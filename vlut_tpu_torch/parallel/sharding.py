"""Meshes and partition specs of params and KV cache (port of
vlut_tpu/parallel/sharding.py).

The JAX package's one ("dp", "tp") mesh with Megatron-style layer sharding,
each leaf's spec a plain tuple of axis names (None: whole):

  wq/wk/wv/w_gate/w_up packed  (.., rows, n)  -> (.., None, "tp")  N local
  wo/w_down packed             (.., rows, d)  -> (.., "tp", None)  K-sharded
  attn_sub_norm/ffn_sub_norm                  -> (.., "tp")
  embed, norms, anything else                 -> replicated
  lm_head (d, vocab_p)                        -> (None, "tp")
  kv cache (L, B, S, Hkv, hd)                 -> (None, "dp", None, "tp", None)

A MoE model shards its experts dim over the axis and replicates the rest
(expert parallelism, ``spmd.make_engine_forward``).  Every padded dim comes
from ``models/dims.py``, so each shard boundary lands on a pack-block
boundary.  Both layer layouts are covered: the stacked (L, ...) tree and
the per-layer list, whose specs drop the leading layer axis.

A :class:`Mesh` is this rank's view of the mesh: one process per device,
the processes of the default group laid out over the axes in row-major
order (the last axis contiguous: tp inside a host), with one process
group per axis.  :func:`shard_params` cuts this rank's shard out of the
full tree and builds the local model over it.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.parallel._comm import Group

# weight name -> which packed axis shards over "tp" ("col": N local to the
# shard; "row": K sharded, the partial products summed)
_COL_NAMES = ("wq", "wk", "wv", "w_gate", "w_up", "w_attn_gate")
_ROW_NAMES = ("wo", "w_down")


class Mesh:
    """Axes ``shape`` (name -> size, in order) over the ranks of the
    default process group; ``devices[rank]`` is each rank's device.  This
    rank's ``coords``, ``device`` and, per axis, its :class:`Group`
    (``group(name)``); ``control`` is a gloo group of every rank for host
    messages (the engine's commands)."""

    def __init__(self, shape: dict[str, int], devices: list):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs torch.distributed initialized: start the ranks "
                "with parallel/distributed.py (launch, init_multihost)")
        world = dist.get_world_size()
        n = math.prod(shape.values())
        if n != world:
            raise ValueError(f"a mesh of {n} ranks {dict(shape)} over a "
                             f"process group of {world}")
        if len(devices) < n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = torch.device(devices[self.rank])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        grid = np.arange(world).reshape(tuple(shape.values()))
        self.coords = {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(self.rank, grid.shape))}
        # every rank creates every group, in the same order
        self._groups: dict[str, Group] = {}
        for ax, name in enumerate(self.axis_names):
            for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[name]):
                ranks = tuple(int(r) for r in line)
                pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self._groups[name] = Group(pg, ranks,
                                               ranks.index(self.rank),
                                               self.backend)
        # an idle server sends nothing for as long as it is idle; a rank
        # that dies still fails the others' waits at once
        self.control = (dist.new_group(
            backend="gloo", timeout=datetime.timedelta(days=30))
            if world > 1 else None)

    def group(self, name: str) -> Group:
        return self._groups[name]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device}, {self.backend})")


def _default_devices() -> list:
    """One device per rank: the visible GPUs under NCCL, the CPU otherwise
    (gloo ranks on the host)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * world


def make_mesh(dp: int = 1, tp: int | None = None,
              devices: list | None = None) -> Mesh:
    """The ("dp", "tp") mesh over ``devices`` (one per rank; default: the
    visible GPUs under NCCL, the CPU under gloo).  Two ranks may share a
    card: ``devices=[cuda:0, cuda:0]`` with gloo."""
    devices = devices if devices is not None else _default_devices()
    n = len(devices)
    tp = tp or (n // dp)
    if dp * tp > n:
        raise ValueError(f"dp*tp={dp * tp} > {n} devices")
    return Mesh({"dp": dp, "tp": tp}, devices[: dp * tp])


def check_flags(tp: int = 1, dp: int = 1, device=None) -> None:
    """The CLI's `--tp N --dp N` against the devices a mesh can take, as
    JAX's ``mesh_from_flags`` checks every device of the run: the ranks of
    the process group once it is joined; before, the processes of a group
    across hosts where the environment names one (``VLUT_NPROCS``, or
    torchrun's ``WORLD_SIZE``); else this host's GPUs (on the CPU, one gloo
    rank per mesh device, as many as asked)."""
    if tp * dp <= 1:
        return
    if dist.is_initialized():
        n, what = dist.get_world_size(), "ranks in the process group"
    elif os.environ.get("VLUT_COORDINATOR"):
        n, what = int(os.environ.get("VLUT_NPROCS", "1")), "processes"
    elif os.environ.get("TORCHELASTIC_RUN_ID"):
        n, what = int(os.environ.get("WORLD_SIZE", "1")), "processes"
    elif torch.device(device or "cuda").type == "cpu":
        return
    else:
        n, what = torch.cuda.device_count(), "visible"
    if tp * dp > n:
        raise SystemExit(
            f"--tp {tp} x --dp {dp} needs {tp * dp} devices; {n} {what} "
            f"(pass --device cpu for one gloo rank per device on the CPU)")


def mesh_from_flags(tp: int = 1, dp: int = 1, device=None) -> Mesh | None:
    """CLI/server `--tp N --dp N` -> Mesh, or None for one device (the
    engine then runs unsharded).  Call it in every rank, after
    ``parallel/distributed.py`` started them."""
    check_flags(tp, dp, device)
    if tp * dp <= 1:
        return None
    if torch.device(device or "cuda").type == "cpu":
        devices = [torch.device("cpu")] * (tp * dp)
    else:
        # ranks are numbered host by host: rank r on its host's GPU
        # r % (GPUs per host)
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", r % n) for r in range(tp * dp)]
    return make_mesh(dp=dp, tp=tp, devices=devices)


def _replicated(v) -> Any:
    if isinstance(v, dict):
        return {k: _replicated(a) for k, a in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_replicated(a) for a in v)
    return (None,) * v.dim()


def _one_layer_specs(layer: dict[str, Any], lead: tuple,
                     moe_model: bool = False) -> dict[str, Any]:
    """Specs of one layer's name -> tensor dict; ``lead`` is (None,) for
    the stacked (L, ...) tree and () for a per-layer tree.  In a MoE model
    the experts dim of the routed gate/up/down (and gpt-oss's per-expert
    biases) shards over the axis and everything else replicates (the ep
    forward keeps full widths; a dense lead layer replicates too)."""
    nl = len(lead)

    def stacked(v):
        return (isinstance(v, dict) and "packed" in v
                and v["packed"].dim() > nl + 2)

    moe = moe_model or any(stacked(v) for n_, v in layer.items()
                           if n_ in ("w_gate", "w_up", "w_down"))
    specs: dict[str, Any] = {}
    for name, v in layer.items():
        if moe and name in ("w_gate", "w_up", "w_down") and stacked(v):
            extra = v["scale"].dim() - nl - 1  # dims past E
            specs[name] = {
                **_replicated(v),
                "packed": (*lead, "tp", None, None),
                "scale": (*lead, "tp", *([None] * max(extra, 0))),
            }
        elif moe and name in ("eb_gate", "eb_up", "eb_down"):
            specs[name] = (*lead, "tp", None)
        elif moe:
            specs[name] = _replicated(v)
        elif name in _COL_NAMES or name in _ROW_NAMES:
            col = name in _COL_NAMES
            scale = ((*lead, "tp" if col else None)
                     if v["scale"].dim() > nl else lead)
            specs[name] = {
                **_replicated(v),
                "packed": (*lead, None, "tp") if col else (*lead, "tp", None),
                "scale": scale,
            }
        elif name in ("attn_sub_norm", "ffn_sub_norm"):
            specs[name] = (*lead, "tp")
        else:
            specs[name] = _replicated(v)
    return specs


def param_specs(cfg: ModelConfig, params: dict[str, Any]) -> dict[str, Any]:
    """The spec tree of a params tree (``TransformerLM.tree()``: stacked or
    per-layer layers; bf16 or int8 head)."""
    layers = params["layers"]
    moe_model = bool(getattr(cfg, "n_experts", 0))
    specs: dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            specs[k] = (
                [_one_layer_specs(lp, (), moe_model) for lp in layers]
                if isinstance(layers, (list, tuple))
                else _one_layer_specs(layers, (None,), moe_model))
        elif k == "lm_head":
            specs[k] = ({"q": (None, "tp"), "scale": ("tp",)}
                        if isinstance(v, dict) else (None, "tp"))
        else:
            specs[k] = _replicated(v)
    return specs


def cache_specs() -> dict[str, tuple]:
    spec = (None, "dp", None, "tp", None)
    return {"k": spec, "v": spec}


def cache_specs_for(cache: dict, batch_axis: str | None = "dp",
                    head_axis: str | None = "tp") -> dict:
    """The spec tree of a KV cache: stacked (L, B, S, H, hd) tensors or
    per-layer lists of (B, S, H, hd), plus the int8 cache's (B, S, H)
    scale planes.  ``batch_axis`` shards the slots (None: replicated),
    ``head_axis`` the KV heads (None for a MoE engine, whose attention
    replicates)."""
    layered = isinstance(cache["k"], (list, tuple))

    def one(name: str) -> tuple:
        body = ((batch_axis, None, head_axis) if name.endswith("_scale")
                else (batch_axis, None, head_axis, None))
        return body if layered else (None, *body)

    if layered:
        return {k: [one(k) for _ in v] for k, v in cache.items()}
    return {k: one(k) for k in cache}


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a contiguous copy where
    anything is cut, ``t`` itself where nothing is)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of shape "
                         f"{tuple(t.shape)}")
    out = t
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.shape[axis]
        if t.shape[d] % size:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {axis}={size}")
        chunk = t.shape[d] // size
        out = out.narrow(d, mesh.coords[axis] * chunk, chunk)
    return out.clone(memory_format=torch.contiguous_format) if out is not t else t


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))
    return shard_tensor(tree, specs, mesh)


@torch.no_grad()
def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The inverse of :func:`shard_tree`, in every rank: each leaf's blocks
    gathered along the dims its spec shards (detached)."""
    from vlut_tpu_torch.parallel._comm import all_gather

    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, s, mesh) for v, s in zip(tree, specs))
    out = tree.detach()
    for d, axis in enumerate(specs):
        if axis is not None:
            out = all_gather(out, mesh.group(axis), d)
    return out


def shard_params(params, mesh: Mesh, cfg: ModelConfig, tp: int | None = None):
    """This rank's shard of a :class:`TransformerLM` as a model over the
    local tree, on the mesh's device.  ``tp`` is the tp degree the local
    specs are cut for: the "tp" axis' size for a dense model, 1 for a MoE
    model (its axis carries experts)."""
    from vlut_tpu_torch.models.transformer import TransformerLM

    if tp is None:
        tp = 1 if getattr(cfg, "n_experts", 0) else mesh.shape.get("tp", 1)
    tree = params.tree()
    local = shard_tree(tree, param_specs(cfg, tree), mesh)
    return TransformerLM(cfg, _to(local, mesh.device), tp=tp,
                         head_shards=mesh.shape.get("tp", 1)
                         if "lm_head" in tree else 1)


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)
