"""The sharded forwards (port of vlut_tpu/parallel/spmd.py).

The JAX package wraps the forward in ``shard_map``: one program over the
mesh, the kernels partitioned by explicit specs.  Here every rank runs its
own process, so each ``make_forward_*`` returns a function every rank calls
on its shard (``sharding.shard_params``, its dp rows, its T slice); the
forward issues the same collectives as the JAX body (``models/
transformer.py``: the psums after wo and w_down with their pmax scales,
the sub-norm statistics, the vocabulary gather, the expert combine, the
ring's ppermutes).
"""

from __future__ import annotations

from typing import Any

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import TransformerLM, forward
from vlut_tpu_torch.parallel.sharding import (
    Mesh,
    _replicated,
    _to,
    shard_tree,
)


def make_forward_tp(cfg: ModelConfig, mesh: Mesh):
    """f(params, cache, tokens, positions, logits_at) -> (logits, cache) on
    a ("dp", "tp") mesh: ``params`` this rank's shard, ``cache`` its shard
    (``cache_specs``: its dp slots, its KV heads) or None, ``tokens`` /
    ``positions`` / ``logits_at`` its dp rows.  The logits are the rows'
    whole vocabulary (gathered over tp)."""
    tp = mesh.group("tp")

    def fwd(params, cache, tokens, positions, logits_at):
        return forward(params, cfg, tokens, positions, cache,
                       logits_at=logits_at, tp=tp)

    return fwd


def make_engine_forward(cfg: ModelConfig, mesh: Mesh | None,
                        decode_attn: str = "fused"):
    """The engine's forward on a ("dp", "tp") mesh, or on one device with
    ``mesh`` None: f(params, cache, tokens, positions, **forward's
    keywords) -> (logits, cache) over rows the engine gives this rank (its
    dp group's slots), the cache written in place.  A MoE model runs the
    "tp" axis as expert parallelism with tp_size 1 (experts shard,
    attention and the router replicate, the combine sums), as the JAX
    engine does; a dense model as tensor parallelism.  (JAX's view specs
    and ``batch_axis`` have no counterpart: each rank holds its own
    slots.)"""
    axis = mesh.group("tp") if mesh is not None else None
    moe = bool(getattr(cfg, "n_experts", 0))
    kw = {"ep": axis} if moe else {"tp": axis}

    def fwd(params, cache, tokens, positions, **fkw):
        return forward(params, cfg, tokens, positions, cache,
                       decode_attn=decode_attn, **kw, **fkw)

    return fwd


def make_forward_sp(cfg: ModelConfig, mesh: Mesh):
    """Ring (blockwise) context-parallel cache-less forward on an ("sp",)
    mesh: f(params, tokens, positions) -> logits, tokens and positions
    this rank's T slice (global positions), params whole; the logits are
    this slice's."""
    sp = mesh.group("sp")

    def fwd(params, tokens, positions):
        return forward(params, cfg, tokens, positions, None, sp=sp)[0]

    return fwd


def ep_specs(params_tree: dict[str, Any]) -> dict[str, Any]:
    """The expert-parallel specs of a stacked MoE tree: the experts dim of
    every w_gate / w_up / w_down leaf over "ep", the rest whole."""
    def espec(v):
        return {k: (None, "ep") + (None,) * (a.dim() - 2)
                for k, a in v.items()}

    layers = {name: (espec(v) if name in ("w_gate", "w_up", "w_down")
                     else _replicated(v))
              for name, v in params_tree["layers"].items()}
    return {k: (layers if k == "layers" else _replicated(v))
            for k, v in params_tree.items()}


def shard_params_ep(params: TransformerLM, mesh: Mesh,
                    cfg: ModelConfig) -> TransformerLM:
    """This rank's expert shard of a stacked MoE model (:func:`ep_specs`)."""
    tree = params.tree()
    local = shard_tree(tree, ep_specs(tree), mesh)
    return TransformerLM(cfg, _to(local, mesh.device))


def make_forward_ep(cfg: ModelConfig, mesh: Mesh):
    """Expert-parallel cache-less MoE forward on an ("ep",) mesh:
    f(params, tokens, positions) -> logits, ``params`` this rank's expert
    shard (:func:`shard_params_ep`); attention and the router replicate,
    the combine sums the experts' outputs over "ep"."""
    ep = mesh.group("ep")

    def fwd(params, tokens, positions):
        return forward(params, cfg, tokens, positions, None, ep=ep)[0]

    return fwd
