"""Finetuning and QAT of ternary models (port of
``vlut_tpu/train/finetune.py``; reference: ggml-opt + finetune).

* **float twin** (:func:`float_twin_params`): each packed projection
  becomes a ``{"dense": (K, N)}`` leaf holding its trits times its scale,
  at the spec's padded widths so the forward's shapes stay the same; the
  forward multiplies such leaves as plain float products
  (``models/transformer.py:DenseLinear``).  ``cli generate`` runs a
  diffusion checkpoint on this twin, as the JAX CLI does.
* **training** (:func:`make_train_step`): a twin's float leaves
  (:func:`trainable`, :func:`leaves`) trained by any
  ``torch.optim.Optimizer`` on the mean next-token cross-entropy
  (:func:`causal_lm_loss`), optionally through the BitNet b1.58
  straight-through estimator (``qat=True``, :func:`ste_ternarize`).
* **repacking** (:func:`pack_params`): the trained masters back to a
  servable packed tree by absmean quantization, each scale decided on the
  host in numpy as the JAX package decides it.

* **the sharded step** (:func:`make_sharded_train_step`): the same step
  over a ("dp", "tp") mesh of ``parallel/`` (one process per device):
  the batch's rows split over dp, the dense projections Megatron-split
  over tp (:func:`dense_param_specs`), the loss a vocab-sharded
  cross-entropy (:func:`sharded_ce_loss`) that reduces over tp instead of
  gathering the logits and divides by the whole batch's mask count, the
  gradients summed over dp.  Its gradient is the single-device step's at
  every mask (the JAX package's is dp / tp times it with a full mask, and
  a mean of the dp shards' masked means otherwise: ROADMAP "Faults of the
  reference"); :func:`shard_dense` cuts a rank's leaves,
  and ``parallel/sharding.py:gather_tree`` puts a trained tree back
  together for :func:`pack_params`.

The step runs eagerly on the leaves' device (the card unless the twin was
built on the CPU), never inside the decode step's CUDA graph.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.models.transformer import (
    TernarySpec, TransformerLM, forward, layer_specs, weight_specs)
from vlut_tpu_torch.ops.packing import TernaryTensor, pack_ternary, unpack_ternary
from vlut_tpu_torch.ops.quant import true_div
from vlut_tpu_torch.parallel._comm import pmax, psum
from vlut_tpu_torch.parallel.sharding import (
    _COL_NAMES, _ROW_NAMES, Mesh, _replicated, shard_tree)

_TUPLE_TREE = ("takes the stacked tree: the JAX package's {} reads "
               "params['layers'].items(), which a tuple-layers tree (one "
               "dict per layer) does not have (ROADMAP Queue 3, faults of "
               "the reference)")


def _dense(packed: torch.Tensor, scale: torch.Tensor, spec: TernarySpec,
           dtype) -> torch.Tensor:
    """One (K, N) packed projection -> trits * scale (float32, exact), then
    ``dtype``."""
    one = torch.ones((), dtype=torch.float32, device=packed.device)
    w = unpack_ternary(TernaryTensor(packed, one, spec.k, spec.n, spec.fmt,
                                     spec.kb), dtype=torch.float32)
    s = scale.to(torch.float32)
    if s.dim():
        s = s[:spec.n]
    return (w * s).to(dtype)


def _twin(packed: torch.Tensor, scale: torch.Tensor, spec: TernarySpec,
          lead: int, dtype) -> torch.Tensor:
    """A stack of ``lead`` leading dims (layers, experts) unpacked one
    matrix at a time."""
    if lead == 0:
        return _dense(packed, scale, spec, dtype)
    return torch.stack([_twin(packed[i], scale[i], spec, lead - 1, dtype)
                        for i in range(packed.shape[0])])


def _twin_layer(lp: dict[str, Any], specs: dict[str, TernarySpec],
                dtype) -> dict[str, Any]:
    """A layer tree (or the stacked tree) with each packed leaf twinned:
    its leading dims (layers, experts) are those before the (Kp/r, Np)
    bytes."""
    out: dict[str, Any] = {}
    for name, val in lp.items():
        if not isinstance(val, dict) or "packed" not in val:
            out[name] = val  # vectors and already-dense leaves
            continue
        out[name] = {"dense": _twin(val["packed"], val["scale"], specs[name],
                                    val["packed"].dim() - 2, dtype)}
    return out


def float_twin_params(model_or_tree, cfg: ModelConfig,
                      dtype=torch.float32) -> TransformerLM:
    """Packed model (or checkpoint tree) -> the model over its dense twin:
    every packed projection (experts included) a ``{"dense": ...}`` leaf of
    ``dtype``, padded widths preserved; every other tensor as it is."""
    tree = (model_or_tree.tree() if isinstance(model_or_tree, TransformerLM)
            else model_or_tree)
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        twin = [_twin_layer(lp, layer_specs(cfg, i, moe="router" in lp),
                            dtype) for i, lp in enumerate(layers)]
    else:
        twin = _twin_layer(layers, layer_specs(cfg, moe="router" in layers),
                           dtype)
    return TransformerLM(cfg, {**tree, "layers": twin})


# --- the trainable tree --------------------------------------------------------

def _tree_of(params) -> dict[str, Any]:
    return params.tree() if isinstance(params, TransformerLM) else params


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map(v, fn) for v in node]
    return fn(node)


def trainable(params) -> dict[str, Any]:
    """A twin (model or tree) -> its tree with every floating tensor a
    fresh leaf (a copy) that requires grad: the leaves JAX's
    ``value_and_grad`` differentiates (the embedding, the norm gains, the
    sub-norms, the head, the biases, the router and the dense projections,
    experts included).  Integer tensors stay as they are.  The source
    model's tensors are left alone, so a packed model it shares them with
    serves as before."""
    def leaf(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            return t
        return t.detach().clone().requires_grad_(True)

    return _map(_tree_of(params), leaf)


def leaves(params: dict[str, Any]) -> list[torch.Tensor]:
    """The floating leaves of a tree in its order: the tensors to hand the
    optimizer."""
    out: list[torch.Tensor] = []

    def take(t: torch.Tensor) -> None:
        if t.is_floating_point():
            out.append(t)

    _map(params, take)
    return out


# --- QAT and repacking -----------------------------------------------------------

def ste_ternarize(w: torch.Tensor) -> torch.Tensor:
    """BitNet b1.58 quantization with a straight-through estimator: the
    forward sees clip(round(w / s)) * s with s = mean|w| over the whole
    tensor, the backward is the identity (gradients flow to the float
    master)."""
    s = torch.mean(torch.abs(w)) + 1e-8
    q = torch.clamp(torch.round(w / s), -1, 1) * s
    return w + (q - w).detach()


def _apply_ste(params: dict[str, Any]) -> dict[str, Any]:
    """The tree with each stacked dense projection through
    :func:`ste_ternarize` (one scale over its layers and experts, as the
    JAX package takes it)."""
    if not isinstance(params["layers"], dict):
        raise NotImplementedError("qat " + _TUPLE_TREE.format("_apply_ste"))
    layers = {
        name: (
            {"dense": ste_ternarize(v["dense"])}
            if isinstance(v, dict) and "dense" in v
            else v
        )
        for name, v in params["layers"].items()
    }
    return {**params, "layers": layers}


def _pack_master(w2: torch.Tensor, spec: TernarySpec) -> TernaryTensor:
    """One (K, N) float master -> its absmean-packed projection.  The scale
    is the JAX package's, decided on the host: ``float(np.mean(np.abs(w2)))
    + 1e-8`` (numpy's pairwise float32 sum; a device mean sums in another
    order, and one ulp of s moves a trit on a .5 boundary).  The trits are
    ``round(w2 / s)`` (a true division, half to even) clipped to [-1, 1],
    computed and packed on the master's device."""
    w2 = w2.detach().to(torch.float32)
    s = float(np.mean(np.abs(np.ascontiguousarray(w2.cpu().numpy())))) + 1e-8
    trits = torch.clamp(torch.round(true_div(w2, s)), -1, 1).to(torch.int8)
    return pack_ternary(trits, np.float32(s), spec.fmt, spec.kb)


def pack_params(params, cfg: ModelConfig) -> dict[str, Any]:
    """Trained float twin (model or stacked tree) -> packed ternary tree
    (absmean quantization, exactly what the STE forward was simulating),
    one scale per matrix: ``{"packed": (L[, E], Kp/r, Np), "scale": (L[,
    E])}``, on the masters' device.  Every other tensor is copied, detached
    from the masters."""
    tree = _tree_of(params)
    if not isinstance(tree["layers"], dict):
        raise NotImplementedError("pack_params " + _TUPLE_TREE.format(
            "pack_params"))
    specs = weight_specs(cfg, plan=make_plan(cfg))

    def copy(t: torch.Tensor) -> torch.Tensor:
        return t.detach().clone()

    out_layers: dict[str, Any] = {}
    for name, val in tree["layers"].items():
        if not (isinstance(val, dict) and "dense" in val):
            out_layers[name] = _map(val, copy)
            continue
        dense, spec = val["dense"], specs[name]
        lead = dense.shape[:-2]
        ts = [_pack_master(dense[idx], spec) for idx in np.ndindex(*lead)]
        out_layers[name] = {
            "packed": torch.stack([t.packed for t in ts]).reshape(
                lead + ts[0].packed.shape),
            "scale": torch.stack([t.scale.reshape(()) for t in ts]).reshape(
                lead),
        }
    return {k: (_map(v, copy) if k != "layers" else out_layers)
            for k, v in tree.items()}


# --- loss and step ----------------------------------------------------------------

def causal_lm_loss(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, T) int
    mask: torch.Tensor | None = None,  # (B, T) bool; True = count this target
    qat: bool = False,
) -> torch.Tensor:
    """Mean next-token cross-entropy (float32 logits) of a twin (model or
    tree) over ``tokens``; a model is built over the tree for the call, so
    gradients reach the tree's leaves."""
    model = _loss_model(params, cfg, qat)
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device).expand(b, t)
    logits, _ = forward(model, cfg, tokens, pos, None)
    logits = logits[:, :-1, : cfg.vocab_size].to(torch.float32)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    m = torch.ones_like(nll) if mask is None else mask[:, 1:].to(nll.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _loss_model(params, cfg: ModelConfig, qat: bool, tp: int = 1,
                head_shards: int = 1) -> TransformerLM:
    """The model a loss runs: over the tree's leaves (through the STE with
    ``qat``), so gradients reach them."""
    tree = _tree_of(params)
    if qat:
        tree = _apply_ste(tree)
    if isinstance(tree["layers"], dict):
        # the stacked leaves unbound once: their backward stacks the layers'
        # gradients in one op, where a layer's view taken in the layer loop
        # adds a whole-stack gradient per layer
        tree = {**tree, "layers": _unbound(tree["layers"], cfg.n_layers)}
    return TransformerLM(cfg, tree, tp=tp, head_shards=head_shards)


def _unbound(layers: dict[str, Any], n: int) -> list[dict[str, Any]]:
    """A stacked layer tree -> one tree per layer, each leaf a view of
    ``torch.unbind`` of its (L, ...) tensor."""
    per: list[dict[str, Any]] = [{} for _ in range(n)]
    for name, v in layers.items():
        if isinstance(v, dict):
            for leaf, t in v.items():
                for lp, u in zip(per, torch.unbind(t)):
                    lp.setdefault(name, {})[leaf] = u
        else:
            for lp, u in zip(per, torch.unbind(v)):
                lp[name] = u
    return per


def make_train_step(
    cfg: ModelConfig,
    optimizer: torch.optim.Optimizer,
    qat: bool = False,
) -> Callable:
    """(params, tokens, mask) -> loss: one eager step over a tree of
    :func:`trainable` leaves (the ones ``optimizer`` was built on, by
    :func:`leaves`): the loss, its backward, and the optimizer's step,
    which updates the leaves in place.  A leaf the loss does not reach gets
    a zero gradient, as JAX's ``value_and_grad`` gives it, so weight decay
    still applies to it.  Returns the loss (0-d, detached).  The step's
    products, forward and backward, run in full float32 whatever the
    caller allows (``device.full_float32``): TF32 would part from the JAX
    package's numbers."""

    @full_float32()
    def step(params, tokens: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = causal_lm_loss(params, cfg, tokens, mask, qat=qat)
            loss.backward()
        _zero_missing(optimizer)
        optimizer.step()
        return loss.detach()

    return step


def _zero_missing(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for each leaf the loss did not reach (JAX's
    ``value_and_grad`` gives one), so weight decay still applies to it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


# --- the sharded step (dp batch x tp Megatron shards) ------------------------

def dense_param_specs(cfg: ModelConfig, params) -> dict[str, Any]:
    """The spec tree of a twin (model or stacked tree), in the tuples of
    ``parallel/sharding.py:param_specs``: columns on tp for wq / wk / wv /
    w_gate / w_up (and w_attn_gate), rows on tp for wo / w_down, the
    sub-norm gains on tp, the head's columns on tp, the rest replicated."""
    tree = _tree_of(params)
    if not isinstance(tree["layers"], dict):
        raise NotImplementedError("the sharded step " + _TUPLE_TREE.format(
            "dense_param_specs"))

    def layer_spec(name: str, v):
        if isinstance(v, dict) and "dense" in v:
            nd = v["dense"].dim()
            if name in _COL_NAMES:
                return {"dense": (None,) * (nd - 1) + ("tp",)}
            if name in _ROW_NAMES:
                return {"dense": (None,) * (nd - 2) + ("tp", None)}
        elif name in ("attn_sub_norm", "ffn_sub_norm"):
            return (None,) * (v.dim() - 1) + ("tp",)
        return _replicated(v)

    specs = {k: _replicated(v) for k, v in tree.items() if k != "layers"}
    specs["layers"] = {name: layer_spec(name, v)
                       for name, v in tree["layers"].items()}
    if "lm_head" in tree:
        specs["lm_head"] = (None, "tp")
    return specs


def shard_dense(params, pspecs: dict[str, Any], mesh: Mesh) -> dict[str, Any]:
    """This rank's block of a twin under ``pspecs`` (``shard_tree``), on the
    mesh's device, as :func:`trainable` leaves."""
    local = shard_tree(_tree_of(params), pspecs, mesh)
    return trainable(_map(local, lambda t: t.to(mesh.device)))


def sharded_ce_loss(local_logits: torch.Tensor, targets: torch.Tensor, tp,
                    v_local: int, mask: torch.Tensor | None = None,
                    vocab_size: int | None = None, dp=None) -> torch.Tensor:
    """Stable cross-entropy over vocab-sharded logits, as the JAX package's:
    ``local_logits`` (B, T, v_local) this rank's columns of the tp Group
    ``tp`` (None: the whole vocabulary), ``targets`` (B, T) global ids.
    The pad columns past ``vocab_size`` set to -1e30, the max taken
    without a gradient (over tp), the log-sum-exp of the sums over tp,
    each target's logit from the rank that holds it, the masked mean.
    ``dp`` is the Group the batch's rows are split over (None: this rank
    holds them all): the mean divides by the mask's count summed over it,
    so the dp ranks' losses sum to the whole batch's masked mean."""
    lg = local_logits.to(torch.float32)
    off = (tp.index if tp is not None else 0) * v_local
    if vocab_size is not None:
        col = off + torch.arange(v_local, device=lg.device)
        lg = torch.where(col < vocab_size, lg, torch.full_like(lg, -1e30))
    m = pmax(lg.detach().amax(dim=-1), tp)
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    lse = torch.log(psum(se, tp)) + m
    local_t = targets.long() - off
    in_shard = (local_t >= 0) & (local_t < v_local)
    tl = torch.gather(lg, -1, torch.clamp(local_t, 0, v_local - 1)[..., None]
                      )[..., 0]
    target_logit = psum(torch.where(in_shard, tl, torch.zeros_like(tl)), tp)
    nll = lse - target_logit
    w = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    return (nll * w).sum() / torch.clamp(psum(w.sum(), dp), min=1.0)


def make_sharded_train_step(
    cfg: ModelConfig,
    mesh: Mesh,
    params_tree,
    optimizer: Callable[[list[torch.Tensor]], torch.optim.Optimizer],
    qat: bool = False,
):
    """The train step over a ("dp", "tp") mesh, in every rank: returns
    ``(make, pspecs)``.  ``pspecs`` is :func:`dense_param_specs` of the
    twin; ``make(local)`` takes this rank's trainable block
    (:func:`shard_dense`), builds ``optimizer(leaves(local))`` and returns
    ``step(tokens, mask=None) -> loss``, which updates ``local`` in place.
    ``tokens`` / ``mask`` are the whole (B, T) batch; this rank takes its
    dp group's rows.  One step: the local loss (the vocab-sharded
    cross-entropy of this rank's rows, divided by the whole batch's mask
    count), its backward (the collectives' gradients sum where the
    single-device graph adds, ``parallel/_comm.py``), the gradients and
    the loss summed over dp, and the optimizer's step in place, all in
    full float32: the single-device step's gradient at every mask.  With
    ``qat`` each shard is ternarized with its own mean |w|, as the JAX
    package's step does inside ``shard_map``."""
    tree = _tree_of(params_tree)
    pspecs = dense_param_specs(cfg, tree)
    tp_g, dp_g = mesh.group("tp"), mesh.group("dp")
    tp, dp = tp_g.size, dp_g.size
    if tp > 1 and "lm_head" not in tree:
        raise ValueError(
            "the sharded step takes an untied head at tp > 1: a tied head "
            "(embed.T) is whole on every rank and has no vocabulary shard "
            "(the JAX package's step then reads it as its shard: ROADMAP, "
            "faults of the reference)")
    if tp > 1 and getattr(cfg, "n_experts", 0):
        raise ValueError("the sharded step splits dense projections over tp; "
                         "a MoE model's experts are not split")
    v_local = make_plan(cfg).vocab_p // tp

    def local_loss(params, tokens, mask):
        model = _loss_model(params, cfg, qat, tp=tp, head_shards=tp)
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device).expand(b, t)
        logits, _ = forward(model, cfg, tokens, pos, None, tp=tp_g,
                            output="local_logits")
        return sharded_ce_loss(logits[:, :-1], tokens[:, 1:], tp_g, v_local,
                               mask=mask[:, 1:], vocab_size=cfg.vocab_size,
                               dp=dp_g)

    def make(local: dict[str, Any]) -> Callable:
        opt = optimizer(leaves(local))

        @full_float32()
        def step(tokens: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
            b = tokens.shape[0]
            if b % dp:
                raise ValueError(f"a batch of {b} rows over dp={dp}")
            rows = slice(mesh.coords["dp"] * (b // dp),
                         (mesh.coords["dp"] + 1) * (b // dp))
            dev = mesh.device
            toks = tokens[rows].to(dev)
            m = (torch.ones_like(toks, dtype=torch.bool) if mask is None
                 else mask[rows].to(dev))
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = local_loss(local, toks, m)
                loss.backward()
            _zero_missing(opt)
            for group in opt.param_groups:
                for p in group["params"]:
                    p.grad = psum(p.grad, dp_g)
            opt.step()
            return psum(loss.detach(), dp_g)

        return step

    return make, pspecs
