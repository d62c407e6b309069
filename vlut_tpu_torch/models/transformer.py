"""Ternary transformer, dense llama + bitnet subset (port of
vlut_tpu/models/transformer.py).

The model is a :class:`TransformerLM` module whose projections are
:class:`TernaryLinear` modules over packed ternary weights.  Two layer trees
run, as in the JAX package:

* the **unfused, stacked** tree that checkpoints load as
  (:class:`StackedLayers`: one (L, ...) tensor per weight): q/k/v and
  gate/up are separate projections through ``ternary_matmul``;
* the **fused, unrolled** tree (:func:`fuse_projections` then
  :func:`unstack_layers`: one :class:`DecoderLayer` per layer with wq|wk|wv
  -> wqkv and w_gate|w_up -> w_gateup): four projections per layer, each
  through ``ternary_matmul_fused`` with the norms, silu*up and residual adds
  fused in.

A LoRA adapter (``runtime/lora.py``) adds ``(h @ A) @ B * lora_scale`` to
the projections it covers; such a projection runs unfused (its delta needs
the normed input), and a LoRA on wq/wk/wv/w_gate/w_up keeps the whole
tree unfused, as in the JAX package.  A control vector is added to the
residual after each layer.  ``forward(attn_mask=...)`` overrides the causal
mask (lookahead rounds).

The dense knobs of the JAX package's transformer run here too (the zoo of
dense HF families its converter takes): q/k/v biases, q/k norms (per head
or whole, RMS / LayerNorm / weightless L2, before or after rope), q/k/v
clamps, the activations (silu, gelu, exact gelu, relu, relu^2, xIELU), the
ungated MLP, the clamped swiglu, embedding scale and norm, learned / ALiBi
/ no positions, LayerNorm with biases, (1 + w) gains, post-norms and the
norm-after-block order, attention and final logit softcaps, sliding
windows (per layer, rolling or chunked, with a local rope base), parallel
residuals, projection and head biases, partial and interleaved rope, NoPE
layers, the sigmoid attention gate, attention sinks and NoPE-layer
temperature tuning.  Which projection runs fused follows the JAX package's
gates (:func:`_layer_step`).

Heterogeneous stacks run too: per-layer head counts and FFN widths
(``heads_per_layer`` / ``d_ff_per_layer``: each layer has its own
:class:`DimPlan` and spec table, :func:`layer_config`), deci's linear
"attention" and its attention-free and FFN-free layers, and the dense lead
layers of MoE models.  Their checkpoints keep a tuple of per-layer trees
(``layers_tuple``), which loads here as the unrolled list.  Mixture of
experts runs the JAX package's ``build_moe_ffn`` analog (:func:`_moe_block`):
a float32 router with softmax or sigmoid scores, a selection bias,
grouped top-k, the top-k norm and routed scale, then every expert over
every row in index order into a float32 accumulator (static shapes, so a
decode step stays one CUDA graph), with shared, chunk (grovemoe) and
parallel residual (arctic) experts beside it.

MLA, deepseek's latent-KV attention (:func:`_mla_attention`), runs as the
JAX package's ``mla_attention``: the q path with or without q-LoRA, one
latent row of ``kv_lora_rank + qk_rope_dim`` (lane-padded) per position in
a one-head cache, the absorbed ``q_nope . w_uk`` and ``ctx . w_uv`` float32
products and the composed attention over the latent.  M-RoPE
(``rope_scaling`` "mrope") rotates each frequency by its own position row
where ``forward`` is given ``mrope_pos``, and is plain rope without.

PyTorch runs eagerly, so there is no scan-versus-unroll trade-off in the
computation: the serving engine keeps the unrolled tree, or the stacked one
over a stacked cache (``Engine(unroll=False)``).  ``causal_attn=False``
(the diffusion LMs and the decoder embedders) attends both ways in the
composed attention; a float twin's ``{"dense": (K, N)}`` leaves
(``train/finetune.py``) multiply as plain float products.  Tensor, expert
and sequence parallelism run with each rank on its shard (``forward``'s
``tp`` / ``ep`` / ``sp``, ``parallel/spmd.py``); a pipeline stage runs its
slice of the layers (``run_layers``' ``first_layer``,
``parallel/pipeline.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import full_float32, resolve_device
from vlut_tpu_torch.models.dims import (
    DimPlan,
    chunk_positions,
    head_positions,
    make_plan,
    pad_heads_cols,
    pad_heads_rows,
    scatter_cols,
    scatter_rows,
)
from vlut_tpu_torch.ops import decode_attention as dattn
from vlut_tpu_torch.ops.kv_update import write_rows_pair
from vlut_tpu_torch.ops import norm as nrm
from vlut_tpu_torch.ops.matmul import ternary_matmul, ternary_matmul_fused
from vlut_tpu_torch.ops.packing import (
    TRITS_PER_BYTE,
    TernaryTensor,
    pack_ternary,
    padded_k,
    random_packed_bytes,
    unpack_ternary,
)
from vlut_tpu_torch.ops.quant import quantize_activations, true_div
from vlut_tpu_torch.ops.ternary_gemm import RECIP_127
from vlut_tpu_torch.parallel._comm import all_gather, copy_to, ppermute, psum
from vlut_tpu_torch.ops.rope import (
    apply_mrope,
    apply_rope,
    mrope_row_map,
    rope_prefix,
    rope_table,
)
from vlut_tpu_torch.runtime.kv_cache import (
    dequantize_kv,
    is_quantized,
    max_len_of,
    new_cache,
    quantize_kv,
)

ATTN_CHUNK = 1024  # switch to online-softmax chunking past this KV length
DECODE_ATTN = ("fused", "composed")
IMPLS = ("auto", "dequant")
# forward's ablation switches (bench/ablate.py only): the unfused
# projections at every M, no cache write, no attention, no head
ABLATIONS = frozenset({"unfused", "no_kv_write", "no_attn", "no_head"})

# config fields this port implements; any other field must keep its default
_SUPPORTED_FIELDS = {
    "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
    "arch", "head_dim", "rms_eps", "rope_theta", "rope_scaling",
    "tie_embeddings", "use_subnorms", "weight_fmt", "max_seq_len", "tp_pack",
    "attn_scale", "logit_scale",
    # the dense knobs
    "qkv_bias", "qk_norm", "act_fn", "embed_scale", "post_norms",
    "norm_plus_one", "attn_logit_softcap", "final_logit_softcap",
    "sliding_window", "sliding_window_pattern", "rope_theta_local",
    "parallel_residual", "rope_pct", "ffn_gated", "rope_interleaved",
    "norm_type", "proj_bias", "pos_embed", "embed_norm", "pre_norms",
    "qk_norm_scope", "qk_norm_post_rope", "qk_norm_type", "qkv_clamp",
    "swa_layers", "swa_type", "attn_temp_scale", "attn_temp_floor",
    "attn_temp_offset", "nope_layers", "attn_gate", "alibi_scaled",
    "attn_sinks", "swiglu_limit",
    # heterogeneous stacks
    "heads_per_layer", "d_ff_per_layer",
    # mixture of experts
    "n_experts", "n_experts_used", "moe_score", "moe_norm_topk",
    "n_expert_groups", "topk_groups", "routed_scale", "n_shared_experts",
    "d_ff_shared", "first_k_dense", "d_ff_dense", "dense_layers",
    "moe_expert_bias", "moe_weight_before", "moe_router_input",
    "moe_parallel", "moe_chunk_experts", "moe_chunk_scale", "d_ff_chunk",
    # MLA
    "q_lora_rank", "kv_lora_rank", "qk_nope_dim", "qk_rope_dim",
    # bidirectional attention and the diffusion LMs
    "causal_attn", "mask_token_id", "diffusion_shift_logits",
    # cogvlm's visual experts (the vis_* projections, forward(visual_expert=))
    "dual_expert",
}
# the values of the string knobs this port computes
_CHOICES = {
    "act_fn": ("silu", "gelu", "gelu_exact", "relu2", "relu", "xielu"),
    "norm_type": ("rms", "ln"),
    "pos_embed": ("rope", "learned", "alibi", "none"),
    "qk_norm_scope": ("head", "whole"),
    "qk_norm_type": ("rms", "ln", "l2"),
    "swa_type": ("window", "chunked"),
    "attn_gate": ("", "sigmoid"),
    "moe_score": ("softmax", "sigmoid"),
    "moe_router_input": ("hidden", "layer_input"),
    "moe_parallel": ("", "arctic"),
}
# MLA's projections, in the JAX package's init order: plain packing (no
# head permutation), each through ternary_matmul (the JAX package's ``mm``:
# no fused prologue, no LoRA)
MLA_PROJECTIONS = ("wkv_a", "wq_a", "wq_b", "wq_full")
# cogvlm's visual-expert twins of the attention and FFN projections, which
# image rows use in their place (forward(visual_expert=True))
_VISUAL_TWINS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up",
                 "w_gateup", "w_down")
VISUAL_PROJECTIONS = tuple("vis_" + n for n in _VISUAL_TWINS)
PROJECTIONS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_gateup",
               "w_down", "w_attn_gate", "w_lin_attn", "w_shared_gate",
               "w_shared_up", "w_shared_down", "w_res_gate", "w_res_up",
               "w_res_down") + MLA_PROJECTIONS + VISUAL_PROJECTIONS
# MLA's absorbed float factors, stored as {"dense": ...} leaves: w_uk (H, dn,
# r_kv) and w_uv (H, r_kv, v)
MLA_DENSE = ("w_uk", "w_uv")
# projections that carry an experts dim in MoE layers: (E, Kp/r, Np) packed
# bytes and (E,) scales per layer; w_ch_* are grovemoe's chunk experts
EXPERT_PROJECTIONS = ("w_gate", "w_up", "w_down", "w_ch_gate", "w_ch_up",
                      "w_ch_down")
NORMS = ("attn_norm", "ffn_norm", "attn_sub_norm", "ffn_sub_norm",
         "moe_norm", "q_a_norm", "kv_a_norm")
# the knobs' per-layer vectors, kept in their stored dtype: LayerNorm
# biases, post-norm and q/k-norm gains (+ biases), projection biases,
# attention sinks and xIELU's alphas
KNOB_VECTORS = (
    "attn_norm_b", "ffn_norm_b", "post_attn_norm", "post_ffn_norm",
    "q_norm", "k_norm", "q_norm_b", "k_norm_b", "bq", "bk", "bv", "bo",
    "b_gate", "b_up", "b_down", "sinks", "xielu_ap", "xielu_an",
)
# a MoE layer's vectors, as stored: the router (D, E), its selection-only
# bias and its logits bias (E,), the per-expert projection biases (E, ff_p)
# and (E, D), and the shared expert's sigmoid gate (D,)
MOE_VECTORS = ("router", "router_bias", "router_b", "eb_gate", "eb_up",
               "eb_down", "shared_gate")
# per-layer vectors a layer tree may carry: the norm gains (float32), the
# knobs' and MoE vectors and the control vector
LAYER_VECTORS = NORMS + KNOB_VECTORS + MOE_VECTORS + ("cvector",)
# top-level vectors beside embed / final_norm / lm_head
TOP_VECTORS = ("pos_embed", "embed_norm", "embed_norm_b", "final_norm_b",
               "lm_head_b")
LORA_LEAVES = ("lora_a", "lora_b", "lora_scale")
# a LoRA on one of these keeps the tree unfused (JAX fuse_projections)
_UNFUSED_BY_LORA = ("wq", "wk", "wv", "w_gate", "w_up")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for anything outside the ported subset."""
    if cfg.arch not in ("llama", "bitnet"):
        raise NotImplementedError(f"arch {cfg.arch!r} is not ported")
    base = ModelConfig(vocab_size=1, d_model=1, n_layers=1, n_heads=1,
                       n_kv_heads=1, d_ff=1)
    for f in dataclasses.fields(ModelConfig):
        if f.name in _SUPPORTED_FIELDS:
            continue
        if getattr(cfg, f.name) != getattr(base, f.name):
            raise NotImplementedError(
                f"config field {f.name}={getattr(cfg, f.name)!r} is not "
                "ported to vlut_tpu_torch yet")
    for name, allowed in _CHOICES.items():
        if getattr(cfg, name) not in allowed:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported")


def layer_config(cfg: ModelConfig, i: int) -> ModelConfig:
    """Layer i's config: ``cfg`` itself, or for per-layer head counts and
    FFN widths the JAX package's per-layer swap (its ``run_layers``): that
    layer's (at least one) heads and KV heads and its FFN width."""
    if not (cfg.heads_per_layer or cfg.d_ff_per_layer):
        return cfg
    nh, nkv = (cfg.heads_per_layer[i] if cfg.heads_per_layer
               else (cfg.n_heads, cfg.n_kv_heads))
    ff = cfg.d_ff_per_layer[i] if cfg.d_ff_per_layer else cfg.d_ff
    return dataclasses.replace(
        cfg, n_heads=max(nh, 1), n_kv_heads=max(nkv or nh, 1),
        d_ff=max(ff, 1), heads_per_layer=None, d_ff_per_layer=None)


def layer_kv_heads(cfg: ModelConfig) -> tuple[int, ...]:
    """Each layer's KV heads in the cache: its own count, 0 for a layer
    without softmax attention (deci's linear and attention-free layers)."""
    if not cfg.heads_per_layer:
        return (cfg.n_kv_heads,) * cfg.n_layers
    return tuple(nkv if nh else 0 for nh, nkv in cfg.heads_per_layer)


def layers_tuple(cfg: ModelConfig) -> bool:
    """Whether the config's checkpoints keep a tuple of per-layer trees
    (the JAX converter's rule: dense lead layers, or per-layer heads or
    FFN widths)."""
    return bool(cfg.first_k_dense or (cfg.dense_layers
                                      and any(cfg.dense_layers))
                or cfg.heads_per_layer or cfg.d_ff_per_layer)


def moe_layers(cfg: ModelConfig) -> tuple[bool, ...]:
    """Each layer's kind in a MoE model's per-layer tree: True where it
    routes over the experts, False for a dense lead layer
    (``first_k_dense`` / ``dense_layers``); all False without experts."""
    if not cfg.n_experts:
        return (False,) * cfg.n_layers
    dense = cfg.dense_layers or (False,) * cfg.n_layers
    return tuple(not (i < cfg.first_k_dense or dense[i])
                 for i in range(cfg.n_layers))


def rope_width(cfg: ModelConfig, plan: DimPlan) -> int:
    """The rotated width of a head: the logical head (rope_pct 1), or its
    first rope_pct share rounded down to an even count (JAX run_layers)."""
    rot = plan.hd
    if cfg.rope_pct < 1.0:
        rot = int(plan.hd * cfg.rope_pct) // 2 * 2
        if plan.hd != plan.hd_p and rot > plan.hd // 2:
            raise ValueError(
                f"rope_pct={cfg.rope_pct} needs rot <= head_dim/2 when the "
                f"head dim is lane-padded ({plan.hd} -> {plan.hd_p})")
    if cfg.rope_interleaved and plan.hd != plan.hd_p:
        raise ValueError("rope_interleaved requires an unpadded head dim")
    return rot


def rope_tables(cfg: ModelConfig, plan: DimPlan, with_mscale: bool = True,
                device="cpu") -> tuple:
    """(cos, sin, cos_local, sin_local): the global tables (padded to hd_p
    when the whole head rotates) and, for a model whose sliding-window
    layers rope with their own base, the local ones (no rope_scaling);
    else the last two are None.  An MLA model's tables are its rope dims'
    (``qk_rope_dim``, with the config's scaling: the JAX package's
    ``cos_m`` / ``sin_m``)."""
    if cfg.kv_lora_rank:
        return rope_table(cfg.max_seq_len, cfg.qk_rope_dim, cfg.rope_theta,
                          cfg.rope_scaling, with_mscale=with_mscale,
                          device=device) + (None, None)
    rot = rope_width(cfg, plan)
    pad = plan.hd_p if rot == plan.hd else None
    cos, sin = rope_table(cfg.max_seq_len, rot, cfg.rope_theta,
                          cfg.rope_scaling, pad_to=pad,
                          with_mscale=with_mscale, device=device)
    if not cfg.rope_theta_local:
        return cos, sin, None, None
    return (cos, sin) + rope_table(cfg.max_seq_len, rot, cfg.rope_theta_local,
                                   None, pad_to=pad, with_mscale=with_mscale,
                                   device=device)


def layer_windows(cfg: ModelConfig) -> tuple[int, ...]:
    """Each layer's sliding window (0: global attention)."""
    return tuple(cfg.sliding_window if f else 0 for f in cfg.swa_flags())


def layer_rope_on(cfg: ModelConfig) -> tuple[bool, ...]:
    """Each layer's rope flag: False on a NoPE layer, and on every layer of
    a model without rope positions."""
    if cfg.pos_embed != "rope":
        return (False,) * cfg.n_layers
    if cfg.nope_layers is None:
        return (True,) * cfg.n_layers
    return tuple(not f for f in cfg.nope_layers)


def shift_tables(cfg: ModelConfig, device="cpu") -> list:
    """Each layer's unscaled rope tables for a context shift
    (``kv_cache.seq_shift``): None on a layer whose keys carry no rope, the
    local tables on a sliding layer of a model with a local rope base,
    else the global ones (stored keys already carry the mscale).  An MLA
    layer's entry is (cos, sin, kv_lora_rank): its latent row's rope dims
    [r_kv, r_kv + qk_rope_dim) rotate, the latent does not."""
    cos, sin, cos_l, sin_l = rope_tables(cfg, make_plan(cfg),
                                         with_mscale=False, device=device)
    if cfg.kv_lora_rank:
        return [(cos, sin, cfg.kv_lora_rank)] * cfg.n_layers
    return [None if not on else
            (cos_l, sin_l) if w and cos_l is not None else (cos, sin)
            for w, on in zip(layer_windows(cfg), layer_rope_on(cfg))]


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (HF build_alibi_tensor): a geometric schedule
    over the closest power of two, the extra heads interleaving the doubled
    one."""
    m = 1 << int(np.floor(np.log2(n_heads)))
    base = 2.0 ** (-(2.0 ** -(np.log2(m) - 3)))
    slopes = base ** np.arange(1, m + 1, dtype=np.float64)
    if m != n_heads:
        base2 = 2.0 ** (-(2.0 ** -(np.log2(2 * m) - 3)))
        extra = base2 ** np.arange(1, 2 * (n_heads - m) + 1, 2,
                                   dtype=np.float64)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TernarySpec:
    k: int
    n: int
    fmt: str
    kb: int


def weight_specs(cfg: ModelConfig, plan: DimPlan | None = None,
                 tp: int = 1) -> dict[str, TernarySpec]:
    """Packed weight specs of one shard of a ``tp``-way split (the whole
    weights at tp 1; fused names included): q/k/v and gate/up keep N / tp
    columns, wo and w_down K / tp rows, in whole pack chunks."""
    plan = plan or make_plan(cfg)
    fmt, kb, d = cfg.weight_fmt, plan.kb, cfg.d_model
    if tp > 1:
        for dim, what in ((cfg.n_heads, "n_heads"),
                          (cfg.n_kv_heads, "n_kv_heads")):
            if dim % tp:
                raise ValueError(f"{what}={dim} not divisible by tp={tp}")
        if plan.tp_pack % tp:
            raise ValueError(f"tp={tp} must divide tp_pack={plan.tp_pack}")
    qd, kvd = plan.q_dim_p // tp, plan.kv_dim_p // tp
    ff = plan.ff_p // tp
    specs = {
        "wq": TernarySpec(d, qd, fmt, kb),
        "wk": TernarySpec(d, kvd, fmt, kb),
        "wv": TernarySpec(d, kvd, fmt, kb),
        "wqkv": TernarySpec(d, qd + 2 * kvd, fmt, kb),
        "wo": TernarySpec(plan.wo_in_p // tp, d, fmt, kb),
        "w_gate": TernarySpec(d, ff, fmt, kb),
        "w_up": TernarySpec(d, ff, fmt, kb),
        "w_gateup": TernarySpec(d, 2 * ff, fmt, kb),
        "w_down": TernarySpec(ff, d, fmt, kb),
    }
    if cfg.attn_gate:
        # the attention output gate packs exactly like wq
        specs["w_attn_gate"] = TernarySpec(d, qd, fmt, kb)
    if cfg.heads_per_layer and any(nh and not nkv
                                   for nh, nkv in cfg.heads_per_layer):
        # deci's linear "attention": a plain (D, D) projection
        specs["w_lin_attn"] = TernarySpec(d, d, fmt, kb)
    if cfg.dual_expert:
        # cogvlm's visual-expert twins share the language specs
        for nm in _VISUAL_TWINS:
            specs["vis_" + nm] = specs[nm]
    if cfg.kv_lora_rank:
        # MLA: the latent and k_pe (wkv_a), q with or without its LoRA
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        specs["wkv_a"] = TernarySpec(d, cfg.kv_lora_rank + dr, fmt, kb)
        if cfg.q_lora_rank:
            specs["wq_a"] = TernarySpec(d, cfg.q_lora_rank, fmt, kb)
            specs["wq_b"] = TernarySpec(cfg.q_lora_rank,
                                        cfg.n_heads * (dn + dr), fmt, kb)
        else:
            specs["wq_full"] = TernarySpec(d, cfg.n_heads * (dn + dr), fmt,
                                           kb)
    return specs


def _ffn_cfg(cfg: ModelConfig, d_ff: int) -> ModelConfig:
    """A uniform config of FFN width ``d_ff`` (the plan of a MoE model's
    experts, dense lead, shared, residual and chunk FFNs)."""
    return dataclasses.replace(cfg, d_ff=d_ff, n_experts=0,
                               heads_per_layer=None, d_ff_per_layer=None)


def _side_ffns(cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """(prefix, FFN width, experts) of the shared expert, arctic's residual
    MLP and grovemoe's chunk experts the config has."""
    out = []
    if cfg.n_shared_experts:
        out.append(("w_shared_", cfg.d_ff_shared
                    or cfg.n_shared_experts * cfg.d_ff, 0))
    if cfg.moe_parallel:
        out.append(("w_res_", cfg.d_ff_dense or cfg.d_ff, 0))
    if cfg.moe_chunk_experts:
        out.append(("w_ch_", cfg.d_ff_chunk or cfg.d_ff,
                    cfg.moe_chunk_experts))
    return out


def _ffn_specs(cfg: ModelConfig, d_ff: int, prefix: str) -> dict:
    """The gate, up and down specs of a gated FFN of width ``d_ff`` under
    ``prefix`` (its plan's padding, as the JAX package's per-width spec
    tables)."""
    c = _ffn_cfg(cfg, d_ff)
    s = weight_specs(c, make_plan(c))
    return {f"{prefix}gate": s["w_gate"], f"{prefix}up": s["w_up"],
            f"{prefix}down": s["w_down"]}


def layer_specs(cfg: ModelConfig, i: int = 0, moe: bool | None = None,
                tp: int = 1) -> dict[str, TernarySpec]:
    """Layer i's spec table: its own heads and FFN width
    (:func:`layer_config`, plus deci's linear projection), and in a MoE
    model the routed experts at ``d_ff`` (one expert's shapes), a dense
    lead layer's FFN at ``d_ff_dense`` when ``moe`` is False, the shared
    expert at ``d_ff_shared`` (or ``n_shared_experts * d_ff``), arctic's
    residual MLP at ``d_ff_dense`` and grovemoe's chunk experts at
    ``d_ff_chunk`` (the JAX package's ``specs_dense`` / ``specs_shared`` /
    ``specs_chunk``); ``tp``: one shard's (:func:`weight_specs`)."""
    specs = weight_specs(layer_config(cfg, i), tp=tp)
    lin = weight_specs(cfg).get("w_lin_attn")
    if lin:  # the per-layer config drops heads_per_layer, which gates it
        specs["w_lin_attn"] = lin
    if not cfg.n_experts:
        return specs
    specs.update(_ffn_specs(
        cfg, cfg.d_ff if moe is not False else cfg.d_ff_dense or cfg.d_ff,
        "w_"))
    for prefix, width, _ in _side_ffns(cfg):
        specs.update(_ffn_specs(cfg, width, prefix))
    return specs


def pack_weight(name: str, trits, scale, cfg: ModelConfig,
                plan: DimPlan | None = None,
                device: str | torch.device | None = None) -> TernaryTensor:
    """Pack one logical (K, N) projection (numpy or a tensor) with the
    plan's head padding and chunk padding (the JAX package's checkpoint
    layout).  The padding and the packing run on ``device`` (default: the
    trits' own; the CPU for numpy)."""
    plan = plan or make_plan(cfg)
    if device is not None:
        trits = torch.as_tensor(trits).to(device)
    hd, hd_p = plan.hd, plan.hd_p
    name = name.removeprefix("vis_")  # cogvlm's twins pack identically
    if name in ("wq", "wk", "wv", "w_attn_gate"):
        heads = cfg.n_kv_heads if name in ("wk", "wv") else cfg.n_heads
        trits = pad_heads_cols(trits, heads, hd, hd_p)
    elif name == "wo":
        trits = pad_heads_rows(trits, cfg.n_heads, hd, hd_p)
        trits = scatter_rows(trits, plan.wo_chunk, plan.wo_chunk_p,
                             plan.wo_in_p)
    elif name in _FFN_IN:
        # the shared, residual and chunk experts pack like the FFN at
        # their own width (the caller passes a cfg of that d_ff)
        trits = scatter_cols(trits, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
    elif name in _FFN_OUT:
        trits = scatter_rows(trits, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
    elif name not in ("w_lin_attn",) + MLA_PROJECTIONS:
        # deci's (D, D) and MLA's projections: plain packing
        raise KeyError(name)
    t = pack_ternary(trits, scale, cfg.weight_fmt, plan.kb)
    if name in ("wq_b", "wq_full") and t.packed.shape[1] != trits.shape[1]:
        # q reshapes per head, so its width must be lane-exact (true of the
        # real models: H * (128 + 64) is a multiple of 128)
        raise ValueError(f"MLA projection {name} width {trits.shape[1]} "
                         "must be a lane multiple")
    return t


_FFN_IN = ("w_gate", "w_up", "w_shared_gate", "w_shared_up", "w_res_gate",
           "w_res_up", "w_ch_gate", "w_ch_up")
_FFN_OUT = ("w_down", "w_shared_down", "w_res_down", "w_ch_down")


def unpack_weight(name: str, t: TernaryTensor, cfg: ModelConfig,
                  plan: DimPlan | None = None, host: bool = True):
    """Inverse of :func:`pack_weight`: packed tensor -> logical (K, N) int8
    trits in HF orientation (the head and chunk padding dropped); a numpy
    array, or with ``host`` False a tensor on the packed tensor's device."""
    plan = plan or make_plan(cfg)
    hd, hd_p = plan.hd, plan.hd_p
    name = name.removeprefix("vis_")
    w = unpack_ternary(t)

    def at(idx):
        return torch.as_tensor(idx, device=w.device)

    def gather_head_cols(w2, heads):
        if hd == hd_p:
            return w2
        k = w2.shape[0]
        return w2.reshape(k, heads, hd_p)[
            :, :, at(head_positions(hd, hd_p))].reshape(k, heads * hd)

    if name in ("wq", "wk", "wv", "w_attn_gate"):
        w = gather_head_cols(
            w, cfg.n_kv_heads if name in ("wk", "wv") else cfg.n_heads)
    elif name == "wo":
        w = w[at(chunk_positions(cfg.n_heads * hd_p, plan.wo_chunk,
                                 plan.wo_chunk_p))]
        if hd != hd_p:
            w = w.reshape(cfg.n_heads, hd_p, -1)[
                :, at(head_positions(hd, hd_p))].reshape(cfg.n_heads * hd, -1)
    elif name in _FFN_IN:
        w = w[:, at(chunk_positions(cfg.d_ff, plan.ff_chunk, plan.ff_chunk_p))]
    elif name in _FFN_OUT:
        w = w[at(chunk_positions(cfg.d_ff, plan.ff_chunk, plan.ff_chunk_p))]
    elif name not in ("w_lin_attn",) + MLA_PROJECTIONS:
        raise KeyError(name)
    return w.cpu().numpy() if host else w


# --- modules -------------------------------------------------------------------

class TernaryLinear(nn.Module):
    """A packed ternary projection x (..., K) -> (..., N).

    Buffers: ``packed`` (Kp/r, Np) uint8 and ``scale`` (per-tensor () or
    per-channel (Np,)) float32; ``w_scale`` is the scale broadcast to (Np,)
    once, for the kernels' epilogue.  With ``lora`` (a dict of ``lora_a``
    (Kp, r), ``lora_b`` (r, Np) and the float32 ``lora_scale``) the plain
    call adds the adapter's delta.
    """

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 spec: TernarySpec, lora: dict | None = None):
        super().__init__()
        if packed.shape[0] * TRITS_PER_BYTE[spec.fmt] != padded_k(
                spec.k, spec.fmt, spec.kb):
            raise ValueError(f"packed {tuple(packed.shape)} does not fit "
                             f"K={spec.k} ({spec.fmt})")
        self.k, self.n, self.fmt, self.kb = spec.k, spec.n, spec.fmt, spec.kb
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale.to(torch.float32))
        t = TernaryTensor(packed, self.scale, self.k, self.n, self.fmt,
                          self.kb)
        self.register_buffer("w_scale", t.scale_vector(), persistent=False)
        self.has_lora = bool(lora)
        for name in LORA_LEAVES if lora else ():
            self.register_buffer(name, lora[name])

    def tensor(self) -> TernaryTensor:
        return TernaryTensor(self.packed, self.w_scale, self.k, self.n,
                             self.fmt, self.kb)

    @property
    def fusable(self) -> bool:
        """The JAX gates' ``can_fuse``: packed, no LoRA delta."""
        return not self.has_lora

    def forward(self, x: torch.Tensor, impl: str = "auto", reduce=None,
                **fused) -> torch.Tensor:
        """ternary_matmul, or ternary_matmul_fused when keywords are given.
        ``reduce``: K is sharded over that tensor-parallel Group, and the
        product (LoRA delta included) is summed over it."""
        if fused:
            if self.has_lora:
                raise ValueError("a projection with a LoRA runs unfused")
            return ternary_matmul_fused(x, self.tensor(), impl=impl, **fused)
        out = ternary_matmul(x, self.tensor(), impl=impl, tp_group=reduce)
        if self.has_lora:
            out = out + psum(self.lora_delta(x), reduce).to(out.dtype)
        return out

    def lora_delta(self, x: torch.Tensor) -> torch.Tensor:
        """float32 ``(x @ A) @ B * lora_scale``: the inner product in A's
        dtype, the outer one accumulated in float32 (JAX: ``jnp.dot(jnp.dot(
        h.astype(a.dtype), a), b, preferred_element_type=float32)``)."""
        inner = torch.matmul(x.to(self.lora_a.dtype), self.lora_a)
        return torch.matmul(inner.to(torch.float32),
                            self.lora_b.to(torch.float32)) * self.lora_scale

    def lora_tree(self) -> dict[str, torch.Tensor]:
        return ({n: getattr(self, n) for n in LORA_LEAVES} if self.has_lora
                else {})


class ExpertStack(nn.Module):
    """A MoE layer's bank of E experts for one projection: ``packed`` (E,
    Kp/r, Np) uint8 and ``scale`` (E,) float32 buffers; :meth:`tensor`
    gives expert e's (K, N) :class:`TernaryTensor` (views, no copy)."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 spec: TernarySpec):
        super().__init__()
        if packed.dim() != 3 or packed.shape[1] * TRITS_PER_BYTE[
                spec.fmt] != padded_k(spec.k, spec.fmt, spec.kb):
            raise ValueError(f"expert stack {tuple(packed.shape)} does not "
                             f"fit K={spec.k} ({spec.fmt})")
        self.k, self.n, self.fmt, self.kb = spec.k, spec.n, spec.fmt, spec.kb
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale.to(torch.float32))
        self.register_buffer("w_scale", torch.stack([
            TernaryTensor(packed[e], self.scale[e], self.k, self.n, self.fmt,
                          self.kb).scale_vector()
            for e in range(packed.shape[0])]), persistent=False)

    def __len__(self) -> int:
        return self.packed.shape[0]

    def tensor(self, e: int) -> TernaryTensor:
        return TernaryTensor(self.packed[e], self.w_scale[e], self.k, self.n,
                             self.fmt, self.kb)


class DenseLinear(nn.Module):
    """A float-twin projection: a dense (K, N) weight (``{"dense": ...}``
    leaves, ``train/finetune.py:float_twin_params``), multiplied as the
    JAX package's ``mm`` multiplies it: x cast to the weight's dtype, the
    product accumulated in float32, the result in x's dtype.  It never
    fuses (the JAX gates' ``can_fuse`` refuses a dense leaf)."""

    fusable = False

    def __init__(self, dense: torch.Tensor):
        super().__init__()
        self.register_buffer("dense", dense)

    def tensor(self) -> torch.Tensor:
        return self.dense

    def forward(self, x: torch.Tensor, impl: str = "auto", reduce=None,
                **fused) -> torch.Tensor:
        if fused:
            raise ValueError("a float-twin projection runs unfused")
        return dense_matmul(x, self.dense, reduce)


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 reduce=None) -> torch.Tensor:
    """``jnp.dot(x.astype(w.dtype), w, preferred_element_type=float32)
    .astype(x.dtype)``: products of the cast operands in float32 (summed
    over the ``reduce`` Group before the cast, the float twin's K-sharded
    form)."""
    out = torch.matmul(x.to(w.dtype).to(torch.float32), w.to(torch.float32))
    return psum(out, reduce).to(x.dtype)


def matmul_any(x: torch.Tensor, w, impl: str = "auto") -> torch.Tensor:
    """x @ a projection's weight: a :class:`TernaryTensor` through
    ``ternary_matmul`` (#4 / #3), a float twin's dense tensor as a plain
    float product."""
    if isinstance(w, torch.Tensor):
        return dense_matmul(x, w)
    return ternary_matmul(x, w, impl=impl)


class DenseExpertStack(nn.Module):
    """A float twin's bank of E experts for one projection: ``dense`` (E,
    K, N); :meth:`tensor` gives expert e's (K, N) weight (a view)."""

    def __init__(self, dense: torch.Tensor):
        super().__init__()
        self.register_buffer("dense", dense)

    def __len__(self) -> int:
        return self.dense.shape[0]

    def tensor(self, e: int) -> torch.Tensor:
        return self.dense[e]


class DecoderLayer(nn.Module):
    """One layer's projections (``proj``), its expert stacks (``experts``,
    in a MoE layer) and vectors (buffers: the norm gains in float32, the
    knobs' and MoE vectors as stored, MLA's float factors ``w_uk`` /
    ``w_uv``)."""

    def __init__(self, tree: dict[str, Any], specs: dict[str, TernarySpec]):
        super().__init__()
        unknown = (set(tree) - set(PROJECTIONS) - set(EXPERT_PROJECTIONS)
                   - set(LAYER_VECTORS) - set(MLA_DENSE))
        if unknown:
            raise NotImplementedError(f"layer tensors not ported: {unknown}")
        for name in PROJECTIONS + EXPERT_PROJECTIONS:
            leaves = tree.get(name, {})
            if "dense" in leaves and "lora_a" in leaves:
                raise NotImplementedError(
                    f"{name}: a LoRA on a float-twin weight is not ported")
            if name in MLA_PROJECTIONS and "lora_a" in leaves:
                # the JAX package runs them through mm, which adds no delta
                raise ValueError(
                    f"a LoRA on MLA's {name} is not applied (the reference "
                    "adds none to the MLA projections)")
        def dims(name):
            leaves = tree[name]
            return leaves["dense" if "dense" in leaves else "packed"].dim()

        stacks = {name for name in EXPERT_PROJECTIONS if name in tree
                  and dims(name) == 3}

        def linear(name):
            leaves = tree[name]
            if "dense" in leaves:
                return DenseLinear(leaves["dense"])
            return TernaryLinear(
                leaves["packed"], leaves["scale"], specs[name],
                {k: leaves[k] for k in LORA_LEAVES if k in leaves})

        def stack(name):
            leaves = tree[name]
            if "dense" in leaves:
                return DenseExpertStack(leaves["dense"])
            return ExpertStack(leaves["packed"], leaves["scale"], specs[name])

        self.proj = nn.ModuleDict({
            name: linear(name)
            for name in PROJECTIONS if name in tree and name not in stacks
        })
        self.experts = nn.ModuleDict({
            name: stack(name) for name in EXPERT_PROJECTIONS if name in stacks
        })
        for name in LAYER_VECTORS:
            if name in tree:
                v = tree[name]
                self.register_buffer(
                    name, v.to(torch.float32) if name in NORMS else v)
        for name in MLA_DENSE:
            if name in tree:
                self.register_buffer(name, tree[name]["dense"])

    @property
    def fused(self) -> bool:
        return "wqkv" in self.proj

    @property
    def mla(self) -> bool:
        return "wkv_a" in self.proj

    @property
    def has_attn(self) -> bool:
        """Softmax attention, MLA's included (deci's linear and
        attention-free layers have none)."""
        return "wq" in self.proj or "wqkv" in self.proj or self.mla

    @property
    def has_ffn(self) -> bool:
        """An FFN, dense or routed (deci's FFN-free layers have none)."""
        return (hasattr(self, "router") or any(
            n in self.proj for n in ("w_gate", "w_up", "w_gateup")))

    def vec(self, name: str) -> torch.Tensor | None:
        return getattr(self, name, None)

    def visual(self) -> "DecoderLayer":
        """cogvlm's image rows: this layer with its ``vis_*`` projections in
        place of the language ones (norms and the rest shared); itself when
        it has none."""
        vis = {n[4:]: m for n, m in self.proj.items() if n.startswith("vis_")}
        if not vis:
            return self
        twin = copy.copy(self)
        twin._modules = dict(self._modules)
        twin._modules["proj"] = nn.ModuleDict({
            **{n: m for n, m in self.proj.items()
               if not n.startswith("vis_")}, **vis})
        return twin


class StackedLayers(nn.Module):
    """The stacked tree: each weight is one (L, ...) tensor, as checkpoints
    store it.  Indexing gives a :class:`DecoderLayer` of views."""

    def __init__(self, tree: dict[str, Any], specs: dict[str, TernarySpec],
                 n_layers: int):
        super().__init__()
        self.n_layers = n_layers
        self._specs = specs
        self._names = []
        for name, v in tree.items():
            leaves = v.items() if isinstance(v, dict) else [("", v)]
            for leaf, t in leaves:
                if t.shape[0] != n_layers:
                    raise ValueError(f"{name}.{leaf}: leading dim != L")
                key = f"{name}__{leaf}" if leaf else name
                self.register_buffer(key, t)
                self._names.append((name, leaf, key))

    def tree(self, i: int | None = None) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, leaf, key in self._names:
            t = getattr(self, key)
            t = t if i is None else t[i]
            if leaf:
                out.setdefault(name, {})[leaf] = t
            else:
                out[name] = t
        return out

    def __len__(self) -> int:
        return self.n_layers

    def __getitem__(self, i: int) -> DecoderLayer:
        return DecoderLayer(self.tree(i), self._specs)


class TransformerLM(nn.Module):
    """Embedding [+ scale, norm, learned positions] -> layers -> final norm
    -> output head [+ bias].

    ``lm_head`` is a bf16 (D, Vp) matrix, or after :func:`quantize_head`
    the int8 ``lm_head_q`` with per-column ``lm_head_scale``; tied models
    use ``embed.T``.  ``tp`` > 1: the tree is one shard of a tp-way split
    (``parallel/sharding.py:shard_params``; local heads and FFN columns);
    ``head_shards`` > 1: the head holds one of that many slices of the
    vocabulary columns (the tp axis' size, also for a MoE model whose axis
    carries experts).  A checkpoint converted from a sequence classifier
    also carries ``rank_head`` {w (D, 1), b (1,)}, which the server's
    rerank scores with.  The per-layer windows and rope flags and the rope
    tables (global, and local for models whose sliding layers rope with
    their own base) follow from the config.
    """

    def __init__(self, cfg: ModelConfig, tree: dict[str, Any], tp: int = 1,
                 head_shards: int = 1):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tp = tp
        self.head_shards = head_shards
        self.plan = make_plan(cfg)
        # each layer's plan (its own heads and FFN width; the model's plan
        # on a uniform stack)
        hetero = cfg.heads_per_layer or cfg.d_ff_per_layer
        self.plans = [make_plan(layer_config(cfg, i)) if hetero else self.plan
                      for i in range(cfg.n_layers)]
        layers = tree["layers"]
        if isinstance(layers, dict):
            if hetero:
                raise ValueError("per-layer head counts or FFN widths take "
                                 "the tuple-layers tree (one per layer)")
            self.layers = StackedLayers(
                layers, layer_specs(cfg, moe="router" in layers, tp=tp),
                cfg.n_layers)
        else:
            if len(layers) != cfg.n_layers:
                raise ValueError(f"{len(layers)} layer trees for "
                                 f"n_layers={cfg.n_layers}")
            self.layers = nn.ModuleList(
                DecoderLayer(lp, layer_specs(cfg, i, moe="router" in lp,
                                             tp=tp))
                for i, lp in enumerate(layers))
        self.register_buffer("embed", tree["embed"])
        self.register_buffer("final_norm", tree["final_norm"].to(torch.float32))
        for name in TOP_VECTORS:
            if name in tree:
                self.register_buffer(name, tree[name])
        head = tree.get("lm_head")
        if isinstance(head, dict):
            self.register_buffer("lm_head_q", head["q"])
            self.register_buffer("lm_head_scale",
                                 head["scale"].to(torch.float32))
        elif head is not None:
            self.register_buffer("lm_head", head)
        rank = tree.get("rank_head")
        if rank is not None:
            # a reranker's classification head (D, 1) [+ bias (1,)]
            self.register_buffer("rank_head_w", rank["w"])
            if "b" in rank:
                self.register_buffer("rank_head_b", rank["b"])
        dev = self.embed.device
        self.rot = rope_width(cfg, self.plan)
        cos, sin, cos_l, sin_l = rope_tables(cfg, self.plan, device=dev)
        for name, t in (("rope_cos", cos), ("rope_sin", sin),
                        ("rope_cos_local", cos_l), ("rope_sin_local", sin_l)):
            if t is not None:
                self.register_buffer(name, t, persistent=False)
        self.windows = layer_windows(cfg)
        self.rope_on = layer_rope_on(cfg)
        sections = (cfg.rope_scaling or {}).get("mrope_section")
        if sections:
            # each frequency's M-RoPE position row (0 T, 1 H, 2 W)
            self.register_buffer("mrope_rows", mrope_row_map(
                tuple(sections), self.rope_cos.shape[-1],
                bool(cfg.rope_scaling.get("mrope_interleaved"))).to(dev),
                persistent=False)
        if cfg.qk_norm and cfg.qk_norm_type == "ln":
            # 1.0 at a head's logical positions (per-head LayerNorm stats)
            valid = torch.zeros(self.plan.hd_p)
            valid[torch.from_numpy(head_positions(self.plan.hd,
                                                  self.plan.hd_p))] = 1.0
            self.register_buffer("head_valid", valid.to(dev),
                                 persistent=False)
        if cfg.pos_embed == "alibi":
            slopes = alibi_slopes(cfg.n_heads)
            if cfg.alibi_scaled:
                # falcon: (scores + alibi) / sqrt(hd), with q pre-scaled
                slopes = slopes / np.sqrt(self.plan.hd)
            self.register_buffer("alibi", torch.from_numpy(slopes).to(dev),
                                 persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def n_logits(self) -> int:
        """The width of the logits ``forward`` returns (the padded vocab)."""
        if hasattr(self, "lm_head_q"):
            return self.lm_head_q.shape[-1]
        if hasattr(self, "lm_head"):
            return self.lm_head.shape[-1]
        return self.embed.shape[0]

    def rope_for(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer i's (cos, sin): the local tables on a sliding layer of a
        model with a local rope base, else the global ones."""
        if self.windows[i] and hasattr(self, "rope_cos_local"):
            return self.rope_cos_local, self.rope_sin_local
        return self.rope_cos, self.rope_sin

    def tree(self) -> dict[str, Any]:
        layers = (self.layers.tree() if isinstance(self.layers, StackedLayers)
                  else [_layer_tree(lp) for lp in self.layers])
        out = {"embed": self.embed, "final_norm": self.final_norm,
               "layers": layers}
        for name in TOP_VECTORS:
            if hasattr(self, name):
                out[name] = getattr(self, name)
        if hasattr(self, "lm_head_q"):
            out["lm_head"] = {"q": self.lm_head_q, "scale": self.lm_head_scale}
        elif hasattr(self, "lm_head"):
            out["lm_head"] = self.lm_head
        if hasattr(self, "rank_head_w"):
            out["rank_head"] = {"w": self.rank_head_w}
            if hasattr(self, "rank_head_b"):
                out["rank_head"]["b"] = self.rank_head_b
        return out

    def forward(self, tokens, positions, kv_cache=None, **kw):
        return forward(self, self.cfg, tokens, positions, kv_cache, **kw)


def _layer_tree(lp: DecoderLayer) -> dict[str, Any]:
    out: dict[str, Any] = {
        name: ({"dense": m.dense} if isinstance(m, DenseLinear) else
               {"packed": m.packed, "scale": m.scale, **m.lora_tree()})
        for name, m in lp.proj.items()
    }
    out.update({name: ({"dense": m.dense}
                       if isinstance(m, DenseExpertStack) else
                       {"packed": m.packed, "scale": m.scale})
                for name, m in lp.experts.items()})
    for name in LAYER_VECTORS:
        if hasattr(lp, name):
            out[name] = getattr(lp, name)
    for name in MLA_DENSE:
        if hasattr(lp, name):
            out[name] = {"dense": getattr(lp, name)}
    return out


# --- parameter construction ----------------------------------------------------

def _mla_vectors(cfg: ModelConfig, ones, draw) -> dict:
    """MLA's per-layer float tensors in the JAX package's ``init_params``
    order: the latent norm's gain (and q-LoRA's), ones; the absorbed
    factors w_uk (L, H, dn, r_kv) and w_uv (L, H, r_kv, v) as ``dense``
    leaves, ``draw(shape)`` each (normals * 0.03)."""
    if not cfg.kv_lora_rank:
        return {}
    h, dn, r_kv = cfg.n_heads, cfg.qk_nope_dim, cfg.kv_lora_rank
    out = {"kv_a_norm": ones(r_kv)}
    if cfg.q_lora_rank:
        out["q_a_norm"] = ones(cfg.q_lora_rank)
    out["w_uk"] = {"dense": draw((h, dn, r_kv))}
    out["w_uv"] = {"dense": draw((h, r_kv, cfg.head_dim_))}
    return out


def _knob_vectors(cfg: ModelConfig, plan: DimPlan, ones, draw) -> dict:
    """The float vectors the JAX package's ``init_params`` lays out for the
    config beside the projections (in its order): the pre-norm gains, the
    LayerNorm biases, the projection and q/k/v biases, the sub-norm, q/k-norm
    and post-norm gains.  ``ones(width)`` makes an (L, width) gain and
    ``draw(width)`` an (L, width) bias of standard normals * 0.02."""
    layers = {"attn_norm": ones(cfg.d_model), "ffn_norm": ones(cfg.d_model)}
    if cfg.norm_type == "ln":
        layers["attn_norm_b"] = draw(cfg.d_model)
        layers["ffn_norm_b"] = draw(cfg.d_model)
    if cfg.proj_bias:
        for nm, width in (("bo", cfg.d_model), ("b_up", plan.ff_p),
                          ("b_down", cfg.d_model)):
            layers[nm] = draw(width)
    if cfg.use_subnorms:
        layers["attn_sub_norm"] = ones(plan.wo_in_p)
        layers["ffn_sub_norm"] = ones(plan.ff_p)
    if cfg.qkv_bias:
        for nm, width in (("bq", plan.q_dim_p), ("bk", plan.kv_dim_p),
                          ("bv", plan.kv_dim_p)):
            layers[nm] = draw(width)
    if cfg.qk_norm:
        layers["q_norm"] = ones(plan.hd_p)
        layers["k_norm"] = ones(plan.hd_p)
    if cfg.post_norms:
        layers["post_attn_norm"] = ones(cfg.d_model)
        layers["post_ffn_norm"] = ones(cfg.d_model)
    return layers


def pack_config(cfg: ModelConfig, name: str) -> ModelConfig:
    """The config whose plan packs projection ``name`` of a uniform stack:
    a MoE model's shared expert, arctic's residual MLP and grovemoe's chunk
    experts at their own FFN widths, every other projection at ``cfg``'s
    (:func:`layer_specs`' widths)."""
    for prefix, width, _ in _side_ffns(cfg):
        if name.startswith(prefix):
            return _ffn_cfg(cfg, width)
    return cfg


def _layer_projections(cfg: ModelConfig, i: int) -> dict:
    """Layer i's projections in the JAX package's ``init_params`` order:
    name -> (K, N, the config that packs it, experts or 0)."""
    d, hd = cfg.d_model, cfg.head_dim_
    cl = layer_config(cfg, i)
    nh, nkv = (cfg.heads_per_layer[i] if cfg.heads_per_layer
               else (cfg.n_heads, cfg.n_kv_heads))
    ff = cfg.d_ff_per_layer[i] if cfg.d_ff_per_layer else cfg.d_ff
    out: dict = {}
    if cfg.kv_lora_rank:
        # MLA: wo, then (after the FFN) wkv_a and the q projections, in the
        # JAX package's order
        out["wo"] = (nh * hd, d, cl, 0)
    elif nh and nkv:
        out.update(wq=(d, nh * hd, cl, 0), wk=(d, nkv * hd, cl, 0),
                   wv=(d, nkv * hd, cl, 0), wo=(nh * hd, d, cl, 0))
    elif nh:
        out["w_lin_attn"] = (d, d, cl, 0)
    if not ff:
        return out
    experts, fc = 0, cl
    if cfg.n_experts:
        if moe_layers(cfg)[i]:
            experts, fc = cfg.n_experts, _ffn_cfg(cfg, cfg.d_ff)
        else:
            ff = cfg.d_ff_dense or cfg.d_ff
            fc = _ffn_cfg(cfg, ff)
    if cfg.ffn_gated:
        out["w_gate"] = (d, ff, fc, experts)
    out["w_up"] = (d, ff, fc, experts)
    out["w_down"] = (ff, d, fc, experts)
    out.update(_mla_projections(cfg))
    return out


def _mla_projections(cfg: ModelConfig) -> dict:
    """MLA's projections in the JAX package's ``init_params`` order: name
    -> (K, N, cfg, 0)."""
    if not cfg.kv_lora_rank:
        return {}
    d, qw = cfg.d_model, cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    out = {"wkv_a": (d, cfg.kv_lora_rank + cfg.qk_rope_dim, cfg, 0)}
    if cfg.q_lora_rank:
        out["wq_a"] = (d, cfg.q_lora_rank, cfg, 0)
        out["wq_b"] = (cfg.q_lora_rank, qw, cfg, 0)
    else:
        out["wq_full"] = (d, qw, cfg, 0)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu") -> TransformerLM:
    """Random ternary model from numpy draws in the JAX package's
    ``init_params`` order (synthetic models for tests).

    A MoE model gets its expert stacks (E packed projections per layer)
    and a float32 router of normals * 0.02 as the JAX package lays them
    out; the parts the JAX package's ``init_params`` does not lay out are
    drawn after everything it draws: the shared expert, arctic's residual
    MLP (with its ``moe_norm`` gain of ones), grovemoe's chunk experts and
    gpt-oss's expert biases.  Dense lead layers and per-layer head counts
    or FFN widths (deci's linear and attention-free layers among them)
    give the tuple-layers tree, one dict per layer."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    plan = make_plan(cfg)
    n_l = cfg.n_layers
    per = [_layer_projections(cfg, i) for i in range(n_l)]
    hetero = bool(cfg.heads_per_layer or cfg.d_ff_per_layer)
    if hetero and (cfg.qkv_bias or cfg.proj_bias or cfg.use_subnorms):
        raise NotImplementedError("init_params lays out no per-layer-width "
                                  "biases or sub-norms")

    def draw_packed(k, n, name, c, experts):
        def one():
            trits = rng.integers(-1, 2, size=(k, n), dtype=np.int8)
            t = pack_weight(name, trits, np.float32(0.05), c, make_plan(c))
            return t.packed, t.scale
        if not experts:
            return one()
        ps, ss = zip(*(one() for _ in range(experts)))
        return torch.stack(ps), torch.stack(ss)

    layers = [dict() for _ in range(n_l)]
    for name in ("wq", "wk", "wv", "wo", "w_lin_attn", "w_gate", "w_up",
                 "w_down") + MLA_PROJECTIONS:
        for i in range(n_l):
            if name in per[i]:
                k, n, c, experts = per[i][name]
                p_, s_ = draw_packed(k, n, name, c, experts)
                layers[i][name] = {"packed": p_, "scale": s_}
    mla = _mla_vectors(cfg, lambda w: torch.ones((n_l, w)),
                       lambda shape: torch.from_numpy(
                           rng.standard_normal((n_l,) + shape) * 0.03).to(
                               torch.float32))
    vectors = _knob_vectors(
        cfg, plan,
        lambda w: torch.ones((n_l, w), dtype=torch.float32),
        lambda w: torch.from_numpy(
            rng.standard_normal((n_l, w)) * 0.02).to(torch.float32))
    moe = moe_layers(cfg)
    if cfg.n_experts:
        vectors["router"] = torch.from_numpy(rng.standard_normal(
            (n_l, cfg.d_model, cfg.n_experts)) * 0.02).to(torch.float32)
    tree: dict[str, Any] = {
        "embed": torch.from_numpy(
            rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.02
        ).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32),
    }
    if cfg.norm_type == "ln":
        tree["final_norm_b"] = torch.from_numpy(
            rng.standard_normal((cfg.d_model,)) * 0.02).to(torch.float32)
    if not cfg.tie_embeddings:
        head = rng.standard_normal((cfg.d_model, plan.vocab_p)) * 0.02
        head[:, cfg.vocab_size:] = 0.0
        tree["lm_head"] = torch.from_numpy(head).to(dtype)
    # the parts the JAX package's init_params does not lay out
    for prefix, width, experts in _side_ffns(cfg):
        c = _ffn_cfg(cfg, width)
        for i in range(n_l):
            if not moe[i]:
                continue
            for nm, (k, n) in ((prefix + "gate", (cfg.d_model, width)),
                               (prefix + "up", (cfg.d_model, width)),
                               (prefix + "down", (width, cfg.d_model))):
                p_, s_ = draw_packed(k, n, nm, c, experts)
                layers[i][nm] = {"packed": p_, "scale": s_}
    if cfg.moe_parallel:
        vectors["moe_norm"] = torch.ones((n_l, cfg.d_model))
    if cfg.moe_expert_bias:
        ff_p = make_plan(_ffn_cfg(cfg, cfg.d_ff)).ff_p
        for nm, w in (("eb_gate", ff_p), ("eb_up", ff_p),
                      ("eb_down", cfg.d_model)):
            vectors[nm] = torch.from_numpy(rng.standard_normal(
                (n_l, cfg.n_experts, w)) * 0.02).to(torch.float32)
    for nm, v in {**mla, **vectors}.items():
        for i in range(n_l):
            if nm in MOE_VECTORS + ("moe_norm",) and not moe[i]:
                continue
            layers[i][nm] = ({"dense": v["dense"][i]} if nm in MLA_DENSE
                             else v[i])
    if layers_tuple(cfg):
        tree["layers"] = layers
    else:
        tree["layers"] = {
            nm: ({leaf: torch.stack([lp[nm][leaf] for lp in layers])
                  for leaf in layers[0][nm]}
                 if isinstance(layers[0][nm], dict)
                 else torch.stack([lp[nm] for lp in layers]))
            for nm in layers[0]}
    return TransformerLM(cfg, _tree_to(tree, device))


def init_params_fast(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                     device: str | torch.device | None = None) -> TransformerLM:
    """Random packed model generated directly on ``device`` with a seeded
    ``torch.Generator`` (benchmark weights at full size in seconds).

    Bytes come from :func:`random_packed_bytes` (valid trits only);
    padding positions get random trits too.  The float vectors are those
    :func:`init_params` lays out (gains of one, biases of normals * 0.02,
    MLA's absorbed factors normals * 0.03), so every config that runs from
    ``init_params`` runs from these too.  A MoE layer gets its expert
    banks, its shared / residual / chunk experts and the JAX package's fast
    router; a config whose layers differ (dense lead layers, per-layer
    heads) gets the tuple-layers tree, one dict per layer.
    """
    check_supported(cfg)
    device = resolve_device(device)
    plan = make_plan(cfg)
    r = TRITS_PER_BYTE[cfg.weight_fmt]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def packed(spec: TernarySpec, lead: tuple) -> torch.Tensor:
        shape = (padded_k(spec.k, spec.fmt, spec.kb) // r,
                 -(-spec.n // 128) * 128)
        if len(lead) == 1:
            return random_packed_bytes(lead + shape, cfg.weight_fmt, gen,
                                       device)
        # an expert bank one layer at a time: its int32 draws take four
        # times its bytes at once
        out = torch.empty(lead + shape, dtype=torch.uint8, device=device)
        for i in range(lead[0]):
            out[i] = random_packed_bytes(lead[1:] + shape, cfg.weight_fmt,
                                         gen, device)
        return out

    def randn(*shape) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)

    def stack(n_l: int, i: int, moe: bool) -> dict:
        """n_l layers shaped as layer i: the layer tree with (n_l, ...)
        leaves."""
        specs = layer_specs(cfg, i, moe=moe if cfg.n_experts else None)
        names = {n: e for n, (*_, e) in _layer_projections(cfg, i).items()}
        if moe:
            names.update({p + n: e for p, _, e in _side_ffns(cfg)
                          for n in ("gate", "up", "down")})
        layers: dict[str, Any] = {}
        for name, e in names.items():
            lead = (n_l,) + ((e,) if e else ())
            layers[name] = {"packed": packed(specs[name], lead),
                            "scale": torch.full(lead, 0.05, device=device)}
        if moe:
            # the JAX package's fast router: one bf16 linspace per layer
            layers["router"] = torch.linspace(
                -0.02, 0.02, cfg.n_experts, device=device).to(
                    torch.bfloat16).expand(n_l, cfg.d_model,
                                           cfg.n_experts).contiguous()
            if cfg.moe_parallel:
                layers["moe_norm"] = torch.ones((n_l, cfg.d_model),
                                                device=device)
        layers.update(_mla_vectors(
            cfg, lambda w: torch.ones((n_l, w), device=device),
            lambda shape: randn(n_l, *shape) * 0.03))
        layers.update(_knob_vectors(
            cfg, plan, lambda w: torch.ones((n_l, w), device=device),
            lambda w: randn(n_l, w) * 0.02))
        return layers

    if layers_tuple(cfg):
        if cfg.qkv_bias or cfg.proj_bias or cfg.use_subnorms:
            raise NotImplementedError("init_params_fast lays out no "
                                      "per-layer-width biases or sub-norms")
        moe = moe_layers(cfg)
        tree_layers: Any = []
        for i in range(cfg.n_layers):
            one = stack(1, i, moe[i])
            tree_layers.append({
                k: ({leaf: t[0] for leaf, t in v.items()}
                    if isinstance(v, dict) else v[0])
                for k, v in one.items()})
    else:
        tree_layers = stack(cfg.n_layers, 0, bool(cfg.n_experts))
    tree: dict[str, Any] = {
        "embed": (randn(cfg.vocab_size, cfg.d_model) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), device=device),
        "layers": tree_layers,
    }
    if cfg.norm_type == "ln":
        tree["final_norm_b"] = randn(cfg.d_model) * 0.02
    if not cfg.tie_embeddings:
        tree["lm_head"] = (randn(cfg.d_model, plan.vocab_p) * 0.02).to(dtype)
    return TransformerLM(cfg, tree)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def quantize_head(model: TransformerLM) -> TransformerLM:
    """bf16 lm_head -> int8 codes + per-column max-abs scales (halves the
    head's bytes per decode step)."""
    if not hasattr(model, "lm_head"):
        return model
    wf = model.lm_head.to(torch.float32)
    amax = wf.abs().amax(dim=0)
    inv = torch.where(amax > 0, true_div(127.0, torch.clamp(amax, min=1e-30)),
                      torch.zeros_like(amax))
    q = torch.clamp(torch.round(wf * inv[None, :]), -127, 127).to(torch.int8)
    tree = model.tree()
    # the JAX package's jitted ``amax / 127.0`` compiles to a multiply by
    # the float32 reciprocal
    tree["lm_head"] = {"q": q, "scale": amax * RECIP_127}
    return TransformerLM(model.cfg, tree, tp=model.tp,
                         head_shards=model.head_shards)


def fuse_projections(model: TransformerLM, cfg: ModelConfig) -> TransformerLM:
    """Concatenate wq|wk|wv -> wqkv and w_gate|w_up -> w_gateup along N (the
    byte layout is row-major over K slabs, so packed columns concatenate
    exactly); per-tensor scales become one per-channel vector.  Stacked
    trees only.  As in the JAX package: a no-op when already fused or
    unrolled (the tuple-layers trees of heterogeneous stacks stay apart),
    for a model with q/k/v biases, or when a LoRA sits on
    wq/wk/wv/w_gate/w_up or they are a float twin's dense weights;
    gate|up fuse only for a gated FFN without
    projection biases, and never in a MoE model (its experts keep their
    stacks)."""
    if not isinstance(model.layers, StackedLayers):
        return model
    tree = model.tree()
    layers = dict(tree["layers"])
    if "wqkv" in layers or cfg.qkv_bias or any(
            leaf in layers.get(n, {}) for leaf in ("lora_a", "dense")
            for n in _UNFUSED_BY_LORA):
        return model
    plan = make_plan(cfg)

    def fuse(names, widths, new):
        packs = [layers[n]["packed"] for n in names]
        l = packs[0].shape[0]
        scales = [layers[n]["scale"].to(torch.float32).reshape(l, -1)
                  .expand(l, w) for n, w in zip(names, widths)]
        layers[new] = {"packed": torch.cat(packs, dim=-1),
                       "scale": torch.cat(scales, dim=-1).contiguous()}
        for n in names:
            del layers[n]

    # cogvlm's visual twins fuse into their own leaves, so an image row's
    # swap (DecoderLayer.visual) finds the visual qkv and gate|up
    for pre in ("", "vis_"):
        if all(pre + n in layers for n in ("wq", "wk", "wv")):
            fuse([pre + "wq", pre + "wk", pre + "wv"],
                 [plan.q_dim_p, plan.kv_dim_p, plan.kv_dim_p], pre + "wqkv")
        if (not cfg.n_experts and cfg.ffn_gated and not cfg.proj_bias
                and pre + "w_gate" in layers):
            fuse([pre + "w_gate", pre + "w_up"], [plan.ff_p, plan.ff_p],
                 pre + "w_gateup")
    tree["layers"] = layers
    return TransformerLM(cfg, tree)


def unstack_layers(model: TransformerLM, cfg: ModelConfig) -> TransformerLM:
    """Stacked tree -> one :class:`DecoderLayer` per layer (views of the
    stacked tensors; no copy)."""
    if not isinstance(model.layers, StackedLayers):
        return model
    tree = model.tree()
    tree["layers"] = [model.layers.tree(i) for i in range(cfg.n_layers)]
    return TransformerLM(cfg, tree, tp=model.tp,
                         head_shards=model.head_shards)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int | None = None,
                  dtype=torch.bfloat16, device="cpu",
                  quantized: bool = False, layout: str = "layers",
                  tp: int = 1) -> dict:
    """The slot cache: each layer's rows hold that layer's own KV heads
    (:func:`layer_kv_heads`; cfg.n_kv_heads, the largest, on every layer
    of a uniform stack; a tp-way shard's 1/tp of them) of the padded head
    width.  An MLA model's holds one latent row per position: one head of
    ``kv_lora_rank + qk_rope_dim`` padded to a multiple of 128 (k =
    [latent | k_pe | 0], v = [latent | 0]).  ``layout`` "stacked" gives
    (L, ...) tensors (runtime/kv_cache.py)."""
    s = max_len or cfg.max_seq_len
    if cfg.kv_lora_rank:
        w_row = cfg.kv_lora_rank + cfg.qk_rope_dim
        return new_cache(batch, s, (1,) * cfg.n_layers, w_row + (-w_row) % 128,
                         dtype=dtype, device=device, quantized=quantized,
                         layout=layout)
    return new_cache(batch, s, tuple(h // tp for h in layer_kv_heads(cfg)),
                     make_plan(cfg).hd_p, dtype=dtype, device=device,
                     quantized=quantized, layout=layout)


# --- forward ---------------------------------------------------------------------

def _norm_d(z: torch.Tensor, lp: DecoderLayer, name: str,
            cfg: ModelConfig) -> torch.Tensor:
    """A d_model-wide pre/post norm of the layer: RMS or LayerNorm (with
    the layer's ``<name>_b`` bias where it has one), (1 + w) gains under
    ``norm_plus_one``."""
    if cfg.norm_type == "rms":
        return nrm.rms(z, getattr(lp, name), cfg.rms_eps, cfg.d_model,
                    cfg.norm_plus_one)
    return nrm.layer_norm(z, getattr(lp, name), lp.vec(name + "_b"),
                          cfg.rms_eps, cfg.d_model, cfg.norm_plus_one)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(true_div(x, cap))


def _mask(kp, qp, window: int, chunked: bool, override=None,
          causal: bool = True):
    """The mask of key positions kp against query positions qp: causal (or
    every key at a position >= 0 when not ``causal``), or ``override`` (B,
    T, S) where given (the caller owns causality), and the sliding window
    when window > 0: chunked (kp and qp in the same window-wide chunk),
    rolling (kp > qp - window) or, bidirectional, symmetric (|kp - qp| <
    window).  (The JAX package drops the window under an override, so its
    lookahead rounds on a sliding-window model attend past the window.)"""
    if override is not None:
        mask = override[:, None, None, :, :]
    elif causal:
        mask = (kp <= qp) & (kp >= 0)
    else:
        mask = kp >= 0
    if window > 0:
        if chunked:
            mask = mask & (torch.div(kp, window, rounding_mode="floor")
                           == torch.div(qp, window, rounding_mode="floor"))
        elif causal:
            mask = mask & (kp > qp - window)
        else:
            mask = mask & ((kp - qp).abs() < window)
    return mask


def _attention(q, k, v, q_pos, k_pos, hd_logical, scale=0.0, k_scale=None,
               v_scale=None, mask_override=None, softcap=0.0, window=0,
               alibi=None, sinks=None, chunked_window=False, causal=True):
    """Causal GQA attention, or bidirectional with ``causal=False`` (the
    diffusion LMs and the decoder embedders; a window then masks both
    ways).  q (B, T, H, hd), k/v (B, S, Hkv, hd); returns
    float32 (B, T, H, hd).  ``mask_override`` (B, T, S) bool replaces the
    causal mask (the caller owns causality); the window still applies.

    The scores take, in the JAX package's order: the int8 key scales, the
    ``softcap`` (tanh capping), the ALiBi bias ``alibi`` (H,) slopes times
    (k_pos - q_pos), the mask (causal, and the sliding ``window`` when > 0:
    rolling, or chunked with ``chunked_window``); ``sinks`` (H,) logits
    join the softmax's denominator without a value row.

    k_scale/v_scale (B, S, Hkv): deferred int8-KV dequantization; the codes
    stay int8 and the per-row scales fold into the scores (scores·ks) and
    the probabilities (p·vs).  Short KV takes one dense softmax; past
    ``ATTN_CHUNK`` keys it streams chunks through an online softmax
    (:func:`_attention_chunked`, which takes dequantized values)."""
    kw = dict(softcap=softcap, window=window, alibi=alibi, sinks=sinks,
              chunked_window=chunked_window, causal=causal)
    if k.shape[1] > ATTN_CHUNK:
        if k_scale is not None:
            k = dequantize_kv(k, k_scale)
            v = dequantize_kv(v, v_scale)
        return _attention_chunked(q, k, v, q_pos, k_pos, hd_logical, scale,
                                  mask_override=mask_override, **kw)
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.to(torch.float32) * (scale or 1.0 / math.sqrt(hd_logical))
    qf = qf.reshape(b, t, hkv, g, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.to(torch.float32))
    if k_scale is not None:
        # true scores = q · (codes * ks) == (q · codes) * ks
        scores = scores * k_scale.to(torch.float32).permute(0, 2, 1)[
            :, :, None, None, :]
    if softcap:
        scores = _softcap(scores, softcap)
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    if alibi is not None:
        scores = scores + (alibi.to(torch.float32).reshape(1, hkv, g, 1, 1)
                           * (kp - qp).to(torch.float32))
    mask = _mask(kp, qp, window, chunked_window, mask_override, causal)
    scores = scores.masked_fill(~mask, -1e30)
    if sinks is not None:
        sk = sinks.to(torch.float32).reshape(1, hkv, g, 1)
        m = torch.maximum(scores.amax(dim=-1), sk)
        p = torch.exp(scores - m[..., None]).masked_fill(~mask, 0.0)
        p = p / (p.sum(dim=-1) + torch.exp(sk - m))[..., None]
    else:
        p = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        # out = p · (codes * vs) == (p * vs) · codes
        p = p * v_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return out.reshape(b, t, h, v.shape[-1])


def _attention_chunked(q, k, v, q_pos, k_pos, hd_logical, scale=0.0,
                       chunk=ATTN_CHUNK, mask_override=None, **kw):
    """Online-softmax attention over KV chunks (same semantics as the dense
    path; O(T * chunk) live scores instead of O(T * S))."""
    blocks = ((k[:, o:o + chunk], v[:, o:o + chunk], k_pos[:, o:o + chunk],
               None if mask_override is None
               else mask_override[:, :, o:o + chunk])
              for o in range(0, k.shape[1], chunk))
    return _online_attention(q, blocks, q_pos, hd_logical, k.shape[2],
                             v.shape[-1], scale, **kw)


def _ring_attention(q, k, v, q_pos, k_pos, hd_logical, sp, scale=0.0, **kw):
    """Ring (blockwise) context-parallel attention, the JAX package's
    ``_ring_attention``: each rank of the sequence-parallel Group ``sp``
    holds its T/sp slice of K/V; the blocks, with their global positions,
    go round the ring (``ppermute``, sp steps, the last bringing each block
    home) through the online softmax, so a rank never holds more than one
    block of the context."""
    perm = [(i, (i + 1) % sp.size) for i in range(sp.size)]

    def blocks():
        kb, vb, kpb = k, v, k_pos
        for _ in range(sp.size):
            yield kb, vb, kpb, None
            kb, vb, kpb = ppermute((kb, vb, kpb), sp, perm)

    return _online_attention(q, blocks(), q_pos, hd_logical, k.shape[2],
                             v.shape[-1], scale, **kw)


def _online_attention(q, blocks, q_pos, hd_logical, hkv, hd_v, scale=0.0,
                      softcap=0.0, window=0, alibi=None, sinks=None,
                      chunked_window=False, causal=True):
    """The float32 online softmax over KV ``blocks`` of (k, v, k_pos, mask
    override or None), in order, with :func:`_attention`'s scores and
    masks; sinks enter as the recurrence's initial state (m0 = sink logit,
    l0 = 1, acc = 0).  Returns float32 (B, T, H, hd_v)."""
    b, t, h, hd = q.shape
    g = h // hkv
    qf = q.to(torch.float32) * (scale or 1.0 / math.sqrt(hd_logical))
    qf = qf.reshape(b, t, hkv, g, hd)
    qp = q_pos[:, None, None, :, None]
    if sinks is not None:
        m = sinks.to(torch.float32).reshape(1, hkv, g, 1).expand(
            b, hkv, g, t).clone()
        l = torch.ones((b, hkv, g, t), device=q.device)
    else:
        m = torch.full((b, hkv, g, t), -math.inf, device=q.device)
        l = torch.zeros((b, hkv, g, t), device=q.device)
    acc = torch.zeros((b, hkv, g, t, hd_v), device=q.device)
    slopes = (alibi.to(torch.float32).reshape(1, hkv, g, 1, 1)
              if alibi is not None else None)
    for kc, vc, kp, override in blocks:
        kp = kp[:, None, None, None, :]
        sc = torch.einsum("bthgd,bshd->bhgts", qf, kc.to(torch.float32))
        if softcap:
            sc = _softcap(sc, softcap)
        if slopes is not None:
            sc = sc + slopes * (kp - qp).to(torch.float32)
        masked = ~_mask(kp, qp, window, chunked_window, override, causal)
        # a train step differentiates through here (autograd keeps exp's
        # output), so under grad nothing is written in place
        grad = sc.requires_grad
        sc = sc.masked_fill(masked, -1e30) if grad else sc.masked_fill_(
            masked, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = (torch.exp(sc - m_new[..., None]).masked_fill(masked, 0.0) if grad
             else sc.sub_(m_new[..., None]).exp_().masked_fill_(masked, 0.0))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgts,bshd->bhgtd", p, vc.to(torch.float32))
        m = m_new
        del sc, p
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b, hkv, g, t, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd_v)


@dataclasses.dataclass(frozen=True)
class Par:
    """The mesh axes a forward runs over, each a ``parallel/_comm.py``
    Group or None: tensor parallel (``tp``: local heads and FFN columns,
    wo / w_down summed, the sub-norm statistics summed, the vocabulary
    gathered), expert parallel (``ep``: local experts, the routed output
    summed) and sequence parallel (``sp``: local tokens, ring attention)."""

    tp: Any = None
    ep: Any = None
    sp: Any = None

    @property
    def tp_size(self) -> int:
        return self.tp.size if self.tp is not None else 1

    @property
    def reduce(self):
        """The tp Group where it has more than one rank, else None."""
        return self.tp if self.tp_size > 1 else None


SERIAL = Par()


class _SlotKV:
    """Cache IO of layer i, in place.

    Without ``slots`` the forward's rows are the cache's slots; with
    ``slots`` (m,) they are those slots of the cache (a batched prefill):
    their rows are written in place and only those slots are read back.
    """

    def __init__(self, cache: dict, i: int, slots: torch.Tensor | None):
        self.cache, self.i, self.slots = cache, i, slots
        self.quant = is_quantized(cache)

    def _layer(self, name: str) -> torch.Tensor:
        return self.cache[name][self.i]

    def _names(self):
        return ("k", "v", "k_scale", "v_scale") if self.quant else ("k", "v")

    def update(self, k, v, start):
        """Write the new rows; returns (k, v, k_scale, v_scale) to attend
        over (scales None for a bf16 cache)."""
        if self.quant:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            rows = (k, v, ks, vs)
        else:
            kc = self._layer("k")
            rows = (k.to(kc.dtype), v.to(kc.dtype))
        arrs = [self._layer(n) for n in self._names()]
        b, t = k.shape[:2]
        if t == 1 and self.slots is None:
            # one launch for the layer: K, V and the q8 scale planes
            write_rows_pair(arrs[0], arrs[1], rows[0], rows[1], start,
                            scales=tuple(arrs[2:] + list(rows[2:])) or None)
        else:
            s = arrs[0].shape[1]
            idx = (self.slots if self.slots is not None
                   else torch.arange(b, device=k.device))[:, None]
            # pad tokens of a prefill bucket may run past the cache: they
            # land on the scratch row S-1, which never holds a live row
            pos = torch.clamp(start[:, None] + torch.arange(t, device=k.device),
                              max=s - 1)
            for arr, u in zip(arrs, rows):
                arr[idx, pos] = u
        return self.peek()

    def peek(self):
        """The cache's rows as :meth:`update` returns them, nothing
        written (the ``no_kv_write`` ablation)."""
        arrs = [self._layer(n) for n in self._names()]
        if self.slots is not None:
            arrs = [a[self.slots] for a in arrs]
        return tuple(arrs) + ((None, None) if not self.quant else ())

    def fused_attend(self, q, k, v, start, window, scale):
        """KV row write + attention in one kernel launch (#7 for a bf16
        cache, #8 for an int8 one); the cache is read once in its storage
        type."""
        if self.quant:
            return dattn.decode_attention_int8(
                q, k, v, self._layer("k"), self._layer("v"),
                self._layer("k_scale"), self._layer("v_scale"), start, window,
                scale=scale)
        return dattn.decode_attention(q, k, v, self._layer("k"),
                                      self._layer("v"), start, window,
                                      scale=scale)


def _fused_attn_ok(cfg: ModelConfig, heads: tuple[int, int],
                   widths: tuple[int, int], t: int, kvio: _SlotKV | None,
                   decode_attn: str,
                   attn_mask: torch.Tensor | None = None) -> bool:
    """The decode-attention gate: one token per slot over the whole cache
    under the causal mask (no ``attn_mask`` override), a model whose
    attention the kernels compute (no ALiBi, sinks, softcap, chunked
    windows or bidirectional attention), and the kernels' head shapes:
    the layer's own (query heads, KV heads) and padded (K, V) head
    widths."""
    return (
        decode_attn == "fused" and attn_mask is None
        and kvio is not None and kvio.slots is None and t == 1
        and getattr(cfg, "pos_embed", "rope") != "alibi"
        and not getattr(cfg, "attn_sinks", False)
        and not cfg.attn_logit_softcap
        and getattr(cfg, "swa_type", "window") != "chunked"
        and getattr(cfg, "causal_attn", True)
        and dattn.supports(heads[0], heads[1], *widths)
    )


_ACT = {
    "silu": torch.nn.functional.silu,
    # "gelu" is the tanh approximation, "gelu_exact" the erf form
    "gelu": lambda z: torch.nn.functional.gelu(z, approximate="tanh"),
    "gelu_exact": torch.nn.functional.gelu,
    "relu2": lambda z: torch.square(torch.relu(z)),
    "relu": torch.relu,
}


def _glu(gate, up, cfg: ModelConfig) -> torch.Tensor:
    """float32 act(gate) * up, or the clamped swiglu under ``swiglu_limit``:
    gate clamped to (-inf, limit], up to [-limit, limit], out =
    gate * sigmoid(1.702 * gate) * (up + 1)."""
    gate, up = gate.to(torch.float32), up.to(torch.float32)
    if cfg.swiglu_limit:
        lim = cfg.swiglu_limit
        gate = torch.clamp(gate, max=lim)
        up = torch.clamp(up, -lim, lim)
        return gate * torch.sigmoid(1.702 * gate) * (up + 1.0)
    return _ACT[cfg.act_fn](gate) * up


def _xielu(up, lp: DecoderLayer) -> torch.Tensor:
    """float32 xIELU with the layer's alphas (stored softplus-inverse)."""
    upf = up.to(torch.float32)
    sp = torch.nn.functional.softplus
    ap = sp(lp.xielu_ap.to(torch.float32))
    an = 0.5 + sp(lp.xielu_an.to(torch.float32))
    return torch.where(
        upf > 0, ap * upf * upf + 0.5 * upf,
        (torch.expm1(torch.clamp(upf, max=-1e-6)) - upf) * an + 0.5 * upf)


def _add(x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    return x if bias is None else x + bias.to(x.dtype)


def _qk_norm(q, k, lp: DecoderLayer, cfg: ModelConfig, plan: DimPlan,
             params: TransformerLM):
    """The q/k norm of the config: per-head LayerNorm (chameleon), one RMS
    over the whole width (olmo2), or per-head RMS (qwen3/gemma3)."""
    if cfg.qk_norm_type == "ln":
        valid = params.head_valid
        return (nrm.head_layer_norm(q, lp.q_norm, lp.q_norm_b, valid,
                                    plan.hd).to(q.dtype),
                nrm.head_layer_norm(k, lp.k_norm, lp.k_norm_b, valid,
                                    plan.hd).to(k.dtype))
    if cfg.qk_norm_scope == "whole":
        return (nrm.rms_whole(q, lp.q_norm, cfg.rms_eps, cfg.n_heads * plan.hd),
                nrm.rms_whole(k, lp.k_norm, cfg.rms_eps,
                              cfg.n_kv_heads * plan.hd))
    p1 = cfg.norm_plus_one
    return (nrm.rms(q, lp.q_norm, cfg.rms_eps, plan.hd, p1),
            nrm.rms(k, lp.k_norm, cfg.rms_eps, plan.hd, p1))


def _layer_step(x, lp: DecoderLayer, kvio, *, cfg, plan, params, li,
                safe_pos, rope_pos, k_pos, write_start, decode_attn, impl,
                attn_mask=None, mrope_pos=None, ablate=frozenset(),
                par: Par = SERIAL):
    """One layer, the JAX package's ``layer_step`` for the dense knobs, in
    its order and with its fused gates: qkv fuses (#1 at M <= 64, norm +
    quant + GEMM) under an RMS pre-norm; wo fuses with its residual without
    post-norms, a parallel residual or projection biases; the FFN fuses
    for a silu-gated one under the same terms plus an RMS pre-norm and no
    swiglu clamp, in a model without experts.  Any projection a gate leaves
    unfused runs #4 / #3, every expert's gate, up and down among them.

    ``plan`` is the layer's own (its heads and FFN width).  deci's layer
    kinds: a layer without an FFN returns its input whole (the reference
    skips the block, attention included), a layer without attention adds
    nothing in its place, or with ``w_lin_attn`` adds that projection of
    its attn-normed input."""
    if not lp.has_ffn:
        return x
    x_in = x
    h_attn = attn_out = None
    if lp.has_attn:
        x, h_attn, attn_out = _attn_block(
            x, lp, kvio, cfg=cfg, plan=plan, params=params, li=li,
            safe_pos=safe_pos, rope_pos=rope_pos, k_pos=k_pos,
            write_start=write_start, decode_attn=decode_attn, impl=impl,
            attn_mask=attn_mask, mrope_pos=mrope_pos, ablate=ablate, par=par)
    elif "w_lin_attn" in lp.proj:
        o = lp.proj["w_lin_attn"](_norm_d(x, lp, "attn_norm", cfg), impl)
        x = x + o.to(x.dtype)[..., :cfg.d_model]
    return _ffn_block(x, x_in, h_attn, attn_out, lp, cfg=cfg, plan=plan,
                      impl=impl, par=par)


def _attn_block(x, lp: DecoderLayer, kvio, *, cfg, plan, params, li,
                safe_pos, rope_pos, k_pos, write_start, decode_attn, impl,
                attn_mask=None, mrope_pos=None, ablate=frozenset(),
                par: Par = SERIAL):
    """The attention half of a layer: (x after the attention residual, the
    attn-normed input where it was materialised, the parallel residual's
    attention branch or None)."""
    window = params.windows[li]
    if lp.mla:
        h_attn, att = _mla_attention(
            x, lp, kvio, cfg=cfg, plan=plan, params=params,
            safe_pos=safe_pos, rope_pos=rope_pos, k_pos=k_pos,
            write_start=write_start, impl=impl, window=window,
            attn_mask=attn_mask)
    else:
        h_attn, att = _softmax_attention(
            x, lp, kvio, cfg=cfg, plan=plan, params=params, li=li,
            safe_pos=safe_pos, rope_pos=rope_pos, k_pos=k_pos,
            write_start=write_start, decode_attn=decode_attn, impl=impl,
            attn_mask=attn_mask, mrope_pos=mrope_pos, ablate=ablate, par=par)
    return _attn_out(x, att, h_attn, lp, cfg=cfg, plan=plan, impl=impl,
                     par=par)


def _rope(z, cfg: ModelConfig, params, li: int, plan: DimPlan, rope_pos,
          mrope_pos=None):
    """Layer li's rope of q or k (B, T, H, hd_p): the rotated prefix
    (:func:`rope_prefix`), or with ``mrope_pos`` (B, 3, T) on an M-RoPE
    config each frequency by its own position row (after the interleave
    permutation where the config has one)."""
    cos, sin = params.rope_for(li)
    rot = plan.hd_p if params.rot == plan.hd else params.rot
    sections = (cfg.rope_scaling or {}).get("mrope_section")
    if mrope_pos is None or not sections:
        return rope_prefix(z, rope_pos, cos, sin, rot, cfg.rope_interleaved,
                           params.rope_on[li])
    z = rope_prefix(z, rope_pos, cos, sin, rot, cfg.rope_interleaved, False)
    if not params.rope_on[li]:
        return z
    # the global tables, as the JAX package's M-RoPE takes them
    return apply_mrope(z, mrope_pos, params.rope_cos, params.rope_sin,
                       params.mrope_rows)


def _il(z: torch.Tensor) -> torch.Tensor:
    """deepseek's interleaved rope pairing as an even|odd permutation of
    the rope dims (applied to q_pe and k_pe alike, it cancels in the score
    dot)."""
    return torch.cat([z[..., 0::2], z[..., 1::2]], dim=-1)


def _mla_attention(x, lp: DecoderLayer, kvio, *, cfg, plan, params, safe_pos,
                   rope_pos, k_pos, write_start, impl, window=0,
                   attn_mask=None):
    """deepseek's MLA with the absorbed factors, the JAX package's
    ``mla_attention``: (the attn-normed input, the float32 attention output
    (B, T, H, hd_p)).

    q from ``wq_full``, or from ``wq_a``, its RMS norm and ``wq_b``;
    ``wkv_a`` gives the latent (RMS-normed by ``kv_a_norm``, in x's dtype)
    and k_pe; q_pe and k_pe take :func:`_il` then rope with the MLA tables.
    The cache row is k = [latent | k_pe | 0] and v = [latent | 0], padded
    to a multiple of 128; q_eff = [q_nope . w_uk (float32) | q_pe] in x's
    dtype with the same zero tail, so the scores over the latent row are
    q_nope . k_nope + q_pe . k_pe; the context over ``v[..., :r_kv]``
    times ``w_uv`` (float32) is the head output.  A q8 cache is attended
    dequantized, as the JAX package's update returns it."""
    dn, dr, r_kv, hh = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank,
                        cfg.n_heads)
    b, t = x.shape[:2]
    proj = lp.proj
    h = _norm_d(x, lp, "attn_norm", cfg)
    if "wq_a" in proj:
        qa = nrm.rms(proj["wq_a"](h, impl), lp.q_a_norm, cfg.rms_eps,
                     cfg.q_lora_rank)
        q = proj["wq_b"](qa, impl)
    else:
        q = proj["wq_full"](h, impl)
    q = q.reshape(b, t, hh, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kvr = proj["wkv_a"](h, impl)
    lat = nrm.rms(kvr[..., :r_kv], lp.kv_a_norm, cfg.rms_eps, r_kv)
    k_pe = kvr[..., r_kv:r_kv + dr].reshape(b, t, 1, dr)
    cos, sin = params.rope_cos, params.rope_sin
    q_pe = apply_rope(_il(q_pe), rope_pos, cos, sin)
    k_pe = apply_rope(_il(k_pe), rope_pos, cos, sin)
    q_abs = torch.einsum("bthd,hdr->bthr", q_nope.to(torch.float32),
                         lp.w_uk.to(torch.float32))
    w_pad = (-(r_kv + dr)) % 128
    pad = torch.nn.functional.pad
    q_eff = pad(torch.cat([q_abs, q_pe.to(torch.float32)], dim=-1).to(
        x.dtype), (0, w_pad))
    lat4 = lat.reshape(b, t, 1, r_kv)
    k_row = pad(torch.cat([lat4, k_pe.to(lat4.dtype)], dim=-1), (0, w_pad))
    v_row = pad(lat4, (0, dr + w_pad))
    if kvio is not None:
        k_all, v_all, k_sc, v_sc = kvio.update(k_row, v_row, write_start)
        if k_sc is not None:
            k_all, v_all = dequantize_kv(k_all, k_sc), dequantize_kv(v_all,
                                                                     v_sc)
    else:
        k_all, v_all = k_row, v_row
    ctx = _attention(q_eff, k_all, v_all[..., :r_kv], safe_pos, k_pos,
                     dn + dr, scale=cfg.attn_scale, mask_override=attn_mask,
                     window=window)
    att = torch.einsum("bthr,hrv->bthv", ctx, lp.w_uv.to(torch.float32))
    if plan.hd != plan.hd_p:
        # a v head that is not lane-aligned (minicpm3): its halves go to
        # head_positions, wo's padded-row layout (slices: no host index
        # inside a captured step)
        half, half_p = plan.hd // 2, plan.hd_p // 2
        att_p = att.new_zeros((b, t, hh, plan.hd_p))
        att_p[..., :half] = att[..., :half]
        att_p[..., half_p:half_p + half] = att[..., half:]
        att = att_p
    return h, att


def _softmax_attention(x, lp: DecoderLayer, kvio, *, cfg, plan, params, li,
                       safe_pos, rope_pos, k_pos, write_start, decode_attn,
                       impl, attn_mask=None, mrope_pos=None,
                       ablate=frozenset(), par: Par = SERIAL):
    """The q/k/v projections and the attention of a softmax-attention
    layer: (the attn-normed input where it was materialised, the float32
    attention output (B, T, H, hd_p)).  ``ablate`` as the JAX package's
    ``VLUT_ABLATE``: ``no_attn`` puts q in the attention output's place
    (on the fused path it skips #7/#8 and the row write it holds),
    ``no_kv_write`` reads the cache without writing the new rows (the
    composed path; the fused one ignores it, as JAX's does)."""
    b, t = x.shape[:2]
    hd_p, eps, d = plan.hd_p, cfg.rms_eps, cfg.d_model
    proj = lp.proj
    std_norm = cfg.norm_type == "rms"
    window, r_on = params.windows[li], params.rope_on[li]
    h_attn = None
    if lp.fused and proj["wqkv"].fusable and std_norm and cfg.pre_norms:
        # attn_norm + activation quant + qkv GEMM in one projection
        qkv = proj["wqkv"](x, impl, mode="norm",
                           norm_g=nrm.gain(lp.attn_norm, cfg.norm_plus_one),
                           norm_n=d, eps=eps)
    else:
        h_attn = _norm_d(x, lp, "attn_norm", cfg) if cfg.pre_norms else x
        # the column shards' input: its gradient summed over tp
        h_col = copy_to(h_attn, par.reduce)
        qkv = proj["wqkv"](h_col, impl) if lp.fused else None
    if qkv is not None:
        qd, kvd = plan.q_dim_p, plan.kv_dim_p
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q, k, v = (proj[n](h_col, impl) for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias and hasattr(lp, "bq"):
        q, k, v = _add(q, lp.bq), _add(k, lp.bk), _add(v, lp.bv)
    q = q.reshape(b, t, -1, hd_p)
    k = k.reshape(b, t, -1, hd_p)
    v = v.reshape(b, t, -1, hd_p)
    if cfg.qk_norm and not cfg.qk_norm_post_rope:
        q, k = _qk_norm(q, k, lp, cfg, plan, params)
    if cfg.qkv_clamp:
        c = cfg.qkv_clamp
        q, k, v = (torch.clamp(z, -c, c) for z in (q, k, v))
    if cfg.pos_embed == "rope":
        q = _rope(q, cfg, params, li, plan, rope_pos, mrope_pos)
        k = _rope(k, cfg, params, li, plan, rope_pos, mrope_pos)
    if cfg.qk_norm and cfg.qk_norm_post_rope:
        if cfg.qk_norm_type == "l2":
            # weightless, on rope layers only
            if r_on:
                q, k = (nrm.l2_norm(z, eps, plan.hd) for z in (q, k))
        else:
            q, k = _qk_norm(q, k, lp, cfg, plan, params)
    if cfg.attn_temp_scale and not r_on:
        # temperature tuning of NoPE layers' queries
        tf = torch.log(torch.floor(true_div(
            safe_pos.to(torch.float32) + cfg.attn_temp_offset,
            float(cfg.attn_temp_floor))) + 1.0) * cfg.attn_temp_scale + 1.0
        q = q * tf[..., None, None].to(q.dtype)
    fused = _fused_attn_ok(cfg, (q.shape[2], k.shape[2]),
                           (q.shape[-1], v.shape[-1]), t, kvio, decode_attn,
                           attn_mask)
    if fused and "no_attn" in ablate:
        att = q.to(torch.float32)
    elif fused:
        att = kvio.fused_attend(
            q, k, v, write_start, window,
            cfg.attn_scale or 1.0 / math.sqrt(plan.hd))
    else:
        k_sc = v_sc = None
        if kvio is not None:
            k, v, k_sc, v_sc = (kvio.peek() if "no_kv_write" in ablate
                                else kvio.update(k, v, write_start))
        if "no_attn" in ablate:
            return h_attn, q.to(torch.float32)
        kw = dict(softcap=cfg.attn_logit_softcap, window=window,
                  alibi=getattr(params, "alibi", None),
                  sinks=lp.sinks if cfg.attn_sinks else None,
                  chunked_window=cfg.swa_type == "chunked",
                  causal=cfg.causal_attn)
        if kvio is None and par.sp is not None and attn_mask is None:
            # context parallel: the KV blocks (with their global
            # positions, k_pos: this rank's slice) go round the ring
            return h_attn, _ring_attention(q, k, v, safe_pos, k_pos, plan.hd,
                                           par.sp, scale=cfg.attn_scale, **kw)
        if kvio is None and par.sp is not None:
            # a (B, T, S-global) mask override needs the whole context
            k, v = all_gather(k, par.sp, 1), all_gather(v, par.sp, 1)
            k_pos = all_gather(k_pos, par.sp, 1)
        att = _attention(q, k, v, safe_pos, k_pos, plan.hd,
                         scale=cfg.attn_scale, k_scale=k_sc, v_scale=v_sc,
                         mask_override=attn_mask, **kw)
    return h_attn, att


def _attn_out(x, att, h_attn, lp: DecoderLayer, *, cfg, plan, impl,
              par: Par = SERIAL):
    """The attention output's gate, wo and residual: (x, h_attn, the
    parallel residual's attention branch or None).  Under tp the output
    holds this shard's tp_pack / tp chunks of wo's input and wo's products
    are summed over the axis; on a tp axis (of any size) wo never fuses,
    as the JAX gates have it."""
    b, t = x.shape[:2]
    eps, d = cfg.rms_eps, cfg.d_model
    proj = lp.proj
    if cfg.attn_gate and "w_attn_gate" in proj:
        # sigmoid gate of the attention output, from the attn-normed input
        if h_attn is None:
            h_attn = _norm_d(x, lp, "attn_norm", cfg)
        gate = proj["w_attn_gate"](copy_to(h_attn, par.reduce), impl)
        att = att.reshape(b, t, -1).to(torch.float32) * torch.sigmoid(
            gate.to(torch.float32))
    # chunk-pad into wo's packed-K layout (a no-op when chunk == chunk_p)
    chunks = plan.tp_pack // par.tp_size
    att = att.reshape(b, t, chunks, plan.wo_chunk)
    if plan.wo_chunk_p != plan.wo_chunk:
        att = torch.nn.functional.pad(att, (0, plan.wo_chunk_p - plan.wo_chunk))
    att = att.reshape(b, t, chunks * plan.wo_chunk_p)
    red = par.reduce
    attn_out = None
    if (proj["wo"].fusable and par.tp is None and not cfg.post_norms
            and not cfg.parallel_residual and not cfg.proj_bias):
        # [attn_sub_norm] + quant + wo GEMM + residual (both trees)
        x = proj["wo"](
            att, impl, mode="norm" if cfg.use_subnorms else "plain",
            norm_g=getattr(lp, "attn_sub_norm", None),
            norm_n=cfg.n_heads * plan.hd, eps=eps, residual=x,
            out_dtype=x.dtype)
    else:
        if cfg.use_subnorms:
            att = nrm.rms(att, lp.attn_sub_norm, eps, cfg.n_heads * plan.hd,
                          group=red)
        o = proj["wo"](att, impl, reduce=red)
        if cfg.proj_bias:
            o = _add(o, lp.vec("bo"))
        if cfg.post_norms:
            o = nrm.rms(o, lp.post_attn_norm, eps, d, cfg.norm_plus_one)
        if cfg.parallel_residual:
            # the FFN branches off the same layer input; both branch
            # outputs join the residual at the end
            attn_out = o
        else:
            x = x + o.to(x.dtype)
    return x, h_attn, attn_out


def _ffn_block(x, x_in, h_attn, attn_out, lp: DecoderLayer, *, cfg, plan,
               impl, par: Par = SERIAL):
    """The FFN half of a layer: dense (fused where the gates let), a MoE
    block (:func:`_moe_block`) where the layer has a router, or a MoE
    model's dense lead FFN; then the residual adds and the control
    vector.  Under tp the FFN keeps this shard's columns and w_down's
    products are summed over the axis; on a tp axis (of any size) nothing
    fuses, as the JAX gates have it."""
    eps, d = cfg.rms_eps, cfg.d_model
    proj = lp.proj
    std_norm = cfg.norm_type == "rms"
    red = par.reduce
    ffl = plan.ff_p // par.tp_size
    if (not cfg.n_experts and par.tp is None and "w_gateup" in proj
            and proj["w_gateup"].fusable and proj["w_down"].fusable
            and cfg.act_fn == "silu" and not cfg.post_norms and std_norm
            and cfg.pre_norms and not cfg.swiglu_limit
            and not cfg.parallel_residual and not cfg.proj_bias):
        # ffn_norm + quant + gate|up GEMM; silu*up [+ sub-norm] + quant +
        # down GEMM + residual
        gu = proj["w_gateup"](x, impl, mode="norm",
                              norm_g=nrm.gain(lp.ffn_norm, cfg.norm_plus_one),
                              norm_n=d, eps=eps)
        x = proj["w_down"](
            gu[..., :ffl], impl, mode="silu_mul", x2=gu[..., ffl:],
            sub_norm=cfg.use_subnorms,
            norm_g=getattr(lp, "ffn_sub_norm", None), norm_n=cfg.d_ff,
            eps=eps, residual=x, out_dtype=x.dtype)
        return _add(x, lp.vec("cvector"))
    if cfg.parallel_residual and not hasattr(lp, "ffn_norm"):
        # single-norm parallel residual: the FFN reads the attention
        # branch's normed input
        h = h_attn if h_attn is not None else _norm_d(x, lp, "attn_norm", cfg)
    elif not cfg.pre_norms:
        # norm after the block: the FFN reads the raw residual
        h = x
    else:
        h = _norm_d(x, lp, "ffn_norm", cfg)
    if cfg.n_experts and hasattr(lp, "router"):
        x, dn = _moe_block(x, x_in, h, lp, cfg, impl, par.ep)
    elif cfg.n_experts:
        # a dense lead layer (first_k_dense / dense_layers) at d_ff_dense
        a = _glu(proj["w_gate"](h, impl), proj["w_up"](h, impl), cfg)
        dn = proj["w_down"](a.to(x.dtype), impl, reduce=red)
    elif not cfg.ffn_gated:
        up = proj["w_up"](copy_to(h, red), impl)
        if cfg.proj_bias:
            up = _add(up, lp.vec("b_up"))
        a = (_xielu(up, lp) if cfg.act_fn == "xielu"
             else _ACT[cfg.act_fn](up.to(torch.float32)))
    else:
        # the column shards' input: its gradient summed over tp
        h = copy_to(h, red)
        if "w_gateup" in proj:
            gu = proj["w_gateup"](h, impl)
            gate, up = gu[..., :ffl], gu[..., ffl:]
        else:
            gate, up = proj["w_gate"](h, impl), proj["w_up"](h, impl)
            if cfg.proj_bias:
                gate, up = _add(gate, lp.vec("b_gate")), _add(up, lp.vec("b_up"))
        a = _glu(gate, up, cfg)
    if not cfg.n_experts:
        a = a.to(x.dtype)
        if cfg.use_subnorms:
            a = nrm.rms(a, lp.ffn_sub_norm, eps, cfg.d_ff, group=red)
        dn = proj["w_down"](a, impl, reduce=red)
    if cfg.proj_bias:
        dn = _add(dn, lp.vec("b_down"))
    if cfg.post_norms:
        dn = nrm.rms(dn, lp.post_ffn_norm, eps, d, cfg.norm_plus_one)
    if cfg.parallel_residual:
        x = x + attn_out.to(x.dtype) + dn.to(x.dtype)
    else:
        x = x + dn.to(x.dtype)
    # control-vector steering, after the layer's residual adds
    return _add(x, lp.vec("cvector"))


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last dim, the lower index
    first among equal values: ``jax.lax.top_k``'s order (``torch.topk``
    promises none), by a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _scatter_weights(idx: torch.Tensor, w: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Dense (..., n) float32 combine weights: w[..., j] added at column
    idx[..., j], j in order (columns may repeat: grovemoe's chunk ids)."""
    comb = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.float32,
                       device=idx.device)
    for j in range(idx.shape[-1]):
        comb.scatter_add_(-1, idx[..., j:j + 1], w[..., j:j + 1])
    return comb


def _dense_ffn(hh, gate_t: TernaryTensor, up_t: TernaryTensor,
               down_t: TernaryTensor, lp: DecoderLayer, cfg: ModelConfig,
               impl: str, dtype, biases=(None, None, None)) -> torch.Tensor:
    """The JAX package's ``dense_ffn`` of an expert: the gate and up
    products [+ the expert's biases], act(gate) * up in float32 rounded to
    the layer's ``dtype`` [+ the sub-norm], the down product [+ its bias];
    each product #4 at M <= 64, #3 past it (``ternary_matmul``), or a float
    twin's plain product (:func:`matmul_any`)."""
    gate = matmul_any(hh, gate_t, impl)
    up = matmul_any(hh, up_t, impl)
    bg, bu, bd = biases
    if bg is not None:
        gate, up = gate + bg.to(gate.dtype), up + bu.to(up.dtype)
    a = _glu(gate, up, cfg).to(dtype)
    if cfg.use_subnorms:
        a = nrm.rms(a, lp.ffn_sub_norm, cfg.rms_eps, cfg.d_ff)
    out = matmul_any(a, down_t, impl)
    return out if bd is None else out + bd.to(out.dtype)


def _expert_scan(h, lp: DecoderLayer, prefix: str, comb: torch.Tensor,
                 cfg: ModelConfig, impl: str, dtype,
                 biases=None, first: int = 0) -> torch.Tensor:
    """float32 sum over the experts ``prefix``gate/up/down of the layer, in
    index order, every expert over every row (static shapes: the JAX
    package's expert scan): ``acc + w_e * out_e`` (a product then a sum,
    two roundings), or with ``moe_weight_before`` (llama4) the expert's
    weight scaling its input instead.  The stacks may hold a shard of the
    experts: the one at index e is expert ``first + e``."""
    stacks = [lp.experts[prefix + n] for n in ("gate", "up", "down")]
    acc = torch.zeros(h.shape[:-1] + (cfg.d_model,), dtype=torch.float32,
                      device=h.device)
    for e in range(len(stacks[0])):
        w_e = comb[..., first + e, None]
        ts = [st.tensor(e) for st in stacks]
        bias = ((biases[0][e], biases[1][e], biases[2][e]) if biases
                else (None, None, None))
        if cfg.moe_weight_before:
            h_e = (h.to(torch.float32) * w_e).to(h.dtype)
            acc = acc + _dense_ffn(h_e, *ts, lp, cfg, impl, dtype,
                                   bias).to(torch.float32)
        else:
            out = _dense_ffn(h, *ts, lp, cfg, impl, dtype, bias)
            acc = acc + w_e * out.to(torch.float32)
    return acc


def _moe_block(x, x_in, h, lp: DecoderLayer, cfg: ModelConfig, impl: str,
               ep=None):
    """The JAX package's MoE block (``build_moe_ffn``): returns (x, the
    block's output in x's dtype).

    The router logits in float32 (a plain product: it sits outside any
    kernel) from the FFN's normed input, or the raw layer input
    (``moe_router_input="layer_input"``, smallthinker), plus ``router_b``
    (gpt-oss); softmax or sigmoid scores; ``router_bias`` biases the
    selection only (deepseek V3); grouped routing keeps ``topk_groups``
    groups ranked by the sum of each group's top two, the others set to 0
    (not -inf); the top k by :func:`_top_k`, their scores normed by
    ``sum + 1e-20`` and times ``routed_scale``; the dense (B, T, E) combine
    weights; the expert scan (:func:`_expert_scan`).  grovemoe's chunk
    experts take a second pass over the routed output, arctic's routed
    branch reads ``moe_norm`` of the layer input while its residual MLP
    adds to x first, and the shared expert (times the sigmoid of
    ``shared_gate`` where the layer has one) joins the routed output.
    ``ep`` (expert parallel, a Group): the layer holds this rank's
    E / ep experts, and their weighted outputs are summed over the axis
    before anything joins them."""
    h_res = h
    if cfg.moe_parallel == "arctic":
        h = _norm_d(x_in, lp, "moe_norm", cfg)
    r_in = x_in if cfg.moe_router_input == "layer_input" else h
    logits = torch.matmul(r_in.to(torch.float32),
                          lp.router.to(torch.float32))
    if lp.vec("router_b") is not None:
        logits = logits + lp.router_b.to(torch.float32)
    scores = (torch.sigmoid(logits) if cfg.moe_score == "sigmoid"
              else torch.softmax(logits, dim=-1))
    sel = scores
    if lp.vec("router_bias") is not None:
        sel = sel + lp.router_bias.to(torch.float32)
    if cfg.n_expert_groups:
        g = cfg.n_expert_groups
        rank = torch.topk(sel.reshape(sel.shape[:-1] + (g, -1)), 2,
                          dim=-1).values.sum(-1)
        keep = torch.zeros_like(rank).scatter_(
            -1, _top_k(rank, cfg.topk_groups), 1.0) > 0
        sel = torch.where(keep.repeat_interleave(sel.shape[-1] // g, dim=-1),
                          sel, torch.zeros_like(sel))
    idx = _top_k(sel, cfg.n_experts_used)
    w = torch.gather(scores, -1, idx)
    if cfg.moe_norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    if cfg.routed_scale != 1.0:
        w = w * cfg.routed_scale
    comb = _scatter_weights(idx, w, cfg.n_experts)
    eb = ((lp.eb_gate, lp.eb_up, lp.eb_down)
          if cfg.moe_expert_bias and lp.vec("eb_gate") is not None else None)
    first = 0
    if ep is not None and ep.size > 1:
        first = ep.index * (cfg.n_experts // ep.size)
    dn = psum(_expert_scan(h, lp, "w_", comb, cfg, impl, x.dtype, eb, first),
              ep)
    if cfg.moe_chunk_experts and "w_ch_gate" in lp.experts:
        ch = cfg.moe_chunk_experts
        idx_ch = torch.div(_top_k(logits, min(cfg.n_experts_used, ch)),
                           cfg.n_experts // ch, rounding_mode="floor")
        w_ch = torch.gather(scores, -1, idx_ch)
        w_ch = w_ch / (w_ch.sum(-1, keepdim=True) + 1e-20)
        dn = dn + cfg.moe_chunk_scale * _expert_scan(
            dn.to(x.dtype), lp, "w_ch_", _scatter_weights(idx_ch, w_ch, ch),
            cfg, impl, x.dtype)
    proj = lp.proj
    if "w_shared_gate" in proj:
        sh = _dense_ffn(h, *(proj[f"w_shared_{n}"].tensor()
                             for n in ("gate", "up", "down")),
                        lp, cfg, impl, x.dtype).to(torch.float32)
        if lp.vec("shared_gate") is not None:
            sh = sh * torch.sigmoid(torch.matmul(
                h.to(torch.float32),
                lp.shared_gate.to(torch.float32)))[..., None]
        dn = dn + sh
    if cfg.moe_parallel == "arctic":
        res = _dense_ffn(h_res, *(proj[f"w_res_{n}"].tensor()
                                  for n in ("gate", "up", "down")),
                         lp, cfg, impl, x.dtype)
        x = x + res.to(x.dtype)
    return x, dn.to(x.dtype)


def run_layers(params: TransformerLM, x, positions, kv: dict | None, *,
               cfg: ModelConfig, slots: torch.Tensor | None = None,
               decode_attn: str = "fused", impl: str = "auto",
               attn_mask: torch.Tensor | None = None,
               mrope_pos: torch.Tensor | None = None,
               visual_expert: bool = False,
               deepstack_embeds: tuple | None = None,
               ablate: frozenset[str] = frozenset(),
               par: Par = SERIAL, first_layer: int = 0):
    """Run the layer stack (either tree) over x (B, T, D).  With ``slots``
    the B rows are those slots of the cache ``kv``.  ``visual_expert``
    runs cogvlm's visual twins; ``deepstack_embeds[i]`` (B, T, D) is added
    to layer i's output (qwen3vl's DeepStack).  ``par``: the mesh axes
    (:class:`Par`); ``params.layers`` may be a pipeline stage's slice,
    whose first layer is model layer ``first_layer``."""
    layers = params.layers
    b = positions.shape[0]
    safe_pos = torch.clamp(positions, min=0)
    # the rope gather clamps past the table as JAX's gather does (only pad
    # tokens of a prefill bucket reach there)
    rope_pos = torch.clamp(safe_pos, max=params.rope_cos.shape[0] - 1)
    if kv is not None:
        s = max_len_of(kv)
        k_pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
        # a row past the cache (an idle slot's draft step) lands on the
        # scratch row S-1, as the JAX package's clamped update puts it
        write_start = torch.clamp(safe_pos[:, 0], max=s - 1)
    else:
        k_pos, write_start = positions, None
    for j in range(len(layers)):
        i = first_layer + j
        lp = layers[j].visual() if visual_expert else layers[j]
        x = _layer_step(
            x, lp, _SlotKV(kv, j, slots) if kv is not None else None,
            cfg=cfg, plan=params.plans[i], params=params, li=i,
            safe_pos=safe_pos, rope_pos=rope_pos, k_pos=k_pos,
            write_start=write_start, decode_attn=decode_attn, impl=impl,
            attn_mask=attn_mask, mrope_pos=mrope_pos, ablate=ablate, par=par,
        )
        if deepstack_embeds is not None and i < len(deepstack_embeds):
            x = x + deepstack_embeds[i].to(x.dtype)
    return x, kv


def _int_head(x2d: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 (M, D) @ int8 (D, V) -> int32, a library call: torch._int_mm on
    the GPU (it needs more than 16 rows and K, N multiples of 8, so rows are
    padded), an int32 matmul on the CPU."""
    if not x2d.is_cuda:
        return x2d.to(torch.int32) @ q.to(torch.int32)
    m = x2d.shape[0]
    mp = max(32, -(-m // 8) * 8)
    xp = torch.nn.functional.pad(x2d, (0, 0, 0, mp - m))
    return torch._int_mm(xp, q)[:m]


def project_head(params: TransformerLM, x: torch.Tensor) -> torch.Tensor:
    """float32 logits (B, T, Vp) of hidden states x (B, T, D): the int8
    head (per-row int8 codes, an int32 product, ``(acc * xs) * scale``),
    or the bf16 ``lm_head`` / ``embed.T`` in float32."""
    b, t, d = x.shape
    if hasattr(params, "lm_head_q"):
        xq, xs = quantize_activations(x.reshape(b * t, d))
        acc = _int_head(xq, params.lm_head_q)
        return (acc.to(torch.float32) * xs
                * params.lm_head_scale[None, :]).reshape(b, t, -1)
    head = params.lm_head if hasattr(params, "lm_head") else params.embed.T
    return x.to(torch.float32) @ head.to(torch.float32)


@full_float32()
def forward(
    params: TransformerLM,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, T) int
    positions: torch.Tensor,  # (B, T) int; -1 marks padding tokens
    kv_cache: dict | None = None,
    *,
    impl: str = "auto",
    logits_last_only: bool = False,
    logits_at: torch.Tensor | None = None,  # (B,) per-row index into T
    slots: torch.Tensor | None = None,  # (B,) cache slot of each row
    decode_attn: str = "fused",
    attn_mask: torch.Tensor | None = None,  # (B, T, S) bool override
    output: str = "logits",
    mrope_pos: torch.Tensor | None = None,  # (B, 3, T) M-RoPE rows
    token_embeds: torch.Tensor | None = None,  # (B, T, D) for the lookup
    visual_expert: bool = False,  # cogvlm: the vis_* projections
    deepstack_embeds: tuple | None = None,  # qwen3vl: adds after layer i
    ablate: frozenset[str] = frozenset(),  # bench/ablate.py's switches
    tp=None,  # parallel/_comm.py Groups of the mesh axes (see below)
    ep=None,
    sp=None,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (float32 logits (B, T', V_padded), kv_cache updated in place),
    or with ``output="hidden"`` the final-norm hidden states (B, T, D) in
    the embedding's dtype and no head (the embeddings and rerank path), or
    with ``output="local_logits"`` under tp this rank's vocabulary columns
    of a vocab-sharded head, not gathered (the sharded train step's
    logits, as the JAX forward returns them under ``tp_axis``).

    With a cache, the T new tokens of row b occupy cache rows
    positions[b, 0] ... positions[b, 0] + T - 1 of slot b, or of slot
    ``slots[b]`` when given.  ``decode_attn`` picks the attention of a
    one-token step over the whole cache: ``"fused"`` runs the KV row write
    and the attention as one kernel (#7/#8), ``"composed"`` writes the row
    (#5) and attends in PyTorch.  ``impl`` picks the projections' path:
    ``"auto"`` (the kernels on the card, their plain versions on the CPU)
    or ``"dequant"`` (float32 products with the dequantized weights, the
    accuracy reference).  ``logits_at`` projects one row per sequence,
    ``logits_last_only`` the last.  ``attn_mask`` (B, T, S) bool replaces
    the causal mask over the cache rows (the T rows are written first); it
    takes the composed attention.  ``mrope_pos`` (B, 3, T) int gives an
    M-RoPE config's temporal, height and width position rows (clamped
    into the tables); without it an M-RoPE config ropes as plain rope, as
    text serving does.  ``token_embeds`` (B, T, D) take the embedding
    lookup's place (an image's rows spliced among the text's; ``tokens``
    then only gives the shapes), and the embedding scale, norm and learned
    positions apply to them as to looked-up rows.  ``visual_expert`` runs
    cogvlm's visual-expert projections in place of the language ones;
    ``deepstack_embeds`` (a tuple of (B, T, D)) adds its i-th plane to the
    output of layer i (qwen3vl's DeepStack).  ``ablate`` (a subset of
    :data:`ABLATIONS`; ``bench/ablate.py`` alone passes one) removes work
    to time its share: ``unfused`` takes the tiled route and the composed
    projections at every M, ``no_kv_write`` and ``no_attn`` act on the
    attention (:func:`_softmax_attention`), ``no_head`` returns logits of
    the head's shape that only sum x (a data dependency kept, as JAX's).

    Under a mesh every rank calls ``forward`` on its shard
    (``parallel/spmd.py``) with the Groups of its axes: ``tp`` (``params``
    cut for that tp degree: local heads and FFN columns, the cache's local
    KV heads, wo and w_down summed exactly, bitnet's sub-norm statistics
    summed, a vocab-sharded head's logits gathered, so every rank returns
    the whole vocabulary), ``ep`` (a MoE model's local experts, their
    output summed) and ``sp`` (cache-less: ``tokens`` and ``positions``
    are this rank's T slice, with global positions; ring attention).
    """
    if decode_attn not in DECODE_ATTN:
        raise ValueError(f"decode_attn must be one of {DECODE_ATTN}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}")
    if output not in ("logits", "hidden", "local_logits"):
        raise ValueError("output must be 'logits', 'hidden' or "
                         "'local_logits'")
    if not ablate <= ABLATIONS:
        raise ValueError(f"unknown ablation {sorted(ablate - ABLATIONS)}")
    if "unfused" in ablate and impl == "auto":
        impl = "tiled"
    par = Par(tp, ep, sp)
    if par.tp_size != params.tp:
        raise ValueError(f"a model cut for tp={params.tp} runs over a tp "
                         f"axis of {par.tp_size}")
    # the axis a sharded head's vocabulary columns lie over: tp, or the
    # axis a MoE model's experts ride
    head_group = par.reduce or ep
    if params.head_shards > 1 and (head_group is None
                                   or head_group.size != params.head_shards):
        raise ValueError(f"a head cut in {params.head_shards} runs over no "
                         "axis of that size")
    if (output == "local_logits" and par.tp_size > 1
            and params.head_shards != par.tp_size):
        raise ValueError("local logits under tp take a vocab-sharded "
                         "lm_head; a tied head (embed.T) is whole on every "
                         "rank")
    if par.tp_size > 1 and cfg.pos_embed == "alibi":
        raise ValueError("alibi attention is not tp-sharded yet")
    if cfg.kv_lora_rank and (par.tp_size > 1 or sp is not None):
        raise ValueError("MLA attention does not support tp/sp sharding yet "
                         "(absorbed per-head einsums; dp/ep/pp compose fine)")
    b = tokens.shape[0]
    x = (params.embed[tokens] if token_embeds is None
         else token_embeds.to(params.embed.dtype))
    if cfg.embed_scale:
        x = (x.to(torch.float32) * cfg.embed_scale).to(x.dtype)
    if cfg.embed_norm:
        x = nrm.layer_norm(x, params.embed_norm,
                           getattr(params, "embed_norm_b", None), cfg.rms_eps,
                           cfg.d_model)
    if cfg.pos_embed == "learned":
        table = params.pos_embed
        pe = table[torch.clamp(positions, 0, table.shape[0] - 1)]
        x = x + pe.to(x.dtype)
    if mrope_pos is not None:
        mrope_pos = torch.clamp(mrope_pos, 0, params.rope_cos.shape[0] - 1)
    x, kv_cache = run_layers(params, x, positions, kv_cache, cfg=cfg,
                             slots=slots, decode_attn=decode_attn, impl=impl,
                             attn_mask=attn_mask, mrope_pos=mrope_pos,
                             visual_expert=visual_expert,
                             deepstack_embeds=deepstack_embeds, ablate=ablate,
                             par=par)
    if cfg.norm_type == "ln":
        x = nrm.layer_norm(x, params.final_norm,
                           getattr(params, "final_norm_b", None), cfg.rms_eps,
                           cfg.d_model, cfg.norm_plus_one)
    else:
        x = nrm.rms(x, params.final_norm, cfg.rms_eps, cfg.d_model,
                 cfg.norm_plus_one)
    if output == "hidden":
        return x, kv_cache
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at][:, None]
    elif logits_last_only:
        x = x[:, -1:]
    if "no_head" in ablate:
        logits = torch.zeros((*x.shape[:2], params.n_logits),
                             dtype=torch.float32, device=x.device)
        return logits + x.sum(dim=-1, keepdim=True).to(torch.float32), kv_cache
    return head_logits(params, cfg, x,
                       head_group if params.head_shards > 1 else None,
                       gather=output == "logits"), kv_cache


def head_logits(params: TransformerLM, cfg: ModelConfig,
                x: torch.Tensor, tp=None, gather: bool = True) -> torch.Tensor:
    """The head on final-norm hidden states, then its bias, the logit scale
    and the final softcap.  ``tp``: the head is this rank's vocabulary
    columns of a tp-way split, and the logits are gathered over the axis
    (a tied head, ``embed.T``, is whole on every rank), or with ``gather``
    False kept local (x's gradient then summed over the axis)."""
    sharded = tp is not None and (hasattr(params, "lm_head")
                                  or hasattr(params, "lm_head_q"))
    if sharded and not gather:
        if hasattr(params, "lm_head_b"):
            raise ValueError("local logits of a head with a bias are not "
                             "supported (the bias is whole)")
        x = copy_to(x, tp)
    logits = project_head(params, x)
    if sharded and gather:
        logits = all_gather(logits, tp, -1)
    if hasattr(params, "lm_head_b"):
        logits = logits + params.lm_head_b.to(logits.dtype)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        logits = _softcap(logits, cfg.final_logit_softcap)
    return logits
