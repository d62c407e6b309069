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

PyTorch runs eagerly, so there is no scan-versus-unroll trade-off: a
serving process keeps one tree.  MoE, MLA, M-RoPE, per-layer head counts
and FFN widths, non-causal attention and tensor/sequence parallelism raise
``NotImplementedError`` (:func:`check_supported`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import resolve_device
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
from vlut_tpu_torch.ops.rope import rope_prefix, rope_table
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
}
PROJECTIONS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_gateup",
               "w_down", "w_attn_gate")
NORMS = ("attn_norm", "ffn_norm", "attn_sub_norm", "ffn_sub_norm")
# the knobs' per-layer vectors, kept in their stored dtype: LayerNorm
# biases, post-norm and q/k-norm gains (+ biases), projection biases,
# attention sinks and xIELU's alphas
KNOB_VECTORS = (
    "attn_norm_b", "ffn_norm_b", "post_attn_norm", "post_ffn_norm",
    "q_norm", "k_norm", "q_norm_b", "k_norm_b", "bq", "bk", "bv", "bo",
    "b_gate", "b_up", "b_down", "sinks", "xielu_ap", "xielu_an",
)
# per-layer vectors a layer tree may carry: the norm gains (float32), the
# knobs' vectors and the control vector
LAYER_VECTORS = NORMS + KNOB_VECTORS + ("cvector",)
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
                "ported to vlut_tpu_torch yet"
            )
    for name, allowed in _CHOICES.items():
        if getattr(cfg, name) not in allowed:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported")
    kind = (cfg.rope_scaling or {}).get(
        "rope_type", (cfg.rope_scaling or {}).get("type"))
    if kind == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")


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
    else the last two are None."""
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
    else the global ones (stored keys already carry the mscale)."""
    cos, sin, cos_l, sin_l = rope_tables(cfg, make_plan(cfg),
                                         with_mscale=False, device=device)
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


def weight_specs(cfg: ModelConfig,
                 plan: DimPlan | None = None) -> dict[str, TernarySpec]:
    """Packed weight specs (single device; fused names included)."""
    plan = plan or make_plan(cfg)
    fmt, kb, d = cfg.weight_fmt, plan.kb, cfg.d_model
    qd, kvd = plan.q_dim_p, plan.kv_dim_p
    specs = {
        "wq": TernarySpec(d, qd, fmt, kb),
        "wk": TernarySpec(d, kvd, fmt, kb),
        "wv": TernarySpec(d, kvd, fmt, kb),
        "wqkv": TernarySpec(d, qd + 2 * kvd, fmt, kb),
        "wo": TernarySpec(plan.wo_in_p, d, fmt, kb),
        "w_gate": TernarySpec(d, plan.ff_p, fmt, kb),
        "w_up": TernarySpec(d, plan.ff_p, fmt, kb),
        "w_gateup": TernarySpec(d, 2 * plan.ff_p, fmt, kb),
        "w_down": TernarySpec(plan.ff_p, d, fmt, kb),
    }
    if cfg.attn_gate:
        # the attention output gate packs exactly like wq
        specs["w_attn_gate"] = TernarySpec(d, qd, fmt, kb)
    return specs


def pack_weight(name: str, trits: np.ndarray, scale, cfg: ModelConfig,
                plan: DimPlan | None = None) -> TernaryTensor:
    """Pack one logical (K, N) projection with the plan's head padding and
    chunk padding (the JAX package's checkpoint layout)."""
    plan = plan or make_plan(cfg)
    hd, hd_p = plan.hd, plan.hd_p
    if name in ("wq", "wk", "wv", "w_attn_gate"):
        heads = cfg.n_kv_heads if name in ("wk", "wv") else cfg.n_heads
        trits = pad_heads_cols(trits, heads, hd, hd_p)
    elif name == "wo":
        trits = pad_heads_rows(trits, cfg.n_heads, hd, hd_p)
        trits = scatter_rows(trits, plan.wo_chunk, plan.wo_chunk_p,
                             plan.wo_in_p)
    elif name in ("w_gate", "w_up"):
        trits = scatter_cols(trits, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
    elif name == "w_down":
        trits = scatter_rows(trits, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
    else:
        raise KeyError(name)
    return pack_ternary(trits, scale, cfg.weight_fmt, plan.kb)


def unpack_weight(name: str, t: TernaryTensor, cfg: ModelConfig,
                  plan: DimPlan | None = None) -> np.ndarray:
    """Inverse of :func:`pack_weight`: packed tensor -> logical (K, N) int8
    trits in HF orientation (the head and chunk padding dropped)."""
    plan = plan or make_plan(cfg)
    hd, hd_p = plan.hd, plan.hd_p
    w = unpack_ternary(t).cpu().numpy()

    def gather_head_cols(w2, heads):
        if hd == hd_p:
            return w2
        k = w2.shape[0]
        return w2.reshape(k, heads, hd_p)[
            :, :, head_positions(hd, hd_p)].reshape(k, heads * hd)

    if name in ("wq", "wk", "wv", "w_attn_gate"):
        return gather_head_cols(
            w, cfg.n_kv_heads if name in ("wk", "wv") else cfg.n_heads)
    if name == "wo":
        w = w[chunk_positions(cfg.n_heads * hd_p, plan.wo_chunk,
                              plan.wo_chunk_p)]
        if hd != hd_p:
            w = w.reshape(cfg.n_heads, hd_p, -1)[
                :, head_positions(hd, hd_p)].reshape(cfg.n_heads * hd, -1)
        return w
    if name in ("w_gate", "w_up"):
        return w[:, chunk_positions(cfg.d_ff, plan.ff_chunk, plan.ff_chunk_p)]
    if name == "w_down":
        return w[chunk_positions(cfg.d_ff, plan.ff_chunk, plan.ff_chunk_p)]
    raise KeyError(name)


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

    def forward(self, x: torch.Tensor, impl: str = "auto",
                **fused) -> torch.Tensor:
        """ternary_matmul, or ternary_matmul_fused when keywords are given."""
        if fused:
            if self.has_lora:
                raise ValueError("a projection with a LoRA runs unfused")
            return ternary_matmul_fused(x, self.tensor(), impl=impl, **fused)
        out = ternary_matmul(x, self.tensor(), impl=impl)
        if self.has_lora:
            out = out + self.lora_delta(x).to(out.dtype)
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


class DecoderLayer(nn.Module):
    """One layer's projections (``proj``) and vectors (buffers: the norm
    gains in float32, the knobs' vectors as stored)."""

    def __init__(self, tree: dict[str, Any], specs: dict[str, TernarySpec]):
        super().__init__()
        unknown = set(tree) - set(PROJECTIONS) - set(LAYER_VECTORS)
        if unknown:
            raise NotImplementedError(f"layer tensors not ported: {unknown}")
        self.proj = nn.ModuleDict({
            name: TernaryLinear(
                tree[name]["packed"], tree[name]["scale"], specs[name],
                {k: tree[name][k] for k in LORA_LEAVES if k in tree[name]})
            for name in PROJECTIONS if name in tree
        })
        for name in LAYER_VECTORS:
            if name in tree:
                v = tree[name]
                self.register_buffer(
                    name, v.to(torch.float32) if name in NORMS else v)

    @property
    def fused(self) -> bool:
        return "wqkv" in self.proj

    def vec(self, name: str) -> torch.Tensor | None:
        return getattr(self, name, None)


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
    use ``embed.T``.  A checkpoint converted from a sequence classifier
    also carries ``rank_head`` {w (D, 1), b (1,)}, which the server's
    rerank scores with.  The per-layer windows and rope flags and the rope
    tables (global, and local for models whose sliding layers rope with
    their own base) follow from the config.
    """

    def __init__(self, cfg: ModelConfig, tree: dict[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.plan = make_plan(cfg)
        specs = weight_specs(cfg, self.plan)
        layers = tree["layers"]
        if isinstance(layers, dict):
            self.layers = StackedLayers(layers, specs, cfg.n_layers)
        else:
            self.layers = nn.ModuleList(DecoderLayer(lp, specs)
                                        for lp in layers)
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
        name: {"packed": m.packed, "scale": m.scale, **m.lora_tree()}
        for name, m in lp.proj.items()
    }
    for name in LAYER_VECTORS:
        if hasattr(lp, name):
            out[name] = getattr(lp, name)
    return out


# --- parameter construction ----------------------------------------------------

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


def _projection_names(cfg: ModelConfig) -> tuple[str, ...]:
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    if not cfg.ffn_gated:
        names = tuple(n for n in names if n != "w_gate")
    return names


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cpu") -> TransformerLM:
    """Random ternary model from numpy draws in the JAX package's
    ``init_params`` order (synthetic models for tests)."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    plan = make_plan(cfg)
    logical = {
        "wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
        "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model),
        "w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
        "w_down": (cfg.d_ff, cfg.d_model),
    }
    layers: dict[str, Any] = {}
    for name in _projection_names(cfg):
        k, n = logical[name]
        packed, scales = [], []
        for _ in range(cfg.n_layers):
            trits = rng.integers(-1, 2, size=(k, n), dtype=np.int8)
            t = pack_weight(name, trits, np.float32(0.05), cfg, plan)
            packed.append(t.packed)
            scales.append(t.scale)
        layers[name] = {"packed": torch.stack(packed),
                        "scale": torch.stack(scales)}
    layers.update(_knob_vectors(
        cfg, plan,
        lambda w: torch.ones((cfg.n_layers, w), dtype=torch.float32),
        lambda w: torch.from_numpy(
            rng.standard_normal((cfg.n_layers, w)) * 0.02).to(torch.float32)))
    tree: dict[str, Any] = {
        "embed": torch.from_numpy(
            rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.02
        ).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32),
        "layers": layers,
    }
    if cfg.norm_type == "ln":
        tree["final_norm_b"] = torch.from_numpy(
            rng.standard_normal((cfg.d_model,)) * 0.02).to(torch.float32)
    if not cfg.tie_embeddings:
        head = rng.standard_normal((cfg.d_model, plan.vocab_p)) * 0.02
        head[:, cfg.vocab_size:] = 0.0
        tree["lm_head"] = torch.from_numpy(head).to(dtype)
    return TransformerLM(cfg, _tree_to(tree, device))


def init_params_fast(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                     device: str | torch.device | None = None) -> TransformerLM:
    """Random packed model generated directly on ``device`` with a seeded
    ``torch.Generator`` (benchmark weights at full size in seconds).

    Bytes come from :func:`random_packed_bytes` (valid trits only);
    padding positions get random trits too.  The float vectors are those
    :func:`init_params` lays out (gains of one, biases of normals * 0.02),
    so every config that runs from ``init_params`` runs from these too.
    """
    check_supported(cfg)
    device = resolve_device(device)
    plan = make_plan(cfg)
    specs = weight_specs(cfg, plan)
    r = TRITS_PER_BYTE[cfg.weight_fmt]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def packed(spec: TernarySpec) -> torch.Tensor:
        shape = (cfg.n_layers, padded_k(spec.k, spec.fmt, spec.kb) // r,
                 -(-spec.n // 128) * 128)
        return random_packed_bytes(shape, cfg.weight_fmt, gen, device)

    def randn(*shape) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)

    layers: dict[str, Any] = {}
    for name in _projection_names(cfg):
        layers[name] = {
            "packed": packed(specs[name]),
            "scale": torch.full((cfg.n_layers,), 0.05, device=device),
        }
    layers.update(_knob_vectors(
        cfg, plan, lambda w: torch.ones((cfg.n_layers, w), device=device),
        lambda w: randn(cfg.n_layers, w) * 0.02))
    tree: dict[str, Any] = {
        "embed": (randn(cfg.vocab_size, cfg.d_model) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), device=device),
        "layers": layers,
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
    return TransformerLM(model.cfg, tree)


def fuse_projections(model: TransformerLM, cfg: ModelConfig) -> TransformerLM:
    """Concatenate wq|wk|wv -> wqkv and w_gate|w_up -> w_gateup along N (the
    byte layout is row-major over K slabs, so packed columns concatenate
    exactly); per-tensor scales become one per-channel vector.  Stacked
    trees only.  As in the JAX package: a no-op when already fused or
    unrolled, for a model with q/k/v biases, or when a LoRA sits on
    wq/wk/wv/w_gate/w_up; gate|up fuse only for a gated FFN without
    projection biases."""
    if not isinstance(model.layers, StackedLayers):
        return model
    tree = model.tree()
    layers = dict(tree["layers"])
    if "wqkv" in layers or cfg.qkv_bias or any(
            "lora_a" in layers.get(n, {}) for n in _UNFUSED_BY_LORA):
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

    if all(n in layers for n in ("wq", "wk", "wv")):
        fuse(["wq", "wk", "wv"], [plan.q_dim_p, plan.kv_dim_p, plan.kv_dim_p],
             "wqkv")
    if cfg.ffn_gated and not cfg.proj_bias:
        fuse(["w_gate", "w_up"], [plan.ff_p, plan.ff_p], "w_gateup")
    tree["layers"] = layers
    return TransformerLM(cfg, tree)


def unstack_layers(model: TransformerLM, cfg: ModelConfig) -> TransformerLM:
    """Stacked tree -> one :class:`DecoderLayer` per layer (views of the
    stacked tensors; no copy)."""
    if not isinstance(model.layers, StackedLayers):
        return model
    tree = model.tree()
    tree["layers"] = [model.layers.tree(i) for i in range(cfg.n_layers)]
    return TransformerLM(cfg, tree)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int | None = None,
                  dtype=torch.bfloat16, device="cpu",
                  quantized: bool = False) -> dict:
    plan = make_plan(cfg)
    return new_cache(cfg.n_layers, batch, max_len or cfg.max_seq_len,
                     cfg.n_kv_heads, plan.hd_p, dtype=dtype, device=device,
                     quantized=quantized)


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


def _mask(kp, qp, window: int, chunked: bool, override=None):
    """The mask of key positions kp against query positions qp: causal, or
    ``override`` (B, T, S) where given (the caller owns causality), and the
    sliding window when window > 0: rolling (kp > qp - window) or chunked
    (kp and qp in the same window-wide chunk).  (The JAX package drops the
    window under an override, so its lookahead rounds on a sliding-window
    model attend past the window.)"""
    if override is not None:
        mask = override[:, None, None, :, :]
    else:
        mask = (kp <= qp) & (kp >= 0)
    if window > 0:
        if chunked:
            mask = mask & (torch.div(kp, window, rounding_mode="floor")
                           == torch.div(qp, window, rounding_mode="floor"))
        else:
            mask = mask & (kp > qp - window)
    return mask


def _attention(q, k, v, q_pos, k_pos, hd_logical, scale=0.0, k_scale=None,
               v_scale=None, mask_override=None, softcap=0.0, window=0,
               alibi=None, sinks=None, chunked_window=False):
    """Causal GQA attention.  q (B, T, H, hd), k/v (B, S, Hkv, hd); returns
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
              chunked_window=chunked_window)
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
    mask = _mask(kp, qp, window, chunked_window, mask_override)
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
                       chunk=ATTN_CHUNK, mask_override=None, softcap=0.0,
                       window=0, alibi=None, sinks=None, chunked_window=False):
    """Online-softmax attention over KV chunks (same semantics as the dense
    path; O(T * chunk) live scores instead of O(T * S)).  Sinks enter as the
    recurrence's initial state (m0 = sink logit, l0 = 1, acc = 0)."""
    b, t, h, hd = q.shape
    hkv, s = k.shape[2], k.shape[1]
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
    acc = torch.zeros((b, hkv, g, t, v.shape[-1]), device=q.device)
    slopes = (alibi.to(torch.float32).reshape(1, hkv, g, 1, 1)
              if alibi is not None else None)
    for off in range(0, s, chunk):
        kc = k[:, off:off + chunk].to(torch.float32)
        vc = v[:, off:off + chunk].to(torch.float32)
        kp = k_pos[:, off:off + chunk][:, None, None, None, :]
        sc = torch.einsum("bthgd,bshd->bhgts", qf, kc)
        if softcap:
            sc = _softcap(sc, softcap)
        if slopes is not None:
            sc = sc + slopes * (kp - qp).to(torch.float32)
        masked = ~_mask(kp, qp, window, chunked_window,
                        None if mask_override is None
                        else mask_override[:, :, off:off + chunk])
        sc.masked_fill_(masked, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = sc.sub_(m_new[..., None]).exp_().masked_fill_(masked, 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgts,bshd->bhgtd", p, vc)
        m = m_new
        del sc, p
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b, hkv, g, t, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, v.shape[-1])


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


def _fused_attn_ok(cfg: ModelConfig, plan: DimPlan, t: int,
                   kvio: _SlotKV | None, decode_attn: str,
                   attn_mask: torch.Tensor | None = None) -> bool:
    """The decode-attention gate: one token per slot over the whole cache
    under the causal mask (no ``attn_mask`` override), a model whose
    attention the kernels compute (no ALiBi, sinks, softcap, chunked
    windows or bidirectional attention), and the kernels' head shapes."""
    return (
        decode_attn == "fused" and attn_mask is None
        and kvio is not None and kvio.slots is None and t == 1
        and getattr(cfg, "pos_embed", "rope") != "alibi"
        and not getattr(cfg, "attn_sinks", False)
        and not cfg.attn_logit_softcap
        and getattr(cfg, "swa_type", "window") != "chunked"
        and getattr(cfg, "causal_attn", True)
        and dattn.supports(cfg.n_heads, cfg.n_kv_heads, plan.hd_p)
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
                attn_mask=None):
    """One layer, the JAX package's ``layer_step`` for the dense knobs, in
    its order and with its fused gates: qkv fuses (#1 at M <= 64, norm +
    quant + GEMM) under an RMS pre-norm; wo fuses with its residual without
    post-norms, a parallel residual or projection biases; the FFN fuses
    for a silu-gated one under the same terms plus an RMS pre-norm and no
    swiglu clamp.  Any projection a gate leaves unfused runs #4 / #3."""
    b, t = x.shape[:2]
    hd_p, eps, d = plan.hd_p, cfg.rms_eps, cfg.d_model
    proj = lp.proj
    std_norm = cfg.norm_type == "rms"
    window, r_on = params.windows[li], params.rope_on[li]
    h_attn = None
    if lp.fused and std_norm and cfg.pre_norms:
        # attn_norm + activation quant + qkv GEMM in one projection
        qkv = proj["wqkv"](x, impl, mode="norm",
                           norm_g=nrm.gain(lp.attn_norm, cfg.norm_plus_one),
                           norm_n=d, eps=eps)
    else:
        h_attn = _norm_d(x, lp, "attn_norm", cfg) if cfg.pre_norms else x
        qkv = proj["wqkv"](h_attn, impl) if lp.fused else None
    if qkv is not None:
        qd, kvd = plan.q_dim_p, plan.kv_dim_p
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q, k, v = (proj[n](h_attn, impl) for n in ("wq", "wk", "wv"))
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
        cos, sin = params.rope_for(li)
        rot = hd_p if params.rot == plan.hd else params.rot
        q = rope_prefix(q, rope_pos, cos, sin, rot, cfg.rope_interleaved, r_on)
        k = rope_prefix(k, rope_pos, cos, sin, rot, cfg.rope_interleaved, r_on)
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
    if _fused_attn_ok(cfg, plan, t, kvio, decode_attn, attn_mask):
        att = kvio.fused_attend(
            q, k, v, write_start, window,
            cfg.attn_scale or 1.0 / math.sqrt(plan.hd))
    else:
        k_sc = v_sc = None
        if kvio is not None:
            k, v, k_sc, v_sc = kvio.update(k, v, write_start)
        att = _attention(q, k, v, safe_pos, k_pos, plan.hd,
                         scale=cfg.attn_scale, k_scale=k_sc, v_scale=v_sc,
                         mask_override=attn_mask,
                         softcap=cfg.attn_logit_softcap, window=window,
                         alibi=getattr(params, "alibi", None),
                         sinks=lp.sinks if cfg.attn_sinks else None,
                         chunked_window=cfg.swa_type == "chunked")
    if cfg.attn_gate and "w_attn_gate" in proj:
        # sigmoid gate of the attention output, from the attn-normed input
        if h_attn is None:
            h_attn = _norm_d(x, lp, "attn_norm", cfg)
        gate = proj["w_attn_gate"](h_attn, impl)
        att = att.reshape(b, t, -1).to(torch.float32) * torch.sigmoid(
            gate.to(torch.float32))
    # chunk-pad into wo's packed-K layout (a no-op when chunk == chunk_p)
    att = att.reshape(b, t, plan.tp_pack, plan.wo_chunk)
    if plan.wo_chunk_p != plan.wo_chunk:
        att = torch.nn.functional.pad(att, (0, plan.wo_chunk_p - plan.wo_chunk))
    att = att.reshape(b, t, plan.wo_in_p)
    par = cfg.parallel_residual
    attn_out = None
    if (not proj["wo"].has_lora and not cfg.post_norms and not par
            and not cfg.proj_bias):
        # [attn_sub_norm] + quant + wo GEMM + residual (both trees)
        x = proj["wo"](
            att, impl, mode="norm" if cfg.use_subnorms else "plain",
            norm_g=getattr(lp, "attn_sub_norm", None),
            norm_n=cfg.n_heads * plan.hd, eps=eps, residual=x,
            out_dtype=x.dtype)
    else:
        if cfg.use_subnorms:
            att = nrm.rms(att, lp.attn_sub_norm, eps, cfg.n_heads * plan.hd)
        o = proj["wo"](att, impl)
        if cfg.proj_bias:
            o = _add(o, lp.vec("bo"))
        if cfg.post_norms:
            o = nrm.rms(o, lp.post_attn_norm, eps, d, cfg.norm_plus_one)
        if par:
            # the FFN branches off the same layer input; both branch
            # outputs join the residual at the end
            attn_out = o
        else:
            x = x + o.to(x.dtype)
    ffl = plan.ff_p
    if ("w_gateup" in proj and not proj["w_down"].has_lora
            and cfg.act_fn == "silu" and not cfg.post_norms and std_norm
            and cfg.pre_norms and not cfg.swiglu_limit and not par
            and not cfg.proj_bias):
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
    if par and not hasattr(lp, "ffn_norm"):
        # single-norm parallel residual: the FFN reads the attention
        # branch's normed input
        h = h_attn if h_attn is not None else _norm_d(x, lp, "attn_norm", cfg)
    elif not cfg.pre_norms:
        # norm after the block: the FFN reads the raw residual
        h = x
    else:
        h = _norm_d(x, lp, "ffn_norm", cfg)
    if not cfg.ffn_gated:
        up = proj["w_up"](h, impl)
        if cfg.proj_bias:
            up = _add(up, lp.vec("b_up"))
        a = (_xielu(up, lp) if cfg.act_fn == "xielu"
             else _ACT[cfg.act_fn](up.to(torch.float32)))
    else:
        if "w_gateup" in proj:
            gu = proj["w_gateup"](h, impl)
            gate, up = gu[..., :ffl], gu[..., ffl:]
        else:
            gate, up = proj["w_gate"](h, impl), proj["w_up"](h, impl)
            if cfg.proj_bias:
                gate, up = _add(gate, lp.vec("b_gate")), _add(up, lp.vec("b_up"))
        a = _glu(gate, up, cfg)
    a = a.to(x.dtype)
    if cfg.use_subnorms:
        a = nrm.rms(a, lp.ffn_sub_norm, eps, cfg.d_ff)
    dn = proj["w_down"](a, impl)
    if cfg.proj_bias:
        dn = _add(dn, lp.vec("b_down"))
    if cfg.post_norms:
        dn = nrm.rms(dn, lp.post_ffn_norm, eps, d, cfg.norm_plus_one)
    if par:
        x = x + attn_out.to(x.dtype) + dn.to(x.dtype)
    else:
        x = x + dn.to(x.dtype)
    # control-vector steering, after the layer's residual adds
    return _add(x, lp.vec("cvector"))


def run_layers(params: TransformerLM, x, positions, kv: dict | None, *,
               cfg: ModelConfig, slots: torch.Tensor | None = None,
               decode_attn: str = "fused", impl: str = "auto",
               attn_mask: torch.Tensor | None = None):
    """Run the layer stack (either tree) over x (B, T, D).  With ``slots``
    the B rows are those slots of the cache ``kv``."""
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
    for i in range(len(layers)):
        x = _layer_step(
            x, layers[i], _SlotKV(kv, i, slots) if kv is not None else None,
            cfg=cfg, plan=params.plan, params=params, li=i,
            safe_pos=safe_pos, rope_pos=rope_pos, k_pos=k_pos,
            write_start=write_start, decode_attn=decode_attn, impl=impl,
            attn_mask=attn_mask,
        )
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
) -> tuple[torch.Tensor, dict | None]:
    """Returns (float32 logits (B, T', V_padded), kv_cache updated in place),
    or with ``output="hidden"`` the final-norm hidden states (B, T, D) in
    the embedding's dtype and no head (the embeddings and rerank path).

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
    takes the composed attention.
    """
    if decode_attn not in DECODE_ATTN:
        raise ValueError(f"decode_attn must be one of {DECODE_ATTN}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}")
    if output not in ("logits", "hidden"):
        raise ValueError("output must be 'logits' or 'hidden'")
    b = tokens.shape[0]
    x = params.embed[tokens]
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
    x, kv_cache = run_layers(params, x, positions, kv_cache, cfg=cfg,
                             slots=slots, decode_attn=decode_attn, impl=impl,
                             attn_mask=attn_mask)
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
    return head_logits(params, cfg, x), kv_cache


def head_logits(params: TransformerLM, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """The head on final-norm hidden states, then its bias, the logit scale
    and the final softcap."""
    logits = project_head(params, x)
    if hasattr(params, "lm_head_b"):
        logits = logits + params.lm_head_b.to(logits.dtype)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        logits = _softcap(logits, cfg.final_logit_softcap)
    return logits
