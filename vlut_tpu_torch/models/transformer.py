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

PyTorch runs eagerly, so there is no scan-versus-unroll trade-off: a
serving process keeps one tree.  Configurations outside llama/bitnet (MoE,
MLA, softcaps, sliding windows, ALiBi, qk-norm, tensor/sequence
parallelism, ...) raise ``NotImplementedError`` (:func:`check_supported`).
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
from vlut_tpu_torch.ops.rope import apply_rope, rope_table
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
}
PROJECTIONS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_gateup",
               "w_down")
NORMS = ("attn_norm", "ffn_norm", "attn_sub_norm", "ffn_sub_norm")
# float32 per-layer vectors a layer tree may carry: the norm gains and the
# control vector
LAYER_VECTORS = NORMS + ("cvector",)
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
    kind = (cfg.rope_scaling or {}).get(
        "rope_type", (cfg.rope_scaling or {}).get("type"))
    if kind == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")


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
    return {
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


def pack_weight(name: str, trits: np.ndarray, scale, cfg: ModelConfig,
                plan: DimPlan | None = None) -> TernaryTensor:
    """Pack one logical (K, N) projection with the plan's head padding and
    chunk padding (the JAX package's checkpoint layout)."""
    plan = plan or make_plan(cfg)
    hd, hd_p = plan.hd, plan.hd_p
    if name in ("wq", "wk", "wv"):
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

    if name in ("wq", "wk", "wv"):
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
    """One layer's projections (``proj``) and norm gains (buffers)."""

    def __init__(self, tree: dict[str, Any], specs: dict[str, TernarySpec]):
        super().__init__()
        self.proj = nn.ModuleDict({
            name: TernaryLinear(
                tree[name]["packed"], tree[name]["scale"], specs[name],
                {k: tree[name][k] for k in LORA_LEAVES if k in tree[name]})
            for name in PROJECTIONS if name in tree
        })
        for name in LAYER_VECTORS:
            if name in tree:
                self.register_buffer(name, tree[name].to(torch.float32))
        unknown = set(tree) - set(PROJECTIONS) - set(LAYER_VECTORS)
        if unknown:
            raise NotImplementedError(f"layer tensors not ported: {unknown}")

    @property
    def fused(self) -> bool:
        return "wqkv" in self.proj


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
    """Embedding -> layers -> final RMSNorm -> output head.

    ``lm_head`` is a bf16 (D, Vp) matrix, or after :func:`quantize_head`
    the int8 ``lm_head_q`` with per-column ``lm_head_scale``; tied models
    use ``embed.T``.  A checkpoint converted from a sequence classifier
    also carries ``rank_head`` {w (D, 1), b (1,)}, which the server's
    rerank scores with.
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
        plan = self.plan
        cos, sin = rope_table(cfg.max_seq_len, plan.hd, cfg.rope_theta,
                              cfg.rope_scaling, pad_to=plan.hd_p)
        self.register_buffer("rope_cos", cos.to(self.embed.device),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(self.embed.device),
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

    def tree(self) -> dict[str, Any]:
        layers = (self.layers.tree() if isinstance(self.layers, StackedLayers)
                  else [_layer_tree(lp) for lp in self.layers])
        out = {"embed": self.embed, "final_norm": self.final_norm,
               "layers": layers}
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
    for name, (k, n) in logical.items():
        packed, scales = [], []
        for _ in range(cfg.n_layers):
            trits = rng.integers(-1, 2, size=(k, n), dtype=np.int8)
            t = pack_weight(name, trits, np.float32(0.05), cfg, plan)
            packed.append(t.packed)
            scales.append(t.scale)
        layers[name] = {"packed": torch.stack(packed),
                        "scale": torch.stack(scales)}
    ones = lambda w: torch.ones((cfg.n_layers, w), dtype=torch.float32)  # noqa: E731
    layers["attn_norm"] = ones(cfg.d_model)
    layers["ffn_norm"] = ones(cfg.d_model)
    if cfg.use_subnorms:
        layers["attn_sub_norm"] = ones(plan.wo_in_p)
        layers["ffn_sub_norm"] = ones(plan.ff_p)
    tree: dict[str, Any] = {
        "embed": torch.from_numpy(
            rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.02
        ).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32),
        "layers": layers,
    }
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
    padding positions get random trits too.
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

    layers: dict[str, Any] = {}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        layers[name] = {
            "packed": packed(specs[name]),
            "scale": torch.full((cfg.n_layers,), 0.05, device=device),
        }
    ones = lambda w: torch.ones((cfg.n_layers, w), device=device)  # noqa: E731
    layers["attn_norm"] = ones(cfg.d_model)
    layers["ffn_norm"] = ones(cfg.d_model)
    if cfg.use_subnorms:
        layers["attn_sub_norm"] = ones(plan.wo_in_p)
        layers["ffn_sub_norm"] = ones(plan.ff_p)
    tree: dict[str, Any] = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=device) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), device=device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (torch.randn((cfg.d_model, plan.vocab_p),
                                       generator=gen, device=device)
                           * 0.02).to(dtype)
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
    trees only; a no-op when already fused or unrolled, or when a LoRA sits
    on wq/wk/wv/w_gate/w_up."""
    if not isinstance(model.layers, StackedLayers):
        return model
    tree = model.tree()
    layers = dict(tree["layers"])
    if "wqkv" in layers or any("lora_a" in layers.get(n, {})
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

    fuse(["wq", "wk", "wv"], [plan.q_dim_p, plan.kv_dim_p, plan.kv_dim_p],
         "wqkv")
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

def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float,
         n_logical: int) -> torch.Tensor:
    """RMSNorm whose zero-padded tail does not skew the mean."""
    xf = x.to(torch.float32)
    ss = (xf * xf).sum(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(true_div(ss, float(n_logical)) + eps)
           * weight.to(torch.float32))
    return out.to(x.dtype)


def _attention(q, k, v, q_pos, k_pos, hd_logical, scale=0.0, k_scale=None,
               v_scale=None, mask_override=None):
    """Causal GQA attention.  q (B, T, H, hd), k/v (B, S, Hkv, hd); returns
    float32 (B, T, H, hd).  ``mask_override`` (B, T, S) bool replaces the
    causal mask (the caller owns causality).

    k_scale/v_scale (B, S, Hkv): deferred int8-KV dequantization; the codes
    stay int8 and the per-row scales fold into the scores (scores·ks) and
    the probabilities (p·vs).  Short KV takes one dense softmax; past
    ``ATTN_CHUNK`` keys it streams chunks through an online softmax
    (:func:`_attention_chunked`, which takes dequantized values)."""
    if k.shape[1] > ATTN_CHUNK:
        if k_scale is not None:
            k = dequantize_kv(k, k_scale)
            v = dequantize_kv(v, v_scale)
        return _attention_chunked(q, k, v, q_pos, k_pos, hd_logical, scale,
                                  mask_override=mask_override)
    b, t, h, hd = q.shape
    hkv = k.shape[2]
    qf = q.to(torch.float32) * (scale or 1.0 / math.sqrt(hd_logical))
    qf = qf.reshape(b, t, hkv, h // hkv, hd)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.to(torch.float32))
    if k_scale is not None:
        # true scores = q · (codes * ks) == (q · codes) * ks
        scores = scores * k_scale.to(torch.float32).permute(0, 2, 1)[
            :, :, None, None, :]
    if mask_override is not None:
        mask = mask_override[:, None, None, :, :]
    else:
        kp = k_pos[:, None, None, None, :]
        qp = q_pos[:, None, None, :, None]
        mask = (kp <= qp) & (kp >= 0)
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        # out = p · (codes * vs) == (p * vs) · codes
        p = p * v_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return out.reshape(b, t, h, v.shape[-1])


def _attention_chunked(q, k, v, q_pos, k_pos, hd_logical, scale=0.0,
                       chunk=ATTN_CHUNK, mask_override=None):
    """Online-softmax attention over KV chunks (same semantics as the dense
    path; O(T * chunk) live scores instead of O(T * S))."""
    b, t, h, hd = q.shape
    hkv, s = k.shape[2], k.shape[1]
    g = h // hkv
    qf = q.to(torch.float32) * (scale or 1.0 / math.sqrt(hd_logical))
    qf = qf.reshape(b, t, hkv, g, hd)
    qp = q_pos[:, None, None, :, None]
    m = torch.full((b, hkv, g, t), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, g, t), device=q.device)
    acc = torch.zeros((b, hkv, g, t, v.shape[-1]), device=q.device)
    for off in range(0, s, chunk):
        kc = k[:, off:off + chunk].to(torch.float32)
        vc = v[:, off:off + chunk].to(torch.float32)
        kp = k_pos[:, off:off + chunk][:, None, None, None, :]
        sc = torch.einsum("bthgd,bshd->bhgts", qf, kc)
        if mask_override is not None:
            masked = ~mask_override[:, None, None, :, off:off + chunk]
        else:
            masked = ~((kp <= qp) & (kp >= 0))
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


def _layer_step(x, lp: DecoderLayer, kvio, *, cfg, plan, cos, sin,
                safe_pos, rope_pos, k_pos, write_start, decode_attn, impl,
                attn_mask=None):
    b, t = x.shape[:2]
    hd_p, eps, d = plan.hd_p, cfg.rms_eps, cfg.d_model
    proj = lp.proj
    if lp.fused:
        # attn_norm + activation quant + qkv GEMM in one projection
        qkv = proj["wqkv"](x, impl, mode="norm", norm_g=lp.attn_norm,
                           norm_n=d, eps=eps)
        qd, kvd = plan.q_dim_p, plan.kv_dim_p
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        h = _rms(x, lp.attn_norm, eps, d)
        q, k, v = proj["wq"](h, impl), proj["wk"](h, impl), proj["wv"](h, impl)
    q = apply_rope(q.reshape(b, t, -1, hd_p), rope_pos, cos, sin)
    k = apply_rope(k.reshape(b, t, -1, hd_p), rope_pos, cos, sin)
    v = v.reshape(b, t, -1, hd_p)
    if _fused_attn_ok(cfg, plan, t, kvio, decode_attn, attn_mask):
        att = kvio.fused_attend(
            q, k, v, write_start, 0,
            cfg.attn_scale or 1.0 / math.sqrt(plan.hd))
    else:
        k_sc = v_sc = None
        if kvio is not None:
            k, v, k_sc, v_sc = kvio.update(k, v, write_start)
        att = _attention(q, k, v, safe_pos, k_pos, plan.hd,
                         scale=cfg.attn_scale, k_scale=k_sc, v_scale=v_sc,
                         mask_override=attn_mask)
    # chunk-pad into wo's packed-K layout (a no-op when chunk == chunk_p)
    att = att.reshape(b, t, plan.tp_pack, plan.wo_chunk)
    if plan.wo_chunk_p != plan.wo_chunk:
        att = torch.nn.functional.pad(att, (0, plan.wo_chunk_p - plan.wo_chunk))
    att = att.reshape(b, t, plan.wo_in_p)
    if proj["wo"].has_lora:
        # unfused: the delta needs the sub-normed input
        if cfg.use_subnorms:
            att = _rms(att, lp.attn_sub_norm, eps, cfg.n_heads * plan.hd)
        x = x + proj["wo"](att, impl).to(x.dtype)
    else:
        # [attn_sub_norm] + quant + wo GEMM + residual (both trees)
        x = proj["wo"](
            att, impl, mode="norm" if cfg.use_subnorms else "plain",
            norm_g=getattr(lp, "attn_sub_norm", None),
            norm_n=cfg.n_heads * plan.hd, eps=eps, residual=x,
            out_dtype=x.dtype)
    ffl = plan.ff_p
    if "w_gateup" in proj and not proj["w_down"].has_lora:
        # ffn_norm + quant + gate|up GEMM; silu*up [+ sub-norm] + quant +
        # down GEMM + residual
        gu = proj["w_gateup"](x, impl, mode="norm", norm_g=lp.ffn_norm,
                              norm_n=d, eps=eps)
        x = proj["w_down"](
            gu[..., :ffl], impl, mode="silu_mul", x2=gu[..., ffl:],
            sub_norm=cfg.use_subnorms,
            norm_g=getattr(lp, "ffn_sub_norm", None), norm_n=cfg.d_ff,
            eps=eps, residual=x, out_dtype=x.dtype)
    else:
        h = _rms(x, lp.ffn_norm, eps, d)
        if "w_gateup" in proj:
            gu = proj["w_gateup"](h, impl)
            gate, up = gu[..., :ffl], gu[..., ffl:]
        else:
            gate, up = proj["w_gate"](h, impl), proj["w_up"](h, impl)
        a = (torch.nn.functional.silu(gate.to(torch.float32))
             * up.to(torch.float32)).to(x.dtype)
        if cfg.use_subnorms:
            a = _rms(a, lp.ffn_sub_norm, eps, cfg.d_ff)
        x = x + proj["w_down"](a, impl).to(x.dtype)
    if hasattr(lp, "cvector"):
        # control-vector steering, after the layer's residual adds
        x = x + lp.cvector.to(x.dtype)
    return x


def run_layers(layers, x, positions, kv: dict | None, *, cfg: ModelConfig,
               plan: DimPlan, cos, sin, slots: torch.Tensor | None = None,
               decode_attn: str = "fused", impl: str = "auto",
               attn_mask: torch.Tensor | None = None):
    """Run the layer stack (either tree) over x (B, T, D).  With ``slots``
    the B rows are those slots of the cache ``kv``."""
    b = positions.shape[0]
    safe_pos = torch.clamp(positions, min=0)
    # the rope gather clamps past the table as JAX's gather does (only pad
    # tokens of a prefill bucket reach there)
    rope_pos = torch.clamp(safe_pos, max=cos.shape[0] - 1)
    if kv is not None:
        s = max_len_of(kv)
        k_pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
        write_start = safe_pos[:, 0]
    else:
        k_pos, write_start = positions, None
    for i in range(len(layers)):
        x = _layer_step(
            x, layers[i], _SlotKV(kv, i, slots) if kv is not None else None,
            cfg=cfg, plan=plan, cos=cos, sin=sin, safe_pos=safe_pos,
            rope_pos=rope_pos, k_pos=k_pos, write_start=write_start,
            decode_attn=decode_attn, impl=impl, attn_mask=attn_mask,
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
    plan = params.plan
    x = params.embed[tokens]
    x, kv_cache = run_layers(params.layers, x, positions, kv_cache, cfg=cfg,
                             plan=plan, cos=params.rope_cos,
                             sin=params.rope_sin, slots=slots,
                             decode_attn=decode_attn, impl=impl,
                             attn_mask=attn_mask)
    x = _rms(x, params.final_norm, cfg.rms_eps, cfg.d_model)
    if output == "hidden":
        return x, kv_cache
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at][:, None]
    elif logits_last_only:
        x = x[:, -1:]
    logits = project_head(params, x)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits, kv_cache
