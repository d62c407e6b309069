"""Bidirectional text encoders (embedding models), port of
``vlut_tpu/models/encoder.py``.

A float, fixed-shape forward over (tokens, mask) that returns token hidden
states, and :func:`embed`, which pools them (mean or cls) and L2-normalises.
No KV cache and no ternary weight: encoder checkpoints are small and never
ternary in the wild, so no kernel of the port runs here.  Families:

* ``bert`` — post-LN, learned absolute and token-type embeddings, biased
  projections, exact-gelu MLP.
* ``modernbert`` — pre-LN without bias, fused qkv, rope with a theta per
  layer kind, local (±window/2, bidirectional) and global layers
  (``global_every``), GeGLU MLP.
* ``neobert`` — RMS pre-norms, fused [q;k;v], rope, swiglu w12 / w3.
* ``bert-variant`` archs: ``nomic-bert`` (fused wqkv, full-head rope,
  parallel swiglu), ``nomic-bert-moe`` (softmax MoE without renorm on
  layers ``i % moe_every == 1``), ``jina-bert-v2`` (ALiBi with max bias 8,
  q/k LayerNorms, fused GEGLU), ``jina-bert-v3`` (rope and per-task LoRA
  adapters, chosen by ``task``).

The stored dtypes are kept and each operation promotes as the JAX package's
does (a bf16 embedding sum rounds in bf16; products of a float32 input and a
bf16 weight are float32).  The layers are one :class:`EncoderLayer` each, a
tuple as the JAX package keeps a bert-variant's (its MoE layers differ from
its dense ones); the stacked checkpoints of the other archs are sliced into
per-layer views.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.transformer import alibi_slopes

VARIANTS = ("nomic-bert", "nomic-bert-moe", "jina-bert-v2", "jina-bert-v3")
ARCHS = ("bert", "modernbert", "neobert") + VARIANTS


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    arch: str                    # one of ARCHS
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    max_seq_len: int = 512
    ln_eps: float = 1e-12
    pooling: str = "mean"        # "mean" | "cls" | "none"
    type_vocab_size: int = 2     # bert segment embeddings
    # modernbert
    local_window: int = 128      # total bidirectional window (±window/2)
    global_every: int = 3        # layer_id % global_every == 0 -> global
    rope_theta_global: float = 160000.0
    rope_theta_local: float = 10000.0
    normalize: bool = True       # L2-normalize pooled embeddings
    # bert-variant family
    rope: bool = False           # nomic / jina-v3: full-head NEOX rope
    alibi: bool = False          # jina-v2: max bias 8
    ffn_kind: str = "gelu_seq"   # "swiglu_par" (nomic) | "geglu" (jina-v2)
    moe_every: int = 0           # nomic-moe: MoE on i % moe_every == 1
    n_experts: int = 0
    moe_top_k: int = 2
    lora_alpha: float = 1.0      # jina-v3 task adapters
    lora_tasks: tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class EncoderLayer(nn.Module):
    """One layer's tensors (buffers, as stored); ``t`` maps their names."""

    def __init__(self, lp: dict[str, torch.Tensor]):
        super().__init__()
        self.names = tuple(lp)
        for k, v in lp.items():
            self.register_buffer(k, v)

    @property
    def t(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.names}


class EncoderLM(nn.Module):
    """An encoder checkpoint's model: the top-level tensors and adapters
    (``params``, registered as buffers) and one :class:`EncoderLayer` per
    layer."""

    def __init__(self, cfg: EncoderConfig, tree: dict[str, Any]):
        super().__init__()
        if cfg.arch not in ARCHS:
            raise ValueError(f"unknown encoder arch {cfg.arch!r}")
        self.cfg = cfg
        layers = tree["layers"]
        # stacked (L, ...) tensors (bert, modernbert, neobert), sliced into
        # views; tree() stacks them again
        self.stacked = isinstance(layers, dict)
        if self.stacked:
            layers = [{k: v[i] for k, v in layers.items()}
                      for i in range(cfg.n_layers)]
        self.layers = nn.ModuleList(EncoderLayer(lp) for lp in layers)
        self.params = {k: v for k, v in tree.items() if k != "layers"}

        def register(node, prefix):
            for k, v in node.items():
                if torch.is_tensor(v):
                    self.register_buffer(
                        (prefix + k).replace(".", "_").replace("/", "_"), v)
                else:
                    register(v, f"{prefix}{k}_")
        register(self.params, "top_")

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def tree(self) -> dict[str, Any]:
        layers = [lp.t for lp in self.layers]
        if self.stacked:
            layers = {k: torch.stack([lp[k] for lp in layers])
                      for k in layers[0]}
        return {**self.params, "layers": layers}


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype (JAX's ``@`` across dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _rms(x, w, eps):
    x = x.to(torch.float32)
    v = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(v + eps) * w


def _ln(x, w, b, eps):
    x = x.to(torch.float32)
    xc = x - x.mean(-1, keepdim=True)
    v = (xc * xc).mean(-1, keepdim=True)
    out = xc * torch.rsqrt(v + eps) * w
    return out if b is None else out + b


def _gelu(x):
    return torch.nn.functional.gelu(x.to(torch.float32))


def _attend(q, k, v, mask_bias):
    """(B, T, H, hd) bidirectional attention with an additive bias
    (B or 1, H or 1, T or 1, T)."""
    hd = q.shape[-1]
    sc = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                      k.to(torch.float32)) * (hd ** -0.5)
    p = torch.softmax(sc + mask_bias, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32))


def _rope(x, pos, theta):
    """NEOX split-half rope over the full head dim."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos[..., None].to(torch.float32) * inv  # (B, T, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _alibi_bias(n_heads: int, t: int, device) -> torch.Tensor:
    """Bidirectional ALiBi: bias[h, i, j] = -slope_h * |i - j|."""
    sl = torch.from_numpy(alibi_slopes(n_heads)).to(device)
    ar = torch.arange(t, device=device)
    rel = (ar[:, None] - ar[None, :]).abs()
    return -sl[:, None, None] * rel[None].to(torch.float32)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: values and indices, ties to the lower index."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _bert(model: EncoderLM, cfg, tokens, pad_bias):
    p = model.params
    b, t = tokens.shape
    x = p["embed"][tokens]
    x = x + p["pos_embed"][torch.arange(t, device=tokens.device)][None]
    if "type_embed" in p:
        x = x + p["type_embed"][0][None, None]
    x = _ln(x, p["embed_norm"], p.get("embed_norm_b"), cfg.ln_eps)
    h, hd = cfg.n_heads, cfg.head_dim
    for layer in model.layers:
        lp = layer.t
        q = (_mm(x, lp["wq"]) + lp["bq"]).reshape(b, t, h, hd)
        k = (_mm(x, lp["wk"]) + lp["bk"]).reshape(b, t, h, hd)
        v = (_mm(x, lp["wv"]) + lp["bv"]).reshape(b, t, h, hd)
        att = _attend(q, k, v, pad_bias).reshape(b, t, -1)
        o = _mm(att, lp["wo"]) + lp["bo"]
        x = _ln(x + o, lp["attn_norm"], lp["attn_norm_b"], cfg.ln_eps)
        up = _mm(x, lp["w_up"]) + lp["b_up"]
        dn = _mm(_gelu(up), lp["w_down"]) + lp["b_down"]
        x = _ln(x + dn, lp["ffn_norm"], lp["ffn_norm_b"], cfg.ln_eps)
    return x


def _variant(model: EncoderLM, cfg, tokens, pad_bias, task):
    """The reference's post-LN bert builder superset: token (+ type)
    embeddings, embed LN; per layer attention (fused qkv or not, q/k LNs,
    rope, ALiBi) -> add input -> LN [-> re-add input -> LN] -> FFN (gelu
    seq, parallel swiglu, GEGLU or the MoE) -> add -> LN."""
    p = model.params
    b, t = tokens.shape
    ad = {}
    if task is not None:
        ad = p.get("adapters", {}).get(task, {})
        if not ad:
            raise KeyError(f"unknown adapter task {task!r}; have "
                           f"{tuple(p.get('adapters', {}))}")

    def w_of(store, key, path):
        w = store[key]
        if path in ad:
            a, bm = ad[path]["a"], ad[path]["b"]
            w = w + (cfg.lora_alpha / a.shape[-1]) * torch.matmul(
                a.to(torch.float32), bm.to(torch.float32))
        return w

    x = w_of(p, "embed", "embed")[tokens]
    if "type_embed" in p:
        x = x + w_of(p, "type_embed", "type_embed")[0][None, None]
    x = _ln(x, p["embed_norm"], p.get("embed_norm_b"), cfg.ln_eps)
    h, hd = cfg.n_heads, cfg.head_dim
    pos = torch.arange(t, device=tokens.device)[None].expand(b, t)
    bias = pad_bias
    if cfg.alibi:
        bias = bias + _alibi_bias(h, t, tokens.device)[None]
    for li, layer in enumerate(model.layers):
        lp = layer.t

        def lw(key, li=li, lp=lp):
            return w_of(lp, key, f"layers/{li}/{key}")

        inp = x
        if "wqkv" in lp:
            qkv = _mm(inp, lw("wqkv"))
            if "bqkv" in lp:
                qkv = qkv + lp["bqkv"]
            q, k, v = torch.chunk(qkv, 3, dim=-1)
        else:
            q = _mm(inp, lw("wq")) + lp["bq"]
            k = _mm(inp, lw("wk")) + lp["bk"]
            v = _mm(inp, lw("wv")) + lp["bv"]
        if "q_norm" in lp:
            # jina-v2's q/k LayerNorms over the full width
            q = _ln(q, lp["q_norm"], lp.get("q_norm_b"), cfg.ln_eps)
            k = _ln(k, lp["k_norm"], lp.get("k_norm_b"), cfg.ln_eps)
        q, k, v = (z.reshape(b, t, h, hd) for z in (q, k, v))
        if cfg.rope:
            q = _rope(q, pos, cfg.rope_theta_global)
            k = _rope(k, pos, cfg.rope_theta_global)
        o = _mm(_attend(q, k, v, bias).reshape(b, t, -1), lw("wo"))
        if "bo" in lp:
            o = o + lp["bo"]
        x = _ln(inp + o, lp["attn_norm"], lp.get("attn_norm_b"), cfg.ln_eps)
        if "attn_norm2" in lp:
            # jina-v2-code's second norm re-adds the layer input
            x = _ln(x + inp, lp["attn_norm2"], lp.get("attn_norm2_b"),
                    cfg.ln_eps)
        f = x
        if "router" in lp:
            # nomic-moe: softmax router, top k, no renorm, GELU experts
            scores = torch.softmax(_mm(f, lp["router"]).to(torch.float32),
                                   dim=-1)
            top_w, top_i = _top_k(scores, cfg.moe_top_k)
            comb = torch.zeros_like(scores).scatter_add_(-1, top_i, top_w)
            dn = torch.zeros(f.shape, dtype=torch.float32, device=f.device)
            for e in range(cfg.n_experts):
                a = _gelu(_mm(f, lp["e_up"][e]))
                dn = dn + comb[..., e, None] * _mm(a, lp["e_down"][e])
        elif cfg.ffn_kind == "swiglu_par" and "w_gate" in lp:
            g = torch.nn.functional.silu(_mm(f, lw("w_gate")).to(
                torch.float32))
            dn = _mm(g * _mm(f, lw("w_up")), lw("w_down"))
        elif cfg.ffn_kind == "geglu" and "w_in" in lp:
            z = _mm(f, lw("w_in"))
            if "b_in" in lp:
                z = z + lp["b_in"]
            ff = z.shape[-1] // 2
            dn = _mm(_gelu(z[..., :ff]) * z[..., ff:], lw("w_down"))
            if "b_down" in lp:
                dn = dn + lp["b_down"]
        else:
            up = _mm(f, lw("w_up"))
            if "b_up" in lp:
                up = up + lp["b_up"]
            dn = _mm(_gelu(up), lw("w_down"))
            if "b_down" in lp:
                dn = dn + lp["b_down"]
        x = _ln(f + dn, lp["ffn_norm"], lp.get("ffn_norm_b"), cfg.ln_eps)
    return x


def _modernbert(model: EncoderLM, cfg, tokens, pad_bias):
    p = model.params
    b, t = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim
    x = _ln(p["embed"][tokens], p["embed_norm"], None, cfg.ln_eps)
    pos = torch.arange(t, device=tokens.device)[None].expand(b, t)
    ar = torch.arange(t, device=tokens.device)
    local_ok = (ar[:, None] - ar[None, :]).abs() <= cfg.local_window // 2
    local_bias = pad_bias + torch.where(
        local_ok, 0.0, -1e30).to(torch.float32)[None, None]
    for i, layer in enumerate(model.layers):
        lp = layer.t
        is_global = i % cfg.global_every == 0
        hh = x if i == 0 else _ln(x, lp["attn_norm"], None, cfg.ln_eps)
        qkv = _mm(hh, lp["wqkv"]).reshape(b, t, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        theta = cfg.rope_theta_global if is_global else cfg.rope_theta_local
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        att = _attend(q, k, v, pad_bias if is_global else local_bias)
        x = x + _mm(att.reshape(b, t, -1), lp["wo"])
        hh = _ln(x, lp["mlp_norm"], None, cfg.ln_eps)
        wi = _mm(hh, lp["w_in"])
        a = _gelu(wi[..., :cfg.d_ff]) * wi[..., cfg.d_ff:]
        x = x + _mm(a, lp["w_out"])
    return _ln(x, p["final_norm"], None, cfg.ln_eps)


def _neobert(model: EncoderLM, cfg, tokens, pad_bias):
    p = model.params
    b, t = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim
    x = p["embed"][tokens].to(torch.float32)
    pos = torch.arange(t, device=tokens.device)[None].expand(b, t)
    qd = h * hd
    for layer in model.layers:
        lp = layer.t
        hh = _rms(x, lp["attn_norm"], cfg.ln_eps)
        qkv = _mm(hh, lp["wqkv"])
        q = qkv[..., :qd].reshape(b, t, h, hd)
        k = qkv[..., qd:2 * qd].reshape(b, t, h, hd)
        v = qkv[..., 2 * qd:].reshape(b, t, h, hd)
        q = _rope(q, pos, cfg.rope_theta_global)
        k = _rope(k, pos, cfg.rope_theta_global)
        x = x + _mm(_attend(q, k, v, pad_bias).reshape(b, t, -1), lp["wo"])
        hh = _rms(x, lp["ffn_norm"], cfg.ln_eps)
        wi = _mm(hh, lp["w_in"])
        a = torch.nn.functional.silu(wi[..., :cfg.d_ff].to(torch.float32)) \
            * wi[..., cfg.d_ff:]
        x = x + _mm(a, lp["w_out"])
    return _rms(x, p["final_norm"], cfg.ln_eps)


@torch.inference_mode()
@full_float32()
def forward_encoder(model: EncoderLM, cfg: EncoderConfig,
                    tokens: torch.Tensor, mask: torch.Tensor,
                    task: str | None = None) -> torch.Tensor:
    """Token hidden states (B, T, D), float32, of tokens (B, T) under mask
    (B, T) (1 a real token, 0 padding); ``task`` picks a jina-v3 adapter."""
    pad_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).to(
        torch.float32)
    if cfg.arch == "bert":
        return _bert(model, cfg, tokens, pad_bias)
    if cfg.arch in VARIANTS:
        return _variant(model, cfg, tokens, pad_bias, task)
    if cfg.arch == "modernbert":
        return _modernbert(model, cfg, tokens, pad_bias)
    if cfg.arch == "neobert":
        return _neobert(model, cfg, tokens, pad_bias)
    raise ValueError(f"unknown encoder arch {cfg.arch!r}")


@torch.inference_mode()
@full_float32()
def embed(model: EncoderLM, cfg: EncoderConfig, tokens: torch.Tensor,
          mask: torch.Tensor, task: str | None = None) -> torch.Tensor:
    """Pooled (B, D) float32 embeddings: cls, or the mean over the real
    tokens; L2-normalised unless the config says not to."""
    x = forward_encoder(model, cfg, tokens, mask, task=task)
    if cfg.pooling == "cls":
        e = x[:, 0]
    else:
        m = mask.to(torch.float32)[..., None]
        e = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    if cfg.normalize:
        e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
    return e

