"""Hybrid SSM + attention decoder LMs (port of vlut_tpu/models/hybrid.py):
Jamba, Falcon-H1, Granite-hybrid, LFM2 (and lfm2moe), Qwen3-Next (gated
delta net), Nemotron-H (and its MoE), PLaMo-2.

One config-driven graph: each layer's mixer is attention (NoPE or rope,
partial rope, q/k norms, qwen3next's output gate), Jamba's mamba1 (dt/B/C
RMSNorms), mamba2 (:func:`vlut_tpu_torch.models.ssm.mamba2_core`),
attention and mamba2 in parallel (falcon-h1), PLaMo-2's mamba, LFM2's
gated short conv, the gated delta net, or a Nemotron-H FFN / MoE block;
then a dense, MoE, shared or shared-MoE FFN (or none).  Weights are float
matrices (these checkpoints are never ternary), so no ternary kernel runs
here.  The forward is stateless over the whole sequence, as the JAX
package's: ``generate`` recomputes the sequence for each new token.
"""

from __future__ import annotations

import dataclasses

import torch

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models import ssm
from vlut_tpu_torch.models.ssm import (
    Mamba2Dims,
    TreeLM,
    _causal_conv,
    _ssm_scan,
    mamba2_core,
    rms32 as _rms,
    silu,
    softplus,
)
from vlut_tpu_torch.models.transformer import _scatter_weights, _top_k


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    arch: str                    # "jamba" | "falcon_h1" | "granite_hybrid"
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    layer_types: tuple[str, ...]  # "attention" | "mamba" | "mamba2" |
    # "parallel" | "deltanet" | "plamo2_mamba" | "conv" | "ffn"
    ffn_types: tuple[str, ...]    # "dense" | "moe" | "shared" |
    # "shared_moe" | "moe_qwen" | "none"
    head_dim: int | None = None
    rms_eps: float = 1e-5
    rope: bool = True
    rope_theta: float = 10000.0
    attn_scale: float = 0.0       # 0 = 1/sqrt(head_dim)
    # mamba2 dims
    m2_heads: int = 0
    m2_head_dim: int = 64
    m2_groups: int = 1
    m2_state: int = 128
    m2_conv: int = 4
    m2_norm_mode: str = "gated"   # see ssm.Mamba2Dims.norm_mode
    # mamba1 dims (jamba)
    m1_d_inner: int = 0
    m1_state: int = 16
    m1_conv: int = 4
    m1_dt_rank: int = 0
    # gated delta net (qwen3next "linear_attention" layers)
    dn_v_heads: int = 0
    dn_k_heads: int = 0
    dn_k_dim: int = 128
    dn_v_dim: int = 128
    dn_conv: int = 4
    # lfm2 short conv
    conv_l: int = 3
    # nemotron-h FFN layers
    ffn_act: str = "silu"         # "relu2" for nemotron-h
    ffn_gated: bool = True
    # attention extras
    qk_norm: bool = False
    rope_pct: float = 1.0
    attn_gate: bool = False
    # MoE
    n_experts: int = 0
    n_experts_used: int = 0
    moe_renorm: bool = True
    routed_scale: float = 1.0
    moe_score: str = "softmax"    # "sigmoid": lfm2moe / nemotron-h-moe
    d_ff_shared: int = 0
    embed_scale: float = 0.0
    logit_scale: float = 1.0
    tie_embeddings: bool = False
    max_seq_len: int = 4096

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def m2_dims(self) -> Mamba2Dims:
        return Mamba2Dims(
            d_inner=self.m2_heads * self.m2_head_dim,
            n_heads=self.m2_heads, head_dim=self.m2_head_dim,
            n_groups=self.m2_groups, d_state=self.m2_state,
            d_conv=self.m2_conv, rms_eps=self.rms_eps,
            norm_mode=self.m2_norm_mode)


def _rope_tab(t, hd, theta, device):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=device) / hd))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _rope_partial(x, cos, sin, rot):
    if rot == x.shape[-1]:
        return _apply_rope(x, cos, sin)
    return torch.cat([_apply_rope(x[..., :rot], cos, sin), x[..., rot:]], -1)


def _attention(cfg: HybridConfig, lp, h, cos, sin):
    b, t, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    gate = None
    if cfg.attn_gate:
        # qwen3next: q_proj emits (q | gate) per head
        qg = (h @ lp["wq"]).reshape(b, t, H, 2 * hd)
        q, gate = qg[..., :hd], qg[..., hd:].reshape(b, t, H * hd)
    else:
        q = (h @ lp["wq"]).reshape(b, t, H, hd)
    k = (h @ lp["wk"]).reshape(b, t, KV, hd)
    v = (h @ lp["wv"]).reshape(b, t, KV, hd)
    if cfg.qk_norm:
        q = _rms(q, lp["q_norm"], cfg.rms_eps)
        k = _rms(k, lp["k_norm"], cfg.rms_eps)
    if cfg.rope:
        rot = int(hd * cfg.rope_pct) // 2 * 2
        q = _rope_partial(q, cos, sin, rot)
        k = _rope_partial(k, cos, sin, rot)
    rep = H // KV
    k = k.repeat_interleave(rep, 2)
    v = v.repeat_interleave(rep, 2)
    scale = cfg.attn_scale or hd ** -0.5
    sc = torch.einsum("bthd,bshd->bhts", q, k) * scale
    pos = torch.arange(t, device=h.device)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30)
    p = torch.softmax(sc + causal[None, None], dim=-1)
    att = torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, H * hd)
    if gate is not None:
        att = att * torch.sigmoid(gate)
    return att @ lp["wo"]


def _conv_taps(x, w, b, width):
    """Depthwise causal conv from a zero window, taps added in order."""
    zeros = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    return _causal_conv(zeros, x, w, b)[0]


def _jamba_mamba(cfg: HybridConfig, lp, h):
    """Jamba's mamba1 mixer: mamba1 with RMSNorms on dt, B and C."""
    b, t, _ = h.shape
    di, ds, dr, dc = cfg.m1_d_inner, cfg.m1_state, cfg.m1_dt_rank, cfg.m1_conv
    xz = h @ lp["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xc = silu(_conv_taps(xi, lp["conv_w"], lp.get("conv_b"), dc))
    proj = xc @ lp["x_proj"]
    dt_in = _rms(proj[..., :dr], lp["dt_norm"], cfg.rms_eps)
    B = _rms(proj[..., dr:dr + ds], lp["b_norm"], cfg.rms_eps)
    C = _rms(proj[..., dr + ds:], lp["c_norm"], cfg.rms_eps)
    dt = softplus(dt_in @ lp["dt_proj_w"] + lp["dt_proj_b"])
    A = -torch.exp(lp["A_log"].to(torch.float32))
    dA = torch.exp(dt[..., None] * A)
    dBx = dt[..., None] * B[:, :, None, :] * xc[..., None]
    hs = _ssm_scan(dA, dBx, h.new_zeros((b, di, ds), dtype=torch.float32))
    y = (hs @ C[..., None])[..., 0] + lp["D"] * xc
    return (y * silu(z)) @ lp["out_proj"]


def _mamba2(cfg: HybridConfig, lp, h):
    b = h.shape[0]
    md = cfg.m2_dims()
    conv_dim = md.d_inner + 2 * md.n_groups * md.d_state
    zxbcdt = (h @ lp["in_proj"]).to(torch.float32)
    conv0 = h.new_zeros((b, md.d_conv - 1, conv_dim), dtype=torch.float32)
    ssm0 = h.new_zeros((b, md.n_heads, md.head_dim, md.d_state),
                       dtype=torch.float32)
    y, _, _ = mamba2_core(zxbcdt, conv0, ssm0, lp, md)
    return y @ lp["out_proj"]


def _plamo2_mamba(cfg: HybridConfig, lp, h):
    """PLaMo-2's mamba mixer: per-head [z; x] in_proj, conv + silu over x,
    B / C / dt from bcdt_proj with RMS norms, one dt per head (scalar-A
    SSD), y = SSD(x) + D x gated by silu(z).  A_log holds -exp(A_log)."""
    b, t, _ = h.shape
    md = cfg.m2_dims()
    M2H, hd, ds, dc = md.n_heads, md.head_dim, md.d_state, md.d_conv
    di = M2H * hd
    zx = (h @ lp["in_proj"]).to(torch.float32).reshape(b, t, M2H, 2 * hd)
    z = zx[..., :hd].reshape(b, t, di)
    x = zx[..., hd:].reshape(b, t, di)
    xc = silu(_conv_taps(x, lp["conv_w"], lp.get("conv_b"), dc))
    bcdt = xc @ lp["bcdt_proj"]
    B = _rms(bcdt[..., :ds], lp["b_norm"], cfg.rms_eps)
    C = _rms(bcdt[..., ds:2 * ds], lp["c_norm"], cfg.rms_eps)
    dt_in = _rms(bcdt[..., 2 * ds:], lp["dt_norm"], cfg.rms_eps)
    dt = softplus(dt_in @ lp["dt_proj_w"] + lp["dt_proj_b"])
    A = lp["A_log"].to(torch.float32)
    dA = torch.exp(dt * A)                                 # (b, t, M2H)
    dA_bd = dA.repeat_interleave(hd, -1)[..., None]        # (b, t, di, 1)
    dt_bd = dt.repeat_interleave(hd, -1)                   # (b, t, di)
    dBx = (dt_bd * xc)[..., None] * B[:, :, None, :]       # (b, t, di, ds)
    hs = _ssm_scan(dA_bd.expand(dBx.shape), dBx,
                   h.new_zeros((b, di, ds), dtype=torch.float32))
    y = (hs @ C[..., None])[..., 0]
    y = y + lp["D"].to(torch.float32).repeat_interleave(hd) * xc
    return (silu(z) * y) @ lp["out_proj"]


def _lfm2_conv(cfg: HybridConfig, lp, h):
    """LFM2 gated short conv: in_proj -> (B, C, x); causal conv (no
    activation) over B*x; y = C * conv; out_proj."""
    d = h.shape[-1]
    bcx = h @ lp["in_proj"]
    Bg, Cg, xg = bcx[..., :d], bcx[..., d:2 * d], bcx[..., 2 * d:]
    conv = _conv_taps(Bg * xg, lp["conv_w"], lp.get("conv_b"), cfg.conv_l)
    return (Cg * conv) @ lp["out_proj"]


def _l2norm(x, eps=1e-6):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _deltanet(cfg: HybridConfig, lp, h):
    """Qwen3-Next's gated delta rule, step by step over T:
    S_t = S_{t-1} exp(g_t) + k_t (beta_t (v_t - k_t . S_{t-1} exp(g_t)))^T,
    out_t = q_t . S_t, then a norm-then-gate RMSNorm."""
    b, t, _ = h.shape
    Hv, Hk = cfg.dn_v_heads, cfg.dn_k_heads
    dk, dv = cfg.dn_k_dim, cfg.dn_v_dim
    kd, vd = Hk * dk, Hv * dv
    qkvz = h @ lp["in_proj_qkvz"]
    ba = h @ lp["in_proj_ba"]
    z = qkvz[..., 2 * kd + vd:].reshape(b, t, Hv, dv)
    bgate = torch.sigmoid(ba[..., :Hv].to(torch.float32))
    a = ba[..., Hv:].to(torch.float32)
    g = -torch.exp(lp["A_log"].to(torch.float32)) * softplus(
        a + lp["dt_bias"].to(torch.float32))
    qkv = silu(_conv_taps(qkvz[..., :2 * kd + vd], lp["conv_w"], None,
                          cfg.dn_conv))
    rep = Hv // Hk
    q = qkv[..., :kd].reshape(b, t, Hk, dk).repeat_interleave(rep, 2)
    k = qkv[..., kd:2 * kd].reshape(b, t, Hk, dk).repeat_interleave(rep, 2)
    v = qkv[..., 2 * kd:].reshape(b, t, Hv, dv).to(torch.float32)
    q = _l2norm(q.to(torch.float32)) * dk ** -0.5
    k = _l2norm(k.to(torch.float32))
    S = h.new_zeros((b, Hv, dk, dv), dtype=torch.float32)
    outs = []
    for i in range(t):
        q_t, k_t, v_t, g_t, b_t = (u[:, i] for u in (q, k, v, g, bgate))
        S = S * torch.exp(g_t)[..., None, None]
        kv = (k_t[..., None, :] @ S)[..., 0, :]
        delta = (v_t - kv) * b_t[..., None]
        S = S + k_t[..., :, None] * delta[..., None, :]
        outs.append((q_t[..., None, :] @ S)[..., 0, :])
    core = torch.stack(outs, 1)
    cf = core * torch.rsqrt((core * core).mean(-1, keepdim=True)
                            + cfg.rms_eps)
    core = cf * lp["norm_w"].to(torch.float32) * silu(z.to(torch.float32))
    return core.reshape(b, t, vd) @ lp["out_proj"]


def _glu(h, w_in, w_out, ff):
    """Granite's fused GLU: input_linear -> chunk 2 -> silu(a) * b -> out."""
    z = h @ w_in
    return (silu(z[..., :ff]) * z[..., ff:]) @ w_out


def _top_kw(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, in
    ``jax.lax.top_k``'s order."""
    idx = _top_k(x, k)
    return torch.gather(x, -1, idx), idx


def _expert_sum(h, comb, fn, n_experts):
    """float32 ``acc + w_e * out_e`` over the experts in order, every expert
    over every row (the JAX package's expert scan)."""
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(n_experts):
        acc = acc + comb[..., e, None] * fn(e)
    return acc


def _ffn(cfg: HybridConfig, lp, h, kind):
    if kind == "dense":
        return (silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    if kind == "moe_qwen":
        # qwen3next: softmax -> top-k -> renorm routed experts + a
        # sigmoid-gated shared expert
        scores = torch.softmax((h @ lp["router"]).to(torch.float32), -1)
        top_w, top_i = _top_kw(scores, cfg.n_experts_used)
        if cfg.moe_renorm:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        comb = _scatter_weights(top_i, top_w, scores.shape[-1])
        moe = _expert_sum(h, comb, lambda e: (
            silu(h @ lp["e_gate"][e]) * (h @ lp["e_up"][e])) @ lp["e_down"][e],
            lp["e_gate"].shape[0])
        sh = (silu(h @ lp["w_shared_gate"]) * (h @ lp["w_shared_up"])
              ) @ lp["w_shared_down"]
        g_sh = torch.sigmoid((h @ lp["shared_gate"]).to(torch.float32))
        return moe + sh * g_sh
    out = 0.0
    if kind in ("shared", "shared_moe"):
        out = _glu(h, lp["w_shared_in"], lp["w_shared_out"],
                   cfg.d_ff_shared or cfg.d_ff)
    if kind in ("moe", "shared_moe"):
        logits = (h @ lp["router"]).to(torch.float32)
        scores = (torch.sigmoid(logits) if cfg.moe_score == "sigmoid"
                  else torch.softmax(logits, -1))
        if "e_bias" in lp:
            # selection-only bias: top-k on scores + bias, the combine
            # weights from the raw scores
            top_i = _top_k(scores + lp["e_bias"].to(torch.float32),
                           cfg.n_experts_used)
            top_w = torch.gather(scores, -1, top_i)
        else:
            top_w, top_i = _top_kw(scores, cfg.n_experts_used)
        if cfg.moe_renorm:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        comb = _scatter_weights(top_i, top_w, scores.shape[-1])
        if "e_in" in lp:  # granite's fused stacks
            moe = _expert_sum(h, comb, lambda e: _glu(
                h, lp["e_in"][e], lp["e_out"][e], cfg.d_ff),
                lp["e_in"].shape[0])
        else:             # jamba's per-expert gate / up / down
            moe = _expert_sum(h, comb, lambda e: (
                silu(h @ lp["e_gate"][e]) * (h @ lp["e_up"][e])
            ) @ lp["e_down"][e], lp["e_gate"].shape[0])
        out = out + moe
    return out


def _relu2(z):
    return torch.square(torch.relu(z))


def _nemotron_moe(cfg: HybridConfig, lp, h):
    """Nemotron-H-MoE's E block: sigmoid router with a selection-only bias,
    renormalized and scaled top-k weights over ungated relu^2 experts, plus
    an ungated relu^2 shared expert."""
    scores = torch.sigmoid((h @ lp["router"]).to(torch.float32))
    sel = scores + lp["e_bias"].to(torch.float32) if "e_bias" in lp else scores
    top_i = _top_k(sel, cfg.n_experts_used)
    top_w = torch.gather(scores, -1, top_i)
    if cfg.moe_renorm:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    comb = _scatter_weights(top_i, top_w * cfg.routed_scale,
                            scores.shape[-1])
    mix = _expert_sum(h, comb, lambda e: _relu2(h @ lp["e_up"][e])
                      @ lp["e_down"][e], lp["e_up"].shape[0])
    return mix + _relu2(h @ lp["w_shared_up"]) @ lp["w_shared_down"]


def _ffn_block(cfg: HybridConfig, lp, h):
    """Nemotron-H's MLP block: gated, or act(up [+ b]) @ down [+ b]."""
    if cfg.ffn_gated:
        return (silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    act = {"relu2": _relu2, "silu": silu}[cfg.ffn_act]
    up = h @ lp["w_up"]
    if "b_up" in lp:
        up = up + lp["b_up"]
    out = act(up) @ lp["w_down"]
    return out + lp["b_down"] if "b_down" in lp else out


@full_float32()
def forward(model: TreeLM, cfg: HybridConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence logits (B, T, V), float32."""
    params = model.params
    x = params["embed"][tokens].to(torch.float32)
    if cfg.embed_scale:
        x = x * cfg.embed_scale
    t = tokens.shape[1]
    rot = int(cfg.head_dim_ * cfg.rope_pct) // 2 * 2
    cos, sin = _rope_tab(t, rot, cfg.rope_theta, x.device)
    for i, lp in enumerate(params["layers"]):
        kind = cfg.layer_types[i]
        h = _rms(x, lp["attn_norm"], cfg.rms_eps)
        if kind == "parallel":
            mix = _attention(cfg, lp, h, cos, sin) + _mamba2(cfg, lp, h)
        elif kind == "attention":
            mix = _attention(cfg, lp, h, cos, sin)
        elif kind == "mamba2":
            mix = _mamba2(cfg, lp, h)
        elif kind == "deltanet":
            mix = _deltanet(cfg, lp, h)
        elif kind == "plamo2_mamba":
            mix = _plamo2_mamba(cfg, lp, h)
        elif kind == "conv":
            mix = _lfm2_conv(cfg, lp, h)
        elif kind == "ffn" and "router" in lp:
            mix = _nemotron_moe(cfg, lp, h)
        elif kind == "ffn":
            mix = _ffn_block(cfg, lp, h)
        else:
            mix = _jamba_mamba(cfg, lp, h)
        if "post_mixer_norm" in lp:
            mix = _rms(mix, lp["post_mixer_norm"], cfg.rms_eps)
        x = x + mix
        if cfg.ffn_types[i] != "none":
            h = _rms(x, lp["ffn_norm"], cfg.rms_eps)
            fo = _ffn(cfg, lp, h, cfg.ffn_types[i])
            if "post_ffn_norm" in lp:
                fo = _rms(fo, lp["post_ffn_norm"], cfg.rms_eps)
            x = x + fo
        x = ssm.layer_output(x)
    x = _rms(x, params["final_norm"], cfg.rms_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].t().to(torch.float32)
    logits = x @ head
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits
