"""RWKV7 ("Goose"), arwkv7, RWKV6 and rwkv6qwen2: attention-free RNN LMs
(port of vlut_tpu/models/rwkv.py).

Per layer, with token-shift states carrying the previous token's normed
input:  x -> LN1 -> time mix -> + residual -> LN2 -> channel mix (arwkv7,
rwkv6qwen2: a SwiGLU FFN) -> + residual.  The WKV recurrences
(:func:`_wkv7_scan`, :func:`_wkv6_scan`, :func:`_gla_scan`) run step by
step over T, as the JAX package's ``lax.scan``; the state is (B, H, hs,
hs) float32 per layer.  Weights are float32 matrices (RWKV checkpoints are
never ternary), so no ternary kernel runs here.  :func:`forward` and
:func:`forward6` run their products with TF32 off whatever the caller
allows (``device.full_float32``): TF32 would move them from the CPU's by
about 1e-3.

The model is a :class:`~vlut_tpu_torch.models.ssm.TreeLM` over the JAX
checkpoint's tree (stacked (L, ...) layer tensors).
"""

from __future__ import annotations

import dataclasses

import torch

from vlut_tpu_torch.device import full_float32, resolve_device
from vlut_tpu_torch.models import ssm
from vlut_tpu_torch.models.ssm import TreeLM, rms32 as _rms, silu


@dataclasses.dataclass(frozen=True)
class Rwkv7Config:
    vocab_size: int
    d_model: int
    n_layers: int
    head_size: int = 64
    d_ff: int = 0               # channel-mix width (default 4*d)
    ln_eps: float = 1e-5
    has_gate: bool = True
    arch: str = "rwkv7"         # "rwkv7" | "arwkv7" (RMS norms, no
    # embedding pre-LN, SwiGLU FFN instead of channel mix, one token shift)
    max_seq_len: int = 1 << 20  # RWKV is not context-limited
    tie_embeddings: bool = False

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size

    @property
    def d_ff_(self) -> int:
        return self.d_ff or 4 * self.d_model


@dataclasses.dataclass(frozen=True)
class Rwkv6Config:
    vocab_size: int
    d_model: int
    n_layers: int
    head_size: int = 64
    d_ff: int = 0
    ln_eps: float = 1e-5
    arch: str = "rwkv6"          # "rwkv6" | "rwkv6qwen2"
    n_kv_heads: int = 0          # qrwkv GQA (0 = all heads)
    proj_bias: bool = False      # qrwkv r/k/v biases
    max_seq_len: int = 1 << 20
    tie_embeddings: bool = False

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size


def _ln(x, w, b, eps):
    xf = x.to(torch.float32)
    xc = xf - xf.mean(-1, keepdim=True)
    v = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(v + eps) * w + b


def _norm(cfg, x, w, b, eps):
    return _rms(x, w, eps) if cfg.arch == "arwkv7" else _ln(x, w, b, eps)


def _group_norm(out, eps=64e-5):
    """Per-head normalization over the last dim (ggml_norm over
    head_size)."""
    oc = out - out.mean(-1, keepdim=True)
    var = (oc * oc).mean(-1, keepdim=True)
    return oc * torch.rsqrt(var + eps)


def init_state(cfg: Rwkv7Config, batch: int, device="cpu"
               ) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    L, D, H, hs = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_size
    return {
        "shift_att": torch.zeros((L, batch, D), device=dev),
        "shift_ffn": torch.zeros((L, batch, D), device=dev),
        "wkv": torch.zeros((L, batch, H, hs, hs), device=dev),
    }


init_state6 = init_state


def _wkv7_scan(r, w, k, v, a_in, b_in, S0):
    """(B, T, H, hs) inputs -> (out (B, T, H, hs), final state).  S[i, j]:
    i the value dim, j the key dim (ggml_compute_forward_rwkv_wkv7_f32)."""
    S, outs = S0, []
    for t in range(r.shape[1]):
        r_t, w_t, k_t, v_t, a_t, b_t = (u[:, t] for u in
                                        (r, w, k, v, a_in, b_in))
        sa = (S @ a_t[..., None])[..., 0]
        S = (S * w_t[..., None, :] + v_t[..., :, None] * k_t[..., None, :]
             + sa[..., :, None] * b_t[..., None, :])
        outs.append((S @ r_t[..., None])[..., 0])
    return torch.stack(outs, 1), S


def _time_mix(cfg: Rwkv7Config, lp, x, x_prev, wkv0, v_first):
    b, t, D = x.shape
    H, hs = cfg.n_heads, cfg.head_size
    xf = x.to(torch.float32)
    sx = x_prev - xf

    def mix(name):
        return xf + sx * lp["lerp_" + name]

    r = mix("r") @ lp["wr"]
    w = torch.exp(-0.606531 * torch.sigmoid(
        lp["w0"] + torch.tanh(mix("w") @ lp["w1"]) @ lp["w2"]))
    k = mix("k") @ lp["wk"]
    v = mix("v") @ lp["wv"]
    new_vf = v if v_first is None else v_first
    if v_first is not None:
        v = v + (v_first - v) * torch.sigmoid(
            lp["v0"] + (mix("v") @ lp["v1"]) @ lp["v2"])
    g = (torch.sigmoid(mix("g") @ lp["g1"]) @ lp["g2"] if cfg.has_gate
         else None)
    a = torch.sigmoid(lp["a0"] + (mix("a") @ lp["a1"]) @ lp["a2"])

    kk = (k * lp["k_k"]).reshape(b, t, H, hs)
    kk = kk * torch.rsqrt((kk * kk).sum(-1, keepdim=True) + 1e-12)
    k = k * (1.0 + (a - 1.0) * lp["k_a"])

    rh, wh, kh, vh, ah = (u.reshape(b, t, H, hs) for u in (r, w, k, v, a))
    out, S = _wkv7_scan(rh, wh, kh, vh, -kk, kk * ah, wkv0)
    out = _group_norm(out).reshape(b, t, D) * lp["ln_x_w"] + lp["ln_x_b"]
    rk = (kh * rh * lp["r_k"].reshape(1, 1, H, hs)).sum(-1, keepdim=True)
    out = out + (vh * rk).reshape(b, t, D)
    if g is not None:
        out = out * g
    return out @ lp["wo"], S, new_vf


def _layer(lp_all, i):
    return {k: v[i] for k, v in lp_all.items()}


def _head(params, x):
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].t().to(torch.float32)
    return x @ head


def _shifted(prev: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The previous token's input at each step: the carried one first."""
    return torch.cat([prev[:, None], h[:, :-1]], 1)


@full_float32()
def forward(model: TreeLM, cfg: Rwkv7Config, tokens: torch.Tensor,
            state: dict[str, torch.Tensor] | None = None):
    """(logits (B, T, V) float32, new state or None)."""
    params = model.params
    b, t = tokens.shape
    carry = state is not None
    st = state if carry else init_state(cfg, b, model.device)
    x = params["embed"][tokens].to(torch.float32)
    if cfg.arch == "rwkv7":
        x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], cfg.ln_eps)
    new_sa, new_sf, new_wkv = [], [], []
    v_first = None
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _norm(cfg, x, lp["ln1_w"], lp.get("ln1_b"), cfg.ln_eps)
        new_sa.append(h[:, -1])
        mix, S, v_first = _time_mix(cfg, lp, h, _shifted(st["shift_att"][i],
                                                         h),
                                    st["wkv"][i], v_first)
        new_wkv.append(S)
        x = x + mix
        h = _norm(cfg, x, lp["ln2_w"], lp.get("ln2_b"), cfg.ln_eps)
        new_sf.append(h[:, -1])
        if cfg.arch == "arwkv7":
            # qwen-style SwiGLU FFN, no second token shift
            x = x + (silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
        else:
            hf = h.to(torch.float32)
            xk = hf + (_shifted(st["shift_ffn"][i], h) - hf) * lp["cm_lerp_k"]
            ck = torch.square(torch.relu(xk @ lp["cm_key"]))
            x = x + ck @ lp["cm_value"]
        x = ssm.layer_output(x)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"),
              cfg.ln_eps)
    logits = _head(params, x)
    if not carry:
        return logits, None
    return logits, {"shift_att": torch.stack(new_sa),
                    "shift_ffn": torch.stack(new_sf),
                    "wkv": torch.stack(new_wkv)}


# --- RWKV6 -------------------------------------------------------------------

def _wkv6_scan(r, w, k, v, u, S0):
    """out_j = sum_i r_i (S[i,j] + u_i k_i v_j); S = w_i S + k_i v_j (state
    row i the key dim, column j the value dim)."""
    S, outs = S0, []
    for t in range(r.shape[1]):
        r_t, w_t, k_t, v_t = (z[:, t] for z in (r, w, k, v))
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append((r_t[..., None, :] @ (S + u[None, :, :, None] * kv))[
            ..., 0, :])
        S = S * w_t[..., :, None] + kv
    return torch.stack(outs, 1), S


def _gla_scan(q, g, k, v, S0, scale):
    """Gated linear attention (qrwkv6): S = g_i S + k_i v_j, the output from
    the updated state: out_j = sum_i scale q_i S[i, j]."""
    S, outs = S0, []
    for t in range(q.shape[1]):
        q_t, g_t, k_t, v_t = (z[:, t] for z in (q, g, k, v))
        S = S * g_t[..., :, None] + k_t[..., :, None] * v_t[..., None, :]
        outs.append(((q_t * scale)[..., None, :] @ S)[..., 0, :])
    return torch.stack(outs, 1), S


def _time_mix6(cfg: Rwkv6Config, lp, x, x_prev, wkv0):
    b, t, D = x.shape
    H, hs = cfg.n_heads, cfg.head_size
    qr = cfg.arch == "rwkv6qwen2"
    xf = x.to(torch.float32)
    sx = x_prev - xf
    # ddlerp: 5 data-dependent deltas from one tanh bottleneck
    m = torch.tanh((xf + sx * lp["maa_x"]) @ lp["maa_w1"]).reshape(
        b, t, 5, -1)
    m = torch.einsum("btfr,frd->btfd", m, lp["maa_w2"])
    xs = {nm: xf + sx * (m[:, :, i] + lp["maa_" + nm])
          for i, nm in enumerate(("w", "k", "v", "r", "g"))}
    r, k, v = (xs[n] @ lp["w" + n] for n in ("r", "k", "v"))
    if cfg.proj_bias:
        r, k, v = r + lp["br"], k + lp["bk"], v + lp["bv"]
    g = xs["g"] @ lp["wg"]
    g = torch.sigmoid(g) if qr else silu(g)
    if cfg.n_kv_heads and cfg.n_kv_heads != H:
        rep = H // cfg.n_kv_heads
        k = k.reshape(b, t, cfg.n_kv_heads, hs).repeat_interleave(
            rep, 2).reshape(b, t, D)
        v = v.reshape(b, t, cfg.n_kv_heads, hs).repeat_interleave(
            rep, 2).reshape(b, t, D)
    w = torch.exp(-torch.exp(
        lp["decay"] + torch.tanh(xs["w"] @ lp["td_w1"]) @ lp["td_w2"]))
    if qr:
        k = k * (1.0 - w)
    rh, wh, kh, vh = (z.reshape(b, t, H, hs) for z in (r, w, k, v))
    if qr:
        out, S = _gla_scan(rh, wh, kh, vh, wkv0, hs ** -0.5)
        out = out.reshape(b, t, D)
    else:
        out, S = _wkv6_scan(rh, wh, kh, vh, lp["u"].reshape(H, hs), wkv0)
        out = _group_norm(out).reshape(b, t, D) * lp["ln_x_w"] + lp["ln_x_b"]
    return (out * g) @ lp["wo"], S


@full_float32()
def forward6(model: TreeLM, cfg: Rwkv6Config, tokens: torch.Tensor,
             state: dict[str, torch.Tensor] | None = None):
    params = model.params
    b, t = tokens.shape
    carry = state is not None
    st = state if carry else init_state6(cfg, b, model.device)
    qr = cfg.arch == "rwkv6qwen2"
    x = params["embed"][tokens].to(torch.float32)
    if not qr:
        x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], cfg.ln_eps)

    def norm(z, w_, b_):
        return _rms(z, w_, cfg.ln_eps) if qr else _ln(z, w_, b_, cfg.ln_eps)

    new_sa, new_sf, new_wkv = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = norm(x, lp["ln1_w"], lp.get("ln1_b"))
        new_sa.append(h[:, -1])
        mix, S = _time_mix6(cfg, lp, h, _shifted(st["shift_att"][i], h),
                            st["wkv"][i])
        new_wkv.append(S)
        x = x + mix
        h = norm(x, lp["ln2_w"], lp.get("ln2_b"))
        new_sf.append(h[:, -1])
        if qr:
            x = x + (silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
        else:
            x_prev = _shifted(st["shift_ffn"][i], h)
            xk = h + (x_prev - h) * lp["cm_lerp_k"]
            xr = h + (x_prev - h) * lp["cm_lerp_r"]
            rr = torch.sigmoid(xr @ lp["cm_receptance"])
            ck = torch.square(torch.relu(xk @ lp["cm_key"]))
            x = x + rr * (ck @ lp["cm_value"])
        x = ssm.layer_output(x)
    x = norm(x, params["final_norm"], params.get("final_norm_b"))
    logits = _head(params, x)
    if not carry:
        return logits, None
    return logits, {"shift_att": torch.stack(new_sa),
                    "shift_ffn": torch.stack(new_sf),
                    "wkv": torch.stack(new_wkv)}
