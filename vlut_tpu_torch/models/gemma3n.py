"""Gemma3n's text model (MatFormer E2B / E4B), port of
``vlut_tpu/models/gemma3n.py``: a full-sequence float32 ``forward``.

AltUp streams (predict and correct around each layer), LAuReL's low-rank
residual, per-layer input embeddings, gaussian top-k activation sparsity,
local / global layers with their own rope bases and a sliding window, and
KV sharing for the tail layers: a shared layer reuses the K / V of the
last non-shared layer of its attention type.  Weights are stored (in, out)
and held in float32; no kernel of the port runs here.  The JAX package
reaches it from no entry point; neither does the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.ssm import TreeLM


@dataclasses.dataclass(frozen=True)
class Gemma3nConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: tuple[int, ...]            # per layer (MatFormer)
    layer_types: tuple[str, ...]     # "sliding_attention" | "full_attention"
    sliding_window: int = 512
    rms_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_theta_local: float = 10000.0
    n_altup: int = 4
    altup_active: int = 0
    altup_correct_scale: bool = True
    laurel_rank: int = 64
    pl_dim: int = 256                # hidden_size_per_layer_input
    pl_vocab: int = 262144           # vocab_size_per_layer_input
    n_kv_shared: int = 0             # num_kv_shared_layers (tail)
    sparsity: tuple[float, ...] = ()  # activation_sparsity_pattern per layer
    logit_softcap: float = 30.0
    max_seq_len: int = 32768
    arch: str = "gemma3n"


def _rms(x, w, eps):
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return out * w if w is not None else out


def _rope(x, pos, theta):
    """NEOX full-head rope (rotate_half)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos[:, :, None].to(torch.float32) * inv
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)[:, :, None, :]
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)[:, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def norm_ppf(p: float) -> float:
    """The standard normal's inverse CDF at p (the sparsity cutoff), by
    ``scipy.special.erfinv``, as the JAX package computes it."""
    from scipy.special import erfinv

    return float(math.sqrt(2.0) * erfinv(2.0 * p - 1.0))


def _gaussian_topk(x, p: float):
    """relu(x - (mean + std * icdf(p))), the biased std."""
    mu = x.mean(-1, keepdim=True)
    std = torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True))
    return torch.relu(x - (mu + std * norm_ppf(p)))


def _magnitude(x, clamp: bool):
    m = torch.mean(x * x, dim=-1, keepdim=True)
    if clamp:
        m = torch.clamp(m, min=1e-5)
    return torch.sqrt(m)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


@torch.inference_mode()
@full_float32()
def forward(model: TreeLM, cfg: Gemma3nConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal logits (B, T, V), float32."""
    p = model.params
    b, t = tokens.shape
    d, n_alt, act = cfg.d_model, cfg.n_altup, cfg.altup_active
    dev = tokens.device
    pos = torch.arange(t, device=dev)[None].expand(b, t)

    x0 = p["embed"][tokens].to(torch.float32) * math.sqrt(d)
    # per-layer inputs: the scaled per-layer embedding plus the projected
    # main embedding, normed, summed and scaled 1/sqrt(2)
    plin = p["embed_per_layer"][tokens].to(torch.float32)
    plin = plin.reshape(b, t, cfg.n_layers, cfg.pl_dim) * math.sqrt(
        cfg.pl_dim)
    plproj = (x0 @ p["per_layer_model_proj"]) * (d ** -0.5)
    plproj = _rms(plproj.reshape(b, t, cfg.n_layers, cfg.pl_dim),
                  p["per_layer_proj_norm"], cfg.rms_eps)
    per_layer = (plproj + plin) * (2.0 ** -0.5)

    # n_altup streams, magnitude-matched to the embedding
    tmag = _magnitude(x0, clamp=False)
    streams = [x0]
    for i in range(n_alt - 1):
        u = x0 @ p["altup_proj"][i]
        streams.append(u * tmag / _magnitude(u, clamp=True))
    hs = torch.stack(streams, dim=0)  # (n_alt, B, T, D)

    ar = torch.arange(t, device=dev)
    causal = ar[None, :] <= ar[:, None]
    rel = ar[:, None] - ar[None, :]
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    masks = {
        "full_attention": torch.where(causal, zero, neg),
        "sliding_attention": torch.where(
            causal & (rel < cfg.sliding_window), zero, neg),
    }

    def router_modalities(lp, z):
        r = _rms(z, lp["altup_router_norm"], cfg.rms_eps) * (1.0 / d)
        return torch.tanh((r @ lp["altup_router"]).to(torch.float32))

    first_shared = cfg.n_layers - cfg.n_kv_shared
    shared_kv: dict[str, tuple] = {}
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for li in range(cfg.n_layers):
        lp = p["layers"][li]
        ltype = cfg.layer_types[li]
        theta = (cfg.rope_theta_local if ltype == "sliding_attention"
                 else cfg.rope_theta)

        # altup predict
        mods = router_modalities(lp, hs[act])
        coefs = (mods @ lp["altup_predict_coef"]).reshape(b, t, n_alt, n_alt)
        preds = torch.einsum("nbtd,btjn->jbtd", hs, coefs) + hs
        active = preds[act]
        hh = _rms(active, lp["attn_norm"], cfg.rms_eps)
        # laurel on the normed active prediction
        lr = (hh @ lp["laurel_l"]) @ lp["laurel_r"]
        laurel_out = hh + _rms(lr, lp["laurel_post_norm"], cfg.rms_eps)

        # attention: scale 1, a weightless v norm, KV sharing
        q = _rms((hh @ lp["wq"]).reshape(b, t, h, hd), lp["q_norm"],
                 cfg.rms_eps)
        q = _rope(q, pos, theta)
        if li >= first_shared and cfg.n_kv_shared > 0:
            k, v = shared_kv[ltype]
        else:
            k = _rms((hh @ lp["wk"]).reshape(b, t, kvh, hd), lp["k_norm"],
                     cfg.rms_eps)
            k = _rope(k, pos, theta)
            v = _rms((hh @ lp["wv"]).reshape(b, t, kvh, hd), None,
                     cfg.rms_eps)
            shared_kv[ltype] = (k, v)
        rep = h // kvh
        kf = torch.repeat_interleave(k, rep, dim=2)
        vf = torch.repeat_interleave(v, rep, dim=2)
        sc = torch.einsum("bthd,bshd->bhts", q, kf) + masks[ltype][None, None]
        att = torch.einsum("bhts,bshd->bthd", torch.softmax(sc, dim=-1),
                           vf).reshape(b, t, h * hd)
        attn_out = _rms(att @ lp["wo"], lp["post_attn_norm"], cfg.rms_eps)
        attn_laurel = (active + attn_out + laurel_out) * (2.0 ** -0.5)

        # MLP: the layer's width, gelu-tanh, activation sparsity
        hn = _rms(attn_laurel, lp["ffn_norm"], cfg.rms_eps)
        gate = hn @ lp["w_gate"]
        if cfg.sparsity and cfg.sparsity[li] > 0.0:
            gate = _gaussian_topk(gate, cfg.sparsity[li])
        ffw = (_gelu(gate) * (hn @ lp["w_up"])) @ lp["w_down"]
        out = attn_laurel + _rms(ffw, lp["post_ffn_norm"], cfg.rms_eps)

        # altup correct
        mods2 = router_modalities(lp, out)
        ccoefs = (mods2 @ lp["altup_correct_coef"]) + 1.0
        innovation = out - preds[act]
        corrected = preds + innovation[None] * ccoefs.permute(2, 0, 1)[
            ..., None]

        # per-layer input injection
        first = corrected[act]
        if cfg.altup_correct_scale:
            first = first * lp["altup_correct_scale"]
        g = _gelu(first @ lp["per_layer_inp_gate"]) * per_layer[:, :, li]
        g = _rms(g @ lp["per_layer_proj"], lp["per_layer_post_norm"],
                 cfg.rms_eps)
        hs = torch.cat([corrected[:1], corrected[1:] + g[None]], dim=0)

    # merge the streams: magnitude-matched unembed projections, mean
    tmag = _magnitude(hs[0], clamp=False)
    outs = [hs[0]]
    for i in range(n_alt - 1):
        u = hs[i + 1] @ p["altup_unembed_proj"][i]
        outs.append(u * tmag / _magnitude(u, clamp=True))
    x = sum(outs) / n_alt
    x = _rms(x, p["final_norm"], cfg.rms_eps)
    head = p.get("lm_head")
    if head is None:
        head = p["embed"].T.to(torch.float32)
    logits = x @ head
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits

