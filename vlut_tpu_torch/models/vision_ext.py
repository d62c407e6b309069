"""SigLIP + Gemma3 projector, Pixtral 2-D-rope ViT and the MiniCPM-V
resampler (port of ``vlut_tpu/models/vision_ext.py``).

* SigLIP ViT (learned positions, biased projections, gelu MLP,
  post-layernorm) -> 4x4 average pool to ``mm_tokens_per_image`` ->
  Gemma3RMSNorm (1 + w) -> linear into the decoder width.
* Pixtral: RMSNorm pre-norm ViT with per-patch 2-D rope (h-freqs even /
  w-freqs odd), no-bias QKVO, silu-gated MLP, a 2-layer GELU projector and
  mistral3's optional patch merger.

Both are dense float towers: plain ``torch.matmul`` products, the attention
an einsum-softmax-einsum in float32 (no SDPA), every operation in the JAX
package's order so a float32 tower equals it to float rounding.  The
helpers here (``_ln``, ``_rms``, ``_patchify``, ``_attend``) serve the
other tower modules too.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vlut_tpu_torch.device import full_float32


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    image_size: int = 896
    patch_size: int = 14
    d_model: int = 1152
    n_layers: int = 27
    n_heads: int = 16
    d_ff: int = 4304
    ln_eps: float = 1e-6
    d_llm: int = 2560                 # decoder width
    mm_tokens_per_image: int = 256    # gemma3 pooled token count


@dataclasses.dataclass(frozen=True)
class PixtralConfig:
    image_size: int = 1024
    patch_size: int = 16
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    d_llm: int = 5120
    proj_act: str = "gelu"
    # mistral-small-3.1 / lightonocr patch merger (0 = plain pixtral)
    spatial_merge_size: int = 0
    rms_eps_merge: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _ln(x, w, b, eps):
    """LayerNorm in float32 (two-pass: mean, then the centred variance)."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    v = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(v + eps) * w + b


def _rms(x, w, eps):
    xf = x.to(torch.float32)
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * w


def gelu(x, approximate: bool):
    """``jax.nn.gelu``: tanh form or erf form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def layer(layers: dict[str, torch.Tensor], i: int) -> dict[str, torch.Tensor]:
    """Layer i's views of a stacked (L, ...) tower tree."""
    return {k: v[i] for k, v in layers.items()}


def _patchify(images, patch):
    """(B, H, W, C) -> (B, gh*gw, p*p*C), row-major patches, (ph, pw, C)
    within a patch (a stride = kernel convolution after the weight
    reshape)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _attend(q, k, v, hd, bias=None):
    """(B, T, H, hd) q, k, v -> (B, T, H, hd) float32: scores in float32
    scaled by hd^-0.5, [+ bias], softmax, the weighted sum."""
    sc = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                      k.to(torch.float32)) * (hd ** -0.5)
    if bias is not None:
        sc = sc + bias
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32))


@full_float32()
def siglip_forward(params: dict[str, Any], cfg: SiglipConfig,
                   images: torch.Tensor, act: str = "tanh") -> torch.Tensor:
    """SigLIP ViT: (B, H, W, 3) -> (B, P, D) patch features: patchify +
    learned positions, pre-LN blocks with biased q/k/v/o, gelu MLP, final
    post-layernorm.  ``act``: "tanh" (siglip, gemma3, idefics3) or "exact"
    (janus-pro's erf gelu).  Also the siglip2 tower of lfm2-vl at its
    native grid."""
    b = images.shape[0]
    x = _patchify(images.to(torch.float32), cfg.patch_size)
    x = x @ params["patch_w"] + params["patch_b"]
    x = x + params["pos"][None]
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    t = x.shape[1]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(b, t, H, hd)
        k = (h @ lp["wk"] + lp["bk"]).reshape(b, t, H, hd)
        v = (h @ lp["wv"] + lp["bv"]).reshape(b, t, H, hd)
        att = _attend(q, k, v, hd).reshape(b, t, cfg.d_model)
        x = x + (att @ lp["wo"] + lp["bo"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        a = gelu(h @ lp["w1"] + lp["b1"], act == "tanh")
        x = x + (a @ lp["w2"] + lp["b2"])
    return _ln(x, params["post_ln_w"], params["post_ln_b"], cfg.ln_eps)


@full_float32()
def gemma3_project(params: dict[str, Any], cfg: SiglipConfig,
                   feats: torch.Tensor) -> torch.Tensor:
    """Gemma3 multimodal projector: average-pool the patch grid down to
    ``mm_tokens_per_image``, Gemma3RMSNorm (1 + w), matmul into the
    decoder width."""
    b, p, d = feats.shape
    side = cfg.image_size // cfg.patch_size
    tside = int(cfg.mm_tokens_per_image ** 0.5)
    ker = side // tside
    x = feats.reshape(b, tside, ker, tside, ker, d).mean(dim=(2, 4))
    x = x.reshape(b, tside * tside, d)
    x = _rms(x, 1.0 + params["soft_emb_norm"], cfg.ln_eps)
    return x @ params["mm_proj"]


def _pixtral_rope_tables(grid_hw, cfg: PixtralConfig, device):
    """(cos, sin) (N, hd) per patch: h positions drive the even frequency
    pairs, w positions the odd ones, halves duplicated (rotate-half)."""
    h, w = grid_hw
    hd = cfg.head_dim
    freqs = 1.0 / (cfg.rope_theta
                   ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    fh = np.outer(np.arange(h), freqs[::2])
    fw = np.outer(np.arange(w), freqs[1::2])
    full = np.concatenate([
        np.broadcast_to(fh[:, None, :], (h, w, fh.shape[1])),
        np.broadcast_to(fw[None, :, :], (h, w, fw.shape[1])),
    ], axis=-1).reshape(h * w, hd // 2)
    emb = np.concatenate([full, full], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def _rot_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


@full_float32()
def pixtral_forward(params: dict[str, Any], cfg: PixtralConfig,
                    images: torch.Tensor) -> torch.Tensor:
    """Pixtral ViT, one image: (1, H, W, 3) -> (N, D) patch features
    (RMSNorm pre-norms, no-bias QKVO, 2-D rope, silu-gated MLP)."""
    b, hh, ww, _ = images.shape
    assert b == 1, "one image per call; batch at the host level"
    grid = (hh // cfg.patch_size, ww // cfg.patch_size)
    x = _patchify(images.to(torch.float32), cfg.patch_size)
    x = x @ params["patch_w"]
    x = _rms(x, params["pre_norm"], cfg.rms_eps)
    cos, sin = _pixtral_rope_tables(grid, cfg, x.device)
    H, hd = cfg.n_heads, cfg.head_dim
    t = x.shape[1]

    def rope(z):  # (1, T, H, hd)
        return z * cos[None, :, None, :] + _rot_half(z) * sin[None, :, None, :]

    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = _rms(x, lp["attn_norm"], cfg.rms_eps)
        q = rope((h @ lp["wq"]).reshape(b, t, H, hd))
        k = rope((h @ lp["wk"]).reshape(b, t, H, hd))
        v = (h @ lp["wv"]).reshape(b, t, H, hd)
        att = _attend(q, k, v, hd).reshape(b, t, cfg.d_model)
        x = x + att @ lp["wo"]
        h = _rms(x, lp["ffn_norm"], cfg.rms_eps)
        x = x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    return x[0]


@full_float32()
def pixtral_project(params: dict[str, Any], feats: torch.Tensor,
                    cfg: PixtralConfig | None = None,
                    grid_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """The 2-layer GELU projector into the decoder width; with a patch
    merger (mistral3): RMSNorm -> each merge x merge block unfolded
    channel-major -> the no-bias merging linear, before the MLP."""
    if "merge_w" in params:
        assert cfg is not None and grid_hw is not None
        m = cfg.spatial_merge_size
        gh, gw = grid_hw
        n, d = feats.shape
        y = _rms(feats, params["input_norm"], cfg.rms_eps_merge)
        y = y.reshape(gh // m, m, gw // m, m, d)
        y = y.permute(0, 2, 4, 1, 3)         # (gh/m, gw/m, d, ky, kx)
        y = y.reshape((gh // m) * (gw // m), d * m * m)
        feats = y @ params["merge_w"]
    y = feats @ params["proj_w1"]
    if "proj_b1" in params:
        y = y + params["proj_b1"]
    y = gelu(y, False)
    y = y @ params["proj_w2"]
    if "proj_b2" in params:
        y = y + params["proj_b2"]
    return y


def minicpmv_pos_embed(grid_hw: tuple[int, int], d: int,
                       device="cpu") -> torch.Tensor:
    """MiniCPM-V's 2-D sincos table (n_pos, d): d/4 frequencies,
    [sin(w·ω) | cos(w·ω) | sin(h·ω) | cos(h·ω)] per patch."""
    h, w = grid_hw
    omega = 1.0 / (10000.0 ** (np.arange(d // 4, dtype=np.float64)
                               / (d / 4)))
    hp = np.repeat(np.arange(h), w).astype(np.float64)
    wp = np.tile(np.arange(w), h).astype(np.float64)
    tx = wp[:, None] * omega[None]
    ty = hp[:, None] * omega[None]
    pos = np.concatenate(
        [np.sin(tx), np.cos(tx), np.sin(ty), np.cos(ty)], axis=-1)
    return torch.tensor(pos, dtype=torch.float32, device=device)


@full_float32()
def minicpmv_resampler(params: dict[str, Any], feats: torch.Tensor,
                       grid_hw: tuple[int, int],
                       d_head: int = 128) -> torch.Tensor:
    """MiniCPM-V perceiver resampler: ``num_query`` learned queries
    cross-attend over kv_proj'd patch features whose keys carry the 2-D
    sincos table; LayerNorms throughout; a final linear to the decoder
    width.  Returns (num_query, d_llm)."""
    eps = 1e-6
    q = _ln(params["query"], params["ln_q_w"], params["ln_q_b"], eps)
    v = feats @ params["kv_proj"]
    v = _ln(v, params["ln_kv_w"], params["ln_kv_b"], eps)
    d = q.shape[-1]
    k = v + minicpmv_pos_embed(grid_hw, d, v.device)[:, :d]
    nq, npos = q.shape[0], k.shape[0]
    nh = d // d_head
    Q = (q @ params["attn_q_w"] + params["attn_q_b"]).reshape(nq, nh, d_head)
    K = (k @ params["attn_k_w"] + params["attn_k_b"]).reshape(npos, nh,
                                                              d_head)
    V = (v @ params["attn_v_w"] + params["attn_v_b"]).reshape(npos, nh,
                                                              d_head)
    sc = torch.einsum("qhd,khd->hqk", Q, K) * (d_head ** -0.5)
    p = torch.softmax(sc, dim=-1)
    att = torch.einsum("hqk,khd->qhd", p, V).reshape(nq, d)
    out = att @ params["attn_o_w"] + params["attn_o_b"]
    out = _ln(out, params["ln_post_w"], params["ln_post_b"], eps)
    return out @ params["mm_proj"]
