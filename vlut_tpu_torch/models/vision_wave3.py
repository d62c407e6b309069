"""InternVL, Llama4 vision, Idefics3, Janus-Pro, LFM2-VL, GLM4-V, Qwen3-VL
(DeepStack), and the towers and projectors held only against twins:
MobileVLM's LDP / LDPv2, GLM-Edge, Youtu-VL, CogVLM's EVA2-CLIP and
Kimi-VL (port of ``vlut_tpu/models/vision_wave3.py``).

Dense float towers like ``models/vision_ext.py``: plain ``torch.matmul``
products, einsum-softmax-einsum attention in float32, every operation in
the JAX package's order.  Embeddings splice into the decoder through
``forward``'s ``token_embeds``; qwen3vl's DeepStack features through
``forward``'s ``deepstack_embeds``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.qwen_vision import (
    QwenVisionConfig, _self_attend, _vision_rot_table, window_layout)
from vlut_tpu_torch.models.vision_ext import (
    _attend, _ln, _patchify, _rms, _rot_half, gelu, layer)


def _resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(h, w, d) -> (H, W, d): ``jax.image.resize(method="bicubic")`` (Keys
    cubic a = -0.5, half-pixel centres, antialiased when shrinking), one
    weight matrix per spatial axis, contracted h then w."""
    def weights(n_in: int, n_out: int) -> torch.Tensor:
        scale = np.float32(n_out) / np.float32(n_in)
        inv = np.float32(1.0) / scale
        ks = max(inv, np.float32(1.0))
        f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
            - np.float32(0.5)
        z = np.abs(f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
            / ks
        w = ((np.float32(1.5) * z - np.float32(2.5)) * z) * z + np.float32(1)
        w = np.where(z >= 1, ((np.float32(-0.5) * z + np.float32(2.5)) * z
                              - np.float32(4)) * z + np.float32(2), w)
        w = np.where(z >= 2, np.float32(0), w).astype(np.float32)
        tot = w.sum(0, keepdims=True)
        w = np.where(np.abs(tot) > 1000 * float(np.finfo(np.float32).eps),
                     w / np.where(tot != 0, tot, 1), 0)
        ok = (f >= -0.5) & (f <= n_in - 0.5)
        return torch.from_numpy(np.where(ok[None, :], w, 0).astype(
            np.float32)).to(x.device)

    wh = weights(x.shape[0], out_hw[0])
    ww = weights(x.shape[1], out_hw[1])
    y = torch.einsum("hwd,hH->Hwd", x.to(torch.float32), wh)
    return torch.einsum("Hwd,wW->HWd", y, ww)


def _block_major(gh: int, gw: int, m: int, device):
    """(rows, cols) of each patch in merge-block-major order."""
    hh = np.arange(gh).reshape(gh // m, m, 1, 1)
    hh = np.broadcast_to(hh, (gh // m, m, gw // m, m))
    hh = hh.transpose(0, 2, 1, 3).reshape(-1)
    ww = np.arange(gw).reshape(1, 1, gw // m, m)
    ww = np.broadcast_to(ww, (gh // m, m, gw // m, m))
    ww = ww.transpose(0, 2, 1, 3).reshape(-1)
    return torch.from_numpy(hh).to(device), torch.from_numpy(ww).to(device)


# ---------------------------------------------------------------------------
# InternVL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    image_size: int = 448
    patch_size: int = 14
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    ln_eps: float = 1e-6
    norm_type: str = "layer_norm"   # "layer_norm" | "rms_norm" (6B ViT)
    use_qk_norm: bool = False       # full-width RMS on q/k (large ViTs)
    downsample: int = 2             # 1/downsample_ratio pixel-shuffle
    d_llm: int = 4096
    proj_act: str = "gelu"


def _norm(x, w, b, eps, kind):
    if kind == "rms_norm":
        return _rms(x, w, eps)
    return _ln(x, w, b, eps)


@full_float32()
def internvl_forward(params: dict[str, Any], cfg: InternVLConfig,
                     images: torch.Tensor) -> torch.Tensor:
    """InternVL ViT: (B, H, W, 3) -> (B, P+1, D), CLS first: conv patchify
    (+ bias), learned positions, pre-norm blocks with layer-scale lambdas,
    q/k/v [+ biases], optional full-width q/k RMS norm, biased GELU MLP."""
    b = images.shape[0]
    x = _patchify(images.to(torch.float32), cfg.patch_size)
    x = x @ params["patch_w"] + params["patch_b"]
    cls = params["cls"].expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    if "pos" in params:
        x = x + params["pos"][None]
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    t = x.shape[1]
    nt = cfg.norm_type
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = _norm(x, lp["ln1_w"], lp.get("ln1_b"), cfg.ln_eps, nt)
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if "bq" in lp:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if cfg.use_qk_norm:
            q = _rms(q, lp["qn"], cfg.ln_eps)
            k = _rms(k, lp["kn"], cfg.ln_eps)
        q = q.reshape(b, t, H, hd)
        k = k.reshape(b, t, H, hd)
        v = v.reshape(b, t, H, hd)
        att = _attend(q, k, v, hd).reshape(b, t, cfg.d_model)
        att = att @ lp["wo"] + lp["bo"]
        x = x + lp["ls1"] * att
        h = _norm(x, lp["ln2_w"], lp.get("ln2_b"), cfg.ln_eps, nt)
        a = gelu(h @ lp["w1"] + lp["b1"], False)
        x = x + lp["ls2"] * (a @ lp["w2"] + lp["b2"])
    if "final_ln_w" in params:  # absent when use_mean_pooling
        x = _norm(x, params["final_ln_w"], params.get("final_ln_b"),
                  cfg.ln_eps, nt)
    return x


def internvl_pixel_shuffle(x: torch.Tensor, scale: float = 0.5):
    """HF InternVLModel.pixel_shuffle: (B, W, H, C), two reshape /
    transpose rounds folding a (1/scale)^2 block into channels."""
    b, w, h, c = x.shape
    x = x.reshape(b, w, int(h * scale), int(c / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, int(h * scale), int(w * scale), int(c / scale ** 2))
    return x.permute(0, 2, 1, 3)


@full_float32()
def internvl_project(params: dict[str, Any], cfg: InternVLConfig,
                     feats: torch.Tensor) -> torch.Tensor:
    """Drop CLS -> pixel shuffle -> LayerNorm -> linear / GELU / linear."""
    b, p1, d = feats.shape
    side = int(round((p1 - 1) ** 0.5))
    x = feats[:, 1:].reshape(b, side, side, d)
    x = internvl_pixel_shuffle(x, 1.0 / cfg.downsample)
    x = x.reshape(b, -1, d * cfg.downsample ** 2)
    x = _ln(x, params["proj_ln_w"], params["proj_ln_b"], 1e-5)
    x = x @ params["proj_w1"] + params["proj_b1"]
    x = gelu(x, cfg.proj_act == "gelu_pytorch_tanh")
    return x @ params["proj_w2"] + params["proj_b2"]


# ---------------------------------------------------------------------------
# Llama4 vision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Llama4VisionConfig:
    image_size: int = 336
    patch_size: int = 14
    d_model: int = 1408
    n_layers: int = 34
    n_heads: int = 16
    d_ff: int = 5632
    rope_theta: float = 10000.0
    ln_eps: float = 1e-5
    pixel_shuffle_ratio: float = 0.5
    projector_input_dim: int = 4096
    projector_output_dim: int = 4096
    d_llm: int = 5120

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _llama4_rope_tables(cfg: Llama4VisionConfig, device):
    """(cos, sin) (P+1, hd/2), complex-pair convention: x coordinates
    drive the first hd/4 pair frequencies, y the second; the trailing CLS
    row rotates by zero."""
    idx = cfg.image_size // cfg.patch_size
    pos = np.arange(idx * idx)
    fx, fy = pos % idx, pos // idx
    freq_dim = cfg.head_dim // 2
    rf = 1.0 / (cfg.rope_theta
                ** (np.arange(0, freq_dim, 2)[: freq_dim // 2] / freq_dim))
    freqs = np.concatenate([
        (fx + 1)[:, None] * rf[None, :],
        (fy + 1)[:, None] * rf[None, :],
    ], axis=-1)
    freqs = np.concatenate([freqs, np.zeros((1, freqs.shape[1]))], axis=0)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.sin(freqs), dtype=torch.float32, device=device))


def _rope_pairs(z, cos, sin):
    """Complex-pair rotation: channels (2j, 2j+1) rotate by angle j."""
    zr, zi = z[..., 0::2], z[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([zr * c - zi * s, zr * s + zi * c], dim=-1)
    return out.reshape(z.shape)


@full_float32()
def llama4_vision_forward(params: dict[str, Any], cfg: Llama4VisionConfig,
                          images: torch.Tensor) -> torch.Tensor:
    """Llama4 ViT: (B, H, W, 3) -> (B, P+1, D) post-LN features, CLS last:
    unfold patchify + no-bias linear, learned positions, complex 2-D rope,
    biased q/k/v/o, exact-GELU MLP, LayerNorms before and after."""
    b = images.shape[0]
    x = _patchify(images.to(torch.float32), cfg.patch_size)
    x = x @ params["patch_w"]
    cls = params["cls"].expand(b, 1, cfg.d_model)
    x = torch.cat([x, cls], dim=1)
    x = x + params["pos"][None]
    x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], cfg.ln_eps)
    cos, sin = _llama4_rope_tables(cfg, x.device)
    H, hd = cfg.n_heads, cfg.head_dim
    t = x.shape[1]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(b, t, H, hd)
        k = (h @ lp["wk"] + lp["bk"]).reshape(b, t, H, hd)
        v = (h @ lp["wv"] + lp["bv"]).reshape(b, t, H, hd)
        q = _rope_pairs(q, cos, sin)
        k = _rope_pairs(k, cos, sin)
        att = _attend(q, k, v, hd).reshape(b, t, cfg.d_model)
        x = x + (att @ lp["wo"] + lp["bo"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        a = gelu(h @ lp["w1"] + lp["b1"], False)
        x = x + (a @ lp["w2"] + lp["b2"])
    return _ln(x, params["post_ln_w"], params["post_ln_b"], cfg.ln_eps)


def llama4_pixel_shuffle(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """HF llama4 pixel_shuffle ((B, P, C), square grid)."""
    b, p, c = x.shape
    side = int(round(p ** 0.5))
    x = x.reshape(b, side, side, c)
    x = x.reshape(b, side, int(side * ratio), int(c / ratio))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, int(side * ratio), int(side * ratio),
                  int(c / ratio ** 2))
    x = x.permute(0, 2, 1, 3)
    return x.reshape(b, -1, int(c / ratio ** 2))


@full_float32()
def llama4_project(params: dict[str, Any], cfg: Llama4VisionConfig,
                   feats: torch.Tensor) -> torch.Tensor:
    """Drop the trailing CLS -> pixel shuffle -> no-bias fc1 / GELU / fc2 /
    GELU adapter -> no-bias projector."""
    x = llama4_pixel_shuffle(feats[:, :-1], cfg.pixel_shuffle_ratio)
    x = gelu(x @ params["adapter_w1"], False)
    x = gelu(x @ params["adapter_w2"], False)
    return x @ params["mm_proj"]


# ---------------------------------------------------------------------------
# Janus-Pro aligner and the LFM2-VL projector (their towers are
# vision_ext.siglip_forward)
# ---------------------------------------------------------------------------

@full_float32()
def janus_aligner(params: dict[str, Any], feats: torch.Tensor):
    """Janus-Pro's understanding aligner: fc1, then (GELU, linear) per
    hidden layer, into the decoder width."""
    x = feats @ params["aligner_w0"] + params["aligner_b0"]
    if "aligner_wh" in params:
        for w, b_ in zip(params["aligner_wh"], params["aligner_bh"]):
            x = gelu(x, False) @ w + b_
    return x


@full_float32()
def lfm2vl_project(params: dict[str, Any], feats: torch.Tensor,
                   factor: int) -> torch.Tensor:
    """Pixel unshuffle (square grid) + LayerNorm + biased GELU MLP into the
    decoder width."""
    b, p, c = feats.shape
    side = int(round(p ** 0.5))
    x = feats.reshape(b, side, side, c)
    x = x.reshape(b, side, side // factor, c * factor)
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, side // factor, side // factor, c * factor ** 2)
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, p // factor ** 2, c * factor ** 2)
    x = _ln(x, params["proj_ln_w"], params["proj_ln_b"], 1e-5)
    x = gelu(x @ params["proj_w1"] + params["proj_b1"], False)
    return x @ params["proj_w2"] + params["proj_b2"]


# ---------------------------------------------------------------------------
# MobileVLM LDP / LDPv2 projectors over the CLIP tower
# ---------------------------------------------------------------------------

def _hardswish(x):
    return x * torch.clip((x + 3.0) / 6.0, 0.0, 1.0)


def _conv_nhwc(x, w_hwio, stride=1, padding=0, groups=1):
    """An NHWC convolution with HWIO weights (``conv_general_dilated``)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _dw_conv3(x, w, stride=1):
    """Depthwise 3x3 conv, NHWC x (3, 3, 1, C) HWIO, pad 1."""
    return _conv_nhwc(x, w, stride, 1, x.shape[-1])


def _ldp_block(x, p, prefix, stride, eps=1e-5, residual=True):
    """One LDP block: depthwise 3x3 -> LayerNorm -> hardswish ->
    squeeze-excite -> pointwise conv -> LayerNorm [-> + input]."""
    y = _dw_conv3(x, p[f"{prefix}_dw"], stride=stride)
    y = _ln(y, p[f"{prefix}_ln0_w"], p[f"{prefix}_ln0_b"], eps)
    hw = _hardswish(y)
    se = hw.mean(dim=(1, 2))
    se = F.relu(se @ p[f"{prefix}_fc1_w"] + p[f"{prefix}_fc1_b"])
    se = se @ p[f"{prefix}_fc2_w"] + p[f"{prefix}_fc2_b"]
    se = torch.clip((se + 3.0) / 6.0, 0.0, 1.0)
    y = hw * se[:, None, None, :]
    y = y @ p[f"{prefix}_pw"]
    y = _ln(y, p[f"{prefix}_ln1_w"], p[f"{prefix}_ln1_b"], eps)
    return x + y if residual else y


@full_float32()
def ldp_project(params: dict[str, Any], feats: torch.Tensor) -> torch.Tensor:
    """MobileVLM LDP: biased GELU MLP -> block 1 (stride 1, residual) ->
    block 2 (stride 2) -> (B, P/4, C)."""
    b, p_, d = feats.shape
    side = int(round(p_ ** 0.5))
    x = gelu(feats @ params["mlp1_w"] + params["mlp1_b"], True)
    x = x @ params["mlp3_w"] + params["mlp3_b"]
    x = x.reshape(b, side, side, -1)
    x = _ldp_block(x, params, "b1", stride=1, residual=True)
    x = _ldp_block(x, params, "b2", stride=2, residual=False)
    return x.reshape(b, (side // 2) ** 2, x.shape[-1])


@full_float32()
def ldpv2_project(params: dict[str, Any], feats: torch.Tensor):
    """MobileVLM-v2 LDP: biased GELU MLP -> 2x2 stride-2 average pool ->
    3x3 depthwise PEG conv (+ bias) with residual -> (B, P/4, C)."""
    b, p_, d = feats.shape
    side = int(round(p_ ** 0.5))
    x = gelu(feats @ params["mlp0_w"] + params["mlp0_b"], True)
    x = x @ params["mlp2_w"] + params["mlp2_b"]
    x = x.reshape(b, side, side, -1)
    x = x.reshape(b, side // 2, 2, side // 2, 2, -1).sum(dim=(2, 4)) / 4.0
    peg = _dw_conv3(x, params["peg_w"]) + params["peg_b"]
    x = peg + x
    return x.reshape(b, (side // 2) ** 2, x.shape[-1])


# ---------------------------------------------------------------------------
# GLM-Edge adapter (the tower is models/vision.py's CLIP)
# ---------------------------------------------------------------------------

@full_float32()
def glm_edge_project(params: dict[str, Any], feats: torch.Tensor):
    """GLM-Edge adapter: 2x2 stride-2 conv over the patch grid -> linear
    -> LayerNorm -> GELU -> silu(mlp2 x) * mlp1 x -> down linear, between
    BOI / EOI rows."""
    b, p, c = feats.shape
    side = int(round(p ** 0.5))
    x = feats.reshape(b, side, side, c)
    x = _conv_nhwc(x, params["conv_w"], stride=2) + params["conv_b"]
    x = x.reshape(b, -1, x.shape[-1])
    x = x @ params["mlp0_w"]
    x = _ln(x, params["ln_w"], params["ln_b"], 1e-5)
    x = gelu(x, True)
    g = F.silu(x @ params["mlp2_w"]) * (x @ params["mlp1_w"])
    x = g @ params["mlp3_w"]
    boi = params["boi"].expand(b, 1, x.shape[-1])
    eoi = params["eoi"].expand(b, 1, x.shape[-1])
    return torch.cat([boi, x, eoi], dim=1)


# ---------------------------------------------------------------------------
# Youtu-VL vision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class YoutuVLConfig:
    patch_size: int = 16
    d_model: int = 1152
    n_layers: int = 27
    n_heads: int = 16
    d_ff: int = 4304
    d_out: int = 2048
    merge: int = 2
    ln_eps: float = 1e-6
    rope_theta: float = 10000.0
    # layers with full attention when window attention is on; empty = full
    # attention everywhere
    wa_layer_indexes: tuple[int, ...] = ()
    window_size: int = 0  # in patches

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@full_float32()
def youtuvl_vision_forward(params: dict[str, Any], vc: YoutuVLConfig,
                           patches: torch.Tensor,
                           grid_hw: tuple[int, int]) -> torch.Tensor:
    """Youtu-VL ViT: (N, p*p*C) merge-block-major rows -> (N/merge^2,
    d_out): linear patchify [+ bias], optional pre-LN, 2-D rope, biased
    q/k/v, window attention off the ``wa_layer_indexes``, tanh-GELU MLP,
    window order restored, optional post-LN, then RMSNorm -> merge ->
    biased GELU MLP."""
    m = vc.merge
    m2 = m * m
    x = patches.to(torch.float32) @ params["patch_w"]
    if "patch_b" in params:
        x = x + params["patch_b"]
    if "pre_ln_w" in params:
        x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], vc.ln_eps)
    dev = x.device
    cos, sin = _vision_rot_table(grid_hw, vc.head_dim, m, dev)
    H, hd = vc.n_heads, vc.head_dim
    n = x.shape[0]

    win_mask = inv_units = None
    if vc.wa_layer_indexes and vc.window_size > 0:
        qvc = QwenVisionConfig(
            depth=vc.n_layers, embed_dim=vc.d_model, n_heads=vc.n_heads,
            mlp_dim=vc.d_ff, patch_size=vc.patch_size, spatial_merge_size=m,
            window_size=vc.window_size * vc.patch_size)
        perm, win_mask, inv_units = window_layout(grid_hw, qvc, m2, dev)
        x = x[perm]
        cos, sin = cos[perm], sin[perm]

    def rope(z):
        return z * cos[:, None, :] + _rot_half(z) * sin[:, None, :]

    for i in range(vc.n_layers):
        lp = layer(params["layers"], i)
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], vc.ln_eps)
        q = rope((h @ lp["wq"] + lp["bq"]).reshape(n, H, hd))
        k = rope((h @ lp["wk"] + lp["bk"]).reshape(n, H, hd))
        v = (h @ lp["wv"] + lp["bv"]).reshape(n, H, hd)
        full = win_mask is None or i in vc.wa_layer_indexes
        att = _self_attend(q, k, v, hd, None if full else win_mask)
        x = x + (att @ lp["wo"] + lp["bo"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], vc.ln_eps)
        a = gelu(h @ lp["w1"] + lp["b1"], True)
        x = x + (a @ lp["w2"] + lp["b2"])

    if inv_units is not None:
        perm = (inv_units[:, None] * m2 + np.arange(m2)[None]).reshape(-1)
        x = x[torch.from_numpy(perm).to(dev)]
    if "post_ln_w" in params:
        x = _ln(x, params["post_ln_w"], params["post_ln_b"], vc.ln_eps)
    x = _rms(x, params["merge_norm"], 1e-6)
    y = x.reshape(n // m2, m2 * vc.d_model)
    y = gelu(y @ params["merge_fc1_w"] + params["merge_fc1_b"], True)
    return y @ params["merge_fc2_w"] + params["merge_fc2_b"]


# ---------------------------------------------------------------------------
# CogVLM vision (EVA2-CLIP tower + gated adapter; the text side's visual
# experts are models/transformer.py's dual_expert)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CogVLMVisionConfig:
    image_size: int = 490
    patch_size: int = 14
    d_model: int = 1792
    n_layers: int = 63
    n_heads: int = 16
    d_ff: int = 15360
    ln_eps: float = 1e-6
    d_llm: int = 4096


@full_float32()
def cogvlm_vision_forward(params: dict[str, Any], cfg: CogVLMVisionConfig,
                          images: torch.Tensor) -> torch.Tensor:
    """CogVLM's EVA2-CLIP tower: (B, H, W, 3) -> (B, P+1, D), CLS last;
    post-norm blocks (attention -> LN -> + residual; gated-GELU FFN -> LN
    -> + residual), fused biased qkv, biased o."""
    b = images.shape[0]
    x = _patchify(images.to(torch.float32), cfg.patch_size)
    x = x @ params["patch_w"] + params["patch_b"]
    cls = params["cls"].expand(b, 1, cfg.d_model)
    x = torch.cat([x, cls], dim=1)
    x = x + params["pos"][None]
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    t = x.shape[1]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        qkv = (x @ lp["wqkv"] + lp["bqkv"]).reshape(b, t, 3, H, hd)
        att = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], hd)
        att = att.reshape(b, t, cfg.d_model) @ lp["wo"] + lp["bo"]
        att = _ln(att, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        x = x + att
        # the up operand is activated: gelu(up(x)) * gate(x)
        a = gelu(x @ lp["w_up"] + lp["b_up"], True) * (
            x @ lp["w_gate"] + lp["b_gate"])
        f = a @ lp["w_down"] + lp["b_down"]
        f = _ln(f, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        x = x + f
    return x


@full_float32()
def cogvlm_project(params: dict[str, Any], feats: torch.Tensor):
    """Drop the trailing CLS -> no-bias linear -> LayerNorm(1e-5) -> GELU
    -> silu(gate) * h_to_4h -> down linear, between BOI / EOI rows."""
    b = feats.shape[0]
    x = feats[:, :-1] @ params["mm_proj"]
    x = _ln(x, params["post_fc_ln_w"], params["post_fc_ln_b"], 1e-5)
    x = gelu(x, True)
    g = F.silu(x @ params["gate_w"]) * (x @ params["h4h_w"])
    x = g @ params["h4h_down_w"]
    boi = params["boi"].expand(b, 1, x.shape[-1])
    eoi = params["eoi"].expand(b, 1, x.shape[-1])
    return torch.cat([boi, x, eoi], dim=1)


# ---------------------------------------------------------------------------
# Qwen3-VL DeepStack vision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Qwen3VLVisionConfig:
    patch_size: int = 16
    d_model: int = 1152
    n_layers: int = 27
    n_heads: int = 16
    d_ff: int = 4304
    d_out: int = 2048            # out_hidden_size (= LLM width)
    temporal_patch_size: int = 2
    merge: int = 2
    pos_grid: int = 48           # sqrt(num_position_embeddings)
    deepstack_indexes: tuple[int, ...] = (8, 16, 24)
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _qwen3vl_merger(params, prefix: str, x, d: int, m2: int,
                    post_shuffle: bool, eps: float):
    """Qwen3VLVisionPatchMerger: LayerNorm at n_embd (the main merger) or at
    the merged width (DeepStack's) -> fc1 / GELU / fc2."""
    n = x.shape[0]
    if post_shuffle:
        y = x.reshape(n // m2, m2 * d)
        y = _ln(y, params[f"{prefix}_ln_w"], params[f"{prefix}_ln_b"], eps)
    else:
        y = _ln(x, params[f"{prefix}_ln_w"], params[f"{prefix}_ln_b"], eps)
        y = y.reshape(n // m2, m2 * d)
    y = gelu(y @ params[f"{prefix}_fc1_w"] + params[f"{prefix}_fc1_b"],
             False)
    return y @ params[f"{prefix}_fc2_w"] + params[f"{prefix}_fc2_b"]


@full_float32()
def qwen3vl_vision_forward(params: dict[str, Any], vc: Qwen3VLVisionConfig,
                           patches: torch.Tensor, grid_hw: tuple[int, int]):
    """Qwen3-VL ViT: (N, C*tp*p*p) merge-block-major rows -> (main
    (N/merge^2, d_out), the DeepStack features, one (N/merge^2, d_out) per
    ``deepstack_indexes`` entry).  Conv3d patchify (+ bias), learned
    positions gathered merge-block-major (bilinear off the native grid),
    2-D rotate-half rope, LN pre-norm blocks with fused biased qkv and a
    plain tanh-GELU MLP; the main merger norms before the shuffle, the
    DeepStack mergers after it."""
    gh, gw = grid_hw
    m = vc.merge
    m2 = m * m
    x = patches.to(torch.float32) @ params["patch_w"] + params["patch_b"]
    dev = x.device

    pos = params["pos"]
    side = vc.pos_grid
    pos2d = pos.reshape(side, side, vc.d_model)
    if (gh, gw) != (side, side):
        hi = np.linspace(0, side - 1, gh)
        wi = np.linspace(0, side - 1, gw)
        hf_, wf_ = np.floor(hi).astype(int), np.floor(wi).astype(int)
        hc = np.clip(hf_ + 1, None, side - 1)
        wc = np.clip(wf_ + 1, None, side - 1)
        dh, dw = hi - hf_, wi - wf_

        def wt(a):  # float64 host weights, used in float32 as JAX does
            return torch.tensor(a, dtype=torch.float32, device=dev)[..., None]

        def at(r, c):
            return pos2d[torch.from_numpy(r).to(dev)][
                :, torch.from_numpy(c).to(dev)]

        p2 = (at(hf_, wf_) * wt((1 - dh)[:, None] * (1 - dw)[None])
              + at(hf_, wc) * wt((1 - dh)[:, None] * dw[None])
              + at(hc, wf_) * wt(dh[:, None] * (1 - dw)[None])
              + at(hc, wc) * wt(dh[:, None] * dw[None]))
    else:
        p2 = pos2d
    hh, ww = _block_major(gh, gw, m, dev)
    x = x + p2[hh, ww]

    cos, sin = _vision_rot_table(grid_hw, vc.head_dim, m, dev)
    H, hd = vc.n_heads, vc.head_dim
    n = x.shape[0]

    def rope(z):
        return z * cos[:, None, :] + _rot_half(z) * sin[:, None, :]

    deepstack = []
    for i in range(vc.n_layers):
        lp = layer(params["layers"], i)
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], vc.ln_eps)
        qkv = (h @ lp["wqkv"] + lp["bqkv"]).reshape(n, 3, H, hd)
        q, k, v = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        att = _self_attend(q, k, v, hd)
        x = x + (att @ lp["wo"] + lp["bo"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], vc.ln_eps)
        a = gelu(h @ lp["w1"] + lp["b1"], True)
        x = x + (a @ lp["w2"] + lp["b2"])
        if i in vc.deepstack_indexes:
            di = vc.deepstack_indexes.index(i)
            deepstack.append(_qwen3vl_merger(
                params, f"ds{di}", x, vc.d_model, m2, True, vc.ln_eps))
    main = _qwen3vl_merger(params, "merge", x, vc.d_model, m2, False,
                           vc.ln_eps)
    return main, deepstack


# ---------------------------------------------------------------------------
# GLM4-V vision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Glm4vVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    d_model: int = 1536
    n_layers: int = 24
    n_heads: int = 12
    d_out: int = 4096            # out_hidden_size (= LLM width)
    d_proj_ff: int = 13696       # merger gate/up width (intermediate_size)
    temporal_patch_size: int = 2
    merge: int = 2               # spatial_merge_size
    rms_eps: float = 1e-5
    attention_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@full_float32()
def glm4v_vision_forward(params: dict[str, Any], vc: Glm4vVisionConfig,
                         patches: torch.Tensor,
                         grid_hw: tuple[int, int]) -> torch.Tensor:
    """GLM4-V ViT: (N, C*tp*p*p) merge-block-major rows -> (N/merge^2,
    d_out): conv3d patchify (+ bias) -> RMSNorm -> learned positions
    (bicubic off the native grid) -> RMS-normed blocks (fused qkv, no-bias
    o and gated silu MLP, 2-D rope) -> RMSNorm -> the merge^2 downsample
    conv as a linear -> merger (proj, LayerNorm, GELU, gated silu MLP)."""
    gh, gw = grid_hw
    m = vc.merge
    x = patches.to(torch.float32) @ params["patch_w"] + params["patch_b"]
    x = _rms(x, params["post_conv_norm"], vc.rms_eps)
    dev = x.device

    pos = params["pos"]
    side = int(round(pos.shape[0] ** 0.5))
    pos2d = pos.reshape(side, side, vc.d_model)
    if (gh, gw) != (side, side):
        pos2d = _resize_bicubic(pos2d, (gh, gw))
    hh, ww = _block_major(gh, gw, m, dev)
    x = x + pos2d[hh, ww]

    cos, sin = _vision_rot_table(grid_hw, vc.head_dim, m, dev)
    H, hd = vc.n_heads, vc.head_dim
    n = x.shape[0]

    def rope(z):
        return z * cos[:, None, :] + _rot_half(z) * sin[:, None, :]

    for i in range(vc.n_layers):
        lp = layer(params["layers"], i)
        h_in = _rms(x, lp["ln1_w"], vc.rms_eps)
        qkv = h_in @ lp["wqkv"]
        if "bqkv" in lp:
            qkv = qkv + lp["bqkv"]
        qkv = qkv.reshape(n, 3, H, hd)
        q, k, v = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        att = _self_attend(q, k, v, hd)
        x = x + att @ lp["wo"]
        h_in = _rms(x, lp["ln2_w"], vc.rms_eps)
        a = F.silu(h_in @ lp["w_gate"]) * (h_in @ lp["w_up"])
        x = x + a @ lp["w_down"]

    x = _rms(x, params["post_norm"], vc.rms_eps)
    x = x.reshape(n // (m * m), m * m * vc.d_model)
    x = x @ params["down_w"] + params["down_b"]
    x = x @ params["merge_proj"]
    x = _ln(x, params["merge_ln_w"], params["merge_ln_b"], 1e-5)
    x = gelu(x, False)
    a = F.silu(x @ params["merge_gate"]) * (x @ params["merge_up"])
    return a @ params["merge_down"]


# ---------------------------------------------------------------------------
# Kimi-VL (MoonViT)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    image_size: int = 448
    patch_size: int = 14
    d_model: int = 1152
    n_layers: int = 27
    n_heads: int = 16
    d_ff: int = 4304
    ln_eps: float = 1e-6
    rope_theta: float = 10000.0
    merge: int = 2
    d_llm: int = 2048


def _rope2d_split_tables(grid_hw, hd: int, theta: float, device):
    """Split-half 2-D rope: the first half of the head rotates with the x
    (w) positions, the second with y (h), pair-interleaved, both halves on
    the same frequencies.  (cos, sin) (N, hd/2)."""
    h, w = grid_hw
    half = hd // 2
    inv = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float64) / half))
    ww, hh = np.meshgrid(np.arange(w), np.arange(h))
    pw = ww.reshape(-1)[:, None] * inv[None]
    ph = hh.reshape(-1)[:, None] * inv[None]
    ang = np.concatenate([pw, ph], axis=-1)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


@full_float32()
def kimivl_forward(params: dict[str, Any], cfg: KimiVLConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """Kimi-VL MoonViT: (B, H, W, 3) -> (B, P, D): learned positions
    (bicubic off the native grid) + split-half 2-D rope, LN pre-norms,
    biased q/k/v/o and a tanh-GELU MLP."""
    b, hh, ww, _ = images.shape
    grid = (hh // cfg.patch_size, ww // cfg.patch_size)
    x = _patchify(images.to(torch.float32), cfg.patch_size)
    x = x @ params["patch_w"] + params["patch_b"]
    pos = params["pos"]
    side = int(round(pos.shape[0] ** 0.5))
    if grid != (side, side):
        pos = _resize_bicubic(pos.reshape(side, side, cfg.d_model),
                              grid).reshape(-1, cfg.d_model)
    x = x + pos[None]
    cos, sin = _rope2d_split_tables(grid, cfg.d_model // cfg.n_heads,
                                    cfg.rope_theta, x.device)
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    t = x.shape[1]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        q = _rope_pairs((h @ lp["wq"] + lp["bq"]).reshape(b, t, H, hd),
                        cos, sin)
        k = _rope_pairs((h @ lp["wk"] + lp["bk"]).reshape(b, t, H, hd),
                        cos, sin)
        v = (h @ lp["wv"] + lp["bv"]).reshape(b, t, H, hd)
        att = _attend(q, k, v, hd).reshape(b, t, cfg.d_model)
        x = x + (att @ lp["wo"] + lp["bo"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        a = gelu(h @ lp["w1"] + lp["b1"], True)
        x = x + (a @ lp["w2"] + lp["b2"])
    if "post_ln_w" in params:
        x = _ln(x, params["post_ln_w"], params["post_ln_b"], cfg.ln_eps)
    return x


@full_float32()
def kimivl_project(params: dict[str, Any], cfg: KimiVLConfig,
                   feats: torch.Tensor) -> torch.Tensor:
    """Patch-merge permute -> LayerNorm at the original n_embd width ->
    biased GELU MLP into the decoder width."""
    b, p, d = feats.shape
    m = cfg.merge
    x = idefics3_pixel_shuffle(feats, m)
    x = x.reshape(b, -1, d)
    x = _ln(x, params["proj_ln_w"], params["proj_ln_b"], 1e-5)
    x = x.reshape(b, p // m ** 2, d * m ** 2)
    x = gelu(x @ params["proj_w1"] + params["proj_b1"], False)
    return x @ params["proj_w2"] + params["proj_b2"]


# ---------------------------------------------------------------------------
# Idefics3 connector (the tower is vision_ext.siglip_forward)
# ---------------------------------------------------------------------------

def idefics3_pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """HF Idefics3Connector.pixel_shuffle ((B, P, C), square grid)."""
    b, p, c = x.shape
    side = int(round(p ** 0.5))
    x = x.reshape(b, side, side, c)
    x = x.reshape(b, side, side // scale, c * scale)
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, side // scale, side // scale, c * scale * scale)
    x = x.permute(0, 2, 1, 3)
    return x.reshape(b, p // scale ** 2, c * scale ** 2)


@full_float32()
def idefics3_project(params: dict[str, Any], feats: torch.Tensor,
                     scale: int) -> torch.Tensor:
    """Pixel shuffle + one no-bias linear into the decoder width."""
    return idefics3_pixel_shuffle(feats, scale) @ params["mm_proj"]
