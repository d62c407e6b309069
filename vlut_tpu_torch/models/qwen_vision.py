"""Qwen2-VL / Qwen2.5-VL vision tower and the M-RoPE positions of an image
(port of ``vlut_tpu/models/qwen_vision.py``).

pixels -> 3D-conv patchify (temporal_patch x patch x patch, no bias) ->
ViT blocks (pre-LN or RMS, fused qkv + bias, 2-D rotary split half h /
half w, bidirectional attention over the image's patches, gelu or gated
silu MLP; qwen2.5-vl's window attention except on ``fullatt_blocks``) ->
PatchMerger (norm, then an MLP over ``spatial_merge_size``^2 grouped
patches) -> language-model-width embeddings.

:func:`mrope_positions` makes the (3, T) temporal / height / width rows
that ``forward(mrope_pos=)`` takes for [text, image, text].
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.vision_ext import _ln, _rms, _rot_half, gelu, layer


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    depth: int
    embed_dim: int
    n_heads: int
    mlp_dim: int
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    out_dim: int = 3584          # language-model width
    ln_eps: float = 1e-6
    # qwen2.5-vl: RMS norms, gated MLP with biases, window attention
    rms_norm: bool = False
    gated_mlp: bool = False
    window_size: int = 0         # window attention size in pixels (112)
    fullatt_blocks: tuple[int, ...] = ()  # blocks with full attention

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads


def _vision_rot_table(grid_hw: tuple[int, int], hd: int, merge: int,
                      device="cpu"):
    """Per-patch (cos, sin) of width hd: the frequency pairs split h / w,
    patches in merge-block-major order (Qwen2VL rot_pos_emb)."""
    h, w = grid_hw
    dim = hd // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    hpos = np.arange(h).reshape(h // merge, merge, 1, 1)
    hpos = np.broadcast_to(hpos, (h // merge, merge, w // merge, merge))
    hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
    wpos = np.arange(w).reshape(1, 1, w // merge, merge)
    wpos = np.broadcast_to(wpos, (h // merge, merge, w // merge, merge))
    wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
    fh = hpos[:, None] * inv[None, :]
    fw = wpos[:, None] * inv[None, :]
    freqs = np.concatenate([fh, fw], -1)
    emb = np.concatenate([freqs, freqs], -1)
    return (torch.from_numpy(np.cos(emb)).to(device, torch.float32),
            torch.from_numpy(np.sin(emb)).to(device, torch.float32))


def _window_order(grid_hw: tuple[int, int], vc: QwenVisionConfig):
    """Qwen2.5-VL's window reorder (HF get_window_index): the permutation of
    spatial-merge units into window-major order and the units of each
    window (ragged at the right and bottom edges).  Host numpy."""
    m = vc.spatial_merge_size
    gh, gw = grid_hw[0] // m, grid_hw[1] // m
    vw = vc.window_size // m // vc.patch_size
    idx = np.arange(gh * gw).reshape(gh, gw)
    pad_h, pad_w = (-gh) % vw, (-gw) % vw
    idxp = np.pad(idx, ((0, pad_h), (0, pad_w)), constant_values=-100)
    nh, nw = (gh + pad_h) // vw, (gw + pad_w) // vw
    idxp = idxp.reshape(nh, vw, nw, vw).transpose(0, 2, 1, 3)
    idxp = idxp.reshape(nh * nw, vw * vw)
    seqlens = (idxp != -100).sum(-1)
    order = idxp.reshape(-1)
    order = order[order != -100]
    return order, seqlens


def window_layout(grid_hw, vc: QwenVisionConfig, m2: int, device):
    """(patch permutation, additive block mask, inverse unit order) of the
    window attention."""
    order, seqlens = _window_order(grid_hw, vc)
    perm = (order[:, None] * m2 + np.arange(m2)[None]).reshape(-1)
    wid = np.repeat(np.arange(len(seqlens)), seqlens * m2)
    mask = torch.tensor(np.where(wid[:, None] == wid[None, :], 0.0, -1e30),
                        dtype=torch.float32, device=device)
    return torch.from_numpy(perm).to(device), mask, np.argsort(order)


def _self_attend(q, k, v, hd, mask=None):
    """(N, H, hd) rows -> (N, H*hd): float32 scores scaled by hd^-0.5
    [+ mask], softmax, weighted sum."""
    sc = torch.einsum("thd,shd->hts", q, k) * (hd ** -0.5)
    if mask is not None:
        sc = sc + mask[None]
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("hts,shd->thd", p, v).reshape(q.shape[0], -1)


@full_float32()
def vision_forward(params: dict[str, Any], vc: QwenVisionConfig,
                   patches: torch.Tensor,
                   grid_hw: tuple[int, int]) -> torch.Tensor:
    """One image's patch rows -> (N / merge^2, out_dim) embeddings."""
    x = patches.to(torch.float32) @ params["patch_w"]
    dev = x.device
    cos, sin = _vision_rot_table(grid_hw, vc.head_dim,
                                 vc.spatial_merge_size, dev)
    H, hd = vc.n_heads, vc.head_dim
    n = x.shape[0]
    m2 = vc.spatial_merge_size ** 2

    win_mask = inv_units = None
    if vc.window_size:
        perm, win_mask, inv_units = window_layout(grid_hw, vc, m2, dev)
        x = x[perm]
        cos, sin = cos[perm], sin[perm]

    def rope(z):  # (N, H, hd)
        return z * cos[:, None, :] + _rot_half(z) * sin[:, None, :]

    for i in range(vc.depth):
        lp = layer(params["layers"], i)
        if vc.rms_norm:
            h_in = _rms(x, lp["ln1_w"], vc.ln_eps)
        else:
            h_in = _ln(x, lp["ln1_w"], lp["ln1_b"], vc.ln_eps)
        qkv = (h_in @ lp["wqkv"] + lp["bqkv"]).reshape(n, 3, H, hd)
        q, k, v = rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2]
        full = win_mask is None or i in vc.fullatt_blocks
        att = _self_attend(q, k, v, hd, None if full else win_mask)
        x = x + (att @ lp["wo"] + lp["bo"])
        if vc.rms_norm:
            h_in = _rms(x, lp["ln2_w"], vc.ln_eps)
        else:
            h_in = _ln(x, lp["ln2_w"], lp["ln2_b"], vc.ln_eps)
        if vc.gated_mlp:
            a = torch.nn.functional.silu(h_in @ lp["w_gate"] + lp["b_gate"]) \
                * (h_in @ lp["w1"] + lp["b1"])
        else:
            a = gelu(h_in @ lp["w1"] + lp["b1"], False)
        x = x + (a @ lp["w2"] + lp["b2"])

    if vc.rms_norm:
        x = _rms(x, params["merge_ln_w"], vc.ln_eps)
    else:
        x = _ln(x, params["merge_ln_w"], params["merge_ln_b"], vc.ln_eps)
    x = x.reshape(n // m2, m2 * vc.embed_dim)
    x = gelu(x @ params["merge_w1"] + params["merge_b1"], False)
    out = x @ params["merge_w2"] + params["merge_b2"]
    if inv_units is not None:
        out = out[torch.from_numpy(inv_units).to(dev)]
    return out


def patchify(pixels: np.ndarray, vc: QwenVisionConfig
             ) -> tuple[np.ndarray, tuple[int, int]]:
    """(C, H, W) image -> (N, C*tp*p*p) patch rows in the merge-block-major
    order HF's image processor emits, and (grid_h, grid_w).  Host numpy."""
    c, hh, ww = pixels.shape
    p, tp, m = vc.patch_size, vc.temporal_patch_size, vc.spatial_merge_size
    gh, gw = hh // p, ww // p
    px = np.broadcast_to(pixels[None], (tp, c, hh, ww))
    px = px.reshape(tp, c, gh, p, gw, p)
    px = px.transpose(2, 4, 1, 0, 3, 5)
    px = px.reshape(gh // m, m, gw // m, m, c, tp, p, p)
    px = px.transpose(0, 2, 1, 3, 4, 5, 6, 7)
    return px.reshape(gh * gw, c * tp * p * p), (gh, gw)


def mrope_positions(n_text_before: int, grid_hw: tuple[int, int], merge: int,
                    n_text_after: int) -> np.ndarray:
    """(3, T) M-RoPE positions of [text, image, text] (HF get_rope_index):
    text rows advance together; the image's merged patches take (t const,
    h, w) grid positions from the text offset; trailing text resumes at
    max(image positions) + 1."""
    gh, gw = grid_hw[0] // merge, grid_hw[1] // merge
    rows = [np.tile(np.arange(n_text_before), (3, 1))]
    st = n_text_before
    tpos = np.full((gh * gw,), st)
    hpos = st + np.repeat(np.arange(gh), gw)
    wpos = st + np.tile(np.arange(gw), gh)
    rows.append(np.stack([tpos, hpos, wpos]))
    nxt = st + max(gh, gw)
    rows.append(np.tile(nxt + np.arange(n_text_after), (3, 1)))
    return np.concatenate(rows, axis=1)
