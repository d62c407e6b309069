"""Rotary position embeddings (NEOX split-half), port of vlut_tpu/ops/rope.py
and of the rope knobs of vlut_tpu/models/transformer.py.

Frequency scaling modes: none, linear, llama3, yarn, longrope, and the
unscaled frequencies of M-RoPE (``"mrope"``, whose ``mrope_section`` the
positions side consumes: :func:`mrope_row_map`, :func:`apply_mrope`).
Partial rotary (the first ``rot`` dims) and the original-GPT interleaved
pairing (an even|odd permutation of the rotated dims before the
split-half rotation) are :func:`rope_prefix`'s.
"""

from __future__ import annotations

import math
from typing import Any

import torch


def _inv_freq(head_dim: int, theta: float,
              scaling: dict[str, Any] | None) -> tuple[torch.Tensor, float]:
    inv = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    )
    if not scaling:
        return inv, 1.0
    kind = scaling.get("rope_type", scaling.get("type"))
    if kind in ("default", "mrope"):
        # M-RoPE (qwen2-vl): unscaled frequencies; its sections select the
        # position row per frequency (apply_mrope)
        return inv, 1.0
    if kind == "llama3":
        factor = scaling.get("factor", 8.0)
        lo = scaling.get("low_freq_factor", 1.0)
        hi = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv
        smooth = (orig / wavelen - lo) / (hi - lo)
        inv = torch.where(
            wavelen > orig / lo,
            inv / factor,
            torch.where(wavelen < orig / hi, inv,
                        (1 - smooth) * inv / factor + smooth * inv),
        )
        return inv, 1.0
    if kind == "linear":
        return inv / scaling.get("factor", 1.0), 1.0
    if kind == "yarn":
        factor = scaling.get("factor", 1.0)
        orig = scaling.get("original_max_position_embeddings", 4096)
        beta_fast = scaling.get("beta_fast", 32.0)
        beta_slow = scaling.get("beta_slow", 1.0)

        def dim_for_rotations(n_rot):
            return (head_dim * math.log(orig / (n_rot * 2 * math.pi))
                    / (2 * math.log(theta)))

        low = max(math.floor(dim_for_rotations(beta_fast)), 0)
        high = min(math.ceil(dim_for_rotations(beta_slow)), head_dim - 1)
        dims = torch.arange(0, head_dim, 2, dtype=torch.float32) / 2
        ramp = torch.clamp((dims - low) / max(high - low, 1e-3), 0.0, 1.0)
        extrap = 1.0 - ramp
        inv = inv * extrap + (inv / factor) * (1.0 - extrap)
        attn_factor = scaling.get("attention_factor")
        if attn_factor is None:
            attn_factor = 0.1 * math.log(factor) + 1.0 if factor > 1.0 else 1.0
        return inv, float(attn_factor)
    if kind == "longrope":
        factors = scaling.get("long_factor") or scaling.get("factor")
        inv = inv / torch.as_tensor(factors, dtype=torch.float32)
        orig = scaling.get("original_max_position_embeddings", 4096)
        s = scaling.get("max_position_embeddings", orig) / orig
        mscale = math.sqrt(1.0 + math.log(s) / math.log(orig)) if s > 1.0 else 1.0
        return inv, float(mscale)
    raise NotImplementedError(f"rope scaling type {kind!r} is not ported")


def rope_table(
    max_len: int,
    head_dim: int,
    theta: float = 10000.0,
    scaling: dict[str, Any] | None = None,
    pad_to: int | None = None,
    with_mscale: bool = True,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_len, head_dim // 2) float32.

    ``pad_to`` pads the frequency axis to pad_to // 2 with identity rotations
    (cos 1, sin 0) for the padded-head layout (models/dims.py).
    """
    inv, mscale = _inv_freq(head_dim, theta, scaling)
    if not with_mscale:
        mscale = 1.0
    pos = torch.arange(max_len, dtype=torch.float32)
    ang = pos[:, None] * inv[None, :]
    cos, sin = torch.cos(ang) * mscale, torch.sin(ang) * mscale
    if pad_to is not None and pad_to > head_dim:
        extra = (pad_to - head_dim) // 2
        cos = torch.nn.functional.pad(cos, (0, extra), value=1.0)
        sin = torch.nn.functional.pad(sin, (0, extra), value=0.0)
    return cos.to(device), sin.to(device)


def mrope_row_map(sections, n_freqs: int, interleaved: bool) -> torch.Tensor:
    """(n_freqs,) int64: the position row (0 T, 1 H, 2 W) of each frequency.

    Chunked (qwen2-vl ``mrope_section``): [T] * s0 + [H] * s1 + [W] * s2,
    cycled.  Interleaved (qwen3-vl): T everywhere, except frequency f takes
    H when f % 3 == 1 and f < 3 * s1, W when f % 3 == 2 and f < 3 * s2.
    Frequencies past the mapped range (the lane padding) take row 0; their
    table entries are identity rotations."""
    rows = torch.zeros(n_freqs, dtype=torch.int64)
    if interleaved:
        for dim in (1, 2):
            rows[dim:min(sections[dim] * 3, n_freqs):3] = dim
    else:
        lo = 0
        for i, n in enumerate(sections):
            rows[lo:lo + n] = i % 3
            lo += n
    return rows


def apply_mrope(x: torch.Tensor, mrope_pos: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, row_map: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); mrope_pos (B, 3, T) int (temporal, height, width
    rows); tables (max_len, hd/2); row_map from :func:`mrope_row_map` on
    the tables' device: each frequency rotates by the angle of its own
    position row."""
    # (B, 3, T, half) gathered per row, then each frequency's own row
    idx = row_map[None, None, None, :].expand(
        mrope_pos.shape[0], 1, mrope_pos.shape[2], -1)
    c = cos[mrope_pos].to(torch.float32).gather(1, idx)[:, 0]
    s = sin[mrope_pos].to(torch.float32).gather(1, idx)[:, 0]
    return apply_rope_rows(x, c[..., None, :], s[..., None, :])


def apply_rope_rows(x: torch.Tensor, c: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, hd); c/s (..., T, 1, hd/2) gathered at the positions."""
    half = x.shape[-1] // 2
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, hd); positions (..., T) int; tables (max_len, hd/2)."""
    return apply_rope_rows(x, cos[positions][..., None, :],
                           sin[positions][..., None, :])


def rope_prefix(z: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, rot: int, interleaved: bool = False,
                on: bool = True) -> torch.Tensor:
    """Rope on the first ``rot`` dims of z (..., T, H, hd_p); the rest pass
    through.  ``rot`` equal to the head width rotates the whole (padded)
    head with tables padded to it.  ``interleaved`` permutes even|odd
    channels inside the rotated prefix first (the inverse permutation
    cancels in the q.k dot, so it is dropped); with ``on`` False (a NoPE
    layer) the permuted z comes back unrotated, as the JAX package's
    per-layer select returns it."""
    full = rot >= z.shape[-1]
    if interleaved:
        zp = z if full else z[..., :rot]
        parts = [zp[..., 0::2], zp[..., 1::2]]
        z = torch.cat(parts if full else parts + [z[..., rot:]], dim=-1)
    if not on:
        return z
    if full:
        return apply_rope(z, positions, cos, sin)
    return torch.cat([apply_rope(z[..., :rot], positions, cos, sin),
                      z[..., rot:]], dim=-1)
