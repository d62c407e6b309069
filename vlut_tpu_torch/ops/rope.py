"""Rotary position embeddings (NEOX split-half), port of vlut_tpu/ops/rope.py.

Frequency scaling modes: none, linear, llama3, yarn, longrope.  M-RoPE is
not in this port yet.
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
    if kind == "default":
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
