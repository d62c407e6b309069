"""Slot KV cache and its sequence ops (port of vlut_tpu/runtime/kv_cache.py,
per-layer "layers" layout only).

The cache is a dict of per-layer tensor lists, so every layer's rows
update in place:

* bf16: ``{"k": [L x (n_slots, max_len, Hkv, hd)], "v": [...]}``;
* q8 (int8 codes with one float32 scale per (slot, row, head)):
  ``"k"``/``"v"`` int8 of that shape plus ``"k_scale"``/``"v_scale"``
  float32 (n_slots, max_len, Hkv).

:func:`seq_cp` and :func:`seq_shift` work in place, where the JAX package
donates the cache and returns a new one.
"""

from __future__ import annotations

import torch

from vlut_tpu_torch.ops.ternary_gemm import RECIP_127


def new_cache(
    n_layers: int, n_slots: int, max_len: int, n_kv_heads: int,
    head_dim: int, dtype=torch.bfloat16, device="cpu", quantized: bool = False,
) -> dict[str, list[torch.Tensor]]:
    shape = (n_slots, max_len, n_kv_heads, head_dim)
    entries = {"k": (shape, dtype), "v": (shape, dtype)}
    if quantized:
        entries = {
            "k": (shape, torch.int8), "v": (shape, torch.int8),
            "k_scale": (shape[:-1], torch.float32),
            "v_scale": (shape[:-1], torch.float32),
        }
    return {
        name: [torch.zeros(sh, dtype=dt, device=device)
               for _ in range(n_layers)]
        for name, (sh, dt) in entries.items()
    }


def is_quantized(cache: dict) -> bool:
    return "k_scale" in cache


def max_len_of(cache: dict) -> int:
    return cache["k"][0].shape[1]


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 codes + per-(...) float32 scale, as the JAX
    package's jitted ``quantize_kv`` computes them: scale = max|x| times the
    float32 reciprocal of 127, codes = round_half_even(x / scale) clipped to
    [-127, 127] (the division is a true one, ``1 / scale`` then a
    multiply)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) * RECIP_127
    inv = torch.where(scale > 0,
                      torch.ones_like(scale) / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def seq_cp(cache: dict, src: int, dst: int, length: int) -> dict:
    """Copy rows [0, length) of slot ``src`` over slot ``dst``, every entry
    and layer, in place."""
    for arrs in cache.values():
        for a in arrs:
            a[dst, :length] = a[src, :length]
    return cache


@torch.no_grad()
def seq_shift(cache: dict, slot: int, start: int, count: int,
              cos: torch.Tensor, sin: torch.Tensor) -> dict:
    """Context shift, in place: drop rows [start-count, start) of ``slot``,
    slide the tail left, and rotate the moved keys by -count positions so
    their RoPE phase matches their new position.  ``cos``/``sin`` are the
    unscaled tables (``rope_table(with_mscale=False)``).  A q8 cache
    dequantizes the moved keys, rotates them and quantizes them again."""
    quant = is_quantized(cache)
    k0 = cache["k"][0]
    dev, max_len = k0.device, k0.shape[1]
    idx = torch.arange(max_len, device=dev)
    moved = idx >= start - count
    src_rows = torch.clamp(torch.where(moved, idx + count, idx), 0,
                           max_len - 1)
    c = cos[count].to(dev)
    s = -sin[count].to(dev)
    for i in range(len(cache["k"])):
        k = cache["k"][i]
        ks = k[slot][src_rows]
        if quant:
            ksc = cache["k_scale"][i][slot][src_rows]
            ksf = dequantize_kv(ks, ksc)
        else:
            ksf = ks
        half = k.shape[-1] // 2
        k1, k2 = ksf[..., :half], ksf[..., half:]
        kr = torch.cat([k1 * c - k2 * s, k2 * c + k1 * s], dim=-1)
        if quant:
            krq, krs = quantize_kv(kr)
            k[slot] = torch.where(moved[:, None, None], krq, ks)
            cache["k_scale"][i][slot] = torch.where(moved[:, None], krs, ksc)
            vsc = cache["v_scale"][i]
            vsc[slot] = vsc[slot][src_rows]
        else:
            k[slot] = torch.where(moved[:, None, None], kr, ksf).to(k.dtype)
        v = cache["v"][i]
        v[slot] = v[slot][src_rows]
    return cache
