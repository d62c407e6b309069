"""Slot KV cache and its sequence ops (port of vlut_tpu/runtime/kv_cache.py).

Two layouts of the same content, as in the JAX package.  The "layers"
layout (the default) is a dict of per-layer tensor lists:

* bf16: ``{"k": [L x (n_slots, max_len, Hkv, hd)], "v": [...]}``, Hkv
  the layer's own KV heads (they differ between the layers of a
  heterogeneous stack);
* q8 (int8 codes with one float32 scale per (slot, row, head)):
  ``"k"``/``"v"`` int8 of that shape plus ``"k_scale"``/``"v_scale"``
  float32 (n_slots, max_len, Hkv).

The "stacked" layout holds one (L, n_slots, max_len, Hkv, hd) tensor per
entry (every layer the same heads); ``cache[name][i]`` is then a view of
layer i, so the forward, the sequence ops and the slot files update it in
place exactly as they update a list, and no step restacks it.
:func:`to_layered` gives the list of those views, :func:`to_stacked`
copies a list into one tensor (a layout boundary, never per step).

:func:`seq_cp` and :func:`seq_shift` work in place, where the JAX package
donates the cache and returns a new one.
"""

from __future__ import annotations

import torch

from vlut_tpu_torch.ops.ternary_gemm import RECIP_127


def new_cache(
    n_slots: int, max_len: int, kv_heads: tuple[int, ...], head_dim: int,
    dtype=torch.bfloat16, device="cpu", quantized: bool = False,
    layout: str = "layers",
) -> dict:
    """Zeroed caches, one per layer, layer i holding ``kv_heads[i]`` KV heads
    (a heterogeneous stack's layers differ; one without attention has 0);
    ``layout`` "stacked" gives one (L, ...) tensor per entry."""
    if layout not in ("layers", "stacked"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if layout == "stacked":
        if len(set(kv_heads)) != 1:
            raise ValueError("a stacked cache needs the same KV heads on "
                             "every layer")
        return to_stacked(new_cache(n_slots, max_len, kv_heads[:1],
                                    head_dim, dtype, device, quantized),
                          len(kv_heads))

    def entries(h):
        shape = (n_slots, max_len, h, head_dim)
        if quantized:
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_scale": (shape[:-1], torch.float32),
                    "v_scale": (shape[:-1], torch.float32)}
        return {"k": (shape, dtype), "v": (shape, dtype)}

    per = [entries(h) for h in kv_heads]
    return {name: [torch.zeros(e[name][0], dtype=e[name][1], device=device)
                   for e in per]
            for name in per[0]}


def is_quantized(cache: dict) -> bool:
    return "k_scale" in cache


def is_layered(cache: dict) -> bool:
    return isinstance(cache["k"], (list, tuple))


def to_layered(cache: dict) -> dict:
    """Stacked -> per-layer lists of views (the same storage; a no-op on a
    layered cache)."""
    if is_layered(cache):
        return dict(cache)
    return {name: list(a.unbind(0)) for name, a in cache.items()}


def to_stacked(cache: dict, n_layers: int | None = None) -> dict:
    """Per-layer lists -> one (L, ...) tensor per entry (a copy; a no-op on
    a stacked cache).  ``n_layers`` repeats a one-layer list's zeroed
    shape L times (:func:`new_cache`)."""
    if not is_layered(cache):
        return dict(cache)
    if n_layers is not None:
        return {name: a[0].new_zeros((n_layers,) + tuple(a[0].shape))
                for name, a in cache.items()}
    return {name: torch.stack(list(a)) for name, a in cache.items()}


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
              tables: list) -> dict:
    """Context shift, in place: drop rows [start-count, start) of ``slot``,
    slide the tail left, and rotate the moved keys by -count positions so
    their rope phase matches their new position.

    ``tables`` holds each layer's unscaled rope tables (``rope_table(
    with_mscale=False)``) as a (cos, sin) pair, or None for a layer whose
    keys carry no rope (a NoPE layer, learned / ALiBi / no positions): its
    keys move unrotated.  A table of width w/2 rotates the first w dims of
    the head (the whole padded head, or a partial-rope prefix); the other
    dims move as they are.  A (cos, sin, lo) triple rotates dims [lo, lo +
    w) instead: an MLA latent row's k_pe, whose latent stays as it is.
    (The JAX package rotates every layer's whole head with the global
    tables, which is right only for full rope on rope layers.)  A q8 cache
    dequantizes the moved keys, rotates them and quantizes them again (an
    MLA row: one scale over the whole row, as it was written)."""
    quant = is_quantized(cache)
    k0 = cache["k"][0]
    dev, max_len = k0.device, k0.shape[1]
    idx = torch.arange(max_len, device=dev)
    moved = idx >= start - count
    src_rows = torch.clamp(torch.where(moved, idx + count, idx), 0,
                           max_len - 1)
    for i in range(len(cache["k"])):
        k = cache["k"][i]
        ks = k[slot][src_rows]
        if tables[i] is None:
            k[slot] = ks
            if quant:
                ksc = cache["k_scale"][i]
                ksc[slot] = ksc[slot][src_rows]
        else:
            cos, sin, *lo = tables[i]
            lo = lo[0] if lo else 0
            c = cos[count].to(dev)
            s = -sin[count].to(dev)
            if quant:
                ksc = cache["k_scale"][i][slot][src_rows]
                ksf = dequantize_kv(ks, ksc)
            else:
                ksf = ks
            half = c.shape[-1]
            k1, k2 = ksf[..., lo:lo + half], ksf[..., lo + half:lo + 2 * half]
            kr = torch.cat([ksf[..., :lo], k1 * c - k2 * s, k2 * c + k1 * s,
                            ksf[..., lo + 2 * half:]], dim=-1)
            if quant:
                krq, krs = quantize_kv(kr)
                k[slot] = torch.where(moved[:, None, None], krq, ks)
                cache["k_scale"][i][slot] = torch.where(moved[:, None], krs,
                                                        ksc)
            else:
                k[slot] = torch.where(moved[:, None, None], kr, ksf).to(
                    k.dtype)
        if quant:
            vsc = cache["v_scale"][i]
            vsc[slot] = vsc[slot][src_rows]
        v = cache["v"][i]
        v[slot] = v[slot][src_rows]
    return cache
