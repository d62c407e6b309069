"""Fused decode attention: KV row write + GQA attention in one kernel call
(port of vlut_tpu/ops/decode_attention.py).

:func:`decode_attention` serves the bf16 cache (TPU kernel #7) and
:func:`decode_attention_int8` the int8 cache with per-(row, head) float32
scales (#8).  Both write the step's new K/V row of every slot b into
``cache[b, start[b]]`` in place and return the attention output
(B, 1, H, hd) float32 over the cache rows ``row < start[b]`` (and
``row > start[b] - window`` when ``window > 0``) plus the new token, whose
own term uses the cache-dtype value: the bf16-cast row, or the int8 row
quantized as the JAX package's jitted ``quantize_kv`` does and dequantized.

A CUDA tensor goes to the kernel in ``csrc/decode_attention.cu`` (two
passes: splits of 256 cache rows, then their merge with the new token;
the wrapper allocates the splits' scratch); a CPU
tensor goes to the plain PyTorch version below (:func:`decode_attention_plain`,
:func:`decode_attention_int8_plain`).  Both skip the write of a slot whose
start lies outside [0, S).
"""

from __future__ import annotations

import ctypes

import torch

from vlut_tpu_torch.ops import _build
from vlut_tpu_torch.runtime.kv_cache import dequantize_kv, quantize_kv

_P = ctypes.c_void_p
NEG = -1e30
HEAD_DIMS = (128, 256)
GROUPS = (1, 2, 4, 8)


def supports(h: int, hkv: int, hd: int) -> bool:
    """Whether the kernels take H query heads over Hkv KV heads of width
    hd (a padded head width; the port pads heads to 128 lanes)."""
    return hd in HEAD_DIMS and h % hkv == 0 and h // hkv in GROUPS


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention.cu")
    if not getattr(lib, "_vlut_typed", False):
        i = ctypes.c_int
        lib.vlut_decode_attention.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, i, i, i, i, i, i,
            ctypes.c_float, i, _P, _P, _P]
        lib.vlut_decode_attention.restype = ctypes.c_int
        lib.vlut_decode_attention_scratch.argtypes = [i, i, i, i]
        lib.vlut_decode_attention_scratch.restype = ctypes.c_long
        lib._vlut_typed = True
    return lib


# --- plain versions ----------------------------------------------------------

def _visible(start: torch.Tensor, s: int, window: int) -> torch.Tensor:
    """(B, S) bool: the cache rows a slot's new token attends to."""
    rows = torch.arange(s, device=start.device)[None, :]
    st = start.long()[:, None]
    valid = rows < st
    if window > 0:
        valid &= rows > st - window
    return valid


def _attend_plain(q, kf, vf, kn, vn, start, window, scale):
    """q (B, 1, H, hd); kf/vf (B, S, Hkv, hd) float32 cache values;
    kn/vn (B, Hkv, hd) float32 new-row values -> (B, 1, H, hd) float32."""
    b, s, hkv, hd = kf.shape
    h = q.shape[2]
    g = h // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, hd) * scale
    valid = _visible(start, s, window)[:, None, None, :]
    scores = torch.einsum("bjgd,bsjd->bjgs", qf, kf)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    sn = torch.einsum("bjgd,bjd->bjg", qf, kn)[..., None]
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), sn)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    pn = torch.exp(sn - m)
    l = p.sum(dim=-1, keepdim=True) + pn
    num = torch.einsum("bjgs,bsjd->bjgd", p, vf) + pn * vn[:, :, None, :]
    return (num / l).reshape(b, 1, h, hd)


def _write_row(cache: torch.Tensor, row: torch.Tensor,
               start: torch.Tensor) -> None:
    """cache[b, start[b]] = row[b] for the slots whose start lies in
    [0, S)."""
    st = start.long()
    ok = (st >= 0) & (st < cache.shape[1])
    idx = torch.arange(cache.shape[0], device=cache.device)[ok]
    cache[idx, st[ok]] = row[ok].to(cache.dtype)


def decode_attention_plain(q, k_new, v_new, kc, vc, start, window=0, *,
                           scale: float):
    kn, vn = k_new[:, 0].to(kc.dtype), v_new[:, 0].to(vc.dtype)
    att = _attend_plain(q, kc.to(torch.float32), vc.to(torch.float32),
                        kn.to(torch.float32), vn.to(torch.float32), start,
                        int(window), scale)
    _write_row(kc, kn, start)
    _write_row(vc, vn, start)
    return att


def decode_attention_int8_plain(q, k_new, v_new, kc, vc, ksc, vsc, start,
                                window=0, *, scale: float):
    kq, ks = quantize_kv(k_new[:, 0])
    vq, vs = quantize_kv(v_new[:, 0])
    att = _attend_plain(q, dequantize_kv(kc, ksc), dequantize_kv(vc, vsc),
                        dequantize_kv(kq, ks), dequantize_kv(vq, vs), start,
                        int(window), scale)
    for c, u in ((kc, kq), (vc, vq), (ksc, ks), (vsc, vs)):
        _write_row(c, u, start)
    return att


# --- kernel wrappers ---------------------------------------------------------

def _launch(q, k_new, v_new, kc, vc, ksc, vsc, start, window, scale):
    b, s, hkv, hd = kc.shape
    h = q.shape[2]
    quant = ksc is not None
    if not supports(h, hkv, hd):
        raise ValueError(f"decode attention kernel takes hd in {HEAD_DIMS} "
                         f"and H/Hkv in {GROUPS}; got hd {hd}, H {h}, "
                         f"Hkv {hkv}")
    want = torch.int8 if quant else torch.bfloat16
    for c in (kc, vc):
        if c.dtype != want or not c.is_contiguous() or c.shape != kc.shape:
            raise ValueError(f"caches must be contiguous {want} "
                             f"{tuple(kc.shape)}")
    if quant:
        for c in (ksc, vsc):
            if (c.dtype != torch.float32 or not c.is_contiguous()
                    or c.shape != kc.shape[:3]):
                raise ValueError("scales must be contiguous float32 "
                                 f"{tuple(kc.shape[:3])}")
    if q.shape != (b, 1, h, hd) or k_new.shape != (b, 1, hkv, hd) \
            or v_new.shape != (b, 1, hkv, hd) or start.shape != (b,):
        raise ValueError("q (B,1,H,hd), k/v_new (B,1,Hkv,hd), start (B,)")
    dev = kc.device
    tensors = [q, k_new, v_new, start, vc] + ([ksc, vsc] if quant else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must lie on the cache's device")
    qf = q.to(torch.float32).contiguous()
    new_dtype = torch.float32 if quant else torch.bfloat16
    kn = k_new.to(new_dtype).contiguous()
    vn = v_new.to(new_dtype).contiguous()
    st = start.to(torch.int32).contiguous()
    out = torch.empty((b, 1, h, hd), dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = torch.empty(lib.vlut_decode_attention_scratch(b, s, h, hd),
                          dtype=torch.float32, device=dev)
    err = lib.vlut_decode_attention(
        qf.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), ksc.data_ptr() if quant else None,
        vsc.data_ptr() if quant else None, st.data_ptr(), b, s, h, hkv, hd,
        int(window), float(scale), int(quant), scratch.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vlut_decode_attention")
    return out


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     start: torch.Tensor, window: int = 0, *,
                     scale: float) -> torch.Tensor:
    """bf16 cache (#7): q (B, 1, H, hd), k/v_new (B, 1, Hkv, hd) (cast to
    bf16), kc/vc (B, S, Hkv, hd) bf16 updated in place, start (B,) ->
    att (B, 1, H, hd) float32."""
    if not kc.is_cuda:
        return decode_attention_plain(q, k_new, v_new, kc, vc, start, window,
                                      scale=scale)
    out = _launch(q, k_new, v_new, kc, vc, None, None, start, window, scale)
    decode_attention.launches += 1
    return out


def decode_attention_int8(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, ksc: torch.Tensor,
                          vsc: torch.Tensor, start: torch.Tensor,
                          window: int = 0, *, scale: float) -> torch.Tensor:
    """int8 cache (#8): as :func:`decode_attention` over int8 codes kc/vc
    and float32 scales ksc/vsc (B, S, Hkv); the new rows are quantized in
    the kernel and codes and scales are written in place."""
    if not kc.is_cuda:
        return decode_attention_int8_plain(q, k_new, v_new, kc, vc, ksc, vsc,
                                           start, window, scale=scale)
    out = _launch(q, k_new, v_new, kc, vc, ksc, vsc, start, window, scale)
    decode_attention_int8.launches += 1
    return out


decode_attention.launches = 0
decode_attention_int8.launches = 0
