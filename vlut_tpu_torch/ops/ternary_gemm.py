"""Ternary GEMM kernels: CUDA wrappers and their plain PyTorch versions.

Counterpart of ``vlut_tpu/ops/pallas_gemm.py``.  Three wrappers, one per
TPU kernel on the serving path:

* :func:`ternary_gemm_decode`     <- ``ternary_gemm_decode`` (M <= 64,
  fused RMSNorm / silu*up [+ sub-norm] prologue, residual epilogue)
* :func:`ternary_gemm_fused_quant` <- ``ternary_gemm_fused_quant`` (M <= 64,
  int8 quantization in the kernel)
* :func:`ternary_gemm_tiled`      <- ``ternary_gemm_pallas`` (pre-quantized
  int8 activations, any M)

A tensor on the CPU goes to the plain version beside each wrapper; a CUDA
tensor goes to the kernel in ``csrc/ternary_gemm.cu`` (built and loaded by
``ops/_build.py``), or the wrapper raises.  Each wrapper counts its kernel
launches in its ``launches`` attribute.  Shapes: x has the logical K
columns (no padding needed); outputs are (M, Np) with the packed, padded N.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vlut_tpu_torch.ops import _build
from vlut_tpu_torch.ops.packing import TRITS_PER_BYTE, DEFAULT_BLOCK, unpack_fields
from vlut_tpu_torch.ops.quant import true_div

MAX_DECODE_M = 64
_MODES = {"plain": 0, "norm": 1, "silu_mul": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("ternary_gemm.cu")
    if not getattr(lib, "_vlut_typed", False):
        lib.vlut_quant_prologue.argtypes = [
            _P, _P, _L, _I, _I, _I, _P, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P]
        lib.vlut_decode_gemm.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P]
        lib.vlut_tiled_gemm.argtypes = [
            _P, _L, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
            _I, _P]
        for f in (lib.vlut_quant_prologue, lib.vlut_decode_gemm,
                  lib.vlut_tiled_gemm, lib.vlut_tiled_init):
            f.restype = ctypes.c_int
        _build.check(lib.vlut_tiled_init(), "vlut_tiled_init")
        lib._vlut_typed = True
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ small-int (K, N) -> int32.  CUDA has no integer
    matmul for these shapes; a float64 product of the integers is exact
    while |acc| < 2**53 (here |acc| <= 127 * K)."""
    if a.is_cuda:
        return (a.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    return a.to(torch.int32) @ w.to(torch.int32)


def _check_common(packed: torch.Tensor, w_scale: torch.Tensor, fmt: str,
                  kb: int, k: int) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be 2-D uint8, got {packed.dtype}")
    if kb != DEFAULT_BLOCK[fmt]:
        raise ValueError(f"kb={kb}: the kernels take the default block only")
    kp = packed.shape[0] * TRITS_PER_BYTE[fmt]
    if not k <= kp or kp % kb:
        raise ValueError(f"k={k} does not fit packed K {kp}")
    if packed.shape[1] % 128:
        raise ValueError("packed N must be a multiple of 128")
    if w_scale.shape != (packed.shape[1],) or w_scale.dtype != torch.float32:
        raise ValueError("w_scale must be float32 of shape (Np,)")


def _check_cuda(*ts: torch.Tensor | None) -> None:
    for t in ts:
        if t is not None and (not t.is_cuda or not t.is_contiguous()):
            raise ValueError("kernel operands must be contiguous CUDA tensors")


def _check_packed_cuda(packed: torch.Tensor, w_scale: torch.Tensor) -> None:
    _check_cuda(packed, w_scale)
    if packed.data_ptr() % 16:
        raise ValueError("packed weights must be 16-byte aligned on the card")


def _epilogue_plain(acc, x_scale, w_scale, residual, out_dtype):
    """(acc * xs) * ws [+ residual]; see the kernel's ``epilogue``."""
    p = acc.to(torch.float32) * x_scale
    if residual is None:
        return (p * w_scale[None, :]).to(out_dtype)
    res = _pad_cols(residual.to(out_dtype), p.shape[1])
    if out_dtype == torch.float32:
        # the reference's fused multiply-add, one rounding: the float64
        # product is exact, and its sum rounds twice only in the rare case
        # that lands on a float32 midpoint
        return (p.double() * w_scale.double()[None, :] + res.double()).float()
    return res + (p * w_scale[None, :]).to(out_dtype)


def _pad_cols(a: torch.Tensor, n: int) -> torch.Tensor:
    if a.shape[-1] == n:
        return a
    return torch.nn.functional.pad(a, (0, n - a.shape[-1]))


def _gemm_plain(x_q, x_scale, packed, w_scale, fmt, kb, k, residual,
                out_dtype):
    w = unpack_fields(packed, fmt, kb)[:k].to(torch.int8) - 1
    return _epilogue_plain(_int_matmul(x_q, w), x_scale, w_scale, residual,
                           out_dtype)


# --- the decode prologue ------------------------------------------------------

# The Pallas kernels' compiled ``amax / 127.0`` multiplies by the float32
# reciprocal of 127 (checked against them in interpret mode), while the
# unfused quantize_activations divides; the kernels here follow the kernels.
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def kernel_quantize(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization as the decode and fused-quant kernels do
    it: codes as :func:`quantize_activations`, scale ``amax * (1/127)``."""
    xf = xf.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    inv = torch.where(amax > 0, true_div(127.0, amax), torch.zeros_like(amax))
    q = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return q, amax * RECIP_127


def decode_input(x1, x2=None, norm_g=None, mode="plain", sub_norm=False,
                 norm_n=0, eps=1e-5) -> torch.Tensor:
    """The decode prologue's float32 GEMM input h
    (vlut_tpu/ops/pallas_gemm.py:405-422):

    h = rms(x1)*g (norm) | silu(x1)*x2 [bf16, rms*g] (silu_mul) | x1, then a
    bf16 round except in plain mode (the attention output arrives float32).
    """
    xf = x1.to(torch.float32)
    if mode == "silu_mul":
        xf = xf * torch.sigmoid(xf) * x2.to(torch.float32)
        if sub_norm:
            xf = _bf16_round(xf)
    if mode == "norm" or sub_norm:
        ss = (xf * xf).sum(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(true_div(ss, float(norm_n or xf.shape[-1])) + eps)
        xf = xf * norm_g.to(torch.float32)
    if mode != "plain":
        xf = _bf16_round(xf)
    return xf


def decode_prologue(*args, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's prologue: (int8 codes, per-row scales)."""
    return kernel_quantize(decode_input(*args, **kw))


def _m_tiles(m: int) -> int:
    return -(-m // 16)


def _launch_prologue(x1, x2, norm_g, mode, sub_norm, norm_n, eps, fmt, kb,
                     kp):
    """The prologue kernel: (A fragments as uint8 bytes, (M,) scales)."""
    m, k = x1.shape
    in_bf16 = x1.dtype == torch.bfloat16
    if x1.dtype not in (torch.bfloat16, torch.float32) or x1.stride(1) != 1:
        raise ValueError("x must be bf16/f32 with unit column stride")
    if x2 is not None and (x2.dtype != x1.dtype or x2.stride() != x1.stride()
                           or x2.device != x1.device):
        raise ValueError("x2 must match x1's dtype, strides and device")
    if norm_g is not None:
        norm_g = norm_g.to(torch.float32).contiguous()
        _check_cuda(norm_g)
    mtl = _m_tiles(m)
    dev = x1.device
    afrag = torch.empty((mtl * 16 * kp,), dtype=torch.uint8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    err = _lib().vlut_quant_prologue(
        x1.data_ptr(), x2.data_ptr() if x2 is not None else None,
        x1.stride(0), int(in_bf16), k, kp,
        norm_g.data_ptr() if norm_g is not None else None, _MODES[mode],
        int(sub_norm), float(norm_n or k), float(eps), kb, m, mtl,
        afrag.data_ptr(), xs.data_ptr(), _stream())
    _build.check(err, "vlut_quant_prologue")
    return afrag, xs


def afrag_offsets(m: int, kp: int, kb: int, device=None) -> torch.Tensor:
    """(M, Kp) byte offsets of each int8 code in the prologue's A-fragment
    layout (the kernel's ``afrag_byte``)."""
    mtl, nc = _m_tiles(m), kb // 32
    kk = torch.arange(kp, device=device)
    b, w = kk // kb, kk % kb
    q, j = w // 32, w % 32
    c = torch.where(q < 4, j >> 3, 4)
    byte = torch.where(q < 4, q, j >> 3)
    t, half = j & 3, (j >> 2) & 1
    rows = torch.arange(m, device=device)[:, None]
    reg = ((rows >> 3) & 1) + 2 * half
    frag = (b * nc + c) * mtl + (rows >> 4)
    return ((frag * 32 + (rows & 7) * 4 + t) * 4 + reg) * 4 + byte


def prologue_codes(x1, x2, norm_g, mode, sub_norm, norm_n, eps, fmt, kb,
                   kp) -> tuple[torch.Tensor, torch.Tensor]:
    """The prologue kernel's int8 codes in natural (M, Kp) order and its
    (M,) scales, to hold them against :func:`decode_prologue` (not counted
    as a launch of the decode kernel)."""
    afrag, xs = _launch_prologue(x1, x2, norm_g, mode, sub_norm, norm_n,
                                 eps, fmt, kb, kp)
    offs = afrag_offsets(x1.shape[0], kp, kb, device=afrag.device)
    return afrag[offs].view(torch.int8), xs


def _launch_decode_gemm(afrag, xs, packed, w_scale, fmt, kb, m, residual,
                        out_dtype):
    np_ = packed.shape[1]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported out dtype {out_dtype}")
    out = torch.empty((m, np_), dtype=out_dtype, device=packed.device)
    if residual is not None:
        residual = residual.to(out_dtype).contiguous()
        _check_cuda(residual)
    nb = packed.shape[0] * TRITS_PER_BYTE[fmt] // kb
    err = _lib().vlut_decode_gemm(
        afrag.data_ptr(), xs.data_ptr(), packed.data_ptr(),
        w_scale.data_ptr(), m, nb, np_, int(fmt == "i1"),
        residual.data_ptr() if residual is not None else None,
        residual.shape[1] if residual is not None else 0,
        residual.shape[1] if residual is not None else 0,
        out.data_ptr(), int(out_dtype == torch.bfloat16), _stream())
    _build.check(err, "vlut_decode_gemm")
    return out


# --- kernel 1: fused decode projection -----------------------------------------

def ternary_gemm_decode(
    x1: torch.Tensor,  # (M, K) bf16/f32, M <= 64
    packed: torch.Tensor,  # (Kp/r, Np) uint8
    w_scale: torch.Tensor,  # (Np,) f32
    *,
    x2: torch.Tensor | None = None,  # (M, K) up half for silu_mul
    norm_g: torch.Tensor | None = None,  # (K,) RMSNorm gain
    residual: torch.Tensor | None = None,  # (M, N<=Np) added in the epilogue
    fmt: str,
    kb: int,
    k: int,
    mode: str = "plain",
    sub_norm: bool = False,
    norm_n: int = 0,
    eps: float = 1e-5,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Fused elementwise -> int8 quant -> ternary GEMM -> residual (M, Np)."""
    m = x1.shape[0]
    _check_common(packed, w_scale, fmt, kb, k)
    if x1.shape[1] != k or not 0 < m <= MAX_DECODE_M:
        raise ValueError(f"x1 {tuple(x1.shape)}: need (M <= 64, K={k})")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not x1.is_cuda:
        xq, xs = decode_prologue(x1, x2, norm_g, mode, sub_norm, norm_n,
                                       eps)
        return _gemm_plain(xq, xs, packed, w_scale, fmt, kb, k, residual,
                           out_dtype)
    out = _decode_cuda(x1, packed, w_scale, x2, norm_g, residual, fmt, kb,
                       mode, sub_norm, norm_n, eps, out_dtype)
    ternary_gemm_decode.launches += 1
    return out


def _decode_cuda(x1, packed, w_scale, x2, norm_g, residual, fmt, kb, mode,
                 sub_norm, norm_n, eps, out_dtype):
    _check_packed_cuda(packed, w_scale)
    kp = packed.shape[0] * TRITS_PER_BYTE[fmt]
    afrag, xs = _launch_prologue(x1, x2, norm_g, mode, sub_norm, norm_n,
                                 eps, fmt, kb, kp)
    return _launch_decode_gemm(afrag, xs, packed, w_scale, fmt, kb,
                               x1.shape[0], residual, out_dtype)


ternary_gemm_decode.launches = 0


# --- kernel 4: small-M GEMM with the quantization fused --------------------------

def ternary_gemm_fused_quant(
    x: torch.Tensor,  # (M, K) bf16/f32, M <= 64
    packed: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    fmt: str,
    kb: int,
    k: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Per-row int8 quantization in the kernel, then the ternary GEMM
    (M, Np).  Quantizes once per call (one prologue launch) where the TPU
    kernel re-quantizes per output block."""
    m = x.shape[0]
    _check_common(packed, w_scale, fmt, kb, k)
    if x.shape[1] != k or not 0 < m <= MAX_DECODE_M:
        raise ValueError(f"x {tuple(x.shape)}: need (M <= 64, K={k})")
    if not x.is_cuda:
        xq, xs = kernel_quantize(x)
        return _gemm_plain(xq, xs, packed, w_scale, fmt, kb, k, None,
                           out_dtype)
    out = _decode_cuda(x, packed, w_scale, None, None, None, fmt, kb,
                       "plain", False, 0, 0.0, out_dtype)
    ternary_gemm_fused_quant.launches += 1
    return out


ternary_gemm_fused_quant.launches = 0


# --- kernel 3: tiled GEMM on pre-quantized activations -----------------------------

_SMS = 132  # streaming multiprocessors of an H100 SXM


def tiled_plan(m: int, np_: int, kp: int, fmt: str) -> tuple[int, int, int]:
    """The tiled kernel's (BM, BN, splits) for an (M, Kp) x (Kp, Np) GEMM.

    The kernel's shared memory holds one block per SM (two for the 32-row
    i2 tile), and a grid past one wave of 132 blocks leaves SMs idle in its
    last wave (and at 32 rows, short splits cost more than a second block
    per SM gives; PERF.md §6 PR 5).  BM is 32 up to M 32; 64 up to M 256
    while its 128-column tiles fit in one wave; 128 otherwise, with 256
    columns where Np allows (x is then read from L2 half as often).  Where
    the tiles leave SMs idle, K is split: ``splits`` is the largest divisor
    of the pack blocks that keeps the grid in one wave and every split two
    pack blocks deep.  The splits' int32 sums are exact, so their order
    cannot change the result."""
    nb = kp // DEFAULT_BLOCK[fmt]
    bm = (32 if m <= 32 else
          64 if m <= 256 and np_ // 128 * -(-m // 64) <= _SMS else 128)
    bn = 256 if bm == 128 and np_ % 256 == 0 else 128
    tiles = np_ // bn * -(-m // bm)
    splits = max(s for s in range(1, max(1, nb // 2) + 1)
                 if nb % s == 0 and (s == 1 or tiles * s <= _SMS))
    return bm, bn, splits


def ternary_gemm_tiled(
    x_q: torch.Tensor,  # (M, K) int8
    packed: torch.Tensor,
    x_scale: torch.Tensor,  # (M, 1) f32
    w_scale: torch.Tensor,  # (Np,) f32
    *,
    fmt: str,
    kb: int,
    k: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """(M, Np) = (x_q @ trits(packed)) * x_scale * w_scale, int32 accumulator.
    With unit scales the output is the exact accumulator (the K-sharded
    tensor-parallel form)."""
    m = x_q.shape[0]
    _check_common(packed, w_scale, fmt, kb, k)
    if x_q.dtype != torch.int8 or x_q.shape[1] != k:
        raise ValueError(f"x_q must be int8 (M, {k})")
    if x_scale.shape != (m, 1):
        raise ValueError("x_scale must be (M, 1)")
    if not x_q.is_cuda:
        return _gemm_plain(x_q, x_scale.to(torch.float32), packed, w_scale,
                           fmt, kb, k, None, out_dtype)
    out = _tiled_cuda(x_q, packed, x_scale, w_scale, fmt, kb, k, out_dtype)
    ternary_gemm_tiled.launches += 1
    return out


def _tiled_cuda(x_q, packed, x_scale, w_scale, fmt, kb, k, out_dtype):
    x_scale = x_scale.to(torch.float32).contiguous()
    _check_packed_cuda(packed, w_scale)
    _check_cuda(x_scale)
    if x_q.stride(1) != 1:
        raise ValueError("x_q must have unit column stride")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported out dtype {out_dtype}")
    m, np_ = x_q.shape[0], packed.shape[1]
    kp = packed.shape[0] * TRITS_PER_BYTE[fmt]
    if x_q.stride(0) % 16 or x_q.data_ptr() % 16:
        # the TMA unit reads x from 16-byte aligned rows: rows that are not
        # go through one padded contiguous copy
        xp = torch.empty((m, -(-k // 16) * 16), dtype=torch.int8,
                         device=x_q.device)
        xp[:, :k] = x_q
        x_q = xp
    bm, bn, splits = tiled_plan(m, np_, kp, fmt)
    out = torch.empty((m, np_), dtype=out_dtype, device=x_q.device)
    work = None
    if splits > 1:  # int32 sums, then one arrival counter per output tile
        tiles = np_ // bn * -(-m // bm)
        work = torch.zeros((m * np_ + tiles,), dtype=torch.int32,
                           device=x_q.device)
    err = _lib().vlut_tiled_gemm(
        x_q.data_ptr(), x_q.stride(0), k, x_scale.data_ptr(),
        packed.data_ptr(), w_scale.data_ptr(), m, kp, np_, kb,
        int(fmt == "i1"), bm, bn, splits,
        work.data_ptr() if work is not None else None, out.data_ptr(),
        int(out_dtype == torch.bfloat16), _stream())
    _build.check(err, "vlut_tiled_gemm")
    return out


ternary_gemm_tiled.launches = 0
