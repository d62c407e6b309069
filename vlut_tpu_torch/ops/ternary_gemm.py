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
tensor goes to the kernels in ``csrc/decode_gemm.cu`` (the first two) or
``csrc/ternary_gemm.cu`` (the tiled one), built and loaded by
``ops/_build.py``, or the wrapper raises.  Each wrapper counts its kernel
launches in its ``launches`` attribute.  Shapes: x has the logical K
columns (no padding needed); outputs are (M, Np) with the packed, padded N.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vlut_tpu_torch.ops import _build, counted
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
        lib.vlut_tiled_gemm.argtypes = [
            _P, _L, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
            _I, _P]
        for f in (lib.vlut_tiled_gemm, lib.vlut_tiled_init):
            f.restype = ctypes.c_int
        _build.check(lib.vlut_tiled_init(), "vlut_tiled_init")
        lib._vlut_typed = True
    return lib


def _stream(index: int | None = None) -> int:
    """The current CUDA stream's handle (of device ``index``, the cheaper
    lookup on the decode step's hot path)."""
    if index is None:
        return torch.cuda.current_stream().cuda_stream
    return torch._C._cuda_getCurrentRawStream(index)


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


# the decode prologue keeps a row of float32 inputs in the shared memory of
# a cluster of at most 8 blocks (csrc/decode_gemm.cu: kProSmemMax)
MAX_K = 8 * (227 * 1024 - 1024) // 4
MAX_SPLITS = 4  # the decode GEMM's splits of K (its last block adds them)


def _dlib() -> ctypes.CDLL:
    lib = _build.load("decode_gemm.cu")
    if not getattr(lib, "_vlut_typed", False):
        lib.vlut_decode_prologue.argtypes = [
            _P, _P, _L, _I, _I, _I, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P,
            _I, _I, _P]
        lib.vlut_decode_gemm.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P,
            _I, _P]
        lib.vlut_decode.argtypes = [
            _P, _P, _L, _I, _I, _I, _P, _I, _I, _F, _F, _I, _P, _P, _I, _I,
            _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P]
        for f in (lib.vlut_decode_prologue, lib.vlut_decode_gemm,
                  lib.vlut_decode, lib.vlut_decode_init):
            f.restype = ctypes.c_int
        _build.check(lib.vlut_decode_init(), "vlut_decode_init")
        lib._vlut_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def decode_plan(m: int, np_: int, kp: int, fmt: str,
                sms: int) -> tuple[int, int]:
    """The decode GEMM's (BN, splits) for an (M <= 64, Kp) x (Kp, Np) GEMM
    on a card with ``sms`` streaming multiprocessors.

    With its ring of up to 200 KB the kernel takes one block per SM, and a
    grid past one wave leaves SMs idle in its last.  A block owns 128
    columns, or 256 where the 128-column tiles alone overfill the wave (and
    Np allows).  Where the tiles leave SMs idle, K is split into the most
    ranges of whole pack blocks that keep the grid in one wave, each at
    least one stage deep (the kernel's K groups, ``decode_stage_blocks``)
    and at most 4 (their sums meet by atomic adds in L2, and the last block
    of a tile applies the epilogue: splits cost time too); none where 254 *
    Kp reaches 2^24 (the sums are added as floats, exact below it).  The
    choice follows a sweep of every (BN, splits) on an H100 at the flagship
    projections, M 1, 32 and 64 (``bench/decode_study.py --sweep``, PERF.md
    §6).  The ranges may be uneven; the sums are exact, so no plan changes
    the result."""
    bn = 256 if np_ // 128 > sms and np_ % 256 == 0 else 128
    tiles = np_ // bn
    nb = kp // DEFAULT_BLOCK[fmt]
    s = decode_stage_blocks(m, bn, fmt)
    if 254 * kp >= 1 << 24:
        return bn, 1
    return bn, max(1, min(sms // tiles, nb // s, MAX_SPLITS))


# (M, K, N) at which decode_plan takes every kernel instantiation it uses
# (16-row tiles 1-4; BN 128 with one split and with several, BN 256 with
# one) and every split count on a 132-SM card, in i2 and i1, and the
# flagship's projections at M 32: the shapes of the kernel's checks on the
# card
DECODE_PLAN_SHAPES = [
    (m, k, n) for m in (1, 17, 33, 64)
    for k, n in ((1280, 17000), (1280, 33792), (3840, 384), (3840, 512))
] + [(m, k, 384) for m in (17, 64) for k in (1280, 1920)] + [
    (32, 4096, 6144), (32, 4096, 4096), (32, 4096, 28672), (32, 14336, 4096)]


def decode_stage_blocks(m: int, bn: int, fmt: str) -> int:
    """Pack blocks per stage of the decode GEMM (csrc/decode_gemm.cu Cfg):
    its eight mma warps split into column groups of 128 (i2 up to M 32) or
    64 columns, and K groups of one pack block each."""
    nw = 128 if fmt == "i2" and m <= 32 else 64
    return 8 * nw // bn


def _prologue_args(x1, x2, norm_g):
    if x1.dtype not in (torch.bfloat16, torch.float32) or x1.stride(1) != 1:
        raise ValueError("x must be bf16/f32 with unit column stride")
    if x1.shape[1] > MAX_K:
        raise ValueError(f"K={x1.shape[1]}: the decode prologue takes "
                         f"K <= {MAX_K}")
    if x2 is not None and (x2.dtype != x1.dtype or x2.stride() != x1.stride()
                           or x2.device != x1.device):
        raise ValueError("x2 must match x1's dtype, strides and device")
    if norm_g is not None:
        if norm_g.dtype != torch.float32 or not norm_g.is_contiguous():
            norm_g = norm_g.to(torch.float32).contiguous()
        _check_cuda(norm_g)
    return norm_g


@functools.lru_cache(maxsize=None)
def _scratch_layout(m: int, kp: int, np_: int, bn: int,
                    splits: int) -> tuple[int, int, int | None, int]:
    """Byte offsets in a call's one scratch allocation: the (M, Kp) int8
    codes at 0, then the (M,) float32 scales, the (M,) int32 row sums and,
    with a split of K, 16-byte aligned after them, the split's workspace
    (the (M, Np) float32 sums, then one int32 arrival counter per column
    tile), which the prologue zeroes.  Returns (scales, row sums, workspace
    or None, total bytes)."""
    xs = m * kp
    rowsum = xs + 4 * m
    end = rowsum + 4 * m
    if splits == 1:
        return xs, rowsum, None, end
    work = -(-end // 16) * 16
    return xs, rowsum, work, work + 4 * (m * np_ + np_ // bn)


def _decode_buffers(m, kp, np_, bn, splits, device):
    """The scratch of :func:`_scratch_layout` as tensors: (M, Kp) int8
    codes, (M,) float32 scales, (M,) int32 row sums and the workspace as
    int32 (None without a split)."""
    xs, rowsum, work, nbytes = _scratch_layout(m, kp, np_, bn, splits)
    buf = torch.empty((nbytes,), dtype=torch.uint8, device=device)
    return (buf[:xs].view(torch.int8).view(m, kp),
            buf[xs:rowsum].view(torch.float32),
            buf[rowsum:rowsum + 4 * m].view(torch.int32),
            buf[work:].view(torch.int32) if work is not None else None)


def _launch_prologue(x1, x2, norm_g, mode, sub_norm, norm_n, eps, kp,
                     np_=0, bn=128, splits=1):
    """The prologue kernel alone: ((M, Kp) int8 codes, (M,) scales, (M,)
    int32 row sums of the codes, and, for a GEMM of ``splits`` > 1 over Np
    columns in tiles of BN, its workspace, zeroed)."""
    norm_g = _prologue_args(x1, x2, norm_g)
    m, k = x1.shape
    codes, xs, rowsum, work = _decode_buffers(m, kp, np_, bn, splits,
                                              x1.device)
    err = _dlib().vlut_decode_prologue(
        x1.data_ptr(), x2.data_ptr() if x2 is not None else None,
        x1.stride(0), int(x1.dtype == torch.bfloat16), k, kp,
        norm_g.data_ptr() if norm_g is not None else None, _MODES[mode],
        int(sub_norm), float(norm_n or k), float(eps), m, codes.data_ptr(),
        xs.data_ptr(), rowsum.data_ptr(),
        work.data_ptr() if work is not None else None, np_,
        np_ // bn if work is not None else 0, _stream())
    _build.check(err, "vlut_decode_prologue")
    return codes, xs, rowsum, work


def prologue_codes(x1, x2, norm_g, mode, sub_norm, norm_n, eps,
                   kp) -> tuple[torch.Tensor, torch.Tensor]:
    """The prologue kernel's (M, K) int8 codes and (M,) scales, to hold them
    against :func:`decode_prologue` (not counted as a launch of the decode
    kernel)."""
    codes, xs, _, _ = _launch_prologue(x1, x2, norm_g, mode, sub_norm,
                                       norm_n, eps, kp)
    return codes[:, :x1.shape[1]], xs


def _launch_decode_gemm(codes, xs, rowsum, work, packed, w_scale, fmt, m,
                        residual, out_dtype, bn, splits):
    """The GEMM kernel alone, on :func:`_launch_prologue`'s outputs (with
    ``splits`` > 1, its zeroed workspace ``work``)."""
    np_ = packed.shape[1]
    out = torch.empty((m, np_), dtype=out_dtype, device=packed.device)
    err = _dlib().vlut_decode_gemm(
        codes.data_ptr(), xs.data_ptr(), rowsum.data_ptr(), packed.data_ptr(),
        w_scale.data_ptr(), m, codes.shape[1], np_, int(fmt == "i1"), bn,
        splits, work.data_ptr() if work is not None else None,
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
                 sub_norm, norm_n, eps, out_dtype, plan=None):
    """Two launches from one C call: the prologue and the GEMM, which may
    start while the prologue runs.  One scratch allocation holds the codes,
    the scales, the row sums and the split's workspace (the decode step is
    bound by the host's dispatch: PERF.md §5).  ``plan`` forces (BN,
    splits) in place of :func:`decode_plan`'s."""
    _check_packed_cuda(packed, w_scale)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported out dtype {out_dtype}")
    if residual is not None:
        if residual.dtype != out_dtype or not residual.is_contiguous():
            residual = residual.to(out_dtype).contiguous()
        _check_cuda(residual)
    norm_g = _prologue_args(x1, x2, norm_g)
    m, k = x1.shape
    np_ = packed.shape[1]
    kp = packed.shape[0] * TRITS_PER_BYTE[fmt]
    index = x1.device.index or 0
    bn, splits = plan or decode_plan(m, np_, kp, fmt, sm_count(index))
    xs, rowsum, work, nbytes = _scratch_layout(m, kp, np_, bn, splits)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x1.device)
    out = torch.empty((m, np_), dtype=out_dtype, device=x1.device)
    base = scratch.data_ptr()
    err = _dlib().vlut_decode(
        x1.data_ptr(), x2.data_ptr() if x2 is not None else None,
        x1.stride(0), int(x1.dtype == torch.bfloat16), k, kp,
        norm_g.data_ptr() if norm_g is not None else None, _MODES[mode],
        int(sub_norm), float(norm_n or k), float(eps), m, packed.data_ptr(),
        w_scale.data_ptr(), np_, int(fmt == "i1"), bn, splits, base,
        base + xs, base + rowsum, base + work if work is not None else None,
        residual.data_ptr() if residual is not None else None,
        residual.shape[1] if residual is not None else 0,
        residual.shape[1] if residual is not None else 0, out.data_ptr(),
        int(out_dtype == torch.bfloat16), _stream(index))
    _build.check(err, "vlut_decode")
    return out


counted(ternary_gemm_decode)


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


counted(ternary_gemm_fused_quant)


# --- kernel 3: tiled GEMM on pre-quantized activations -----------------------------

def tiled_plan(m: int, np_: int, kp: int, fmt: str,
               sms: int) -> tuple[int, int, int]:
    """The tiled kernel's (BM, BN, splits) for an (M, Kp) x (Kp, Np) GEMM on
    a card with ``sms`` streaming multiprocessors.

    The kernel's shared memory holds one block per SM (two for the 32-row
    i2 tile), and a grid past one wave of ``sms`` blocks leaves SMs idle in
    its last wave (and at 32 rows, short splits cost more than a second
    block per SM gives; PERF.md §6).  BM is 32 up to M 32; 64 up to M 256
    while its 128-column tiles fit in one wave; 128 otherwise, with 256
    columns where Np allows (x is then read from L2 half as often).  Where
    the tiles leave SMs idle, K is split: ``splits`` is the largest divisor
    of the pack blocks that keeps the grid in one wave and every split two
    pack blocks deep.  The splits' int32 sums are exact, so their order
    cannot change the result."""
    nb = kp // DEFAULT_BLOCK[fmt]
    bm = (32 if m <= 32 else
          64 if m <= 256 and np_ // 128 * -(-m // 64) <= sms else 128)
    bn = 256 if bm == 128 and np_ % 256 == 0 else 128
    tiles = np_ // bn * -(-m // bm)
    splits = max(s for s in range(1, max(1, nb // 2) + 1)
                 if nb % s == 0 and (s == 1 or tiles * s <= sms))
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
    bm, bn, splits = tiled_plan(m, np_, kp, fmt,
                                sm_count(x_q.device.index or 0))
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


counted(ternary_gemm_tiled)
