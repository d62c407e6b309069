"""TQ2_0/TQ1_0 baseline lanes: llama.cpp's upstream ternary types (port of
``vlut_tpu/ops/tq.py``).

The kernel microbenchmark races the Vec-LUT formats (i2, i1) against these
two types on the same card:

* **TQ2_0**: per-256-block fp16 absmax scale d, stored fields
  round(w/d) + 1 in {0, 1, 2}, four per byte; field q of byte row w of
  block b is logical row b*256 + q*64 + w.  2.0625 bits per weight.
* **TQ1_0**: the same quantization at 1.6875 bits per weight: per block,
  rows 0-47 hold five base-3 digits (digit q of row w is logical row
  b*256 + q*48 + w), rows 48-51 four (digit q of row 48+w is logical row
  b*256 + 240 + q*4 + w).

Scales live in a separate (Kp/256, N) float16 array.  The layout is the
JAX package's, not GGUF's; the quantization semantics and the bytes moved
are llama.cpp's.

:func:`tq_gemm` computes ``sum_blocks (x_b . trits_b) * d_b * x_scale``: a
tensor on the CPU goes to :func:`tq_gemm_plain`, a CUDA tensor to the kernel
in ``csrc/tq_gemm.cu`` (or the wrapper raises).  The float32 sum follows the
JAX kernel run in interpret mode bit for bit (see :func:`tq_gemm_plain`), so
its result depends on ``bk`` as the JAX one does.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vlut_tpu_torch.ops import _build, counted
from vlut_tpu_torch.ops.ternary_gemm import (
    _check_cuda, _int_matmul, _stream, sm_count)

QK = 256  # block size (QK_K)
ROWS_PER_BLOCK = {"tq2": QK // 4, "tq1": 52}  # packed byte rows / 256 wts
TILES = ((32, 64), (32, 128), (128, 64))  # the kernel's (BM, BN)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long


# --- packing (numpy in, numpy out; byte-identical to the JAX package) --------

def pack_tq2(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(K, N) float weights -> ((Kp/4, N) uint8, (Kp/256, N) float16).

    Per-(256-block, column) absmax scale d; stored fields are
    round(w/d)+1 in {0,1,2}, four per byte in slab order (field q of byte
    row w = logical row b*256 + q*64 + w).
    """
    k, n = w.shape
    kp = -(-k // QK) * QK
    wf = np.zeros((kp, n), np.float32)
    wf[:k] = w.astype(np.float32)
    blocks = wf.reshape(kp // QK, QK, n)
    d = np.abs(blocks).max(axis=1)                       # (nb, N)
    scales = d.astype(np.float16)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
    q = np.rint(blocks * inv[:, None, :]).astype(np.int8)  # {-1,0,1}
    f = (q + 1).astype(np.uint8).reshape(kp // QK, 4, QK // 4, n)
    packed = (
        f[:, 0] | (f[:, 1] << 2) | (f[:, 2] << 4) | (f[:, 3] << 6)
    ).reshape(kp // 4, n)
    return packed, scales


def unpack_tq2(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of pack_tq2 -> (Kp, N) float32."""
    return _unpack(packed, scales, "tq2")


def pack_tq1(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(K, N) float weights -> ((Kp/256*52, N) uint8, (Kp/256, N) float16).

    Same quantization rule as TQ2_0 (per-block absmax d, round(w/d) in
    {-1,0,1}) at TQ1_0's 1.6875 bpw: per 256-block, rows 0-47 pack 5
    trits/byte base-243 (logical row q*48 + w at digit q of byte w) and
    rows 48-51 pack the last 16 trits 4/byte base-81.
    """
    k, n = w.shape
    kp = -(-k // QK) * QK
    wf = np.zeros((kp, n), np.float32)
    wf[:k] = w.astype(np.float32)
    blocks = wf.reshape(kp // QK, QK, n)
    d = np.abs(blocks).max(axis=1)
    scales = d.astype(np.float16)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
    f = (np.rint(blocks * inv[:, None, :]) + 1).astype(np.uint8)  # {0,1,2}
    f5 = f[:, :240].reshape(kp // QK, 5, 48, n)
    p5 = sum(f5[:, q].astype(np.uint16) * 3**q for q in range(5))
    f4 = f[:, 240:].reshape(kp // QK, 4, 4, n)
    p4 = sum(f4[:, q].astype(np.uint16) * 3**q for q in range(4))
    packed = np.concatenate([p5, p4], axis=1).astype(np.uint8)
    return packed.reshape(-1, n), scales


def unpack_tq1(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of pack_tq1 -> (Kp, N) float32."""
    return _unpack(packed, scales, "tq1")


def _unpack(packed: np.ndarray, scales: np.ndarray, fmt: str) -> np.ndarray:
    trits = tq_trits(torch.from_numpy(np.ascontiguousarray(packed)), fmt)
    d = torch.from_numpy(scales.astype(np.float32)).repeat_interleave(QK, 0)
    return (trits.float() * d).numpy()


def tq_trits(packed: torch.Tensor, fmt: str) -> torch.Tensor:
    """(Kp/256*rpb, N) uint8 -> (Kp, N) int8 trits in logical K order, on
    the packed tensor's device."""
    rpb = ROWS_PER_BLOCK[fmt]
    rows, n = packed.shape
    nb = rows // rpb
    p = packed.to(torch.int16).reshape(nb, rpb, n)
    if fmt == "tq2":
        f = torch.stack([(p >> (2 * q)) & 3 for q in range(4)], dim=1)
        f = f.reshape(nb, QK, n)
    else:
        f5 = torch.stack([(p[:, :48] // 3**q) % 3 for q in range(5)], dim=1)
        f4 = torch.stack([(p[:, 48:] // 3**q) % 3 for q in range(4)], dim=1)
        f = torch.cat([f5.reshape(nb, 240, n), f4.reshape(nb, 16, n)], dim=1)
    return (f - 1).to(torch.int8).reshape(nb * QK, n)


# --- the GEMM -------------------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as ``fmaf``.  The float64 product of
    two float32 values is exact.  The float64 sum is rounded to odd: where
    it is inexact (its TwoSum error is not 0) and its last bit is even, it
    moves one step toward the exact sum.  A round-to-odd value with 29 bits
    more than float32 rounds to float32 as the exact sum does."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf), err))
    return torch.where(nudge, away, s).float()


def tq_gemm_plain(x_q, packed, scales, x_scale, *, fmt: str, bk: int = 2048,
                  out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: exact int32 block dots, then the
    float32 sum in the order the JAX kernel's interpret run computes it
    (``acc + dot*s`` inside a ``bk`` tile, ``acc_ref += acc`` across tiles,
    ``tq.py:134-147``), as XLA compiles it: inside a tile of two or more
    blocks the first pair is fma(d0, s0, round(d1*s1)) and each later
    block fma(d, s, p), and the tile is added to the running sum with one
    rounding; a one-block tile is fma(d, s, total).  Then ``* x_scale``."""
    m, kp = x_q.shape
    n = packed.shape[1]
    nb, nbt = kp // QK, bk // QK
    w = tq_trits(packed, fmt).reshape(nb, QK, n)
    xb = x_q.reshape(m, nb, QK).permute(1, 0, 2)
    dots = _int_matmul(xb, w).to(torch.float32)  # (nb, M, N), exact
    s = scales.to(torch.float32)[:, None, :]
    total = torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    for t0 in range(0, nb, nbt):
        if nbt == 1:
            total = _fma(dots[t0], s[t0], total)
            continue
        p = _fma(dots[t0], s[t0], dots[t0 + 1] * s[t0 + 1])
        for i in range(t0 + 2, t0 + nbt):
            p = _fma(dots[i], s[i], p)
        total = total + p
    return (total * x_scale.to(torch.float32)).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("tq_gemm.cu")
    if not getattr(lib, "_vlut_typed", False):
        lib.vlut_tq_gemm.argtypes = [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _P, _P, _P, _P]
        lib.vlut_tq_gemm.restype = ctypes.c_int
        lib.vlut_tq_init.restype = ctypes.c_int
        _build.check(lib.vlut_tq_init(), "vlut_tq_init")
        lib._vlut_typed = True
    return lib


def tq_plan(m: int, np_: int, kp: int, bk: int,
            sms: int) -> tuple[int, int, int]:
    """The kernel's (BM, BN, splits) for an (M, Kp) x (Kp, Np) GEMM on a card
    with ``sms`` streaming multiprocessors.

    The kernel's shared memory holds one block per SM.  K splits only at bk
    tile boundaries (each tile's float32 partial is summed in tile order,
    so the result does not depend on the split), a split may cover an
    uneven number of tiles, and bk = 256 (one chained sum) never splits;
    ``splits`` is the most that keep the grid in one wave (1 when the tiles
    alone fill it).  The tiles follow a sweep of every tile and split on an
    H100 (``bench/tq_study.py --sweep``, PERF.md §6): above 32 rows
    128 x 64 (for tq1, whose decode costs per column what tq2's does per 4
    columns, by far the best tile; for tq2 2-7% faster than 64 x 128, the
    next best); up to 32 rows 32 x 128, or 32 x 64 where the 128-column
    tiles and their splits would leave half the card idle."""
    nk = kp // bk

    def split(tiles: int) -> int:
        return 1 if bk == QK else max(1, min(nk, sms // tiles))

    def tiles_of(bm: int, bn: int) -> int:
        return -(-np_ // bn) * -(-m // bm)

    if m > 32:
        bm, bn = 128, 64
    else:
        bm, bn = 32, 128
        t = tiles_of(bm, bn)
        if t * split(t) < sms // 2:
            bn = 64
    t = tiles_of(bm, bn)
    return bm, bn, split(t)


# (M, K, N, bk) at which tq_plan takes each of its tiles and split counts on
# a 132-SM card (one split, even and uneven splits of the bk tiles), with
# ragged M and N (N not a multiple of 16 is padded by the wrapper): the
# shapes of the kernel's checks on the card
PLAN_SHAPES = [
    (1, 512, 64, 256), (17, 1024, 200, 512), (100, 1536, 136, 512),
    (40, 4096, 1000, 2048), (256, 2048, 1024, 1024), (130, 3584, 264, 512),
    (32, 14336, 4096, 2048), (256, 4096, 14336, 2048), (32, 4096, 4096, 2048),
    (32, 4096, 14336, 2048), (64, 14336, 4096, 2048), (7, 14336, 2000, 2048),
    (33, 1024, 72, 512)]


def tq_gemm(
    x_q: torch.Tensor,  # (M, Kp) int8
    packed: torch.Tensor,  # (Kp/256 * rows_per_block, N) uint8
    scales: torch.Tensor,  # (Kp/256, N) float16
    x_scale: torch.Tensor,  # (M, 1) float32
    *,
    fmt: str = "tq2",
    bk: int = 2048,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """(M, N) = sum_blocks (x_b @ trits_b) * d_b * x_scale."""
    if fmt not in ROWS_PER_BLOCK:
        raise ValueError(f"unknown TQ format {fmt!r}")
    m, kp = x_q.shape
    rpb = ROWS_PER_BLOCK[fmt]
    n = packed.shape[1]
    if x_q.dtype != torch.int8 or packed.dtype != torch.uint8:
        raise ValueError("x_q must be int8 and packed uint8")
    if kp % QK or packed.shape[0] != kp // QK * rpb:
        raise ValueError(f"packed {tuple(packed.shape)} does not fit Kp={kp}")
    if scales.shape != (kp // QK, n) or scales.dtype != torch.float16:
        raise ValueError("scales must be float16 of shape (Kp/256, N)")
    if x_scale.shape != (m, 1):
        raise ValueError("x_scale must be (M, 1)")
    if bk % QK or kp % bk:
        raise ValueError(f"bk={bk} must be a multiple of 256 dividing Kp={kp}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported out dtype {out_dtype}")
    if not x_q.is_cuda:
        return tq_gemm_plain(x_q, packed, scales, x_scale, fmt=fmt, bk=bk,
                             out_dtype=out_dtype)
    out = _tq_cuda(x_q, packed, scales, x_scale, fmt, bk, out_dtype)
    tq_gemm.launches += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte aligned address (the TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _tq_cuda(x_q, packed, scales, x_scale, fmt, bk, out_dtype, plan=None,
             lib=None):
    """The kernel's call; ``plan`` and ``lib`` replace the plan and the
    built library (for the study, ``bench/tq_study.py``)."""
    m, kp = x_q.shape
    n = packed.shape[1]
    # the TMA reads rows 16 bytes apart: N is padded only where it is not
    np_ = -(-n // 16) * 16
    if np_ != n:
        packed = torch.nn.functional.pad(packed, (0, np_ - n))
        scales = torch.nn.functional.pad(scales, (0, np_ - n))
    packed, scales = _aligned(packed), _aligned(scales)
    x_scale = x_scale.to(torch.float32).contiguous()
    _check_cuda(packed, scales, x_scale)
    if x_q.stride(1) != 1:
        raise ValueError("x_q must have unit column stride")
    if x_q.stride(0) % 16 or x_q.data_ptr() % 16:
        # rows that are not 16-byte aligned go through one contiguous copy
        x_q = x_q.clone(memory_format=torch.contiguous_format)
    lib = lib or _lib()
    bm, bn, splits = plan or tq_plan(m, np_, kp, bk,
                                     sm_count(x_q.device.index or 0))
    out = torch.empty((m, np_), dtype=torch.float32, device=x_q.device)
    part = counters = None
    if splits > 1:  # the bk tiles' partials, one arrival counter per tile
        part = torch.empty((kp // bk, m, np_), dtype=torch.float32,
                           device=x_q.device)
        counters = torch.zeros((-(-np_ // bn) * -(-m // bm),),
                               dtype=torch.int32, device=x_q.device)
    err = lib.vlut_tq_gemm(
        x_q.data_ptr(), x_q.stride(0), x_scale.data_ptr(), packed.data_ptr(),
        scales.data_ptr(), m, kp, np_, int(fmt == "tq1"), bk, bm, bn, splits,
        part.data_ptr() if part is not None else None,
        counters.data_ptr() if counters is not None else None,
        out.data_ptr(), _stream())
    _build.check(err, "vlut_tq_gemm")
    return (out if np_ == n else out[:, :n]).to(out_dtype)


counted(tq_gemm)


def tq2_gemm(*args, **kw):
    return tq_gemm(*args, fmt="tq2", **kw)


def tq1_gemm(*args, **kw):
    return tq_gemm(*args, fmt="tq1", **kw)
