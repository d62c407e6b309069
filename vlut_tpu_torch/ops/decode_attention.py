"""Fused decode attention: KV row write + GQA attention in one kernel call
(port of vlut_tpu/ops/decode_attention.py).

:func:`decode_attention` serves the bf16 cache (TPU kernel #7) and
:func:`decode_attention_int8` the int8 cache with per-(row, head) float32
scales (#8).  Both write the step's new K/V row of every slot b into
``cache[b, start[b]]`` in place and return the attention output
(B, 1, H, hdv) float32 over the cache rows ``row < start[b]`` (and
``row > start[b] - window`` when ``window > 0``) plus the new token, whose
own term uses the cache-dtype value: the bf16-rounded row, or the int8 row
quantized as the JAX package's jitted ``quantize_kv`` does and dequantized.
K heads are hd wide and V heads hdv wide; any group size H / Hkv.

A CUDA tensor goes to the kernel in ``csrc/decode_attention.cu``: one
launch of blocks of (slot, KV head, group of :func:`head_groups` query
heads, split of ``attn_plan`` cache rows), the last block of a split
(slot, KV head, group) merging the splits; it takes q and the new rows as
the model's layer gives them (bf16 or float32, the new rows strided) and
the starts as int32 or int64, and never casts or copies them.  It takes hd
and hdv each of :data:`HEAD_DIMS`; a wider head raises ``ValueError``
(the one place the port's domain is narrower than the Pallas kernels').
A CPU tensor goes to the plain PyTorch version below
(:func:`decode_attention_plain`, :func:`decode_attention_int8_plain`).
Both skip the write of a slot whose start lies outside [0, S).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vlut_tpu_torch.ops import _build, counted, holds_buffers
from vlut_tpu_torch.ops.ternary_gemm import _stream, sm_count
from vlut_tpu_torch.runtime.kv_cache import dequantize_kv, quantize_kv

_P = ctypes.c_void_p
NEG = -1e30
HEAD_DIMS = (128, 256, 384, 512)
MAX_HEAD_WIDTH = 512  # a block holds 4 x 512 / max(hd, hdv) query heads


def supports(h: int, hkv: int, hd: int, hdv: int) -> bool:
    """Whether the kernels take H query heads over Hkv KV heads, K heads
    of width hd and V heads of width hdv (padded widths: the port pads
    heads to 128 lanes)."""
    return (hd in HEAD_DIMS and hdv in HEAD_DIMS and hkv > 0
            and h >= hkv and h % hkv == 0)


def head_groups(g: int, hd: int, hdv: int) -> tuple[int, int]:
    """(heads per block, groups per KV head): a KV head's g query heads
    dealt into the fewest groups of at most 4 x 512 / max(hd, hdv) heads
    (16 at 128, the most one block's m-tiles and accumulators hold), of
    equal size but the last.  The kernel is instantiated per m-tile count,
    ceil(heads / 4)."""
    most = 4 * (MAX_HEAD_WIDTH // max(hd, hdv))
    n = -(-g // most)
    heads = -(-g // n)
    return heads, -(-g // heads)


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
    """q (B, 1, H, hd); kf (B, S, Hkv, hd), vf (B, S, Hkv, hdv) float32
    cache values; kn (B, Hkv, hd), vn (B, Hkv, hdv) float32 new-row values
    -> (B, 1, H, hdv) float32."""
    b, s, hkv, hd = kf.shape
    h, hdv = q.shape[2], vf.shape[-1]
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
    return (num / l).reshape(b, 1, h, hdv)


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

ROWS = (16, 32, 64, 128, 256, 512)  # cache rows per block, multiples of 16

# (B, Hkv, S, G) at which attn_plan takes each of ROWS on a card of 132
# SMs, and where head groups move the plan (OuteTTS's one slot of 2 KV
# heads at G 7 over 8,192 rows; falcon-7b's 16 slots of one KV head at G
# 71, five groups, over 2,048); chip_smoke.py, the card tests and
# bench/attention_study.py check the kernel there
PLAN_SHAPES = [(32, 8, 2048, 4), (8, 8, 512, 2), (4, 8, 512, 1),
               (1, 8, 552, 8), (1, 8, 300, 4), (1, 2, 300, 2),
               (1, 2, 8192, 7), (16, 1, 2048, 71)]


def span(s: int, window: int) -> int:
    """The most cache rows a slot attends to: S, or the window."""
    return min(s, window) if window > 0 else s


@functools.lru_cache(maxsize=None)
def attn_plan(b: int, hkv: int, s: int, sms: int, groups: int = 1) -> int:
    """Cache rows per block for B slots of Hkv KV heads of ``groups`` head
    groups each over at most ``s`` rows each, on a card of ``sms`` SMs:
    the most (of :data:`ROWS`) that still give a full cache at least half
    a wave of blocks, else the fewest.  A block's fixed costs (its first
    copies' latency, the merge of a slot's splits by the last block)
    outweigh the SMs a short cache leaves idle: on the H100, B 1 at S 552
    took 8.1 us at 64 rows (72 blocks) and 13.7 us at 16 (280 blocks), and
    B 32 at S 2048 was fastest at 512 (bench/attention_study.py --sweep)."""
    for rows in reversed(ROWS):
        if 2 * b * hkv * groups * -(-s // rows) >= sms:
            return rows
    return ROWS[0]


def type_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    i, lg = ctypes.c_int, ctypes.c_long
    lib.vlut_decode_attn.argtypes = [
        _P, lg, i, _P, lg, _P, lg, i, _P, _P, _P, _P, _P, i, i, i, i, i, i, i,
        i, i, ctypes.c_float, i, i, i, _P, _P, _P, _P]
    lib.vlut_decode_attn.restype = i
    return lib


_dlib = None
_work: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


@holds_buffers
def _workspaces() -> list:
    # a CUDA graph captured with a workspace keeps it, so a larger call
    # may replace it here
    return [t for pair in _work.values() for t in pair]


def _lib() -> ctypes.CDLL:
    global _dlib
    if _dlib is None:
        _dlib = type_lib(_build.load("decode_attention.cu"))
    return _dlib


def _workspace(dev: torch.device, floats: int, pairs: int):
    """The splits' states and the per-(slot, KV head, group) arrival
    counters of ``dev``, kept between calls: the counters are zeroed once,
    and the kernel's last block of a (slot, KV head, group) zeroes its own
    again, so a call launches nothing but the kernel.  Calls on one device
    share them, so they must not run on two streams at once."""
    part, cnt = _work.get(dev.index, (None, None))
    if part is None or part.numel() < floats or cnt.numel() < pairs:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention: the workspace must be "
                               "allocated (one call at this size) before "
                               "a CUDA graph is captured")
        part = torch.empty(max(floats, 0 if part is None else part.numel()),
                           dtype=torch.float32, device=dev)
        cnt = torch.zeros(max(pairs, 0 if cnt is None else cnt.numel()),
                          dtype=torch.int32, device=dev)
        _work[dev.index] = (part, cnt)
    return part, cnt


def _rowwise(t: torch.Tensor, shape: tuple, name: str) -> int:
    """The slot stride of ``t``: (B, 1, heads, hd) with contiguous heads,
    its slots' rows 16-byte aligned (the kernel copies them whole)."""
    if (tuple(t.shape) != shape or t.stride(3) != 1
            or t.stride(2) != shape[3] or t.data_ptr() % 16
            or t.stride(0) * t.element_size() % 16):
        raise ValueError(f"{name} must be {shape} with contiguous heads and "
                         f"16-byte aligned rows; got {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.stride(0)


def _launch(q, k_new, v_new, kc, vc, ksc, vsc, start, window, scale,
            rows=None, lib=None, heads=None):
    """One kernel call; ``rows`` forces the rows per block, ``heads`` the
    query heads per block and ``lib`` another build of the kernel
    (studies)."""
    b, s, hkv, hd = kc.shape
    h, hdv = q.shape[2], vc.shape[-1]
    quant = ksc is not None
    if not supports(h, hkv, hd, hdv):
        raise ValueError(f"decode attention kernel takes hd and hdv in "
                         f"{HEAD_DIMS} (at most {MAX_HEAD_WIDTH}) and H a "
                         f"multiple of Hkv; got hd {hd}, hdv {hdv}, H {h}, "
                         f"Hkv {hkv}")
    want = torch.int8 if quant else torch.bfloat16
    for c, w in ((kc, hd), (vc, hdv)):
        if (c.dtype != want or not c.is_contiguous()
                or c.shape != (b, s, hkv, w) or c.data_ptr() % 16):
            raise ValueError(f"caches must be contiguous 16-byte aligned "
                             f"{want} {(b, s, hkv)} x (hd, hdv); got "
                             f"{tuple(kc.shape)}, {tuple(vc.shape)}")
    if quant:
        for c in (ksc, vsc):
            if (c.dtype != torch.float32 or not c.is_contiguous()
                    or c.shape != kc.shape[:3]):
                raise ValueError("scales must be contiguous float32 "
                                 f"{tuple(kc.shape[:3])}")
    q_ld = _rowwise(q, (b, 1, h, hd), "q")
    k_ld = _rowwise(k_new, (b, 1, hkv, hd), "k_new")
    v_ld = _rowwise(v_new, (b, 1, hkv, hdv), "v_new")
    floats = (torch.bfloat16, torch.float32)
    if q.dtype not in floats or k_new.dtype not in floats \
            or v_new.dtype != k_new.dtype:
        raise ValueError("q and the new rows must be bf16 or float32 (the "
                         "rows of one type)")
    if start.shape != (b,) or start.stride(0) != 1 \
            or start.dtype not in (torch.int32, torch.int64):
        raise ValueError("start must be a contiguous (B,) int32 or int64")
    dev = kc.device
    tensors = [q, k_new, v_new, start, vc] + ([ksc, vsc] if quant else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must lie on the cache's device")
    g = h // hkv
    heads, groups = ((heads, -(-g // heads)) if heads
                     else head_groups(g, hd, hdv))
    rows = rows or attn_plan(b, hkv, span(s, int(window)),
                             sm_count(dev.index), groups)
    nsplit = -(-span(s, int(window)) // rows)
    part, cnt = _workspace(dev, b * hkv * groups * nsplit * heads * (hdv + 2),
                           b * hkv * groups)
    out = torch.empty((b, 1, h, hdv), dtype=torch.float32, device=dev)
    err = (lib or _lib()).vlut_decode_attn(
        q.data_ptr(), q_ld, int(q.dtype == torch.bfloat16), k_new.data_ptr(),
        k_ld, v_new.data_ptr(), v_ld, int(k_new.dtype == torch.bfloat16),
        kc.data_ptr(), vc.data_ptr(), ksc.data_ptr() if quant else None,
        vsc.data_ptr() if quant else None, start.data_ptr(),
        int(start.dtype == torch.int64), b, s, h, hkv, hd, hdv, heads,
        int(window), float(scale), int(quant), rows, nsplit, part.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), _stream(dev.index))
    _build.check(err, "vlut_decode_attn")
    return out


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     start: torch.Tensor, window: int = 0, *,
                     scale: float) -> torch.Tensor:
    """bf16 cache (#7): q (B, 1, H, hd), k_new (B, 1, Hkv, hd) and v_new
    (B, 1, Hkv, hdv) (bf16 or float32, rounded to bf16 for the cache), kc
    (B, S, Hkv, hd) and vc (B, S, Hkv, hdv) bf16 updated in place, start
    (B,) -> att (B, 1, H, hdv) float32."""
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


counted(decode_attention)
counted(decode_attention_int8)
