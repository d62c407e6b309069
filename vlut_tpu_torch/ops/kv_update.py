"""KV-cache row writes (port of vlut_tpu/ops/kv_update.py).

:func:`write_rows_pair` writes the K and V row of every slot b into
``cache[b, start[b]]`` and :func:`write_rows` does the same for one array.
Both update the caches IN PLACE and return them (the JAX package gets the
same effect through buffer donation).  A CUDA tensor goes to the kernel in
``csrc/kv_update.cu``: one launch for every array of a layer's update (K
and V, and with ``scales`` the int8 cache's two scale planes), the rows
taken with the slot stride the layer gives them and the starts as int32 or
int64, so nothing is cast or copied before it.  A CPU tensor goes to the
plain indexed assignment.  The kernel drops a write whose start lies
outside [0, S); the plain version raises on it.
"""

from __future__ import annotations

import ctypes

import torch

from vlut_tpu_torch.ops import _build, counted

_P = ctypes.c_void_p
MAX_ARRAYS = 4  # csrc/kv_update.cu kMaxArrays


def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_update.cu")
    if not getattr(lib, "_vlut_typed", False):
        lib.vlut_write_rows.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P]
        lib.vlut_write_rows.restype = ctypes.c_int
        lib._vlut_typed = True
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _write_plain(cache: torch.Tensor, u: torch.Tensor,
                 start: torch.Tensor) -> None:
    b, s = cache.shape[:2]
    st = start.long()
    if bool(((st < 0) | (st >= s)).any()):
        raise IndexError(f"a start lies outside [0, {s}): {st.tolist()}")
    cache[torch.arange(b, device=cache.device), st] = u[:, 0].to(cache.dtype)


def _slot_stride(c: torch.Tensor, u: torch.Tensor) -> int:
    """The slot stride of the rows ``u`` (B, 1, *trail) of cache ``c``
    (B, S, *trail): same type and device, trailing dims contiguous."""
    b, trail = c.shape[0], tuple(c.shape[2:])
    ok = (tuple(u.shape) == (b, 1) + trail and u.dtype == c.dtype
          and u.device == c.device and c.is_contiguous())
    step = 1
    for dim in range(u.dim() - 1, 1, -1):
        ok = ok and (u.shape[dim] == 1 or u.stride(dim) == step)
        step *= u.shape[dim]
    if not ok:
        raise ValueError(
            f"rows {tuple(u.shape)} {u.dtype} strides {u.stride()} do not "
            f"fit the contiguous cache {tuple(c.shape)} {c.dtype}")
    return u.stride(0)


def _launch(caches, rows, start, lib=None) -> None:
    """One kernel call for up to four arrays of one layer; ``lib``
    overrides the build (studies, tests)."""
    b, s = caches[0].shape[:2]
    n = len(caches)
    if not 0 < n <= MAX_ARRAYS or len(rows) != n:
        raise ValueError(f"1 to {MAX_ARRAYS} caches, one row each")
    lds, nbytes = [], []
    for c, u in zip(caches, rows):
        if c.shape[:2] != (b, s):
            raise ValueError("the caches must share (B, S)")
        lds.append(_slot_stride(c, u) * u.element_size())
        nbytes.append(c[0, 0].numel() * c.element_size())
    if (start.shape != (b,) or start.dtype not in (torch.int32, torch.int64)
            or start.stride(0) != 1 or start.device != caches[0].device):
        raise ValueError("start must be a contiguous (B,) int32 or int64 on "
                         "the caches' device")
    arr = ctypes.c_void_p * n
    lng = ctypes.c_long * n
    err = (lib or _lib()).vlut_write_rows(
        n, arr(*[c.data_ptr() for c in caches]),
        arr(*[u.data_ptr() for u in rows]), lng(*lds), lng(*nbytes),
        start.data_ptr(), int(start.dtype == torch.int64), b, s, _stream())
    _build.check(err, "vlut_write_rows")


def write_rows_pair(kc: torch.Tensor, vc: torch.Tensor, ku: torch.Tensor,
                    vu: torch.Tensor, start: torch.Tensor, scales=None):
    """kc/vc (B, S, H, D) caches, ku/vu (B, 1, H, D) rows of the caches'
    type (any slot stride, trailing dims contiguous), start (B,) int32 or
    int64: writes both rows of every slot, in place; returns (kc, vc).
    ``scales`` = (k_scale cache, v_scale cache, k row scales, v row scales),
    (B, S, H) and (B, 1, H) float32, the int8 cache's scale planes, written
    in the same launch."""
    caches = (kc, vc) + tuple(scales[:2] if scales is not None else ())
    rows = (ku, vu) + tuple(scales[2:] if scales is not None else ())
    if not kc.is_cuda:
        for c, u in zip(caches, rows):
            _write_plain(c, u, start)
        return kc, vc
    _launch(caches, rows, start)
    write_rows_pair.launches += 1
    return kc, vc


def write_rows(cache: torch.Tensor, u: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
    """One-array form of :func:`write_rows_pair` (same kernel, same launch
    counter); in place; returns cache."""
    if not cache.is_cuda:
        _write_plain(cache, u, start)
        return cache
    _launch((cache,), (u,), start)
    write_rows_pair.launches += 1
    return cache


counted(write_rows_pair)
