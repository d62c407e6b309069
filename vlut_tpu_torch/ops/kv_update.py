"""KV-cache row writes (port of vlut_tpu/ops/kv_update.py).

:func:`write_rows_pair` writes the K and V row of every slot b into
``cache[b, start[b]]`` and :func:`write_rows` does the same for one array.
Both update the caches IN PLACE and return them (the JAX package gets the
same effect through buffer donation).  A CUDA tensor goes to the kernel in
``csrc/kv_update.cu`` (one kernel serves both forms); a CPU tensor goes to
the plain indexed assignment.  The kernel drops a write whose start lies
outside [0, S); the plain version raises on it.
"""

from __future__ import annotations

import ctypes

import torch

from vlut_tpu_torch.ops import _build

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_update.cu")
    if not getattr(lib, "_vlut_typed", False):
        lib.vlut_write_rows.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_long, _P]
        lib.vlut_write_rows.restype = ctypes.c_int
        lib._vlut_typed = True
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _write_plain(cache: torch.Tensor, u: torch.Tensor,
                 start: torch.Tensor) -> None:
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), start.long()] = u[:, 0].to(
        cache.dtype)


def _launch(kc, vc, ku, vu, start) -> None:
    b, s = kc.shape[:2]
    for c, u in ((kc, ku), (vc, vu)):
        if c is None:
            continue
        if not (c.is_contiguous() and u.is_contiguous()):
            raise ValueError("cache and rows must be contiguous")
        if (u.shape != (b, 1) + c.shape[2:] or u.dtype != c.dtype
                or u.device != c.device):
            raise ValueError(f"row {tuple(u.shape)} {u.dtype} does not fit "
                             f"cache {tuple(c.shape)} {c.dtype}")
    start = start.to(device=kc.device, dtype=torch.int32).contiguous()
    if start.shape != (b,):
        raise ValueError("start must be (B,)")
    row_bytes = kc[0, 0].numel() * kc.element_size()
    err = _lib().vlut_write_rows(
        kc.data_ptr(), vc.data_ptr() if vc is not None else None,
        ku.data_ptr(), vu.data_ptr() if vu is not None else None,
        start.data_ptr(), b, s, row_bytes, _stream())
    _build.check(err, "vlut_write_rows")


def write_rows_pair(kc: torch.Tensor, vc: torch.Tensor, ku: torch.Tensor,
                    vu: torch.Tensor, start: torch.Tensor):
    """kc/vc (B, S, H, D) caches, ku/vu (B, 1, H, D) rows, start (B,):
    writes both rows of every slot in one launch, in place; returns
    (kc, vc)."""
    if not kc.is_cuda:
        _write_plain(kc, ku, start)
        _write_plain(vc, vu, start)
        return kc, vc
    if not vc.is_cuda:
        raise ValueError("kc and vc must lie on one device")
    _launch(kc, vc, ku.to(kc.dtype).contiguous(), vu.to(vc.dtype).contiguous(),
            start)
    write_rows_pair.launches += 1
    return kc, vc


def write_rows(cache: torch.Tensor, u: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
    """One-array form of :func:`write_rows_pair` (same kernel, same launch
    counter); in place; returns cache."""
    if not cache.is_cuda:
        _write_plain(cache, u, start)
        return cache
    _launch(cache, None, u.to(cache.dtype).contiguous(), None, start)
    write_rows_pair.launches += 1
    return cache


write_rows_pair.launches = 0
