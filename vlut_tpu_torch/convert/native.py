"""ctypes bindings of the host pack / ternarize library (port of
vlut_tpu/convert/native.py).

``csrc/vlut_pack.cpp`` is compiled by ``g++`` at first use into the
repository's ``build/`` directory (``ops/_build.py``: named by a hash of the
source and flags, written to a temporary file and renamed, so processes
that build it at once load one library).  Numpy in, numpy out; bit-identical
to ``ops/packing.py`` (tests/test_torch_native.py).

Unlike the JAX module there is no numpy fallback: a failed build raises
``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from vlut_tpu_torch.ops import _build

SOURCE = "vlut_pack.cpp"
_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load(SOURCE)
            i64 = ctypes.c_int64
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.vlut_pack_i2.argtypes = [i8p, u8p, i64, i64, i64]
            lib.vlut_pack_i1.argtypes = [i8p, u8p, i64, i64, i64]
            lib.vlut_unpack_i2.argtypes = [u8p, i8p, i64, i64, i64]
            lib.vlut_unpack_i1.argtypes = [u8p, i8p, i64, i64, i64]
            for f in (lib.vlut_pack_i2, lib.vlut_pack_i1, lib.vlut_unpack_i2,
                      lib.vlut_unpack_i1):
                f.restype = None
            lib.vlut_ternarize_absmean.argtypes = [f32p, i8p, i64]
            lib.vlut_ternarize_absmean.restype = ctypes.c_float
            lib.vlut_detect_ternary.argtypes = [f32p, i64]
            lib.vlut_detect_ternary.restype = ctypes.c_float
            _lib = lib
        return _lib


def pack(trits_padded: np.ndarray, fmt: str, kb: int) -> np.ndarray:
    """(kp, n) padded trits (kp a multiple of kb) -> (kp / r, n) uint8."""
    kp, n = trits_padded.shape
    r = 4 if fmt == "i2" else 5
    out = np.empty((kp // r, n), np.uint8)
    trits_padded = np.ascontiguousarray(trits_padded, np.int8)
    lib = get_lib()
    fn = lib.vlut_pack_i2 if fmt == "i2" else lib.vlut_pack_i1
    fn(trits_padded, out, kp, n, kb)
    return out


def unpack(packed: np.ndarray, fmt: str, kb: int, kp: int) -> np.ndarray:
    """(kp / r, n) uint8 -> (kp, n) int8 trits."""
    n = packed.shape[1]
    out = np.empty((kp, n), np.int8)
    packed = np.ascontiguousarray(packed, np.uint8)
    lib = get_lib()
    fn = lib.vlut_unpack_i2 if fmt == "i2" else lib.vlut_unpack_i1
    fn(packed, out, kp, n, kb)
    return out


def ternarize_absmean(w: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """BitNet absmean: (trits of w's shape, scale = mean |w| over the
    nonzero entries)."""
    w = np.ascontiguousarray(w, np.float32)
    trits = np.empty(w.size, np.int8)
    scale = get_lib().vlut_ternarize_absmean(w.reshape(-1), trits, w.size)
    return trits.reshape(w.shape), np.float32(scale)


def detect_ternary(w: np.ndarray) -> float:
    """s > 0 where w's values are {-s, 0, s} (within 1e-4 relative), 0.0
    where all are zero, -1.0 otherwise."""
    w = np.ascontiguousarray(w, np.float32)
    return float(get_lib().vlut_detect_ternary(w.reshape(-1), w.size))
