"""Build and load the port's CUDA kernels.

Each source in ``vlut_tpu_torch/csrc/`` with a plain C interface is compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/`` directory, at first use, and loaded with ``ctypes``.
A library is named by a hash of its sources and flags, so an edited kernel
is rebuilt and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
SOURCES = ("decode_gemm.cu", "ternary_gemm.cu", "kv_update.cu",
           "decode_attention.cu", "tq_gemm.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags of one source: decode_attention.cu holds 44 kernel instances, whose
# optimizer and ptxas runs nvcc spreads over the host's threads (on the
# H100's 8-core host, 61.6 s alone without, 30.7 s with)
SOURCE_FLAGS = {"decode_attention.cu": ("-split-compile=0",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(source: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(source, ()))
                       .encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str):
    """Start nvcc for one source unless its library exists; returns
    (library path, temporary output path, process or None)."""
    out = _lib_path(source)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return out, tmp, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, *SOURCE_FLAGS.get(source, ()), "-I",
           str(CSRC), "-o", str(tmp), str(CSRC / source)]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(source: str, out: pathlib.Path, tmp: pathlib.Path,
            proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every source in parallel (one nvcc each); returns the
    compiler's output per source (register and shared-memory use)."""
    with _lock:
        started = {s: _start(s) for s in SOURCES}
        logs = {s: _finish(s, *started[s]) for s in SOURCES}
    for s in SOURCES:
        load(s)
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library for one source, building it first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            out, tmp, proc = _start(source)
            _finish(source, out, tmp, proc)
            lib = ctypes.CDLL(str(out))
            _libs[source] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
