"""Build and load the port's CUDA kernels and its host library.

Each source in ``vlut_tpu_torch/csrc/`` with a plain C interface is compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/`` directory, at first use, and loaded with ``ctypes``.
A library is named by a hash of its sources and flags, so an edited kernel
is rebuilt and an unchanged one is reused.  The host packer
(``vlut_pack.cpp``, :data:`HOST_SOURCES`) is compiled the same way by
``g++`` (:data:`GXX_FLAGS`).  A build writes a temporary file and renames
it, so processes that build one library at once load a whole one.
:func:`build_all` starts one compiler per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
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
# the host library (convert/native.py) and its flags, as the JAX package's
# convert/native.py builds its copy; -march=native ties the library to the
# host's CPU, so its name hashes that CPU too (_host_cpu)
HOST_SOURCES = ("vlut_pack.cpp",)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
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


@functools.cache
def _host_cpu() -> str:
    """The host CPU's identity (its model and feature flags where Linux
    lists them), which ``-march=native`` builds for."""
    ident = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's entry is enough
                if line.split(":", 1)[0].strip() in ("model name", "flags",
                                                     "Features"):
                    ident.append(line)
    except OSError:
        pass
    return "".join(ident)


def _lib_path(source: str, build_dir: pathlib.Path = BUILD_DIR
              ) -> pathlib.Path:
    host = source in HOST_SOURCES
    flags = GXX_FLAGS if host else NVCC_FLAGS + SOURCE_FLAGS.get(source, ())
    h = hashlib.sha256(" ".join(flags).encode())
    if host:
        h.update(_host_cpu().encode())
    for f in [CSRC / source] if host else sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str, build_dir: pathlib.Path = BUILD_DIR):
    """Start the compiler for one source unless its library exists;
    returns (library path, temporary output path, process or None)."""
    out = _lib_path(source, build_dir)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if out.exists():
        return out, tmp, None
    build_dir.mkdir(parents=True, exist_ok=True)
    if source in HOST_SOURCES:
        cmd = [shutil.which("g++") or "g++", *GXX_FLAGS, str(CSRC / source),
               "-o", str(tmp)]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, *SOURCE_FLAGS.get(source, ()), "-I",
               str(CSRC), "-o", str(tmp), str(CSRC / source)]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} could not start for {source}: {e}")
    return out, tmp, proc


def _finish(source: str, out: pathlib.Path, tmp: pathlib.Path,
            proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{pathlib.Path(proc.args[0]).name} failed for "
                           f"{source}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every source in parallel (one compiler each); returns the
    compiler's output per source (register and shared-memory use)."""
    sources = SOURCES + HOST_SOURCES
    with _lock:
        started = {s: _start(s) for s in sources}
        logs = {s: _finish(s, *started[s]) for s in sources}
    for s in sources:
        load(s)
    return logs


def _compiled(source: str, build_dir: pathlib.Path = BUILD_DIR
              ) -> pathlib.Path:
    out, tmp, proc = _start(source, build_dir)
    _finish(source, out, tmp, proc)
    return out


def build(source: str, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """The library of one source under ``build_dir``, compiled first if it
    is not there."""
    with _lock:
        return _compiled(source, build_dir)


def load(source: str) -> ctypes.CDLL:
    """The loaded library for one source, building it first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(_compiled(source)))
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
