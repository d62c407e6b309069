"""A study of the tiled GEMM (TPU kernel #3, ``csrc/ternary_gemm.cu``) on
the card: where its time goes and what each design step bought.

    python -m vlut_tpu_torch.bench.tiled_study [--variant NAME=DIR ...]
        [--ablate] [--sweep] [--timeline]

It builds the checked-out kernel, holds it bit-exact against its plain
version at shapes that take every tile and split of K, then prints one JSON
line per measurement (device time of a CUDA graph of calls, weights rotated
past the L2 at the bench lanes):

* the bench lanes (llama3_8b dxd, dxff, ffxd at M 32 and 256, i2 and i1)
  and the flagship prefill's four projections at M 4096, for the current
  kernel and each ``--variant`` in turns (variant, kernel, kernel,
  variant).  A variant is a directory holding another ``ternary_gemm.cu``
  (and the headers it includes), for instance the parent commit's
  ``vlut_tpu_torch/csrc`` unpacked by ``git archive``; a source without
  ``vlut_tiled_init`` is called through the first port's interface (one
  128 x 128 tile, no plan).
* ``--ablate``: the current kernel without the trit decode, without the
  mma, and without both (copies and fragment loads only), at the i2 lanes
  and the qkv projection; built from the checked-out source by text edits.
  Their outputs are wrong by design and are not checked.
* ``--sweep``: every (BM, BN, splits) at the i2 lanes, against the
  plan's choice.
* ``--timeline``: clock64 stamps of thread 0 of the first 64 blocks at the
  stage loop's points (top, stage landed, barrier passed, next copies
  asked for), from an instrumented build.

The builds go to ``build/study/`` (gitignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from vlut_tpu_torch.ops import _build, ternary_gemm as tg
from vlut_tpu_torch.ops.packing import (
    DEFAULT_BLOCK,
    TRITS_PER_BYTE,
    padded_k,
    random_packed_bytes,
)

STUDY = _build.BUILD_DIR / "study"
LANES = [(tag, m, k, n) for tag, k, n in (("dxd", 4096, 4096),
                                          ("dxff", 4096, 14336),
                                          ("ffxd", 14336, 4096))
         for m in (32, 256)]
PREFILL = (("qkv", 4096, 6144), ("wo", 4096, 4096), ("gateup", 4096, 28672),
           ("down", 14336, 4096))
CHECK_SHAPES = [(1, 1280, 384), (32, 1280, 384), (65, 1000, 256),
                (200, 1283, 384), (256, 640, 128), (513, 1280, 384),
                (7, 300, 130), (32, 4096, 4096), (256, 4096, 14336),
                (32, 14336, 4096), (512, 4096, 6144), (20, 4096, 28672),
                (300, 4096, 28672), (700, 3840, 2432)]

# text edits of the checked-out source: (old, new) pairs per variant
_DECODE = [
    ("if (dec) decode_load<BN>(sraw + ((i + 1) % R) * C::kRawBytes, tid, w);",
     ""),
    ("for (int e = 0; e < 4; ++e) decode_column<BN, I1>(w, tid, e, bnext);",
     ""),
    ("if (r < 4 && dec) decode_column<BN, I1>(w, tid, r, bnext);", ""),
]
_MMA = [
    ("mma_s8(acc[mt][nt], a[h][mt], h ? bv[nt].z : bv[nt].x,\n"
     "                       h ? bv[nt].w : bv[nt].y);",
     "acc[mt][nt][0] += a[h][mt][nt & 3] ^ (h ? bv[nt].z : bv[nt].x);"),
    ("mma_s8(acc[mt][nt], a[mt], h ? bv[nt].z : bv[nt].x,\n"
     "                     h ? bv[nt].w : bv[nt].y);",
     "acc[mt][nt][0] += a[mt][nt & 3] ^ (h ? bv[nt].z : bv[nt].x);"),
]
ABLATIONS = {"nodec": _DECODE, "nomma": _MMA, "copyonly": _DECODE + _MMA}
_REC = ("__device__ __forceinline__ void rec(int slot) {\n"
        "  const int b = blockIdx.x + blockIdx.y * gridDim.x + blockIdx.z * "
        "gridDim.x * gridDim.y;\n"
        "  if (threadIdx.x == 0 && b < 64) g_dbg[b * 256 + slot] = clock64();\n"
        "}\n")
TIMELINE = [
    ("namespace {\n\nusing vlut::kSlab;",
     "__device__ long long g_dbg[64 * 256];\nnamespace {\n\n"
     "using vlut::kSlab;"),
    ("template <int BM, int BN, bool I1>\n__global__ void __launch_bounds__("
     "kTiledThreads,\n",
     _REC + "template <int BM, int BN, bool I1>\n__global__ void "
     "__launch_bounds__(kTiledThreads,\n"),
    ("    if (i + 1 < ns) landed(i + 1);\n    __syncthreads();",
     "    rec(4 * i);\n    if (i + 1 < ns) landed(i + 1);\n"
     "    rec(4 * i + 1);\n    __syncthreads();\n    rec(4 * i + 2);"),
    ("    load(i + R - 1);\n", "    load(i + R - 1);\n    rec(4 * i + 3);\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint vlut_dbg_read(void* host) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_dbg, "
     "sizeof(g_dbg)));\n}\n"),
]


def variant_source(name: str, edits, source: str = "ternary_gemm.cu"
                   ) -> pathlib.Path:
    """A directory under ``build/study`` holding ``source`` of the checkout
    with the text ``edits`` applied (each (old, new) must be found), and the
    headers it includes."""
    d = STUDY / name
    d.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, d)
    src = (_build.CSRC / source).read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new, 1)
    (d / source).write_text(src)
    return d


def compile_variants(dirs: dict[str, pathlib.Path],
                     source: str) -> dict[str, ctypes.CDLL]:
    """Builds ``source`` of every directory in parallel (one nvcc each) and
    loads the libraries."""
    lib = pathlib.Path(source).stem + ".so"
    procs = {v: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
         str(d / lib), str(d / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, d in dirs.items()}
    libs = {}
    for v, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        libs[v] = ctypes.CDLL(str(dirs[v] / lib))
    return libs


def _build_variants(dirs: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    libs = compile_variants(dirs, "ternary_gemm.cu")
    for v, lib in libs.items():
        lib.vlut_tiled_gemm.restype = ctypes.c_int
        if hasattr(lib, "vlut_tiled_init"):
            lib.vlut_tiled_gemm.argtypes = tg._lib().vlut_tiled_gemm.argtypes
            _build.check(lib.vlut_tiled_init(), f"{v} vlut_tiled_init")
            lib.planned = True
        else:
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
            lib.vlut_tiled_gemm.argtypes = [P, L, I, P, P, P, I, I, I, I, I,
                                            P, I, P]
            lib.planned = False
    return libs


class Case:
    """One GEMM's inputs on the card; ``rotate`` keeps copies of the weight
    past the L2 and cycles them."""

    def __init__(self, gen, m, k, n, fmt, rotate):
        dev = gen.device
        self.m, self.k, self.n, self.fmt = m, k, n, fmt
        self.kb, self.kp = DEFAULT_BLOCK[fmt], padded_k(k, fmt)
        p = random_packed_bytes((self.kp // TRITS_PER_BYTE[fmt], n), fmt,
                                gen, dev)
        extra = -(-(128 << 20) // p.numel()) - 1 if rotate else 0
        self.copies = [p] + [p.clone() for _ in range(max(0, extra))]
        self.xq = torch.randint(-100, 100, (m, k), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
        self.xs = torch.ones((m, 1), device=dev)
        self.ws = torch.ones((n,), device=dev)
        self.i = 0

    def call(self, lib=None, plan=None):
        """A function of no arguments running one GEMM on the next weight
        copy: the wrapper, or ``lib`` (a variant) with ``plan``."""
        def run():
            self.i = (self.i + 1) % len(self.copies)
            return self.run(self.copies[self.i], lib, plan)
        return run

    def run(self, packed, lib=None, plan=None):
        m, n = self.m, self.n
        if lib is None and plan is None:
            return tg.ternary_gemm_tiled(self.xq, packed, self.xs, self.ws,
                                         fmt=self.fmt, kb=self.kb, k=self.k)
        lib = lib or tg._lib()
        out = torch.empty((m, n), device=self.xq.device)
        stream = torch.cuda.current_stream().cuda_stream
        args = (self.xq.data_ptr(), self.xq.stride(0), self.k,
                self.xs.data_ptr(), packed.data_ptr(), self.ws.data_ptr(), m,
                self.kp, n, self.kb, int(self.fmt == "i1"))
        if not getattr(lib, "planned", True):
            err = lib.vlut_tiled_gemm(*args, out.data_ptr(), 0, stream)
        else:
            bm, bn, splits = plan or tg.tiled_plan(m, n, self.kp, self.fmt,
                                                   tg.sm_count(0))
            work = None
            if splits > 1:
                work = torch.zeros((m * n + n // bn * -(-m // bm),),
                                   dtype=torch.int32, device=out.device)
            err = lib.vlut_tiled_gemm(
                *args, bm, bn, splits, work.data_ptr() if work is not None
                else None, out.data_ptr(), 0, stream)
        _build.check(err, "vlut_tiled_gemm")
        return out

    def exact(self, fn) -> bool:
        want = tg._gemm_plain(self.xq, self.xs, self.copies[0], self.ws,
                              self.fmt, self.kb, self.k, None, torch.float32)
        self.i = len(self.copies) - 1  # the next call takes copies[0]
        return torch.equal(fn(), want)


def graph_us(fn, iters: int) -> float:
    """Best of three replays of a CUDA graph of ``iters`` calls, in us per
    call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e) * 1e3 / iters)
    return best


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "tiled_study", description=__doc__.split(
                                     "\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of another ternary_gemm.cu")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tiled_study: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = {}
    for spec in args.variant:
        name, _, d = spec.partition("=")
        dirs[name] = pathlib.Path(d)
    ablations = list(ABLATIONS) if args.ablate else []
    for name in ablations:
        dirs[name] = variant_source(name, ABLATIONS[name])
    if args.timeline:
        dirs["timeline"] = variant_source("timeline", TIMELINE)
    _build.build_all()
    libs = _build_variants(dirs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    emit(card=card, variants=sorted(dirs))

    bad = 0
    for fmt in ("i2", "i1"):
        for m, k, n in CHECK_SHAPES:
            c = Case(gen, m, k, -(-n // 128) * 128, fmt, rotate=False)
            ok = c.exact(c.call())
            bad += not ok
            if not ok:
                emit(mismatch=[m, k, n, fmt])
    emit(checked=2 * len(CHECK_SHAPES), mismatches=bad)
    if bad:
        return 1

    others = [v for v in libs if v not in ABLATIONS and v != "timeline"]
    for fmt in ("i2", "i1"):
        for tag, m, k, n in LANES:
            c = Case(gen, m, k, n, fmt, rotate=True)
            row = {"lane": tag, "m": m, "fmt": fmt,
                   "plan": tg.tiled_plan(m, n, c.kp, fmt, tg.sm_count(0))}
            for v in others:  # in turns: variants, kernel twice, variants
                if not c.exact(c.call(libs[v])):
                    emit(mismatch=[v, tag, m, fmt])
                    return 1
                row[v] = [graph_us(c.call(libs[v]), 20)]
            row["kernel"] = [graph_us(c.call(), 20), graph_us(c.call(), 20)]
            for v in reversed(others):
                row[v].append(graph_us(c.call(libs[v]), 20))
            if fmt == "i2":
                for v in ablations:
                    row[v] = graph_us(c.call(libs[v]), 20)
            emit(**row, card=card)
    total = {}
    for label, k, n in PREFILL:
        c = Case(gen, 4096, k, n, "i2", rotate=False)
        row = {"prefill": label, "m": 4096}
        row["kernel_ms"] = graph_us(c.call(), 5) / 1e3
        for v in others:
            row[f"{v}_ms"] = graph_us(c.call(libs[v]), 5) / 1e3
        row["kernel_ms"] = min(row["kernel_ms"], graph_us(c.call(), 5) / 1e3)
        if label == "qkv":
            for v in ablations:
                row[f"{v}_ms"] = graph_us(c.call(libs[v]), 5) / 1e3
        for key in row:
            if key.endswith("_ms"):
                total[key] = total.get(key, 0.0) + row[key]
        emit(**row, card=card)
        del c
        torch.cuda.empty_cache()
    emit(prefill_sum=total, card=card)

    if args.sweep:
        for tag, m, k, n in LANES:
            c = Case(gen, m, k, n, "i2", rotate=True)
            nb = c.kp // c.kb
            res = {f"{bm}x{bn}x{s}": graph_us(c.call(tg._lib(), (bm, bn, s)),
                                                20)
                   for bm, bn in ((32, 128), (64, 128), (128, 128), (128, 256))
                   for s in (1, 2, 4, 7, 8, 16)
                   if nb % s == 0 and (s == 1 or nb // s >= 2)}
            emit(sweep=tag, m=m,
                 plan=tg.tiled_plan(m, n, c.kp, "i2", tg.sm_count(0)),
                 us=res, card=card)

    if args.timeline:
        lib = libs["timeline"]
        for tag, m, k, n in LANES[:2] + [("qkv", 4096, 4096, 6144)]:
            c = Case(gen, m, k, n, "i2", rotate=False)
            plan = tg.tiled_plan(m, n, c.kp, "i2", tg.sm_count(0))
            c.run(c.copies[0], lib, plan)
            torch.cuda.synchronize()
            buf = np.zeros(64 * 256, np.int64)
            _build.check(lib.vlut_dbg_read(buf.ctypes.data), "vlut_dbg_read")
            stamps = buf.reshape(64, 256)[0]
            ns = -(-(c.kp // c.kb // plan[2]) // 2)
            it = (stamps[:4 * min(ns, 32)] - stamps[0]).reshape(-1, 4)
            emit(timeline=tag, m=m, plan=plan,
                 cycles_top_landed_synced_asked=it.tolist(), card=card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
