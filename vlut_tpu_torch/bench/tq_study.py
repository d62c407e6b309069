"""A study of the TQ2_0/TQ1_0 GEMM (TPU kernel #9, ``csrc/tq_gemm.cu``) on
the card: what each design step bought and which tile each lane wants.

    python -m vlut_tpu_torch.bench.tq_study [--variant NAME=DIR ...]
        [--ablate] [--sweep] [--timeline] [--check-only]

It builds the checked-out kernel, holds it bit-exact against
``tq_gemm_plain`` at shapes that take every tile of the kernel with one
split and with several (even and uneven), ragged M and N, and bk 256 to
2048 (``--check-only`` stops there), then prints one JSON line per
measurement (device time of a CUDA graph of calls, weights rotated past
the L2, bk 2048 as ``bench`` takes):

* the fixed cost of a call (one block walking one K block) beside one
  small PyTorch op;
* the bench lanes (llama3_8b dxd, dxff, ffxd at M 32 and 256, tq2 and
  tq1) for the current kernel and each ``--variant`` in turns (variant,
  kernel, kernel, variant), beside one float16 ``torch.matmul`` of the
  codes and the weight dequantized beforehand.  A variant is a directory
  holding another ``tq_gemm.cu`` of the same interface (and the headers
  it includes), for instance the parent commit's ``vlut_tpu_torch/csrc``
  unpacked by ``git archive``.
* ``--ablate``: the current kernel without the x copies, without the
  weight copies, without the decode, without the mma, at the tq2 lanes;
  built from the checked-out source by text edits (they fail loudly when
  the kernel's lines change).  Their outputs are wrong by design and are
  not checked.
* ``--sweep``: every (BM, BN, splits) of the kernel at the lanes, against
  the plan's choice.
* ``--timeline``: clock64 stamps of thread 0 of the first 64 blocks at the
  K loop's points (top, next stage landed, barrier passed, rounds done)
  and the global timer of every block at its entry and at the end of its
  K loop, from an instrumented build, at the tq2 lanes.

The builds go to ``build/`` (gitignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

from vlut_tpu_torch.bench.kernels import rand_packed
from vlut_tpu_torch.bench.tiled_study import (
    compile_variants, emit, graph_us, variant_source)
from vlut_tpu_torch.ops import _build, tq

LANES = [(tag, m, k, n) for tag, k, n in (("dxd", 4096, 4096),
                                          ("dxff", 4096, 14336),
                                          ("ffxd", 14336, 4096))
         for m in (32, 256)]
# text edits of the checked-out source: (old, new) pairs per ablation
_BYTES = ("mbar_arrive_expect(bar, C::kXBytes + C::kRpb * BN + 2 * BN);",)
ABLATIONS = {
    "nox": [(_BYTES[0], "mbar_arrive_expect(bar, C::kRpb * BN + 2 * BN);"),
            ("    tma_load_2d(dx, &tmx, b * kQK, m0, bar);\n"
             "    tma_load_2d(dx + BM * 128, &tmx, b * kQK + 128, m0, bar);\n",
             "")],
    "now": [(_BYTES[0], "mbar_arrive_expect(bar, C::kXBytes + 2 * BN);"),
            ("    tma_load_2d(dx + C::kXBytes, &tmw, n0, b * C::kRpb, bar);\n",
             "")],
    "nodec": [("          tq2_store<BN, C::kTrits>(w, u2, qp, bnext);", ""),
              ("            tq1_unit<BN, C::kTrits>(sraw(i + 1), tid + kThreads * qp,\n"
               "                                    reinterpret_cast<uint32_t*>(bnext));",
               "")],
    "nomma": [("            mma<C::kTrits>(acc[mt][nt], a[h][mt], h ? bv[nt].z : bv[nt].x,\n"
               "                           h ? bv[nt].w : bv[nt].y);",
               "            acc[mt][nt][0] += a[h][mt][nt & 3] ^ "
               "(h ? bv[nt].z : bv[nt].x);")],
}


_REC = ("__device__ __forceinline__ void rec(int slot) {\n"
        "  const int b = blockIdx.x + blockIdx.y * gridDim.x + blockIdx.z * "
        "gridDim.x * gridDim.y;\n"
        "  if (threadIdx.x == 0 && b < 64) g_dbg[b * 256 + slot] = clock64();\n"
        "}\n"
        "__device__ __forceinline__ void span(int which) {\n"
        "  const int b = blockIdx.x + blockIdx.y * gridDim.x + blockIdx.z * "
        "gridDim.x * gridDim.y;\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  if (threadIdx.x == 0 && b < 4096) g_span[b * 2 + which] = t;\n"
        "}\n")
# clock64 stamps of thread 0 of the first 64 blocks: before the ring's
# first stage landed (slot 0), after stage 0's decode (1), and per K block
# i at slots 4 + 4i..: loop top, stage i + 1 landed, barrier passed,
# rounds done (before the float chain); and the global timer (ns) of every
# block at its entry and at the end of its K loop
TIMELINE = [
    ("namespace {\n\nconstexpr int kQK = 256;",
     "__device__ long long g_dbg[64 * 256];\n"
     "__device__ unsigned long long g_span[4096 * 2];\nnamespace {\n\n"
     "constexpr int kQK = 256;"),
    ("template <int BM, int BN, bool TQ1>\n__global__ void __launch_bounds__(",
     _REC + "template <int BM, int BN, bool TQ1>\n__global__ void "
     "__launch_bounds__("),
    ("  extern __shared__ __align__(1024) uint8_t smem[];\n  uint4* sb",
     "  span(0);\n  extern __shared__ __align__(1024) uint8_t smem[];\n"
     "  uint4* sb"),
    ("  landed(0);\n  if constexpr (TQ1) {",
     "  rec(0);\n  landed(0);\n  if constexpr (TQ1) {"),
    ("  int acc[MT][NT][4], rs[MT][4];", "  rec(1);\n  int acc[MT][NT][4], rs[MT][4];"),
    ("    if (i + 1 < ns) landed(i + 1);\n    __syncthreads();",
     "    rec(4 + 4 * i);\n    if (i + 1 < ns) landed(i + 1);\n"
     "    rec(5 + 4 * i);\n    __syncthreads();\n    rec(6 + 4 * i);"),
    ("    // the float chain of K block b0 + i",
     "    rec(7 + 4 * i);\n    // the float chain of K block b0 + i"),
    ("  if (splits > 1) {\n    // thread 0's acquire-release add",
     "  span(1);\n  if (splits > 1) {\n    // thread 0's acquire-release add"),
    ('extern "C" {\n',
     'extern "C" {\n\nint vlut_dbg_read(void* host, void* span) {\n'
     "  cudaMemcpyFromSymbol(span, g_span, sizeof(g_span));\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_dbg, "
     "sizeof(g_dbg)));\n}\n"),
]


def _build_variants(dirs: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    libs = compile_variants(dirs, "tq_gemm.cu")
    for v, lib in libs.items():
        lib.vlut_tq_gemm.restype = lib.vlut_tq_init.restype = ctypes.c_int
        lib.vlut_tq_gemm.argtypes = tq._lib().vlut_tq_gemm.argtypes
        _build.check(lib.vlut_tq_init(), f"{v} vlut_tq_init")
    return libs


class Case:
    """One GEMM's inputs on the card; ``rotate`` keeps copies of the weight
    past the L2 and cycles them."""

    def __init__(self, gen, fmt, m, k, n, bk, rotate):
        dev = gen.device
        self.fmt, self.bk = fmt, bk
        p = rand_packed(fmt, k, n, gen, dev)
        self.scales = (torch.rand((k // tq.QK, n), generator=gen, device=dev)
                       * 0.6 + 0.3).to(torch.float16)
        extra = -(-(128 << 20) // p.numel()) - 1 if rotate else 0
        self.copies = [p] + [p.clone() for _ in range(max(0, extra))]
        # codes near 127 make block dots whose products with an fp16
        # scale round in float32, so the order of the float sum shows
        self.xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
        self.xq[: m // 2] = self.xq[: m // 2].abs()
        self.xs = torch.rand((m, 1), generator=gen, device=dev) * 0.01
        self.i = 0

    def run(self, packed, lib=None, plan=None):
        return tq._tq_cuda(self.xq, packed, self.scales, self.xs, self.fmt,
                           self.bk, torch.float32, plan=plan, lib=lib)

    def call(self, lib=None, plan=None):
        def run():
            self.i = (self.i + 1) % len(self.copies)
            return self.run(self.copies[self.i], lib, plan)
        return run

    def want(self):
        return tq.tq_gemm_plain(self.xq, self.copies[0], self.scales, self.xs,
                                fmt=self.fmt, bk=self.bk)

    def exact(self, lib=None, plan=None) -> bool:
        got = self.run(self.copies[0], lib, plan)
        return torch.equal(got, self.want())

    def fp16_call(self):
        """One float16 matmul of the codes and the weight dequantized to
        float16 beforehand (codes and scales are exact in float16)."""
        w = (tq.tq_trits(self.copies[0], self.fmt).to(torch.float16)
             * self.scales.repeat_interleave(tq.QK, dim=0))
        ws = [w] + [w.clone() for _ in range(-(-(128 << 20) // (2 * w.numel())) - 1)]
        xh = self.xq.to(torch.float16)
        state = {"i": 0}

        def run():
            state["i"] = (state["i"] + 1) % len(ws)
            return torch.matmul(xh, ws[state["i"]])
        return run


def splits_of(nk: int, bk: int) -> list[int]:
    return [1] if bk == tq.QK else sorted({1, 2, min(3, nk), nk} & set(
        range(1, nk + 1)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.tq_study",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of another tq_gemm.cu")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tq_study: needs a CUDA device", file=sys.stderr)
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
        dirs[name] = variant_source(name, ABLATIONS[name], "tq_gemm.cu")
    if args.timeline:
        dirs["timeline"] = variant_source("timeline", TIMELINE, "tq_gemm.cu")
    logs = _build.build_all()
    for line in logs["tq_gemm.cu"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"ptxas: {line.strip()}", flush=True)
    libs = _build_variants(dirs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sms = tq.sm_count(0)
    emit(card=card, sms=sms, variants=sorted(dirs))

    bad = checked = 0
    for fmt in ("tq2", "tq1"):
        for m, k, n, bk in tq.PLAN_SHAPES:
            c = Case(gen, fmt, m, k, n, bk, rotate=False)
            want = c.want()
            np_ = -(-n // 16) * 16
            plans = [None] + [(bm, bn, s) for bm, bn in tq.TILES
                              for s in splits_of(k // bk, bk)]
            for plan in plans:
                got = c.run(c.copies[0], plan=plan)
                checked += 1
                if not torch.equal(got, want):
                    bad += 1
                    emit(mismatch=[fmt, m, k, n, bk], plan=plan,
                         planned=tq.tq_plan(m, np_, k, bk, sms),
                         max_err=float((got - want).abs().max()),
                         bad_share=float((got != want).float().mean()))
            del c
    torch.cuda.synchronize()
    emit(checked=checked, mismatches=bad)
    if bad or args.check_only:
        return 1 if bad else 0

    # the fixed cost of a call: one block walking one K block, beside one
    # small PyTorch op in the same graph form
    tiny = Case(gen, "tq2", 1, 256, 64, 256, rotate=False)
    z = torch.zeros(64, device="cuda")
    emit(one_block_call_us=graph_us(tiny.call(), 20),
         torch_add_us=graph_us(lambda: z.add_(1.0), 20), card=card)

    for fmt in ("tq2", "tq1"):
        for tag, m, k, n in LANES:
            c = Case(gen, fmt, m, k, n, 2048, rotate=True)
            row = {"lane": tag, "m": m, "fmt": fmt,
                   "plan": tq.tq_plan(m, n, k, 2048, sms)}
            others = [v for v in libs if v not in ablations
                      and v != "timeline"]
            for v in others:  # in turns: variants, kernel twice, variants
                if not c.exact(libs[v]):
                    emit(mismatch=[v, tag, m, fmt])
                    return 1
                row[v] = [graph_us(c.call(libs[v]), 20)]
            row["kernel"] = [graph_us(c.call(), 20), graph_us(c.call(), 20)]
            for v in reversed(others):
                row[v].append(graph_us(c.call(libs[v]), 20))
            if fmt == "tq2":
                for v in ablations:
                    row[v] = graph_us(c.call(libs[v]), 20)
            row["fp16_matmul"] = graph_us(c.fp16_call(), 20)
            emit(**row, card=card)
            del c
            torch.cuda.empty_cache()

    if args.timeline:
        lib = libs["timeline"]
        for tag, m, k, n in LANES:
            c = Case(gen, "tq2", m, k, n, 2048, rotate=False)
            plan = tq.tq_plan(m, n, k, 2048, sms)
            us = graph_us(c.call(lib, plan), 20)
            c.run(c.copies[0], lib, plan)
            torch.cuda.synchronize()
            buf = np.zeros(64 * 256, np.int64)
            spans = np.zeros(4096 * 2, np.uint64)
            _build.check(lib.vlut_dbg_read(buf.ctypes.data, spans.ctypes.data),
                         "vlut_dbg_read")
            nblk = -(-n // plan[1]) * -(-m // plan[0]) * plan[2]
            sp = spans.reshape(-1, 2)[:nblk].astype(np.int64)
            sp -= sp[:, 0].min()
            st = buf.reshape(64, 256)[0]
            ns = k // 2048 // plan[2] * 8
            emit(timeline=tag, m=m, plan=plan, graph_us=us,
                 entry_ns_max=int(sp[:, 0].max()),
                 loop_end_ns_min_median_max=[int(sp[:, 1].min()),
                                             int(np.median(sp[:, 1])),
                                             int(sp[:, 1].max())],
                 prologue=int(st[1] - st[0]),
                 cycles_top_landed_synced_rounds=(
                     st[4:4 + 4 * ns] - st[0]).reshape(-1, 4).tolist(),
                 card=card)

    if args.sweep:
        for fmt in ("tq2", "tq1"):
            for tag, m, k, n in LANES:
                c = Case(gen, fmt, m, k, n, 2048, rotate=True)
                res = {f"{bm}x{bn}x{s}": graph_us(c.call(plan=(bm, bn, s)), 20)
                       for bm, bn in tq.TILES
                       for s in range(1, k // 2048 + 1)
                       if s == 1 or -(-n // bn) * -(-m // bm) * s <= sms}
                best = min(res, key=res.get)
                emit(sweep=tag, m=m, fmt=fmt,
                     plan=tq.tq_plan(m, n, k, 2048, sms), best=best, us=res,
                     card=card)
                del c
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
