"""A study of the small-M ternary projections (TPU kernels #1 and #4,
``csrc/decode_gemm.cu``) on the card: where a call's time goes and what
the plan picks.

    python -m vlut_tpu_torch.bench.decode_study [--variant NAME=DIR ...]
        [--ablate] [--timeline] [--sweep] [--check-only]

It builds the checked-out kernels and holds them bit-exact (prologue in
plain mode: the integer path) against their plain version at shapes that
take every kernel instantiation and split count of ``decode_plan``
(``ops/ternary_gemm.py:DECODE_PLAN_SHAPES``) as planned, with every
(BN, splits) forced at two shapes, and once through a CUDA graph
(``--check-only`` stops there).  Then it prints one JSON line per
measurement (device time of a CUDA graph of calls, weights rotated past the
L2):

* #1 at the flagship layer's four projections (qkv with the norm, wo plain
  with the residual, gate-up with the norm, down silu*up with the
  residual) and #4 at the unfused tree's six (plain), at M 1, 32 and 64:
  the whole call, the prologue alone and the GEMM alone (fed the
  prologue's output; with a split, after a memset of its workspace, timed
  apart), for the checked-out kernels and each ``--variant`` in
  turns (variant, kernel, kernel, variant), the host's dispatch of a call
  launched one by one from Python (``*_eager``, in turns too), and the
  column-major
  ``torch._int_mm`` of the codes and the unpacked trits.  A variant is a directory holding another
  ``decode_gemm.cu`` (and the headers it includes), or the parent's
  ``ternary_gemm.cu`` with its ``vlut_quant_prologue`` and
  ``vlut_decode_gemm`` (the first design: an A-fragment prologue and a GEMM
  of 32 columns per block).
* ``--ablate``: the GEMM without its mma (an XOR in its place) and without
  its epilogue loop, and the call without programmatic dependent launch
  (the GEMM's launch attribute dropped), built from the checked-out source
  by text edits (they fail loudly when the kernel's lines change), at
  every shape.
* ``--timeline``: the global timer of thread 0 of every block at its entry,
  its first stage landed, the end of its K loop, its K groups' sums in
  shared memory and (the block applying the epilogue) the splits' sums in
  and its end, from an
  instrumented build, for the GEMM alone at the #1 shapes (ns after the
  first block's entry: min / median / max over the blocks that reach it).
* ``--sweep``: every (BN, splits) at the flagship projections, M 1, 32 and
  64, against the plan's choice.

The builds go to ``build/study/`` (gitignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

from vlut_tpu_torch.bench.tiled_study import (
    compile_variants, emit, graph_us, variant_source)
from vlut_tpu_torch.ops import _build, ternary_gemm as tg
from vlut_tpu_torch.ops.packing import (
    DEFAULT_BLOCK,
    TRITS_PER_BYTE,
    padded_k,
    random_packed_bytes,
    unpack_fields,
)

# (label, K, N, mode, residual?) of #1 in a flagship layer, then #4's
FLAGSHIP = [("qkv", 4096, 6144, "norm", False), ("wo", 4096, 4096, "plain", True),
            ("gateup", 4096, 28672, "norm", False),
            ("down", 14336, 4096, "silu_mul", True)]
FUSED = [("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
         ("w_gate", 4096, 14336), ("w_up", 4096, 14336), ("w_down", 14336, 4096)]
MS = (1, 32, 64)
# text edits of the checked-out source: (old, new) pairs per ablation (none
# is checked: nomma's and noepi's outputs are wrong by design), and the part
# of a call each is timed as
ABLATIONS = {
    "nomma": [("for (int mt = 0; mt < MTL; ++mt) mma_s8u8(acc[mt][4 * l + e], "
               "a[mt], b0, b1);",
               "for (int mt = 0; mt < MTL; ++mt) acc[mt][4 * l + e][0] ^= "
               "a[mt][0] ^ b0 ^ b1;")],
    "noepi": [("    if (row < m) {\n      // the fields are the trits plus one",
               "    if (row < 0) {\n      // the fields are the trits plus one")],
    "nopdl": [("  cfg.numAttrs = 1;\n  return static_cast<int>(cudaLaunchKernelEx("
               "\n      &cfg, decode_gemm_kernel",
               "  cfg.numAttrs = 0;\n  return static_cast<int>(cudaLaunchKernelEx("
               "\n      &cfg, decode_gemm_kernel")],
}
ABLATED_PART = {"nomma": "gemm", "noepi": "gemm", "nopdl": "call"}
# the global timer of thread 0 of every block at its entry (0), when its
# first stage has landed (1), at the end of its K loop (2), when its K
# groups' sums are in shared memory (3) and, in the block that applies the
# epilogue, when the other splits' sums are in (4) and at its end (5)
_SPAN = ("__device__ __forceinline__ void span(int which) {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  const int b = blockIdx.x + blockIdx.y * gridDim.x;\n"
         "  if (threadIdx.x == 0 && b < 4096) g_span[b * 6 + which] = t;\n"
         "}\n")
TIMELINE = [
    ("namespace {\n\nusing vlut::kSlab;",
     "__device__ unsigned long long g_span[4096 * 6];\nnamespace {\n\n"
     "using vlut::kSlab;\n" + _SPAN),
    ("  auto stage = [&](int s) { return smem + (s % R) * C::kStage; };\n",
     "  auto stage = [&](int s) { return smem + (s % R) * C::kStage; };\n"
     "  span(0);\n"),
    ("      mbar_wait(&full[s % R], (s / R) & 1);\n",
     "      mbar_wait(&full[s % R], (s / R) & 1);\n      if (s == 0) span(1);\n"),
    ("  // the K groups meet in shared memory (the ring is free",
     "  span(2);\n  // the K groups meet in shared memory (the ring is free"),
    ("  constexpr int kStep = kGemmThreads / BN, kPer",
     "  span(3);\n  constexpr int kStep = kGemmThreads / BN, kPer"),
    ("  // the epilogue: every load asked for before any value is used (rows",
     "  span(4);\n  // the epilogue: every load asked for before any value is used (rows"),
    ("                  col, kStep);\n  }\n}\n\n",
     "                  col, kStep);\n  }\n  span(5);\n}\n\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint vlut_span_read(void* host) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_span, "
     "sizeof(g_span)));\n}\n"),
]
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float


def _build_variants(dirs: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    """Each variant's library: a ``decode_gemm.cu`` (typed as the checked-out
    one) or the parent's ``ternary_gemm.cu`` (``lib.parent``)."""
    parents = {v: d for v, d in dirs.items()
               if not (d / "decode_gemm.cu").exists()}
    libs = compile_variants(parents, "ternary_gemm.cu")
    libs.update(compile_variants({v: d for v, d in dirs.items()
                                  if v not in parents}, "decode_gemm.cu"))
    for v, lib in libs.items():
        lib.parent = v in parents
        if lib.parent:
            lib.vlut_quant_prologue.argtypes = [
                _P, _P, _L, _I, _I, _I, _P, _I, _I, _F, _F, _I, _I, _I, _P,
                _P, _P]
            lib.vlut_decode_gemm.argtypes = [
                _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P]
            lib.vlut_quant_prologue.restype = lib.vlut_decode_gemm.restype = _I
        else:
            mine = tg._dlib()
            for f in ("vlut_decode_prologue", "vlut_decode_gemm",
                      "vlut_decode"):
                getattr(lib, f).argtypes = getattr(mine, f).argtypes
                getattr(lib, f).restype = _I
            lib.vlut_decode_init.restype = _I
            _build.check(lib.vlut_decode_init(), f"{v} vlut_decode_init")
    return libs


class Case:
    """One projection's inputs on the card; ``rotate`` keeps copies of the
    weight past the L2 and cycles them."""

    def __init__(self, gen, m, k, n, mode, has_res, fmt, rotate,
                 x_dtype=None):
        dev = gen.device
        self.m, self.k, self.fmt, self.mode = m, k, fmt, mode
        self.kb, self.kp = DEFAULT_BLOCK[fmt], padded_k(k, fmt)
        self.np = -(-n // 128) * 128
        p = random_packed_bytes((self.kp // TRITS_PER_BYTE[fmt], self.np),
                                fmt, gen, dev)
        extra = -(-(128 << 20) // p.numel()) - 1 if rotate else 0
        self.copies = [p] + [p.clone() for _ in range(max(0, extra))]
        self.ws = torch.rand((self.np,), generator=gen, device=dev) * 0.1
        xd = x_dtype or (torch.float32 if mode == "plain" else torch.bfloat16)
        gu = torch.randn((m, 2 * k), generator=gen, device=dev).to(xd)
        self.x1 = gu[:, :k]
        self.x2 = gu[:, k:] if mode == "silu_mul" else None
        self.g = (torch.rand(k, generator=gen, device=dev) + 0.5
                  if mode == "norm" else None)
        self.od = torch.bfloat16 if has_res else torch.float32
        self.res = (torch.randn((m, n), generator=gen, device=dev).to(self.od)
                    if has_res else None)
        self.i = 0
        # the prologue's output once, for the parent's GEMM alone and _int_mm
        self.pro = self.prologue()()
        self.afrag = None

    def _next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]

    def plan(self):
        return tg.decode_plan(self.m, self.np, self.kp, self.fmt,
                              tg.sm_count(0))

    def prologue(self, lib=None):
        args = (self.x1, self.x2, self.g, self.mode, False, self.k, 1e-5)
        if lib is None:
            return lambda: tg._launch_prologue(*args, self.kp)
        if lib.parent:
            mtl = -(-self.m // 16)
            self.afrag = torch.empty((mtl * 16 * self.kp,), dtype=torch.uint8,
                                     device=self.x1.device)
            xs = torch.empty((self.m,), device=self.x1.device)

            def run():
                _build.check(lib.vlut_quant_prologue(
                    self.x1.data_ptr(), self.x2.data_ptr() if self.x2 is not None
                    else None, self.x1.stride(0),
                    int(self.x1.dtype == torch.bfloat16), self.k, self.kp,
                    self.g.data_ptr() if self.g is not None else None,
                    tg._MODES[self.mode], 0, float(self.k), 1e-5, self.kb,
                    self.m, mtl, self.afrag.data_ptr(), xs.data_ptr(),
                    tg._stream()), "vlut_quant_prologue")
                return self.afrag, xs
            return run
        return lambda: _with_lib(lib, tg._launch_prologue, *args, self.kp)

    def gemm(self, lib=None, plan=None):
        """The GEMM alone on the prologue's output (with a split, after a
        fill of its workspace, timed apart by :meth:`memset`)."""
        if lib is not None and lib.parent:
            if self.afrag is None:
                self.prologue(lib)()
            afrag, pxs = self.afrag, self.pro[1]

            def run():
                packed = self._next()
                out = torch.empty((self.m, self.np), dtype=self.od,
                                  device=packed.device)
                _build.check(lib.vlut_decode_gemm(
                    afrag.data_ptr(), pxs.data_ptr(), packed.data_ptr(),
                    self.ws.data_ptr(), self.m, self.kp // self.kb, self.np,
                    int(self.fmt == "i1"),
                    self.res.data_ptr() if self.res is not None else None,
                    self.res.shape[1] if self.res is not None else 0,
                    self.res.shape[1] if self.res is not None else 0,
                    out.data_ptr(), int(self.od == torch.bfloat16),
                    tg._stream()), "vlut_decode_gemm")
                return out
            return run
        bn, splits = plan or self.plan()
        codes, xs, rowsum, work = tg._launch_prologue(
            self.x1, self.x2, self.g, self.mode, False, self.k, 1e-5,
            self.kp, self.np, bn, splits)

        def run():
            if work is not None:
                work.zero_()
            return _with_lib(
                lib, tg._launch_decode_gemm, codes, xs, rowsum, work,
                self._next(), self.ws, self.fmt, self.m, self.res, self.od,
                bn, splits)
        return run

    def memset(self):
        """The fill of the split's workspace that :meth:`gemm` runs (None
        without a split)."""
        work = tg._decode_buffers(self.m, self.kp, self.np, *self.plan(),
                                  self.x1.device)[3]
        return work.zero_ if work is not None else None

    def call(self, lib=None, plan=None):
        """The whole call: prologue, then GEMM (the wrapper's one C call)."""
        if lib is not None and lib.parent:
            pro, gemm = self.prologue(lib), self.gemm(lib)
            return lambda: (pro(), gemm())[1]
        return lambda: _with_lib(
            lib, tg._decode_cuda, self.x1, self._next(), self.ws, self.x2,
            self.g, self.res, self.fmt, self.kb, self.mode, False, self.k,
            1e-5, self.od, plan)

    def want(self):
        xq, xs = tg.decode_prologue(self.x1, self.x2, self.g, self.mode,
                                    False, self.k, 1e-5)
        return tg._gemm_plain(xq, xs, self.copies[0], self.ws, self.fmt,
                              self.kb, self.k, self.res, self.od)


def _with_lib(lib, fn, *args):
    """``fn`` with the wrappers' library swapped for a variant's."""
    if lib is None:
        return fn(*args)
    saved = tg._dlib
    tg._dlib = lambda: lib
    try:
        return fn(*args)
    finally:
        tg._dlib = saved


def eager_us(fn, iters: int = 100) -> float:
    """us per call of ``fn`` launched one by one from Python (CUDA events
    around ``iters`` calls): the host's dispatch where it is slower than
    the device, as in an eager decode step."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) * 1e3 / iters


def int_mm_us(case, iters=20) -> float:
    """The column-major ``torch._int_mm`` of the codes and the unpacked
    trits (weights rotated past the L2): #1's library yardstick."""
    codes = case.pro[0][:, :case.k].contiguous()
    if case.m < 17:  # _int_mm takes M > 16
        codes = torch.nn.functional.pad(codes, (0, 0, 0, 17 - case.m))
    w = (unpack_fields(case.copies[0], case.fmt, case.kb)[:case.k]
         .to(torch.int8) - 1)
    ws = [w.t().contiguous().t()]
    ws += [ws[0].t().contiguous().t()
           for _ in range(-(-(128 << 20) // w.numel()) - 1)]
    state = {"i": 0}

    def run():
        state["i"] = (state["i"] + 1) % len(ws)
        return torch._int_mm(codes, ws[state["i"]])
    return graph_us(run, iters)


def check(gen) -> tuple[int, int]:
    """Bit-exact checks of the integer path (plain mode); returns (checked,
    mismatches)."""
    checked = bad = 0
    sms = tg.sm_count(0)
    forced = {(17, 3840, 512), (64, 3840, 384)}
    for fmt in ("i2", "i1"):
        for m, k, n in tg.DECODE_PLAN_SHAPES:
            c = Case(gen, m, k, n, "plain", True, fmt, rotate=False)
            want = c.want()
            nb = c.kp // c.kb
            plans = [None]
            if (m, k, n) in forced:
                plans += [(bn, s) for bn in (128, 256) if c.np % bn == 0
                          for s in range(1, min(nb, tg.MAX_SPLITS) + 1)]
            for plan in plans:
                c.i = len(c.copies) - 1
                got = c.call(plan=plan)()
                checked += 1
                if not torch.equal(got, want):
                    bad += 1
                    emit(mismatch=[fmt, m, k, n], plan=plan,
                         planned=tg.decode_plan(m, c.np, c.kp, fmt, sms),
                         max_err=float((got.float() - want.float()).abs().max()))
    # the call captured in a CUDA graph (the GEMM's programmatic dependent
    # launch inside a graph) and replayed
    c = Case(gen, 32, 4096, 4096, "plain", True, "i2", rotate=False)
    want = c.want()
    g = torch.cuda.CUDAGraph()
    c.call()()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        c.i = len(c.copies) - 1
        out = c.call()()
    g.replay()
    torch.cuda.synchronize()
    checked += 1
    if not torch.equal(out, want):
        bad += 1
        emit(mismatch="graph replay")
    return checked, bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "decode_study",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of another decode_gemm.cu, or of the "
                    "parent's ternary_gemm.cu")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_study: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = {}
    for spec in args.variant:
        name, _, d = spec.partition("=")
        dirs[name] = pathlib.Path(d)
    extra = list(ABLATIONS) if args.ablate else []
    for name in extra:
        dirs[name] = variant_source(name, ABLATIONS[name], "decode_gemm.cu")
    if args.timeline:
        extra.append("timeline")
        dirs["timeline"] = variant_source("timeline", TIMELINE,
                                          "decode_gemm.cu")
    logs = _build.build_all()
    for line in logs["decode_gemm.cu"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"ptxas: {line.strip()}", flush=True)
    libs = _build_variants(dirs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    emit(card=card, sms=tg.sm_count(0), variants=sorted(dirs))

    checked, bad = check(gen)
    emit(checked=checked, mismatches=bad)
    if bad or args.check_only:
        return 1 if bad else 0

    cases = ([("decode", label, k, n, mode, res)
              for label, k, n, mode, res in FLAGSHIP]
             + [("fused_quant", label, k, n, "plain", False)
                for label, k, n in FUSED])
    for kernel, label, k, n, mode, res in cases:
        for m in MS:
            c = Case(gen, m, k, n, mode, res, "i2", rotate=True,
                     x_dtype=torch.bfloat16 if kernel == "fused_quant" else None)
            others = {v: lib for v, lib in libs.items() if v not in extra}
            for v, lib in others.items():
                if lib.parent and mode == "plain":
                    c.i = len(c.copies) - 1
                    if not torch.equal(c.call(lib)(), c.want()):
                        emit(mismatch=[v, label, m])
                        return 1
            row = {"kernel": kernel, "shape": label, "m": m, "k": k, "n": n,
                   "plan": c.plan()}
            parts = {"call": lambda lib: c.call(lib),
                     "prologue": lambda lib: c.prologue(lib),
                     "gemm": lambda lib: c.gemm(lib)}
            for part, make in parts.items():
                for v, lib in others.items():  # in turns: variants, kernel x2
                    row[f"{v}_{part}"] = [graph_us(make(lib), 20)]
                row[f"kernel_{part}"] = [graph_us(make(None), 20),
                                         graph_us(make(None), 20)]
                for v, lib in reversed(others.items()):
                    row[f"{v}_{part}"].append(graph_us(make(lib), 20))
            memset = c.memset()
            if memset is not None:
                row["gemm_memset"] = graph_us(memset, 20)
            for v in extra:
                if v in ABLATED_PART:
                    part = ABLATED_PART[v]
                    row[f"{v}_{part}"] = graph_us(parts[part](libs[v]), 20)
            for v, lib in others.items():  # the host's dispatch, in turns
                row[f"{v}_eager"] = [eager_us(c.call(lib))]
            row["kernel_eager"] = [eager_us(c.call()), eager_us(c.call())]
            for v, lib in reversed(others.items()):
                row[f"{v}_eager"].append(eager_us(c.call(lib)))
            row["int_mm_col"] = int_mm_us(c)
            emit(**row, card=card)
            del c
            torch.cuda.empty_cache()

    if args.timeline:
        lib = libs["timeline"]
        lib.vlut_span_read.restype = _I
        for label, k, n, mode, res in FLAGSHIP:
            for m in MS:
                c = Case(gen, m, k, n, mode, res, "i2", rotate=True)
                run = c.gemm(lib)
                us = graph_us(run, 20)
                run()
                torch.cuda.synchronize()
                span = torch.zeros(4096 * 6, dtype=torch.int64)
                _build.check(lib.vlut_span_read(span.data_ptr()),
                             "vlut_span_read")
                bn, splits = c.plan()
                sp = span.view(-1, 6)[:c.np // bn * splits]
                t0 = sp[:, 0].min()
                # slots 4-5 of a block that did not apply the epilogue hold
                # an earlier call's time
                sp[:, 4:] = torch.where(sp[:, 4:] > t0, sp[:, 4:], 0)
                cols = [sp[sp[:, j] > 0, j] - t0 for j in range(6)]
                emit(timeline=label, m=m, plan=[bn, splits], graph_us=us,
                     ns_min_median_max=[[int(v.min()), int(v.median()),
                                         int(v.max())] for v in cols
                                        if len(v)],
                     card=card)
                del c
                torch.cuda.empty_cache()

    if args.sweep:
        for label, k, n, mode, res in FLAGSHIP:
            for m in MS:
                c = Case(gen, m, k, n, mode, res, "i2", rotate=True)
                nb = c.kp // c.kb
                us = {f"{bn}x{s}": graph_us(c.call(plan=(bn, s)), 20)
                      for bn in (128, 256) if c.np % bn == 0
                      for s in range(1, min(nb, tg.MAX_SPLITS) + 1)}
                emit(sweep=label, m=m, plan=c.plan(),
                     best=min(us, key=us.get), us=us, card=card)
                del c
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
