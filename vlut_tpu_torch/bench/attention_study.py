"""A study of the fused decode attention (TPU kernels #7 and #8,
``csrc/decode_attention.cu``) on the card: where a call's time goes and
what the plan picks.

    python -m vlut_tpu_torch.bench.attention_study [--variant NAME=DIR ...]
        [--ablate] [--timeline] [--sweep] [--check-only]

It builds the checked-out kernel and holds it against its plain versions
(cache rows, codes and scales bit-exact, the output to rtol and atol 2e-5,
two calls bit-equal) at ``ops/decode_attention.py:PLAN_SHAPES`` as planned
and with every rows-per-block choice forced at two shapes, at the edge
starts (0, S - 1, out of range) with large finite values in the rows a
slot does not see, at B 1, and once through a CUDA graph (``--check-only``
stops there).  Then it prints one JSON line per shape and cache type
(device time of a CUDA graph of calls, the cache rotated past the L2 where
it fits in it):

* the shapes of the decode paths (``SHAPES``): the flagship engine (B 32,
  S 2048, starts spread over 64-1900) without and with a 512-row window,
  the flagship ``batched`` cache (B 32, S 184, 128-183 rows),
  ``bench-sweep`` tg (B 1 and 32, S 552) and tiny_real's heads (Hkv 2, G
  2, hd 128), for the checked-out kernel and each ``--variant`` in turns
  (variant, kernel, kernel, variant), beside
  ``scaled_dot_product_attention``; the host's dispatch of a call launched
  one by one from Python with the tensors ``_layer_step`` hands it (bf16 q
  and rows, v a strided slice of the qkv output, int64 starts), in turns
  too, and the device kernels one such call runs (torch.profiler).  A
  variant is a directory holding another ``decode_attention.cu``, for
  instance the parent commit's ``vlut_tpu_torch/csrc`` unpacked by ``git
  archive``; a source with the first design's interface
  (``vlut_decode_attention_scratch``: q in float32, new rows cast, a
  scratch of the splits) is called the way that design's wrapper called
  it, casts included.
* ``--ablate``: text edits of the checked-out source (they fail loudly when
  the kernel's lines change).  On the first design: its partial pass
  alone, its merge pass alone, and the partial pass without its score
  dots, without its value dots and without both (loads only).  On the
  current one: no cache copies, no score mma, no value mma, no merge of
  the splits, copies only (a landed stage released at once) and (int8)
  no scale copies.  Their outputs are wrong by design and are not
  checked; each is timed in a graph and eagerly.
* ``--timeline``: the global timer of thread 0 of every block at its entry,
  its first stage landed, its row loop done, its state merged (or, alone,
  finished) and, for the last block of a split slot, its end.
* ``--sweep``: every rows-per-block choice at every shape, against the
  plan's.

The builds go to ``build/study/`` (gitignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import subprocess
import sys

import torch

from vlut_tpu_torch.bench.decode_study import eager_us
from vlut_tpu_torch.bench.tiled_study import (
    compile_variants, emit, graph_us, variant_source)
from vlut_tpu_torch.ops import _build, decode_attention as da
from vlut_tpu_torch.ops.ternary_gemm import sm_count
from vlut_tpu_torch.runtime.kv_cache import dequantize_kv, quantize_kv

SOURCE = "decode_attention.cu"
TOL = dict(rtol=2e-5, atol=2e-5)

# (label, B, S, Hkv, G, hd, window, starts): "spread" is the flagship
# engine's 64-1900 over the slots, "batched" 128-183, an int is every
# slot's start
SHAPES = [
    ("engine", 32, 2048, 8, 4, 128, 0, "spread"),
    ("engine_w512", 32, 2048, 8, 4, 128, 512, "spread"),
    ("batched", 32, 184, 8, 4, 128, 0, "batched"),
    ("tg_b1", 1, 552, 8, 4, 128, 0, 530),
    ("tg_b32", 32, 552, 8, 4, 128, 0, 530),
    ("tiny_real", 4, 256, 2, 2, 128, 0, "tiny"),
]

# the first design (a split pass, then a merge pass): the partial pass
# alone, the merge pass alone, and the partial pass without its score dots,
# its value dots, or both
_NO_FINISH = [("  decode_attn_finish<HD, G, Q8><<<a.b * a.hkv, 32, 0, "
               "stream>>>(",
               "  if (false) decode_attn_finish<HD, G, Q8><<<a.b * a.hkv, 32, "
               "0, stream>>>(")]
_NO_PARTIAL = [("  decode_attn_partial<HD, G, Q8>\n      <<<",
                "  if (false) decode_attn_partial<HD, G, Q8>\n      <<<")]
_NO_SCORE = [("    for (int i = tid; i < G * n; i += kThreads) {",
              "    for (int i = tid; i < 0; i += kThreads) {")]
_NO_VALUE = [("      for (int r = grp; r < n; r += PAR) {",
              "      for (int r = grp; r < 0; r += PAR) {")]
FIRST_DESIGN_PARTS = {
    "partial": _NO_FINISH, "finish": _NO_PARTIAL,
    "partial_noscore": _NO_FINISH + _NO_SCORE,
    "partial_novalue": _NO_FINISH + _NO_VALUE,
    "partial_loads": _NO_FINISH + _NO_SCORE + _NO_VALUE,
}
# the current design: no cache copies (the stages' barriers complete
# empty), no score mma, no value mma (an XOR in place of each), no merge of
# the splits (a block of a split slot stops after its state), copies only
# (a landed stage is released at once: no products, no softmax), no int8
# scale copies
_NOCOPY = [("      mbar_arrive_expect(bar, C::SB);",
            "      mbar_arrive_expect(bar, 0);"),
           ("      for (int x = 0; x < C::NBOX; ++x) {\n        tma_load_2d(",
            "      for (int x = 0; x < 0; ++x) {\n        tma_load_2d(")]
_NOSCORE = [("            mma_bf16(s[mt][x >> 1], a, b0, b1);",
             "            s[mt][x >> 1][0] += "
             "__uint_as_float(a[0] ^ b0 ^ b1);"),
            ("          mma_bf16(s[mt][0], a, r[0], r[1]);\n"
             "          mma_bf16(s[mt][1], a, r[2], r[3]);",
             "          s[mt][0][0] += __uint_as_float(a[0] ^ r[0] ^ r[1]);\n"
             "          s[mt][1][0] += __uint_as_float(a[0] ^ r[2] ^ r[3]);")]
_NOVALUE = [("            mma_bf16(acc[mt][4 * cb + q], pa[mt], b0, b1);",
             "            acc[mt][4 * cb + q][0] += "
             "__uint_as_float(pa[mt][0] ^ b0 ^ b1);"),
            ("          mma_bf16(acc[mt][2 * cb], pa[mt], r[0], r[1]);\n"
             "          mma_bf16(acc[mt][2 * cb + 1], pa[mt], r[2], r[3]);",
             "          acc[mt][2 * cb][0] += "
             "__uint_as_float(pa[mt][0] ^ r[0]);\n"
             "          acc[mt][2 * cb + 1][0] += __uint_as_float(pa[mt][0] ^ "
             "r[2]);")]
_NOMERGE = [("  if (alone) return;\n", "  return;\n")]
_COPYONLY = [("    mbar_wait(&bars[slot], (i / D) & 1);\n",
              "    mbar_wait(&bars[slot], (i / D) & 1);\n"
              "    if (rb >= 0) {\n      __syncwarp();\n"
              "      if constexpr (CG > 1) team_sync(1 + team, CG * 32);\n"
              "      if (member == 0 && i + D < nloc) {\n"
              "        if (lane == 0) fence_proxy_async();\n"
              "        issue(i + D);\n      }\n      continue;\n    }\n")]
_NOSCALE = [("mbar_init(&bars[i], Q8 ? 33 : 1);", "mbar_init(&bars[i], 1);"),
            ("      cp_async4(smem_addr(smem + C::SCALES + slot * 128 + "
             "lane * 4), src,\n                ok ? 4 : 0, bar);",
             "      (void)src;")]
ABLATIONS = {"nocopy": _NOCOPY, "noscore": _NOSCORE, "novalue": _NOVALUE,
             "nommas": _NOSCORE + _NOVALUE, "nomerge": _NOMERGE,
             "copyonly": _COPYONLY, "noscale": _NOSCALE,
             "copyonly_noscale": _COPYONLY + _NOSCALE}
# global-timer stamps of thread 0 of the first 4,096 blocks: entry (past
# the early exit), first stage landed, row loop done, state merged (or, with
# one split, finished), and (the last block of a split slot) end
_SPAN = ("__device__ unsigned long long g_span[4096 * 5];\n"
         "__device__ __forceinline__ void rec(int slot) {\n"
         "  const int blk = blockIdx.x + blockIdx.y * gridDim.x;\n"
         "  unsigned long long now;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(now));\n"
         "  if (threadIdx.x == 0 && blk < 4096)\n"
         "    g_span[blk * 5 + slot] = now;\n"
         "}\n")
TIMELINE = [
    ("struct Params {", _SPAN + "struct Params {"),
    ("  if (sp >= max(n_act, 1)) return;\n",
     "  if (sp >= max(n_act, 1)) return;\n  rec(0);\n"),
    ("    mbar_wait(&bars[slot], (i / D) & 1);\n",
     "    mbar_wait(&bars[slot], (i / D) & 1);\n    if (i == 0) rec(1);\n"),
    ("  // the teams' states meet in shared memory (the ring is free now)\n"
     "  __syncthreads();\n",
     "  // the teams' states meet in shared memory (the ring is free now)\n"
     "  __syncthreads();\n  rec(2);\n"),
    ("  if (alone) return;\n", "  rec(3);\n  if (alone) return;\n"),
    ("  if (tid == 0) p.counters[pair] = 0;\n",
     "  rec(4);\n  if (tid == 0) p.counters[pair] = 0;\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint vlut_span_read(void* host) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_span, "
     "sizeof(g_span)));\n}\n"),
]
_I, _P = ctypes.c_int, ctypes.c_void_p


def _first_design(lib) -> bool:
    return hasattr(lib, "vlut_decode_attention_scratch")


def _build_variants(dirs: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    libs = compile_variants(dirs, SOURCE)
    for lib in libs.values():
        if _first_design(lib):
            lib.vlut_decode_attention.argtypes = [
                _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                ctypes.c_float, _I, _P, _P, _P]
            lib.vlut_decode_attention.restype = _I
            lib.vlut_decode_attention_scratch.argtypes = [_I, _I, _I, _I]
            lib.vlut_decode_attention_scratch.restype = ctypes.c_long
        else:
            da.type_lib(lib)
    return libs


def _starts(kind, b, s, gen):
    dev = gen.device
    if kind == "spread":
        st = torch.linspace(64, 1900, b, device=dev).round().long()
        return st[torch.randperm(b, generator=gen, device=dev)]
    if kind == "batched":
        return 128 + torch.randint(0, 56, (b,), generator=gen, device=dev)
    if kind == "tiny":
        return torch.linspace(20, 120, b, device=dev).round().long()
    return torch.full((b,), int(kind), device=dev, dtype=torch.long)


class Case:
    """One layer's decode-attention inputs as ``_layer_step`` hands them to
    the kernel (bf16 q and rows, v a strided slice of the qkv output, int64
    starts), with copies of the cache cycled past the L2 when ``rotate``."""

    def __init__(self, gen, b, s, hkv, g, hd, window, starts, q8, rotate,
                 dtype=torch.bfloat16):
        dev = gen.device
        self.b, self.s, self.hkv, self.g, self.hd = b, s, hkv, g, hd
        self.h, self.window, self.q8 = hkv * g, window, q8
        self.scale = hd ** -0.5
        rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa
        qd, kvd = self.h * hd, hkv * hd
        qkv = rn(b, 1, qd + 2 * kvd).to(dtype)
        self.q = qkv[..., :qd].reshape(b, 1, self.h, hd).contiguous()
        self.kn = qkv[..., qd:qd + kvd].reshape(b, 1, hkv, hd).contiguous()
        self.vn = qkv[..., qd + kvd:].reshape(b, 1, hkv, hd)
        self.start = (starts if torch.is_tensor(starts)
                      else _starts(starts, b, s, gen))
        kf, vf = rn(b, s, hkv, hd), rn(b, s, hkv, hd)
        if q8:
            cache = [*quantize_kv(kf), *quantize_kv(vf)]
            cache = [cache[0], cache[2], cache[1], cache[3]]  # k, v, ks, vs
        else:
            cache = [kf.to(torch.bfloat16), vf.to(torch.bfloat16)]
        nbytes = sum(t.numel() * t.element_size() for t in cache)
        n = max(1, math.ceil((128 << 20) / nbytes)) if rotate else 1
        self.copies = [cache] + [[t.clone() for t in cache]
                                 for _ in range(n - 1)]
        self.i = 0

    def rows(self) -> int:
        """Visible cache rows over all slots."""
        st = self.start.clamp(max=self.s)
        lo = (self.start - self.window + 1).clamp(min=0) if self.window \
            else torch.zeros_like(st)
        return int((st - lo).clamp(min=0).sum())

    def _next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]

    def call(self, lib=None, rows=None):
        """A function of no arguments running one call on the next cache
        copy: the wrapper, or ``lib`` (a variant) with ``rows`` forced."""
        if lib is not None and _first_design(lib):
            return lambda: self._first(lib, self._next())
        if lib is None and rows is None:
            f = da.decode_attention_int8 if self.q8 else da.decode_attention
            return lambda: f(self.q, self.kn, self.vn, *self._next(),
                             self.start, self.window, scale=self.scale)

        def run():
            c = self._next()
            return da._launch(self.q, self.kn, self.vn, c[0], c[1],
                              c[2] if self.q8 else None,
                              c[3] if self.q8 else None, self.start,
                              self.window, self.scale, rows=rows, lib=lib)
        return run

    def _first(self, lib, c):
        """The first design's call, as its wrapper made it: q to float32,
        the new rows to the kernel's type, starts to int32, each made
        contiguous, a scratch of the splits."""
        b, s, h, hd = self.b, self.s, self.h, self.hd
        dev = self.q.device
        qf = self.q.to(torch.float32).contiguous()
        nd = torch.float32 if self.q8 else torch.bfloat16
        kn, vn = self.kn.to(nd).contiguous(), self.vn.to(nd).contiguous()
        st = self.start.to(torch.int32).contiguous()
        out = torch.empty((b, 1, h, hd), dtype=torch.float32, device=dev)
        scratch = torch.empty(lib.vlut_decode_attention_scratch(b, s, h, hd),
                              dtype=torch.float32, device=dev)
        _build.check(lib.vlut_decode_attention(
            qf.data_ptr(), kn.data_ptr(), vn.data_ptr(), c[0].data_ptr(),
            c[1].data_ptr(), c[2].data_ptr() if self.q8 else None,
            c[3].data_ptr() if self.q8 else None, st.data_ptr(), b, s, h,
            self.hkv, hd, self.window, self.scale, int(self.q8),
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "vlut_decode_attention")
        return out

    def want(self, c):
        """The plain version on copies of cache ``c``: (output, cache)."""
        ref = [t.clone() for t in c]
        if self.q8:
            out = da.decode_attention_int8_plain(
                self.q, self.kn, self.vn, *ref, self.start, self.window,
                scale=self.scale)
        else:
            out = da.decode_attention_plain(
                self.q, self.kn, self.vn, *ref, self.start, self.window,
                scale=self.scale)
        return out, ref

    def sdpa(self):
        """``scaled_dot_product_attention`` over the same rows (int8:
        dequantized to bf16 beforehand), the yardstick."""
        c = self.copies[0]
        if self.q8:
            k = dequantize_kv(c[0], c[2], torch.bfloat16)
            v = dequantize_kv(c[1], c[3], torch.bfloat16)
        else:
            k, v = c[0], c[1]
        idx = torch.arange(self.s, device=k.device)[None, :]
        st = self.start[:, None]
        mask = idx < st
        if self.window:
            mask &= idx > st - self.window
        mask = mask[:, None, None, :]
        qb = self.q.transpose(1, 2)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kt, vt, attn_mask=mask, scale=self.scale, enable_gqa=True)


def device_kernels(fn) -> list[str]:
    """The device kernels (and memsets, copies) one call of ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _same(got_out, got_cache, want_out, want_cache) -> tuple[str | None,
                                                              float]:
    """(None, largest error) when a call agrees with the plain version,
    else (what differs, largest error)."""
    for mine, theirs in zip(got_cache, want_cache):
        if not torch.equal(mine, theirs):
            return "cache rows", float("nan")
    if not bool(torch.isfinite(got_out).all()):
        return "non-finite output", float("nan")
    err = (got_out - want_out).abs()
    top = float(err.max())
    if bool((err > TOL["atol"] + TOL["rtol"] * want_out.abs()).any()):
        return f"output (max {top})", top
    return None, top


def check_case(case, rows=None, lib=None) -> tuple[str | None, float]:
    """The kernel (forced to ``rows`` per block) against the plain version
    on a copy of the cache, and a second call on another copy bit-equal to
    the first: (None, largest error) or (what differs, error)."""
    c = case.copies[0]
    want_out, want_cache = case.want(c)
    outs, top = [], 0.0
    for _ in range(2):
        mine = [t.clone() for t in c]
        out = da._launch(case.q, case.kn, case.vn, mine[0], mine[1],
                         mine[2] if case.q8 else None,
                         mine[3] if case.q8 else None, case.start,
                         case.window, case.scale, rows=rows, lib=lib)
        torch.cuda.synchronize()
        why, top = _same(out, mine, want_out, want_cache)
        if why:
            return why, top
        outs.append(out)
    if not torch.equal(outs[0], outs[1]):
        return "two calls differ", top
    return None, top


def hide_rows(case) -> None:
    """Large finite values in every cache row a slot does not see (bf16
    3e38; int8 codes 127 with scales 1e30): they must get p = 0."""
    idx = torch.arange(case.s, device=case.start.device)[None, :]
    st = case.start[:, None]
    hidden = idx >= st
    if case.window:
        hidden |= idx <= st - case.window
    c = case.copies[0]
    for t in c[:2]:
        t[hidden] = 127 if case.q8 else 3e38
    if case.q8:
        for t in c[2:]:
            t[hidden] = 1e30


def check(gen) -> list[dict]:
    """Untimed checks of the checked-out kernel: at every PLAN_SHAPES entry
    (bf16 and int8, G and hd varied) as planned, with every rows-per-block
    choice forced at the first two, at the edge starts with large finite
    values in the invisible rows (with and without a window), at B 1, and
    one call replayed from a CUDA graph.  One dict per check: its label,
    rows (None: planned), what differs (None) and the largest error."""
    out = []
    sms = sm_count(0)

    def one(label, case, rows=None):
        why, err = check_case(case, rows)
        out.append(dict(label=label, rows=rows or da.attn_plan(
            case.b, case.hkv, da.span(case.s, case.window), sms),
            why=why, max_abs_err=err))

    for q8 in (False, True):
        for i, (b, hkv, s) in enumerate(da.PLAN_SHAPES):
            g = (4, 2, 1, 8)[i % 4]
            hd = 256 if i % 3 == 2 else 128
            case = Case(gen, b, s, hkv, g, hd, 0, "spread" if s >= 1900
                        else max(1, s - 3), q8, rotate=False)
            one(f"plan B={b} Hkv={hkv} S={s} G={g} hd={hd} q8={q8}", case)
            if i < 2:
                for rows in da.ROWS:
                    one(f"forced B={b} Hkv={hkv} S={s} G={g} hd={hd} "
                        f"q8={q8}", case, rows)
            del case
        s = 300
        st = torch.tensor([0, s - 1, s, -1, 17], device=gen.device)
        for window in (0, 37):
            case = Case(gen, 5, s, 2, 4, 128, window, st, q8, rotate=False)
            hide_rows(case)
            one(f"edges starts 0/S-1/S/-1/17 window={window} q8={q8}", case)
        case = Case(gen, 1, 40, 8, 4, 128, 0, 39, q8, rotate=False)
        one(f"B=1 S=40 q8={q8}", case)
        torch.cuda.empty_cache()
    # one call captured in a CUDA graph and replayed
    case = Case(gen, 32, 2048, 8, 4, 128, 0, "spread", False, rotate=False)
    want_out, want_cache = case.want(case.copies[0])
    mine = [t.clone() for t in case.copies[0]]
    fn = lambda: da.decode_attention(case.q, case.kn, case.vn, *mine,  # noqa
                                     case.start, 0, scale=case.scale)
    fn()
    for t, u in zip(mine, case.copies[0]):
        t.copy_(u)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        res = fn()
    g.replay()
    torch.cuda.synchronize()
    why, err = _same(res, mine, want_out, want_cache)
    out.append(dict(label="CUDA graph replay", rows=None, why=why,
                    max_abs_err=err))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "attention_study",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of another decode_attention.cu")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_study: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = {}
    for spec in args.variant:
        name, _, d = spec.partition("=")
        dirs[name] = pathlib.Path(d)
    first = "vlut_decode_attention_scratch" in (_build.CSRC / SOURCE
                                                ).read_text()
    edits = dict(FIRST_DESIGN_PARTS if first else ABLATIONS) \
        if args.ablate else {}
    if args.timeline and not first:
        edits["timeline"] = TIMELINE
    for name, e in edits.items():
        dirs[name] = variant_source(name, e, SOURCE)
    logs = _build.build_all()
    for line in logs[SOURCE].splitlines():
        if any(w in line for w in ("registers", "spill")):
            print(f"ptxas: {line.strip()}", flush=True)
    libs = _build_variants(dirs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sms = sm_count(0)
    emit(card=card, sms=sms, variants=sorted(dirs), first_design=first)

    if not first:
        results = check(gen)
        bad = [r for r in results if r["why"]]
        for r in bad:
            emit(mismatch=r)
        emit(checked=len(results), mismatches=len(bad),
             max_abs_err=max(r["max_abs_err"] for r in results))
        if bad or args.check_only:
            return 1 if bad else 0

    others = {v: lib for v, lib in libs.items() if v not in edits}
    for label, b, s, hkv, g, hd, window, starts in SHAPES:
        for q8 in (False, True):
            case = Case(gen, b, s, hkv, g, hd, window, starts, q8,
                        rotate=True)
            want_out, want_cache = case.want(case.copies[0])
            for v, lib in [(None, None), *others.items()]:
                mine = [t.clone() for t in case.copies[0]]
                saved, case.copies[0] = case.copies[0], mine
                case.i = len(case.copies) - 1
                out = case.call(lib)()
                torch.cuda.synchronize()
                case.copies[0] = saved
                why, _ = _same(out, mine, want_out, want_cache)
                if why:
                    emit(mismatch=[v or "kernel", label, q8], why=why)
                    return 1
            row = {"shape": label, "b": b, "s": s, "hkv": hkv, "g": g,
                   "hd": hd, "window": window, "q8": q8, "rows": case.rows()}
            if not first:
                row["plan"] = da.attn_plan(b, hkv, da.span(s, window), sms)
            for v, lib in others.items():  # in turns: variants, kernel x2
                row[f"{v}_us"] = [graph_us(case.call(lib), 20)]
            row["kernel_us"] = [graph_us(case.call(), 20),
                                graph_us(case.call(), 20)]
            for v, lib in reversed(others.items()):
                row[f"{v}_us"].append(graph_us(case.call(lib), 20))
            for v in edits:
                if v != "timeline":
                    row[f"{v}_us"] = graph_us(case.call(libs[v]), 20)
                    row[f"{v}_eager_us"] = eager_us(case.call(libs[v]))
            for v, lib in others.items():  # the host's dispatch, in turns
                row[f"{v}_eager_us"] = [eager_us(case.call(lib))]
            row["kernel_eager_us"] = [eager_us(case.call()),
                                      eager_us(case.call())]
            for v, lib in reversed(others.items()):
                row[f"{v}_eager_us"].append(eager_us(case.call(lib)))
            row["kernel_launched"] = device_kernels(case.call())
            for v, lib in others.items():
                row[f"{v}_launched"] = device_kernels(case.call(lib))
            try:
                row["sdpa_us"] = graph_us(case.sdpa(), 20)
            except RuntimeError as e:
                row["sdpa_us"] = f"refused: {e}"[:80]
            emit(**row, card=card)
            del case
            torch.cuda.empty_cache()

    if args.timeline and not first:
        timeline(libs["timeline"], gen, card)
    if args.sweep and not first:
        for label, b, s, hkv, g, hd, window, starts in SHAPES:
            for q8 in (False, True):
                case = Case(gen, b, s, hkv, g, hd, window, starts, q8,
                            rotate=True)
                us = {r: graph_us(case.call(rows=r), 20) for r in da.ROWS}
                emit(sweep=label, q8=q8, plan=da.attn_plan(
                    b, hkv, da.span(s, window), sms),
                    best=min(us, key=us.get), us=us, card=card)
                del case
                torch.cuda.empty_cache()
    return 0


def timeline(lib, gen, card) -> None:
    """Per-block global-timer stamps at the flagship shapes (ns after the
    first block's entry: min / median / max over the blocks that reach each
    point), from one call."""
    lib.vlut_span_read.restype = _I
    lib.vlut_span_read.argtypes = [_P]
    for label, b, s, hkv, g, hd, window, starts in SHAPES[:3]:
        for q8 in (False, True):
            case = Case(gen, b, s, hkv, g, hd, window, starts, q8,
                        rotate=True)
            run = case.call(lib)
            us = graph_us(run, 20)
            span = torch.zeros(4096 * 5, dtype=torch.int64)
            _build.check(lib.vlut_span_read(span.data_ptr()), "span")
            before = span.clone()
            run()
            torch.cuda.synchronize()
            _build.check(lib.vlut_span_read(span.data_ptr()), "span")
            sp = torch.where(span != before, span, 0).view(-1, 5)
            t0 = sp[sp[:, 0] > 0, 0].min()
            cols = [sp[sp[:, j] > 0, j] - t0 for j in range(5)]
            life = (sp[:, 3] - sp[:, 0])[(sp[:, 3] > 0) & (sp[:, 0] > 0)]
            emit(timeline=label, q8=q8, graph_us=us, blocks=int(
                (sp[:, 0] > 0).sum()), ns_min_median_max=[
                    [int(v.min()), int(v.median()), int(v.max())]
                    if len(v) else None for v in cols],
                 block_ns_median=int(life.median()), card=card)
            del case
            torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
