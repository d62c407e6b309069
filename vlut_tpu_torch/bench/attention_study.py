"""A study of the fused decode attention (TPU kernels #7 and #8,
``csrc/decode_attention.cu``) on the card: where a call's time goes and
what the plan picks.

    python -m vlut_tpu_torch.bench.attention_study [--variant NAME=DIR ...]
        [--ablate] [--timeline] [--sweep] [--composed] [--check-only]

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
  ``bench-sweep`` tg (B 1 and 32, S 552), tiny_real's heads (Hkv 2, G
  2, hd 128), OuteTTS's cache (B 1, S 8192, 14 heads over 2) at its
  prefill's rows and full, falcon-7b's (71 over 1) and starcoder's (48
  over 1) engines, and the Pallas kernels' wider domain (G 3 at hd 256,
  hdv != hd, hd 512, and past 512 the wide path's shapes: DeepSeek-V2-Lite's
  latent widths 640 / 512 at 16 heads over one, 1024 / 1024, 128 / 2048,
  2048 / 128, 4096 / 4096 and G 7 at 768), for the checked-out kernel and
  each ``--variant`` in
  turns (variant, kernel, kernel, variant), beside
  ``scaled_dot_product_attention``; the host's dispatch of a call launched
  one by one from Python with the tensors ``_layer_step`` hands it (bf16 q
  and rows, v a strided slice of the qkv output, int64 starts), in turns
  too, and the device kernels one such call runs (torch.profiler).  A
  variant is a directory holding another ``decode_attention.cu``, of this
  interface or of the one before head groups (hd = hdv in 128 / 256, G in
  1, 2, 4, 8; called as its wrapper called it, at the shapes it takes; a
  source without the wide path takes heads of at most 512), for instance
  the parent commit's ``vlut_tpu_torch/csrc`` unpacked by ``git archive``;
  each row says whether a variant's output is bit-identical to the
  kernel's (``same_bits``).
* ``--ablate``: text edits of the checked-out source (they fail loudly when
  the kernel's lines change): no cache copies, no score mma, no value mma,
  no merge of the splits, copies only (a landed stage released at once)
  and (int8) no scale copies.  Their outputs are wrong by design and are not
  checked; each is timed in a graph and eagerly.  They edit the first path
  (heads of at most 512) only.
* ``--timeline``: the global timer of thread 0 of every block at its entry,
  its first stage landed, its row loop done, its state merged (or, alone,
  finished) and, for the last block of a split slot, its end.
* ``--sweep``: every rows-per-block choice at every shape, against the
  plan's.
* ``--composed``: after the checks, only the wide path against the
  composed step's row write and plain attention (``COMPOSED_SWEEP``),
  with the decode gate's choice (``fused_pays``) beside each.

The builds go to ``build/study/`` (gitignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import math
import pathlib
import subprocess
import sys

import torch

from vlut_tpu_torch.bench.decode_study import eager_us
from vlut_tpu_torch.bench.tiled_study import (
    compile_variants, emit, graph_us, variant_source)
from vlut_tpu_torch.ops import _build, decode_attention as da
from vlut_tpu_torch.ops.ternary_gemm import _stream, sm_count
from vlut_tpu_torch.runtime.kv_cache import dequantize_kv, quantize_kv

SOURCE = "decode_attention.cu"
TOL = dict(rtol=2e-5, atol=2e-5)

# (label, B, S, Hkv, G, hd, hdv, window, starts): "spread" is the
# flagship engine's 64-1900 over the slots, "batched" 128-183, "fill"
# S / 16 to S - 1, an int is every slot's start; OuteTTS's prefill holds
# 586 rows (phase 27's speaker profile), falcon-7b and starcoder serve 16
# slots of ctx 2048; past hd 512 the wide path (K pieces, V slices):
# DeepSeek-V2-Lite's latent row (kv_lora 512 + rope 64, padded to 640;
# V the 512 latent columns) as a kernel shape, 16 heads over one
SHAPES = [
    ("engine", 32, 2048, 8, 4, 128, 128, 0, "spread"),
    ("engine_w512", 32, 2048, 8, 4, 128, 128, 512, "spread"),
    ("batched", 32, 184, 8, 4, 128, 128, 0, "batched"),
    ("tg_b1", 1, 552, 8, 4, 128, 128, 0, 530),
    ("tg_b32", 32, 552, 8, 4, 128, 128, 0, 530),
    ("tiny_real", 4, 256, 2, 2, 128, 128, 0, "tiny"),
    ("outetts_prefill", 1, 8192, 2, 7, 128, 128, 0, 586),
    ("outetts_full", 1, 8192, 2, 7, 128, 128, 0, 8191),
    ("falcon_7b", 16, 2048, 1, 71, 128, 128, 0, "spread"),
    ("starcoder", 16, 2048, 1, 48, 128, 128, 0, "spread"),
    ("hd256_g3", 4, 1024, 2, 3, 256, 256, 0, "spread"),
    ("hd128_hdv256", 4, 1024, 2, 4, 128, 256, 0, "spread"),
    ("hd256_hdv128", 4, 1024, 2, 4, 256, 128, 0, "spread"),
    ("hd512", 4, 1024, 2, 4, 512, 512, 0, "spread"),
    ("v2_lite_latent", 16, 2048, 1, 16, 640, 512, 0, "fill"),
    ("wide_square", 4, 1024, 2, 4, 1024, 1024, 0, "fill"),
    ("wide_v", 4, 1024, 2, 2, 128, 2048, 0, "fill"),
    ("wide_k", 4, 1024, 2, 8, 2048, 128, 0, "fill"),
    ("very_wide", 2, 512, 1, 4, 4096, 4096, 0, "fill"),
    ("odd_g_wide", 1, 8192, 1, 7, 768, 768, 0, 8191),
]
# (B, S, Hkv, G, hd, hdv) of --composed: the wide path against the composed
# step over widths, head counts (one and four head groups) and caches,
# the ground of ops/decode_attention.py:WIDE_SCORE_COLS
COMPOSED_SWEEP = [
    (4, 1024, 2, g, hd, hdv) for (hd, hdv) in (
        (640, 512), (768, 768), (1024, 1024), (1536, 1536), (2048, 2048),
        (3072, 3072), (4096, 4096), (2048, 128), (4096, 128), (128, 2048),
        (128, 4096), (4096, 512), (512, 4096), (1024, 4096), (4096, 1024))
    for g in (1, 4, 16)] + [
    (1, 8192, 1, 16, 640, 512), (16, 512, 1, 16, 640, 512),
    (32, 4096, 1, 16, 640, 512), (1, 8192, 1, 4, 4096, 4096),
    (16, 512, 1, 4, 4096, 4096), (2, 4096, 1, 4, 4096, 4096)]
# (G, hd, hdv) of the wide path's untimed checks (check): each of the
# timed shapes' head shapes at a small cache
WIDE = [(4, 640, 512), (2, 1024, 1024), (3, 128, 2048), (8, 2048, 128),
        (7, 768, 768), (2, 4096, 4096)]

# the current design: no cache copies (the stages' barriers complete
# empty), no score mma, no value mma (an XOR in place of each), no merge of
# the splits (a block of a split slot stops after its state), copies only
# (a landed stage is released at once: no products, no softmax), no int8
# scale copies
_NOCOPY = [("      mbar_arrive_expect(bar, C::SB);",
            "      mbar_arrive_expect(bar, 0);"),
           ("      for (int x = 0; x < C::NBOXK; ++x)\n        tma_load_2d(",
            "      for (int x = 0; x < 0; ++x)\n        tma_load_2d("),
           ("      for (int x = 0; x < C::NBOXV; ++x)\n        tma_load_2d(",
            "      for (int x = 0; x < 0; ++x)\n        tma_load_2d(")]
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
    ("  if (tid == 0) p.counters[unit] = 0;\n",
     "  rec(4);\n  if (tid == 0) p.counters[unit] = 0;\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint vlut_span_read(void* host) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_span, "
     "sizeof(g_span)));\n}\n"),
]
_I, _P = ctypes.c_int, ctypes.c_void_p
# the entry point's arguments since head groups and hdv; a source without
# them has the interface from before head groups
_INTERFACE = "int hkv, int hd, int hdv, int heads"


def _build_variants(dirs: dict[str, pathlib.Path]) -> dict[str, ctypes.CDLL]:
    libs = compile_variants(dirs, SOURCE)
    for v, lib in libs.items():
        src = (dirs[v] / SOURCE).read_text()
        # a source without the wide path takes heads of at most 512
        lib.widest = None if "decode_attn_wide" in src else da.MAX_HEAD_WIDTH
        if _INTERFACE in src:
            da.type_lib(lib)
            lib.parent = False
        else:
            i, lg = ctypes.c_int, ctypes.c_long
            lib.vlut_decode_attn.argtypes = [
                _P, lg, i, _P, lg, _P, lg, i, _P, _P, _P, _P, _P, i, i, i, i,
                i, i, i, ctypes.c_float, i, i, i, _P, _P, _P, _P]
            lib.vlut_decode_attn.restype = i
            lib.parent = True
    return libs


def takes(lib, case) -> bool:
    """Whether a variant takes the case's shape: ``supports``, with heads
    of at most 512 in a source without the wide path; the parent's
    interface takes hd = hdv in (128, 256) and G in (1, 2, 4, 8)."""
    widest = getattr(lib, "widest", None)
    if not da.supports(case.h, case.hkv, case.hd, case.hdv) or (
            widest and max(case.hd, case.hdv) > widest):
        return False
    return not getattr(lib, "parent", False) or (
        case.hd == case.hdv and case.hd in (128, 256)
        and case.g in (1, 2, 4, 8))


def _launch_parent(lib, q, kn, vn, kc, vc, ksc, vsc, start, window, scale,
                   rows=None):
    """One call of a parent-interface build, as its wrapper made it (the
    workspace is the current wrapper's, which is at least as large)."""
    b, s, hkv, hd = kc.shape
    h = q.shape[2]
    quant = ksc is not None
    dev = kc.device
    rows = rows or da.attn_plan(b, hkv, da.span(s, int(window)),
                                sm_count(dev.index))
    nsplit = -(-da.span(s, int(window)) // rows)
    part, cnt = da._workspace(dev, b * h * nsplit * (hd + 2), b * hkv)
    out = torch.empty((b, 1, h, hd), dtype=torch.float32, device=dev)
    err = lib.vlut_decode_attn(
        q.data_ptr(), q.stride(0), int(q.dtype == torch.bfloat16),
        kn.data_ptr(), kn.stride(0), vn.data_ptr(), vn.stride(0),
        int(kn.dtype == torch.bfloat16), kc.data_ptr(), vc.data_ptr(),
        ksc.data_ptr() if quant else None, vsc.data_ptr() if quant else None,
        start.data_ptr(), int(start.dtype == torch.int64), b, s, h, hkv, hd,
        int(window), float(scale), int(quant), rows, nsplit, part.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), _stream(dev.index))
    _build.check(err, "parent vlut_decode_attn")
    return out


def _starts(kind, b, s, gen):
    dev = gen.device
    if kind == "spread":
        st = torch.linspace(64, 1900, b, device=dev).round().long()
        return st[torch.randperm(b, generator=gen, device=dev)]
    if kind == "batched":
        return 128 + torch.randint(0, 56, (b,), generator=gen, device=dev)
    if kind == "tiny":
        return torch.linspace(20, 120, b, device=dev).round().long()
    if kind == "fill":
        st = torch.linspace(s // 16, s - 1, b, device=dev).round().long()
        return st[torch.randperm(b, generator=gen, device=dev)]
    return torch.full((b,), int(kind), device=dev, dtype=torch.long)


class Case:
    """One layer's decode-attention inputs as ``_layer_step`` hands them to
    the kernel (bf16 q and rows, v a strided slice of the qkv output, int64
    starts), with copies of the cache cycled past the L2 when ``rotate``."""

    def __init__(self, gen, b, s, hkv, g, hd, window, starts, q8, rotate,
                 dtype=torch.bfloat16, hdv=None):
        dev = gen.device
        hdv = hdv or hd
        self.b, self.s, self.hkv, self.g, self.hd = b, s, hkv, g, hd
        self.hdv = hdv
        self.h, self.window, self.q8 = hkv * g, window, q8
        self.scale = hd ** -0.5
        rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa
        qd, kd, vd = self.h * hd, hkv * hd, hkv * hdv
        qkv = rn(b, 1, qd + kd + vd).to(dtype)
        self.q = qkv[..., :qd].reshape(b, 1, self.h, hd).contiguous()
        self.kn = qkv[..., qd:qd + kd].reshape(b, 1, hkv, hd).contiguous()
        self.vn = qkv[..., qd + kd:].reshape(b, 1, hkv, hdv)
        self.start = (starts if torch.is_tensor(starts)
                      else _starts(starts, b, s, gen))
        kf, vf = rn(b, s, hkv, hd), rn(b, s, hkv, hdv)
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

    def call(self, lib=None, rows=None, heads=None):
        """A function of no arguments running one call on the next cache
        copy: the wrapper, or ``lib`` (a variant) with ``rows`` or
        ``heads`` (query heads per block) forced."""
        if lib is None and rows is None and heads is None:
            f = da.decode_attention_int8 if self.q8 else da.decode_attention
            return lambda: f(self.q, self.kn, self.vn, *self._next(),
                             self.start, self.window, scale=self.scale)

        launch = (functools.partial(_launch_parent, lib)
                  if getattr(lib, "parent", False)
                  else functools.partial(da._launch, lib=lib, heads=heads))

        def run():
            c = self._next()
            return launch(self.q, self.kn, self.vn, c[0], c[1],
                          c[2] if self.q8 else None,
                          c[3] if self.q8 else None, self.start,
                          self.window, self.scale, rows=rows)
        return run

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

    def composed(self):
        """A function of no arguments running the composed decode step's
        attention on the next cache copy, as ``_softmax_attention`` runs it
        where the gate says no: the rows written by one ``write_rows_pair``
        launch (#5/#6; int8 quantized first), then the plain attention
        over the cache (``models/transformer.py:_attention``)."""
        from vlut_tpu_torch.models.transformer import _SlotKV, _attention

        names = ("k", "v", "k_scale", "v_scale") if self.q8 else ("k", "v")
        k_pos = torch.arange(self.s, device=self.q.device)[None, :].expand(
            self.b, self.s)
        q_pos = self.start[:, None]

        def run():
            kv = _SlotKV({n: [t] for n, t in zip(names, self._next())}, 0,
                         None)
            k, v, ks, vs = kv.update(self.kn, self.vn, self.start)
            return _attention(self.q, k, v, q_pos, k_pos, self.hd,
                              scale=self.scale, k_scale=ks, v_scale=vs,
                              window=self.window)
        return run

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


def check_case(case, rows=None, lib=None,
               heads=None) -> tuple[str | None, float]:
    """The kernel (forced to ``rows`` per block, ``heads`` query heads per
    block) against the plain version on a copy of the cache, and a second
    call on another copy bit-equal to the first: (None, largest error) or
    (what differs, error)."""
    c = case.copies[0]
    want_out, want_cache = case.want(c)
    outs, top = [], 0.0
    for _ in range(2):
        mine = [t.clone() for t in c]
        out = da._launch(case.q, case.kn, case.vn, mine[0], mine[1],
                         mine[2] if case.q8 else None,
                         mine[3] if case.q8 else None, case.start,
                         case.window, case.scale, rows=rows, lib=lib,
                         heads=heads)
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


def plan(case, sms) -> int:
    """The rows per block the wrapper plans for the case."""
    groups = da.head_groups(case.g, case.hd, case.hdv)[1]
    return da.attn_plan(case.b, case.hkv, da.span(case.s, case.window), sms,
                        groups, da.value_slices(case.hd, case.hdv))


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
        out.append(dict(label=label, rows=rows or plan(case, sms),
                        why=why, max_abs_err=err))

    for q8 in (False, True):
        for i, (b, hkv, s, g) in enumerate(da.PLAN_SHAPES):
            hd = 256 if i % 3 == 2 and g <= 8 else 128
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
        # head groups (G 71: five of 15, 15, 15, 15, 11) and hdv != hd with
        # large values in the rows a slot does not see
        for g, hd, hdv in ((71, 128, 128), (7, 256, 128), (3, 128, 512),
                           *WIDE):
            case = Case(gen, 5, s, 1, g, hd, 37, st, q8, rotate=False,
                        hdv=hdv)
            hide_rows(case)
            one(f"edges G={g} hd={hd} hdv={hdv} window=37 q8={q8}", case)
        # the wide path over several splits, every rows-per-block choice
        case = Case(gen, 3, 700, 2, 7, 768, 0, "fill", q8, rotate=False,
                    hdv=1152)
        for rows in da.ROWS:
            one(f"forced wide G=7 hd=768 hdv=1152 q8={q8}", case, rows)
        del case
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
    ap.add_argument("--composed", action="store_true",
                    help="after the checks, only COMPOSED_SWEEP")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma-separated SHAPES labels to time (default: all)")
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
    edits = dict(ABLATIONS) if args.ablate else {}
    if args.timeline:
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
    emit(card=card, sms=sms, variants=sorted(dirs))

    results = check(gen)
    bad = [r for r in results if r["why"]]
    for r in bad:
        emit(mismatch=r)
    emit(checked=len(results), mismatches=len(bad),
         max_abs_err=max(r["max_abs_err"] for r in results))
    if bad or args.check_only:
        return 1 if bad else 0
    if args.composed:
        return composed_sweep(gen, card)

    shapes = [sh for sh in SHAPES
              if not args.only or sh[0] in args.only.split(",")]
    for label, b, s, hkv, g, hd, hdv, window, starts in shapes:
        for q8 in (False, True):
            case = Case(gen, b, s, hkv, g, hd, window, starts, q8,
                        rotate=True, hdv=hdv)
            others = {v: lib for v, lib in libs.items()
                      if v not in edits and takes(lib, case)}
            want_out, want_cache = case.want(case.copies[0])
            outs = {}
            for v, lib in [(None, None), *others.items()]:
                mine = [t.clone() for t in case.copies[0]]
                saved, case.copies[0] = case.copies[0], mine
                case.i = len(case.copies) - 1
                outs[v] = out = case.call(lib)()
                torch.cuda.synchronize()
                case.copies[0] = saved
                why, _ = _same(out, mine, want_out, want_cache)
                if why:
                    emit(mismatch=[v or "kernel", label, q8], why=why)
                    return 1
            row = {"shape": label, "b": b, "s": s, "hkv": hkv, "g": g,
                   "hd": hd, "hdv": hdv, "window": window, "q8": q8,
                   "rows": case.rows(), "plan": plan(case, sms),
                   "heads_groups": da.head_groups(g, hd, hdv),
                   "same_bits": {v: torch.equal(outs[v], outs[None])
                                 for v in others}}
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

    if args.timeline:
        timeline(libs["timeline"], gen, card)
    if args.sweep:
        for label, b, s, hkv, g, hd, hdv, window, starts in shapes:
            for q8 in (False, True):
                case = Case(gen, b, s, hkv, g, hd, window, starts, q8,
                            rotate=True, hdv=hdv)
                us = {r: graph_us(case.call(rows=r), 20) for r in da.ROWS}
                emit(sweep=label, q8=q8, plan=plan(case, sms),
                     best=min(us, key=us.get), us=us, card=card)
                # heads per block (each at the rows the plan gives its
                # groups): 4 up to the most a block holds, and G
                most = da.head_groups(64, hd, hdv)[0]
                if g > 4:
                    hus = {}
                    for heads in sorted({*range(4, min(g, most) + 1, 4),
                                         min(g, most)}):
                        groups = -(-g // heads)
                        rows = da.attn_plan(b, hkv, da.span(s, window), sms,
                                            groups, da.value_slices(hd, hdv))
                        why, _ = check_case(case, rows, heads=heads)
                        hus[heads] = why or graph_us(
                            case.call(rows=rows, heads=heads), 20)
                    timed = {k: v for k, v in hus.items()
                             if not isinstance(v, str)}
                    emit(sweep_heads=label, q8=q8,
                         plan=da.head_groups(g, hd, hdv),
                         best=min(timed, key=timed.get), us=hus, card=card)
                del case
                torch.cuda.empty_cache()
    return 0


def composed_sweep(gen, card) -> int:
    """--composed: the kernel and the composed step (``Case.composed``),
    each in a CUDA graph, at ``COMPOSED_SWEEP`` (starts spread over S / 16
    to S - 1), with the gate's choice (``fused_pays``) beside which was
    faster."""
    for b, s, hkv, g, hd, hdv in COMPOSED_SWEEP:
        for q8 in (False, True):
            case = Case(gen, b, s, hkv, g, hd, 0, "fill", q8, rotate=True,
                        hdv=hdv)
            us = graph_us(case.call(), 20)
            composed_us = graph_us(case.composed(), 20)
            emit(composed_sweep=[b, s, hkv, g, hd, hdv], q8=q8,
                 rows=case.rows(), slices=da.value_slices(hd, hdv),
                 heads_groups=da.head_groups(g, hd, hdv), kernel_us=us,
                 composed_us=composed_us,
                 fused_pays=da.fused_pays(hkv * g, hkv, hd, hdv), card=card)
            del case
            torch.cuda.empty_cache()
    return 0


def timeline(lib, gen, card) -> None:
    """Per-block global-timer stamps at the flagship shapes (ns after the
    first block's entry: min / median / max over the blocks that reach each
    point), from one call."""
    lib.vlut_span_read.restype = _I
    lib.vlut_span_read.argtypes = [_P]
    for label, b, s, hkv, g, hd, hdv, window, starts in SHAPES[:3]:
        for q8 in (False, True):
            case = Case(gen, b, s, hkv, g, hd, window, starts, q8,
                        rotate=True, hdv=hdv)
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
