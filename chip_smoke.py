#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):
  1. build the CUDA kernels from vlut_tpu_torch/csrc with nvcc (sm_90a);
  2. hold every kernel against its plain PyTorch version on the card at the
     serving path's shapes, and time kernel, plain version, one library call
     and the card's lower bound for the same work (kernel and library call
     timed inside a CUDA graph, so the time is the device's);
  3. the flagship: llama3_8b_158 at full width and depth, prefill 32 x 128
     plus greedy batched decode (vlut_tpu_torch/bench/flagship.py), with the
     composed decode attention (row write #5 + PyTorch) and the fused one
     (#7);
  4. real weights: tests/fixtures/tiny_real through the port's ``batched``
     path on the card and on the CPU; the greedy tokens must be identical;
  5. the slot engine at the flagship's full width: 32 slots, ctx 2048, 48
     greedy requests of 64-1500 prompt tokens (vlut_tpu_torch/bench/
     engine.py), with the bf16 and the q8 cache, each with the fused and
     the composed decode attention (the A/B of ms per decode step);
  6. tiny_real through the engine on the card and on the CPU, bf16 and q8
     cache: identical greedy tokens;
  7. the completion server over the flagship engine (tiny_real's tokenizer
     for text): 8 concurrent /completion requests, one streaming, must
     answer 200 with the tokens of a direct Engine.run;
  8. the kernel microbenchmark (vlut_tpu_torch/bench/kernels.py) at the
     llama3_8b shapes, M 32 and 256: i2/i1 through #3, TQ2_0/TQ1_0 through
     #9, one JSON line per row;
  9. the end-to-end benches (vlut_tpu_torch/bench/e2e.py): bench_sweep of
     llama3_8b_158 at full width and depth in i2 and in i1 (pp 512, tg 32,
     batch 1 and 32) and one batched_bench (npp 128, ntg 32, npl 32);
 10. perplexity of tiny_real over the first 1,024 bytes of SURVEY.md
     (window 128) on the card and on the CPU (relative 1e-4), and the
     quantized-vs-dequant KL on the card (mean < 0.05, top-1 > 0.95);
 11. tiny_real requantized to i1 (convert/quantize.py) gives the i2
     model's greedy ``batched`` tokens on the card; ``inspect`` of both;
 12. one JSON line of every kernel with its launches on the paths of phases
     3-11, then the card, then ``{"ok": true, "device": ...}`` last.

Phase 2 also holds #9 (the TQ2_0/TQ1_0 GEMM) against its plain version at
the llama3_8b shapes (dxd, dxff, ffxd) for both formats at M 32 and 256:
the float32 sum runs in the same order in both, so they must be equal bit
for bit (max |err| 0).  It then checks, without timing them, the kernels
at the shapes the later phases give them: #1 at every flagship projection
in i2 and i1 at M 1 and 32 (the e2e benches' decode), #3 bit-exact in i2
and i1 at the microbenchmark's lanes (M 32 and 256) and at the e2e
prefills (M 512 and 16384), and #7 at the e2e benches' caches.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth, int8 tensor rate and
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Device ms per call of ``fn`` from CUDA events.  With ``graph`` the
    ``iters`` calls are captured in one CUDA graph and replayed, so the time
    is the device's alone (a small kernel launched from Python otherwise
    measures the host's dispatch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def library_ms(fn, iters: int = 20) -> float | None:
    """Time of the one-call library yardstick, or None where this PyTorch
    build refuses the call (it is a comparison, not part of the port)."""
    try:
        return cuda_ms(fn, iters=iters, graph=True)
    except RuntimeError as e:
        print(f"library call unavailable: {e}", file=sys.stderr, flush=True)
        return None


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Rotation:
    """Copies of a weight whose total exceeds the 50 MB L2 cache, cycled so
    every timed call reads its weight from device memory, as a decode step
    does."""

    def __init__(self, t, min_total: int = 128 << 20):
        n = max(1, math.ceil(min_total / max(1, t.numel() * t.element_size())))
        self.copies = [t] + [t.clone() for _ in range(n - 1)]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]


def check_float_prologue(name, got, want, codes_k, codes_p, xs, ws, res):
    """Float-prologue tolerance: the sums of squares are reduced in another
    order than in the plain version, so an int8 code may differ by 1 in at
    most 0.1% of entries; the outputs then agree to within (differing codes
    in the row + 1) code steps times the scales, plus one bf16 step of the
    product before and after the residual add."""
    import torch

    d = (codes_k.int() - codes_p.int()).abs()
    if int(d.max()) > 1 or float((d > 0).float().mean()) > 1e-3:
        fail(f"{name}: prologue codes differ (max {int(d.max())}, "
             f"share {float((d > 0).float().mean()):.2e})")
    ndiff = (d > 0).sum(dim=1, keepdim=True).float()
    mag = want.float().abs()
    if res is not None:
        mag = mag + torch.nn.functional.pad(
            res.float().abs(), (0, want.shape[1] - res.shape[1]))
    tol = (ndiff + 1) * xs.reshape(-1, 1) * ws[None, :] + 2.0 ** -6 * mag
    err = (got.float() - want.float()).abs()
    if bool((err > tol).any()):
        fail(f"{name}: kernel vs plain beyond tolerance (max {float(err.max())})")
    return float(err.max())


def phase_kernels(dev) -> dict:
    import torch

    from vlut_tpu_torch.ops import kv_update, ternary_gemm as tg
    from vlut_tpu_torch.ops.quant import quantize_activations
    from vlut_tpu_torch.ops.packing import (
        TRITS_PER_BYTE, DEFAULT_BLOCK, padded_k, random_packed_bytes,
        unpack_fields)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = {}

    def rand_packed(k, n, fmt):
        return random_packed_bytes(
            (padded_k(k, fmt) // TRITS_PER_BYTE[fmt], n), fmt, gen, dev)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def trits_i8(packed, fmt, k):
        return (unpack_fields(packed, fmt, DEFAULT_BLOCK[fmt])[:k]
                .to(torch.int8) - 1).contiguous()

    def record(name, **kw):
        agg = results.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "library_ms": 0.0,
                                        "max_abs_err": 0.0, "shapes": []})
        for key in ("ms", "plain_ms", "bound_ms"):
            agg[key] += kw[key]
        agg["library_ms"] = (None if kw["library_ms"] is None
                             or agg["library_ms"] is None
                             else agg["library_ms"] + kw["library_ms"])
        agg["max_abs_err"] = max(agg["max_abs_err"], kw["max_abs_err"])
        agg["bound_by"] = kw["bound_by"]
        agg["shapes"].append(kw["shape"])
        print(json.dumps({"phase": "kernels", "kernel": name, **kw}),
              flush=True)

    def decode_case(label, m, k, n, mode, sub, has_res, fmt):
        """#1's inputs at one projection, held against its plain version;
        returns the inputs, the call's keywords and the largest error."""
        packed = rand_packed(k, n, fmt)
        ws = torch.full((n,), 0.05, device=dev)
        if mode == "plain":
            x1 = randn(m, k, dtype=torch.float32)
        elif mode == "silu_mul":
            gu = randn(m, 2 * k)
            x1 = gu[:, :k]
        else:
            x1 = randn(m, k)
        kw = dict(x2=gu[:, k:] if mode == "silu_mul" else None,
                  norm_g=(torch.rand(k, generator=gen, device=dev) + 0.5
                          if mode == "norm" or sub else None),
                  residual=randn(m, n) if has_res else None, fmt=fmt,
                  kb=DEFAULT_BLOCK[fmt], k=k, mode=mode, sub_norm=sub,
                  norm_n=k, eps=1e-5, out_dtype=torch.bfloat16)
        got = tg.ternary_gemm_decode(x1, packed, ws, **kw)
        x2, g, res = kw["x2"], kw["norm_g"], kw["residual"]
        xq_p, xs_p = tg.decode_prologue(x1, x2, g, mode, sub, k, 1e-5)
        want = tg._gemm_plain(xq_p, xs_p, packed, ws, fmt, DEFAULT_BLOCK[fmt],
                              k, res, torch.bfloat16)
        torch.cuda.synchronize()
        if mode == "plain":
            err = float((got.float() - want.float()).abs().max())
            if err != 0.0:
                fail(f"decode {label}: integer path differs ({err})")
        else:
            kp = packed.shape[0] * TRITS_PER_BYTE[fmt]
            codes_k = tg.prologue_codes(x1, x2, g, mode, sub, k, 1e-5, fmt,
                                        DEFAULT_BLOCK[fmt], kp)[0][:, :k]
            err = check_float_prologue(f"decode {label}", got, want, codes_k,
                                       xq_p, xs_p, ws, res)
        return x1, packed, ws, kw, xq_p, err

    def tiled_case(label, m, k, n, fmt):
        """#3's inputs at one shape, bit-exact against its plain version."""
        kb = DEFAULT_BLOCK[fmt]
        packed = rand_packed(k, n, fmt)
        ws = torch.full((n,), 0.05, device=dev)
        xq, xs = quantize_activations(randn(m, k))
        got = tg.ternary_gemm_tiled(xq, packed, xs, ws, fmt=fmt, kb=kb, k=k)
        want = tg._gemm_plain(xq, xs, packed, ws, fmt, kb, k, None,
                              torch.float32)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"tiled {label}: differs ({err})")
        return packed, ws, xq, xs, err

    # --- #1 fused decode projection: one decode layer of the flagship -------
    m = 32
    # (label, K, N, mode, sub_norm, residual?, fmt, in the flagship layer?)
    shapes = [
        ("qkv", 4096, 6144, "norm", False, False, "i2", True),
        ("wo", 4096, 4096, "plain", False, True, "i2", True),
        ("gateup", 4096, 28672, "norm", False, False, "i2", True),
        ("down", 14336, 4096, "silu_mul", False, True, "i2", True),
        ("qkv_i1", 4096, 6144, "norm", False, False, "i1", False),
        ("down_subnorm", 14336, 4096, "silu_mul", True, True, "i2", False),
    ]
    for label, k, n, mode, sub, has_res, fmt, main_path in shapes:
        x1, packed, ws, kw, xq_p, err = decode_case(label, m, k, n, mode, sub,
                                                    has_res, fmt)
        x2, g, res, od = (kw["x2"], kw["norm_g"], kw["residual"],
                          kw["out_dtype"])
        rot = Rotation(packed)
        ms = cuda_ms(lambda: tg.ternary_gemm_decode(x1, rot.next(), ws, **kw),
                     graph=True)
        # the same calls launched one by one from Python: the host's
        # dispatch per call, which bounds a decode step that is not graphed
        eager_ms = cuda_ms(lambda: tg.ternary_gemm_decode(x1, rot.next(), ws,
                                                          **kw))
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.decode_prologue(x1, x2, g, mode, sub, k, 1e-5), packed, ws,
            fmt, DEFAULT_BLOCK[fmt], k, res, od), iters=3, warmup=1)
        w8 = Rotation(trits_i8(packed, fmt, k))
        lib_ms = library_ms(lambda: torch._int_mm(xq_p, w8.next()))
        in_b = x1.element_size() * m * k * (2 if x2 is not None else 1)
        nbytes = (in_b + packed.numel() + 4 * n + (4 * k if g is not None else 0)
                  + (2 * m * n if res is not None else 0) + 2 * m * n)
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        name = ("ternary_gemm_decode" if main_path
                else "ternary_gemm_decode_other")
        record(name, shape=f"{label} M={m} {k}->{n} {fmt} {mode}"
               f"{'+sub' if sub else ''}{'+res' if has_res else ''}",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, eager_ms=eager_ms)
        del rot, w8

    # --- #4 fused-quant GEMM: the unfused tree's projections at M = 32 ------
    for label, k, n in (("wq", 4096, 4096), ("wk", 4096, 1024),
                        ("wv", 4096, 1024), ("w_gate", 4096, 14336),
                        ("w_up", 4096, 14336), ("w_down", 14336, 4096)):
        packed = rand_packed(k, n, "i2")
        ws = torch.full((n,), 0.05, device=dev)
        x = randn(m, k)
        got = tg.ternary_gemm_fused_quant(x, packed, ws, fmt="i2", kb=128, k=k)
        xq, xs = tg.kernel_quantize(x)
        want = tg._gemm_plain(xq, xs, packed, ws, "i2", 128, k, None,
                              torch.float32)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"fused_quant {label}: differs ({err})")
        rot = Rotation(packed)
        ms = cuda_ms(lambda: tg.ternary_gemm_fused_quant(
            x, rot.next(), ws, fmt="i2", kb=128, k=k), graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.kernel_quantize(x), packed, ws, "i2", 128, k, None,
            torch.float32), iters=3, warmup=1)
        w8 = Rotation(trits_i8(packed, "i2", k))
        lib_ms = library_ms(lambda: torch._int_mm(xq, w8.next()))
        nbytes = 2 * m * k + packed.numel() + 4 * n + 4 * m * n
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record("ternary_gemm_fused_quant", shape=f"{label} M={m} {k}->{n} i2",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err)

    # --- #3 tiled GEMM: the flagship prefill's projections at M = 4096 ------
    m = 4096
    for label, k, n, fmt in (("qkv", 4096, 6144, "i2"),
                             ("wo", 4096, 4096, "i2"),
                             ("gateup", 4096, 28672, "i2"),
                             ("down", 14336, 4096, "i2"),
                             ("qkv_i1", 4096, 6144, "i1")):
        kb = DEFAULT_BLOCK[fmt]
        packed, ws, xq, xs, err = tiled_case(label, m, k, n, fmt)
        ms = cuda_ms(lambda: tg.ternary_gemm_tiled(xq, packed, xs, ws, fmt=fmt,
                                                   kb=kb, k=k), iters=5,
                     graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            xq, xs, packed, ws, fmt, kb, k, None, torch.float32),
            iters=2, warmup=1)
        w8 = trits_i8(packed, fmt, k)
        lib_ms = library_ms(lambda: torch._int_mm(xq, w8), iters=5)
        del w8
        nbytes = m * k + 4 * m + packed.numel() + 4 * n + 4 * m * n
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        name = "ternary_gemm_tiled" if fmt == "i2" else "ternary_gemm_tiled_other"
        record(name, shape=f"{label} M={m} {k}->{n} {fmt}", ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err)
        torch.cuda.empty_cache()

    # --- #5/#6 KV row writer on the flagship's per-layer cache --------------
    b, s, h, d = 32, 184, 8, 128
    kc, vc = randn(b, s, h, d), randn(b, s, h, d)
    ku, vu = randn(b, 1, h, d), randn(b, 1, h, d)
    start = torch.randint(0, s, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    wk, wv = kc.clone(), vc.clone()
    kv_update._write_plain(wk, ku, start)
    kv_update._write_plain(wv, vu, start)
    kv_update.write_rows_pair(kc, vc, ku, vu, start)
    one = randn(b, s, h, d)
    w1 = one.clone()
    kv_update._write_plain(w1, ku, start)
    kv_update.write_rows(one, ku, start)
    torch.cuda.synchronize()
    for got, want in ((kc, wk), (vc, wv), (one, w1)):
        if not torch.equal(got, want):
            fail("KV row writer differs from the indexed assignment")
    ms = cuda_ms(lambda: kv_update.write_rows_pair(kc, vc, ku, vu, start),
                 iters=100, graph=True)
    plain_ms = cuda_ms(lambda: (kv_update._write_plain(kc, ku, start),
                                kv_update._write_plain(vc, vu, start)),
                       iters=100)
    idx = (torch.arange(b, device=dev), start.long())
    lib_ms = cuda_ms(lambda: (kc.index_put_(idx, ku[:, 0]),
                              vc.index_put_(idx, vu[:, 0])), iters=100,
                     graph=True)
    b_ms, by = bound_ms(2 * 2 * b * h * d * 2 + 4 * b, 0)
    record("write_rows_pair", shape=f"pair B={b} S={s} Hkv={h} hd={d} bf16",
           ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
           library_ms=lib_ms, max_abs_err=0.0)
    del kc, vc, wk, wv, one, w1
    decode_attention_kernels(dev, gen, record)
    tq_kernels(dev, gen, record)

    # --- the other paths' shapes, checked and not timed ---------------------
    def checked(name, shape, err):
        agg = results[name]
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg.setdefault("checked", []).append(shape)
        print(json.dumps({"phase": "kernels_check", "kernel": name,
                          "shape": shape, "max_abs_err": err}), flush=True)

    # #1 in the e2e benches' decode: every flagship projection, i2 and i1,
    # at batch 1 and 32
    for fmt in ("i2", "i1"):
        for m in (1, 32):
            for label, k, n, mode, sub, has_res, _, _ in shapes[:4]:
                err = decode_case(label, m, k, n, mode, sub, has_res, fmt)[-1]
                checked("ternary_gemm_decode",
                        f"{label} M={m} {k}->{n} {fmt} {mode}", err)
    # #3 in the microbenchmark's i2/i1 lanes (llama3_8b dxd, dxff, ffxd at
    # M 32 and 256) and in the e2e benches' prefills (pp 512 at batch 1 and
    # 32: M 512 and 16384)
    lanes = [(tag, m, k, n) for tag, k, n in (("dxd", 4096, 4096),
                                              ("dxff", 4096, 14336),
                                              ("ffxd", 14336, 4096))
             for m in (32, 256)]
    lanes += [(label, m, k, n) for label, k, n, *_ in shapes[:4]
              for m in (512, 16384)]
    for fmt in ("i2", "i1"):
        for label, m, k, n in lanes:
            err = tiled_case(label, m, k, n, fmt)[-1]
            checked("ternary_gemm_tiled", f"{label} M={m} {k}->{n} {fmt}",
                    err)
            torch.cuda.empty_cache()
    # #7 in the e2e benches' decode: bench_sweep's tg from an empty cache
    # (S 552) at batch 1 and 32, batched_bench's after a 128-token prefill
    for b, s, first in ((1, 552, 0), (1, 552, 31), (32, 552, 0),
                        (32, 168, 128)):
        err = attention_case(dev, gen, b, s, first)
        checked("decode_attention", f"B={b} S={s} start={first}+", err)
    return results


def attention_case(dev, gen, b: int, s: int, first: int) -> float:
    """#7 at the llama3_8b heads (8 KV heads of 32, hd 128), slot i at start
    first + i, against its plain version (rows equal, output to rtol and
    atol 2e-5)."""
    import torch

    from vlut_tpu_torch.ops import decode_attention as da

    hkv, h, hd = 8, 32, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    start = first + torch.arange(b, device=dev, dtype=torch.int32)
    q, kn, vn = randn(b, 1, h, hd), randn(b, 1, hkv, hd), randn(b, 1, hkv, hd)
    kc = randn(b, s, hkv, hd).to(torch.bfloat16)
    vc = randn(b, s, hkv, hd).to(torch.bfloat16)
    kw, vw = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, kn, vn, kw, vw, start, 0,
                                     scale=hd ** -0.5)
    got = da.decode_attention(q, kn, vn, kc, vc, start, 0, scale=hd ** -0.5)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kw) and torch.equal(vc, vw)):
        fail(f"decode_attention B={b} S={s}: cache rows differ")
    err = (got - want).abs()
    if bool((err > ATT_ATOL + ATT_RTOL * want.abs()).any()):
        fail(f"decode_attention B={b} S={s}: beyond tolerance "
             f"(max {float(err.max())})")
    return float(err.max())


def tq_kernels(dev, gen, record) -> None:
    """#9 at the microbenchmark's llama3_8b shapes, tq2 and tq1, M 32 and
    256, with the bench's tile choice bk = 2048.  Kernel and plain version
    sum in the same float order: bit-exact.  The library yardstick is one
    float16 ``torch.matmul`` of the int8 codes with the weight dequantized
    to float16 beforehand (trits times the block scale; codes and scales
    are exact in float16)."""
    import torch

    from vlut_tpu_torch.bench.kernels import rand_packed
    from vlut_tpu_torch.ops import tq

    for fmt in ("tq2", "tq1"):
        for label, k, n in (("dxd", 4096, 4096), ("dxff", 4096, 14336),
                            ("ffxd", 14336, 4096)):
            packed = rand_packed(fmt, k, n, gen, dev)
            scales = (torch.rand((k // tq.QK, n), generator=gen, device=dev)
                      * 0.06 + 0.01).to(torch.float16)
            wf = (tq.tq_trits(packed, fmt).to(torch.float16)
                  * scales.repeat_interleave(tq.QK, dim=0))
            rot = Rotation(packed)
            wrot = Rotation(wf)
            for m in (32, 256):
                xq = torch.randint(-127, 128, (m, k), generator=gen,
                                   device=dev, dtype=torch.int32).to(torch.int8)
                xs = torch.rand((m, 1), generator=gen, device=dev) * 0.01
                got = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=2048)
                want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt,
                                        bk=2048)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    fail(f"tq_gemm {fmt} {label} M={m}: differs from the "
                         f"plain version (max {err})")
                ms = cuda_ms(lambda: tq.tq_gemm(xq, rot.next(), scales, xs,
                                                fmt=fmt, bk=2048), graph=True)
                plain_ms = cuda_ms(lambda: tq.tq_gemm_plain(
                    xq, packed, scales, xs, fmt=fmt, bk=2048), iters=2,
                    warmup=1)
                xh = xq.to(torch.float16)
                lib_ms = library_ms(lambda: torch.matmul(xh, wrot.next()))
                b_ms, by = bound_ms(bench_bytes(fmt, m, k, n), 2 * m * k * n)
                record("tq_gemm", shape=f"{label} M={m} {k}->{n} {fmt}",
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                       library_ms=lib_ms, max_abs_err=err,
                       library="float16 torch.matmul of the codes and the "
                       "weight dequantized to float16 beforehand")
                del want, got
            del rot, wrot, wf
            torch.cuda.empty_cache()


ATT_RTOL = ATT_ATOL = 2e-5


def decode_attention_kernels(dev, gen, record) -> None:
    """#7 and #8 at the flagship engine's shapes (B 32, S 2048, 8 KV heads
    of 32 query heads, hd 128), starts spread over 64-1900, without and
    with a 512-row window.  Cache rows, codes and scales must equal the
    plain version's; the attention output is float32 summed in another
    order, held to rtol and atol 2e-5."""
    import torch
    import torch.nn.functional as F

    from vlut_tpu_torch.ops import decode_attention as da
    from vlut_tpu_torch.runtime.kv_cache import dequantize_kv, quantize_kv

    b, s, hkv, g, hd = 32, 2048, 8, 4, 128
    h = hkv * g
    scale = hd ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    start = torch.linspace(64, 1900, b, device=dev).round().to(torch.int32)
    start = start[torch.randperm(b, generator=gen, device=dev)]
    q, kn, vn = randn(b, 1, h, hd), randn(b, 1, hkv, hd), randn(b, 1, hkv, hd)
    kf, vf = randn(b, s, hkv, hd), randn(b, s, hkv, hd)
    kq, ksc = quantize_kv(kf)
    vq, vsc = quantize_kv(vf)
    rows_idx = torch.arange(s, device=dev)[None, :]

    def check(name, got, want, caches):
        torch.cuda.synchronize()
        for mine, theirs in caches:
            if not torch.equal(mine, theirs):
                fail(f"{name}: cache rows differ from the plain version")
        err = (got - want).abs()
        if bool((err > ATT_ATOL + ATT_RTOL * want.abs()).any()):
            fail(f"{name}: attention beyond tolerance (max {float(err.max())})")
        return float(err.max())

    for window in (0, 512):
        visible = rows_idx < start.long()[:, None]
        if window:
            visible &= rows_idx > (start.long()[:, None] - window)
        rows = int(visible.sum())  # visible cache rows over all slots
        ops = 4.0 * rows * h * hd
        out_b = b * h * hd * 4
        mask = visible[:, None, None, :]
        suffix = "" if window == 0 else "_window"
        shape = (f"B={b} S={s} H={h} Hkv={hkv} hd={hd} window={window} "
                 f"rows={rows}")

        # #7: bf16 cache
        kc, vc = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        kw, vw = kc.clone(), vc.clone()
        want = da.decode_attention_plain(q, kn, vn, kw, vw, start, window,
                                         scale=scale)
        got = da.decode_attention(q, kn, vn, kc, vc, start, window,
                                  scale=scale)
        err = check("decode_attention" + suffix, got, want,
                    ((kc, kw), (vc, vw)))
        ms = cuda_ms(lambda: da.decode_attention(q, kn, vn, kc, vc, start,
                                                 window, scale=scale),
                     graph=True)
        plain_ms = cuda_ms(lambda: da.decode_attention_plain(
            q, kn, vn, kw, vw, start, window, scale=scale), iters=3, warmup=1)
        qb = q.transpose(1, 2).to(torch.bfloat16)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
            qb, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True))
        nbytes = rows * hkv * hd * 2 * 2 + out_b * 2 + b * hkv * hd * 2 * 4
        b_ms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
        record("decode_attention" + suffix, shape=shape + " bf16", ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err,
               library="scaled_dot_product_attention(enable_gqa) over the "
               "bf16 rows")
        del kc, vc, kw, vw, kt, vt

        # #8: int8 codes + float32 scales
        kc, vc, ks, vs = kq.clone(), vq.clone(), ksc.clone(), vsc.clone()
        ref = [t.clone() for t in (kc, vc, ks, vs)]
        want = da.decode_attention_int8_plain(q, kn, vn, *ref, start, window,
                                              scale=scale)
        got = da.decode_attention_int8(q, kn, vn, kc, vc, ks, vs, start,
                                       window, scale=scale)
        err = check("decode_attention_int8" + suffix, got, want,
                    zip((kc, vc, ks, vs), ref))
        ms = cuda_ms(lambda: da.decode_attention_int8(
            q, kn, vn, kc, vc, ks, vs, start, window, scale=scale), graph=True)
        plain_ms = cuda_ms(lambda: da.decode_attention_int8_plain(
            q, kn, vn, *ref, start, window, scale=scale), iters=3, warmup=1)
        kd = dequantize_kv(kc, ks, torch.bfloat16).transpose(1, 2)
        vd = dequantize_kv(vc, vs, torch.bfloat16).transpose(1, 2)
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(
            qb, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True))
        nbytes = (rows * hkv * (hd + 4) * 2 + out_b * 2
                  + b * hkv * hd * 4 * 2 + b * hkv * (hd + 4) * 2)
        b_ms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
        record("decode_attention_int8" + suffix, shape=shape + " int8",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err,
               library="scaled_dot_product_attention(enable_gqa) over the "
               "cache dequantized to bf16 beforehand")
        del kc, vc, ks, vs, ref, kd, vd
        torch.cuda.empty_cache()


def main() -> None:
    t_start = time.time()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        import vlut_tpu_torch
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if pathlib.Path(vlut_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("vlut_tpu_torch was imported from outside this checkout")
    # float32 products in full float32, in matmuls and convolutions alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    from vlut_tpu_torch.ops import _build, kv_update, ternary_gemm as tg
    from vlut_tpu_torch.ops import decode_attention as da
    from vlut_tpu_torch.ops import tq

    # 1. build
    t0 = time.time()
    logs = _build.build_all()
    build_s = time.time() - t0
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": list(logs)}), flush=True)

    # 2. kernels against their plain versions
    kern = phase_kernels(dev)
    torch.cuda.empty_cache()

    counters = {
        "ternary_gemm_decode": tg.ternary_gemm_decode,
        "ternary_gemm_fused_quant": tg.ternary_gemm_fused_quant,
        "ternary_gemm_tiled": tg.ternary_gemm_tiled,
        "write_rows_pair": kv_update.write_rows_pair,
        "decode_attention": da.decode_attention,
        "decode_attention_int8": da.decode_attention_int8,
        "tq_gemm": tq.tq_gemm,
    }
    launches: dict[str, dict[str, int]] = {}

    def reset():
        for f in counters.values():
            f.launches = 0

    def read(path: str, expect: tuple[str, ...]) -> dict[str, int]:
        """The counts of the path just driven; fails if a kernel the path
        runs was launched no time."""
        got = {name: f.launches for name, f in counters.items()}
        launches[path] = got
        for name in expect:
            if got[name] == 0:
                fail(f"{path} path never launched {name}")
        return got

    # 3. flagship at full width and depth, composed then fused attention
    from vlut_tpu_torch.bench import flagship

    built = flagship.build_model("llama3_8b_158", dev)
    ab: dict[str, dict[str, float]] = {}
    for mode, attn_kernel in (("composed", "write_rows_pair"),
                              ("fused", "decode_attention")):
        reset()
        fl = flagship.run("llama3_8b_158", device=dev, decode_attn=mode,
                          built=built)
        got = read(f"flagship_{mode}", ("ternary_gemm_decode",
                                        "ternary_gemm_tiled", attn_kernel))
        ab.setdefault("flagship_batched_S184", {})[mode] = fl["ms_per_step"]
        print(json.dumps({"phase": "flagship", **fl, "launches": got,
                          "card": card}), flush=True)
        torch.cuda.empty_cache()

    # 4. real weights: tiny_real on the card and on the CPU
    from vlut_tpu_torch.cli import run_batched
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    ids = [2] + list(b"The little model reads the lines of its own repo.")
    fixture = ROOT / "tests" / "fixtures" / "tiny_real"
    cfg, gpu_model, _ = load_checkpoint(fixture, device="cuda")
    _, cpu_model, _ = load_checkpoint(fixture, device="cpu")
    reset()
    toks_gpu = run_batched(gpu_model, cfg, ids, 4, 12, temp=0.0,
                           decode_attn="composed").cpu()
    launches_real = read("tiny_real_batched", (
        "ternary_gemm_decode", "ternary_gemm_fused_quant",
        "ternary_gemm_tiled", "write_rows_pair"))
    toks_cpu = run_batched(cpu_model, cfg, ids, 4, 12, temp=0.0,
                           decode_attn="composed")
    same = torch.equal(toks_gpu, toks_cpu)
    print(json.dumps({"phase": "tiny_real", "prompt_tokens": len(ids),
                      "slots": 4, "n": 12, "tokens_gpu": toks_gpu[0].tolist(),
                      "tokens_cpu": toks_cpu[0].tolist(), "identical": same,
                      "launches": launches_real}), flush=True)
    if not same:
        fail("tiny_real greedy tokens differ between the card and the CPU")

    # 5. the slot engine at the flagship's full width
    from vlut_tpu_torch.bench import engine as bench_engine

    engine_out = {}
    for cache in ("bf16", "q8"):
        for mode in ("fused", "composed"):
            attn_kernel = {("bf16", "fused"): "decode_attention",
                           ("q8", "fused"): "decode_attention_int8"}.get(
                               (cache, mode), "write_rows_pair")
            reset()
            out = bench_engine.run(
                device=dev, built=built, kv_quant=cache == "q8",
                decode_attn=mode, profile_steps=4 if cache == "bf16" else 0,
                check_paths=mode == "fused")
            got = read(f"engine_{cache}_{mode}", (
                "ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
            engine_out[(cache, mode)] = out.pop("outputs")
            ab.setdefault(f"engine_{cache}_ctx2048", {})[mode] = out[
                "decode_ms_per_step"]
            print(json.dumps({"phase": "engine", **out, "launches": got,
                              "card": card}), flush=True)
            torch.cuda.empty_cache()
    agree = {}
    for cache in ("bf16", "q8"):
        pairs = [a == b for x, y in zip(engine_out[(cache, "fused")],
                                        engine_out[(cache, "composed")])
                 for a, b in zip(x, y)]
        agree[cache] = sum(pairs) / len(pairs)
    print(json.dumps({"phase": "decode_attn_ab", "ms_per_step": ab,
                      "fused_vs_composed_token_agreement": agree,
                      "card": card}), flush=True)

    # 6. tiny_real through the engine on the card and on the CPU
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    texts = [b"The little model", b"reads the lines", b"of its own repo.",
             b"The", b"little model reads the lines of its own repo.", b"re"]
    for cache in ("bf16", "q8"):
        outs = {}
        for device, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            eng = Engine(cfg, model, n_slots=4, max_len=256,
                         kv_quant=cache == "q8")
            reqs = [Request(prompt=[2] + list(t), max_new_tokens=12,
                            sampler=SamplerParams(temperature=0.0))
                    for t in texts]
            if device == "cuda":
                reset()
            eng.run(reqs)
            if device == "cuda":
                got = read(f"tiny_real_engine_{cache}", (
                    "decode_attention" if cache == "bf16"
                    else "decode_attention_int8",))
            outs[device] = [r.output for r in reqs]
        same = outs["cuda"] == outs["cpu"]
        print(json.dumps({"phase": "tiny_real_engine", "cache": cache,
                          "tokens_gpu": outs["cuda"][0],
                          "tokens_cpu": outs["cpu"][0], "identical": same,
                          "launches": got}), flush=True)
        if not same:
            fail(f"tiny_real engine ({cache}) tokens differ between the card "
                 "and the CPU")

    # 7. the completion server over the flagship engine
    server_phase(built, fixture, card, reset, read)

    # 8-11. the microbenchmark, the end-to-end benches, perplexity and
    # requantization
    tools_phases(dev, built, fixture, card, reset, read,
                 (cfg, gpu_model, cpu_model, ids, toks_gpu))

    # 12. summary
    replaces = {
        "ternary_gemm_decode": ("vlut_tpu_torch/csrc/ternary_gemm.cu",
                                "vlut_tpu/ops/pallas_gemm.py:676"),
        "ternary_gemm_fused_quant": ("vlut_tpu_torch/csrc/ternary_gemm.cu",
                                     "vlut_tpu/ops/pallas_gemm.py:336"),
        "ternary_gemm_tiled": ("vlut_tpu_torch/csrc/ternary_gemm.cu",
                               "vlut_tpu/ops/pallas_gemm.py:223"),
        "write_rows_pair": ("vlut_tpu_torch/csrc/kv_update.cu",
                            "vlut_tpu/ops/kv_update.py:76"),
        "decode_attention": ("vlut_tpu_torch/csrc/decode_attention.cu",
                             "vlut_tpu/ops/decode_attention.py:486"),
        "decode_attention_int8": ("vlut_tpu_torch/csrc/decode_attention.cu",
                                  "vlut_tpu/ops/decode_attention.py:378"),
        "tq_gemm": ("vlut_tpu_torch/csrc/tq_gemm.cu",
                    "vlut_tpu/ops/tq.py:182"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        k = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": sum(path[name] for path in launches.values()),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    print(json.dumps({"launches": launches,
                      "timed_shapes": {n: k["shapes"] for n, k in kern.items()},
                      "checked_shapes": {n: k["checked"] for n, k in kern.items()
                                         if "checked" in k},
                      "seconds": time.time() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def bench_bytes(fmt: str, m: int, k: int, n: int) -> int:
    """Bytes a microbenchmark lane must move: x, the packed weights (and
    the TQ scales, or the i2/i1 channel scales), the row scales and the
    float32 output."""
    from vlut_tpu_torch.ops import tq
    from vlut_tpu_torch.ops.packing import TRITS_PER_BYTE, padded_k

    if fmt in tq.ROWS_PER_BLOCK:
        nb = -(-k // tq.QK)
        return (m * nb * tq.QK + nb * tq.ROWS_PER_BLOCK[fmt] * n
                + 2 * nb * n + 4 * m + 4 * m * n)
    np_ = -(-n // 128) * 128
    return (m * k + padded_k(k, fmt) // TRITS_PER_BYTE[fmt] * np_
            + 4 * np_ + 4 * m + 4 * m * np_)


def tools_phases(dev, built, fixture, card, reset, read, real) -> None:
    """Phases 8-11: the tools of the reference's evaluation loop on the
    card."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import e2e, kernels
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.convert.quantize import requantize
    from vlut_tpu_torch.eval.perplexity import logits_compare, perplexity
    from vlut_tpu_torch.models.transformer import forward

    # 8. the kernel microbenchmark: i2/i1 vs TQ2_0/TQ1_0
    reset()
    rows = kernels.main(["-m", "llama3_8b", "-ns", "32,256", "--fmt",
                         "i2,i1,tq2,tq1"])
    got = read("bench", ("ternary_gemm_tiled", "tq_gemm"))
    for r in rows:
        b_ms, by = bound_ms(bench_bytes(r["fmt"], r["m"], r["k"], r["n"]),
                            2 * r["m"] * r["k"] * r["n"])
        print(json.dumps({"phase": "bench", **r, "bound_us": b_ms * 1e3,
                          "bound_by": by, "card": card}), flush=True)
    print(json.dumps({"phase": "bench", "launches": got}), flush=True)
    torch.cuda.empty_cache()

    # 9. the end-to-end benches at full width and depth, i2 then i1
    i1 = e2e._load_model(None, "llama3_8b_158", "i1", dev)
    for fmt, model in (("i2", built), ("i1", i1)):
        reset()
        out = e2e.bench_sweep(preset="llama3_8b_158", fmt=fmt,
                              n_prompt=(512,), n_gen=(32,), batch=(1, 32),
                              repeats=2, device=dev, built=model)
        got = read(f"bench_sweep_{fmt}", ("ternary_gemm_tiled",
                                          "ternary_gemm_decode",
                                          "decode_attention"))
        for r in out:
            print(json.dumps({"phase": "bench_sweep", "fmt": fmt, **r,
                              "card": card}), flush=True)
        print(json.dumps({"phase": "bench_sweep", "fmt": fmt,
                          "launches": got}), flush=True)
        torch.cuda.empty_cache()
    del i1
    torch.cuda.empty_cache()
    reset()
    out = e2e.batched_bench(preset="llama3_8b_158", npp=(128,), ntg=(32,),
                            npl=(32,), device=dev, built=built)
    got = read("batched_bench", ("ternary_gemm_tiled", "ternary_gemm_decode",
                                 "decode_attention"))
    for r in out:
        print(json.dumps({"phase": "batched_bench", **r, "card": card}),
              flush=True)
    torch.cuda.empty_cache()

    # 10. perplexity of tiny_real, card vs CPU, and the lossless check
    cfg, gpu_model, cpu_model, prompt, toks_i2 = real
    text = np.frombuffer((ROOT / "SURVEY.md").read_bytes()[:1024],
                         np.uint8).astype(np.int32)
    reset()
    ppl_gpu = perplexity(gpu_model, cfg, text, window=128)
    cmp = logits_compare(gpu_model, cfg, text, "auto", "dequant", window=128)
    got = read("ppl", ("ternary_gemm_tiled",))
    ppl_cpu = perplexity(cpu_model, cfg, text, window=128)
    rel = abs(ppl_gpu["ppl"] - ppl_cpu["ppl"]) / ppl_cpu["ppl"]
    print(json.dumps({"phase": "ppl", "tokens": ppl_gpu["tokens"],
                      "window": 128, "ppl_gpu": ppl_gpu["ppl"],
                      "ppl_cpu": ppl_cpu["ppl"], "rel_diff": rel,
                      "quantized_vs_dequant": cmp, "launches": got,
                      "card": card}), flush=True)
    if rel > 1e-4:
        fail(f"tiny_real ppl differs between the card and the CPU ({rel})")
    if not (cmp["kl_mean"] < 0.05 and cmp["top1_agreement"] > 0.95):
        fail(f"quantized vs dequant out of bounds: {cmp}")

    # 11. requantize tiny_real to i1: the same greedy tokens on the card
    with tempfile.TemporaryDirectory() as tmp:
        dst = pathlib.Path(tmp) / "tiny_real_i1"
        requantize(fixture, dst, "i1")
        cfg1, model1, _ = load_checkpoint(dst, device="cuda")
        reset()
        toks_i1 = cli.run_batched(model1, cfg1, prompt, 4, 12, temp=0.0,
                                  decode_attn="composed").cpu()
        got = read("quantize_i1_batched", ("ternary_gemm_decode",
                                           "ternary_gemm_tiled"))
        ids_t = torch.tensor([prompt], device="cuda")
        pos = torch.arange(len(prompt), device="cuda")[None]
        with torch.inference_mode():
            diff = float((forward(gpu_model, cfg, ids_t, pos)[0]
                          - forward(model1, cfg1, ids_t, pos)[0]).abs().max())
        listing = io.StringIO()
        with contextlib.redirect_stdout(listing):
            cli.main(["inspect", str(fixture), "--hash"])
            cli.main(["inspect", str(dst), "--hash"])
        digests = [line for line in listing.getvalue().splitlines()
                   if line.startswith("model digest:")]
    same = torch.equal(toks_i1, toks_i2)
    print(json.dumps({"phase": "quantize", "fmt": cfg1.weight_fmt,
                      "tokens_i2": toks_i2[0].tolist(),
                      "tokens_i1": toks_i1[0].tolist(), "identical": same,
                      "max_abs_logit_diff": diff, "inspect": digests,
                      "launches": got}), flush=True)
    if not same or len(digests) != 2:
        fail("requantized i1 tiny_real gives other greedy tokens on the card "
             "(or inspect failed)")


def server_phase(built, fixture, card, reset, read) -> None:
    """8 concurrent greedy /completion requests (one streaming) to the port's
    server over the flagship model; every answer must be 200, carry the
    tokens of a direct Engine.run of the same prompts, and the server must
    count no error.  The engine loop starts once all 8 are queued, and the
    direct run takes them in the server's queue order, so both prefill the
    same groups (the random flagship amplifies float rounding, which
    differs between batch shapes, into other tokens)."""
    import concurrent.futures as cf
    import http.client

    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams
    from vlut_tpu_torch.serving.server import serve
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model = built
    tok = Tokenizer(fixture)
    texts = [f"Request {i}: " + "the little model reads its own repo. "
             * (1 + 3 * i) for i in range(8)]
    n_new = 16
    reset()
    engine = Engine(cfg, model, n_slots=8, max_len=2048)
    httpd, state = serve(engine, tok, port=0, start_engine=False)
    hostport = ("127.0.0.1", httpd.server_address[1])

    def post(i):
        conn = http.client.HTTPConnection(*hostport, timeout=600)
        body = {"prompt": texts[i], "n_predict": n_new, "temperature": 0.0,
                "ignore_eos": True, "return_tokens": True, "stream": i == 0}
        conn.request("POST", "/completion", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read().decode()
        conn.close()
        if r.status != 200:
            return r.status, None
        if i == 0:
            events = [json.loads(line[6:]) for line in raw.splitlines()
                      if line.startswith("data: ") and line != "data: [DONE]"]
            return r.status, events[-1].get("tokens")
        return r.status, json.loads(raw)["tokens"]

    try:
        t0 = time.time()
        with cf.ThreadPoolExecutor(8) as ex:
            pending = [ex.submit(post, i) for i in range(8)]
            while len(engine.queue) < 8 and time.time() - t0 < 120:
                time.sleep(0.01)
            order = [list(r.prompt) for r in engine.queue]
            state.start()
            answers = [f.result() for f in pending]
        wall = time.time() - t0
        conn = http.client.HTTPConnection(*hostport, timeout=60)
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
        conn.close()
    finally:
        state.stop()
        httpd.shutdown()
        httpd.server_close()
        if state.thread.ident is not None:
            state.thread.join(timeout=60)
    got = read("server", ("ternary_gemm_decode", "decode_attention"))
    direct = [Request(prompt=p, max_new_tokens=n_new,
                      sampler=SamplerParams(temperature=0.0)) for p in order]
    Engine(cfg, model, n_slots=8, max_len=2048).run(direct)
    by_prompt = {tuple(r.prompt): r.output for r in direct}
    errors = [float(line.split()[-1]) for line in metrics.splitlines()
              if line.startswith("vlut_requests_errors_total")]
    same = [toks == by_prompt.get(tuple(tok.encode(t)))
            for (_, toks), t in zip(answers, texts)]
    print(json.dumps({"phase": "server", "requests": len(answers),
                      "status": [a[0] for a in answers],
                      "tokens_equal_direct": same, "wall_s": wall,
                      "requests_errors_total": errors, "launches": got,
                      "card": card}), flush=True)
    if any(a[0] != 200 for a in answers):
        fail(f"server answered {[a[0] for a in answers]}")
    if errors != [0.0]:
        fail(f"server counted errors: {errors}")
    if not all(same):
        fail("server tokens differ from a direct Engine.run")


if __name__ == "__main__":
    main()
