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
  8. one JSON line of every kernel with its launches on the paths of phases
     3-7, then the card, then ``{"ok": true, "device": ...}`` last.

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
        TRITS_PER_BYTE, DEFAULT_BLOCK, padded_k, unpack_fields)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = {}

    def rand_packed(k, n, fmt):
        r = TRITS_PER_BYTE[fmt]
        shape = (padded_k(k, fmt) // r, n)
        if fmt == "i1":
            return torch.randint(0, 243, shape, generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.uint8)
        c = torch.randint(0, 81, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        out = torch.zeros_like(c)
        for q in range(4):
            out |= (c % 3) << (2 * q)
            c = c // 3
        return out.to(torch.uint8)

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
        packed = rand_packed(k, n, fmt)
        ws = torch.full((n,), 0.05, device=dev)
        if mode == "plain":
            x1 = randn(m, k, dtype=torch.float32)
        elif mode == "silu_mul":
            gu = randn(m, 2 * k)
            x1 = gu[:, :k]
        else:
            x1 = randn(m, k)
        x2 = gu[:, k:] if mode == "silu_mul" else None
        g = (torch.rand(k, generator=gen, device=dev) + 0.5
             if mode == "norm" or sub else None)
        res = randn(m, n) if has_res else None
        od = torch.bfloat16
        kw = dict(x2=x2, norm_g=g, residual=res, fmt=fmt,
                  kb=DEFAULT_BLOCK[fmt], k=k, mode=mode, sub_norm=sub,
                  norm_n=k, eps=1e-5, out_dtype=od)
        got = tg.ternary_gemm_decode(x1, packed, ws, **kw)
        xq_p, xs_p = tg.decode_prologue(x1, x2, g, mode, sub, k, 1e-5)
        want = tg._gemm_plain(xq_p, xs_p, packed, ws, fmt, DEFAULT_BLOCK[fmt],
                              k, res, od)
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
        packed = rand_packed(k, n, fmt)
        ws = torch.full((n,), 0.05, device=dev)
        xq, xs = quantize_activations(randn(m, k))
        got = tg.ternary_gemm_tiled(xq, packed, xs, ws, fmt=fmt, kb=kb, k=k)
        want = tg._gemm_plain(xq, xs, packed, ws, fmt, kb, k, None,
                              torch.float32)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"tiled {label}: differs ({err})")
        del want
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
    return results


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

    # 8. summary
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
                      "seconds": time.time() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
