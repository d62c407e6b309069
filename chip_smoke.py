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
     (#7), each with the decode step replayed as a CUDA graph (the main
     path, counted) and then eagerly (the A/B): identical greedy tokens;
  4. real weights: tests/fixtures/tiny_real through the port's ``batched``
     path on the card (graphed and eager) and on the CPU: identical greedy
     tokens; seeded sampling graphed and eager: identical tokens;
  5. the slot engine at the flagship's full width: 32 slots, ctx 2048, 40
     greedy requests of 64-1100 prompt tokens (vlut_tpu_torch/bench/
     engine.py), with the bf16 and the q8 cache, each with the fused and
     the composed decode attention (the A/B of ms per decode step), each
     graphed (the main path) and eager: identical greedy tokens; the fused
     runs profile 4 decode steps (kernels, launch calls, idle share);
  6. tiny_real through the engine on the card (graphed and eager) and on
     the CPU, bf16 and q8 cache: identical greedy tokens; seeded sampling
     (temperature 0.8, top-k 40, XTC, mirostat rows) graphed and eager on
     the card: identical tokens;
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
 12. speculative decoding at full width: the flagship engine (32 slots, ctx
     2048, 32 greedy requests of 128-512 prompt tokens, 32 new tokens)
     with a random bitnet_2b_4t draft (seed 1, the same vocabulary), k 4,
     graphed rounds against eager ones (identical tokens); ms and tokens
     per round, drafted and accepted counts, the round program's launches,
     and the share of tokens equal to the plain engine's (printed, not
     gated: the random flagship turns rounding into other tokens); then the
     flagship as its own draft;
 13. lookahead at full width: the same engine and requests with W 4, G 3
     (T 11 rows per slot, M 352), graphed against eager;
 14. tiny_real on the card and on the CPU (identical tokens): draft mode
     (itself, and itself with its last layer dropped) and lookahead (their
     tokens equal plain greedy), prompt lookup through the CLI (card text
     equals the CPU's and plain greedy's), a GBNF and a json_schema request
     (their outputs parse under their grammars), a random rank-8 LoRA
     adapter written as safetensors and loaded by ``load_peft_adapter``,
     and a control vector (each changes the tokens);
 15. grammar at full width: 8 flagship slots under a JSON schema over a
     synthetic 128,256-piece vocabulary made from the seed, graphed
     against eager, every output accepted by its grammar; host ms of the
     masks against the step's;
 16. LoRA at full width: a random rank-16 adapter on wq/wv/w_up (the
     unfused tree, #4 per projection at decode), 32 slots, graphed against
     eager, ms per step against the fused model's;
 17. slot save/restore on the flagship engine: a slot saved after its
     request, erased, restored into another slot of the captured engine;
     the continuation equals the original slot's;
 18. the rest of the server over the flagship engine (32 slots, ctx 2048,
     graphed; tiny_real's tokenizer): 8 concurrent greedy chats (one
     streamed, one with n 4) equal a direct Engine.run of the templated
     ids, /apply-template, /infill equals /completion of the prefix,
     /v1/embeddings of 32 inputs (M 4096, #3) in mean, last and cls
     bit-equal to a direct forward(output="hidden") pooled on the card,
     /v1/rerank of 32 documents (M 8192) equal to a direct call and within
     1e-5 of a whole-logits forward, an embedding sent while 8 streamed
     completions decode (their tokens unchanged); tiny_real on the card
     against the CPU (chat, a tool_choice "required" chat whose pieces
     parse as a call, embeddings, rerank, infill); the web UI, routing by
     "model" and a 404; ``generate --promote i1`` against the requantized
     checkpoint; ms per embeddings batch and rerank, #3's device launches
     per embeddings batch;
 19. the dense zoo (vlut_tpu_torch/bench/zoo.py): qwen3_4b at full width
     and depth (16 slots, ctx 2048, 16 greedy requests of 64-512 prompt
     tokens, 16 new tokens) with bf16 fused (#7), q8 fused (#8) and bf16
     composed attention, and gemma2_2b at full width and depth (8 slots,
     ctx 8192, one request of 5,000 tokens past its 4,096 window and 8
     of 64-512, the ninth admitted beside the long one's decode,
     composed: its softcap gate), each graphed against
     eager (identical tokens), with ms per decode step, prompt tok/s and
     the tied head's time; then each knob family of the CPU tests (d 256,
     heads of 128, 2 layers) on the card against the CPU (each layer from
     the CPU's input and the logits within 2e-2 of the largest, the CPU's
     greedy tokens) and graphed against eager; every kernel the JAX gates
     send a model to must count launches;
 20. one JSON line of every kernel with its launches on the paths of phases
     3-19, then the card, then ``{"ok": true, "device": ...}`` last.

Phase 2 times #3 (the tiled GEMM) at the flagship prefill (M 4096) and at
the microbenchmark's i2 lanes (llama3_8b dxd, dxff, ffxd at M 32 and 256)
beside two yardsticks on the unpacked trits: ``torch._int_mm`` with the
weight row-major and column-major (the faster is its ``library_ms``) and
one float16 matmul; #1 and #4 beside the same three calls (the fastest is
their ``library_ms``), with their prologue and GEMM also timed apart, and
one profiled call of each (with and without a split of K) that must run at
most two device kernels.  It also holds #9 (the TQ2_0/TQ1_0 GEMM) against
its plain version at the llama3_8b shapes (dxd, dxff, ffxd) for both
formats at M 32 and 256, with the plan of each: the float32 sum runs in the
same order in both, so they must be equal bit for bit (max |err| 0).  It
then checks, without timing them, the kernels at the shapes the later
phases give them: #1 at every flagship projection in i2 and i1 at M 1,
17, 32, 33 and 64 (the e2e benches' decode is M 1 and 32), and bit-exact at
shapes that make its plan take every kernel instantiation and split count
(with every tile and split forced at two), #3 bit-exact in i2 and i1 at the
microbenchmark's lanes (M 32 and 256), at the e2e prefills (M 512 and
16384), at the speculative verify's and the lookahead round's M (160 and
352) and at the server's rerank (M 8192), and at shapes that make its plan
take each tile and split of K, #1 at the draft model's (bitnet_2b_4t's)
four projections at M 32, the zoo presets' projections (qwen3_4b's four
and gemma2_2b's qkv through #1, gemma2_2b's wo, gate|up and down through
#4) at M 1, 32 and 64 and through #3 at their prefills' M 1024 and 4096
(and times them at their engines' decode M, 16 and 8, and through #3 at
M 512; #7/#8 at qwen3_4b's engine, B 16 S 2048, and at a sliding layer
of gemma2_2b's heads, hd 256, window 4,096 past 5,000 rows), #1 and #4 at the flagship's projections at the
server's small embedding batches (M 16 and 48), #9
bit-exact at shapes that make its plan take each tile and split count and
with every tile and split forced at two shapes, #7 at the e2e benches'
caches, and #7 and #8 at shapes that make attn_plan take each rows-per-block
choice (every choice forced at two), at B 1, at the edge starts (0, S - 1,
out of range: the write skipped) with large finite values in the rows a
slot does not see, and replayed from a CUDA graph (cache bit-exact, output
within 2e-5, two calls bit-identical).  #5 (the KV row writer) takes a
layer's update as the composed path gives it (V a strided slice of the
fused qkv, int64 starts; q8: codes and both scale planes in one call) at
the batched cache, the engine's (bf16 and q8) and tiny_real's heads: bit
for bit against the plain assignment (int32 starts too, a start out of
range skipped, the one-array form), one call the writer's kernel alone,
timed in graphs of 20 calls beside one index_put_ per array.  #7 and #8
are timed at the decode paths' shapes (the flagship engine's B 32 S 2048
without and with a 512-row window, the batched cache B 32 S 184,
bench-sweep's tg at B 1 and 32, tiny_real's heads) with the tensors the model's layer hands them,
beside scaled_dot_product_attention, each with its plan, the host's eager
dispatch of one call, and the device kernels one call runs: the attention
kernel alone, or the phase fails.

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


INT_MM_ROW = "torch._int_mm, weight row-major"
INT_MM_COL = "torch._int_mm, weight column-major"
FP16_MM = "float16 torch.matmul"


def gemm_yardsticks(xq, w8, rotate: bool = True,
                    iters: int = 20) -> tuple[float | None, str | None, dict]:
    """The library yardsticks of an int8 GEMM on the unpacked int8 trits
    (weights rotated past the L2 with ``rotate``): ``torch._int_mm`` with
    the weight row-major and column-major (cuBLASLt's int8 layout), and one
    float16 matmul (codes and trits are exact in float16, every sum below
    2**24: the same integer product).  Returns the fastest's ms and name,
    and every time."""
    import torch

    total = 128 << 20 if rotate else 0
    times = {}
    for name, w in ((INT_MM_ROW, w8), (INT_MM_COL, w8.t().contiguous().t())):
        wr = Rotation(w, total)
        times[name] = library_ms(lambda: torch._int_mm(xq, wr.next()),
                                 iters=iters)
        del wr
    xh = xq.to(torch.float16)
    wr = Rotation(w8.to(torch.float16), total)
    times[FP16_MM] = library_ms(lambda: torch.matmul(xh, wr.next()),
                                iters=iters)
    del wr
    return (*fastest(times), times)


def fastest(times: dict, names=None) -> tuple[float | None, str | None]:
    """The least time of ``times`` (of ``names`` only, where given), with
    its name; (None, None) where none was timed."""
    timed = {k: v for k, v in times.items()
             if v is not None and (names is None or k in names)}
    best = min(timed, key=timed.get) if timed else None
    return timed.get(best), best


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


def decode_parts_ms(x1, rot, ws, kw) -> dict:
    """#1's (or #4's) prologue and GEMM timed apart, each in a CUDA graph of
    20 calls: the GEMM on the prologue's output; with a split of K, its
    workspace is zeroed by a fill kernel per call (the prologue's work in a
    call), timed apart and taken off."""
    from vlut_tpu_torch.ops import ternary_gemm as tg
    from vlut_tpu_torch.ops.packing import TRITS_PER_BYTE

    fmt, m, np_ = kw["fmt"], x1.shape[0], rot.copies[0].shape[1]
    kp = rot.copies[0].shape[0] * TRITS_PER_BYTE[fmt]
    args = (x1, kw["x2"], kw["norm_g"], kw["mode"], kw["sub_norm"],
            kw["norm_n"], kw["eps"], kp)
    pro_ms = cuda_ms(lambda: tg._launch_prologue(*args), graph=True)
    bn, splits = tg.decode_plan(m, np_, kp, fmt,
                                tg.sm_count(x1.device.index or 0))
    codes, xs, rowsum, work = tg._launch_prologue(*args, np_, bn, splits)
    od, res = kw["out_dtype"], kw["residual"]
    res = res.to(od).contiguous() if res is not None else None

    def gemm():
        if work is not None:
            work.zero_()
        return tg._launch_decode_gemm(codes, xs, rowsum, work, rot.next(), ws,
                                      fmt, m, res, od, bn, splits)
    gemm_ms = cuda_ms(gemm, graph=True)
    memset_ms = cuda_ms(work.zero_, graph=True) if work is not None else 0.0
    return {"prologue_ms": pro_ms, "gemm_ms": gemm_ms - memset_ms,
            "memset_ms": memset_ms, "plan": [bn, splits]}


def device_kernels(fn) -> list[str]:
    """The names of the device kernels (and memsets, copies) that one call
    of ``fn`` runs, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace without any device event is the profiler's miss (seen once
    # for the 1.5 us KV row writer, whose output its caller had checked),
    # not a call that launched nothing: it is taken again, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def check_two_kernels(name, launched) -> None:
    """A call of #1 or #4 runs exactly its prologue, then its GEMM: no
    memset, copy or other kernel (a split's workspace is the prologue's to
    zero)."""
    want = ("decode_prologue_kernel", "decode_gemm_kernel")
    if (len(launched) != 2
            or not all(w in e for w, e in zip(want, launched))):
        fail(f"{name}: one call ran {launched}, not {list(want)}")


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
    sms = tg.sm_count(dev.index or 0)

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

    def decode_case(label, m, k, n, mode, sub, has_res, fmt, plan=None):
        """#1's inputs at one projection, held against its plain version
        (with ``plan``, the kernels forced to that (BN, splits)); returns
        the inputs, the call's keywords and the largest error."""
        np_ = -(-n // 128) * 128  # the residual stays n wide
        packed = rand_packed(k, np_, fmt)
        ws = torch.full((np_,), 0.05, device=dev)
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
        x2, g, res = kw["x2"], kw["norm_g"], kw["residual"]
        if plan is None:
            got = tg.ternary_gemm_decode(x1, packed, ws, **kw)
        else:
            got = tg._decode_cuda(x1, packed, ws, x2, g, res, fmt,
                                  DEFAULT_BLOCK[fmt], mode, sub, k, 1e-5,
                                  torch.bfloat16, plan=plan)
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
            codes_k = tg.prologue_codes(x1, x2, g, mode, sub, k, 1e-5, kp)[0]
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

    def fused_quant_case(label, m, k, n):
        """#4's inputs at one shape, bit-exact against its plain version."""
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
        return packed, ws, x, xq, err

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
        parts = decode_parts_ms(x1, rot, ws, kw)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.decode_prologue(x1, x2, g, mode, sub, k, 1e-5), packed, ws,
            fmt, DEFAULT_BLOCK[fmt], k, res, od), iters=3, warmup=1)
        lib_ms, lib_name, yard = gemm_yardsticks(xq_p, trits_i8(packed, fmt, k))
        in_b = x1.element_size() * m * k * (2 if x2 is not None else 1)
        nbytes = (in_b + packed.numel() + 4 * n + (4 * k if g is not None else 0)
                  + (2 * m * n if res is not None else 0) + 2 * m * n)
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        name = ("ternary_gemm_decode" if main_path
                else "ternary_gemm_decode_other")
        record(name, shape=f"{label} M={m} {k}->{n} {fmt} {mode}"
               f"{'+sub' if sub else ''}{'+res' if has_res else ''}",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, eager_ms=eager_ms,
               library=lib_name, yardsticks_ms=yard, **parts)
        if label in ("wo", "gateup"):  # with a split of K, and without
            launched = device_kernels(
                lambda: tg.ternary_gemm_decode(x1, packed, ws, **kw))
            print(json.dumps({"phase": "kernels_per_call",
                              "kernel": "ternary_gemm_decode",
                              "shape": label, "plan": parts["plan"],
                              "device_kernels": launched}), flush=True)
            check_two_kernels(f"decode {label}", launched)
        del rot

    # --- #4 fused-quant GEMM: the unfused tree's projections at M = 32 ------
    unfused = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
               ("w_gate", 4096, 14336), ("w_up", 4096, 14336),
               ("w_down", 14336, 4096))
    for label, k, n in unfused:
        packed, ws, x, xq, err = fused_quant_case(label, m, k, n)
        rot = Rotation(packed)
        ms = cuda_ms(lambda: tg.ternary_gemm_fused_quant(
            x, rot.next(), ws, fmt="i2", kb=128, k=k), graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            *tg.kernel_quantize(x), packed, ws, "i2", 128, k, None,
            torch.float32), iters=3, warmup=1)
        lib_ms, lib_name, yard = gemm_yardsticks(xq, trits_i8(packed, "i2", k))
        parts = decode_parts_ms(x, rot, ws, dict(
            x2=None, norm_g=None, residual=None, fmt="i2", mode="plain",
            sub_norm=False, norm_n=0, eps=0.0, out_dtype=torch.float32))
        nbytes = 2 * m * k + packed.numel() + 4 * n + 4 * m * n
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record("ternary_gemm_fused_quant", shape=f"{label} M={m} {k}->{n} i2",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, library=lib_name,
               yardsticks_ms=yard, **parts)
        if label == "w_down":
            launched = device_kernels(lambda: tg.ternary_gemm_fused_quant(
                x, packed, ws, fmt="i2", kb=128, k=k))
            print(json.dumps({"phase": "kernels_per_call",
                              "kernel": "ternary_gemm_fused_quant",
                              "shape": label, "device_kernels": launched}),
                  flush=True)
            check_two_kernels(f"fused_quant {label}", launched)
        del rot

    # --- #3 tiled GEMM: the flagship prefill's projections at M = 4096, then
    # the microbenchmark's i2 lanes (llama3_8b dxd, dxff, ffxd at M 32 and
    # 256, weights rotated past the L2 as the bench does) --------------------
    def tiled_timed(name, label, m, k, n, fmt, iters, rotate):
        kb = DEFAULT_BLOCK[fmt]
        packed, ws, xq, xs, err = tiled_case(label, m, k, n, fmt)
        rot = Rotation(packed, 128 << 20 if rotate else 0)
        ms = cuda_ms(lambda: tg.ternary_gemm_tiled(
            xq, rot.next(), xs, ws, fmt=fmt, kb=kb, k=k), iters=iters,
            graph=True)
        plain_ms = cuda_ms(lambda: tg._gemm_plain(
            xq, xs, packed, ws, fmt, kb, k, None, torch.float32),
            iters=2, warmup=1)
        # the yardsticks; the library time is the faster _int_mm layout
        yard = gemm_yardsticks(xq, trits_i8(packed, fmt, k), rotate,
                               iters)[2]
        lib_ms, lib_name = fastest(yard, (INT_MM_ROW, INT_MM_COL))
        nbytes = m * k + 4 * m + packed.numel() + 4 * n + 4 * m * n
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record(name, shape=f"{label} M={m} {k}->{n} {fmt}", ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=err, library=lib_name,
               yardsticks_ms=yard,
               plan=tg.tiled_plan(m, packed.shape[1],
                                  packed.shape[0] * TRITS_PER_BYTE[fmt], fmt,
                                  sms))
        del rot
        torch.cuda.empty_cache()

    for label, k, n, fmt in (("qkv", 4096, 6144, "i2"),
                             ("wo", 4096, 4096, "i2"),
                             ("gateup", 4096, 28672, "i2"),
                             ("down", 14336, 4096, "i2"),
                             ("qkv_i1", 4096, 6144, "i1")):
        tiled_timed("ternary_gemm_tiled" if fmt == "i2"
                    else "ternary_gemm_tiled_other", label, 4096, k, n, fmt,
                    iters=5, rotate=False)
    for label, k, n in (("dxd", 4096, 4096), ("dxff", 4096, 14336),
                        ("ffxd", 14336, 4096)):
        for m in (32, 256):
            tiled_timed("ternary_gemm_tiled_lanes", label, m, k, n, "i2",
                        iters=20, rotate=True)

    # --- the zoo presets' projections (phase 19) at their engines' decode
    # M (qwen3_4b 16 slots, gemma2_2b 8) through #1 or #4 as the JAX gates
    # send them, and at their prefill bucket (M 512) through #3
    for label, k, n, mode, sub, has_res, fused in zoo_projections():
        m = 16 if label.startswith("qwen3") else 8
        if fused:
            x1, packed, ws, kw, xq, err = decode_case(label, m, k, n, mode,
                                                      sub, has_res, "i2")
            if err != 0.0:
                fail(f"decode {label} M={m}: differs from the plain version "
                     f"({err})")
            rot = Rotation(packed)
            ms = cuda_ms(lambda: tg.ternary_gemm_decode(
                x1, rot.next(), ws, **kw), graph=True)
            plain_ms = cuda_ms(lambda: tg._gemm_plain(
                *tg.decode_prologue(x1, kw["x2"], kw["norm_g"], mode, sub, k,
                                    1e-5), packed, ws, "i2", 128, k,
                kw["residual"], kw["out_dtype"]), iters=3, warmup=1)
            in_b = x1.element_size() * m * k * (2 if kw["x2"] is not None
                                                 else 1)
            nbytes = (in_b + packed.numel() + 4 * n
                      + (4 * k if kw["norm_g"] is not None else 0)
                      + (2 * m * n if has_res else 0) + 2 * m * n)
            name, shape = "ternary_gemm_decode_zoo", f"{label} M={m} {mode}"
        else:
            packed, ws, x, xq, err = fused_quant_case(label, m, k, n)
            rot = Rotation(packed)
            ms = cuda_ms(lambda: tg.ternary_gemm_fused_quant(
                x, rot.next(), ws, fmt="i2", kb=128, k=k), graph=True)
            plain_ms = cuda_ms(lambda: tg._gemm_plain(
                *tg.kernel_quantize(x), packed, ws, "i2", 128, k, None,
                torch.float32), iters=3, warmup=1)
            nbytes = 2 * m * k + packed.numel() + 4 * n + 4 * m * n
            name, shape = "ternary_gemm_fused_quant_zoo", f"{label} M={m}"
        lib_ms, lib_name, yard = gemm_yardsticks(xq, trits_i8(packed, "i2", k))
        b_ms, by = bound_ms(nbytes, 2 * m * k * n)
        record(name, shape=f"{shape} {k}->{n} i2", ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
               max_abs_err=err, library=lib_name, yardsticks_ms=yard)
        del rot
    for label, k, n, *_ in zoo_projections():
        tiled_timed("ternary_gemm_tiled_zoo", label, 512, k, n, "i2",
                    iters=5, rotate=False)

    # --- #5/#6 KV row writer: a layer's update as the composed path gives it
    kv_kernels(dev, gen, record)
    decode_attention_kernels(dev, gen, record)
    # #7/#8 at qwen3_4b's engine (B 16, S 2048, 32/8 heads of 128) and at
    # a sliding layer of gemma2_2b's heads (8/4 of 256) with its 4,096-row
    # window past 5,000 rows (gemma2_2b itself decodes composed: its
    # softcap gate)
    decode_attention_kernels(dev, gen, record, (
        ("qwen3_4b", 16, 2048, 8, 4, 128, 0, "spread"),
        ("hd256_w4096", 8, 8192, 4, 2, 256, 4096, 5000)))
    tq_kernels(dev, gen, record)

    # --- the other paths' shapes, checked and not timed ---------------------
    def checked(name, shape, err):
        agg = results[name]
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg.setdefault("checked", []).append(shape)
        print(json.dumps({"phase": "kernels_check", "kernel": name,
                          "shape": shape, "max_abs_err": err}), flush=True)

    # #1 in the e2e benches' decode (batch 1 and 32) and at M 17, 33 and
    # 64: every flagship projection, i2 and i1
    for fmt in ("i2", "i1"):
        for m in (1, 17, 32, 33, 64):
            for label, k, n, mode, sub, has_res, _, _ in shapes[:4]:
                err = decode_case(label, m, k, n, mode, sub, has_res, fmt)[-1]
                checked("ternary_gemm_decode",
                        f"{label} M={m} {k}->{n} {fmt} {mode}", err)
    # #1 bit-exact (plain mode, with a residual) at shapes that make
    # decode_plan take every kernel instantiation and split count, and with
    # every (BN, splits) forced at two of them
    forced = {(17, 3840, 512), (64, 3840, 384)}
    for fmt in ("i2", "i1"):
        for m, k, n in tg.DECODE_PLAN_SHAPES:
            np_, kp = -(-n // 128) * 128, padded_k(k, fmt)
            plans = [None]
            if (m, k, n) in forced:
                plans += [(bn, sp) for bn in (128, 256) if np_ % bn == 0
                          for sp in range(1, min(kp // DEFAULT_BLOCK[fmt],
                                                 tg.MAX_SPLITS) + 1)]
            for plan in plans:
                err = decode_case("plan", m, k, n, "plain", False, True, fmt,
                                  plan)[-1]
                shown = plan or tg.decode_plan(m, np_, kp, fmt, sms)
                checked("ternary_gemm_decode", f"plan M={m} {k}->{n} {fmt} "
                        f"{'forced' if plan else 'plan'}={shown}", err)
            torch.cuda.empty_cache()
    # the server's embeddings of one and of three inputs (bucket 16: M 16
    # and 48) at the flagship's widths: #1 at each projection of the fused
    # tree, #4 at each of the unfused tree, i2
    for m in (16, 48):
        for label, k, n, mode, sub, has_res, _, _ in shapes[:4]:
            err = decode_case(label, m, k, n, mode, sub, has_res, "i2")[-1]
            checked("ternary_gemm_decode",
                    f"embed_{label} M={m} {k}->{n} i2 {mode}", err)
        for label, k, n in unfused:
            err = fused_quant_case(label, m, k, n)[-1]
            checked("ternary_gemm_fused_quant", f"embed_{label} M={m} "
                    f"{k}->{n} i2", err)
        torch.cuda.empty_cache()
    # #1 at the draft model's widths (bitnet_2b_4t: d 2560, 20/5 heads,
    # d_ff 6912, sub-norms) at M 32, each projection of its layer
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    dc = PRESETS["bitnet_2b_4t"]
    dp = make_plan(dc)
    for label, k, n, mode, sub, has_res in (
            ("draft_qkv", dc.d_model, dp.q_dim_p + 2 * dp.kv_dim_p, "norm",
             False, False),
            ("draft_wo", dp.wo_in_p, dc.d_model, "norm", False, True),
            ("draft_gateup", dc.d_model, 2 * dp.ff_p, "norm", False, False),
            ("draft_down", dp.ff_p, dc.d_model, "silu_mul", True, True)):
        err = decode_case(label, 32, k, n, mode, sub, has_res, "i2")[-1]
        checked("ternary_gemm_decode", f"{label} M=32 {k}->{n} i2 {mode}",
                err)
    # the zoo presets' projections (phase 19) at decode M 1, 32 and 64: #1
    # where the JAX gates fuse them (qwen3_4b all four, gemma2_2b qkv with
    # its (1 + w) gain), #4 where they do not (gemma2_2b wo, gate|up and
    # down, unfused by its post-norms and gelu)
    # (the float prologue's codes could differ within check_float_prologue;
    # at these shapes they must not: max |err| 0)
    for label, k, n, mode, sub, has_res, m in zoo_decode_shapes():
        err = decode_case(label, m, k, n, mode, sub, has_res, "i2")[-1]
        if err != 0.0:
            fail(f"decode {label} M={m}: differs from the plain version "
                 f"({err})")
        checked("ternary_gemm_decode", f"{label} M={m} {k}->{n} i2 {mode}",
                err)
    for label, k, n, m in zoo_fused_quant_shapes():
        err = fused_quant_case(label, m, k, n)[-1]
        checked("ternary_gemm_fused_quant", f"{label} M={m} {k}->{n} i2", err)
    torch.cuda.empty_cache()
    # #3 in the microbenchmark's i2/i1 lanes (llama3_8b dxd, dxff, ffxd at
    # M 32 and 256) and in the e2e benches' prefills (pp 512 at batch 1 and
    # 32: M 512 and 16384)
    lanes = [(tag, m, k, n) for tag, k, n in (("dxd", 4096, 4096),
                                              ("dxff", 4096, 14336),
                                              ("ffxd", 14336, 4096))
             for m in (32, 256)]
    lanes += [(label, m, k, n) for label, k, n, *_ in shapes[:4]
              for m in (512, 16384)]
    # the speculative verify (32 slots x (k 4 + 1): M 160) and the
    # lookahead round (32 slots x T 11: M 352) at the flagship's widths
    lanes += [(f"{tag}_{label}", m, k, n) for label, k, n, *_ in shapes[:4]
              for tag, m in (("verify", 160), ("lookahead", 352))]
    # the server's rerank of 32 documents in a 256 bucket (M 8192)
    lanes += [(f"rerank_{label}", 8192, k, n)
              for label, k, n, *_ in shapes[:4]]
    # and at shapes that make tiled_plan take each of its tile rows (32, 64,
    # 128) with and without a split of K, at a ragged K too
    lanes += [("plan", m, k, n) for m, k, n in (
        (1, 1280, 384), (20, 4096, 28672), (65, 1280, 384),
        (200, 4096, 28672), (513, 1280, 384), (300, 4096, 28672),
        (65, 1283, 384), (256, 3000, 640))]
    # the zoo presets' prefills (phase 19: chunks of 1024 rows and a group
    # of 4096; the 512 bucket is timed above) at each projection, in their
    # format (i2)
    zoo_lanes = zoo_prefill_lanes()
    for fmt in ("i2", "i1"):
        for label, m, k, n in lanes + (zoo_lanes if fmt == "i2" else []):
            err = tiled_case(label, m, k, n, fmt)[-1]
            plan = tg.tiled_plan(m, -(-n // 128) * 128, padded_k(k, fmt), fmt,
                                 sms)
            checked("ternary_gemm_tiled", f"{label} M={m} {k}->{n} {fmt} "
                    f"plan={plan}", err)
            torch.cuda.empty_cache()
    # #9 bit-exact at shapes that make tq_plan take each of its tiles and
    # split counts (ragged M and N, bk 256 to 2048), and with every tile and
    # split forced at two shapes
    tq_checks(dev, gen, checked)
    # #7 in the e2e benches' decode: bench_sweep's tg from an empty cache
    # (S 552) at batch 1 and 32, batched_bench's after a 128-token prefill
    for b, s, first in ((1, 552, 0), (1, 552, 31), (32, 552, 0),
                        (32, 168, 128)):
        err = attention_case(dev, gen, b, s, first)
        checked("decode_attention", f"B={b} S={s} start={first}+", err)
    # #7 and #8 at shapes that make attn_plan take each rows-per-block choice
    # (every choice forced at two), at the edge starts (0, S - 1, out of
    # range) with large finite values in the rows a slot does not see, at
    # B 1, and replayed from a CUDA graph: cache bit-exact, output within
    # 2e-5, two calls bit-identical
    from vlut_tpu_torch.bench import attention_study

    for r in attention_study.check(gen):
        name = ("decode_attention_int8" if "q8=True" in r["label"]
                else "decode_attention")
        if r["why"]:
            fail(f"{name} {r['label']} rows={r['rows']}: {r['why']}")
        checked(name, f"{r['label']} rows={r['rows']}", r["max_abs_err"])
    return results


def zoo_projections() -> list:
    """(label, K, N, mode, sub_norm, residual?, fused?) of each projection
    of the zoo presets' serving trees, by the JAX gates: qwen3_4b fuses all
    four (#1); gemma2_2b fuses qkv (#1, norm with the gain 1 + w) and runs
    wo, gate|up and down unfused (#4)."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    out = []
    for name in ("qwen3_4b", "gemma2_2b"):
        c = PRESETS[name]
        p = make_plan(c)
        fused = name == "qwen3_4b"
        out += [
            (f"{name}_qkv", c.d_model, p.q_dim_p + 2 * p.kv_dim_p, "norm",
             False, False, True),
            (f"{name}_wo", p.wo_in_p, c.d_model, "plain", False, True, fused),
            (f"{name}_gateup", c.d_model, 2 * p.ff_p, "norm", False, False,
             fused),
            (f"{name}_down", p.ff_p, c.d_model, "silu_mul", False, True,
             fused),
        ]
    return out


def zoo_decode_shapes() -> list:
    return [(label, k, n, mode, sub, res, m)
            for label, k, n, mode, sub, res, fused in zoo_projections()
            if fused for m in (1, 32, 64)]


def zoo_fused_quant_shapes() -> list:
    return [(label, k, n, m)
            for label, k, n, _, _, _, fused in zoo_projections()
            if not fused for m in (1, 32, 64)]


def zoo_prefill_lanes() -> list:
    return [(label, m, k, n) for label, k, n, *_ in zoo_projections()
            for m in (1024, 4096)]


def kv_kernels(dev, gen, record) -> None:
    """#5/#6 at ``bench/kv_study.py:SHAPES``, a layer's update as the
    composed path gives it (``kv_study.layer_update``): one call (and the
    same with int32 starts, and with a start out of range, which the kernel
    skips) must equal the plain assignment bit for bit, and the one-array
    form likewise; one call must run the writer's kernel alone (no cast or
    copy).  Timed as the median of five CUDA graphs of 20 calls, beside
    one ``index_put_`` per array (the library call) and the plain version
    (``bench/kv_study.py`` times it in turns with other builds)."""
    import statistics

    import torch

    from vlut_tpu_torch.bench import kv_study
    from vlut_tpu_torch.ops import kv_update

    def median_ms(fn):
        return statistics.median(cuda_ms(fn, graph=True) for _ in range(5))

    for label, b, s, hkv, q8 in kv_study.SHAPES:
        caches, rows, start = kv_study.layer_update(gen, b, s, hkv, q8)
        scales = tuple(caches[2:] + rows[2:]) or None

        def call(st=start):
            kv_update.write_rows_pair(caches[0], caches[1], rows[0], rows[1],
                                      st, scales=scales)

        for st in (start, start.to(torch.int32)):
            want = [c.clone() for c in caches]
            for c, u in zip(want, rows):
                kv_update._write_plain(c, u, st)
            call(st)
            torch.cuda.synchronize()
            if not all(torch.equal(c, w) for c, w in zip(caches, want)):
                fail(f"KV row writer ({label}, {st.dtype}) differs from the "
                     "indexed assignment")
        skip = start.clone()
        skip[1] = -1
        want = [c.clone() for c in caches]
        call(skip)
        one, w1 = caches[0].clone(), caches[0].clone()
        kv_update._write_plain(w1, rows[1], start)
        kv_update.write_rows(one, rows[1], start)
        torch.cuda.synchronize()
        if not (all(torch.equal(c, w) for c, w in zip(caches, want))
                and torch.equal(one, w1)):
            fail(f"KV row writer ({label}): a start out of range was "
                 "written, or the one-array form differs")
        del one, w1, want
        launched = device_kernels(call)
        if len(launched) != 1 or "write_rows_kernel" not in launched[0]:
            fail(f"KV row writer ({label}): one call ran {launched}, not the "
                 "writer's kernel alone")
        ms = median_ms(call)
        plain_ms = cuda_ms(lambda: [kv_update._write_plain(c, u, start)
                                    for c, u in zip(caches, rows)])
        idx = (torch.arange(b, device=dev), start)
        lib_ms = statistics.median(
            library_ms(lambda: [c.index_put_(idx, u[:, 0])
                                for c, u in zip(caches, rows)])
            for _ in range(5))
        # each new row read once and written once, the starts read once
        nbytes = 2 * sum(u.numel() * u.element_size() for u in rows) + 8 * b
        b_ms, by = bound_ms(nbytes, 0)
        record("write_rows_pair" + ("" if label == "batched" else
                                    "_" + label),
               shape=f"{label} B={b} S={s} Hkv={hkv} hd=128 arrays="
               f"{len(caches)} " + ("q8" if q8 else "bf16"),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms, max_abs_err=0.0, launched=launched,
               library=f"{len(caches)} index_put_ (one per array)")
        del caches, rows
        torch.cuda.empty_cache()


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


def tq_checks(dev, gen, checked) -> None:
    import torch

    from vlut_tpu_torch.bench.kernels import rand_packed
    from vlut_tpu_torch.ops import tq

    sms = tq.sm_count(dev.index or 0)
    forced = {(40, 4096, 1000, 2048), (130, 3584, 264, 512)}
    for fmt in ("tq2", "tq1"):
        for m, k, n, bk in tq.PLAN_SHAPES:
            packed = rand_packed(fmt, k, n, gen, dev)
            scales = (torch.rand((k // tq.QK, n), generator=gen, device=dev)
                      * 0.6 + 0.3).to(torch.float16)
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            xs = torch.rand((m, 1), generator=gen, device=dev) * 0.01
            want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt, bk=bk)
            plans = [None]
            if (m, k, n, bk) in forced:
                plans += [(bm, bn, sp) for bm, bn in tq.TILES
                          for sp in range(1, k // bk + 1)]
            for plan in plans:
                if plan is None:
                    got = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=bk)
                    plan = tq.tq_plan(m, -(-n // 16) * 16, k, bk, sms)
                    label = "plan"
                else:
                    got = tq._tq_cuda(xq, packed, scales, xs, fmt, bk,
                                      torch.float32, plan=plan)
                    label = "forced"
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    fail(f"tq_gemm {fmt} M={m} {k}->{n} bk={bk} {label} "
                         f"{plan}: differs from the plain version ({err})")
                checked("tq_gemm", f"M={m} {k}->{n} {fmt} bk={bk} {label}="
                        f"{plan}", err)
            del packed, want
            torch.cuda.empty_cache()


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

    sms = tq.sm_count(dev.index or 0)
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
                       "weight dequantized to float16 beforehand",
                       plan=tq.tq_plan(m, n, k, 2048, sms))
                del want, got
            del rot, wrot, wf
            torch.cuda.empty_cache()


ATT_RTOL = ATT_ATOL = 2e-5


def decode_attention_kernels(dev, gen, record, shapes=None) -> None:
    """#7 and #8 at the decode paths' shapes (bench/attention_study.py:
    SHAPES: the flagship engine's B 32, S 2048 with starts spread over
    64-1900, without and with a 512-row window, the flagship batched cache
    B 32 S 184, bench-sweep's tg at B 1 and 32 (S 552) and tiny_real's
    heads), with the tensors ``_layer_step`` hands the kernel (bf16 q and
    rows, v a strided slice of the qkv output, int64 starts) and the cache
    rotated past the L2 where it fits in it.  Cache rows, codes and scales
    must equal the plain version's, the output (float32 summed in another
    order) agree to rtol and atol 2e-5, and two calls be bit-identical.
    Each shape records its plan (cache rows per block), the host's eager
    dispatch of one call and the device kernels one call runs, which must
    be the kernel alone: no cast, copy or memset."""
    import torch

    from vlut_tpu_torch.bench import attention_study as st
    from vlut_tpu_torch.ops import decode_attention as da

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, b, s, hkv, g, hd, window, starts in shapes or st.SHAPES:
        for q8 in (False, True):
            name = ("decode_attention_int8" if q8 else "decode_attention") + (
                "" if label == "engine" else "_" + label)
            case = st.Case(gen, b, s, hkv, g, hd, window, starts, q8,
                           rotate=True)
            why, err = st.check_case(case)
            if why:
                fail(f"{name}: {why}")
            launched = st.device_kernels(case.call())
            if len(launched) != 1 or "decode_attn_kernel" not in launched[0]:
                fail(f"{name}: one call ran {launched}, not the attention "
                     "kernel alone")
            ms = cuda_ms(case.call(), graph=True)
            plain_ms = cuda_ms(lambda: case.want(case.copies[0]), iters=3,
                               warmup=1)
            lib_ms = library_ms(case.sdpa())
            rows = case.rows()
            h = hkv * g
            # visible rows read once (int8: codes and scales), the new rows,
            # q, the output
            row_b = hkv * (hd + 4) * 2 if q8 else hkv * hd * 2 * 2
            nbytes = (rows * row_b + b * h * hd * (2 + 4)
                      + b * hkv * hd * 2 * 2)
            b_ms, by = bound_ms(nbytes, 4.0 * rows * h * hd, F32_OPS_PER_S)
            record(name, shape=(f"B={b} S={s} H={h} Hkv={hkv} hd={hd} "
                                f"window={window} rows={rows} "
                                + ("int8" if q8 else "bf16")),
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                   library_ms=lib_ms, max_abs_err=err,
                   rows_per_block=da.attn_plan(b, hkv, da.span(s, window),
                                               sms),
                   eager_us=st.eager_us(case.call()), launched=launched,
                   library="scaled_dot_product_attention(enable_gqa) over "
                   + ("the cache dequantized to bf16 beforehand" if q8
                      else "the bf16 rows"))
            del case
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

    # seconds from the start to each phase's start (the summary line's
    # phase_start_s)
    starts: dict[str, float] = {}

    def mark(phase: str) -> None:
        starts[phase] = time.time() - t_start

    # 1. build
    mark("build")
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
    mark("kernels")
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
    mark("flagship")
    from vlut_tpu_torch.bench import flagship

    built = flagship.build_model("llama3_8b_158", dev)
    ab: dict[str, dict[str, float]] = {}
    for mode, attn_kernel in (("composed", "write_rows_pair"),
                              ("fused", "decode_attention")):
        toks = {}
        for graph in (True, False):
            run = "graph" if graph else "eager"
            reset()
            fl = flagship.run("llama3_8b_158", device=dev, decode_attn=mode,
                              built=built, cuda_graph=graph)
            got = read(f"flagship_{mode}_{run}", (
                "ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
            toks[run] = fl.pop("tokens").cpu()
            ab.setdefault("flagship_batched_S184", {})[f"{mode}_{run}"] = fl[
                "ms_per_step"]
            print(json.dumps({"phase": "flagship", **fl, "launches": got,
                              "card": card}), flush=True)
            torch.cuda.empty_cache()
        if not torch.equal(toks["graph"], toks["eager"]):
            fail(f"flagship batched ({mode}): the graphed step's greedy "
                 "tokens differ from the eager step's")

    # 4. real weights: tiny_real on the card and on the CPU
    mark("tiny_real")
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
    toks_eager = run_batched(gpu_model, cfg, ids, 4, 12, temp=0.0,
                             decode_attn="composed", cuda_graph=False).cpu()
    toks_cpu = run_batched(cpu_model, cfg, ids, 4, 12, temp=0.0,
                           decode_attn="composed")
    same = torch.equal(toks_gpu, toks_cpu) and torch.equal(toks_gpu,
                                                           toks_eager)
    # seeded sampling through generate: graphed equals eager on the card
    sampled = [run_batched(gpu_model, cfg, ids, 4, 12, temp=0.8, seed=5,
                           decode_attn="composed", cuda_graph=g).cpu()
               for g in (True, False)]
    print(json.dumps({"phase": "tiny_real", "prompt_tokens": len(ids),
                      "slots": 4, "n": 12, "tokens_gpu": toks_gpu[0].tolist(),
                      "tokens_cpu": toks_cpu[0].tolist(),
                      "tokens_gpu_eager": toks_eager[0].tolist(),
                      "identical": same,
                      "seeded_tokens": sampled[0][0].tolist(),
                      "seeded_graph_equals_eager": torch.equal(*sampled),
                      "launches": launches_real}), flush=True)
    if not same:
        fail("tiny_real greedy tokens differ between the card's graphed "
             "step, its eager step and the CPU")
    if not torch.equal(*sampled):
        fail("tiny_real seeded tokens differ between the graphed and the "
             "eager step")

    # 5. the slot engine at the flagship's full width
    mark("engine")
    from vlut_tpu_torch.bench import engine as bench_engine

    engine_out = {}
    for cache in ("bf16", "q8"):
        for mode in ("fused", "composed"):
            attn_kernel = {("bf16", "fused"): "decode_attention",
                           ("q8", "fused"): "decode_attention_int8"}.get(
                               (cache, mode), "write_rows_pair")
            for graph in (True, False):
                run = "graph" if graph else "eager"
                reset()
                # 40 requests of 64-1100 tokens (8 queued past the slots,
                # one chunked past 1024): fewer and shorter than the
                # bench's 48 of 64-1500, to keep the script near its time
                out = bench_engine.run(
                    device=dev, built=built, kv_quant=cache == "q8",
                    decode_attn=mode, cuda_graph=graph,
                    requests=bench_engine.make_requests(built[0].vocab_size,
                                                        n=40, hi=1100),
                    profile_steps=4 if mode == "fused" else 0,
                    check_paths=mode == "fused" and graph)
                got = read(f"engine_{cache}_{mode}_{run}", (
                    "ternary_gemm_decode", "ternary_gemm_tiled", attn_kernel))
                engine_out[(cache, mode, run)] = out.pop("outputs")
                ab.setdefault(f"engine_{cache}_ctx2048", {})[
                    f"{mode}_{run}"] = out["decode_ms_per_step"]
                print(json.dumps({"phase": "engine", **out, "launches": got,
                                  "card": card}), flush=True)
                torch.cuda.empty_cache()
            if (engine_out[(cache, mode, "graph")]
                    != engine_out[(cache, mode, "eager")]):
                fail(f"flagship engine ({cache}, {mode}): the graphed step's "
                     "greedy tokens differ from the eager step's")
    agree = {}
    for cache in ("bf16", "q8"):
        pairs = [a == b for x, y in zip(engine_out[(cache, "fused", "graph")],
                                        engine_out[(cache, "composed",
                                                    "graph")])
                 for a, b in zip(x, y)]
        agree[cache] = sum(pairs) / len(pairs)
    print(json.dumps({"phase": "decode_attn_ab", "ms_per_step": ab,
                      "fused_vs_composed_token_agreement": agree,
                      "card": card}), flush=True)

    # 6. tiny_real through the engine on the card and on the CPU
    mark("tiny_real_engine")
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    texts = [b"The little model", b"reads the lines", b"of its own repo.",
             b"The", b"little model reads the lines of its own repo.", b"re"]

    def tiny_engine(model, cache, graph, samplers):
        eng = Engine(cfg, model, n_slots=4, max_len=256,
                     kv_quant=cache == "q8", cuda_graph=graph)
        reqs = [Request(prompt=[2] + list(t), max_new_tokens=12, sampler=sp)
                for t, sp in zip(texts, samplers)]
        eng.run(reqs)
        return [r.output for r in reqs], eng

    greedy = [SamplerParams(temperature=0.0)] * len(texts)
    for cache in ("bf16", "q8"):
        reset()
        outs, eng = tiny_engine(gpu_model, cache, True, greedy)
        got = read(f"tiny_real_engine_{cache}", (
            "decode_attention" if cache == "bf16"
            else "decode_attention_int8",))
        eager, _ = tiny_engine(gpu_model, cache, False, greedy)
        cpu, _ = tiny_engine(cpu_model, cache, True, greedy)
        same = outs == cpu and outs == eager
        print(json.dumps({"phase": "tiny_real_engine", "cache": cache,
                          "tokens_gpu": outs[0], "tokens_cpu": cpu[0],
                          "tokens_gpu_eager": eager[0], "identical": same,
                          "step_programs": eng.step_programs(),
                          "launches": got}), flush=True)
        if not same:
            fail(f"tiny_real engine ({cache}) tokens differ between the "
                 "card's graphed step, its eager step and the CPU")
    # seeded sampling (temperature 0.8, top-k 40, XTC, mirostat rows): the
    # noise drawn before each replay gives the eager step's tokens
    seeded = [SamplerParams(temperature=0.8, top_k=40, seed=i,
                            xtc_p=0.5 if i % 2 else 0.0, xtc_t=0.05,
                            mirostat_tau=5.0 if i % 3 == 2 else 0.0)
              for i in range(len(texts))]
    sampled = {g: tiny_engine(gpu_model, "bf16", g, seeded)[0]
               for g in (True, False)}
    print(json.dumps({"phase": "tiny_real_engine_seeded",
                      "tokens_graph": sampled[True][0],
                      "tokens_eager": sampled[False][0],
                      "identical": sampled[True] == sampled[False]}),
          flush=True)
    if sampled[True] != sampled[False]:
        fail("tiny_real engine seeded tokens differ between the graphed "
             "and the eager step")

    # 7. the completion server over the flagship engine
    mark("server")
    server_phase(built, fixture, card, reset, read)

    # 8-11. the microbenchmark, the end-to-end benches, perplexity and
    # requantization
    mark("tools")
    tools_phases(dev, built, fixture, card, reset, read,
                 (cfg, gpu_model, cpu_model, ids, toks_gpu))

    # 12-17. speculative decoding, lookahead, grammar, LoRA / control
    # vectors and slot save/restore
    mark("slice")
    slice_phases(dev, built, fixture, card, reset, read,
                 (cfg, gpu_model, cpu_model))

    # 18. the rest of the server: chat, tools, infill, embeddings, rerank,
    # the template, the web UI and routing; generate --promote
    mark("server_rest")
    server_rest_phase(dev, built, fixture, card, reset, read,
                      (cfg, gpu_model, cpu_model))

    # 19. the dense zoo: qwen3_4b and gemma2_2b at full width, and each
    # knob family on the card against the CPU
    mark("zoo")
    zoo_phase(dev, card, reset, read)

    # 20. summary
    mark("summary")
    replaces = {
        "ternary_gemm_decode": ("vlut_tpu_torch/csrc/decode_gemm.cu",
                                "vlut_tpu/ops/pallas_gemm.py:676"),
        "ternary_gemm_fused_quant": ("vlut_tpu_torch/csrc/decode_gemm.cu",
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
                      "phase_start_s": starts,
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



def _http(hostport, method, path, body=None, timeout=600):
    """(status, content type, body bytes) of one request."""
    import http.client

    conn = http.client.HTTPConnection(*hostport, timeout=timeout)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), data


def _post(hostport, path, **body):
    status, _, data = _http(hostport, "POST", path, body)
    if status != 200:
        fail(f"POST {path} answered {status}: {data[:300]!r}")
    return json.loads(data)


def _sse_events(raw: bytes) -> list:
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def server_rest_phase(dev, built, fixture, card, reset, read, real) -> None:
    """Phase 18: the rest of the server.  (a) The flagship engine (32
    slots, ctx 2048, bf16 cache, fused attention, graphed; tiny_real's
    tokenizer for text): 8 concurrent greedy chats (one streamed, one with
    n 4) against a direct Engine.run of the templated ids in queue order,
    /apply-template, /infill against /completion of the prefix (on a
    one-slot flagship engine, the slot erased between them, while
    tiny_real's chats run on the card: two graphed models under one lock),
    /v1/embeddings of 32 inputs of 16-128 tokens in mean, last and cls
    bit-equal to a direct forward(output="hidden") pooled on the card,
    /v1/rerank of a 32-token query and 32 documents of 16-224 tokens
    against a direct call and a whole-logits forward, and one embeddings
    request sent while 8 streamed completions decode (their tokens those
    of a run without it).  (b) tiny_real on the card against the CPU:
    chat, a tool_choice "required" chat, embeddings, rerank and infill.
    (c) GET / (the web UI), routing by "model" over the flagship and
    tiny_real, a 404 for an unknown name, and ``generate --promote i1``
    against the requantized checkpoint.  The launch windows hold the
    server's requests alone: the references and timings run outside
    them."""
    import concurrent.futures as cf
    import contextlib
    import io
    import statistics
    import tempfile

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.convert.quantize import requantize
    from vlut_tpu_torch.models.transformer import forward
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams
    from vlut_tpu_torch.serving import server as srv
    from vlut_tpu_torch.serving.chat import _parse_tool_calls
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model = built
    cfg_r, gpu_real, cpu_real = real
    tok = Tokenizer(fixture)
    greedy = SamplerParams(temperature=0.0)
    rng = np.random.default_rng(18)
    t_phase = time.time()
    out: dict = {"phase": "server_rest", "card": card}

    def big_engine():
        return Engine(cfg, model, n_slots=32, max_len=2048)

    def direct(prompts, n_new):
        """Greedy tokens of a fresh flagship engine over ``prompts``, taken
        in this order (the server's queue order)."""
        reqs = [Request(prompt=p, max_new_tokens=n_new, sampler=greedy)
                for p in prompts]
        big_engine().run(reqs)
        torch.cuda.empty_cache()
        return [r.output for r in reqs]

    def wait_queue(engine, n):
        t0 = time.time()
        while len(engine.queue) < n and time.time() - t0 < 120:
            time.sleep(0.005)
        if len(engine.queue) != n:
            fail(f"server_rest: {len(engine.queue)} of {n} requests queued")
        return [list(r.prompt) for r in engine.queue]

    # (a) the flagship behind the router, beside tiny_real on the card and
    # on the CPU; the engine loops start once the chats are queued
    flag = big_engine()
    engines = {
        "flagship": flag,
        "tiny_real": Engine(cfg_r, gpu_real, n_slots=4, max_len=512),
        "tiny_real_cpu": Engine(cfg_r, cpu_real, n_slots=4, max_len=512),
        # one flagship slot: /infill, the slot erased, then /completion,
        # each the first request of an empty slot (equal batch shapes)
        "one_slot": Engine(cfg, model, n_slots=1, max_len=512),
    }
    httpd, router = srv.serve_multi({n: (e, tok) for n, e in engines.items()},
                                    port=0, default="flagship",
                                    start_engine=False)
    hp = ("127.0.0.1", httpd.server_address[1])
    chats = [[{"role": "user", "content": f"Request {i}: "
               + "the little model reads its own repo. " * (1 + 3 * i)}]
             for i in range(8)]
    n_new = 16

    def chat(i):
        body = {"messages": chats[i], "max_tokens": n_new,
                "temperature": 0.0, "ignore_eos": True,
                "return_tokens": True, "stream": i == 0,
                "n": 4 if i == 1 else 1}
        status, _, raw = _http(hp, "POST", "/v1/chat/completions", body)
        if status != 200:
            return status, None
        if i == 0:
            ev = _sse_events(raw)
            text = "".join(e["choices"][0]["delta"].get("content", "")
                           for e in ev)
            return status, [(text, ev[-1]["choices"][0]["tokens"])]
        return status, [(c["message"]["content"], c["tokens"])
                        for c in json.loads(raw)["choices"]]

    # the inputs: 32 embeddings of 16-128 token ids (bucket 128: M 4096);
    # a rerank of a 32-token query and 32 documents of 16-224 tokens
    # (bucket 256: M 8192) as text, which tiny_real's tokenizer encodes one
    # id per character
    ids32 = [[int(t) for t in rng.integers(3, cfg.vocab_size, int(n))]
             for n in np.r_[128, 16, rng.integers(16, 129, 30)]]
    letters = list("abcdefghijklmnopqrstuvwxyz ")

    def text(n):
        return "".join(rng.choice(letters, int(n)))

    query = text(32 - len(tok.encode("")))
    docs_text = [text(n) for n in np.r_[224, 16, rng.integers(16, 225, 30)]]
    q_ids = tok.encode(query)
    d_ids = [tok.encode(d, add_bos=False) for d in docs_text]
    rerank_m = len(d_ids) * srv._bucket(len(q_ids) + max(map(len, d_ids)))
    real_bodies = {
        "chat": {"messages": chats[2], "max_tokens": 16},
        "tools": {"messages": [{"role": "user", "content": "weather?"}],
                  "max_tokens": 120, "tool_choice": "required",
                  "tools": [{"type": "function", "function": {
                      "name": "get_w", "parameters": {
                          "type": "object", "properties": {
                              "city": {"type": "string"}},
                          "required": ["city"]}}}]}}

    def real_chat(mname, name):
        return _post(hp, "/v1/chat/completions", model=mname,
                     temperature=0.0, return_tokens=True,
                     **real_bodies[name])["choices"][0]["tokens"]

    # the window holds the server's own requests alone; the references on
    # the card (direct forwards, direct calls, timings) come after it
    reset()
    try:
        t0 = time.time()
        with cf.ThreadPoolExecutor(8) as ex:
            pending = [ex.submit(chat, i) for i in range(8)]
            order = wait_queue(flag, 11)
            for st in router.states.values():
                st.start()
            answers = [f.result() for f in pending]
        out["chat_wall_s"] = time.time() - t0
        if any(a[0] != 200 for a in answers):
            fail(f"server_rest chats answered {[a[0] for a in answers]}")
        templ = [tok.apply_chat_template(c) for c in chats]
        prompt = _post(hp, "/apply-template", messages=chats[3])["prompt"]
        if prompt != tok.decode(templ[3]):
            fail("server_rest: /apply-template differs from the template")

        # /infill against /completion of the prefix, on one flagship slot;
        # tiny_real's chats on the card meanwhile: two graphed models on
        # one card capture and step under one lock
        prefix = "The little model reads the lines of its own"
        with cf.ThreadPoolExecutor(3) as ex:
            real_pending = {name: ex.submit(real_chat, "tiny_real", name)
                            for name in real_bodies}
            inf = _post(hp, "/infill", model="one_slot", input_prefix=prefix,
                        input_suffix=" repo.", n_predict=n_new,
                        temperature=0.0, ignore_eos=True, return_tokens=True)
            real_card = {k: f.result() for k, f in real_pending.items()}
        _post(hp, "/slots/0?action=erase", model="one_slot")
        comp = _post(hp, "/completion", model="one_slot", prompt=prefix,
                     n_predict=n_new, temperature=0.0, ignore_eos=True,
                     return_tokens=True)
        out["infill_equals_completion"] = inf["tokens"] == comp["tokens"]

        emb_route = {pooling: np.asarray([d["embedding"] for d in _post(
            hp, "/v1/embeddings", input=ids32, pooling=pooling)["data"]])
            for pooling in srv.POOLINGS}
        ranked = _post(hp, "/v1/rerank", query=query,
                       documents=docs_text)["results"]

        # (b) tiny_real on the card and the CPU
        real_cmp = {}
        for name in real_bodies:
            ta, tb = real_card[name], real_chat("tiny_real_cpu", name)
            real_cmp[name] = ta == tb
            if name == "tools":
                calls, _ = _parse_tool_calls(
                    "".join(tok.pieces()[t] for t in ta))
                real_cmp["tool_call"] = calls[:1]
        texts = ["The little model reads the lines of its own repo.",
                 "reads", "of its own repo, and some more words past 16", "T"]
        cos = []
        for pooling in srv.POOLINGS:
            a, b = (np.asarray([d["embedding"] for d in _post(
                hp, "/v1/embeddings", model=mname, input=texts,
                pooling=pooling)["data"]])
                for mname in ("tiny_real", "tiny_real_cpu"))
            cos.append(float((a * b).sum(-1).min()))
        real_cmp["embed_min_cosine"] = min(cos)
        docs_t = [" reads the lines", " zq xv", " of its own repo.", "!!"]
        a, b = (_post(hp, "/v1/rerank", model=mname, query="The little model",
                      documents=docs_t)["results"]
                for mname in ("tiny_real", "tiny_real_cpu"))
        real_cmp["rerank_same_order"] = ([r["index"] for r in a]
                                         == [r["index"] for r in b])
        real_cmp["rerank_max_rel_err"] = max(
            abs(x["relevance_score"] - y["relevance_score"])
            / abs(y["relevance_score"]) for x, y in zip(a, b))
        a, b = (_post(hp, "/infill", model=mname, input_prefix="The little",
                      input_suffix=" repo.", n_predict=12, temperature=0.0,
                      return_tokens=True)
                for mname in ("tiny_real", "tiny_real_cpu"))
        real_cmp["infill"] = a == b
        out["tiny_real_card_vs_cpu"] = real_cmp

        # (c) the web UI and routing
        status, ctype, data = _http(hp, "GET", "/")
        ui_ok = (status == 200 and ctype.startswith("text/html")
                 and data == srv.WEBUI.read_bytes())
        status, _, data = _http(hp, "GET", "/v1/models")
        listed = [m["id"] for m in json.loads(data)["data"]]
        unknown = _http(hp, "POST", "/completion",
                        {"prompt": "x", "model": "nope"})[0]
        out["web_ui"], out["models"], out["unknown_model_status"] = (
            ui_ok, listed, unknown)
        out["launches"] = read("server_rest", ("ternary_gemm_tiled",
                                               "ternary_gemm_decode",
                                               "decode_attention"))
    finally:
        for st in router.states.values():
            st.stop()
        httpd.shutdown()
        httpd.server_close()
        for st in router.states.values():
            if st.thread.ident is not None:
                st.thread.join(timeout=60)
    calls = real_cmp["tool_call"]
    if not calls or set(calls[0]["arguments"]) != {"city"}:
        fail(f"server_rest: tiny_real's tool call does not parse: {calls}")
    names = list(engines)
    errors = {n: st.metrics["requests_errors_total"]
              for n, st in router.states.items()}

    # the embeddings against a direct forward(output="hidden") pooled on
    # the card at the same shapes
    st = router.states["flagship"]
    toks, pos, lens = srv._padded(ids32, dev)
    with torch.inference_mode():
        hidden = forward(model, cfg, toks, pos, None, output="hidden")[0]
        h = hidden.float()
        valid = torch.arange(h.shape[1], device=dev)[None] < lens[:, None]
        pooled = {
            "mean": (h * valid[..., None]).sum(1)
            / torch.clamp(lens[:, None], min=1).float(),
            "last": h[torch.arange(h.shape[0], device=dev), lens - 1],
            "cls": h[:, 0]}
    emb = {}
    for pooling, want in pooled.items():
        want = want.cpu().numpy()
        want = want / np.maximum(
            np.linalg.norm(want, axis=-1, keepdims=True), 1e-12)
        got = emb_route[pooling]
        emb[pooling] = {
            "bit_equal": bool(np.array_equal(got, want.astype(np.float64))),
            "max_abs_err": float(np.abs(got - want).max()),
            "norm_err": float(np.abs(np.linalg.norm(got, axis=-1)
                                     - 1.0).max())}
    out["embeddings"] = emb
    del hidden, h, pooled

    # the rerank against a direct call, and the direct call against a
    # whole-logits forward
    scores = st.rerank(q_ids, d_ids)
    again = st.rerank(q_ids, d_ids)
    route_scores = {r["index"]: r["relevance_score"] for r in ranked}
    toks, pos, lens = srv._padded([q_ids + d for d in d_ids], dev)
    with torch.inference_mode():
        lg = forward(model, cfg, toks, pos, None)[0][..., :cfg.vocab_size]
        tgt = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], 1)
        lps = (lg.gather(-1, tgt[..., None])[..., 0]
               - torch.logsumexp(lg, dim=-1))
        del lg
        idx = torch.arange(toks.shape[1], device=dev)[None]
        m = (idx >= len(q_ids) - 1) & (idx < lens[:, None] - 1)
        whole = ((lps * m).sum(-1) / m.sum(-1)).tolist()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(scores, whole))
    out["rerank"] = {
        "M": rerank_m, "scores_min_max": [min(scores), max(scores)],
        "route_equals_direct": [route_scores.get(i) for i in range(
            len(scores))] == scores,
        "repeat_bit_equal": scores == again,
        "whole_logits_max_rel_err": rel,
        "route_ordered": [r["relevance_score"] for r in ranked] == sorted(
            scores, reverse=True)}

    # timings (host clock; embed and rerank end in a host copy)
    def med_ms(fn, n=3):
        fn()
        ts = []
        for _ in range(n):
            t1 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ts)

    ids_full = [x[:128] + [5] * (128 - len(x)) for x in ids32]
    out["embed_ms_32x128"] = med_ms(lambda: st.embed(ids_full, "mean"))
    out["rerank_ms_32_docs"] = med_ms(lambda: st.rerank(q_ids, d_ids))
    # #3's launches in one batch: its wrapper's count, and the device
    # kernels of one call in a profiler trace (which has dropped events in
    # a trace of some 4,000 kernels)
    from vlut_tpu_torch.ops import ternary_gemm as tg

    before = tg.ternary_gemm_tiled.launches
    st.embed(ids_full, "mean")
    out["tiled_launches_per_embed_batch"] = (
        tg.ternary_gemm_tiled.launches - before)
    launched = device_kernels(lambda: st.embed(ids_full, "mean"))
    out["tiled_device_kernels_per_embed_batch"] = sum(
        "tiled_gemm_kernel" in k for k in launched)
    out["device_kernels_per_embed_batch"] = len(launched)
    del engines, flag, router, st
    torch.cuda.empty_cache()

    # the chats against a direct run of the templated ids in queue order
    by_prompt = {tuple(p): o for p, o in zip(order, direct(order, n_new))}
    chat_ok = []
    for i, (_, choices) in enumerate(answers):
        want = by_prompt[tuple(templ[i])]
        chat_ok.append(len(choices) == (4 if i == 1 else 1) and all(
            toks_ == want and text == tok.decode(want)
            for text, toks_ in choices))
    out["chat_equal_direct"] = chat_ok

    # one embeddings request while 8 streamed completions decode
    reset()
    eng = big_engine()
    httpd, state = srv.serve(eng, tok, port=0, start_engine=False)
    hp = ("127.0.0.1", httpd.server_address[1])
    texts = [f"Request {i}: " + "the little model reads its own repo. "
             * (2 + 2 * i) for i in range(8)]
    n_long = 48

    def stream(i):
        status, _, raw = _http(hp, "POST", "/completion", {
            "prompt": texts[i], "n_predict": n_long, "temperature": 0.0,
            "ignore_eos": True, "return_tokens": True, "stream": True})
        return status, (_sse_events(raw)[-1].get("tokens")
                        if status == 200 else None)

    try:
        with cf.ThreadPoolExecutor(9) as ex:
            pending = [ex.submit(stream, i) for i in range(8)]
            order = wait_queue(eng, 8)
            state.start()
            t0 = time.time()
            while eng.perf.n_decode_steps < 2 and time.time() - t0 < 120:
                time.sleep(0.001)
            busy = sum(s.req is not None for s in eng.slots)
            steps_before = eng.perf.n_decode_steps
            emb_status = _http(hp, "POST", "/v1/embeddings",
                               {"input": ids32[:8], "pooling": "mean"})[0]
            steps_after = eng.perf.n_decode_steps
            streamed = [f.result() for f in pending]
        _, _, metrics = _http(hp, "GET", "/metrics")
        errors["concurrent"] = [
            float(line.split()[-1]) for line in metrics.decode().splitlines()
            if line.startswith("vlut_requests_errors_total")][0]
    finally:
        state.stop()
        httpd.shutdown()
        httpd.server_close()
        if state.thread.ident is not None:
            state.thread.join(timeout=60)
    got = read("server_rest_concurrent", ("ternary_gemm_tiled",
                                          "ternary_gemm_decode",
                                          "decode_attention"))
    del eng, state
    torch.cuda.empty_cache()
    by_prompt = {tuple(p): o for p, o in zip(order, direct(order, n_long))}
    out["concurrent"] = {
        "slots_busy_at_embed": busy, "decode_steps_before_embed": steps_before,
        "decode_steps_when_answered": steps_after, "status": [emb_status] + [
            s for s, _ in streamed],
        "tokens_equal_without": [toks_ == by_prompt[tuple(tok.encode(t))]
                                 for (_, toks_), t in zip(streamed, texts)],
        "launches": got}
    out["requests_errors_total"] = errors

    # (c) generate --promote i1 against the requantized checkpoint
    gen = ["generate", "-p", "The little model reads", "-n", "12", "--temp",
           "0", "--ctx", "128", "--device", dev.type]
    texts_out = []
    with tempfile.TemporaryDirectory() as tmp:
        dst = pathlib.Path(tmp) / "tiny_real_i1"
        requantize(fixture, dst, "i1")
        for argv in (["--model", str(fixture), "--promote", "i1"],
                     ["--model", str(dst)]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(gen + argv)
            texts_out.append(buf.getvalue())
    out["promote_i1_equals_requantized"] = texts_out[0] == texts_out[1]
    out["promote_text"] = texts_out[0].strip()
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)

    checks = {
        "flagship chats equal the direct engine": all(chat_ok),
        "/infill equals /completion of the prefix":
            out["infill_equals_completion"],
        "embeddings bit-equal to the direct forward": all(
            e["bit_equal"] and e["norm_err"] <= 1e-5 for e in emb.values()),
        "rerank equals a direct call": out["rerank"]["route_equals_direct"]
            and out["rerank"]["repeat_bit_equal"],
        "rerank within 1e-5 of the whole-logits forward": rel <= 1e-5,
        "rerank results ordered by score": out["rerank"]["route_ordered"],
        "rerank at M 8192": rerank_m == 8192,
        "#3 launched 128 times per embeddings batch":
            out["tiled_launches_per_embed_batch"] == 128,
        "tiny_real chat tokens card = CPU": real_cmp["chat"]
            and real_cmp["tools"],
        "tiny_real embeddings cosine >= 0.9999":
            real_cmp["embed_min_cosine"] >= 0.9999,
        "tiny_real rerank within rtol 1e-3, same order":
            real_cmp["rerank_same_order"]
            and real_cmp["rerank_max_rel_err"] <= 1e-3,
        "tiny_real infill card = CPU": real_cmp["infill"],
        "web UI served": ui_ok,
        "every model listed": listed == names,
        "unknown model answers 404": unknown == 404,
        "embedding overlapped the decode": busy == 8 and steps_before >= 2,
        "every answer 200": all(s == 200 for s in out["concurrent"][
            "status"]),
        "completions unchanged by the embedding": all(
            out["concurrent"]["tokens_equal_without"]),
        "no request error": not any(errors.values()),
        "generate --promote i1 = the requantized checkpoint":
            out["promote_i1_equals_requantized"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"server_rest: {bad}")


def zoo_phase(dev, card, reset, read) -> None:
    """Phase 19: the dense zoo.  (a) qwen3_4b and (b) gemma2_2b at full
    width and depth (random packed weights from the seed) through the
    engine, graphed against eager; (c) each knob family of the CPU tests
    (``bench/zoo.py``) on the card against the CPU; (d) the launches of
    each gated kernel per model (``read`` fails on a zero)."""
    import torch

    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.runtime.engine import Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    t_phase = time.time()
    out: dict = {"phase": "zoo", "card": card}

    def engine_runs(name, built, runs, requests, n_slots, ctx, expect):
        toks, res = {}, {}
        for cache, mode in runs:
            for graph in (True, False):
                run = "graph" if graph else "eager"
                reset()
                # the first cell's graphed run profiles 4 decode steps
                # (kernels by device time, idle share)
                prof = 4 if graph and (cache, mode) == runs[0] else 0
                r = bench_engine.run(
                    name, device=dev, built=built, kv_quant=cache == "q8",
                    decode_attn=mode, cuda_graph=graph, n_slots=n_slots,
                    ctx=ctx, requests=requests(), profile_steps=prof)
                got = read(f"zoo_{name}_{cache}_{mode}_{run}",
                           expect(cache, mode))
                toks[(cache, mode, run)] = r.pop("outputs")
                res[f"{cache}_{mode}_{run}"] = {
                    k: r[k] for k in (
                        "decode_ms_per_step", "replay_ms_per_step",
                        "replayed_steps", "prompt_tok_per_s",
                        "decode_tok_per_s", "prompt_tokens", "decode_steps",
                        "capture_s", "wall_s")} | {"launches": got} | (
                    {"profile": r["profile"]} if "profile" in r else {})
                print(json.dumps({"phase": "zoo", "model": name,
                                  "cache": cache, "decode_attn": mode,
                                  "run": run, **res[f"{cache}_{mode}_{run}"],
                                  "card": card}), flush=True)
                torch.cuda.empty_cache()
            if toks[(cache, mode, "graph")] != toks[(cache, mode, "eager")]:
                fail(f"zoo {name} ({cache}, {mode}): the graphed step's "
                     "greedy tokens differ from the eager step's")
        return res

    # (a) qwen3_4b: 16 slots, ctx 2048, 16 greedy requests of 64-512 prompt
    # tokens (seed 12), 16 new tokens; bf16 fused (#7), q8 fused (#8), bf16
    # composed (#5)
    built = flagship.build_model("qwen3_4b", dev)
    cfg_q = built[0]
    attn_of = {("bf16", "fused"): "decode_attention",
               ("q8", "fused"): "decode_attention_int8"}
    out["qwen3_4b"] = engine_runs(
        "qwen3_4b", built, (("bf16", "fused"), ("q8", "fused"),
                            ("bf16", "composed")),
        lambda: bench_engine.make_requests(cfg_q.vocab_size, 16, 64, 512, 16,
                                           seed=12),
        16, 2048, lambda c, m: ("ternary_gemm_decode", "ternary_gemm_tiled",
                                attn_of.get((c, m), "write_rows_pair")))
    del built
    torch.cuda.empty_cache()

    # (b) gemma2_2b: 8 slots, ctx 8192, one greedy request of 5,000 tokens
    # (its 4,096 window bites on the even layers) and 8 of 64-512 tokens,
    # 16 new tokens (the long one 32, so that it still decodes past its
    # window when the ninth request is admitted), composed attention (the
    # softcap gate)
    built = flagship.build_model("gemma2_2b", dev, max_seq_len=8192)
    cfg_g, model_g = built

    def gemma_requests():
        rng = __import__("numpy").random.default_rng(12)
        long = Request(prompt=[int(t) for t in rng.integers(
            3, cfg_g.vocab_size, 5000)], max_new_tokens=32,
            sampler=SamplerParams(temperature=0.0))
        return [long] + bench_engine.make_requests(cfg_g.vocab_size, 8, 64,
                                                   512, 16, seed=12)

    out["gemma2_2b"] = engine_runs(
        "gemma2_2b", built, (("bf16", "composed"),), gemma_requests, 8, 8192,
        lambda c, m: ("ternary_gemm_decode", "ternary_gemm_fused_quant",
                      "ternary_gemm_tiled", "write_rows_pair"))
    # the tied bf16 head (256000 x 2304), cast to float32 per call as the
    # JAX package does (no kernel of its own), at the engine's decode M 8
    x = torch.randn((8, 1, cfg_g.d_model), device=dev).to(torch.bfloat16)
    head_ms = cuda_ms(lambda: tt.project_head(model_g, x), iters=5)
    n_head = model_g.embed.numel()
    # the function needs the bf16 head read once, x read and the float32
    # logits written; the cast adds a float32 copy written and read back
    need = 2 * n_head + 2 * x.numel() + 4 * 8 * cfg_g.vocab_size
    head_bound, head_by = bound_ms(need, 2.0 * n_head * 8, F32_OPS_PER_S)
    out["gemma2_2b_tied_head"] = {
        "ms": head_ms, "M": 8, "bound_ms": head_bound, "bound_by": head_by,
        "cast_traffic_ms": bound_ms(n_head * (2 + 4 + 4), 0)[0],
        "note": "bf16 embed.T cast to float32 then torch.matmul"}
    print(json.dumps({"phase": "zoo", "tied_head": out["gemma2_2b_tied_head"],
                      "card": card}), flush=True)
    del built, model_g
    torch.cuda.empty_cache()

    # (c) each knob family, card against CPU (each layer from the CPU's
    # input and the logits within 2e-2 of the largest, the CPU's greedy
    # tokens, graphed tokens equal to eager ones), its graphed decode the
    # family's counted path (d)
    fams = {}
    for name in zoo.FAMILIES:
        r = zoo.card_vs_cpu(name, dev, counters=(reset, read))
        fams[name] = r
        print(json.dumps({"phase": "zoo_family", **r, "card": card}),
              flush=True)
        if not r["within_tol"]:
            fail(f"zoo family {name}: a layer {r['max_rel_layer_err']} or "
                 f"the logits {r['max_rel_logit_err']} of the largest off "
                 f"the CPU's (tolerance {zoo.TOL})")
        if not r["greedy_equal"]:
            fail(f"zoo family {name}: the card's greedy tokens differ from "
                 "the CPU's")
        if not r["graph_equals_eager"]:
            fail(f"zoo family {name}: graphed tokens differ from eager ones")
    out["families"] = {n: {k: r[k] for k in (
        "max_rel_layer_err", "max_rel_logit_err", "greedy_equal",
        "free_rel_logit_err", "launches")} for n, r in fams.items()}
    out["seconds"] = time.time() - t_phase
    print(json.dumps(out), flush=True)


def slice_phases(dev, built, fixture, card, reset, read, real) -> None:
    """Phases 12-17: speculative decoding, lookahead, grammar-constrained
    sampling, LoRA / control vectors and slot save/restore, at the
    flagship's full width (random weights) and on tiny_real (card against
    CPU)."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np
    import torch

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import engine as bench_engine
    from vlut_tpu_torch.bench import flagship
    from vlut_tpu_torch.convert.checkpoint import write_safetensors
    from vlut_tpu_torch.models.transformer import (
        TransformerLM, init_params_fast, quantize_head)
    from vlut_tpu_torch.runtime import grammar as gm
    from vlut_tpu_torch.runtime import lora
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    cfg_t, model_t = built
    greedy = SamplerParams(temperature=0.0)
    scratch = ROOT / "build" / "chip_smoke"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)

    def requests(n=32, lo=128, hi=512, new=32, seed=2):
        return bench_engine.make_requests(cfg_t.vocab_size, n, lo, hi, new,
                                          seed)

    def drive(path, expect, graph=True, n_slots=32, reqs=None, model=None,
              cfg=None, **kw):
        """One engine over ``reqs``, its launches read as ``path``."""
        reset()
        eng = Engine(cfg or cfg_t, model or model_t, n_slots=n_slots,
                     max_len=2048, cuda_graph=graph, **kw)
        reqs = reqs if reqs is not None else requests()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read(path, expect)
        bad = [r.rid for r in reqs if r.error or not r.done]
        if bad:
            fail(f"{path}: requests {bad} did not finish")
        return [r.output for r in reqs], eng, got, wall

    def stats(eng, wall):
        p = eng.perf
        steps = max(p.n_decode_steps, 1)
        return {"wall_s": wall, "rounds": p.n_spec_rounds,
                "decode_steps": p.n_decode_steps,
                "ms_per_round": 1e3 * p.t_decode_s / steps,
                "tokens_per_round": p.n_decode_tokens / steps,
                "drafted": p.n_spec_drafted, "accepted": p.n_spec_accepted,
                "acceptance": (p.n_spec_accepted / p.n_spec_drafted
                               if p.n_spec_drafted else None),
                "prompt_tok_s": (p.n_prompt_tokens / p.t_prompt_s
                                 if p.t_prompt_s else None),
                "capture_s": p.t_capture_s,
                "step_programs": eng.step_programs()}

    def share_equal(a, b):
        pairs = [x == y for u, v in zip(a, b) for x, y in zip(u, v)]
        return sum(pairs) / max(len(pairs), 1)

    def done():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # 12. speculative decoding at full width: the flagship with a random
    # bitnet_2b_4t draft (same 128,256 vocabulary), k 4, 32 slots
    t_phase = time.time()
    plain, eng, _, wall = drive("spec_plain", ("ternary_gemm_decode",))
    plain_stats = stats(eng, wall)
    del eng
    done()
    d_cfg, d_model = flagship.build_model("bitnet_2b_4t", dev, seed=1)
    spec = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        spec[run], eng, got, wall = drive(
            f"spec_draft_{run}", ("ternary_gemm_decode", "ternary_gemm_tiled",
                                  "decode_attention"),
            graph, draft=(d_cfg, d_model), k_draft=4)
        print(json.dumps({"phase": "speculative", "draft": "bitnet_2b_4t",
                          "k": 4, "run": run, **stats(eng, wall),
                          "share_equal_to_plain": share_equal(spec[run],
                                                              plain),
                          "plain_ms_per_step": plain_stats["ms_per_round"],
                          "launches": got, "card": card}), flush=True)
        del eng
        done()
    if spec["graph"] != spec["eager"]:
        fail("speculative (bitnet_2b_4t draft): graphed rounds' tokens "
             "differ from eager ones")
    del d_model, d_cfg
    done()
    own, eng, got, wall = drive("spec_self_draft", ("ternary_gemm_tiled",),
                                draft=(cfg_t, model_t), k_draft=4)
    print(json.dumps({"phase": "speculative", "draft": "the flagship itself",
                      "k": 4, "run": "graph", **stats(eng, wall),
                      "share_equal_to_plain": share_equal(own, plain),
                      "launches": got, "seconds": time.time() - t_phase}),
          flush=True)
    del eng
    done()

    # 13. lookahead at full width: W 4, G 3 (T 11, M 352 per round)
    t_phase = time.time()
    look = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        look[run], eng, got, wall = drive(
            f"lookahead_{run}", ("ternary_gemm_tiled",), graph,
            lookahead=(4, 3))
        print(json.dumps({"phase": "lookahead", "W": 4, "G": 3, "run": run,
                          **stats(eng, wall),
                          "share_equal_to_plain": share_equal(look[run],
                                                              plain),
                          "launches": got, "card": card,
                          "seconds": time.time() - t_phase}), flush=True)
        del eng
        done()
    if look["graph"] != look["eager"]:
        fail("lookahead: graphed rounds' tokens differ from eager ones")

    # 14. tiny_real on the card and the CPU: draft (itself, and itself with
    # its last layer dropped), lookahead, prompt lookup through the CLI, a
    # GBNF and a json_schema request, a LoRA and a control vector
    t_phase = time.time()
    cfg_r, gpu_r, cpu_r = real[0], real[1], real[2]
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(fixture)
    eos = tok.eos_id
    texts = [b"The little model", b"reads the lines", b"of its own repo.",
             b"The", b"little model reads the lines of its own repo.", b"re"]
    gbnf = 'root ::= "The " [a-z]+ (" " [a-z]+)* "."'
    schema = {"type": "object", "properties": {"a": {"type": "integer"},
                                               "b": {"type": "string",
                                                     "maxLength": 6}},
              "required": ["a", "b"]}

    def dropped(model):
        cfg_d = dataclasses.replace(cfg_r, n_layers=cfg_r.n_layers - 1)
        tree = model.tree()
        tree["layers"] = {k: ({kk: vv[:-1] for kk, vv in v.items()}
                              if isinstance(v, dict) else v[:-1])
                          for k, v in tree["layers"].items()}
        return cfg_d, TransformerLM(cfg_d, tree)

    rng = np.random.default_rng(5)
    adapter = scratch / "tiny_lora"
    adapter.mkdir()
    d, q, kv, ff = cfg_r.d_model, cfg_r.q_dim, cfg_r.kv_dim, cfg_r.d_ff
    arrays = {}
    for li in range(cfg_r.n_layers):
        for mod, block, k, n in (("q_proj", "self_attn", d, q),
                                 ("v_proj", "self_attn", d, kv),
                                 ("o_proj", "self_attn", q, d),
                                 ("up_proj", "mlp", d, ff),
                                 ("down_proj", "mlp", ff, d)):
            pre = f"base_model.model.model.layers.{li}.{block}.{mod}"
            arrays[f"{pre}.lora_A.weight"] = (
                rng.standard_normal((8, k)) * 0.05).astype(np.float32)
            arrays[f"{pre}.lora_B.weight"] = (
                rng.standard_normal((n, 8)) * 0.05).astype(np.float32)
    write_safetensors(adapter / "adapter_model.safetensors", arrays)
    (adapter / "adapter_config.json").write_text(
        json.dumps({"r": 8, "lora_alpha": 16}))
    cvec = (rng.standard_normal((cfg_r.n_layers, cfg_r.d_model))
            * 0.3).astype(np.float32)

    def tiny(model, mode):
        kw, m = {}, model
        if mode == "draft_self":
            kw = dict(draft=(cfg_r, model), k_draft=3)
        elif mode == "draft_dropped":
            kw = dict(draft=dropped(model), k_draft=3)
        elif mode == "lookahead":
            kw = dict(lookahead=(4, 3))
        elif mode == "lora":
            m = lora.apply_lora(model, lora.load_peft_adapter(adapter, cfg_r),
                                scale=1.0)
        elif mode == "cvector":
            m = lora.apply_cvector(model, cvec, scale=1.0)
        eng = Engine(cfg_r, m, n_slots=4, max_len=256, **kw)
        grams = [None] * len(texts)
        if mode == "grammar":
            grams[0] = tok.make_grammar(gbnf)
            grams[3] = tok.make_grammar(gm.json_schema_to_gbnf(schema))
        reqs = [Request(prompt=[2] + list(t), max_new_tokens=16,
                        sampler=greedy, stop_tokens=(eos,), grammar=g)
                for t, g in zip(texts, grams)]
        eng.run(reqs)
        return [r.output for r in reqs], eng.perf

    reset()
    modes = ("plain", "draft_self", "draft_dropped", "lookahead", "grammar",
             "lora", "cvector")
    card_out = {mode: tiny(gpu_r, mode) for mode in modes}
    got = read("tiny_real_slice", ("ternary_gemm_decode",
                                   "ternary_gemm_fused_quant",
                                   "decode_attention"))
    cpu_out = {mode: tiny(cpu_r, mode) for mode in modes}
    for mode in modes:
        if card_out[mode][0] != cpu_out[mode][0]:
            fail(f"tiny_real {mode}: card tokens differ from the CPU's")
    for mode in ("draft_self", "draft_dropped", "lookahead"):
        if card_out[mode][0] != card_out["plain"][0]:
            fail(f"tiny_real {mode}: tokens differ from plain greedy")
        if not card_out[mode][1].n_spec_rounds:
            fail(f"tiny_real {mode}: no round ran")
    if card_out["draft_self"][1].n_spec_accepted != card_out["draft_self"][
            1].n_spec_drafted:
        fail("tiny_real as its own draft: a proposal was rejected")
    for i, g in ((0, gm.Grammar.from_gbnf(gbnf)),
                 (3, gm.Grammar.from_gbnf(gm.json_schema_to_gbnf(schema)))):
        out = card_out["grammar"][0][i]
        text = "".join(tok.pieces()[t] for t in out if t != eos)
        if not gm.GrammarState(g).accepts_text_prefix(text):
            fail(f"tiny_real grammar request {i}: {text!r} is not accepted "
                 "by its grammar")
    for mode in ("lora", "cvector"):
        if card_out[mode][0] == card_out["plain"][0]:
            fail(f"tiny_real {mode}: the adapter changed no token")

    def cli_text(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(
                io.StringIO()):
            cli.main(argv)
        return buf.getvalue()

    base = ["generate", "--model", str(fixture), "-p",
            "The little model reads the lines", "-n", "16", "--temp", "0"]
    lookup = {d_: cli_text(base + ["--prompt-lookup", "3", "--device", d_])
              for d_ in ("cuda", "cpu")}
    plain_cli = cli_text(base + ["--device", "cuda"])
    print(json.dumps({
        "phase": "tiny_real_slice",
        "tokens": {m: card_out[m][0][0] for m in modes},
        "spec_rounds": {m: card_out[m][1].n_spec_rounds for m in modes},
        "accepted": {m: card_out[m][1].n_spec_accepted for m in modes},
        "grammar_texts": ["".join(tok.pieces()[t] for t in card_out[
            "grammar"][0][i] if t != eos) for i in (0, 3)],
        "cli_prompt_lookup": lookup["cuda"], "cli_plain": plain_cli,
        "launches": got, "seconds": time.time() - t_phase}), flush=True)
    if lookup["cuda"] != lookup["cpu"]:
        fail("CLI prompt lookup: card text differs from the CPU's")
    if not lookup["cuda"].startswith(plain_cli.rstrip("\n")):
        fail("CLI prompt lookup: text differs from plain greedy generate")

    # 15. grammar at full width: 8 slots of the flagship, a JSON schema
    # over a synthetic 128,256-piece vocabulary made from the seed
    t_phase = time.time()
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789 {}\":,.-_")
    rng = np.random.default_rng(11)
    v = cfg_t.vocab_size
    lens_ = rng.integers(1, 7, v)
    pieces = ["".join(rng.choice(alphabet, int(n_))) for n_ in lens_]
    pieces[3:3 + len(alphabet)] = alphabet  # every character alone too
    eos_f = 128001
    for i in (0, 1, 2, eos_f):
        pieces[i] = ""
    t0 = time.perf_counter()
    trie = gm.VocabTrie(pieces)
    trie_s = time.perf_counter() - t0
    schema_f = {"type": "object",
                "properties": {"name": {"type": "string", "maxLength": 8},
                               "n": {"type": "integer"}},
                "required": ["name", "n"]}
    gbnf_f = gm.json_schema_to_gbnf(schema_f)
    outs_g = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        reqs = [Request(prompt=r.prompt, max_new_tokens=16, sampler=greedy,
                        stop_tokens=(eos_f,),
                        grammar=gm.GrammarSampler(gbnf_f, pieces,
                                                  eos_ids=(eos_f,),
                                                  trie=trie))
                for r in requests(n=8, lo=64, hi=256, new=16, seed=4)]
        outs_g[run], eng, got, wall = drive(
            f"grammar_{run}", ("ternary_gemm_decode", "decode_attention"),
            graph, n_slots=8, reqs=reqs)
        p = eng.perf
        steps = max(p.n_decode_steps, 1)
        print(json.dumps({
            "phase": "grammar", "run": run, "slots": 8,
            "vocab_pieces": len(pieces), "trie_build_s": trie_s,
            "decode_steps": p.n_decode_steps,
            "host_mask_ms_per_step": 1e3 * p.t_grammar_s / steps,
            "step_ms_without_masks": 1e3 * (p.t_decode_s - p.t_grammar_s)
            / steps,
            "texts": ["".join(pieces[t] for t in o if t != eos_f)
                      for o in outs_g[run][:3]],
            "step_programs": eng.step_programs(), "launches": got,
            "card": card, "seconds": time.time() - t_phase}), flush=True)
        del eng
        done()
    if outs_g["graph"] != outs_g["eager"]:
        fail("grammar at full width: graphed tokens differ from eager ones")
    g_f = gm.Grammar.from_gbnf(gbnf_f)
    for o in outs_g["graph"]:
        text = "".join(pieces[t] for t in o if t != eos_f)
        if not gm.GrammarState(g_f).accepts_text_prefix(text):
            fail(f"grammar at full width: {text!r} is not accepted")

    # 16. LoRA at full width: a random rank-16 adapter on wq/wv/w_up (the
    # unfused tree, #4 per projection at decode), 32 slots, against the
    # fused model's step
    t_phase = time.time()
    rng = np.random.default_rng(6)
    adapter_f = scratch / "flagship_lora"
    adapter_f.mkdir()
    arrays = {}
    for li in range(cfg_t.n_layers):
        for mod, block, k, n in (("q_proj", "self_attn", 4096, 4096),
                                 ("v_proj", "self_attn", 4096, 1024),
                                 ("up_proj", "mlp", 4096, 14336)):
            pre = f"base_model.model.model.layers.{li}.{block}.{mod}"
            arrays[f"{pre}.lora_A.weight"] = (
                rng.standard_normal((16, k)) * 0.02).astype(np.float32)
            arrays[f"{pre}.lora_B.weight"] = (
                rng.standard_normal((n, 16)) * 0.02).astype(np.float32)
    write_safetensors(adapter_f / "adapter_model.safetensors", arrays)
    (adapter_f / "adapter_config.json").write_text(
        json.dumps({"r": 16, "lora_alpha": 32}))
    del arrays
    base_m = quantize_head(init_params_fast(cfg_t, seed=0, device=dev))
    lmodel = lora.apply_lora(base_m, lora.load_peft_adapter(adapter_f, cfg_t))
    del base_m
    lreqs = lambda: requests(n=32, lo=64, hi=256, new=16, seed=3)  # noqa: E731
    _, eng, _, wall = drive("lora_base_fused", ("ternary_gemm_decode",),
                            reqs=lreqs())
    fused_stats = stats(eng, wall)
    del eng
    done()
    outs_l = {}
    for graph in (True, False):
        run = "graph" if graph else "eager"
        outs_l[run], eng, got, wall = drive(
            f"lora_{run}", ("ternary_gemm_fused_quant", "ternary_gemm_decode",
                            "ternary_gemm_tiled"), graph, model=lmodel,
            reqs=lreqs())
        st = stats(eng, wall)
        per = [p_ for p_ in st["step_programs"] if p_.get("replays")]
        print(json.dumps({
            "phase": "lora", "rank": 16, "on": ["wq", "wv", "w_up"],
            "run": run, "ms_per_step": st["ms_per_round"],
            "fused_model_ms_per_step": fused_stats["ms_per_round"],
            "fused_quant_launches_per_step": (
                per[0]["launches_per_replay"].get("ternary_gemm_fused_quant")
                if per else None),
            "step_programs": st["step_programs"], "launches": got,
            "card": card, "seconds": time.time() - t_phase}), flush=True)
        del eng
        done()
    if outs_l["graph"] != outs_l["eager"]:
        fail("LoRA at full width: graphed tokens differ from eager ones")
    del lmodel
    done()

    # 17. slot save/restore on the flagship engine: a slot saved after its
    # request, erased, restored into another slot of the captured engine;
    # the continuation equals the one from the slot it was saved from
    t_phase = time.time()
    rng = np.random.default_rng(8)
    prompt = [int(t) for t in rng.integers(3, cfg_t.vocab_size, 300)]
    suffix = [int(t) for t in rng.integers(3, cfg_t.vocab_size, 8)]

    def continuation(restore):
        reset()
        eng = Engine(cfg_t, model_t, n_slots=4, max_len=2048)
        eng.run([Request(prompt=prompt, max_new_tokens=6, sampler=greedy)])
        hist = list(eng.slots[0].history)
        size = 0
        if restore:
            t0 = time.perf_counter()
            data = eng.save_slot(0)
            save_s = time.perf_counter() - t0
            eng.slots[0].history = []
            t0 = time.perf_counter()
            eng.restore_slot(2, data)
            torch.cuda.synchronize()
            size = (len(data), save_s, time.perf_counter() - t0)
            if eng.slots[2].history != hist:
                fail("slot restore: history differs")
        nxt = Request(prompt=hist + suffix, max_new_tokens=16,
                      sampler=greedy)
        eng.run([nxt])
        if eng.perf.n_reused_tokens != len(hist):
            fail(f"slot restore: reused {eng.perf.n_reused_tokens} of "
                 f"{len(hist)} rows")
        del eng
        done()
        return nxt.output, size

    orig, _ = continuation(False)
    restored, (n_bytes, save_s, load_s) = continuation(True)
    got = read("slot_restore", ("ternary_gemm_decode",))
    print(json.dumps({"phase": "slot_restore", "rows": len(prompt) + 5,
                      "bytes": n_bytes, "save_s": save_s, "restore_s": load_s,
                      "tokens_restored": restored, "tokens_original": orig,
                      "identical": restored == orig, "launches": got,
                      "seconds": time.time() - t_phase}), flush=True)
    if restored != orig:
        fail("slot restore: the continuation differs from the original's")
    shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    main()
