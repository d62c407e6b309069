"""Ternary GEMM microbenchmark (port of vlut_tpu/bench/kernels.py, the
mirror of the reference's ``test-vlut-gemm`` perf mode over real model GEMM
shapes).

Four lanes at each shape: the Vec-LUT formats i2 and i1 through the tiled
kernel (#3, ``ternary_gemm_tiled``) and llama.cpp's TQ2_0 and TQ1_0 through
the TQ kernel (#9, ``tq_gemm``).  On the card each sample is a CUDA graph of
``iters`` calls timed with CUDA events; the calls cycle over a rotation of
distinct weight copies whose total exceeds the 50 MB L2 cache (at least
``L_STACK`` copies and 128 MB), so every call streams its weight from
device memory, as a decode step does.  The time is the best sample's
device time per call.  On the CPU (``--device cpu``) the plain versions run
and the host clock times them (a check of the lanes, not a measurement).

Weights are made on the device from a seeded ``torch.Generator`` with valid
codes only (base-3 codes written as 2-bit fields for i2/tq2, bytes < 243
for i1 and tq1 rows 0-47, < 81 for tq1 rows 48-51).  The TPU's uint32 word
layout (``--word``) is not benchmarked: the port refuses that layout.

    python -m vlut_tpu_torch.bench.kernels [-m llama3_8b] [-ns 32,256]
        [--fmt i2,i1,tq2,tq1] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any

import torch

from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.ops import tq
from vlut_tpu_torch.ops.packing import (
    DEFAULT_BLOCK,
    TRITS_PER_BYTE,
    padded_k,
    random_packed_bytes,
)
from vlut_tpu_torch.ops.ternary_gemm import (
    sm_count, ternary_gemm_tiled, tiled_plan)

# reference shapes: tests/test-vlut-gemm.cpp:717-721
MODEL_SHAPES = {
    "bitnet_3b": (3200, 8640),
    "llama3_8b": (4096, 14336),
    "falcon_1b": (2048, 8192),
}
L_STACK = 8
ROTATION_BYTES = 128 << 20


def tq_bk(kp: int) -> int:
    """The largest of 2048/1024/512/256 that divides Kp (the JAX bench's
    tile choice, which also sets the TQ sum's float order)."""
    return next(b for b in (2048, 1024, 512, 256) if kp % b == 0)


def rand_packed(fmt: str, k: int, n: int, gen, device) -> torch.Tensor:
    """Random valid packed weights of a logical (K, N) matrix."""
    if fmt == "tq2":
        return random_packed_bytes((-(-k // tq.QK) * 64, n), "i2", gen, device)
    if fmt == "tq1":
        nb = -(-k // tq.QK)
        p = torch.randint(0, 243, (nb, 52, n), generator=gen, device=device,
                          dtype=torch.int32)
        p[:, 48:] = torch.randint(0, 81, (nb, 4, n), generator=gen,
                                  device=device, dtype=torch.int32)
        return p.reshape(nb * 52, n).to(torch.uint8)
    rows = padded_k(k, fmt) // TRITS_PER_BYTE[fmt]
    return random_packed_bytes((rows, -(-n // 128) * 128), fmt, gen, device)


def _device_us(call, iters: int, repeats: int) -> float:
    """Best device time per call, in us, of a CUDA graph of ``iters``
    calls."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            call()
    best = math.inf
    for _ in range(repeats + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / iters)
    return best


def _host_us(call, repeats: int) -> float:
    call()
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def bench_gemm(
    fmt: str,
    m: int,
    k: int,
    n: int,
    repeats: int = 3,
    device=None,
    iters: int | None = None,
) -> dict[str, Any]:
    """One (fmt, M, K, N) lane: us per call, packed GB/s and TFLOP/s, with
    the JAX bench's keys.  ``blocks`` are the kernel's own tiles: its plan
    for this shape on the card (the TQ kernel's (BM, BN, splits, bk), the
    tiled kernel's (BM, BN, kb, splits)); on the CPU, whose plain versions
    have no tiles and whose plans need the card's SM count, only the K step
    (bk, kb)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    packed = rand_packed(fmt, k, n, gen, dev)
    xs = torch.ones((m, 1), device=dev)
    if fmt in tq.ROWS_PER_BLOCK:
        kp = packed.shape[0] // tq.ROWS_PER_BLOCK[fmt] * tq.QK
        bk = tq_bk(kp)
        blocks = ((*tq.tq_plan(m, n, kp, bk, tq.sm_count(dev.index or 0)),
                   bk) if dev.type == "cuda" else (bk,))
        scales = torch.full((kp // tq.QK, n), 0.03, dtype=torch.float16,
                            device=dev)
        wbytes = packed.numel() + scales.numel() * 2
        xq = torch.randint(-100, 100, (m, kp), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)

        def gemm(p):
            return tq.tq_gemm(xq, p, scales, xs, fmt=fmt, bk=bk)
    else:
        kb = DEFAULT_BLOCK[fmt]
        # the tiled kernel's plan (BM, BN, splits of K) and its K step
        blocks = (kb,)
        if dev.type == "cuda":
            bm, bn, splits = tiled_plan(m, packed.shape[1], padded_k(k, fmt),
                                        fmt, sm_count(dev.index or 0))
            blocks = (bm, bn, kb, splits)
        ws = torch.ones((packed.shape[1],), device=dev)
        wbytes = packed.numel()
        xq = torch.randint(-100, 100, (m, k), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)

        def gemm(p):
            return ternary_gemm_tiled(xq, p, xs, ws, fmt=fmt, kb=kb, k=k)
    if dev.type == "cuda":
        n_copies = max(L_STACK, math.ceil(ROTATION_BYTES / wbytes))
        copies = [packed] + [packed.clone() for _ in range(n_copies - 1)]
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % n_copies
            return gemm(copies[state["i"]])

        us = _device_us(call, iters or max(n_copies, 20), repeats)
        del copies
    else:
        us = _host_us(lambda: gemm(packed), repeats)
    dt = us * 1e-6
    return {
        "fmt": fmt, "m": m, "k": k, "n": n, "blocks": blocks,
        "us": us, "gbps_packed": wbytes / dt / 1e9,
        "tflops": 2 * m * k * n / dt / 1e12,
    }


def main(argv: list[str] | None = None) -> list[dict[str, Any]]:
    """Print the table (model, gemm, fmt, M, us, GB/s, TFLOP/s) and return
    its rows (each with its model and gemm tag)."""
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.kernels",
                                 description="ternary GEMM microbench")
    ap.add_argument("-m", "--model", choices=list(MODEL_SHAPES), default=None)
    ap.add_argument("-ns", default="32,256",
                    help="comma-separated token counts")
    ap.add_argument("--fmt", default="i2,i1",
                    help="comma-separated lanes of i2, i1, tq2, tq1")
    ap.add_argument("--word", action="store_true",
                    help="not supported: the port refuses the TPU's uint32 "
                    "word layout")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.word:
        ap.error("--word: the port refuses the TPU's uint32 word layout "
                 "(ROADMAP, interchange format); only the byte layout is "
                 "benchmarked")
    fmts = args.fmt.split(",")
    for f in fmts:
        if f not in ("i2", "i1", "tq2", "tq1"):
            ap.error(f"unknown lane {f!r}")
    models = [args.model] if args.model else list(MODEL_SHAPES)
    ns = [int(x) for x in args.ns.split(",")]
    print(f"{'model':10s} {'gemm':14s} {'fmt':3s} {'M':>4s} "
          f"{'us':>9s} {'GB/s':>7s} {'TFLOP/s':>8s}", flush=True)
    rows = []
    for model in models:
        d, ff = MODEL_SHAPES[model]
        for (k, n, tag) in ((d, d, "dxd"), (d, ff, "dxff"), (ff, d, "ffxd")):
            for fmt in fmts:
                for m in ns:
                    r = bench_gemm(fmt, m, k, n, device=args.device)
                    print(f"{model:10s} {tag:14s} {r['fmt']:3s} {m:4d} "
                          f"{r['us']:9.1f} {r['gbps_packed']:7.1f} "
                          f"{r['tflops']:8.2f}", flush=True)
                    rows.append({"model": model, "gemm": tag, **r})
    return rows


if __name__ == "__main__":
    main()
