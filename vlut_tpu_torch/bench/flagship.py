"""Flagship batched-decode benchmark of the port (the ``bench.py`` protocol).

A packed i2 ternary Llama at ``llama3_8b_158`` shapes with seeded random
weights generated on the device (int8 output head, fused and unrolled
layer tree): one prefill of 32 slots x 128-token prompts, then greedy
batched decode.  The decode step time is the marginal between an n = 8 and
an n = 40 run (each after a fresh prefill, best of ``reps``), which cancels
the fixed per-run costs.  Device times come from CUDA events.

    python -m vlut_tpu_torch.bench.flagship [--layers L] [--device cpu]
        [--decode-attn fused|composed] [--profile]

prints one JSON line with prefill ms, ms per decode step and tokens/s
(and, with ``--profile``, the device time of one decode run by kernel).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models.transformer import (
    forward,
    fuse_projections,
    init_kv_cache,
    init_params_fast,
    quantize_head,
    unstack_layers,
)
from vlut_tpu_torch.runtime.generate import make_generate_fn
from vlut_tpu_torch.runtime.sampling import (
    SamplerParams,
    features_of,
    stack_params,
)

NP_SLOTS = 32
PROMPT_LEN = 128
N_LO, N_HI = 8, 40


def build_model(preset: str, device, n_layers: int | None = None,
                seed: int = 0):
    """(cfg, model): the serving tree (int8 head, fused, unrolled)."""
    cfg = PRESETS[preset]
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = init_params_fast(cfg, seed=seed, device=device)
    model = quantize_head(model)
    model = unstack_layers(fuse_projections(model, cfg), cfg)
    return cfg, model


def _elapsed_ms(dev: torch.device, fn):
    """(result, ms) of one call: CUDA events on the GPU, the host clock on
    the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


@torch.inference_mode()
def run(preset: str = "llama3_8b_158", device=None, n_layers: int | None = None,
        reps: int = 3, seed: int = 0, np_slots: int = NP_SLOTS,
        prompt_len: int = PROMPT_LEN, n_lo: int = N_LO,
        n_hi: int = N_HI, profile: bool = False,
        decode_attn: str = "fused", built=None) -> dict:
    """``built``: a (cfg, model) pair from :func:`build_model` to reuse;
    ``decode_attn``: the decode step's attention path (``forward``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg, model = built or build_model(preset, dev, n_layers, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    max_len = prompt_len + n_hi + 16
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (np_slots, prompt_len))).to(dev)
    positions = torch.arange(prompt_len, device=dev)[None].repeat(np_slots, 1)
    logits_at = torch.full((np_slots,), prompt_len - 1, device=dev)

    def prefill():
        cache = init_kv_cache(cfg, np_slots, max_len=max_len, device=dev)
        return forward(model, cfg, tokens, positions, cache,
                       logits_at=logits_at)

    prefill()  # warm-up
    prefill_ms = min(_elapsed_ms(dev, prefill)[1] for _ in range(reps))
    logits, _ = prefill()
    if not bool(torch.isfinite(logits).all()) or logits.shape[:2] != (
            np_slots, 1):
        raise RuntimeError(f"bad prefill logits {tuple(logits.shape)}")

    samplers = [SamplerParams(temperature=0.0)] * np_slots
    sp = stack_params(samplers, device=dev)
    last = torch.argmax(logits[:, 0, : cfg.vocab_size], dim=-1)
    lengths = torch.full((np_slots,), prompt_len, device=dev)
    decode_ms = {}
    for n in (n_lo, n_hi):
        gen = make_generate_fn(cfg, n_steps=n, features=features_of(samplers),
                               decode_attn=decode_attn)
        _, cache = prefill()
        toks, _ = gen(model, cache, last, lengths, sp)  # warm-up
        best = float("inf")
        for _ in range(reps):
            _, cache = prefill()
            (toks, _), ms = _elapsed_ms(
                dev, lambda: gen(model, cache, last, lengths, sp))
            best = min(best, ms)
        if toks.shape != (np_slots, n) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise RuntimeError("decode produced out-of-range tokens")
        decode_ms[n] = best
    step_ms = (decode_ms[n_hi] - decode_ms[n_lo]) / (n_hi - n_lo)
    prof = None
    if profile and dev.type == "cuda":
        gen = make_generate_fn(cfg, n_steps=n_lo,
                               features=features_of(samplers),
                               decode_attn=decode_attn)
        _, cache = prefill()
        prof = profile_decode(lambda: gen(model, cache, last, lengths, sp),
                              n_lo)
    return {
        "preset": preset,
        "n_layers": cfg.n_layers,
        "decode_attn": decode_attn,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "setup_s": setup_s,
        "prefill_ms": prefill_ms,
        "prefill_tok_per_s": np_slots * prompt_len / prefill_ms * 1e3,
        "decode_ms": decode_ms,
        "ms_per_step": step_ms,
        "tok_per_s": np_slots / step_ms * 1e3,
        **({"profile": prof} if prof is not None else {}),
    }


def profile_decode(fn, n_steps: int, top: int = 12) -> dict:
    """Device time by kernel over one call of ``fn`` (``n_steps`` decode
    steps) under ``torch.profiler``: the wall time, the summed kernel time,
    the device's idle share, the ``top`` kernels by time with their
    launches per step, and the host operators by self CPU time (what the
    host spends dispatching a step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = p.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "wall_ms_per_step": wall_ms / n_steps,
        "kernel_ms_per_step": busy_ms / n_steps,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "top": [{"kernel": e.key[:80],
                 "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                 "launches_per_step": e.count / n_steps}
                for e in kernels[:top]],
        "host_top": [{"op": e.key[:60],
                      "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3
                      / n_steps,
                      "calls_per_step": e.count / n_steps}
                     for e in host[:top]],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.flagship")
    ap.add_argument("--preset", default="llama3_8b_158")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--decode-attn", choices=("fused", "composed"),
                    default="fused")
    ap.add_argument("--profile", action="store_true",
                    help="also break one n=8 decode run down by kernel "
                    "(torch.profiler; GPU only)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.preset, args.device, args.layers,
                         profile=args.profile,
                         decode_attn=args.decode_attn)))


if __name__ == "__main__":
    main()
