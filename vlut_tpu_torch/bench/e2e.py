"""End-to-end benchmark tools (port of vlut_tpu/bench/e2e.py; the
reference's ``llama-bench`` and ``batched-bench``).

``bench_sweep``   - llama-bench analog: a grid over (n_prompt, n_gen, batch)
                    that reports prefill tok/s (pp rows) and decode tok/s
                    (tg rows).
``batched_bench`` - batched-bench analog: an (npp, ntg, npl) grid of npl
                    parallel sequences, npp prompt and ntg generated tokens
                    each, with the total throughput.

Protocol: a warm-up run, then the best of ``repeats`` runs, each fenced by
``torch.cuda.synchronize()`` on the card.  The JAX package runs decode as
one ``lax.scan``; here decode is the port's eager loop
(``runtime/generate.py``: one Python ``forward`` call per step), so a tg row
measures the host-bound step of PERF.md §5, launches and all.  Output
formats: md | csv | json.

    python -m vlut_tpu_torch.bench.e2e sweep [-m DIR | --preset P]
        [--fmt i2|i1] [-p 512] [-n 128] [-b 1] [-o md|csv|json] [--device cpu]
    python -m vlut_tpu_torch.bench.e2e batched [-m DIR | --preset P]
        [-npp 16] [-ntg 16] [-npl 64] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import torch

from vlut_tpu_torch.device import resolve_device


def _timeit(fn, dev: torch.device, repeats: int = 3) -> float:
    """Best-of-N seconds of ``fn()``, each run fenced on the device."""
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _load_model(model: str | None, preset: str | None, fmt: str, device,
                n_layers: int | None = None):
    """(cfg, model) with the serving load-time transforms: projections
    fused, layers unrolled, and, for random preset weights, the int8 head
    of the flagship bench."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.transformer import (
        fuse_projections,
        init_params_fast,
        quantize_head,
        unstack_layers,
    )

    if model:
        from vlut_tpu_torch.convert.checkpoint import load_checkpoint

        cfg, params, _ = load_checkpoint(model, device=device)
    else:
        cfg = dataclasses.replace(PRESETS[preset or "llama3_8b_158"],
                                  weight_fmt=fmt)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = quantize_head(init_params_fast(cfg, seed=0, device=device))
    return cfg, unstack_layers(fuse_projections(params, cfg), cfg)


def _decode_fn(cfg, n_steps: int, impl: str):
    from vlut_tpu_torch.runtime.generate import make_generate_fn
    from vlut_tpu_torch.runtime.sampling import SamplerParams, stack_params

    gen = make_generate_fn(cfg, n_steps, features=(), impl=impl)

    def run(params, cache, last, lengths):
        sp = stack_params([SamplerParams(temperature=0.0)] * last.shape[0],
                          device=last.device)
        return gen(params, cache, last, lengths, sp)[0]

    return run


@torch.inference_mode()
def bench_sweep(
    model: str | None = None,
    preset: str | None = None,
    fmt: str = "i2",
    n_prompt: tuple[int, ...] = (512,),
    n_gen: tuple[int, ...] = (128,),
    batch: tuple[int, ...] = (1,),
    impl: str = "auto",
    repeats: int = 3,
    device=None,
    n_layers: int | None = None,
    built=None,
) -> list[dict[str, Any]]:
    """pp rows: one prefill of (batch, n_prompt) tokens with only the last
    row's logits; tg rows: n_gen greedy decode steps of the batch from an
    empty cache.  ``built``: a (cfg, model) pair to reuse."""
    from vlut_tpu_torch.models.transformer import forward, init_kv_cache

    dev = resolve_device(device)
    cfg, params = built or _load_model(model, preset, fmt, dev, n_layers)
    name = model or preset or "llama3_8b_158"
    rows: list[dict[str, Any]] = []

    def row(test, b, n, dt):
        rows.append({"model": name, "test": test, "batch": b,
                     "n_tokens": b * n, "time_s": round(dt, 4),
                     "tok_per_s": round(b * n / dt, 2)})

    for b in batch:
        for pp in n_prompt:
            if not pp:
                continue
            toks = torch.zeros((b, pp), dtype=torch.long, device=dev)
            pos = torch.arange(pp, device=dev)[None].repeat(b, 1)

            def prefill():
                return forward(params, cfg, toks, pos, None, impl=impl,
                               logits_last_only=True)[0]

            _timeit(prefill, dev, 1)  # warm-up
            row(f"pp{pp}", b, pp, _timeit(prefill, dev, repeats))
        for tg in n_gen:
            if not tg:
                continue
            max_len = max(n_prompt or (0,)) + tg + 8
            cache = init_kv_cache(cfg, b, max_len=max_len, device=dev)
            last = torch.zeros((b,), dtype=torch.long, device=dev)
            start = torch.zeros((b,), dtype=torch.long, device=dev)
            decode = _decode_fn(cfg, tg, impl)

            def decode_n():
                return decode(params, cache, last, start)

            _timeit(decode_n, dev, 1)  # warm-up
            row(f"tg{tg}", b, tg, _timeit(decode_n, dev, repeats))
    return rows


@torch.inference_mode()
def batched_bench(
    model: str | None = None,
    preset: str | None = None,
    fmt: str = "i2",
    npp: tuple[int, ...] = (16,),
    ntg: tuple[int, ...] = (16,),
    npl: tuple[int, ...] = (64,),
    impl: str = "auto",
    device=None,
    n_layers: int | None = None,
    built=None,
) -> list[dict[str, Any]]:
    """batched-bench grid: npl parallel sequences, a prefill of npp tokens
    each, then ntg greedy decode steps; one timed run after a warm-up."""
    from vlut_tpu_torch.models.transformer import forward, init_kv_cache

    dev = resolve_device(device)
    cfg, params = built or _load_model(model, preset, fmt, dev, n_layers)
    rows = []
    for b in npl:
        for pp in npp:
            for tg in ntg:
                cache = init_kv_cache(cfg, b, max_len=pp + tg + 8, device=dev)
                toks = torch.zeros((b, pp), dtype=torch.long, device=dev)
                pos = torch.arange(pp, device=dev)[None].repeat(b, 1)
                at = torch.full((b,), pp - 1, device=dev)
                lens = torch.full((b,), pp, device=dev)
                decode = _decode_fn(cfg, tg, impl)

                def run():
                    lg, _ = forward(params, cfg, toks, pos, cache, impl=impl,
                                    logits_at=at)
                    last = torch.argmax(lg[:, 0, : cfg.vocab_size], dim=-1)
                    return decode(params, cache, last, lens)

                _timeit(run, dev, 1)  # warm-up
                dt = _timeit(run, dev, 1)
                total = b * (pp + tg)
                rows.append({"PP": pp, "TG": tg, "B": b, "N_KV": total,
                             "T_s": round(dt, 3),
                             "S_t/s": round(total / dt, 2)})
    return rows


def format_rows(rows: list[dict[str, Any]], fmt: str = "md") -> str:
    if not rows:
        return ""
    if fmt == "json":
        return json.dumps(rows, indent=2)
    cols = list(rows[0].keys())
    if fmt == "csv":
        out = [",".join(cols)]
        out += [",".join(str(r[c]) for c in cols) for r in rows]
        return "\n".join(out)
    widths = {
        c: max(len(str(c)), *(len(str(r[c])) for r in rows)) for c in cols
    }
    line = "| " + " | ".join(str(c).ljust(widths[c]) for c in cols) + " |"
    sep = "|" + "|".join("-" * (widths[c] + 2) for c in cols) + "|"
    body = [
        "| " + " | ".join(str(r[c]).ljust(widths[c]) for c in cols) + " |"
        for r in rows
    ]
    return "\n".join([line, sep] + body)


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.e2e",
                                 description="end-to-end bench")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("-m", "--model", default=None)
        p.add_argument("--preset", default="llama3_8b_158")
        p.add_argument("--fmt", default="i2")
        p.add_argument("-o", "--output", default="md",
                       choices=("md", "csv", "json"))
        p.add_argument("--layers", type=int, default=None,
                       help="cut a preset's depth")
        p.add_argument("--device", default=None, help="cuda (default) or cpu")

    p = sub.add_parser("sweep", help="llama-bench analog")
    common(p)
    p.add_argument("-p", "--n-prompt", default="512")
    p.add_argument("-n", "--n-gen", default="128")
    p.add_argument("-b", "--batch", default="1")
    p.add_argument("-r", "--repeats", type=int, default=3)

    q = sub.add_parser("batched", help="batched-bench analog")
    common(q)
    q.add_argument("-npp", default="16")
    q.add_argument("-ntg", default="16")
    q.add_argument("-npl", default="64")

    args = ap.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in str(s).split(",") if x)  # noqa: E731
    kw = dict(model=args.model, preset=args.preset, fmt=args.fmt,
              device=args.device, n_layers=args.layers)
    if args.cmd == "sweep":
        rows = bench_sweep(n_prompt=ints(args.n_prompt),
                           n_gen=ints(args.n_gen), batch=ints(args.batch),
                           repeats=args.repeats, **kw)
    else:
        rows = batched_bench(npp=ints(args.npp), ntg=ints(args.ntg),
                             npl=ints(args.npl), **kw)
    print(format_rows(rows, args.output))


if __name__ == "__main__":
    main()
