"""Decode-step ablation: where a batched decode step's time goes (port of
vlut_tpu/bench/ablate.py).

Builds the flagship decode step (``bench/flagship.py``'s model and
protocol: 32 slots, 128-token prompts) under a matrix of ``forward``'s
``ablate`` switches and reports the marginal ms a step of each:

* full              the serving path (fused projections and decode kernels)
* unfused           the tiled route and the composed projections at every M
* no_kv_write       the cache read, the new rows not written
* no_attn           the attention's output replaced by q
* no_head           the output head replaced by a sum of x
* gemms_only        no_kv_write + no_attn
* layer_gemms_only  no_kv_write + no_attn + no_head

The JAX package reads its switches from the environment when it traces;
the port takes them as ``forward(ablate=...)`` and ``make_generate_fn(
ablate=...)``, which nothing but this tool sets.  Each matrix runs under
the composed decode attention (the path JAX's ablation measured: #5 and
PyTorch) and the fused one (#7, which holds the row write): there
``no_kv_write`` alone changes nothing and is printed as not applicable,
not timed.

Timing protocol: each run a fresh prefill into one cache, then n greedy
steps of the graphed step timed with CUDA events (the decode step is one
CUDA graph, captured in each n's warm-up run), best of ``reps``, the
marginal between n = 8 and n = 40.

    python -m vlut_tpu_torch.bench.ablate [--preset llama3_8b_158]
        [--configs full,...] [--max-lens 200,...]

prints one JSON line per configuration and one of all.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

NP_SLOTS = 32
PROMPT_LEN = 128
N_LO, N_HI = 8, 40

CONFIGS = [
    ("full", frozenset()),
    ("unfused", frozenset({"unfused"})),
    ("no_kv_write", frozenset({"no_kv_write"})),
    ("no_attn", frozenset({"no_attn"})),
    ("no_head", frozenset({"no_head"})),
    ("gemms_only", frozenset({"no_kv_write", "no_attn"})),
    ("layer_gemms_only", frozenset({"no_kv_write", "no_attn", "no_head"})),
]


def applicable(switches: frozenset, decode_attn: str) -> bool:
    """Whether the switches change the step: under the fused attention
    the row write is #7's, so ``no_kv_write`` alone removes nothing."""
    return not (decode_attn == "fused" and switches == {"no_kv_write"})


@torch.inference_mode()
def run(built, dev, decode_attn: str = "composed",
        configs: list[str] | None = None, max_len: int | None = None,
        reps: int = 2) -> dict[str, float | None]:
    """ms a step of each configuration (None where not applicable) on
    ``built``, a (cfg, model) pair of ``bench/flagship.py:build_model``."""
    from vlut_tpu_torch.bench.flagship import _elapsed_ms
    from vlut_tpu_torch.models.transformer import forward, init_kv_cache
    from vlut_tpu_torch.runtime.generate import make_generate_fn
    from vlut_tpu_torch.runtime.sampling import (
        SamplerParams,
        features_of,
        stack_params,
    )

    cfg, model = built
    max_len = max_len or PROMPT_LEN + N_HI + 16
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (NP_SLOTS, PROMPT_LEN))).to(dev)
    positions = torch.arange(PROMPT_LEN, device=dev)[None].repeat(NP_SLOTS, 1)
    logits_at = torch.full((NP_SLOTS,), PROMPT_LEN - 1, device=dev)
    cache = init_kv_cache(cfg, NP_SLOTS, max_len=max_len, device=dev)

    def prefill():
        return forward(model, cfg, tokens, positions, cache,
                       logits_at=logits_at)

    logits, _ = prefill()
    last = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)
    lengths = torch.full((NP_SLOTS,), PROMPT_LEN, device=dev)
    samplers = [SamplerParams(temperature=0.0)] * NP_SLOTS
    sp = stack_params(samplers, device=dev)
    out: dict[str, float | None] = {}
    for name, switches in CONFIGS:
        if configs and name not in configs:
            continue
        if not applicable(switches, decode_attn):
            out[name] = None
            continue
        ms = {}
        for n in (N_LO, N_HI):
            gen = make_generate_fn(cfg, n_steps=n,
                                   features=features_of(samplers),
                                   decode_attn=decode_attn, ablate=switches)
            prefill()
            gen(model, cache, last, lengths, sp)  # warm-up, capture
            best = float("inf")
            for _ in range(reps):
                prefill()
                _, t = _elapsed_ms(dev, lambda: gen(model, cache, last,
                                                    lengths, sp))
                best = min(best, t)
            ms[n] = best
            del gen
        out[name] = (ms[N_HI] - ms[N_LO]) / (N_HI - N_LO)
        torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> dict:
    from vlut_tpu_torch.bench.flagship import build_model
    from vlut_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.ablate",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="llama3_8b_158")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of the configurations")
    ap.add_argument("--max-lens", default=None,
                    help="comma-separated cache sizes (default: prompt + "
                    "56); whether a cost scales with the cache separates "
                    "whole-cache work from per-row work")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    built = build_model(args.preset, dev)
    configs = args.configs.split(",") if args.configs else None
    max_lens = ([int(x) for x in args.max_lens.split(",")]
                if args.max_lens else [None])
    results = {}
    for attn in ("composed", "fused"):
        for ml in max_lens:
            tag = attn if ml is None else f"{attn}@S{ml}"
            res = run(built, dev, attn, configs, ml)
            for name, ms in res.items():
                print(json.dumps({"decode_attn": attn, "max_len": ml,
                                  "config": name, "ms_per_step": ms,
                                  "tok_per_s": NP_SLOTS / ms * 1e3
                                  if ms else None,
                                  "note": None if ms is not None else
                                  "not applicable: #7 holds the row write",
                                  "card": card}), flush=True)
            results[tag] = res
    summary = {"preset": args.preset, "ms_per_step": results, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
