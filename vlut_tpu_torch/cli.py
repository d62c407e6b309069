"""Command-line entry point of the port.

  python -m vlut_tpu_torch.cli batched --model DIR -p PROMPT -np N -n N
      [--temp T] [--repeat-penalty R] [--seed S] [--device cpu]

``batched`` is the shared-prompt np-way fan-out (the JAX package's
``vlut-tpu batched``): one prompt prefilled into np slots, then n decode
steps per slot.  It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def run_batched(model, cfg, ids: list[int], np_parallel: int, n_predict: int,
                temp: float = 0.5, repeat_penalty: float = 1.5,
                seed: int = 0) -> torch.Tensor:
    """Prefill ``ids`` into ``np_parallel`` slots and generate ``n_predict``
    tokens per slot; returns (np, n_predict) token ids.  As in the JAX
    package, the argmax of the prefill logits seeds decoding and is not part
    of the returned rows."""
    from vlut_tpu_torch.models.transformer import forward, init_kv_cache
    from vlut_tpu_torch.runtime.generate import make_generate_fn
    from vlut_tpu_torch.runtime.sampling import (
        SamplerParams,
        features_of,
        stack_params,
    )

    dev = model.device
    b, t = np_parallel, len(ids)
    cache = init_kv_cache(cfg, b, max_len=t + n_predict + 8, device=dev)
    tokens = torch.tensor(ids, dtype=torch.long, device=dev)[None].repeat(b, 1)
    pos = torch.arange(t, device=dev)[None].repeat(b, 1)
    with torch.inference_mode():
        logits, cache = forward(model, cfg, tokens, pos, cache,
                                logits_at=torch.full((b,), t - 1, device=dev))
    samplers = [SamplerParams(temperature=temp, seed=i,
                              repeat_penalty=repeat_penalty) for i in range(b)]
    last = torch.argmax(logits[:, 0, : cfg.vocab_size], dim=-1)
    gen = make_generate_fn(cfg, n_steps=n_predict,
                           features=features_of(samplers))
    out, _ = gen(model, cache, last, torch.full((b,), t, device=dev),
                 stack_params(samplers, device=dev), seed)
    return out


def cmd_batched(args) -> None:
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    tok = Tokenizer(args.model)
    t0 = time.time()
    out = run_batched(model, cfg, tok.encode(args.prompt), args.np_parallel,
                      args.n_predict, args.temp, args.repeat_penalty,
                      args.seed)
    dt = time.time() - t0
    for i, row in enumerate(out.tolist()):
        print(f"--- seq {i} ---")
        print(args.prompt + tok.decode(row))
    total = args.np_parallel * args.n_predict
    print(f"\n[{total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s on "
          f"{model.device}]", file=sys.stderr)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("batched", help="shared-prompt np-way fan-out")
    p.add_argument("--model", required=True)
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("-np", "--np-parallel", type=int, default=32)
    p.add_argument("-n", "--n-predict", type=int, default=16)
    p.add_argument("--temp", type=float, default=0.5)
    p.add_argument("--repeat-penalty", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_batched)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
