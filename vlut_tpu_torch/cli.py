"""Command-line entry point of the port.

  python -m vlut_tpu_torch.cli generate --model DIR -p PROMPT [-n N]
      [--ctx N] [--cache-type bf16|q8] [--head-type bf16|q8]
      [--decode-attn fused|composed] [sampler flags] [-l TOKEN:BIAS]
      [--seed S] [--device cpu]
  python -m vlut_tpu_torch.cli serve --model DIR [--port 8080] [--slots 8]
      [--ctx 4096] [--cache-type bf16|q8] [--decode-attn fused|composed]
      [--device cpu]
  python -m vlut_tpu_torch.cli batched --model DIR -p PROMPT -np N -n N
      [--temp T] [--repeat-penalty R] [--seed S] [--device cpu]
  python -m vlut_tpu_torch.cli bench [-m llama3_8b] [-ns 32,256]
      [--fmt i2,i1,tq2,tq1] [--device cpu]
  python -m vlut_tpu_torch.cli bench-sweep [-m DIR | --preset P] [--fmt i2]
      [-p 512] [-n 128] [-b 1] [-o md|csv|json] [--device cpu]
  python -m vlut_tpu_torch.cli batched-bench [-m DIR | --preset P]
      [-npp 16] [-ntg 16] [-npl 64] [--device cpu]
  python -m vlut_tpu_torch.cli ppl --model DIR -f FILE [--window 512]
      [--check-lossless] [--save-logits F.npz | --kl-base F.npz]
      [--device cpu]
  python -m vlut_tpu_torch.cli eval --model DIR --task hellaswag|winogrande|mc
      -f FILE [--limit N] [--device cpu]
  python -m vlut_tpu_torch.cli quantize SRC DST --fmt i2|i1
  python -m vlut_tpu_torch.cli inspect DIR [--hash]

``generate`` serves one request through the slot engine; ``serve`` starts
the completion server; ``batched`` is the shared-prompt np-way fan-out (one
prompt prefilled into np slots, then n decode steps per slot).  ``bench``
is the kernel microbenchmark (i2/i1 through the tiled ternary kernel,
llama.cpp's TQ2_0/TQ1_0 through the TQ kernel); ``bench-sweep`` and
``batched-bench`` are the llama-bench and batched-bench analogs; ``ppl``
and ``eval`` the perplexity harness (with the quantized-vs-dequant KL
check) and the accuracy tasks.  Each of these runs on the GPU unless
``--device cpu`` is given.  ``quantize`` (exact i2 <-> i1 repack) and
``inspect`` (config and tensor directory, ``--hash`` for sha256 digests)
touch no device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def run_batched(model, cfg, ids: list[int], np_parallel: int, n_predict: int,
                temp: float = 0.5, repeat_penalty: float = 1.5,
                seed: int = 0, decode_attn: str = "fused") -> torch.Tensor:
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
                           features=features_of(samplers),
                           decode_attn=decode_attn)
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


def sampler_from_args(args):
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    bias = []
    for spec in args.logit_bias or ():
        t, _, b = spec.partition(":")
        bias.append((int(t), float(b)))
    return SamplerParams(
        temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, typical_p=args.typical,
        dynatemp_range=args.dynatemp_range,
        dynatemp_exponent=args.dynatemp_exp,
        xtc_p=args.xtc_probability, xtc_t=args.xtc_threshold,
        top_n_sigma=args.top_nsigma,
        mirostat_tau=(args.mirostat_ent if args.mirostat else 0.0),
        mirostat_eta=args.mirostat_lr,
        repeat_penalty=args.repeat_penalty,
        presence_penalty=args.presence_penalty,
        frequency_penalty=args.frequency_penalty,
        dry_multiplier=args.dry_multiplier, dry_base=args.dry_base,
        dry_allowed_length=args.dry_allowed_length,
        logit_bias=tuple(bias), seed=args.seed,
    )


def cmd_generate(args) -> None:
    """One request through the slot engine (the JAX package's engine branch
    of ``vlut-tpu generate``)."""
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    tok = Tokenizer(args.model)
    eng = Engine(cfg, model, n_slots=1, max_len=args.ctx,
                 kv_quant=args.cache_type == "q8",
                 head_quant=args.head_type == "q8",
                 decode_attn=args.decode_attn)
    stop = (tok.eos_id,) if tok.eos_id is not None else ()
    req = Request(prompt=tok.encode(args.prompt),
                  max_new_tokens=args.n_predict,
                  sampler=sampler_from_args(args), stop_tokens=stop)
    t0 = time.time()
    eng.run([req])
    dt = time.time() - t0
    print(tok.decode(req.output))
    print(f"\n[{len(req.output)} tokens, {len(req.output) / dt:.1f} tok/s | "
          f"{eng.perf.summary()} | {model.device}]", file=sys.stderr)


def cmd_bench(args) -> None:
    from vlut_tpu_torch.bench.kernels import main as bench_main

    argv = ["-m", args.model_shape] if args.model_shape else []
    argv += ["-ns", args.ns, "--fmt", args.fmt]
    if args.device:
        argv += ["--device", args.device]
    bench_main(argv)


# subcommands whose flags are those of bench/e2e.py (handed over whole:
# argparse would take a leading ``--flag`` of a REMAINDER for its own)
_E2E = {"bench-sweep": "sweep", "batched-bench": "batched"}


def cmd_ppl(args) -> None:
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.eval import tasks
    from vlut_tpu_torch.eval.perplexity import logits_compare, perplexity
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    tok = Tokenizer(args.model)
    with open(args.file) as f:
        ids = np.asarray(tok.encode(f.read()), np.int32)
    if args.save_logits:
        tasks.save_logits(model, cfg, ids, args.save_logits,
                          window=args.window)
        print(f"saved base logits to {args.save_logits}")
        return
    if args.kl_base:
        print(json.dumps(tasks.kl_vs_saved(model, cfg, args.kl_base),
                         indent=2))
        return
    out = perplexity(model, cfg, ids, window=args.window)
    print(f"ppl = {out['ppl']:.4f} over {out['tokens']} tokens")
    if args.check_lossless:
        cmp = logits_compare(model, cfg, ids)
        print(f"quantized-vs-dequant: KL mean {cmp['kl_mean']:.3e}, "
              f"top1 {cmp['top1_agreement'] * 100:.2f}%")


def cmd_eval(args) -> None:
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.eval import tasks
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    fn = {"hellaswag": tasks.hellaswag_eval,
          "winogrande": tasks.winogrande_eval,
          "mc": tasks.multiple_choice_eval}[args.task]
    out = fn(model, cfg, Tokenizer(args.model), args.file, limit=args.limit)
    print(json.dumps(out, indent=2))


def cmd_quantize(args) -> None:
    from vlut_tpu_torch.convert.quantize import requantize

    cfg = requantize(args.src, args.dst, args.fmt)
    print(f"requantized -> {args.dst} ({cfg.weight_fmt})")


def cmd_inspect(args) -> None:
    """Checkpoint directory inspector (the gguf-hash / gguf_dump analog):
    metadata, config, and the tensor directory with shapes, dtypes, sizes
    and, with ``--hash``, a sha256 digest per tensor and of the model."""
    import hashlib
    import pathlib

    from vlut_tpu_torch.convert.checkpoint import safetensors_arrays

    path = pathlib.Path(args.ckpt)
    meta = json.loads((path / "vlut_config.json").read_text())
    print(json.dumps({k: v for k, v in meta.items() if k != "model_config"},
                     indent=2))
    print(json.dumps(meta["model_config"], indent=2))
    arrays = safetensors_arrays(path / "model.safetensors")
    print(f"{'tensor':44s} {'shape':>22s} {'dtype':>9s} {'MiB':>9s}"
          + ("  sha256[:12]" if args.hash else ""))
    total = 0
    full = hashlib.sha256()
    for name in sorted(arrays):
        t = arrays[name]
        total += t.nbytes
        line = (f"{name:44s} {str(t.shape):>22s} {str(t.dtype):>9s} "
                f"{t.nbytes / 2**20:9.2f}")
        if args.hash:
            h = hashlib.sha256(np.ascontiguousarray(t).tobytes())
            full.update(h.digest())
            line += f"  {h.hexdigest()[:12]}"
        print(line)
    print(f"{'TOTAL':44s} {'':>22s} {'':>9s} {total / 2**20:9.2f}")
    if args.hash:
        print(f"model digest: {full.hexdigest()}")


def _generate_parser(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", required=True)
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("-n", "--n-predict", type=int, default=128)
    p.add_argument("--ctx", type=int, default=4096)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--min-p", type=float, default=0.0)
    p.add_argument("--typical", type=float, default=1.0)
    p.add_argument("--dynatemp-range", type=float, default=0.0)
    p.add_argument("--dynatemp-exp", type=float, default=1.0)
    p.add_argument("--xtc-probability", type=float, default=0.0)
    p.add_argument("--xtc-threshold", type=float, default=0.1)
    p.add_argument("--top-nsigma", type=float, default=0.0)
    p.add_argument("--mirostat", type=int, default=0, choices=(0, 2),
                   help="0=off, 2=mirostat v2")
    p.add_argument("--mirostat-ent", type=float, default=5.0,
                   help="mirostat target entropy tau")
    p.add_argument("--mirostat-lr", type=float, default=0.1,
                   help="mirostat learning rate eta")
    p.add_argument("--repeat-penalty", type=float, default=1.0)
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--dry-multiplier", type=float, default=0.0)
    p.add_argument("--dry-base", type=float, default=1.75)
    p.add_argument("--dry-allowed-length", type=int, default=2)
    p.add_argument("-l", "--logit-bias", action="append", default=[],
                   metavar="TOKEN:BIAS")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-type", choices=("bf16", "q8"), default="bf16")
    p.add_argument("--head-type", choices=("bf16", "q8"), default="bf16",
                   help="output head precision (q8 halves head bandwidth)")
    p.add_argument("--decode-attn", choices=("fused", "composed"),
                   default="fused",
                   help="decode attention: one fused kernel per layer, or "
                   "a row write and PyTorch attention")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def main(argv: list[str] | None = None) -> None:
    from vlut_tpu_torch.serving.server import add_server_args, run_from_args

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _E2E:
        from vlut_tpu_torch.bench.e2e import main as e2e_main

        return e2e_main([_E2E[argv[0]]] + argv[1:])
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("generate", help="one request through the slot engine")
    _generate_parser(p)
    p.set_defaults(fn=cmd_generate)
    p = sub.add_parser("serve", help="the completion server")
    add_server_args(p)
    p.set_defaults(fn=run_from_args)
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

    p = sub.add_parser("bench", help="ternary GEMM microbenchmark")
    p.add_argument("-m", "--model-shape", default=None)
    p.add_argument("-ns", default="32,256")
    p.add_argument("--fmt", default="i2,i1")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench)
    sub.add_parser("bench-sweep", help="llama-bench analog (flags: "
                   "python -m vlut_tpu_torch.bench.e2e sweep -h)")
    sub.add_parser("batched-bench", help="batched-bench analog (flags: "
                   "python -m vlut_tpu_torch.bench.e2e batched -h)")

    p = sub.add_parser("ppl", help="perplexity (llama-perplexity analog)")
    p.add_argument("--model", required=True)
    p.add_argument("-f", "--file", required=True)
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--check-lossless", action="store_true")
    p.add_argument("--save-logits", default=None,
                   help="save fp16 base logits for later --kl-base runs")
    p.add_argument("--kl-base", default=None,
                   help="compare against logits saved via --save-logits")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_ppl)
    p = sub.add_parser("eval", help="accuracy tasks (perplexity.cpp analog)")
    p.add_argument("--model", required=True)
    p.add_argument("--task", choices=("hellaswag", "winogrande", "mc"),
                   required=True)
    p.add_argument("-f", "--file", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("quantize",
                       help="requantize a packed checkpoint (i2 <-> i1)")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--fmt", choices=("i2", "i1"), required=True)
    p.set_defaults(fn=cmd_quantize)
    p = sub.add_parser("inspect", help="checkpoint tensor directory + hash")
    p.add_argument("ckpt")
    p.add_argument("--hash", action="store_true")
    p.set_defaults(fn=cmd_inspect)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
