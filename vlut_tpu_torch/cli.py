"""Command-line entry point of the port.

  python -m vlut_tpu_torch.cli generate --model DIR -p PROMPT [-n N]
      [--ctx N] [--cache-type bf16|q8] [--head-type bf16|q8]
      [--decode-attn fused|composed] [sampler flags] [-l TOKEN:BIAS]
      [--seed S] [--grammar-file F | --json-schema JSON]
      [--draft-model DIR [--draft-k 4] | --prompt-lookup K | --lookahead
      [--lookahead-window 8] [--lookahead-ngram 3]]
      [--lora DIR [--lora-scale 1]] [--control-vector F
      [--control-vector-scale 1]] [--promote i2|i1]
      [--override KEY=VALUE ...] [--device cpu]
  python -m vlut_tpu_torch.cli serve --model [NAME=]DIR [--model NAME=DIR
      ...] [--port 8080] [--slots 8] [--ctx 4096] [--cache-type bf16|q8]
      [--decode-attn fused|composed] [--promote i2|i1]
      [--draft-model DIR [--draft-k 4] | --lookahead ...] [--device cpu]
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
  python -m vlut_tpu_torch.cli embed --model DIR [-p TEXT ...] [--task T]
      [--json] [--device cpu]
  python -m vlut_tpu_torch.cli describe --model DIR --image FILE
      [-p "PROMPT WITH <image>"] [-n N] [--device cpu]
  python -m vlut_tpu_torch.cli describe --model DIR --audio FILE.wav
      --audio-encoder DIR [-p "PROMPT WITH <audio>"] [-n N] [--device cpu]
  python -m vlut_tpu_torch.cli tts --model DIR --vocoder DIR -p TEXT
      [-o out.wav] [--speaker F.json] [--guide-tokens] [-n N] [--top-k 4]
      [--seed S] [--code-offset ID] [--override KEY=VALUE] [--device cpu]
  python -m vlut_tpu_torch.cli convert-audio HF_DIR OUT_DIR [--d-llm 4096]
      [--device cpu]
  python -m vlut_tpu_torch.cli convert-vocoder SRC OUT_DIR [--device cpu]
  python -m vlut_tpu_torch.cli convert HF_DIR OUT_DIR [--fmt i2|i1]
      [--device cpu]
  python -m vlut_tpu_torch.cli quantize SRC DST --fmt i2|i1
  python -m vlut_tpu_torch.cli inspect DIR [--hash]

``generate`` serves one request through the slot engine (with a draft
model, a grammar, a LoRA adapter or a control vector as asked), or with
``--prompt-lookup`` / ``--lookahead`` through the standalone greedy
speculative loops of ``runtime/speculative.py``; a Mamba checkpoint goes
through the engine too, a Mamba2 or RWKV checkpoint through its own
state-carrying loop and a hybrid one through a loop that recomputes the
whole sequence for each token (:func:`family_generate`, greedy or
``--temp`` sampling from a generator seeded by ``--seed``), a T5 one
through its encoder and a decoder loop, and a ``causal_attn=False`` one
(llada, dream, llada_moe) through the denoise loop on its float twin
(``--diffusion-steps``, ``--diffusion-alg``); ``embed`` pools an encoder
checkpoint's embeddings; ``describe`` encodes an image with the
checkpoint's vision tower (or, with ``--audio``, a WAV file with an
audio-encoder directory's whisper encoder and projector) and completes the
prompt around it greedily; ``tts`` is the OuteTTS pipeline (text -> audio
codes -> the WavTokenizer vocoder -> WAV, ``runtime/tts.py``);
``--override`` sets a model config field (retyped from the field; a field
the port does not implement raises) and ``--promote`` repacks the weights
at load (i2 <-> i1, exact).  ``serve`` starts the OpenAI-compatible server
(``serving/server.py``: completion, chat with tools, infill, embeddings,
rerank, template, web UI), one engine per ``--model``; ``batched`` is the
shared-prompt np-way fan-out (one prompt prefilled into np slots, then n
decode steps per slot).  ``bench`` is the kernel microbenchmark (i2/i1 through the tiled ternary kernel,
llama.cpp's TQ2_0/TQ1_0 through the TQ kernel); ``bench-sweep`` and
``batched-bench`` are the llama-bench and batched-bench analogs; ``ppl``
and ``eval`` the perplexity harness (with the quantized-vs-dequant KL
check) and the accuracy tasks.  Each of these runs on the GPU unless
``--device cpu`` is given.  ``convert`` turns an HF directory into a
packed checkpoint (``convert/convert.py``: the integer unpack and pack on
the GPU unless ``--device cpu``, every float decision on the host), or a
recurrent, hybrid, encoder, gemma3n or T5 one into its float checkpoint
(the family converters, on the host; the device rule is the same);
``convert-audio`` and ``convert-vocoder`` write the audio-encoder and
vocoder directories from HF checkpoints (host numpy, the same rule).
``quantize`` (exact i2 <-> i1 repack) and
``inspect`` (config and tensor directory, ``--hash`` for sha256 digests)
touch no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def run_batched(model, cfg, ids: list[int], np_parallel: int, n_predict: int,
                temp: float = 0.5, repeat_penalty: float = 1.5,
                seed: int = 0, decode_attn: str = "fused",
                cuda_graph: bool = True) -> torch.Tensor:
    """Prefill ``ids`` into ``np_parallel`` slots and generate ``n_predict``
    tokens per slot; returns (np, n_predict) token ids.  As in the JAX
    package, the argmax of the prefill logits seeds decoding and is not part
    of the returned rows.  ``cuda_graph=False`` decodes eagerly on the
    card."""
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
                           decode_attn=decode_attn, cuda_graph=cuda_graph)
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


def run_standalone_speculative(model, cfg, ids: list[int], n_predict: int,
                               ctx: int, prompt_lookup: int = 0,
                               window: int = 8, ngram: int = 3,
                               decode_attn: str = "fused"):
    """Greedy decoding of ``ids`` by prompt lookup (``prompt_lookup`` = k
    drafted tokens per round, 2-grams over a 512-token history) or, with
    ``prompt_lookup`` 0, by windowed lookahead (W ``window``, N ``ngram``);
    returns (n_predict tokens, per-round accepted counts)."""
    from vlut_tpu_torch.models.transformer import (
        forward,
        fuse_projections,
        init_kv_cache,
        unstack_layers,
    )
    from vlut_tpu_torch.runtime.speculative import (
        make_lookahead_fn,
        make_lookup_fn,
    )

    dev = model.device
    served = unstack_layers(fuse_projections(model, cfg), cfg)
    t = len(ids)
    cache = init_kv_cache(cfg, 1, min(ctx, cfg.max_seq_len), device=dev)
    with torch.inference_mode():
        lg, _ = forward(served, cfg, torch.tensor([ids], device=dev),
                        torch.arange(t, device=dev)[None], cache,
                        logits_at=torch.tensor([t - 1], device=dev),
                        decode_attn=decode_attn)
    last = torch.argmax(lg[:, 0, :cfg.vocab_size], dim=-1)
    lens = torch.tensor([t], device=dev)
    if prompt_lookup:
        hist = torch.zeros((1, 512), dtype=torch.long, device=dev)
        hist[0, :t] = torch.tensor(ids[-512:], device=dev)
        fn = make_lookup_fn(cfg, prompt_lookup, n_predict - 1, ngram=2,
                            decode_attn=decode_attn)
        out, _, accs, _ = fn(served, cache, hist, lens, last, lens)
    else:
        fn = make_lookahead_fn(cfg, n_predict - 1, window=window,
                               ngram=ngram, decode_attn=decode_attn)
        out, _, accs, _ = fn(served, cache, last, lens)
    toks = [int(last[0])] + out[0, :n_predict - 1].tolist()
    return toks, accs[:, 0].tolist()


def _categorical(logits: torch.Tensor, temp: float,
                 gen: torch.Generator) -> int:
    """A draw from softmax(logits / temp): the argmax of the scaled logits
    plus Gumbel noise (``jax.random.categorical``'s method; torch's Philox
    stands in for threefry, so the draws match in distribution only)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return int((logits / temp - torch.log(-torch.log(u))).argmax())


@torch.inference_mode()
def family_generate(model, cfg, ids: list[int], n_predict: int,
                    temp: float = 0.0, seed: int = 0,
                    eos_id: int | None = None) -> list[int]:
    """The JAX CLI's ``generate`` loops of the families the engine does not
    serve: Mamba2 and RWKV carry their state (one prefill, then one-token
    steps), a hybrid recomputes the whole sequence for each token.  Greedy
    at ``temp`` 0, else sampled; stops after ``eos_id``."""
    from vlut_tpu_torch.models import hybrid, rwkv, ssm

    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = cfg.vocab_size

    def pick(logits) -> int:
        return (_categorical(logits, temp, gen) if temp > 0
                else int(logits.argmax()))

    out: list[int] = []
    if isinstance(cfg, hybrid.HybridConfig):
        for _ in range(n_predict):
            toks = torch.tensor([ids + out], device=dev)
            out.append(pick(hybrid.forward(model, cfg, toks)[0, -1, :v]))
            if out[-1] == eos_id:
                break
        return out
    if isinstance(cfg, ssm.Mamba2Config):
        def fwd(toks, st):
            return ssm.forward2(model, cfg, toks, st, logits_last_only=True,
                                inplace=True)
        st = ssm.init_state2(cfg, 1, dev)
    elif isinstance(cfg, (rwkv.Rwkv7Config, rwkv.Rwkv6Config)):
        f = (rwkv.forward6 if isinstance(cfg, rwkv.Rwkv6Config)
             else rwkv.forward)

        def fwd(toks, st):
            return f(model, cfg, toks, st)
        st = rwkv.init_state(cfg, 1, dev)
    else:
        raise ValueError(f"no generate loop for {type(cfg).__name__}")
    lg, st = fwd(torch.tensor([ids], device=dev), st)
    for _ in range(n_predict):
        out.append(pick(lg[0, -1, :v]))
        if out[-1] == eos_id or len(out) == n_predict:
            break
        lg, st = fwd(torch.tensor([[out[-1]]], device=dev), st)
    return out


def override_config(cfg, overrides: list[str]):
    """``cfg`` with each ``KEY=VALUE`` set, the value retyped from the
    field's current value (bool, int, float; else the string)."""
    for spec in overrides:
        key, _, val = spec.partition("=")
        if not hasattr(cfg, key):
            raise SystemExit(f"--override: no config field {key!r}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            val = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(val)
        elif isinstance(cur, float):
            val = float(val)
        cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def t5_generate_cli(args, cfg, model) -> None:
    """``generate`` on a T5 checkpoint (the JAX CLI's encoder-decoder
    branch): the prompt's ids without BOS, then eos, through the encoder;
    the decoder recomputed each step (``models/t5.py:generate``)."""
    from vlut_tpu_torch.models import t5
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(args.model)
    ids = tok.encode(args.prompt, add_bos=False)
    if cfg.eos_id is not None:
        ids = ids + [cfg.eos_id]
    t0 = time.time()
    out = t5.generate(model, cfg, ids, n_new=args.n_predict, temp=args.temp,
                      seed=args.seed)
    dt = time.time() - t0
    print(tok.decode(out))
    print(f"\n[{len(out)} tokens, {len(out) / max(dt, 1e-9):.1f} tok/s]")


def diffusion_generate_cli(args, cfg, model) -> None:
    """``generate`` on a ``causal_attn=False`` checkpoint (the JAX CLI's
    diffusion branch): the float twin of the packed tree, denoised by
    ``runtime/diffusion.py`` in ``--diffusion-steps`` steps (0: one per new
    token) ranked by ``--diffusion-alg``."""
    from vlut_tpu_torch.runtime.diffusion import (DiffusionParams,
                                                  diffusion_generate)
    from vlut_tpu_torch.train.finetune import float_twin_params
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(args.model)
    ids = tok.encode(args.prompt)
    twin = float_twin_params(model, cfg)
    dp = DiffusionParams(steps=args.diffusion_steps or args.n_predict,
                         alg=args.diffusion_alg, temp=args.temp,
                         seed=args.seed)
    t0 = time.time()
    out = diffusion_generate(twin, cfg, ids, args.n_predict, dp)
    dt = time.time() - t0
    print(tok.decode(out))
    print(f"\n[{len(out)} tokens (diffusion, {dp.steps} steps), "
          f"{len(out) / max(dt, 1e-9):.1f} tok/s]")


def cmd_embed(args) -> None:
    """Pooled embeddings of an encoder checkpoint (the JAX CLI's
    ``embed``): each prompt (cut to ``max_seq_len``) through the
    bidirectional forward and the checkpoint's pooling, ``--task`` a
    jina-v3 adapter; with ``--json`` one JSON object, else the first eight
    values of each and, for several, their cosine matrix.  Decoder
    embeddings are the server's ``/embedding``."""
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models.encoder import embed
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, meta = load_checkpoint(args.model, device=args.device)
    if meta.get("model_family") != "encoder":
        raise SystemExit(
            "embed: not an encoder-family checkpoint (decoder embeddings "
            "are served by `vlut-tpu serve` /embedding)")
    tok = Tokenizer(args.model)
    texts = args.prompt or ["Hello world"]
    outs = []
    for text in texts:
        ids = tok.encode(text)[:cfg.max_seq_len]
        toks = torch.tensor([ids], device=model.device)
        e = embed(model, cfg, toks, torch.ones_like(toks), task=args.task)
        outs.append(e[0].to(torch.float32).cpu().numpy())
    if args.json:
        print(json.dumps({"model": str(args.model),
                          "embeddings": [e.tolist() for e in outs]}))
        return
    for text, e in zip(texts, outs):
        head = " ".join(f"{v:+.4f}" for v in e[:8])
        print(f"{head} ...  dim={len(e)}  |  {text[:60]}")
    if len(outs) > 1:
        norms = [max(float(np.linalg.norm(e)), 1e-12) for e in outs]
        print("cosine matrix:")
        for a, na in zip(outs, norms):
            print("  " + " ".join(f"{float(a @ b) / (na * nb):.3f}"
                                  for b, nb in zip(outs, norms)))


def cmd_generate(args) -> None:
    """One request through the slot engine (the JAX package's engine branch
    of ``vlut-tpu generate``), or through a standalone prompt-lookup or
    lookahead loop."""
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.convert.quantize import promote
    from vlut_tpu_torch.models.ssm import MambaConfig
    from vlut_tpu_torch.models.t5 import T5Config
    from vlut_tpu_torch.models.transformer import TransformerLM
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime import lora
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    if isinstance(cfg, T5Config):
        return t5_generate_cli(args, cfg, model)
    if isinstance(cfg, ModelConfig) and args.override:
        cfg = override_config(cfg, args.override)
        model = TransformerLM(cfg, model.tree())
    if isinstance(cfg, ModelConfig) and not cfg.causal_attn:
        return diffusion_generate_cli(args, cfg, model)
    if not isinstance(cfg, ModelConfig):
        if args.lora or args.control_vector or args.promote or args.override:
            raise SystemExit("--lora, --control-vector, --promote and "
                             "--override apply to transformer checkpoints")
        if not isinstance(cfg, MambaConfig):
            tok = Tokenizer(args.model)
            t0 = time.time()
            out = family_generate(model, cfg, tok.encode(args.prompt),
                                  args.n_predict, args.temp, args.seed,
                                  tok.eos_id)
            dt = time.time() - t0
            print(tok.decode(out))
            print(f"\n[{len(out)} tokens, {len(out) / max(dt, 1e-9):.1f} "
                  f"tok/s | {type(cfg).__name__} | {model.device}]",
                  file=sys.stderr)
            return
    if args.promote:
        cfg, model = promote(cfg, model, args.promote)
    if args.lora:
        model = lora.apply_lora(model, lora.load_peft_adapter(args.lora, cfg),
                                scale=args.lora_scale)
    if args.control_vector:
        model = lora.apply_cvector(
            model, lora.load_cvector_file(args.control_vector, cfg),
            scale=args.control_vector_scale)
    tok = Tokenizer(args.model)
    if args.prompt_lookup or args.lookahead:
        t0 = time.time()
        toks, accs = run_standalone_speculative(
            model, cfg, tok.encode(args.prompt), args.n_predict, args.ctx,
            args.prompt_lookup, args.lookahead_window, args.lookahead_ngram,
            args.decode_attn)
        dt = time.time() - t0
        mode = (f"prompt-lookup k={args.prompt_lookup}" if args.prompt_lookup
                else f"lookahead W={args.lookahead_window} "
                f"N={args.lookahead_ngram}")
        print(tok.decode(toks))
        print(f"\n[{len(toks)} tokens, {len(toks) / dt:.1f} tok/s | {mode}, "
              f"{sum(accs)} drafts accepted | {model.device}]",
              file=sys.stderr)
        return
    draft = None
    if args.draft_model:
        d_cfg, d_model, _ = load_checkpoint(args.draft_model,
                                            device=args.device)
        draft = (d_cfg, d_model)
    eng = Engine(cfg, model, n_slots=1, max_len=args.ctx,
                 kv_quant=args.cache_type == "q8",
                 head_quant=args.head_type == "q8",
                 decode_attn=args.decode_attn, draft=draft,
                 k_draft=args.draft_k)
    stop = (tok.eos_id,) if tok.eos_id is not None else ()
    grammar = None
    if args.grammar_file:
        with open(args.grammar_file) as f:
            grammar = tok.make_grammar(f.read())
    elif args.json_schema:
        from vlut_tpu_torch.runtime.grammar import json_schema_to_gbnf

        grammar = tok.make_grammar(
            json_schema_to_gbnf(json.loads(args.json_schema)))
    req = Request(prompt=tok.encode(args.prompt),
                  max_new_tokens=args.n_predict,
                  sampler=sampler_from_args(args), stop_tokens=stop,
                  grammar=grammar)
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


def describe(model, cfg, tok, image_embeds: torch.Tensor, prompt: str,
             n_predict: int, deepstack=None, decode_attn: str = "fused",
             cuda_graph: bool = True, marker: str = "<image>") -> list[int]:
    """Greedy tokens of an image (or audio) + prompt (the JAX package's
    ``vlut-tpu describe``): the prompt split on ``marker`` (``<image>``, or
    ``<audio>`` for audio rows), the media's projected rows spliced between
    the halves' text embeddings, one prefill through
    ``forward(token_embeds=, logits_at=)`` (qwen3vl's DeepStack features
    scattered over the image span as ``deepstack_embeds``), then greedy
    decode steps to ``n_predict`` tokens, cut after the first end of
    sequence.  The steps are ``runtime/generate.py``'s step program: one
    CUDA graph replayed on the card (``cuda_graph=False``: eager), eager
    on the CPU."""
    from vlut_tpu_torch.models.transformer import forward, init_kv_cache
    from vlut_tpu_torch.models.vision import build_multimodal_embeds
    from vlut_tpu_torch.runtime.generate import make_generate_fn
    from vlut_tpu_torch.runtime.sampling import (SamplerParams, features_of,
                                                 stack_params)

    pre_txt, _, post_txt = prompt.partition(marker)
    prefix = tok.encode(pre_txt) if pre_txt else tok.encode("")
    suffix = tok.encode(post_txt, add_bos=False) if post_txt else []
    embeds = build_multimodal_embeds(model, image_embeds, prefix, suffix)
    t = embeds.shape[0]
    dev = model.device
    cache = init_kv_cache(cfg, 1, max_len=t + n_predict + 8, device=dev)
    planes = None
    if deepstack is not None:
        off, n_img = len(prefix), image_embeds.shape[0]
        planes = []
        for d in deepstack:
            plane = torch.zeros((1, t, embeds.shape[-1]), dtype=torch.float32,
                                device=dev)
            plane[0, off:off + n_img] = d.to(dev, torch.float32)
            planes.append(plane)
        planes = tuple(planes)
    v = cfg.vocab_size
    with torch.inference_mode():
        logits, cache = forward(
            model, cfg, torch.zeros((1, t), dtype=torch.long, device=dev),
            torch.arange(t, device=dev)[None], cache,
            token_embeds=embeds[None],
            logits_at=torch.tensor([t - 1], device=dev),
            deepstack_embeds=planes, decode_attn=decode_attn)
    first = logits[0, 0, :v].argmax()[None]
    out = [int(first)]
    if n_predict > 1:
        greedy = [SamplerParams(temperature=0.0)]
        gen = make_generate_fn(cfg, n_steps=n_predict - 1,
                               features=features_of(greedy),
                               decode_attn=decode_attn,
                               cuda_graph=cuda_graph)
        steps, _ = gen(model, cache, first,
                       torch.tensor([t], device=dev),
                       stack_params(greedy, device=dev))
        out += steps[0].tolist()
    if tok.eos_id is not None and tok.eos_id in out[1:]:
        out = out[:out.index(tok.eos_id, 1) + 1]
    return out


def encode_audio_file(encoder_dir, wav, device=None) -> torch.Tensor:
    """A WAV file's decoder embeddings (the JAX ``describe``'s audio
    branch): the encoder directory's config and weights on ``device``, the
    WAV read and resampled, the host log-mel, the encoder and projector."""
    from vlut_tpu_torch.models import audio

    acfg, aparams = audio.load_audio_encoder(encoder_dir, device=device)
    mel = audio.log_mel(audio.load_wav(wav, acfg), acfg)
    with torch.inference_mode():
        return audio.encode(aparams, acfg, torch.from_numpy(mel).to(
            aparams["conv1_w"].device))


def cmd_describe(args) -> None:
    """Image or audio + prompt completion (the JAX package's ``describe``):
    the checkpoint's vision tower (whichever family it carries) encodes
    the image, or ``--audio-encoder``'s encoder the ``--audio`` WAV
    (:func:`encode_audio_file`; the prompt's marker is then ``<audio>``);
    :func:`describe` splices and decodes greedily, on the fused tree."""
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models.transformer import fuse_projections
    from vlut_tpu_torch.models.vision import encode_image_auto
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    if not (args.image or args.audio):
        raise SystemExit("describe needs --image or --audio")
    if args.audio and not args.audio_encoder:
        raise SystemExit("describe --audio needs --audio-encoder (a "
                         "convert-audio output)")
    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    tok = Tokenizer(args.model)
    deepstack = None
    if args.audio:
        embeds = encode_audio_file(args.audio_encoder, args.audio,
                                   device=args.device)
        marker = "<audio>"
    else:
        embeds, family = encode_image_auto(args.model, args.image,
                                           device=args.device)
        if embeds is None:
            raise SystemExit("checkpoint has no vision tower (convert a "
                             "multimodal model)")
        if isinstance(family, tuple):  # qwen3vl: (name, deepstack features)
            family, deepstack = family
        print(f"[vision tower: {family}]", file=sys.stderr)
        marker = "<image>"
    model = fuse_projections(model, cfg)
    t0 = time.time()
    out = describe(model, cfg, tok, embeds, args.prompt, args.n_predict,
                   deepstack=deepstack, marker=marker)
    dt = time.time() - t0
    print(tok.decode(out))
    print(f"\n[{len(out)} tokens, {len(out) / max(dt, 1e-9):.1f} tok/s | "
          f"{embeds.shape[0]} media tokens | {model.device}]",
          file=sys.stderr)


def cmd_tts(args) -> None:
    """The OuteTTS pipeline (the JAX package's ``tts``): the text-to-codes
    checkpoint and the vocoder on the device, :func:`runtime.tts.synthesize`,
    a 16-bit WAV."""
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models.transformer import TransformerLM
    from vlut_tpu_torch.models.vocoder import load_vocoder
    from vlut_tpu_torch.runtime.tts import save_wav, synthesize
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    if args.override:
        cfg = override_config(cfg, args.override)
        model = TransformerLM(cfg, model.tree())
    tok = Tokenizer(args.model)
    voc_cfg, voc_params = load_vocoder(args.vocoder, device=args.device)
    speaker = None
    if args.speaker:
        with open(args.speaker) as f:
            speaker = json.load(f)
    t0 = time.time()
    audio = synthesize(
        cfg, model, tok, args.prompt, voc_cfg, voc_params,
        speaker=speaker, use_guide_tokens=args.guide_tokens,
        n_predict=args.n_predict, top_k=args.top_k, seed=args.seed,
        code_offset=args.code_offset)
    save_wav(args.output, audio, voc_cfg.sample_rate)
    dur = audio.shape[0] / voc_cfg.sample_rate
    print(f"wrote {args.output}: {dur:.2f}s audio in {time.time() - t0:.1f}s "
          f"on {model.device}")


def cmd_convert_audio(args) -> None:
    from vlut_tpu_torch.models.audio import convert_hf_audio

    cfg = convert_hf_audio(args.src, args.dst, d_llm=args.d_llm,
                           device=args.device)
    print(f"audio encoder -> {args.dst}: {cfg}")


def cmd_convert_vocoder(args) -> None:
    from vlut_tpu_torch.models.vocoder import convert_hf_vocoder

    cfg = convert_hf_vocoder(args.src, args.dst, device=args.device)
    print(f"vocoder -> {args.dst}: {cfg}")


def cmd_convert(args) -> None:
    from vlut_tpu_torch.convert.convert import convert_hf

    cfg = convert_hf(args.hf_dir, args.out_dir, fmt=args.fmt,
                     device=args.device)
    print(f"converted: {cfg}")


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
    p.add_argument("--grammar-file", default=None,
                   help="GBNF grammar constraining generation")
    p.add_argument("--json-schema", default=None,
                   help="JSON schema constraining generation (via GBNF)")
    p.add_argument("--draft-model", default=None,
                   help="draft checkpoint for speculative decoding")
    p.add_argument("--draft-k", type=int, default=4)
    p.add_argument("--prompt-lookup", type=int, default=0, metavar="K",
                   help="prompt-lookup (n-gram) speculative decoding with K "
                   "drafted tokens per round (greedy)")
    p.add_argument("--lookahead", action="store_true",
                   help="draft-free windowed lookahead decoding (greedy)")
    p.add_argument("--lookahead-window", type=int, default=8,
                   help="Jacobi window branches (lookahead W)")
    p.add_argument("--lookahead-ngram", type=int, default=3,
                   help="n-gram length (lookahead N)")
    p.add_argument("--lora", default=None,
                   help="HF PEFT LoRA adapter directory")
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--control-vector", default=None,
                   help="control-vector file (.safetensors/.npz)")
    p.add_argument("--control-vector-scale", type=float, default=1.0)
    p.add_argument("--promote", choices=("i2", "i1"), default=None,
                   help="repack the weights to this format at load")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override a model config field (repeatable)")
    p.add_argument("--diffusion-steps", type=int, default=0,
                   help="denoise iterations for diffusion checkpoints "
                   "(0 = n_predict)")
    p.add_argument("--diffusion-alg", default="low_confidence",
                   choices=("low_confidence", "entropy", "margin", "random"),
                   help="unmask-ranking rule of a diffusion checkpoint")
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

    p = sub.add_parser("convert", help="HF directory -> packed checkpoint")
    p.add_argument("hf_dir")
    p.add_argument("out_dir")
    p.add_argument("--fmt", choices=("i2", "i1"), default="i2")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_convert)
    p = sub.add_parser("quantize",
                       help="requantize a packed checkpoint (i2 <-> i1)")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--fmt", choices=("i2", "i1"), required=True)
    p.set_defaults(fn=cmd_quantize)
    p = sub.add_parser("embed", help="pooled embeddings of an encoder "
                       "checkpoint")
    p.add_argument("--model", required=True)
    p.add_argument("-p", "--prompt", action="append")
    p.add_argument("--task", default=None,
                   help="jina-v3 task adapter (retrieval/classification/...)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_embed)
    p = sub.add_parser("describe",
                       help="image|audio + prompt (mtmd-cli analog)")
    p.add_argument("--model", required=True)
    p.add_argument("--image")
    p.add_argument("--audio", help="WAV file (whisper-encoder path)")
    p.add_argument("--audio-encoder",
                   help="audio-encoder dir (convert-audio output)")
    p.add_argument("-p", "--prompt", default="<image>Describe this image.")
    p.add_argument("-n", "--n-predict", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_describe)
    p = sub.add_parser("convert-audio",
                       help="HF whisper/ultravox audio tower -> encoder dir")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--d-llm", type=int, default=4096)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_convert_audio)
    p = sub.add_parser("tts", help="text-to-speech (tools/tts analog)")
    p.add_argument("--model", required=True, help="text-to-codes checkpoint")
    p.add_argument("--vocoder", required=True,
                   help="vocoder dir (convert-vocoder output)")
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("--speaker", help="speaker profile JSON (OuteTTS format)")
    p.add_argument("--guide-tokens", action="store_true",
                   help="force word-initial tokens after newlines")
    p.add_argument("-n", "--n-predict", type=int, default=4096)
    p.add_argument("--top-k", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--code-offset", type=int, default=None,
                   help="first audio-code token id (default: detect <|0|>)")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_tts)
    p = sub.add_parser("convert-vocoder",
                       help="HF WavTokenizer decoder -> vocoder dir")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_convert_vocoder)
    p = sub.add_parser("inspect", help="checkpoint tensor directory + hash")
    p.add_argument("ckpt")
    p.add_argument("--hash", action="store_true")
    p.set_defaults(fn=cmd_inspect)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
