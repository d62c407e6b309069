"""Slot-engine workload at the flagship shapes (the serving path of the port).

A packed i2 ternary Llama at ``llama3_8b_158`` shapes with seeded random
weights generated on the device (int8 head, fused and unrolled layer tree)
behind an ``Engine`` with 32 slots and a 2048-row context.  48 greedy
requests with prompts of 64-1500 random tokens (so the queue exceeds the
slots and prompts past 1024 tokens are prefilled in chunks) each generate
24 tokens.  Prefill and decode rates come from the engine's counters (host
clock around work that ends in a device sync).

    python -m vlut_tpu_torch.bench.engine [--cache-type bf16|q8]
        [--decode-attn fused|composed] [--layers L] [--device cpu]
        [--profile-steps N]

prints one JSON line; with ``--profile-steps`` it also breaks N decode
steps (taken while all 32 slots decode and none is admitted) down by
kernel under ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vlut_tpu_torch.bench.flagship import build_model, profile_decode
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models import transformer
from vlut_tpu_torch.models.transformer import forward
from vlut_tpu_torch.ops import decode_attention as dattn
from vlut_tpu_torch.ops import ternary_gemm as tg
from vlut_tpu_torch.ops.kv_update import write_rows_pair
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

N_SLOTS, CTX = 32, 2048
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 48, 64, 1500, 24


def make_requests(vocab: int, n: int = N_REQUESTS, lo: int = PROMPT_LO,
                  hi: int = PROMPT_HI, new_tokens: int = NEW_TOKENS,
                  seed: int = 0) -> list[Request]:
    """n greedy requests with prompt lengths spread over [lo, hi] (the
    first at hi, so one prompt is always chunked when hi > 1024)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    lens[0] = hi
    return [Request(prompt=[int(t) for t in rng.integers(3, vocab, int(k))],
                    max_new_tokens=new_tokens,
                    sampler=SamplerParams(temperature=0.0))
            for k in lens]


def compare_attention_paths(eng: Engine) -> dict:
    """The next decode step's logits through the fused and the composed
    attention on the engine's current cache (each writes the same rows),
    compared: the largest difference over the largest logit, and the share
    of slots whose greedy token agrees.  Beside it, the same comparison of
    the composed path with itself after a relative 1e-6 of noise on every
    layer's attention output: how far float rounding alone moves these
    logits (the int8 activation codes of 32 layers amplify it)."""
    dev = eng.device
    tokens = torch.zeros((eng.n_slots, 1), dtype=torch.long)
    lengths = torch.full((eng.n_slots, 1), eng.max_len - 1, dtype=torch.long)
    for i, s in enumerate(eng.slots):
        if s.req is not None:
            tokens[i, 0] = s.req.output[-1]
            lengths[i, 0] = s.length + s.generated - 1
    v = eng.cfg.vocab_size

    def logits(mode):
        return forward(eng.params, eng.cfg, tokens.to(dev), lengths.to(dev),
                       eng.cache, decode_attn=mode)[0][:, 0, :v].clone()

    def compare(a, b):
        return {"max_rel_logit_diff": float((a - b).abs().max()
                                            / b.abs().max()),
                "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                      .float().mean())}

    # a comparison, not the serving path: its kernel launches are not counted
    wrappers = (dattn.decode_attention, dattn.decode_attention_int8,
                write_rows_pair, tg.ternary_gemm_decode,
                tg.ternary_gemm_fused_quant, tg.ternary_gemm_tiled)
    counts = [w.launches for w in wrappers]
    f, c = logits("fused"), logits("composed")
    gen = torch.Generator(device=dev).manual_seed(0)
    attention = transformer._attention
    transformer._attention = lambda *a, **k: (lambda o: o * (
        1 + 1e-6 * torch.randn(o.shape, generator=gen, device=o.device)))(
            attention(*a, **k))
    try:
        noisy = logits("composed")
    finally:
        transformer._attention = attention
        for w, n in zip(wrappers, counts):
            w.launches = n
    return {**compare(f, c), "noise_floor": compare(noisy, c)}


@torch.inference_mode()
def run(preset: str = "llama3_8b_158", device=None, n_layers: int | None = None,
        kv_quant: bool = False, decode_attn: str = "fused",
        n_slots: int = N_SLOTS, ctx: int = CTX, requests=None, built=None,
        profile_steps: int = 0, check_paths: bool = False,
        seed: int = 0) -> dict:
    """Run the workload once on a fresh engine; ``built`` is a (cfg, model)
    pair from :func:`build_model` to reuse.  Returns the counters, the
    generated tokens and, with ``profile_steps``, a decode breakdown; with
    ``check_paths``, :func:`compare_attention_paths` once every slot
    decodes."""
    dev = resolve_device(device)
    cfg, model = built or build_model(preset, dev, n_layers, seed)
    eng = Engine(cfg, model, n_slots=n_slots, max_len=ctx, kv_quant=kv_quant,
                 decode_attn=decode_attn)
    reqs = requests if requests is not None else make_requests(cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    prof = paths = None
    t0 = time.perf_counter()
    steps = 0
    while True:
        if (check_paths and paths is None and steps >= 3
                and all(s.req is not None for s in eng.slots)):
            paths = compare_attention_paths(eng)
        # a window of pure decode: every slot busy and none finishing
        if (profile_steps and prof is None and dev.type == "cuda"
                and steps >= 3 and all(
                    s.req is not None and s.req.max_new_tokens
                    - len(s.req.output) > profile_steps for s in eng.slots)):
            prof = profile_decode(
                lambda: [eng.step() for _ in range(profile_steps)],
                profile_steps)
            steps += profile_steps
        if not eng.step():
            break
        steps += 1
    wall_s = time.perf_counter() - t0
    p = eng.perf
    bad = [r for r in reqs if not r.done or r.error
           or len(r.output) != r.max_new_tokens
           or not all(0 <= t < cfg.vocab_size for t in r.output)]
    if bad:
        raise RuntimeError(f"{len(bad)} requests did not finish cleanly")
    return {
        "preset": preset, "n_layers": cfg.n_layers,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "cache": "q8" if kv_quant else "bf16", "decode_attn": decode_attn,
        "slots": n_slots, "ctx": ctx, "requests": len(reqs),
        "prompt_tokens": p.n_prompt_tokens, "prompt_s": p.t_prompt_s,
        "prompt_tok_per_s": p.n_prompt_tokens / p.t_prompt_s,
        "decode_tokens": p.n_decode_tokens, "decode_steps": p.n_decode_steps,
        "decode_s": p.t_decode_s,
        "decode_tok_per_s": p.n_decode_tokens / p.t_decode_s,
        "decode_ms_per_step": p.t_decode_s / p.n_decode_steps * 1e3,
        "wall_s": wall_s,
        "outputs": [r.output for r in reqs],
        **({"profile": prof} if prof is not None else {}),
        **({"attention_paths": paths} if paths is not None else {}),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.engine")
    ap.add_argument("--preset", default="llama3_8b_158")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--cache-type", choices=("bf16", "q8"), default="bf16")
    ap.add_argument("--decode-attn", choices=("fused", "composed"),
                    default="fused")
    ap.add_argument("--profile-steps", type=int, default=0)
    args = ap.parse_args(argv)
    out = run(args.preset, args.device, args.layers,
              kv_quant=args.cache_type == "q8", decode_attn=args.decode_attn,
              profile_steps=args.profile_steps)
    out.pop("outputs")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
