"""Slot-engine workload at the flagship shapes (the serving path of the port).

A packed i2 ternary Llama at ``llama3_8b_158`` shapes (or another preset,
``--model``: the zoo's ``qwen3_4b`` and ``gemma2_2b``, the MoE
``mixtral_8x7b``, the MLA ``deepseek_v2_lite``, the recurrent
``mamba_2_8b``: Mamba-2.8B's widths, whose slots hold conv/ssm state)
with seeded random weights generated on the device (int8 head, fused and
unrolled layer tree; a Mamba's tree as ``models/ssm.py`` makes it)
behind an ``Engine`` with 32 slots and a 2048-row context.  48 greedy
requests with prompts of 64-1500 random tokens (so the queue exceeds the
slots and prompts past 1024 tokens are prefilled in chunks) each generate
24 tokens.  Prefill and decode rates come from the engine's counters (host
clock around work that ends in a device sync).  On the card the decode
step is a CUDA graph (captured at its second step; the capture's time is
counted apart, ``capture_s``, and each step program's capture time, graph
memory and replays are listed).

    python -m vlut_tpu_torch.bench.engine [--model PRESET]
        [--cache-type bf16|q8] [--decode-attn fused|composed] [--layers L]
        [--slots 32] [--ctx 2048] [--device cpu] [--ab] [--profile-steps N]

prints one JSON line; with ``--profile-steps`` it also breaks N decode
steps (taken while all slots decode and none is admitted) down by kernel
under ``torch.profiler``; those steps stay out of the step times.
``--ab`` runs the graphed and the eager step in turns on one model (graph,
eager, eager, graph; with ``--profile-steps``, one profiled run of each
after them), a line per run, and fails unless every run gave the same
tokens.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vlut_tpu_torch.bench.flagship import build_model, profile_decode
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models import transformer
from vlut_tpu_torch.models.transformer import forward
from vlut_tpu_torch.ops import _build
from vlut_tpu_torch.ops import decode_attention as dattn
from vlut_tpu_torch.ops import ternary_gemm as tg
from vlut_tpu_torch.ops.kv_update import write_rows_pair
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

N_SLOTS, CTX = 32, 2048
# the counters of decode-step time that a profiled window leaves unchanged
_STEP_TIMES = ("t_decode_s", "n_decode_steps", "n_decode_tokens",
               "t_replay_s", "n_replays")
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 48, 64, 1500, 24


def _rope_len(preset: str, ctx: int) -> int | None:
    """The rope tables' length an engine of ``ctx`` rows needs past the
    preset's own ``max_seq_len`` (None: the preset's)."""
    if preset not in PRESETS:  # a recurrent preset has no rope tables
        return None
    return ctx if ctx > PRESETS[preset].max_seq_len else None


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
    """:func:`compare_paths` at the engine's next decode step: each busy
    slot's last token at its position, an idle slot's scratch row."""
    tokens = torch.zeros((eng.n_slots, 1), dtype=torch.long)
    lengths = torch.full((eng.n_slots, 1), eng.max_len - 1, dtype=torch.long)
    for i, s in enumerate(eng.slots):
        if s.req is not None:
            tokens[i, 0] = s.req.output[-1]
            lengths[i, 0] = s.length + s.generated - 1
    return compare_paths(eng.params, eng.cfg, tokens.to(eng.device),
                         lengths.to(eng.device), eng.cache)


# The bound of :func:`paths_ok`, as a multiple of the layers' noise floor
# (:func:`compare_paths`).  The kernel's float32 sums differ from the
# composed ones by a relative 1e-7 to 1e-6 (its outputs are held to 2e-5
# of the plain version's), the size of the floor's noise; what reaches a
# layer's output is the int8 activation codes that round the other way,
# each moving it by more than the rounding did.  So the kernel's
# difference is held to 8 x the largest floor: room for its codes landing
# on larger activations than the noise's did, far below what a wrong
# attention (a dropped head or group, a misplaced value column) gives.
PATHS_X = 8.0


def compare_paths(params, cfg, tokens: torch.Tensor, positions: torch.Tensor,
                  cache, draws: int = 8) -> dict:
    """A decode step (tokens and positions (B, 1) on the cache's device)
    through the fused and the composed attention on the same cache (each
    writes the same rows), compared two ways: the logits (the largest
    difference over the largest logit, and the share of slots whose greedy
    token agrees), and layer by layer (``bench/zoo.py:layers_replaced``:
    each fused layer from the composed step's input; the largest over the
    layers of its output's largest difference over its largest value).
    Beside them, the noise floor: the composed step against itself after a
    relative 1e-6 of noise on every layer's attention output, the largest
    of ``draws`` draws.  Float rounding moves a step by the int8 activation
    codes it flips, each by far more than the rounding did, and a random
    model carries a flip through every later layer: the logits' floor is
    of their own scale, so they are printed, not held.  A layer from the
    composed input carries a flip through itself only; :func:`paths_ok`
    holds the layers.  None of these forwards counts a launch."""
    from vlut_tpu_torch.bench.zoo import layers_replaced

    dev = tokens.device
    v = cfg.vocab_size

    def step(mode, by=None):
        seen: list = []
        with layers_replaced(seen, by):
            lg = forward(params, cfg, tokens, positions, cache,
                         decode_attn=mode)[0][:, 0, :v].float().clone()
        return lg, seen

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def compare(a, b, layers):
        return {"max_rel_logit_diff": rel(a, b),
                "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                      .float().mean()),
                "max_rel_layer_diff": max(rel(x, y)
                                          for x, y in zip(layers, c_layers))}

    # a comparison, not the serving path: its kernel launches are not counted
    wrappers = (dattn.decode_attention, dattn.decode_attention_int8,
                write_rows_pair, tg.ternary_gemm_decode,
                tg.ternary_gemm_fused_quant, tg.ternary_gemm_tiled)
    counts = [w.launches for w in wrappers]
    c, c_layers = step("composed")
    f = step("fused")[0]
    got = compare(f, c, step("fused", c_layers)[1])
    gen = torch.Generator(device=dev).manual_seed(0)
    attention = transformer._attention
    transformer._attention = lambda *a, **k: (lambda o: o * (
        1 + 1e-6 * torch.randn(o.shape, generator=gen, device=o.device)))(
            attention(*a, **k))
    try:
        floors = [compare(step("composed")[0], c,
                          step("composed", c_layers)[1])
                  for _ in range(draws)]
    finally:
        transformer._attention = attention
        for w, n in zip(wrappers, counts):
            w.launches = n
    return {**got, "noise_floor": {
        "max_rel_logit_diff": max(x["max_rel_logit_diff"] for x in floors),
        "argmax_agree": min(x["argmax_agree"] for x in floors),
        "max_rel_layer_diff": max(x["max_rel_layer_diff"] for x in floors),
        "layer_draws": [x["max_rel_layer_diff"] for x in floors]}}


def paths_ok(paths: dict) -> bool:
    """Whether :func:`compare_paths`' fused layers lie within
    :data:`PATHS_X` of the layers' noise floor."""
    return (paths["max_rel_layer_diff"]
            <= PATHS_X * paths["noise_floor"]["max_rel_layer_diff"])


@torch.inference_mode()
def run(preset: str = "llama3_8b_158", device=None, n_layers: int | None = None,
        kv_quant: bool = False, decode_attn: str = "fused",
        n_slots: int = N_SLOTS, ctx: int = CTX, requests=None, built=None,
        profile_steps: int = 0, check_paths: bool = False,
        seed: int = 0, cuda_graph: bool = True) -> dict:
    """Run the workload once on a fresh engine; ``built`` is a (cfg, model)
    pair from :func:`build_model` to reuse.  Returns the counters, the
    generated tokens and, with ``profile_steps``, a decode breakdown; with
    ``check_paths``, :func:`compare_attention_paths` once every slot
    decodes."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _build.build_all()  # set-up: no kernel is built in a timed step
    cfg, model = built or build_model(preset, dev, n_layers, seed,
                                      max_seq_len=_rope_len(preset, ctx))
    eng = Engine(cfg, model, n_slots=n_slots, max_len=ctx, kv_quant=kv_quant,
                 decode_attn=decode_attn, cuda_graph=cuda_graph)
    reqs = requests if requests is not None else make_requests(
        cfg.vocab_size)
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
            kept = {k: getattr(eng.perf, k) for k in _STEP_TIMES}
            prof = profile_decode(
                lambda: [eng.step() for _ in range(profile_steps)],
                profile_steps)
            # the profiled steps (slowed by the profiler) stay out of the
            # step times and rates
            for k, v in kept.items():
                setattr(eng.perf, k, v)
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
        "cuda_graph": eng.cuda_graph,
        "slots": n_slots, "ctx": ctx, "requests": len(reqs),
        "prompt_tokens": p.n_prompt_tokens, "prompt_s": p.t_prompt_s,
        "prompt_tok_per_s": p.n_prompt_tokens / p.t_prompt_s,
        "decode_tokens": p.n_decode_tokens, "decode_steps": p.n_decode_steps,
        "decode_s": p.t_decode_s,
        "decode_tok_per_s": p.n_decode_tokens / p.t_decode_s,
        "decode_ms_per_step": p.t_decode_s / p.n_decode_steps * 1e3,
        # the graphed steady state: steps replayed from a graph
        "replay_ms_per_step": (p.t_replay_s / p.n_replays * 1e3
                               if p.n_replays else None),
        "replayed_steps": p.n_replays,
        "captures": p.n_captures, "capture_s": p.t_capture_s,
        "step_programs": eng.step_programs(),
        "wall_s": wall_s,
        "outputs": [r.output for r in reqs],
        **({"profile": prof} if prof is not None else {}),
        **({"attention_paths": paths} if paths is not None else {}),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.engine")
    ap.add_argument("--model", dest="preset", default="llama3_8b_158",
                    help="a preset: llama3_8b_158 (the flagship), qwen3_4b, "
                    "gemma2_2b, mixtral_8x7b, deepseek_v2_lite, "
                    "mamba_2_8b, ...")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--slots", type=int, default=N_SLOTS)
    ap.add_argument("--ctx", type=int, default=CTX)
    ap.add_argument("--device", default=None)
    ap.add_argument("--cache-type", choices=("bf16", "q8"), default="bf16")
    ap.add_argument("--decode-attn", choices=("fused", "composed"),
                    default="fused")
    ap.add_argument("--profile-steps", type=int, default=0)
    ap.add_argument("--ab", action="store_true",
                    help="the graphed and the eager step in turns")
    args = ap.parse_args(argv)
    kw = dict(kv_quant=args.cache_type == "q8", decode_attn=args.decode_attn,
              n_slots=args.slots, ctx=args.ctx)
    if not args.ab:
        out = run(args.preset, args.device, args.layers,
                  profile_steps=args.profile_steps, **kw)
        out.pop("outputs")
        print(json.dumps(out))
        return
    built = build_model(args.preset, resolve_device(args.device),
                        args.layers, max_seq_len=_rope_len(args.preset,
                                                           args.ctx))
    turns = [(g, 0) for g in (True, False, False, True)]
    if args.profile_steps:
        turns += [(True, args.profile_steps), (False, args.profile_steps)]
    outputs = []
    for graph, prof in turns:
        out = run(args.preset, args.device, built=built, profile_steps=prof,
                  cuda_graph=graph, **kw)
        outputs.append(out.pop("outputs"))
        print(json.dumps(out), flush=True)
    if any(o != outputs[0] for o in outputs):
        raise SystemExit("the graphed and the eager step gave different "
                         "tokens")


if __name__ == "__main__":
    main()
