"""Fixed-n batched generation (port of vlut_tpu/runtime/generate.py).

The JAX package runs the n decode steps as one jitted ``lax.scan``.  Here
one step (forward, pad-vocab mask, sampler chain, ``lens += 1``) runs over
static tensors; on the card it is captured once as a CUDA graph
(:mod:`runtime.step_graph`) and replayed n times, the token buffer feeding
itself, so the host launches one graph per step.  The graph is keyed by
the cache's and the model's tensors and the batch: a new cache gets a new
graph, never a stale one (one graph is kept).  On the CPU, or with
``cuda_graph=False`` (the eager A/B), the same step runs eagerly.  A
sampling step's noise is drawn from the per-row generators before each
step, in the order the chain would draw it, so seeded tokens are the same
both ways.  As in the JAX package, no penalties in this path (no token
window is passed to the sampler).
"""

from __future__ import annotations

from typing import Callable

import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import forward
from vlut_tpu_torch.runtime.sampling import (
    NEG_INF,
    draw_noise,
    noise_shapes,
    row_generators,
    sample,
)
from vlut_tpu_torch.runtime.step_graph import step_runner


def _graph_key(params, cache, sp, b: int, ablate: frozenset) -> tuple:
    """What a captured step depends on besides the values of its static
    inputs: the model's and the cache's tensors (by address), the batch,
    the sampler settings' fields and the ablation switches."""
    return (id(params), params.embed.data_ptr(), b, tuple(sp),
            tuple(t.data_ptr() for arrs in cache.values() for t in arrs),
            ablate)


def make_generate_fn(cfg: ModelConfig, n_steps: int,
                     features: tuple[str, ...] | None = None,
                     decode_attn: str = "fused",
                     impl: str = "auto", cuda_graph: bool = True,
                     ablate: frozenset[str] = frozenset()) -> Callable:
    """f(params, cache, last_tokens, lengths, sp, seed) -> ((B, n_steps)
    tokens, cache), generating exactly n_steps tokens per row.

    Prompts must already be prefilled into ``cache`` at rows [0, lengths);
    the cache is updated in place.  ``decode_attn``, ``impl`` and
    ``ablate`` (``bench/ablate.py``'s switches) go to ``forward``;
    ``cuda_graph=False`` runs the steps eagerly on the card.
    The first call on a new cache runs its first step eagerly and captures
    the step before the second; later calls on it only replay.
    """
    features = () if features is None else tuple(features)
    draws = "sampling" in features or "mirostat" in features
    held: dict = {}  # the one kept program: key, static tensors, runner

    def program(params, cache, sp, b: int, dev) -> dict:
        key = _graph_key(params, cache, sp, b, ablate)
        if held.get("key") == key:
            return held
        held.clear()
        st = {"tokens": torch.zeros((b,), dtype=torch.long, device=dev),
              "lens": torch.zeros((b,), dtype=torch.long, device=dev),
              "at": torch.zeros((b,), dtype=torch.long, device=dev),
              "col": torch.zeros((1,), dtype=torch.long, device=dev),
              "out": torch.zeros((b, n_steps), dtype=torch.long, device=dev),
              "sp": {k: torch.zeros_like(v) for k, v in sp.items()},
              "shapes": noise_shapes(b, params.n_logits, features)}
        st["noise"] = {name: torch.zeros(sh, device=dev)
                       for name, sh in st["shapes"].items()}

        def step():
            logits, _ = forward(params, cfg, st["tokens"][:, None],
                                st["lens"][:, None], cache,
                                logits_at=st["at"], decode_attn=decode_attn,
                                impl=impl, ablate=ablate)
            logits = logits[:, 0].to(torch.float32)
            v = logits.shape[-1]
            if v != cfg.vocab_size:
                logits = logits.masked_fill(
                    torch.arange(v, device=dev) >= cfg.vocab_size, NEG_INF)
            tok = sample(logits, st["sp"], None, features, noise=st["noise"])
            st["tokens"].copy_(tok)
            st["lens"] += 1
            st["out"].index_copy_(1, st["col"], tok[:, None])
            st["col"] += 1

        held.update(key=key, st=st, run=step_runner(step, dev, cuda_graph))
        return held

    @torch.inference_mode()
    def generate(params, cache, last_tokens, lengths, sp, seed: int = 0):
        b = last_tokens.shape[0]
        dev = last_tokens.device
        prog = program(params, cache, sp, b, dev)
        st, run = prog["st"], prog["run"]
        st["tokens"].copy_(last_tokens)
        st["lens"].copy_(lengths)
        st["col"].zero_()
        for k, v in sp.items():  # the sampler settings are static inputs
            st["sp"][k].copy_(v)
        gens = row_generators(sp, seed, dev) if draws else None
        for _ in range(n_steps):
            if st["shapes"]:
                draw_noise(gens, st["shapes"], dev, out=st["noise"])
            run()
        return st["out"].clone(), cache

    return generate
