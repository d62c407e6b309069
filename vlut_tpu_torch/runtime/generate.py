"""Fixed-n batched generation (port of vlut_tpu/runtime/generate.py).

The JAX package runs the n decode steps as one jitted ``lax.scan``; here
they are a Python loop of eager forward calls.  Capturing the step in a
CUDA graph is later work.  As there, no penalties in this path (no token
window is passed to the sampler).
"""

from __future__ import annotations

from typing import Callable

import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import forward
from vlut_tpu_torch.runtime.sampling import NEG_INF, row_generators, sample


def make_generate_fn(cfg: ModelConfig, n_steps: int,
                     features: tuple[str, ...] | None = None,
                     decode_attn: str = "fused",
                     impl: str = "auto") -> Callable:
    """f(params, cache, last_tokens, lengths, sp, seed) -> ((B, n_steps)
    tokens, cache), generating exactly n_steps tokens per row.

    Prompts must already be prefilled into ``cache`` at rows [0, lengths);
    the cache is updated in place.  ``decode_attn`` and ``impl`` go to
    ``forward``.
    """
    features = () if features is None else tuple(features)
    draws = "sampling" in features or "mirostat" in features

    @torch.inference_mode()
    def generate(params, cache, last_tokens, lengths, sp, seed: int = 0):
        b = last_tokens.shape[0]
        dev = last_tokens.device
        gens = row_generators(sp, seed, dev) if draws else None
        at = torch.zeros((b,), dtype=torch.long, device=dev)
        tokens, lens, out = last_tokens, lengths, []
        for _ in range(n_steps):
            logits, cache = forward(params, cfg, tokens[:, None],
                                    lens[:, None], cache, logits_at=at,
                                    decode_attn=decode_attn, impl=impl)
            logits = logits[:, 0].to(torch.float32)
            v = logits.shape[-1]
            if v != cfg.vocab_size:
                logits = logits.masked_fill(
                    torch.arange(v, device=dev) >= cfg.vocab_size, NEG_INF)
            tokens = sample(logits, sp, gens, features)
            lens = lens + 1
            out.append(tokens)
        return torch.stack(out, dim=1), cache

    return generate
