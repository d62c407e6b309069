"""Perplexity and logits comparison (port of vlut_tpu/eval/perplexity.py).

The analog of the reference's ``llama-perplexity``: windowed NLL over a
token stream, and the KL divergence between two execution paths of the same
checkpoint (``impl="auto"``, the int8-activation kernels, against
``impl="dequant"``, float32 products with the dequantized weights), the
metric behind the "lossless" claim.  Log-softmax runs in float32, as in the
JAX package.  The model's device decides where everything runs.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import TransformerLM, forward


@torch.inference_mode()
def sequence_logits(model: TransformerLM, cfg: ModelConfig, tokens,
                    impl: str = "auto") -> torch.Tensor:
    """float32 (T, V) logits of one sequence (no cache), vocabulary
    padding dropped."""
    ids = torch.as_tensor(np.asarray(tokens, np.int64),
                          device=model.device)[None]
    pos = torch.arange(ids.shape[1], device=model.device)[None]
    logits, _ = forward(model, cfg, ids, pos, None, impl=impl)
    return logits[0, :, : cfg.vocab_size].to(torch.float32)


def _target_logp(logits: torch.Tensor, ids) -> torch.Tensor:
    """log p(ids[i+1] | ids[:i+1]) for i < T-1, float32."""
    tgt = torch.as_tensor(np.asarray(ids[1:], np.int64), device=logits.device)
    logp = torch.log_softmax(logits[:-1], dim=-1)
    return logp.gather(-1, tgt[:, None])[:, 0]


def perplexity(
    model: TransformerLM,
    cfg: ModelConfig,
    tokens: list[int] | np.ndarray,
    window: int = 512,
    impl: str = "auto",
) -> dict[str, float]:
    """Non-overlapping-window perplexity (the reference's default
    protocol)."""
    tokens = np.asarray(tokens, np.int32)
    n = (len(tokens) // window) * window
    if n < window:
        raise ValueError(f"need at least {window} tokens, got {len(tokens)}")
    total_nll, total_cnt = 0.0, 0
    for i in range(0, n, window):
        chunk = tokens[i: i + window]
        lp = _target_logp(sequence_logits(model, cfg, chunk, impl), chunk)
        total_nll += float(-lp.sum())
        total_cnt += window - 1
    return {
        "ppl": math.exp(total_nll / total_cnt),
        "nll": total_nll / total_cnt,
        "tokens": total_cnt,
    }


def window_logprobs(model: TransformerLM, cfg: ModelConfig,
                    tokens: np.ndarray, impl: str = "auto") -> np.ndarray:
    """(len-1,) log p(tokens[i+1] | tokens[:i+1]), the scoring primitive
    behind the multiple-choice evals."""
    lp = _target_logp(sequence_logits(model, cfg, tokens, impl), tokens)
    return lp.cpu().numpy()


def kl_top1(la: torch.Tensor, lb: torch.Tensor):
    """(per-row KL(a || b), per-row top-1 agreement, log p_a, log p_b) of
    two float32 (T, V) logit arrays."""
    pa = torch.log_softmax(la, dim=-1)
    pb = torch.log_softmax(lb, dim=-1)
    kl = (pa.exp() * (pa - pb)).sum(dim=-1)
    return kl, la.argmax(-1) == lb.argmax(-1), pa, pb


def logits_compare(
    model: TransformerLM,
    cfg: ModelConfig,
    tokens: np.ndarray,
    impl_a: str = "auto",
    impl_b: str = "dequant",
    window: int = 256,
) -> dict[str, float]:
    """KL(a || b) and top-1 agreement between two execution paths, the
    lossless-ternary acceptance metric (the reference's KL-divergence
    mode)."""
    tokens = np.asarray(tokens[:window])
    kl, agree, _, _ = kl_top1(sequence_logits(model, cfg, tokens, impl_a),
                              sequence_logits(model, cfg, tokens, impl_b))
    return {
        "kl_mean": float(kl.mean()),
        "kl_max": float(kl.max()),
        "top1_agreement": float(agree.float().mean()),
    }
