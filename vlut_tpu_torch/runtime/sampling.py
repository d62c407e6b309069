"""Sampling: greedy and plain temperature (port of the subset of
vlut_tpu/runtime/sampling.py that fixed-n generation uses).

Per-row parameters as in the JAX package (:class:`SamplerParams`,
:func:`stack_params`, :func:`features_of`).  A row with temperature <= 0
takes the argmax; a row with temperature > 0 draws by Gumbel-max with noise
from its own seeded ``torch.Generator`` (:func:`row_generators`).  JAX's
threefry and torch's Philox give different numbers for the same seed, so
seeded draws match the JAX package in distribution, not token for token.
The truncation and bias transforms raise ``NotImplementedError`` until they
are ported; the penalty transforms act only on a recent-token window, which
fixed-n generation does not pass in either package, so they are no-ops here
as there.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    """Per-sequence sampling settings (same fields and defaults as the JAX
    package's SamplerParams)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    typical_p: float = 1.0
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    xtc_p: float = 0.0
    xtc_t: float = 0.1
    top_n_sigma: float = 0.0
    mirostat_tau: float = 0.0
    mirostat_eta: float = 0.1
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    penalty_last_n: int = 64
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    logit_bias: tuple[tuple[int, float], ...] = ()
    seed: int = 0


ALL_FEATURES = (
    "logit_bias", "penalties", "dry", "top_n_sigma", "top_k", "typical",
    "top_p", "min_p", "xtc", "sampling", "mirostat",
)
# transforms that need a recent-token window (none in fixed-n generation)
_WINDOW_FEATURES = ("penalties", "dry")


def stack_params(params: list[SamplerParams],
                 device="cpu") -> dict[str, torch.Tensor]:
    """Per-row parameter vectors: temperature, dynamic-temperature range and
    seed (the fields the ported transforms read)."""
    def vec(name, dtype):
        return torch.tensor([getattr(p, name) for p in params], dtype=dtype,
                            device=device)

    return {
        "temperature": vec("temperature", torch.float32),
        "dynatemp_range": vec("dynatemp_range", torch.float32),
        "seed": vec("seed", torch.int64),
    }


def features_of(params: list[SamplerParams]) -> tuple[str, ...]:
    """The static transform set of a batch (same rule as the JAX package)."""
    f: set[str] = set()
    for s in params:
        if s.logit_bias:
            f.add("logit_bias")
        if s.repeat_penalty != 1.0 or s.presence_penalty or s.frequency_penalty:
            f.add("penalties")
        if s.dry_multiplier > 0:
            f.add("dry")
        if s.top_n_sigma > 0:
            f.add("top_n_sigma")
        if s.top_k > 0:
            f.add("top_k")
        if s.typical_p < 1.0:
            f.add("typical")
        if s.top_p < 1.0:
            f.add("top_p")
        if s.min_p > 0:
            f.add("min_p")
        if s.xtc_p > 0:
            f.add("xtc")
        if s.temperature > 0:
            f.add("sampling")
        if s.mirostat_tau > 0:
            f.add("mirostat")
        if s.dynatemp_range > 0:
            f.add("sampling")
    return tuple(x for x in ALL_FEATURES if x in f)


def check_features(features: tuple[str, ...]) -> None:
    missing = set(features) - {"sampling", *_WINDOW_FEATURES}
    if missing:
        raise NotImplementedError(
            f"sampler transforms not ported yet: {sorted(missing)}")


def row_generators(p: dict[str, torch.Tensor], seed: int,
                   device) -> list[torch.Generator]:
    """One generator per row, seeded from (seed, row seed, row index), so
    rows that share a seed still draw different noise."""
    gens = []
    for row, s in enumerate(p["seed"].tolist()):
        g = torch.Generator(device=device)
        g.manual_seed(hash((int(seed), int(s), row)) & 0x7FFFFFFFFFFFFFFF)
        gens.append(g)
    return gens


def sample(logits: torch.Tensor, p: dict[str, torch.Tensor],
           generators: list[torch.Generator] | None = None,
           features: tuple[str, ...] | None = None) -> torch.Tensor:
    """(B, V) float32 logits -> (B,) int64 tokens."""
    features = ALL_FEATURES if features is None else features
    check_features(features)
    greedy = torch.argmax(logits, dim=-1)
    if "sampling" not in features:
        return greedy
    if bool((p["dynatemp_range"] > 0).any()):
        raise NotImplementedError("dynamic temperature is not ported yet")
    temp = p["temperature"]
    safe = torch.where(temp > 0, temp, torch.ones_like(temp))
    t = logits / safe[:, None]
    b, v = logits.shape
    u = torch.stack([
        torch.rand(v, generator=g, device=logits.device) for g in generators
    ])
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    gumbel = torch.where(t > NEG_INF / 2, gumbel, torch.zeros_like(gumbel))
    drawn = torch.argmax(t + gumbel, dim=-1)
    return torch.where(temp > 0, drawn, greedy)
