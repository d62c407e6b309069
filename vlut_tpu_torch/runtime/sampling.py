"""Sampler chain (port of vlut_tpu/runtime/sampling.py).

Each processor is a (B, V) -> (B, V) logits transform with per-row
parameters; a disabled parameter value makes it the identity, and
:func:`features_of` prunes the transforms no row uses.  Order, as in the
JAX package (common/sampling.cpp defaults): logit_bias -> grammar mask ->
penalties -> dry -> top_n_sigma -> top_k -> typical -> top_p -> min_p ->
xtc -> temperature/dynatemp -> draw; mirostat v2 rows take temperature ->
mirostat truncation -> draw -> mu update instead.  temperature <= 0 is
greedy.

Every deterministic transform computes what the JAX package computes.
The draws (Gumbel-max per row, the XTC roll) take their noise from one
seeded ``torch.Generator`` (Philox) per row; JAX's threefry gives other
numbers for the same seed, so draws match the JAX package in
distribution, not token for token.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -1e30
MAX_LOGIT_BIAS = 16  # per-row capacity for (token, bias) pairs


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    """Per-sequence sampling settings (same fields and defaults as the JAX
    package's SamplerParams): temp <= 0 greedy, top_k <= 0 off, top_p >= 1
    off, min_p <= 0 off, typical_p >= 1 off, xtc_p <= 0 off, top_n_sigma
    <= 0 off, mirostat_tau <= 0 off, penalty 1.0 off, dry_multiplier <= 0
    off."""

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


_FLOAT_FIELDS = (
    "temperature", "top_p", "min_p", "typical_p", "dynatemp_range",
    "dynatemp_exponent", "xtc_p", "xtc_t", "top_n_sigma", "mirostat_tau",
    "mirostat_eta", "repeat_penalty", "presence_penalty", "frequency_penalty",
    "dry_multiplier", "dry_base",
)
_INT_FIELDS = ("top_k", "penalty_last_n", "dry_allowed_length", "seed")


def stack_params(params: list[SamplerParams],
                 device="cpu") -> dict[str, torch.Tensor]:
    """Per-row parameter vectors of every field (float32 / int32), plus the
    logit biases as (B, MAX_LOGIT_BIAS) token ids (-1 = unused) and
    values."""
    out = {
        f: torch.tensor([getattr(p, f) for p in params], dtype=torch.float32,
                        device=device)
        for f in _FLOAT_FIELDS
    }
    out.update({
        f: torch.tensor([getattr(p, f) for p in params], dtype=torch.int32,
                        device=device)
        for f in _INT_FIELDS
    })
    bt = np.full((len(params), MAX_LOGIT_BIAS), -1, np.int32)
    bv = np.zeros((len(params), MAX_LOGIT_BIAS), np.float32)
    for i, p in enumerate(params):
        for j, (t, b) in enumerate(p.logit_bias[:MAX_LOGIT_BIAS]):
            bt[i, j], bv[i, j] = t, b
    out["bias_tok"] = torch.from_numpy(bt).to(device)
    out["bias_val"] = torch.from_numpy(bv).to(device)
    return out


def init_state(n_rows: int, device="cpu") -> dict[str, torch.Tensor]:
    """Per-row state carried across steps (mirostat mu)."""
    return {"mu": torch.zeros((n_rows,), dtype=torch.float32, device=device)}


def _fma(a, b, c) -> torch.Tensor:
    """a + b * c rounded once to float32, as XLA contracts it (a float32
    product is exact in float64)."""
    return (a.to(torch.float64) + b.to(torch.float64) * c.to(torch.float64)
            ).to(torch.float32)


def apply_logit_bias(logits: torch.Tensor,
                     p: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sparse per-token additive biases."""
    b, v = logits.shape
    tok = p["bias_tok"].long()
    val = torch.where(tok >= 0, p["bias_val"], torch.zeros_like(p["bias_val"]))
    safe = torch.where(tok >= 0, tok, torch.full_like(tok, v))
    ext = torch.cat([logits, logits.new_zeros((b, 1))], dim=-1)
    return ext.scatter_add(1, safe, val)[:, :v]


def _counts(recent_tokens, recent_valid, v):
    """(B, V) float32 occurrences of each token in the valid window."""
    tok = torch.where(recent_valid, recent_tokens.long(),
                      torch.full_like(recent_tokens, v, dtype=torch.long))
    b = tok.shape[0]
    c = torch.zeros((b, v + 1), dtype=torch.float32, device=tok.device)
    return c.scatter_add_(1, tok, torch.ones_like(tok, dtype=torch.float32))[
        :, :v]


def apply_penalties(logits, recent_tokens, recent_valid, p):
    """repeat/presence/frequency penalties over the last-n window: logits of
    tokens in the window are divided by repeat_penalty (multiplied when
    negative), then shifted by presence and count * frequency."""
    counts = _counts(recent_tokens, recent_valid, logits.shape[-1])
    present = counts > 0
    rp = p["repeat_penalty"][:, None]
    scaled = torch.where(logits > 0, logits / rp, logits * rp)
    out = torch.where(present & (rp != 1.0), scaled, logits)
    out = out - present * p["presence_penalty"][:, None]
    return _fma(out, -counts, p["frequency_penalty"][:, None])


def apply_dry(logits, recent_tokens, recent_valid, p, breakers=None):
    """DRY sequence-repetition penalty: a token that would extend a repeat
    of length m >= allowed_length loses multiplier * base^(m - allowed)."""
    b, pw = recent_tokens.shape
    v = logits.shape[-1]
    dev = logits.device
    ctx = torch.where(recent_valid, recent_tokens.long(),
                      torch.full_like(recent_tokens, -1, dtype=torch.long))
    if breakers is not None:
        is_break = (ctx[:, :, None] == breakers.long()[None, None, :]).any(-1)
        ctx = torch.where(is_break,
                          -(2 + torch.arange(pw, device=dev))[None, :], ctx)
    t_max = pw - 1
    tt = torch.arange(t_max, device=dev)
    jj = torch.arange(pw, device=dev)
    src_j = jj[None, :, None] - tt[None, None, :]  # (1, P, T)
    src_last = (pw - 1) - tt
    gather_j = torch.gather(
        ctx[:, None, :].expand(b, pw, pw), 2,
        torch.clamp(src_j, 0, pw - 1).expand(b, pw, t_max))
    gather_l = ctx[:, src_last]  # (B, T)
    eq = (gather_j == gather_l[:, None, :]) & (src_j >= 0)
    eq = eq & (gather_j >= 0) & (gather_l >= 0)[:, None, :]
    run = torch.cumprod(eq.to(torch.int32), dim=-1).sum(-1)  # (B, P)
    cand = torch.cat([ctx[:, 1:], torch.full((b, 1), -1, device=dev,
                                             dtype=ctx.dtype)], dim=-1)
    valid_j = (jj < pw - 2)[None, :] & (cand >= 0) & (run > 0)
    m = torch.where(valid_j, run, torch.zeros_like(run))
    safe_cand = torch.where(valid_j, cand, torch.full_like(cand, v))
    mlen = torch.zeros((b, v + 1), dtype=run.dtype, device=dev).scatter_reduce(
        1, safe_cand, m, reduce="amax")[:, :v]
    allowed = p["dry_allowed_length"][:, None]
    mult = p["dry_multiplier"][:, None]
    base = p["dry_base"][:, None]
    hit = (mlen >= allowed) & (mult > 0)
    pen = torch.pow(base, torch.clamp(mlen - allowed, min=0).to(torch.float32))
    return torch.where(hit, _fma(logits, -mult, pen), logits)


def apply_top_k(logits, top_k):
    """Per-row top-k; top_k <= 0 disables."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.clamp(top_k.long(), 1, v)
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    mask = (logits >= kth) | (top_k <= 0)[:, None]
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def _keep_sorted(values, order, keep_sorted):
    """Scatter a keep mask over sorted positions back to token order."""
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def apply_top_p(logits, top_p):
    """Nucleus; top_p >= 1 disables; the top token always stays."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, 1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = _keep_sorted(logits, order, (cum - probs) < top_p[:, None])
    keep = keep | (logits >= logits.amax(dim=-1, keepdim=True))
    keep = keep | (top_p >= 1.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_min_p(logits, min_p):
    """Drop tokens with prob < min_p * max prob; min_p <= 0 disables."""
    probs = torch.softmax(logits, dim=-1)
    thresh = probs.amax(dim=-1, keepdim=True) * min_p[:, None]
    keep = (probs >= thresh) | (min_p <= 0.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_typical(logits, typical_p):
    """Locally typical sampling: keep the smallest set of tokens, ranked by
    |surprise - entropy|, whose mass reaches typical_p; >= 1 disables."""
    probs = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    ent = -(probs * torch.where(probs > 0, logp, torch.zeros_like(logp))).sum(
        -1, keepdim=True)
    shifted = torch.abs(-logp - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)
    p_sorted = torch.gather(probs, 1, order)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < typical_p[:, None]
    keep_sorted[:, 0] = True
    keep = _keep_sorted(logits, order, keep_sorted)
    keep = keep | (typical_p >= 1.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_top_n_sigma(logits, n_sigma):
    """Keep logits >= max - n * std over the valid candidates; <= 0 off."""
    valid = logits > NEG_INF / 2
    cnt = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    zero = torch.zeros_like(logits)
    mean = torch.where(valid, logits, zero).sum(-1, keepdim=True) / cnt
    var = torch.where(valid, (logits - mean) ** 2, zero).sum(
        -1, keepdim=True) / cnt
    std = torch.sqrt(var)
    keep = logits >= logits.amax(-1, keepdim=True) - n_sigma[:, None] * std
    keep = keep | (n_sigma <= 0.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_xtc(logits, xtc_p, xtc_t, roll):
    """XTC: with probability p (``roll`` (B, 1) uniform), when >= 2 tokens
    have prob >= threshold, remove all of them but the least probable."""
    probs = torch.softmax(logits, dim=-1)
    qual = probs >= xtc_t[:, None]
    n_qual = qual.sum(-1, keepdim=True)
    minq = torch.where(qual, probs, torch.full_like(probs, torch.inf)).amin(
        -1, keepdim=True)
    remove = qual & (probs > minq) & (n_qual >= 2)
    fire = (roll < xtc_p[:, None]) & (xtc_t[:, None] <= 0.5)
    return torch.where(fire & remove, torch.full_like(logits, NEG_INF),
                       logits)


def apply_temperature(logits, p):
    """Static or dynamic-entropy temperature: with dynatemp_range r > 0 the
    temperature is max(0, t-r) + (t+r - max(0, t-r)) * (H / H_max)^exp
    over the current candidates."""
    temp, rng, expo = (p["temperature"], p["dynatemp_range"],
                       p["dynatemp_exponent"])
    valid = logits > NEG_INF / 2
    probs = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    ent = -(probs * torch.where(valid, logp, torch.zeros_like(logp))
            * valid).sum(-1)
    n_valid = torch.clamp(valid.sum(-1), min=2)
    max_ent = torch.log(n_valid.to(torch.float32))
    tmin = torch.clamp(temp - rng, min=0.0)
    tmax = temp + rng
    dyn = _fma(tmin, tmax - tmin,
               torch.pow(torch.clamp(ent / max_ent, 0.0, 1.0), expo))
    eff = torch.where(rng > 0, dyn, temp)
    safe = torch.where(eff > 0, eff, torch.ones_like(eff))
    return logits / safe[:, None]


def row_generators(p: dict[str, torch.Tensor], seed: int,
                   device) -> list[torch.Generator]:
    """One generator per row, seeded from (seed, row seed, row index), so
    rows that share a seed still draw different noise."""
    return [row_generator(seed, s, row, device)
            for row, s in enumerate(p["seed"].tolist())]


def row_generator(seed: int, row_seed: int, row: int,
                  device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(hash((int(seed), int(row_seed), int(row)))
                  & 0x7FFFFFFFFFFFFFFF)
    return g


def _uniform(gens, b: int, n: int, device) -> torch.Tensor:
    """(b, n) uniform noise, row r from ``gens[r]`` (zeros for a row whose
    generator is None, or every row when ``gens`` is None: a greedy row
    draws nothing)."""
    if gens is None:
        return torch.zeros((b, n), device=device)
    rows = [torch.rand(n, generator=g, device=device) if g is not None
            else torch.zeros(n, device=device) for g in gens]
    if len(rows) != b:
        raise ValueError(f"{len(rows)} generators for {b} rows")
    return torch.stack(rows)


def noise_shapes(b: int, v: int,
                 features: tuple[str, ...] | None) -> dict[str, tuple]:
    """The uniform noise :func:`sample_ex` draws for B rows over V logits
    with these features, in the order it draws it: the XTC roll, the
    categorical draw, mirostat's draw.  A chain that only takes the argmax
    draws nothing."""
    on = (lambda name: features is None or name in features)
    if not on("sampling") and not on("mirostat"):
        return {}
    shapes = {"xtc": (b, 1)} if on("xtc") else {}
    shapes["categorical"] = (b, v)
    if on("mirostat"):
        shapes["mirostat"] = (b, v)
    return shapes


def draw_noise(gens, shapes: dict[str, tuple], device,
               out: dict[str, torch.Tensor] | None = None
               ) -> dict[str, torch.Tensor]:
    """Draw the noise of :func:`noise_shapes` ahead of :func:`sample_ex`,
    in its order, from the same per-row generators: handed to it as
    ``noise``, it gives the tokens it would give drawing for itself, bit
    for bit.  With ``out`` the draws are copied into those tensors (the
    static inputs of a captured step)."""
    drawn = {name: _uniform(gens, b, n, device)
             for name, (b, n) in shapes.items()}
    if out is None:
        return drawn
    for name, u in drawn.items():
        out[name].copy_(u)
    return out


def _per_row_categorical(logits, u):
    """Gumbel-max draw per row with the row's own uniform noise ``u``;
    masked entries get no noise."""
    g = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    g = torch.where(logits > NEG_INF / 2, g, torch.zeros_like(g))
    return torch.argmax(logits + g, dim=-1)


ALL_FEATURES = (
    "logit_bias", "penalties", "dry", "top_n_sigma", "top_k", "typical",
    "top_p", "min_p", "xtc", "sampling", "mirostat",
)


def features_of(params: list[SamplerParams]) -> tuple[str, ...]:
    """The transforms a batch of sampler settings needs (same rule as the
    JAX package)."""
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


@torch.inference_mode()
def sample_ex(
    logits: torch.Tensor,  # (B, V) float32
    p: dict[str, torch.Tensor],
    generators: list[torch.Generator | None] | None,
    state: dict[str, torch.Tensor],
    recent_tokens: torch.Tensor | None = None,  # (B, P)
    recent_valid: torch.Tensor | None = None,
    allowed_mask: torch.Tensor | None = None,  # (B, V) bool
    dry_breakers: torch.Tensor | None = None,
    features: tuple[str, ...] | None = None,
    noise: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The full chain with carried per-row state; returns ((B,) int64
    tokens, state).  ``generators`` holds one generator per row (None for
    a row that never samples); it may be None when no row samples.
    ``noise``, from :func:`draw_noise`, takes the place of the draws (a
    captured step draws nothing: its noise is drawn before each replay)."""
    on = (lambda name: features is None or name in features)
    b, v = logits.shape
    if noise is None:
        noise = draw_noise(generators, noise_shapes(b, v, features),
                           logits.device)
    if on("logit_bias"):
        logits = apply_logit_bias(logits, p)
    if allowed_mask is not None:
        logits = torch.where(allowed_mask, logits,
                             torch.full_like(logits, NEG_INF))
    if recent_tokens is not None:
        if on("penalties"):
            logits = apply_penalties(logits, recent_tokens, recent_valid, p)
        if on("dry"):
            logits = apply_dry(logits, recent_tokens, recent_valid, p,
                               dry_breakers)
    greedy_tok = torch.argmax(logits, dim=-1)
    if not on("sampling") and not on("mirostat"):
        return greedy_tok, state

    # the standard truncation chain
    t = logits
    if on("top_n_sigma"):
        t = apply_top_n_sigma(t, p["top_n_sigma"])
    if on("top_k"):
        t = apply_top_k(t, p["top_k"])
    if on("typical"):
        t = apply_typical(t, p["typical_p"])
    if on("top_p"):
        t = apply_top_p(t, p["top_p"])
    if on("min_p"):
        t = apply_min_p(t, p["min_p"])
    if on("xtc"):
        t = apply_xtc(t, p["xtc_p"], p["xtc_t"], noise["xtc"])
    t = apply_temperature(t, p)
    std_tok = _per_row_categorical(t, noise["categorical"])

    if on("mirostat"):
        tau, eta = p["mirostat_tau"], p["mirostat_eta"]
        mu = torch.where((state["mu"] == 0.0) & (tau > 0), 2.0 * tau,
                         state["mu"])
        temp = p["temperature"]
        safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp))
        ml = logits / safe_temp[:, None]
        mprob = torch.softmax(ml, dim=-1)
        surprise = -torch.log2(torch.clamp(mprob, min=1e-30))
        mkeep = (surprise <= mu[:, None]) | (ml >= ml.amax(-1, keepdim=True))
        mt = torch.where(mkeep, ml, torch.full_like(ml, NEG_INF))
        miro_tok = _per_row_categorical(mt, noise["mirostat"])
        obs = torch.gather(surprise, 1, miro_tok[:, None])[:, 0]
        new_mu = mu - eta * (obs - tau)
        use_miro = tau > 0
        std_tok = torch.where(use_miro, miro_tok, std_tok)
        state = {"mu": torch.where(use_miro, new_mu, state["mu"])}

    return torch.where(p["temperature"] > 0, std_tok, greedy_tok), state


def sample(logits: torch.Tensor, p: dict[str, torch.Tensor],
           generators: list[torch.Generator] | None = None,
           features: tuple[str, ...] | None = None,
           noise: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """The chain, token only (fresh state, no token window): (B, V) ->
    (B,) int64."""
    tok, _ = sample_ex(logits, p, generators,
                       init_state(logits.shape[0], logits.device),
                       features=features, noise=noise)
    return tok
