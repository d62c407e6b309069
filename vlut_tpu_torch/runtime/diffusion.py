"""Diffusion-LM decoding (port of ``vlut_tpu/runtime/diffusion.py``; the
llada / dream / rnd1 / llada_moe family).

A masked-diffusion LM is a decoder stack run with bidirectional attention
(``causal_attn=False``): generation starts from a response of ``[MASK]``
tokens and each denoise step runs one forward over prompt + response and
commits the most confident masked positions until none is left.  The
sequence length is fixed for the whole loop; each step is one cacheless
``forward`` under an all-true ``attn_mask``, run eagerly (the JAX package
runs one jitted forward a step; neither keeps a cache or a graph here).
On the card its projections run #3 (M > 64) or #1 / #4 (M <= 64) for a
packed tree, plain float products for a float twin.

Block mode (``block_len``) is LLaDA's semi-autoregressive schedule: the
response is denoised block by block, ``steps // n_blocks`` steps each, with
attention over the whole sequence.  ``alg="random"`` and ``temp > 0`` draw
from a ``torch.Generator`` seeded by ``seed``, where the JAX package draws
from threefry: those outputs match it in distribution only.
"""

from __future__ import annotations

import dataclasses

import torch

from vlut_tpu_torch.models.transformer import forward as _forward


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    steps: int = 32              # total denoise iterations
    block_len: int = 0           # 0 = one block over the whole response
    alg: str = "low_confidence"  # | "entropy" | "margin" | "random"
    temp: float = 0.0            # > 0: sample the committed tokens
    cfg_scale: float = 0.0       # classifier-free guidance:
    # logits = (1 + s) * cond - s * uncond (the prompt masked)
    seed: int = 0


ALGS = ("low_confidence", "entropy", "margin", "random")


def _confidence(logits: torch.Tensor, alg: str,
                gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position (confidence, token) of (N, V) logits: the argmax token
    (the first of equal maxima, as ``jnp.argmax``) and its probability, the
    top-2 margin, the negative entropy, or a uniform draw (``random``)."""
    tok = torch.argmax(logits, dim=-1)
    if alg == "random":
        return torch.rand(tok.shape, generator=gen,
                          device=logits.device), tok
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    if alg == "low_confidence":
        return p.amax(dim=-1), tok
    if alg == "margin":
        t2 = torch.topk(p, 2, dim=-1).values
        return t2[..., 0] - t2[..., 1], tok
    if alg == "entropy":
        return (p * torch.log(p + 1e-12)).sum(dim=-1), tok
    raise ValueError(f"unknown diffusion alg {alg!r}")


def _top_k(conf: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values, ties to the lower index
    (``jax.lax.top_k``'s order): a stable descending sort."""
    return torch.sort(conf, descending=True, stable=True).indices[:k]


@torch.inference_mode()
def diffusion_generate(model, cfg, prompt: list[int], n_new: int,
                       dp: DiffusionParams = DiffusionParams(),
                       forward_fn=None) -> list[int]:
    """Denoise a fully masked ``n_new``-token response after ``prompt``
    with the model (a packed tree or its float twin) of a config that
    carries ``mask_token_id``; returns the response's tokens."""
    if dp.alg not in ALGS:
        raise ValueError(f"unknown diffusion alg {dp.alg!r}")
    forward_fn = forward_fn or _forward
    dev = model.device
    mask_id = getattr(cfg, "mask_token_id", 0) or 0
    p_len = len(prompt)
    total = p_len + n_new
    toks = torch.tensor([list(prompt) + [mask_id] * n_new], dtype=torch.long,
                        device=dev)
    pos = torch.arange(total, device=dev)[None]
    bidir = torch.ones((1, total, total), dtype=torch.bool, device=dev)
    n_blocks = max(1, -(-n_new // dp.block_len)) if dp.block_len else 1
    blk = dp.block_len or n_new
    steps_per_block = max(1, dp.steps // n_blocks)
    shift = getattr(cfg, "diffusion_shift_logits", True)
    gen = torch.Generator(device=dev).manual_seed(dp.seed)
    idx_all = torch.arange(total, device=dev)

    def logits_of(t):
        lg, _ = forward_fn(model, cfg, t, pos, None, attn_mask=bidir)
        return lg[0, :, :cfg.vocab_size]

    def denoise_step(toks, hi):
        logits = logits_of(toks)
        if dp.cfg_scale > 0:
            un_toks = toks.clone()
            un_toks[0, :p_len] = mask_id
            logits = ((1 + dp.cfg_scale) * logits
                      - dp.cfg_scale * logits_of(un_toks))
        if shift:
            # dream / rnd1 keep the causal LM's head: logits[i] predicts
            # token i + 1
            logits = torch.roll(logits, 1, dims=0)
        conf, tok = _confidence(logits, dp.alg, gen)
        if dp.temp > 0:
            # the sampled token and its probability (sample, then rank)
            u = torch.rand(logits.shape, generator=gen, device=dev).clamp(
                min=torch.finfo(torch.float32).tiny)
            tok = torch.argmax(logits / dp.temp - torch.log(-torch.log(u)),
                               dim=-1)
            p = torch.softmax(logits.to(torch.float32), dim=-1)
            conf = torch.gather(p, -1, tok[:, None])[:, 0]
        cand = (toks[0] == mask_id) & (idx_all >= p_len) & (idx_all < hi)
        return conf, tok, cand

    for b_i in range(n_blocks):
        hi = min(p_len + (b_i + 1) * blk, total)
        for s in range(steps_per_block):
            conf, tok, cand = denoise_step(toks, hi)
            nm = int(cand.sum())
            if nm == 0:
                break
            # commit the ceil(nm / steps_left) most confident positions
            k = max(1, -(-nm // (steps_per_block - s)))
            conf = torch.where(cand, conf, torch.full_like(conf, -torch.inf))
            idx = _top_k(conf, k)
            toks[0, idx] = tok[idx]
        # force-commit the block's stragglers (its steps ran out)
        still = (toks[0] == mask_id) & (idx_all >= p_len) & (idx_all < hi)
        if bool(still.any()):
            _, tok, _ = denoise_step(toks, hi)
            toks[0, still] = tok[still]
    return toks[0, p_len:].tolist()
