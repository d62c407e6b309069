"""``runtime/diffusion.py:diffusion_generate`` against the JAX package's,
step for step: greedy tokens equal for every confidence rule, one block
and LLaDA's blocks, in place (llada) and shifted (dream), with guidance,
on a packed tree (the JAX forward with ``impl="pallas_interpret"``) and on
its float twin.  The model is tests/fixtures/tiny_real's trained weights
run bidirectionally: a tiny random model's confidences tie to the last
bits, where the two packages' float sums round apart.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.diffusion import (DiffusionParams as JaxDP,
                                        diffusion_generate as jax_diffusion)
from vlut_tpu.train.finetune import float_twin_params as jax_twin
from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.runtime.diffusion import (DiffusionParams,
                                              diffusion_generate)
from vlut_tpu_torch.train.finetune import float_twin_params

torch.set_num_threads(1)
FIXTURE = "tests/fixtures/tiny_real"
PROMPT = [84, 104, 101, 32, 108, 105, 116, 116, 108, 101]  # "The little"
JAX_PACKED = functools.partial(jt.forward, impl="pallas_interpret")


@functools.lru_cache(maxsize=None)
def pair(shift: bool, twin: bool):
    """(JAX config, JAX params, port config, port model): tests/fixtures/
    tiny_real (trained weights) made bidirectional with the mask token
    255, in place or shifted, packed or its float twin."""
    cj, params, _ = jax_load(FIXTURE)
    cj = dataclasses.replace(cj, causal_attn=False, mask_token_id=255,
                             diffusion_shift_logits=shift)
    cfg = ModelConfig(**dataclasses.asdict(cj))
    model = params_from_numpy(params, cfg)
    params = jax.tree.map(jnp.asarray, params)
    if twin:
        return cj, jax_twin(params, cj), cfg, float_twin_params(model, cfg)
    return cj, params, cfg, model


# (confidence rule, block_len, cfg_scale, shifted, float twin)
CASES = [(alg, bl, 0.0, shift, False) for alg in ("low_confidence",
                                                  "margin", "entropy")
         for bl in (0, 4) for shift in (False, True)]
CASES += [("low_confidence", 0, 0.5, False, False),
          ("margin", 4, 0.5, True, False)]
CASES += [(alg, bl, 0.0, False, True) for alg in ("low_confidence",
                                                  "entropy")
          for bl in (0, 4)]
CASES += [("margin", 0, 0.5, True, True)]


@pytest.mark.parametrize(
    "alg,block_len,cfg_scale,shift,twin", CASES,
    ids=[f"{a}-bl{b}-cfg{c}-{'dream' if s else 'llada'}-"
         f"{'twin' if t else 'packed'}" for a, b, c, s, t in CASES])
def test_greedy_tokens_equal_jax(alg, block_len, cfg_scale, shift, twin):
    cj, params, cfg, model = pair(shift, twin)
    case = dict(alg=alg, block_len=block_len, cfg_scale=cfg_scale)
    dp = dict(steps=4, **case)
    want = jax_diffusion(params, cj, PROMPT, 12, JaxDP(**dp),
                         forward_fn=None if twin else JAX_PACKED)
    got = diffusion_generate(model, cfg, PROMPT, 12, DiffusionParams(**dp))
    assert got == want
    assert cfg.mask_token_id not in got
