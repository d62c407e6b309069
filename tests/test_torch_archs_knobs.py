"""Knobs that only MoE HF models carry, held against the JAX package on the
CPU: attention sinks, the clamped swiglu, the attention gate, the L2 q/k
norm, NoPE-layer temperature tuning and chunked windows, each as a dense
model made by adding its tensor to a JAX ``init_params`` tree of ``tiny``
(random gains), beside rolling windows (the fused decode attention with its
window), a local rope base and a model without positions.

Tolerances are those of ``tests/_torch_archs.py``: 2e-2 of the largest
logit, greedy tokens identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_archs import check_pair, trees
from test_torch_archs import _random_gains, _tokens
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu_torch.config import PRESETS


def _with_sinks(params, cfg, rng):
    params["layers"]["sinks"] = jnp.asarray(
        rng.standard_normal((cfg.n_layers, cfg.n_heads)).astype(np.float32))


def _with_attn_gate(params, cfg, rng):
    packed, scales = [], []
    for _ in range(cfg.n_layers):
        trits = rng.integers(-1, 2, (cfg.d_model, cfg.q_dim), dtype=np.int8)
        t = jt.pack_weight("w_attn_gate", trits, np.float32(0.05), cfg)
        packed.append(np.asarray(t.packed))
        scales.append(np.asarray(t.scale))
    params["layers"]["w_attn_gate"] = {"packed": jnp.asarray(np.stack(packed)),
                                       "scale": jnp.asarray(np.stack(scales))}


# name -> (config changes of ``tiny``, tensor added to the JAX tree)
KNOBS = {
    "sinks": (dict(attn_sinks=True), _with_sinks),
    "swiglu_limit": (dict(swiglu_limit=0.05), None),
    "attn_gate": (dict(attn_gate="sigmoid"), _with_attn_gate),
    "l2_qk_norm": (dict(qk_norm=True, qk_norm_type="l2",
                        qk_norm_post_rope=True, nope_layers=(False, True)),
                   None),
    "attn_temp": (dict(attn_temp_scale=0.5, attn_temp_floor=4,
                       nope_layers=(True, False)), None),
    "chunked_swa": (dict(sliding_window=4, sliding_window_pattern=2,
                         swa_type="chunked"), None),
    "swa": (dict(sliding_window=4, sliding_window_pattern=2), None),
    "swa_local_rope": (dict(sliding_window=4, sliding_window_pattern=2,
                            rope_theta=1e6, rope_theta_local=1e4), None),
    "no_positions": (dict(pos_embed="none"), None),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_dense_knob_matches_jax(knob):
    """Prompts of 12 tokens (past the windows of 4), then cached decode
    with the fused decode attention where its gate lets it run (the
    rolling-window models: #7 with the layer's window)."""
    change, add = KNOBS[knob]
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny"], **change)
    cfg = dataclasses.replace(PRESETS["tiny"], **change)
    params = jt.init_params(cfg_j, seed=0)
    if add is not None:
        add(params, cfg_j, np.random.default_rng(1))
    params = _random_gains(params)
    tokens = _tokens(cfg.vocab_size, 12, seed=2)
    stacked_j = None
    for label, p, model in trees(cfg_j, params, cfg):
        if knob == "attn_gate" and label == "fused":
            # the JAX package's fused qkv never materialises the normed
            # input its gate reads (it asserts); the port norms it for the
            # gate, so its fused tree is held against JAX's stacked one
            p = stacked_j
        stacked_j = p
        check_pair(cfg_j, p, cfg, model, tokens)
