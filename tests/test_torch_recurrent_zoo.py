"""The recurrent zoo (``vlut_tpu_torch/bench/recurrent_zoo.py``), the
families ``chip_smoke.py`` phase 22 holds card against CPU, on the CPU:
each family's random model (the JAX converter's layout, filled from a
seed; the layouts are held to the converter's in the family tests) gives
the JAX package's logits on the same tree, and the card-vs-CPU harness
runs (here CPU against CPU: every layer and logit bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import close
from vlut_tpu.models import hybrid as jh
from vlut_tpu.models import rwkv as jr
from vlut_tpu.models import ssm as js
from vlut_tpu_torch.bench import recurrent_zoo as rz
from vlut_tpu_torch.models import hybrid as ph

torch.set_num_threads(1)


def _jax_config(cfg):
    import dataclasses

    cls = {"MambaConfig": js.MambaConfig, "Mamba2Config": js.Mamba2Config,
           "Rwkv7Config": jr.Rwkv7Config, "Rwkv6Config": jr.Rwkv6Config,
           "HybridConfig": jh.HybridConfig}[type(cfg).__name__]
    return cls(**dataclasses.asdict(cfg))


def _jax_tree(tree):
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if node.dtype == torch.bfloat16:
            return jnp.asarray(node.float().numpy(), jnp.bfloat16)
        return jnp.asarray(node.numpy())
    return conv(tree)


@pytest.mark.parametrize("name", rz.FAMILIES)
def test_zoo_family_matches_jax_and_runs_card_vs_cpu(name, monkeypatch):
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    cfg, tree = rz.family(name)
    cfg_j, pj = _jax_config(cfg), _jax_tree(tree)
    model = rz.model_on(cfg, tree, "cpu")
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 8))
    t = torch.from_numpy(toks)
    tj = jnp.asarray(toks, jnp.int32)
    if name == "mamba":
        want, got = js.forward(pj, cfg_j, tj)[0], rz.ssm.forward(
            model, cfg, t)[0]
    elif name == "mamba2":
        want, got = js.forward2(pj, cfg_j, tj)[0], rz.ssm.forward2(
            model, cfg, t)[0]
    elif name == "rwkv6":
        want, got = jr.forward6(pj, cfg_j, tj)[0], rz.rwkv.forward6(
            model, cfg, t)[0]
    elif name in ("rwkv7", "arwkv7"):
        want, got = jr.forward(pj, cfg_j, tj)[0], rz.rwkv.forward(
            model, cfg, t)[0]
    else:
        want, got = jh.forward(pj, cfg_j, tj), ph.forward(model, cfg, t)
    assert bool(torch.isfinite(got).all())
    close(got, want, name)
    r = rz.card_vs_cpu(name, "cpu", n_decode=2, prompt=6)
    assert r["within_tol"] and r["greedy_equal"]
    assert r["max_rel_layer_err"] == r["max_rel_logit_err"] == 0.0
    # a prefill and two steps, each through every layer
    assert r["layers_compared"] == 3 * cfg.n_layers
