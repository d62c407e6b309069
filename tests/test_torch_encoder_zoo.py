"""The encoder zoo (``vlut_tpu_torch/bench/encoder_zoo.py``), the families
``chip_smoke.py`` phase 23 holds card against CPU, on the CPU: the data
file of layouts equals what the JAX converters write; each float family's
random model gives the JAX package's outputs on the same tree (within 2e-5
of the largest value); and the card-vs-CPU harness runs (here CPU against
CPU: every output, layer and token equal), the diffusion families packed
and as float twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_encoder
from vlut_tpu.models import encoder as jenc
from vlut_tpu.models import gemma3n as jg
from vlut_tpu.models import t5 as jt5
from vlut_tpu_torch.bench import encoder_zoo as ez
from vlut_tpu_torch.models import encoder as penc
from vlut_tpu_torch.models import gemma3n as pg
from vlut_tpu_torch.models import t5 as pt5

torch.set_num_threads(1)
TOL = 2e-5
FLOAT = tuple(n for n in ez.FAMILIES if n not in ez.DIFFUSION)


def test_families_file_is_the_converters(tmp_path, monkeypatch):
    assert _torch_encoder.structures(tmp_path, monkeypatch) == ez.STRUCTURES


def _jax(cfg, tree):
    import dataclasses

    cls = {"EncoderConfig": jenc.EncoderConfig, "T5Config": jt5.T5Config,
           "Gemma3nConfig": jg.Gemma3nConfig}[type(cfg).__name__]
    return (cls(**dataclasses.asdict(cfg)),
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("name", FLOAT)
def test_float_family_matches_jax_and_runs_card_vs_cpu(name):
    cfg, tree = ez.family(name)
    cj, pj = _jax(cfg, tree)
    model = ez.model_on(cfg, tree, "cpu")
    rng = np.random.default_rng(1)
    fam = ez.STRUCTURES[name]["family"]
    if fam == "encoder":
        toks = rng.integers(1, cfg.vocab_size, (2, 12))
        mask = np.ones_like(toks)
        mask[1, 9:] = 0
        task = ez.TASKS.get(name)
        want = jenc.embed(pj, cj, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(mask, jnp.int32), task=task)
        got = penc.embed(model, cfg, torch.from_numpy(toks),
                         torch.from_numpy(mask), task=task)
    elif fam == "t5":
        toks = rng.integers(2, cfg.vocab_size, (1, 12))
        mask = np.ones_like(toks)
        dec = rng.integers(2, cfg.vocab_size, (1, 5))
        ej = jt5.encode(pj, cj, jnp.asarray(toks, jnp.int32),
                        jnp.asarray(mask, jnp.int32))
        want = jt5.decode_logits(pj, cj, jnp.asarray(dec, jnp.int32), ej,
                                 jnp.asarray(mask, jnp.int32))
        ep = pt5.encode(model, cfg, torch.from_numpy(toks),
                        torch.from_numpy(mask))
        got = pt5.decode_logits(model, cfg, torch.from_numpy(dec), ep,
                                torch.from_numpy(mask))
    else:
        toks = rng.integers(0, cfg.vocab_size, (1, 9))
        want = jg.forward(pj, cj, jnp.asarray(toks, jnp.int32))
        got = pg.forward(model, cfg, torch.from_numpy(toks))
    assert bool(torch.isfinite(got).all())
    _close(got, want, name)
    r = ez.card_vs_cpu(name, "cpu")
    assert r["within_tol"] and r["equal"] and r["max_rel_err"] == 0.0


@pytest.mark.parametrize("name", ez.DIFFUSION)
def test_diffusion_family_runs_card_vs_cpu(name):
    r = ez.card_vs_cpu(name, "cpu")
    assert r["within_tol"] and r["equal"]
    for kind in ("packed", "twin"):
        assert r[kind]["max_rel_layer_err"] == 0.0 and r[kind]["free_equal"]
        assert len(r[kind]["tokens"]) == 16
        assert r[kind]["forwards"] >= 2
