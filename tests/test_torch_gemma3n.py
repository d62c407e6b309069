"""gemma3n (``vlut_tpu_torch/models/gemma3n.py``) against the JAX
package's ``models/gemma3n.py`` on both JAX test checkpoints
(``tests/test_gemma3n.py``: AltUp 2 with KV sharing, sparsity and the
final softcap; AltUp 3 without them): logits within 2e-5 of the largest
value, argmax equal; the sparsity cutoff equal to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_gemma3n
from _torch_recurrent import loaded_by
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import gemma3n as jg
from vlut_tpu_torch.convert import checkpoint as pck
from vlut_tpu_torch.models import gemma3n as pg

torch.set_num_threads(1)
TOL = 2e-5


@pytest.mark.parametrize("case,t", [
    (test_gemma3n.test_gemma3n_parity, 9),
    (test_gemma3n.test_gemma3n_parity_altup3_no_shared, 7)])
def test_gemma3n_matches_jax(case, t, tmp_path, monkeypatch):
    ckpt = loaded_by(case, tmp_path, monkeypatch)
    cfg_j, params_j, _ = jax_load(ckpt)
    params_j = jax.tree.map(jnp.asarray, params_j)
    cfg, model, meta = pck.load_checkpoint(ckpt, device="cpu")
    assert meta["model_family"] == "gemma3n" and cfg.d_ff == cfg_j.d_ff
    toks = np.random.default_rng(7).integers(0, test_gemma3n.V, (2, t))
    want = np.asarray(jg.forward(params_j, cfg_j, jnp.asarray(toks,
                                                               jnp.int32)))
    got = pg.forward(model, cfg, torch.from_numpy(toks)).numpy()
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= TOL * np.abs(want).max(), err
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("p", [0.5, 0.95, 0.999])
def test_norm_ppf_is_the_jax_cutoff(p):
    assert pg.norm_ppf(p) == jg._norm_ppf(p)
