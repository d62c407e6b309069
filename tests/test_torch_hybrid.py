"""The port's hybrid SSM + attention LMs (``vlut_tpu_torch/models/
hybrid.py``) against the JAX package on the CPU, first half of the cases:
each on the checkpoint the JAX converter writes from the HF model its JAX
test builds in code (``tests/test_hybrid.py``): jamba, falcon-h1 (both
mamba norms), granite-hybrid, lfm2 and qwen3-next (dense).  The rest are
in ``test_torch_hybrid2.py``.  float32 weights: logits within 2e-2 of the
largest, greedy tokens equal; and the full-recompute greedy ``generate``
loop gives JAX's tokens (checked by one JAX forward over the prompt and
the port's tokens: the forward is causal, so each argmax there is the
token JAX's loop would pick at that step).  Each checkpoint's layout is
also the recurrent zoo's entry of its name (``bench/
recurrent_families.json``, the card's random models).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import test_hybrid
from _torch_recurrent import family_case
from vlut_tpu.models import hybrid as jh
from vlut_tpu_torch.cli import family_generate
from vlut_tpu_torch.models import hybrid as ph

CASES = {
    "jamba": test_hybrid.test_jamba_parity,
    "falcon_h1": test_hybrid.test_falcon_h1_parity,
    "falcon_h1_rmsnorm": test_hybrid.test_falcon_h1_rmsnorm_parity,
    "granite_hybrid": test_hybrid.test_granite_hybrid_parity,
    "lfm2": test_hybrid.test_lfm2_parity,
    "qwen3next": test_hybrid.test_qwen3next_dense_parity,
}


def hybrid_case(test_fn, nth, tmp_path, monkeypatch, zoo, generate=True):
    cfg_j, pj, cfg, model = family_case(test_fn, nth, tmp_path, monkeypatch,
                                        jh.forward, ph.forward, zoo=zoo)
    if generate:
        ids = [3, 14, 15, 9, 2]
        out = family_generate(model, cfg, ids, 5)
        lg = jh.forward(pj, cfg_j, jnp.asarray([ids + out[:-1]], jnp.int32))
        want = np.asarray(lg[0, len(ids) - 1:, :cfg.vocab_size]).argmax(-1)
        assert out == want.tolist()
    return cfg


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_matches_jax(name, tmp_path, monkeypatch):
    cfg = hybrid_case(CASES[name], 0, tmp_path, monkeypatch, name)
    assert cfg.arch.replace("_", "") in name.replace("_", "")
