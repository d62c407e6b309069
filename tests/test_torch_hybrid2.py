"""The port's hybrid SSM + attention LMs against the JAX package on the
CPU, second half of the cases (the first is ``test_torch_hybrid.py``):
qwen3-next with its sparse block (``tests/test_hybrid.py``), nemotron-h
(all mamba2 layers, and mamba2 with attention: the zoo's
``nemotron_h``), plamo2, lfm2moe and
nemotron-h-moe (the checkpoints their JAX tests write from numpy,
``tests/test_hybrid.py`` and ``test_archs_wave6.py``).  Logits within 2e-2
of the largest, greedy tokens equal, the greedy ``generate`` loop JAX's.
"""

import pytest

import test_archs_wave6
import test_hybrid
from test_torch_hybrid import hybrid_case
from vlut_tpu_torch.bench.recurrent_zoo import STRUCTURES

# (JAX test, which of its load_checkpoint calls)
CASES = {
    "qwen3next_moe": (test_hybrid.test_qwen3next_moe_parity, 0),
    "nemotron_h_mamba": (test_hybrid.test_nemotron_h_mamba_twin, 0),
    "nemotron_h": (test_hybrid.test_nemotron_h_mamba_twin, 2),
    "plamo2": (test_hybrid.test_plamo2_transcription, 0),
    "lfm2moe": (test_archs_wave6.test_lfm2moe_parity, 0),
    "nemotron_h_moe": (test_archs_wave6.test_nemotron_h_moe_transcription,
                       0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_matches_jax(name, tmp_path, monkeypatch):
    test_fn, nth = CASES[name]
    cfg = hybrid_case(test_fn, nth, tmp_path, monkeypatch,
                      name if name in STRUCTURES else None)
    kinds = set(cfg.layer_types) | set(cfg.ffn_types)
    assert {"qwen3next_moe": "moe_qwen", "nemotron_h_mamba": "mamba2",
            "nemotron_h": "attention", "plamo2": "plamo2_mamba",
            "lfm2moe": "moe", "nemotron_h_moe": "ffn"}[name] in kinds
