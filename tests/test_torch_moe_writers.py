"""The port against the JAX package on the MoE models of the JAX tests'
transcription writers (``tests/test_archs_moe_wave.py``,
``test_archs_wave5.py``): HF-style checkpoints written from numpy for the
families without an installed HF implementation (bailingmoe, bailingmoe2,
phimoe, grok, arctic, grovemoe, deepseek v1, minimax-m2, smallthinker,
afmoe).

``_torch_archs.written_by`` runs a JAX test up to its first
``convert_hf`` (its writer and the JAX converter); ``checkpoint_case``
holds the port's forward against the JAX forward (``impl=
"pallas_interpret"``) on both trees, prefill and cached greedy decode,
within 2e-2 of the largest logit with identical greedy tokens.
"""

import pytest

import test_archs_moe_wave as moe_wave
import test_archs_wave5 as wave5
from _torch_archs import checkpoint_case, written_by

WRITERS = {
    "bailingmoe": moe_wave.test_bailingmoe_equals_ernie_moe,
    "bailingmoe2": moe_wave.test_bailingmoe2_equals_dots1,
    "phimoe": moe_wave.test_phimoe_equals_mixtral_ln,
    "grok": moe_wave.test_grok1_matches_reference_transcription,
    "arctic": moe_wave.test_arctic_matches_reference_transcription,
    "grovemoe": moe_wave.test_grovemoe_chunk_matches_reference_transcription,
    "deepseek_v1": wave5.test_deepseek_v1_transcription,
    "minimax_m2": wave5.test_minimax_m2_transcription,
    "smallthinker": wave5.test_smallthinker_transcription,
    "afmoe": wave5.test_afmoe_transcription,
}


@pytest.mark.parametrize("name", list(WRITERS))
def test_moe_writer_matches_jax(name, tmp_path, monkeypatch):
    cfg = checkpoint_case(written_by(WRITERS[name], tmp_path, monkeypatch))
    assert cfg.n_experts
