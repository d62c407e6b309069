"""The encoder half's card families (``vlut_tpu_torch/bench/
encoder_zoo.py``) and the JAX test checkpoints they copy
(``bench/encoder_families.json``).

:func:`structures` runs each JAX test up to its checkpoint and returns
every family's converter layout (family, config, tensor shapes); the zoo
test holds the data file equal to it.  To write the file again after a
converter's layout changes::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \\
        import _torch_encoder as e; e.write()"
"""

from __future__ import annotations

import json
import pathlib
import tempfile

import pytest

import test_archs_clones2
import test_archs_wave5
import test_encoder
import test_encoder_variants
import test_gemma3n
import test_t5
from _torch_recurrent import loaded_by, structure

DATA = (pathlib.Path(__file__).resolve().parents[1] / "vlut_tpu_torch" /
        "bench" / "encoder_families.json")


def _t5(gated, tie):
    def case(tp):
        test_t5._mk(tp, gated=gated, tie=tie)
    case.__module__ = test_t5.__name__
    return case


CASES = {
    "bert": test_encoder.test_bert_parity,
    "modernbert": test_encoder.test_modernbert_parity,
    "neobert": test_archs_wave5.test_neobert_transcription,
    "nomic-bert": test_encoder_variants.test_nomic_bert_transcription,
    "nomic-bert-moe": test_encoder_variants.test_nomic_bert_moe_transcription,
    "jina-bert-v2": test_encoder_variants.test_jina_bert_v2_transcription,
    "jina-bert-v3": test_encoder_variants.test_jina_bert_v3_task_loras,
    "t5_gated": _t5(True, True),
    "t5_relu": _t5(False, False),
    "gemma3n": test_gemma3n.test_gemma3n_parity,
}


def structures(tmp_path, monkeypatch) -> dict:
    out = {}
    for name, fn in CASES.items():
        out[name] = structure(loaded_by(fn, tmp_path / name, monkeypatch))
    # llada_moe: the JAX test converts it last (its checkpoint out_l)
    test_archs_clones2.test_llada_moe_equals_qwen3_moe_bidirectional(
        tmp_path / "llada_moe")
    out["llada_moe"] = structure(tmp_path / "llada_moe" / "out_l")
    return out


def write() -> None:
    with tempfile.TemporaryDirectory() as d, pytest.MonkeyPatch.context() \
            as mp:
        data = structures(pathlib.Path(d), mp)
    DATA.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
