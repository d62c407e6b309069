"""The port's family converters (``vlut_tpu_torch/convert/{rwkv,hybrid}.py``)
against the JAX package's, on the JAX family tests' own sources: RWKV7,
ARWKV-7, RWKV6 and every SSM hybrid (jamba, falcon-h1, granite-hybrid,
lfm2, lfm2-moe, qwen3-next, nemotron-h and its MoE, plamo2).

Each case runs a JAX test up to the conversion it makes
(``_torch_convert.jax_source``), copies tiny_real's tokenizer files beside
the source, and converts it with the JAX ``convert_hf`` and the port's (on
the CPU): the two checkpoints must be equal array for array, the
``vlut_config.json`` files equal, the tokenizer files equal byte for byte
and the converters' warnings the same (``_torch_convert.family_case``).
"""

import pytest

pytest.importorskip("transformers")

import test_archs_wave6  # noqa: E402
import test_hybrid  # noqa: E402
import test_rwkv7  # noqa: E402
from _torch_convert import family_case  # noqa: E402

from vlut_tpu_torch.convert.checkpoint import load_checkpoint  # noqa: E402

# name -> (the JAX test, its converter, which call)
CASES = {
    "rwkv7": (test_rwkv7.test_rwkv7_forward_and_state_carry,
              "convert_rwkv7", 0),
    "arwkv7": (test_rwkv7.test_arwkv7_forward_and_state_carry,
               "convert_hf", 0),
    "rwkv6": (test_rwkv7.test_rwkv6_forward_and_state_carry,
              "convert_rwkv6", 0),
    "jamba": (test_hybrid.test_jamba_parity, "convert_hybrid", 0),
    "falcon_h1": (test_hybrid.test_falcon_h1_parity, "convert_hybrid", 0),
    "falcon_h1_rmsnorm": (test_hybrid.test_falcon_h1_rmsnorm_parity,
                          "convert_hybrid", 0),
    "granite_hybrid": (test_hybrid.test_granite_hybrid_parity,
                       "convert_hybrid", 0),
    "lfm2": (test_hybrid.test_lfm2_parity, "convert_hybrid", 0),
    "qwen3next": (test_hybrid.test_qwen3next_dense_parity,
                  "convert_hybrid", 0),
    "qwen3next_moe": (test_hybrid.test_qwen3next_moe_parity,
                      "convert_hybrid", 0),
    "nemotron_h": (test_hybrid.test_nemotron_h_mamba_twin, "convert_hf", 0),
    "nemotron_h_mixed": (test_hybrid.test_nemotron_h_mamba_twin,
                         "convert_hf", 2),
    "plamo2": (test_hybrid.test_plamo2_transcription, "convert_hf", 0),
    "lfm2moe": (test_archs_wave6.test_lfm2moe_parity, "convert_hybrid", 0),
    "lfm2moe_dense_twin": (test_archs_wave6.test_lfm2moe_parity,
                           "convert_hybrid", 1),
    "nemotron_h_moe": (test_archs_wave6.test_nemotron_h_moe_transcription,
                       "convert_hf", 0),
}

FAMILY = {"rwkv7": "rwkv7", "arwkv7": "rwkv7", "rwkv6": "rwkv6"}


@pytest.mark.parametrize("name", list(CASES))
def test_family_converts_like_jax(name, tmp_path, monkeypatch):
    test_fn, converter, nth = CASES[name]
    out, _ = family_case(test_fn, tmp_path, monkeypatch, nth, converter)
    meta = load_checkpoint(out, device="cpu")[2]
    assert meta["model_family"] == FAMILY.get(name, "hybrid")


@pytest.mark.parametrize("name", ["rwkv7", "jamba", "qwen3next_moe"])
def test_bf16_family_source_equals_jax(name, tmp_path, monkeypatch):
    """The same sources stored in BF16: the port reads them without
    ml_dtypes, and its checkpoint equals the JAX converter's."""
    test_fn, converter, nth = CASES[name]
    family_case(test_fn, tmp_path, monkeypatch, nth, converter, bf16=True)


# tensors no converter maps: one outside the layers, one inside
UNKNOWN = {"rwkv7": ["model.mystery.weight", "model.layers.0.mystery.weight"],
           "jamba": ["model.mystery.weight", "model.layers.1.mamba.mystery",
                     "model.layers.0.mystery.weight"],
           "plamo2": ["model.layers.layers.0.mixer.mystery.weight"]}


@pytest.mark.parametrize("name", list(UNKNOWN))
def test_unrecognized_tensors_warn_like_jax(name, tmp_path, monkeypatch):
    """A tensor the converter does not map is skipped with the JAX
    converter's warning, under the port's logger of the same module."""
    test_fn, converter, nth = CASES[name]
    _, said = family_case(test_fn, tmp_path, monkeypatch, nth, converter,
                          extra=UNKNOWN[name])
    module = ".convert." + ("rwkv" if name.startswith("rwkv") else "hybrid")
    assert len(said) == len(UNKNOWN[name])
    assert {n for n, _ in said} == {module}
