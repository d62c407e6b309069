"""The port's family converters (``vlut_tpu_torch/convert/{encoder,gemma3n,
t5}.py``) against the JAX package's, on the JAX family tests' own sources:
bert, modernbert, neobert, nomic-bert and its MoE, jina-bert-v2,
jina-bert-v3's task LoRAs, gemma3n (flat and nested) and T5 (gated and
relu, tied and untied); and the refusal of lfm2-vl.

Each case converts one source with the JAX ``convert_hf`` and the port's
(on the CPU) and holds the checkpoints, the metadata, the tokenizer files
and the warnings equal (``_torch_convert.family_case``).
"""

import functools
import json

import numpy as np
import pytest

pytest.importorskip("transformers")

import test_archs_wave5  # noqa: E402
import test_encoder  # noqa: E402
import test_encoder_variants  # noqa: E402
import test_gemma3n  # noqa: E402
import test_t5  # noqa: E402
from _torch_convert import family_case, jax_source  # noqa: E402

from vlut_tpu_torch.convert import convert as pc  # noqa: E402
from vlut_tpu_torch.convert.checkpoint import (  # noqa: E402
    load_checkpoint,
    safetensors_arrays,
    write_safetensors,
)

# name -> (the JAX test, its converter, which call)
CASES = {
    "bert": (test_encoder.test_bert_parity, "convert_encoder", 0),
    "modernbert": (test_encoder.test_modernbert_parity, "convert_encoder",
                   0),
    "bert_server": (test_encoder.test_encoder_server, "convert_encoder", 0),
    "neobert": (test_archs_wave5.test_neobert_transcription, "convert_hf",
                0),
    "nomic_bert": (test_encoder_variants.test_nomic_bert_transcription,
                   "convert_encoder", 0),
    "nomic_bert_moe": (
        test_encoder_variants.test_nomic_bert_moe_transcription,
        "convert_encoder", 0),
    "jina_bert_v2": (test_encoder_variants.test_jina_bert_v2_transcription,
                     "convert_encoder", 0),
    "jina_bert_v3": (test_encoder_variants.test_jina_bert_v3_task_loras,
                     "convert_encoder", 0),
    "jina_bert_v3_second": (
        test_encoder_variants.test_jina_bert_v3_task_loras,
        "convert_encoder", 1),
    "gemma3n": (test_gemma3n.test_gemma3n_parity, "convert_gemma3n", 0),
    "gemma3n_altup3": (test_gemma3n.test_gemma3n_parity_altup3_no_shared,
                       "convert_gemma3n", 0),
    "t5_gated_tied": (functools.partial(test_t5.test_t5_parity, gated=True,
                                        tie=True), "convert_t5", 0),
    "t5_relu_untied": (functools.partial(test_t5.test_t5_parity,
                                         gated=False, tie=False),
                       "convert_t5", 0),
    "t5_generate": (test_t5.test_t5_generate_matches_hf, "convert_t5", 0),
}

FAMILY = {"gemma3n": "gemma3n", "t5": "t5"}


@pytest.mark.parametrize("name", list(CASES))
def test_family_converts_like_jax(name, tmp_path, monkeypatch):
    test_fn, converter, nth = CASES[name]
    out, _ = family_case(test_fn, tmp_path, monkeypatch, nth, converter)
    meta = load_checkpoint(out, device="cpu")[2]
    assert meta["model_family"] == FAMILY.get(name.split("_")[0], "encoder")


def _gemma3n_flat_names(src):
    """The source's tensors under plain ``model.`` names (HF saves
    Gemma3nForCausalLM under ``model.language_model.``, with
    ``per_layer_model_projection`` mangled by its substring rename)."""
    f = src / "model.safetensors"
    arrays = safetensors_arrays(f)
    assert ("model.language_model.per_layer_model.language_model_projection"
            ".weight") in arrays
    write_safetensors(f, {k.replace("model.language_model", "model"): v
                          for k, v in arrays.items()})


def _gemma3n_nested_config(src):
    """Gemma3nForConditionalGeneration's config (the text config under
    ``text_config``) with a vision tower's tensor beside the text model."""
    raw = json.loads((src / "config.json").read_text())
    (src / "config.json").write_text(json.dumps({
        "model_type": "gemma3n", "text_config": raw,
        "architectures": ["Gemma3nForConditionalGeneration"]}))
    f = src / "model.safetensors"
    arrays = safetensors_arrays(f)
    arrays["model.vision_tower.timm_model.patch.weight"] = np.ones(
        (2, 2), np.float32)
    write_safetensors(f, arrays)


@pytest.mark.parametrize("prepare", [_gemma3n_flat_names,
                                     _gemma3n_nested_config])
def test_gemma3n_layouts_convert_like_jax(prepare, tmp_path, monkeypatch):
    """Plain ``model.`` names and a nested text config convert to the
    checkpoint the saved layout gives; the vision tower is dropped."""
    out, said = family_case(test_gemma3n.test_gemma3n_parity, tmp_path,
                            monkeypatch, 0, "convert_gemma3n",
                            prepare=prepare)
    assert not said
    saved = tmp_path / "saved"
    saved.mkdir()
    src, _ = jax_source(test_gemma3n.test_gemma3n_parity, saved, monkeypatch,
                        0, "convert_gemma3n")
    pc.convert_hf(src, saved / "out", device="cpu")
    a = safetensors_arrays(out / "model.safetensors")
    b = safetensors_arrays(saved / "out" / "model.safetensors")
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("name", ["bert", "gemma3n", "t5_relu_untied"])
def test_bf16_family_source_equals_jax(name, tmp_path, monkeypatch):
    test_fn, converter, nth = CASES[name]
    family_case(test_fn, tmp_path, monkeypatch, nth, converter, bf16=True)


@pytest.mark.parametrize("name,module", [("bert", "encoder"),
                                         ("gemma3n", "gemma3n"),
                                         ("t5_gated_tied", "t5")])
def test_unrecognized_tensors_warn_like_jax(name, module, tmp_path,
                                            monkeypatch):
    test_fn, converter, nth = CASES[name]
    extra = {"encoder": ["mystery.weight", "encoder.layer.0.mystery.weight"],
             "gemma3n": ["model.mystery.weight",
                         "model.layers.0.mystery.weight"],
             "t5": ["mystery.weight",
                    "encoder.block.0.layer.0.mystery.weight"]}[module]
    _, said = family_case(test_fn, tmp_path, monkeypatch, nth, converter,
                          extra=extra)
    assert [n for n, _ in said] == [".convert." + module] * 2


def test_lfm2_vl_is_refused_before_writing(tmp_path, monkeypatch):
    """lfm2-vl (either spelling of its model type): its text side is the
    lfm2 hybrid and its siglip2 tower is written beside it, both equal to
    the JAX converter's, arrays, sidecar and meta."""
    import test_vision_wave3

    from _torch_convert import convert_both

    src, _ = jax_source(test_vision_wave3.test_lfm2_vl_parity, tmp_path,
                        monkeypatch)
    for mt in ("lfm2_vl", "lfm2-vl"):
        raw = json.loads((src / "config.json").read_text())
        raw["model_type"] = mt
        (src / "config.json").write_text(json.dumps(raw))
        out = convert_both(src, tmp_path / mt, config=False)
        meta = json.loads((out / "vlut_config.json").read_text())
        assert meta["model_family"] == "hybrid" and "lfm2vl_config" in meta
        assert (out / "lfm2vl.safetensors").exists()


@pytest.mark.parametrize("name", ["t5_generate", "neobert"])
def test_cli_convert_takes_the_families(name, tmp_path, monkeypatch):
    """``cli convert`` keeps its device rule for every family: with no
    ``--device`` it runs on the card, and without one raises, writing
    nothing; with ``--device cpu`` it writes what ``python -m
    vlut_tpu_torch.convert.convert`` writes."""
    import torch

    from vlut_tpu_torch import cli

    test_fn, converter, nth = CASES[name]
    src, _ = jax_source(test_fn, tmp_path, monkeypatch, nth, converter)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["convert", str(src), str(tmp_path / "a")])
    assert not (tmp_path / "a").exists()
    cli.main(["convert", str(src), str(tmp_path / "a"), "--device", "cpu"])
    pc.main([str(src), str(tmp_path / "b"), "--device", "cpu"])
    a = safetensors_arrays(tmp_path / "a" / "model.safetensors")
    b = safetensors_arrays(tmp_path / "b" / "model.safetensors")
    assert sorted(a) == sorted(b) and a
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
