"""``bench/vision_zoo.py``, the card's vision families, on the CPU: its
families file is what the JAX vision tests' own sources and twin calls
give, each family runs its card-against-CPU check with the CPU as the card
(every file, tower and splice equal), and the full-width ``llava_1_5_7b``
preset is what the JAX converter makes of LLaVA-1.5-7B's config."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_vision  # noqa: E402

from vlut_tpu_torch.bench import vision_zoo as vz  # noqa: E402

torch.set_num_threads(1)


def test_families_file_is_the_jax_tests(tmp_path, monkeypatch):
    """``vision_families.json`` equals what the JAX tests give now (write
    it again with ``_torch_vision.write_families()`` after one changes)."""
    got = _torch_vision.families(tmp_path, monkeypatch)
    assert json.loads(json.dumps(got)) == vz.STRUCTURES


@pytest.mark.parametrize("name", vz.FAMILIES)
def test_family_runs_card_vs_cpu(name):
    """The card-against-CPU check with the CPU in the card's place: the two
    conversions equal, every tower function and the splice exact."""
    r = vz.card_vs_cpu(name, "cpu", seed=1)
    assert r["ok"], r
    assert all(e == 0.0 for e in r["tower_rel_err"].values()) if (
        "tower_rel_err" in r) else name == "cogvlm"
    if name in vz.SOURCES:
        assert (r["splice"] is None) == (name in vz.NO_SPLICE), r
    if r.get("splice"):
        assert r["splice"]["max_rel_layer_err"] == 0.0
        assert r["splice"]["greedy_equal"]


@pytest.mark.parametrize("name,no_splice", [
    ("glm4v", {k: v for k, v in vz.NO_SPLICE.items() if k != "glm4v"}),
    ("llava", {**vz.NO_SPLICE, "llava": "a splice that should not run"}),
])
def test_an_unexpected_splice_skip_fails(name, no_splice, monkeypatch):
    """A source that skips its splice without being named in
    ``NO_SPLICE``, or is named there and runs it, is not ok."""
    monkeypatch.setattr(vz, "NO_SPLICE", no_splice)
    r = vz.card_vs_cpu(name, "cpu", seed=1)
    assert not r["ok"], r


def test_llava_1_5_7b_preset_is_the_converters(tmp_path):
    """``PRESETS["llava_1_5_7b"]`` is the JAX converter's ``config_from_hf``
    of llava-hf/llava-1.5-7b-hf's config.json (written here), and the
    phase's tower config its ``_convert_vision_tower`` fields."""
    from vlut_tpu.convert.convert import config_from_hf as jax_cfg
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.convert.convert import config_from_hf

    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["LlavaForConditionalGeneration"],
        "model_type": "llava", "image_token_index": 32000,
        "vision_feature_layer": -2,
        "vision_feature_select_strategy": "default",
        "projector_hidden_act": "gelu",
        "text_config": {
            "model_type": "llama", "vocab_size": 32064, "hidden_size": 4096,
            "num_hidden_layers": 32, "num_attention_heads": 32,
            "num_key_value_heads": 32, "intermediate_size": 11008,
            "rms_norm_eps": 1e-5, "max_position_embeddings": 4096,
            "rope_theta": 10000.0, "tie_word_embeddings": False},
        "vision_config": {
            "model_type": "clip_vision_model", "hidden_size": 1024,
            "num_hidden_layers": 24, "num_attention_heads": 16,
            "intermediate_size": 4096, "image_size": 336, "patch_size": 14,
            "projection_dim": 768, "hidden_act": "quick_gelu"},
    }))
    want = dataclasses.asdict(jax_cfg(tmp_path))
    assert dataclasses.asdict(config_from_hf(tmp_path)) == want
    assert dataclasses.asdict(PRESETS["llava_1_5_7b"]) == want
    vcfg, cfg = vz.llava_1_5_7b()
    assert cfg is PRESETS["llava_1_5_7b"]
    assert (vcfg.image_size, vcfg.patch_size, vcfg.d_model, vcfg.n_layers,
            vcfg.n_heads, vcfg.d_ff, vcfg.d_llm, vcfg.feature_layer,
            vcfg.select_feature, vcfg.n_patches) == (
        336, 14, 1024, 24, 16, 4096, 4096, -2, "patch", 576)
