"""The port's converter on every JAX vision test's source: the text model,
the vision sidecars and the meta equal the JAX converter's array for
array (``_torch_convert.convert_both``, which compares every
``*.safetensors`` file of the two outputs); then the port's
``encode_image_auto`` over its own output equals the JAX one over the JAX
output on the same image, through whichever tower the checkpoint carries
(the sidecar loaders and the router held with the towers)."""

from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_convert import convert_both, jax_source  # noqa: E402
from _torch_vision import TOL_BF16, TOL_F32, compare  # noqa: E402

from vlut_tpu_torch.bench.vision_zoo import image_side  # noqa: E402

torch.set_num_threads(1)

# name -> (JAX test module, test, which convert_hf call, tower family the
# router names, or None for a text-side source)
SOURCES = {
    "llava": ("test_vision", "test_convert_llava_roundtrip", 0,
              "clip-llava"),
    "gemma3": ("test_vision_ext", "test_gemma3_vision_parity", 0,
               "gemma3-siglip"),
    "pixtral": ("test_vision_ext", "test_pixtral_parity", 0, "pixtral"),
    "internvl": ("test_vision_wave3", "test_internvl_vision_parity", 0,
                 "internvl"),
    "llama4": ("test_vision_wave3", "test_llama4_vision_parity", 0,
               "llama4-vision"),
    "idefics3": ("test_vision_wave3", "test_idefics3_parity", 0,
                 "idefics3"),
    "glm4v": ("test_vision_wave3", "test_glm4v_end_to_end_convert", 0,
              "glm4v"),
    "janus": ("test_vision_wave3", "test_janus_pro_parity", 0, "janus-pro"),
    "lfm2_vl": ("test_vision_wave3", "test_lfm2_vl_parity", 0, "lfm2-vl"),
    "mistral3_merger": ("test_vision_wave3",
                        "test_mistral3_patch_merger_parity", 0, "pixtral"),
    "qwen3vl": ("test_vision_wave3", "test_qwen3vl_vision_converter_route",
                0, "qwen3vl-deepstack"),
    "qwen3vl_deepstack": ("test_vision_wave3",
                          "test_qwen3vl_deepstack_text_injection", 0,
                          "qwen3vl-deepstack"),
    "qwen2vl": ("test_qwen2vl", "test_qwen2vl_image_parity", 0, "qwen-vl"),
    "qwen25vl": ("test_qwen2vl", "test_qwen25vl_image_parity", 0,
                 "qwen-vl"),
    "qwen3vl_text": ("test_qwen2vl", "test_qwen3vl_text_parity", 0,
                     "qwen3vl-deepstack"),
    "qwen3vl_moe": ("test_archs_wave4", "test_qwen3vl_moe_text_parity", 0,
                    "qwen3vl-deepstack"),
    "mistral3": ("test_archs_wave5", "test_mistral3_text_parity", 0,
                 "pixtral"),
    "cogvlm": ("test_archs_wave5", "test_cogvlm_dual_expert", 0, None),
}


def _convert(name, tmp_path, monkeypatch):
    mod, test, nth, _ = SOURCES[name]
    fn = getattr(importlib.import_module(mod), test)
    src, kw = jax_source(fn, tmp_path, monkeypatch, nth)
    return convert_both(src, tmp_path, config=name != "lfm2_vl", **kw)


@pytest.mark.parametrize("name", list(SOURCES))
def test_converted_equal_and_encoded_equal(name, tmp_path, monkeypatch):
    """Both converters' outputs equal (text model, sidecars, meta); the
    port's tower router over its output equals the JAX router over the
    JAX output on one seeded image (bf16 CLIP within two bf16 steps,
    float32 towers within 2e-6 of the largest output)."""
    from vlut_tpu.models.vision import encode_image_auto as jax_auto
    from vlut_tpu_torch.models.vision import encode_image_auto

    out = _convert(name, tmp_path, monkeypatch)
    family = SOURCES[name][3]
    meta = json.loads((out / "vlut_config.json").read_text())
    if family is None:
        assert encode_image_auto(out, np.zeros((4, 4, 3), np.float32),
                                 device="cpu") == (None, None)
        return
    side = image_side(meta)
    img = np.random.default_rng(3).random((side, side, 3)).astype(
        np.float32)
    want, fam_j = jax_auto(tmp_path / "conv_jax", img)
    with torch.inference_mode():
        got, fam_p = encode_image_auto(out, img, device="cpu")
    tol = TOL_BF16 if family == "clip-llava" else TOL_F32
    if isinstance(fam_j, tuple):
        assert fam_p[0] == fam_j[0] == family
        compare(list(fam_p[1]), list(fam_j[1]), tol, "deepstack")
    else:
        assert fam_p == fam_j == family
    compare(got, want, tol, family)
