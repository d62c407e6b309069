"""The port's InternVL, Llama4, Idefics3, GLM4-V, Janus-Pro, LFM2-VL,
Qwen3-VL (DeepStack) and mistral3 towers against the JAX package's
(``models/vision_wave3.py``, ``vision_ext.py``), and the positions taken
off the native grid (GLM4-V's and Kimi-VL's bicubic resize, Qwen3-VL's
bilinear one).

Each JAX vision test runs to its end with its tower calls recorded; the
port's function of the same name then runs on the same parameters and
inputs, within 2e-6 of the largest output (``_torch_vision``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_vision import (TOL_F32, compare, recorded, to_torch,  # noqa
                           tower_case)

torch.set_num_threads(1)

CASES = [
    ("test_vision_wave3", "test_internvl_vision_parity"),
    ("test_vision_wave3", "test_llama4_vision_parity"),
    ("test_vision_wave3", "test_idefics3_parity"),
    ("test_vision_wave3", "test_glm4v_end_to_end_convert"),
    ("test_vision_wave3", "test_janus_pro_parity"),
    ("test_vision_wave3", "test_lfm2_vl_parity"),
    ("test_vision_wave3", "test_mistral3_patch_merger_parity"),
    ("test_vision_wave3", "test_qwen3vl_vision_converter_route"),
]


@pytest.mark.parametrize("module,test", CASES,
                         ids=[t.removeprefix("test_") for _, t in CASES])
def test_tower_matches_jax(module, test, tmp_path, monkeypatch):
    """Every tower and projector call of the JAX test, through the port."""
    assert tower_case(module, test, tmp_path, monkeypatch)


# the JAX test whose recorded call is re-run off its native grid, and the
# call's grid argument index
OFF_GRID = {
    "glm4v_vision_forward": ("test_glm4v_vision_parity", 3),
    "qwen3vl_vision_forward": ("test_qwen3vl_deepstack_vision_parity", 3),
    "kimivl_forward": ("test_kimivl_twin", None),
}


@pytest.mark.parametrize("name", list(OFF_GRID))
def test_off_native_grid_matches_jax(name, tmp_path, monkeypatch):
    """The tower's recorded call on its native grid, then the same weights
    on a grid the learned positions must be resized to (GLM4-V and
    Kimi-VL: ``jax.image.resize`` bicubic, antialiased where it shrinks;
    Qwen3-VL: bilinear), larger and smaller, through both packages."""
    import importlib

    import jax.numpy as jnp

    test, gi = OFF_GRID[name]
    calls = [c for c in recorded(
        getattr(importlib.import_module("test_vision_wave3"), test),
        tmp_path, monkeypatch, (name,)) if c[0] == name]
    _, args, kw, want = calls[0]
    fn_j = getattr(importlib.import_module("vlut_tpu.models.vision_wave3"),
                   name)
    fn_p = getattr(importlib.import_module(
        "vlut_tpu_torch.models.vision_wave3"), name)
    with torch.inference_mode():
        compare(fn_p(*to_torch(args)), want, TOL_F32, name)
    rng = np.random.default_rng(11)
    cfg = args[1]
    for scale in (2, 0.5):
        if gi is None:  # an image (B, H, W, 3)
            b, h, w, c = args[2].shape
            p = cfg.patch_size
            hw = (max(int(h * scale) // p, 1) * p,
                  max(int(w * scale * 1.5) // p, 1) * p)
            x = rng.standard_normal((b, *hw, c)).astype(np.float32)
            new = (args[0], cfg, jnp.asarray(x))
        else:  # merge-block-major patch rows and their grid
            m = cfg.merge
            gh, gw = args[gi]
            grid = (max(int(gh * scale) // m, 1) * m,
                    max(int(gw * scale) // m, 1) * m + 2 * m)
            rows = rng.standard_normal(
                (grid[0] * grid[1], args[2].shape[1])).astype(np.float32)
            new = (args[0], cfg, jnp.asarray(rows), grid)
        want = fn_j(*new)
        with torch.inference_mode():
            got = fn_p(*to_torch(new))
        compare(got, want, TOL_F32, f"{name} at {scale}x")
