"""The port's CLIP / llava, SigLIP / gemma3, pixtral, MiniCPM-V and
Qwen2/2.5-VL towers against the JAX package's (``models/vision.py``,
``vision_ext.py``, ``qwen_vision.py``).

Each JAX vision test runs to its end with its tower calls recorded
(``_torch_vision.tower_case``); the port's function of the same name then
runs on the same parameters and inputs: float32 towers within 2e-6 of the
largest output, the bf16 CLIP path within two bf16 steps.  The helpers
(patchify, preprocessing, M-RoPE positions, the splice, random weights)
are held equal to JAX's outright.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_vision import TOL_F32, compare, tower_case  # noqa: E402

torch.set_num_threads(1)

CASES = [
    ("test_vision", "test_encoder_shapes_finite"),
    ("test_vision", "test_multimodal_injection_changes_output"),
    ("test_vision", "test_convert_llava_roundtrip"),
    ("test_vision", "test_mlp_norm_projector_variant"),
    ("test_vision_ext", "test_gemma3_vision_parity"),
    ("test_vision_ext", "test_pixtral_parity"),
    ("test_vision_ext", "test_minicpmv_resampler_torch_reference"),
    ("test_qwen2vl", "test_qwen2vl_image_parity"),
    ("test_qwen2vl", "test_qwen25vl_image_parity"),
]


@pytest.mark.parametrize("module,test", CASES,
                         ids=[t.removeprefix("test_") for _, t in CASES])
def test_tower_matches_jax(module, test, tmp_path, monkeypatch):
    """Every tower and projector call of the JAX test, through the port."""
    calls = tower_case(module, test, tmp_path, monkeypatch)
    assert calls


def test_init_params_and_encode_equal_jax():
    """``init_params`` draws the JAX package's bf16 weights bit for bit;
    ``encode_image`` on them is the JAX tower's within two bf16 steps, for
    the llava feature layer -2 and for the last layer with CLS kept."""
    import jax.numpy as jnp

    from vlut_tpu.models import vision as jv
    from vlut_tpu_torch.models import vision as pv

    for kw in ({}, {"feature_layer": -1, "select_feature": "cls_patch"}):
        jc = jv.VisionConfig(image_size=32, patch_size=8, d_model=64,
                             n_layers=3, n_heads=4, d_ff=96, d_llm=48, **kw)
        pc = pv.VisionConfig(**jc.__dict__)
        jp = jv.init_params(jc, seed=4)
        pp = pv.init_params(pc, seed=4)
        flat_j = {**{f"layers.{k}": v for k, v in jp["layers"].items()},
                  **{k: v for k, v in jp.items() if k != "layers"}}
        flat_p = {**{f"layers.{k}": v for k, v in pp["layers"].items()},
                  **{k: v for k, v in pp.items() if k != "layers"}}
        assert sorted(flat_j) == sorted(flat_p)
        for k, v in flat_j.items():
            a = np.asarray(v.astype(jnp.float32))
            b = flat_p[k].float().numpy()
            assert str(v.dtype) == str(flat_p[k].dtype).removeprefix(
                "torch."), k
            np.testing.assert_array_equal(a, b, err_msg=k)
        img = np.random.default_rng(1).standard_normal(
            (2, 32, 32, 3)).astype(np.float32)
        want = jv.encode_image(jp, jc, jnp.asarray(img))
        with torch.inference_mode():
            got = pv.encode_image(pp, pc, torch.from_numpy(img))
        compare(got, want, 2 ** -7, "encode_image")


def test_patchify_preprocess_and_splice_equal_jax():
    """patchify (both towers' forms), the CLIP / family preprocessing of
    an array and ``build_multimodal_embeds`` equal the JAX package's."""
    import jax
    import jax.numpy as jnp

    from vlut_tpu.config import PRESETS
    from vlut_tpu.models import qwen_vision as jq
    from vlut_tpu.models import transformer as jt
    from vlut_tpu.models import vision as jv
    from vlut_tpu_torch.convert.from_jax import params_from_numpy
    from vlut_tpu_torch.config import PRESETS as PP
    from vlut_tpu_torch.models import qwen_vision as pq
    from vlut_tpu_torch.models import vision as pv

    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jv.patchify(jnp.asarray(img), 8)),
        pv.patchify(torch.from_numpy(img), 8).numpy())
    arr = rng.random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(jv.preprocess_image(arr, 8),
                                  pv.preprocess_image(arr, 8))
    np.testing.assert_array_equal(
        jv._load_rgb(arr, 8, jv._IMAGENET_MEAN, jv._IMAGENET_STD),
        pv._load_rgb(arr, 8, pv._IMAGENET_MEAN, pv._IMAGENET_STD))
    qc = dict(depth=1, embed_dim=16, n_heads=2, mlp_dim=32, patch_size=4,
              temporal_patch_size=2, spatial_merge_size=2)
    px = rng.standard_normal((3, 16, 24)).astype(np.float32)
    a, ga = jq.patchify(px, jq.QwenVisionConfig(**qc))
    b, gb = pq.patchify(px, pq.QwenVisionConfig(**qc))
    np.testing.assert_array_equal(a, b)
    assert ga == gb
    for args in ((3, (4, 6), 2, 5), (0, (8, 4), 2, 0), (2, (6, 6), 3, 1)):
        np.testing.assert_array_equal(jq.mrope_positions(*args),
                                      pq.mrope_positions(*args))
    cfg = PRESETS["tiny"]
    jp = jt.init_params(cfg, seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), PP["tiny"])
    emb = rng.standard_normal((4, cfg.d_model)).astype(np.float32)
    for pre, suf in (([3, 5], [7, 9, 11]), ([], [2]), ([1], [])):
        want = jv.build_multimodal_embeds(jp, jnp.asarray(emb), pre, suf)
        got = pv.build_multimodal_embeds(model, torch.from_numpy(emb), pre,
                                         suf)
        assert str(got.dtype) == "torch." + str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_window_order_equal_jax():
    """qwen2.5-vl's window reorder with ragged edge windows (a grid that is
    no multiple of the window) equals the JAX package's."""
    from vlut_tpu.models import qwen_vision as jq
    from vlut_tpu_torch.models import qwen_vision as pq

    for grid, win in (((12, 20), 16), ((8, 8), 8), ((4, 12), 16)):
        kw = dict(depth=1, embed_dim=16, n_heads=2, mlp_dim=32, patch_size=2,
                  spatial_merge_size=2, window_size=win)
        oj, sj = jq._window_order(grid, jq.QwenVisionConfig(**kw))
        op, sp = pq._window_order(grid, pq.QwenVisionConfig(**kw))
        np.testing.assert_array_equal(oj, op)
        np.testing.assert_array_equal(sj, sp)


def test_qwen25_ragged_windows_match_jax():
    """A qwen2.5-vl tower whose grid leaves ragged windows, with one full-
    attention block, through both packages (random float32 weights)."""
    import jax
    import jax.numpy as jnp

    from vlut_tpu.models import qwen_vision as jq
    from vlut_tpu_torch.convert.from_jax import tower_from_numpy
    from vlut_tpu_torch.models import qwen_vision as pq

    rng = np.random.default_rng(7)
    kw = dict(depth=3, embed_dim=32, n_heads=4, mlp_dim=48, patch_size=2,
              temporal_patch_size=2, spatial_merge_size=2, out_dim=24,
              rms_norm=True, gated_mlp=True, window_size=8,
              fullatt_blocks=(1,))
    d, f, L = 32, 48, 3
    t = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa
    params = {
        "patch_w": t(3 * 2 * 2 * 2, d), "merge_ln_w": 1 + t(d),
        "merge_w1": t(4 * d, 4 * d), "merge_b1": t(4 * d),
        "merge_w2": t(4 * d, 24), "merge_b2": t(24),
        "layers": {"ln1_w": 1 + t(L, d), "ln2_w": 1 + t(L, d),
                   "wqkv": t(L, d, 3 * d), "bqkv": t(L, 3 * d),
                   "wo": t(L, d, d), "bo": t(L, d),
                   "w_gate": t(L, d, f), "b_gate": t(L, f),
                   "w1": t(L, d, f), "b1": t(L, f),
                   "w2": t(L, f, d), "b2": t(L, d)},
    }
    px = rng.standard_normal((3, 20, 12)).astype(np.float32)
    patches, grid = jq.patchify(px, jq.QwenVisionConfig(**kw))
    want = jq.vision_forward(
        jax.tree.map(jnp.asarray, params),
        jq.QwenVisionConfig(**kw), jnp.asarray(patches), grid)
    with torch.inference_mode():
        got = pq.vision_forward(tower_from_numpy(params),
                                pq.QwenVisionConfig(**kw),
                                torch.from_numpy(patches), grid)
    compare(got, want, TOL_F32, "qwen2.5 ragged windows")
