"""The port's ``forward`` with an image's rows: ``token_embeds`` (with
``mrope_pos`` on qwen2/2.5-vl, an ``attn_mask`` on gemma3), qwen3vl's
``deepstack_embeds`` and cogvlm's ``visual_expert``, against the JAX
forward.

Each JAX test runs to its end with its ``forward`` calls recorded; the
port's forward then runs on a model built from the same parameter tree
with the same arguments (``_torch_vision.replay_forward``): logits within
2e-6 of the largest.  cogvlm's fused tree is held to the JAX package's
unfused visual pass (the JAX fused tree's is at fault, ROADMAP)."""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_vision import TOL_F32, recorded, replay_forward  # noqa: E402

torch.set_num_threads(1)

CASES = [
    ("test_vision", "test_multimodal_injection_changes_output"),
    ("test_vision_ext", "test_gemma3_vision_parity"),
    ("test_vision_ext", "test_pixtral_parity"),
    ("test_qwen2vl", "test_qwen2vl_image_parity"),
    ("test_qwen2vl", "test_qwen25vl_image_parity"),
    ("test_vision_wave3", "test_qwen3vl_deepstack_text_injection"),
    ("test_archs_wave5", "test_cogvlm_dual_expert"),
]
# what each case's forward calls must carry
CARRIES = {
    "test_multimodal_injection_changes_output": "token_embeds",
    "test_gemma3_vision_parity": "attn_mask",
    "test_pixtral_parity": "token_embeds",
    "test_qwen2vl_image_parity": "mrope_pos",
    "test_qwen25vl_image_parity": "mrope_pos",
    "test_qwen3vl_deepstack_text_injection": "deepstack_embeds",
    "test_cogvlm_dual_expert": "visual_expert",
}


@pytest.mark.parametrize("module,test", CASES,
                         ids=[t.removeprefix("test_") for _, t in CASES])
def test_forward_matches_jax(module, test, tmp_path, monkeypatch):
    """Every forward call of the JAX test, through the port's forward."""
    fn = getattr(importlib.import_module(module), test)
    calls = recorded(fn, tmp_path, monkeypatch, ("forward",))
    assert any(CARRIES[test] in kw for _, _, kw, _ in calls)
    replay_forward(calls, TOL_F32)


def test_cogvlm_fused_visual_pass_follows_the_unfused_reference(
        tmp_path, monkeypatch):
    """cogvlm's packed checkpoint: the port's visual pass, stacked and
    fused (its vis_* leaves fused into ``vis_wqkv`` / ``vis_w_gateup``),
    equals the JAX package's unfused visual pass (Pallas interpret) bit for
    bit, and its text pass the JAX text pass.  The JAX fused tree's visual
    pass runs the language qkv and gate|up beside the visual wo and down,
    which this records."""
    import jax
    import jax.numpy as jnp
    from _torch_archs import per_tensor_scales
    from _torch_convert import convert_both, jax_source

    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
    from vlut_tpu.models import transformer as jt
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import transformer as tt

    fn = importlib.import_module("test_archs_wave5").test_cogvlm_dual_expert
    src, kw = jax_source(fn, tmp_path, monkeypatch, 0)
    out = convert_both(src, tmp_path)
    cfg_j, pj, _ = jax_load(tmp_path / "conv_jax")
    pj = jax.tree.map(jnp.asarray, per_tensor_scales(pj))
    cfg, model, _ = load_checkpoint(out, device="cpu")
    fused = tt.fuse_projections(model, cfg)
    lp = fused.layers[0]
    assert "vis_wqkv" in lp.proj and "vis_w_gateup" in lp.proj
    toks = np.random.default_rng(0).integers(0, 64, (1, 7)).astype(np.int32)
    pos = np.arange(7, dtype=np.int32)[None]

    def jax_logits(params, vis):
        lg, _ = jt.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos),
                           None, impl="pallas_interpret", visual_expert=vis)
        return np.asarray(lg)

    for vis in (False, True):
        want = jax_logits(pj, vis)
        for m in (model, fused):
            with torch.inference_mode():
                got, _ = tt.forward(m, cfg, torch.from_numpy(toks).long(),
                                    torch.from_numpy(pos).long(), None,
                                    visual_expert=vis)
            np.testing.assert_array_equal(got.numpy(), want)
    text = jax_logits(pj, False)
    unfused_vis = jax_logits(pj, True)
    fused_vis = jax_logits(jt.fuse_projections(pj, cfg_j), True)
    gap = np.abs(fused_vis - unfused_vis).max() / np.abs(unfused_vis).max()
    assert gap > 0.1, gap  # the reference's fault, measured
    assert np.abs(unfused_vis - text).max() > 0.1 * np.abs(text).max()
