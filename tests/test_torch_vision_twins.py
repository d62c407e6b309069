"""The port's towers and projectors that the JAX package holds against
twins only (Kimi-VL, MobileVLM's LDP / LDPv2, GLM-Edge, CogVLM's EVA2-CLIP
tower and adapter, Youtu-VL), Qwen3-VL's tower against HF, and GLM4-V's
tower against its transcription, against the JAX package's
(``models/vision_wave3.py``): each JAX test runs to its end with its tower
calls recorded and the port's function runs on the same parameters and
inputs, within 2e-6 of the largest output (``_torch_vision``)."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_vision import tower_case  # noqa: E402

torch.set_num_threads(1)

CASES = [
    ("test_vision_wave3", "test_kimivl_twin"),
    ("test_vision_wave3", "test_ldp_and_ldpv2_twins"),
    ("test_vision_wave3", "test_glm_edge_adapter_twin"),
    ("test_vision_wave3", "test_cogvlm_vision_twin"),
    ("test_vision_wave3", "test_youtuvl_vision_twin"),
    ("test_vision_wave3", "test_qwen3vl_deepstack_vision_parity"),
    ("test_vision_wave3", "test_glm4v_vision_parity"),
]


@pytest.mark.parametrize("module,test", CASES,
                         ids=[t.removeprefix("test_") for _, t in CASES])
def test_tower_matches_jax(module, test, tmp_path, monkeypatch):
    """Every tower and projector call of the JAX test, through the port."""
    assert tower_case(module, test, tmp_path, monkeypatch)
