"""Build the port's model from a JAX parameter tree held as numpy arrays.

Used by the tests, so that the JAX package and the port compute on identical
weights: ``params_from_numpy(jax.tree.map(np.asarray, params), cfg)``.
bfloat16 numpy arrays (ml_dtypes) are carried bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import TransformerLM


def to_tensor(a) -> torch.Tensor:
    # np.array keeps 0-d scalars 0-d (np.ascontiguousarray makes them 1-d,
    # which would turn a per-tensor scale into a one-channel one)
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(node) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v) for v in node]
    return to_tensor(node)


def params_from_numpy(params_np: dict[str, Any], cfg,
                      device: str | torch.device = "cpu"):
    """JAX params tree (stacked or unstacked layers, fused or not, bf16 or
    int8 head) -> TransformerLM on ``device``; a Mamba / Mamba2, RWKV,
    hybrid, encoder, T5 or gemma3n config's tree -> its family's model
    (``convert.checkpoint.model_from_tree``)."""
    tree = _convert(params_np)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return node.to(device)

    if isinstance(cfg, ModelConfig):
        return TransformerLM(cfg, move(tree))
    from vlut_tpu_torch.convert.checkpoint import model_from_tree

    return model_from_tree(cfg, move(tree))


def tower_from_numpy(params_np: dict[str, Any],
                     device: str | torch.device = "cpu") -> dict[str, Any]:
    """A JAX tower's parameter tree (dicts and lists of numpy arrays, bf16
    carried bit for bit) -> the same tree of tensors on ``device``: a
    vision tower (``models/vision*.py``), an audio encoder
    (``models/audio.py``) or a vocoder, whose ``posnet`` and ``convnext``
    are lists of blocks (``models/vocoder.py``)."""
    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [move(v) for v in node]
        return to_tensor(node).to(device)

    return move(params_np)
