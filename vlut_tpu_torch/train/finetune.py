"""The float twin of a packed checkpoint (port of
``vlut_tpu/train/finetune.py:float_twin_params``; the rest of that module,
the trainer, is not ported yet: ROADMAP Queue 1 item 9).

Each packed projection becomes a ``{"dense": (K, N)}`` leaf holding its
trits times its scale, at the spec's padded widths so the forward's shapes
stay the same; the forward multiplies such leaves as plain float products
(``models/transformer.py:DenseLinear``).  ``cli generate`` runs a diffusion
checkpoint on this twin, as the JAX CLI does.
"""

from __future__ import annotations

from typing import Any

import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import (
    TernarySpec, TransformerLM, layer_specs)
from vlut_tpu_torch.ops.packing import TernaryTensor, unpack_ternary


def _dense(packed: torch.Tensor, scale: torch.Tensor, spec: TernarySpec,
           dtype) -> torch.Tensor:
    """One (K, N) packed projection -> trits * scale (float32, exact), then
    ``dtype``."""
    one = torch.ones((), dtype=torch.float32, device=packed.device)
    w = unpack_ternary(TernaryTensor(packed, one, spec.k, spec.n, spec.fmt,
                                     spec.kb), dtype=torch.float32)
    s = scale.to(torch.float32)
    if s.dim():
        s = s[:spec.n]
    return (w * s).to(dtype)


def _twin(packed: torch.Tensor, scale: torch.Tensor, spec: TernarySpec,
          lead: int, dtype) -> torch.Tensor:
    """A stack of ``lead`` leading dims (layers, experts) unpacked one
    matrix at a time."""
    if lead == 0:
        return _dense(packed, scale, spec, dtype)
    return torch.stack([_twin(packed[i], scale[i], spec, lead - 1, dtype)
                        for i in range(packed.shape[0])])


def _twin_layer(lp: dict[str, Any], specs: dict[str, TernarySpec],
                dtype) -> dict[str, Any]:
    """A layer tree (or the stacked tree) with each packed leaf twinned:
    its leading dims (layers, experts) are those before the (Kp/r, Np)
    bytes."""
    out: dict[str, Any] = {}
    for name, val in lp.items():
        if not isinstance(val, dict) or "packed" not in val:
            out[name] = val  # vectors and already-dense leaves
            continue
        out[name] = {"dense": _twin(val["packed"], val["scale"], specs[name],
                                    val["packed"].dim() - 2, dtype)}
    return out


def float_twin_params(model_or_tree, cfg: ModelConfig,
                      dtype=torch.float32) -> TransformerLM:
    """Packed model (or checkpoint tree) -> the model over its dense twin:
    every packed projection (experts included) a ``{"dense": ...}`` leaf of
    ``dtype``, padded widths preserved; every other tensor as it is."""
    tree = (model_or_tree.tree() if isinstance(model_or_tree, TransformerLM)
            else model_or_tree)
    layers = tree["layers"]
    if isinstance(layers, (list, tuple)):
        twin = [_twin_layer(lp, layer_specs(cfg, i, moe="router" in lp),
                            dtype) for i, lp in enumerate(layers)]
    else:
        twin = _twin_layer(layers, layer_specs(cfg, moe="router" in layers),
                           dtype)
    return TransformerLM(cfg, {**tree, "layers": twin})
