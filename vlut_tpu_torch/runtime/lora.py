"""Runtime LoRA adapters and control vectors (port of vlut_tpu/runtime/lora.py).

An adapter is ``{"layers": {wname: {"a": (L, K, r), "b": (L, r, N)}},
"alpha": float, "r": int}``; applied, each covered projection adds
``scale * (x @ A) @ B`` to its ternary product, with ``scale = alpha / r *
user_scale``.  The packed ternary base cannot absorb the delta without
requantizing, so the adapter stays two thin bf16 products beside the base
GEMM (``models/transformer.py:TernaryLinear``).  A and B are padded to the
base weights' layouts (``models/dims.py``), so the delta lands in the same
coordinates as the packed projection.

A control vector is one (d_model,) direction per layer added to the
residual after the layer.

:func:`apply_lora` and :func:`apply_cvector` return a new model whose layer
trees carry the adapter; apply them before ``Engine`` fuses the tree (a
LoRA on wq/wk/wv/w_gate/w_up keeps it unfused).
"""

from __future__ import annotations

import json
import pathlib
import re
import struct
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.convert.checkpoint import safetensors_arrays
from vlut_tpu_torch.models.dims import (
    make_plan,
    pad_heads_cols,
    pad_heads_rows,
    scatter_cols,
    scatter_rows,
)
from vlut_tpu_torch.models.transformer import StackedLayers, TransformerLM

# HF PEFT module names -> the port's weight names
_PEFT_MAP = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}
_PEFT_KEY = re.compile(
    r"(?:base_model\.model\.)?model\.layers\.(\d+)\."
    r"(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight")


def _float32(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "BF16":  # stored as uint16 by safetensors_arrays
        return (a.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def _read(path: pathlib.Path) -> dict[str, np.ndarray]:
    """name -> float32 array of a safetensors file (BF16 widened)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return {name: _float32(a, header[name]["dtype"])
            for name, a in safetensors_arrays(path).items()}


def load_peft_adapter(path: str | pathlib.Path, cfg,
                      dtype=torch.bfloat16) -> dict[str, Any]:
    """Load a HF PEFT LoRA directory (``adapter_config.json`` + its
    ``*.safetensors``) into an adapter dict on the CPU.  B's columns for
    wq/wk/wv go through the rope-aware head permutation and w_gate/w_up's
    through the chunk scatter; A's rows for wo go through the head padding
    and the chunk scatter, and w_down's through the chunk scatter."""
    path = pathlib.Path(path)
    acfg = json.loads((path / "adapter_config.json").read_text())
    alpha = float(acfg.get("lora_alpha", 16))
    r = int(acfg.get("r", acfg.get("lora_rank", 8)))
    plan = make_plan(cfg)
    per: dict[str, dict[int, dict[str, np.ndarray]]] = {}
    for f in sorted(path.glob("*.safetensors")):
        for name, w in _read(f).items():
            m = _PEFT_KEY.match(name)
            if not m or m.group(2) not in _PEFT_MAP:
                continue
            per.setdefault(_PEFT_MAP[m.group(2)], {}).setdefault(
                int(m.group(1)), {})[m.group(3)] = w

    def pad_b(wname: str, b: np.ndarray) -> np.ndarray:
        if wname in ("wq", "wk", "wv"):
            heads = cfg.n_heads if wname == "wq" else cfg.n_kv_heads
            return pad_heads_cols(b, heads, plan.hd, plan.hd_p)
        if wname in ("w_gate", "w_up"):
            return scatter_cols(b, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
        return b  # wo/w_down: the output is d_model wide, unpadded

    def pad_a(wname: str, a: np.ndarray) -> np.ndarray:
        # zero rows at pads are exact: the activations there are zero
        if wname == "wo":
            a = pad_heads_rows(a, cfg.n_heads, plan.hd, plan.hd_p)
            return scatter_rows(a, plan.wo_chunk, plan.wo_chunk_p,
                                plan.wo_in_p)
        if wname == "w_down":
            return scatter_rows(a, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
        return a  # K = d_model

    layers: dict[str, Any] = {}
    for wname, by_layer in per.items():
        a_stack, b_stack = [], []
        for li in range(cfg.n_layers):
            if li in by_layer:
                # PEFT stores A (r, K) and B (N, r); these are (K, r), (r, N)
                a_stack.append(pad_a(wname, by_layer[li]["A"].T))
                b_stack.append(pad_b(wname, by_layer[li]["B"].T))
            else:
                a_stack.append(np.zeros_like(a_stack[-1]))
                b_stack.append(np.zeros_like(b_stack[-1]))
        layers[wname] = {"a": torch.from_numpy(np.stack(a_stack)).to(dtype),
                         "b": torch.from_numpy(np.stack(b_stack)).to(dtype)}
    return {"layers": layers, "alpha": alpha, "r": r}


def _with_layers(model: TransformerLM, edit) -> TransformerLM:
    """A new model whose layer tree is ``edit(layers, i)``'s: once on the
    stacked (L, ...) tree with i None, or on each layer i of an unrolled
    one."""
    tree = model.tree()
    if isinstance(model.layers, StackedLayers):
        tree["layers"] = edit(dict(tree["layers"]), None)
    else:
        tree["layers"] = [edit(dict(lp), i)
                          for i, lp in enumerate(tree["layers"])]
    return TransformerLM(model.cfg, tree)


def apply_lora(model: TransformerLM, adapter: dict[str, Any],
               scale: float = 1.0) -> TransformerLM:
    """A model whose covered projections carry the adapter's A, B and
    ``scale * alpha / r`` (float32)."""
    eff = scale * adapter["alpha"] / max(adapter["r"], 1)
    dev = model.device

    def edit(layers, i):
        for wname, ab in adapter["layers"].items():
            a, b = ab["a"].to(dev), ab["b"].to(dev)
            n = a.shape[0]
            if i is not None:
                a, b, n = a[i], b[i], None
            layers[wname] = {
                **layers[wname], "lora_a": a, "lora_b": b,
                "lora_scale": torch.full(() if n is None else (n,), eff,
                                         dtype=torch.float32, device=dev)}
        return layers

    return _with_layers(model, edit)


def apply_cvector(model: TransformerLM, directions,
                  scale: float = 1.0) -> TransformerLM:
    """Control-vector steering: ``directions`` (L, d_model), or (d_model,)
    for every layer, times ``scale`` is added to the residual after each
    layer."""
    cfg = model.cfg
    d = np.asarray(directions, np.float32)
    if d.ndim == 1:
        d = np.broadcast_to(d, (cfg.n_layers, d.shape[0]))
    cv = torch.from_numpy(np.ascontiguousarray(d * np.float32(scale))).to(
        model.device)

    def edit(layers, i):
        layers["cvector"] = cv if i is None else cv[i]
        return layers

    return _with_layers(model, edit)


def load_cvector_file(path: str | pathlib.Path, cfg) -> np.ndarray:
    """A control vector from ``.npz`` (its first array) or ``.safetensors``
    (one (L, d) ``directions`` tensor, or ``direction.<layer>`` rows)."""
    p = pathlib.Path(path)
    if p.suffix == ".npz":
        with np.load(p) as z:
            return np.asarray(z[z.files[0]], np.float32)
    arrays = _read(p)
    if "directions" in arrays:
        return arrays["directions"]
    out = np.zeros((cfg.n_layers, cfg.d_model), np.float32)
    for k, v in arrays.items():
        tail = k.rsplit(".", 1)[-1]
        if tail.isdigit() and 0 <= int(tail) < cfg.n_layers:
            out[int(tail), : v.shape[0]] = v
    return out
