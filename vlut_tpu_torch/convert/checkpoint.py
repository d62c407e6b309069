"""Load the JAX package's packed-ternary checkpoints (transformer family).

A checkpoint directory holds ``vlut_config.json`` (ModelConfig + format
metadata), ``model.safetensors`` (packed uint8 trits, float32 scales and
norms, bf16 embed/lm_head stored as uint16 under ``<name>::bf16`` keys) and
the tokenizer files.  The safetensors file is read by :func:`read_safetensors`
(8-byte little-endian header length, JSON header, raw bytes), so the port
needs no ``safetensors`` package.
"""

from __future__ import annotations

import json
import pathlib
import struct
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models.transformer import TransformerLM

FORMAT_VERSION = 1

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "U16": np.uint16, "BOOL": np.bool_,
}


def read_safetensors(path: str | pathlib.Path,
                     device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """name -> tensor, each read from a memory map and moved to ``device``
    one at a time.  ``<name>::bf16`` uint16 entries come back as bfloat16
    under ``<name>``; BF16 entries are read as uint16 and viewed as bf16."""
    path = pathlib.Path(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", bytes(mm[:8]))
    header = json.loads(bytes(mm[8:8 + n]))
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        bf16 = dt == "BF16" or name.endswith("::bf16")
        np_dt = np.uint16 if dt == "BF16" else _DTYPES.get(dt)
        if np_dt is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {dt}")
        a, b = info["data_offsets"]
        arr = np.array(mm[base + a: base + b]).view(np_dt).reshape(info["shape"])
        if bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            name = name.removesuffix("::bf16")
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device)
    return out


def unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    """``a.b.c`` keys -> nested dicts."""
    tree: dict[str, Any] = {}
    for key, v in flat.items():
        *parts, last = key.split(".")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def config_from_meta(meta: dict[str, Any]) -> ModelConfig:
    mc = dict(meta["model_config"])
    for k, v in mc.items():
        # JSON round-trips tuples as lists
        if isinstance(v, list):
            mc[k] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
    return ModelConfig(**mc)


def load_checkpoint(
    path: str | pathlib.Path, device: str | torch.device | None = None,
) -> tuple[ModelConfig, TransformerLM, dict[str, Any]]:
    """Returns (cfg, model, meta); the model lies on ``device`` (the GPU
    unless the CPU is asked for)."""
    dev = resolve_device(device)
    path = pathlib.Path(path)
    meta = json.loads((path / "vlut_config.json").read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {meta}")
    family = meta.get("model_family", "transformer")
    if family != "transformer" or meta.get("layers_tuple"):
        raise NotImplementedError(
            f"model family {family!r} (layers_tuple="
            f"{bool(meta.get('layers_tuple'))}) is not ported yet")
    cfg = config_from_meta(meta)
    tree = unflatten(read_safetensors(path / "model.safetensors", dev))
    return cfg, TransformerLM(cfg, tree), meta
