"""The JAX package's packed-ternary checkpoints (transformer family): load
and save.

A checkpoint directory holds ``vlut_config.json`` (ModelConfig + format
metadata), ``model.safetensors`` (packed uint8 trits, float32 scales and
norms, bf16 embed/lm_head stored as uint16 under ``<name>::bf16`` keys) and
the tokenizer files.  The safetensors file is read by :func:`read_safetensors`
and written by :func:`write_safetensors` (8-byte little-endian header
length, JSON header, raw bytes), so the port needs no ``safetensors``
package; :func:`save_checkpoint` writes what the JAX ``load_checkpoint``
reads, tensor for tensor.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
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


_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model",
    "special_tokens_map.json", "vocab.json", "merges.txt",
    "generation_config.json",
)


def safetensors_arrays(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """name -> numpy array in its stored dtype (BF16 entries as uint16),
    each a copy out of a memory map of the file."""
    mm = np.memmap(pathlib.Path(path), dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", bytes(mm[:8]))
    header = json.loads(bytes(mm[8:8 + n]))
    base = 8 + n
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        np_dt = np.uint16 if dt == "BF16" else _DTYPES.get(dt)
        if np_dt is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {dt}")
        a, b = info["data_offsets"]
        out[name] = np.array(mm[base + a: base + b]).view(np_dt).reshape(
            info["shape"])
    return out


def read_safetensors(path: str | pathlib.Path,
                     device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """name -> tensor, each moved to ``device`` one at a time.
    ``<name>::bf16`` uint16 entries come back as bfloat16 under ``<name>``."""
    out: dict[str, torch.Tensor] = {}
    for name, arr in safetensors_arrays(path).items():
        if name.endswith("::bf16"):
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            name = name.removesuffix("::bf16")
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device)
    return out


def write_safetensors(path: str | pathlib.Path,
                      arrays: dict[str, np.ndarray]) -> None:
    """Write name -> numpy array as a safetensors file: tensors in name
    order, contiguous from offset 0, the header padded with spaces to a
    multiple of 8 bytes (the layout the ``safetensors`` package writes)."""
    header: dict[str, Any] = {}
    off = 0
    names = sorted(arrays)
    for name in names:
        a = arrays[name]
        if a.dtype not in _CODES:
            raise ValueError(f"{name}: no safetensors dtype for {a.dtype}")
        header[name] = {"dtype": _CODES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(np.ascontiguousarray(arrays[name]).tobytes())


def _flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested tree of tensors -> the checkpoint's flat keys (bf16 as uint16
    under ``<name>::bf16``, as the JAX package stores it)."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
            continue
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[key + "::bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out


def save_checkpoint(
    path: str | pathlib.Path,
    cfg: ModelConfig,
    model_or_tree: TransformerLM | dict[str, Any],
    tokenizer_src: str | pathlib.Path | None = None,
    extra_meta: dict[str, Any] | None = None,
) -> None:
    """Write ``vlut_config.json`` + ``model.safetensors`` (+ the tokenizer
    files of ``tokenizer_src``).  An unrolled layer list is stacked back
    into (L, ...) tensors, the layout checkpoints keep."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = (model_or_tree.tree() if isinstance(model_or_tree, TransformerLM)
            else dict(model_or_tree))
    layers = tree.get("layers")
    if isinstance(layers, (list, tuple)):
        tree["layers"] = _stack_layers(list(layers))
    write_safetensors(path / "model.safetensors", _flatten(tree))
    meta = {
        "format_version": FORMAT_VERSION,
        "model_family": "transformer",
        "model_config": dataclasses.asdict(cfg),
        "layers_tuple": False,
        **(extra_meta or {}),
    }
    (path / "vlut_config.json").write_text(json.dumps(meta, indent=2))
    if tokenizer_src is not None:
        src = pathlib.Path(tokenizer_src)
        for fname in _TOKENIZER_FILES:
            if (src / fname).exists():
                shutil.copy(src / fname, path / fname)


def _stack_layers(layers: list[dict[str, Any]]) -> dict[str, Any]:
    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return torch.stack(vals)

    return stack(layers)


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
