"""The JAX package's checkpoints: load and save.

Families (``model_family`` in the meta): ``transformer`` (packed ternary),
``mamba`` and ``mamba2`` (packed ternary projections, float SSM tensors;
``models/ssm.py``), ``rwkv7``, ``rwkv6`` and ``hybrid`` (float weights;
``models/rwkv.py``, ``models/hybrid.py``), ``encoder`` (float weights in
their stored dtypes; ``models/encoder.py``), ``t5`` and ``gemma3n`` (float
weights; ``models/t5.py``, ``models/gemma3n.py``).

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
from torch import nn

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models.transformer import TransformerLM, layers_tuple

FORMAT_VERSION = 1
FAMILIES = ("transformer", "mamba", "mamba2", "rwkv7", "rwkv6", "hybrid",
            "encoder", "t5", "gemma3n")

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


def safetensors_open(path: str | pathlib.Path):
    """(memory map, header without ``__metadata__``, data offset) of a
    safetensors file; :func:`safetensors_tensor` reads one entry."""
    mm = np.memmap(pathlib.Path(path), dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", bytes(mm[:8]))
    header = json.loads(bytes(mm[8:8 + n]))
    header.pop("__metadata__", None)
    return mm, header, 8 + n


def safetensors_tensor(mm: np.memmap, base: int, name: str,
                       info: dict[str, Any]) -> np.ndarray:
    """One header entry as a numpy array in its stored dtype (BF16 as
    uint16), copied out of the memory map."""
    dt = info["dtype"]
    np_dt = np.uint16 if dt == "BF16" else _DTYPES.get(dt)
    if np_dt is None:
        raise ValueError(f"{name}: unsupported safetensors dtype {dt}")
    a, b = info["data_offsets"]
    return np.array(mm[base + a: base + b]).view(np_dt).reshape(info["shape"])


def safetensors_arrays(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """name -> numpy array in its stored dtype (BF16 entries as uint16),
    each a copy out of a memory map of the file."""
    mm, header, base = safetensors_open(path)
    return {name: safetensors_tensor(mm, base, name, info)
            for name, info in header.items()}


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
                      arrays: dict[str, np.ndarray],
                      bf16: frozenset[str] = frozenset()) -> None:
    """Write name -> numpy array as a safetensors file: tensors in name
    order, contiguous from offset 0, the header padded with spaces to a
    multiple of 8 bytes (the layout the ``safetensors`` package writes).
    The uint16 arrays named in ``bf16`` are stored as BF16."""
    header: dict[str, Any] = {}
    off = 0
    names = sorted(arrays)
    for name in names:
        a = arrays[name]
        if a.dtype not in _CODES:
            raise ValueError(f"{name}: no safetensors dtype for {a.dtype}")
        code = _CODES[a.dtype]
        if name in bf16:
            if code != "U16":
                raise ValueError(f"{name}: BF16 bits must be uint16")
            code = "BF16"
        header[name] = {"dtype": code, "shape": list(a.shape),
                        "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(np.ascontiguousarray(arrays[name]).data)


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
    into (L, ...) tensors, the layout checkpoints keep; a config whose
    layers differ in shape (:func:`layers_tuple`) keeps one tree per layer
    under the sortable keys ``layers.t0000.`` ..., as the JAX package
    writes them (``"layers_tuple": true``).  A recurrent or hybrid model
    is saved under its family; a hybrid's layer list per layer."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = (dict(model_or_tree.tree()) if isinstance(model_or_tree, nn.Module)
            else dict(model_or_tree))
    layers = tree.get("layers")
    family = family_of(cfg)
    per_layer = (layers_tuple(cfg) if family == "transformer"
                 else isinstance(layers, (list, tuple)))
    if isinstance(layers, (list, tuple)):
        tree["layers"] = ({f"t{i:04d}": lp for i, lp in enumerate(layers)}
                          if per_layer else _stack_layers(list(layers)))
    elif per_layer:
        raise ValueError("a per-layer config keeps the tuple-layers tree")
    write_safetensors(path / "model.safetensors", _flatten(tree))
    meta = {
        "format_version": FORMAT_VERSION,
        "model_family": family,
        "model_config": dataclasses.asdict(cfg),
        "layers_tuple": per_layer,
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


def config_from_meta(meta: dict[str, Any]):
    mc = dict(meta["model_config"])
    for k, v in mc.items():
        # JSON round-trips tuples as lists
        if isinstance(v, list):
            mc[k] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
    return _family_config(meta.get("model_family", "transformer"))(**mc)


def load_checkpoint(
    path: str | pathlib.Path, device: str | torch.device | None = None,
) -> tuple[ModelConfig, TransformerLM, dict[str, Any]]:
    """Returns (cfg, model, meta); the model lies on ``device`` (the GPU
    unless the CPU is asked for)."""
    cfg, tree, meta = read_tree(path, resolve_device(device))
    return cfg, model_from_tree(cfg, tree), meta


def read_tree(path: str | pathlib.Path, device: str | torch.device = "cpu"
              ) -> tuple[Any, dict[str, Any], dict[str, Any]]:
    """(cfg, tree, meta) of a checkpoint directory: its tensors on
    ``device`` as the nested tree they were saved from (a ``layers_tuple``
    checkpoint's layers as the list of per-layer trees), no model built."""
    path = pathlib.Path(path)
    meta = json.loads((path / "vlut_config.json").read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {meta}")
    family = meta.get("model_family", "transformer")
    if family not in FAMILIES:
        raise NotImplementedError(f"unknown model family {family!r}")
    tree = unflatten(read_safetensors(path / "model.safetensors", device))
    if meta.get("layers_tuple"):
        tree["layers"] = tuple_layers(tree["layers"])
    return config_from_meta(meta), tree, meta


def _family_config(family: str):
    """The config class of a ``model_family``."""
    if family == "transformer":
        return ModelConfig
    from vlut_tpu_torch.models import encoder, gemma3n, hybrid, rwkv, ssm, t5

    return {"mamba": ssm.MambaConfig, "mamba2": ssm.Mamba2Config,
            "rwkv7": rwkv.Rwkv7Config, "rwkv6": rwkv.Rwkv6Config,
            "hybrid": hybrid.HybridConfig,
            "encoder": encoder.EncoderConfig, "t5": t5.T5Config,
            "gemma3n": gemma3n.Gemma3nConfig}[family]


def family_of(cfg) -> str:
    """The ``model_family`` a config is saved under."""
    for family in FAMILIES:
        if type(cfg) is _family_config(family):
            return family
    raise TypeError(f"no model family for {type(cfg).__name__}")


def model_from_tree(cfg, tree: dict[str, Any]):
    """The port's model of a config over a checkpoint tree: a
    TransformerLM, a RecurrentLM (Mamba, Mamba2), an EncoderLM (its floats
    in their stored dtypes, whose roundings its forward keeps), or a TreeLM
    (RWKV, the hybrids, T5, gemma3n; float tensors made float32, as the JAX
    package promotes them in every product)."""
    if isinstance(cfg, ModelConfig):
        return TransformerLM(cfg, tree)
    from vlut_tpu_torch.models import encoder, ssm

    family = family_of(cfg)
    if family in ("mamba", "mamba2"):
        return ssm.RecurrentLM(cfg, tree)
    if family == "encoder":
        return encoder.EncoderLM(cfg, tree)

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [f32(v) for v in node]
        return node.to(torch.float32) if node.is_floating_point() else node
    return ssm.TreeLM(cfg, f32(tree))


def tuple_layers(layers: dict[str, Any]) -> list[dict[str, Any]]:
    """A ``layers_tuple`` checkpoint's ``t0000`` ... trees -> the list of
    per-layer trees, in key order (the JAX ``load_checkpoint``)."""
    return [layers[k] for k in sorted(layers)]


# ---------------------------------------------------------------------------
# vision sidecars: a tower file beside model.safetensors and its config in
# the meta (the JAX converter's vision path writes them)
# ---------------------------------------------------------------------------

def _sidecar(path, key: str, fname: str):
    """(dir, config dict) of a sidecar the checkpoint carries, else None."""
    path = pathlib.Path(path)
    meta = json.loads((path / "vlut_config.json").read_text())
    c = meta.get(key)
    if not c or not (path / fname).exists():
        return None
    return path, dict(c), meta


def _load_tower(path: pathlib.Path, fname: str, device) -> dict[str, Any]:
    """A tower's flat file -> {"layers": {name: (L, ...)}, name: ...} on
    ``device``, as stored (float32 from either converter)."""
    params: dict[str, Any] = {"layers": {}}
    for k, v in read_safetensors(path / fname, resolve_device(device)).items():
        if k.startswith("layers."):
            params["layers"][k[len("layers."):]] = v
        else:
            params[k] = v
    return params


def load_vision(path, device=None):
    """The CLIP tower + llava projector of a llava checkpoint: (VisionConfig,
    params) with every weight bf16 and the norms float32, or (None, None)
    for a text-only checkpoint."""
    from vlut_tpu_torch.models.vision import VisionConfig

    hit = _sidecar(path, "vision_config", "vision.safetensors")
    if hit is None:
        return None, None
    params = _load_tower(hit[0], "vision.safetensors", device)
    layers = params["layers"]
    for k, v in list(layers.items()):
        layers[k] = v.to(torch.float32 if k in (
            "ln1_w", "ln1_b", "ln2_w", "ln2_b") else torch.bfloat16)
    for k, v in list(params.items()):
        if k != "layers":
            params[k] = v.to(torch.float32 if k in ("pre_ln_w", "pre_ln_b")
                             else torch.bfloat16)
    return VisionConfig(**hit[1]), params


def load_qwen_vision(path, device=None):
    """The Qwen2-VL / 2.5-VL tower: (QwenVisionConfig, params, {image and
    vision-start token ids}) or (None, None, None)."""
    from vlut_tpu_torch.models.qwen_vision import QwenVisionConfig

    hit = _sidecar(path, "qwen_vision_config", "qwen_vision.safetensors")
    if hit is None:
        return None, None, None
    path, qv, meta = hit
    if "fullatt_blocks" in qv:
        qv["fullatt_blocks"] = tuple(qv["fullatt_blocks"])
    extras = {"image_token_id": meta.get("image_token_id"),
              "vision_start_token_id": meta.get("vision_start_token_id")}
    return (QwenVisionConfig(**qv),
            _load_tower(path, "qwen_vision.safetensors", device), extras)


def _tower(path, key: str, fname: str, config_cls, device, **fixed):
    """(config, params, image_token_id) of a plain sidecar, or Nones."""
    hit = _sidecar(path, key, fname)
    if hit is None:
        return None, None, None
    path, c, meta = hit
    return (config_cls(**c, **fixed), _load_tower(path, fname, device),
            meta.get("image_token_id"))


def load_siglip(path, device=None):
    """Gemma3's SigLIP tower + avg-pool projector."""
    from vlut_tpu_torch.models.vision_ext import SiglipConfig

    return _tower(path, "siglip_config", "siglip.safetensors", SiglipConfig,
                  device)


def load_pixtral(path, device=None):
    """The Pixtral tower + llava projector (mistral3's merger)."""
    from vlut_tpu_torch.models.vision_ext import PixtralConfig

    return _tower(path, "pixtral_config", "pixtral.safetensors",
                  PixtralConfig, device)


def load_internvl_vision(path, device=None):
    """The InternVL ViT + LN / GELU projector."""
    from vlut_tpu_torch.models.vision_wave3 import InternVLConfig

    return _tower(path, "internvl_config", "internvl.safetensors",
                  InternVLConfig, device)


def load_llama4_vision(path, device=None):
    """The Llama4 tower + pixel-shuffle adapter + projector."""
    from vlut_tpu_torch.models.vision_wave3 import Llama4VisionConfig

    return _tower(path, "llama4_vision_config", "llama4_vision.safetensors",
                  Llama4VisionConfig, device)


def load_janus_vision(path, device=None):
    """Janus-Pro's understanding tower (siglip_forward(act="exact")) +
    aligner."""
    from vlut_tpu_torch.models.vision_ext import SiglipConfig

    return _tower(path, "janus_config", "janus.safetensors", SiglipConfig,
                  device)


def load_qwen3vl_vision(path, device=None):
    """The Qwen3-VL DeepStack tower."""
    from vlut_tpu_torch.models.vision_wave3 import Qwen3VLVisionConfig

    hit = _sidecar(path, "qwen3vl_vision_config",
                   "qwen3vl_vision.safetensors")
    if hit is None:
        return None, None, None
    path, qc, meta = hit
    qc["deepstack_indexes"] = tuple(qc["deepstack_indexes"])
    return (Qwen3VLVisionConfig(**qc),
            _load_tower(path, "qwen3vl_vision.safetensors", device),
            meta.get("image_token_id"))


def load_glm4v_vision(path, device=None):
    """The GLM4-V tower + downsample + merger."""
    from vlut_tpu_torch.models.vision_wave3 import Glm4vVisionConfig

    return _tower(path, "glm4v_vision_config", "glm4v_vision.safetensors",
                  Glm4vVisionConfig, device)


def _shuffled(path, key: str, fname: str, factor_key: str, device):
    """(SiglipConfig, shuffle factor, params, image_token_id) of a siglip
    tower with a pixel-shuffle projector (idefics3, lfm2-vl), or Nones."""
    from vlut_tpu_torch.models.vision_ext import SiglipConfig

    hit = _sidecar(path, key, fname)
    if hit is None:
        return None, None, None, None
    path, c, meta = hit
    factor = c.pop(factor_key, 2)
    return (SiglipConfig(**c, mm_tokens_per_image=0), factor,
            _load_tower(path, fname, device), meta.get("image_token_id"))


def load_idefics3(path, device=None):
    """Idefics3's SigLIP tower + pixel-shuffle connector."""
    return _shuffled(path, "idefics3_config", "idefics3.safetensors",
                     "scale_factor", device)


def load_lfm2vl_vision(path, device=None):
    """LFM2-VL's siglip2 tower + pixel-unshuffle projector."""
    return _shuffled(path, "lfm2vl_config", "lfm2vl.safetensors",
                     "downsample", device)
