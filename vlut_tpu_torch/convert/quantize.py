"""Requantize a packed checkpoint between ternary formats (port of
``vlut_tpu/convert/quantize.py``; the llama-quantize analog for
already-converted checkpoints).

i2 (2.0 bpw, 4 trits per byte) <-> i1 (1.6 bpw, 5 trits per byte) is exact:
both store the same trits and only the byte packing changes, so the
conversion goes through the logical trits of every projection.  The pack
block sets the chunk padding of wo's K and the FFN width (``dims.make_plan``),
so the bitnet sub-norm gains, which live in that padded layout, are laid
out anew as well; the JAX package keeps them in the source layout, and its
i1 model of a sub-norm checkpoint does not run (ROADMAP Queue 3).  It runs
on the host and touches no device.

    python -m vlut_tpu_torch.convert.quantize SRC DST --fmt i1
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.convert.checkpoint import (
    FORMAT_VERSION,
    config_from_meta,
    read_safetensors,
    save_checkpoint,
    unflatten,
)
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.models.transformer import (
    TransformerLM,
    pack_weight,
    unpack_weight,
    weight_specs,
)
from vlut_tpu_torch.ops.packing import TernaryTensor


def requantize_params(
    cfg: ModelConfig, params: TransformerLM | dict[str, Any], fmt: str
) -> tuple[ModelConfig, dict[str, Any]]:
    """Exact in-memory i2 <-> i1 repack of a stacked tree (same trits, new
    byte format); returns (new cfg, new tree; its packed weights lie on the
    CPU)."""
    tree = params.tree() if isinstance(params, TransformerLM) else params
    if cfg.weight_fmt == fmt:
        return cfg, tree
    if not isinstance(tree["layers"], dict):
        raise ValueError("requantize takes the stacked (checkpoint) tree")
    src_specs = weight_specs(cfg)
    new_cfg = dataclasses.replace(cfg, weight_fmt=fmt)
    layers: dict[str, Any] = {}
    for name, val in tree["layers"].items():
        if name in _SUB_NORMS:
            layers[name] = _relayout_sub_norm(name, torch.as_tensor(val).cpu(),
                                              cfg, new_cfg)
            continue
        if not (isinstance(val, dict) and "packed" in val):
            layers[name] = torch.as_tensor(val).cpu()
            continue
        packed = torch.as_tensor(val["packed"]).cpu()
        scale = torch.as_tensor(val["scale"]).to(torch.float32).cpu()
        if packed.dim() == 4:
            raise NotImplementedError(
                f"{name}: MoE expert stacks are not ported yet (ROADMAP "
                "Queue 1 item 10)")
        spec = src_specs[name]
        outs = []
        for li in range(packed.shape[0]):
            # the padded layouts differ per format (the pack block shapes
            # the plan), so round-trip through the logical trits
            t = TernaryTensor(packed[li], scale[li], spec.k, spec.n,
                              spec.fmt, spec.kb)
            trits = unpack_weight(name, t, cfg)
            outs.append(pack_weight(name, trits, scale[li], new_cfg))
        layers[name] = {
            "packed": torch.stack([t.packed for t in outs]),
            "scale": torch.stack([t.scale.reshape(()) for t in outs]),
        }
    return new_cfg, {**tree, "layers": layers}


_SUB_NORMS = ("attn_sub_norm", "ffn_sub_norm")


def _relayout_sub_norm(name: str, v: torch.Tensor, cfg: ModelConfig,
                       new_cfg: ModelConfig) -> torch.Tensor:
    """(L, padded width) sub-norm gains from ``cfg``'s chunk layout to
    ``new_cfg``'s: each chunk keeps its first min(old, new) padded entries
    (the logical ones and, when the chunk grows, its old pad entries, so an
    i2 -> i1 -> i2 round trip is exact); new pad entries are zero."""
    old, new = make_plan(cfg), make_plan(new_cfg)
    if name == "attn_sub_norm":
        cp_old, cp_new = old.wo_chunk_p, new.wo_chunk_p
    else:
        cp_old, cp_new = old.ff_chunk_p, new.ff_chunk_p
    c = min(cp_old, cp_new)
    out = torch.zeros((v.shape[0], old.tp_pack, cp_new), dtype=v.dtype)
    out[:, :, :c] = v.reshape(v.shape[0], old.tp_pack, cp_old)[:, :, :c]
    return out.reshape(v.shape[0], old.tp_pack * cp_new)


def requantize(src: str | pathlib.Path, dst: str | pathlib.Path,
               fmt: str) -> ModelConfig:
    """Read the checkpoint ``src``, repack it to ``fmt`` and write it to
    ``dst`` with the source's tokenizer files and metadata."""
    src = pathlib.Path(src)
    meta = json.loads((src / "vlut_config.json").read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {meta}")
    cfg = config_from_meta(meta)
    if cfg.weight_fmt == fmt:
        raise ValueError(f"checkpoint already {fmt}")
    tree = unflatten(read_safetensors(src / "model.safetensors", "cpu"))
    new_cfg, new_tree = requantize_params(cfg, tree, fmt)
    save_checkpoint(
        dst, new_cfg, new_tree, tokenizer_src=src,
        extra_meta={"requantized_from": str(src), **{
            k: v for k, v in meta.items()
            if k not in ("format_version", "model_config")
        }},
    )
    return new_cfg


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m vlut_tpu_torch.convert.quantize",
        description="requantize a packed ternary checkpoint (i2 <-> i1)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--fmt", choices=("i2", "i1"), required=True)
    args = ap.parse_args(argv)
    cfg = requantize(args.src, args.dst, args.fmt)
    print(f"requantized -> {args.dst} ({cfg.weight_fmt})")


if __name__ == "__main__":
    main()
