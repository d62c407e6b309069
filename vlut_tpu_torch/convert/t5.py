"""HF T5 checkpoints -> the t5 checkpoint (own copy of the JAX package's
``vlut_tpu/convert/t5.py``; reference: convert_hf_to_gguf's
T5Model / T5EncoderModel registrations).

The weights stay float32 (transposed to (in, out)) on the host, in numpy,
read through the port's own safetensors reader; the checkpoint is array
for array the JAX converter's.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
from typing import Any

import numpy as np

from vlut_tpu_torch.convert.convert import _iter_hf_tensors, _save
from vlut_tpu_torch.models.t5 import T5Config

log = logging.getLogger("vlut_tpu_torch.convert.t5")


def convert_t5(
    hf_dir: str | pathlib.Path, out_dir: str | pathlib.Path
) -> T5Config:
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    if raw.get("model_type") not in ("t5", "mt5"):
        # (umt5 stores a rel-bias table PER layer — not supported)
        raise ValueError(f"not a t5 checkpoint: {raw.get('model_type')!r}")
    ffp = raw.get("feed_forward_proj", "relu")
    gated = ffp.startswith("gated-") or raw.get("is_gated_act", False)
    act = "gelu" if "gelu" in ffp else "relu"
    cfg = T5Config(
        vocab_size=raw["vocab_size"],
        d_model=raw["d_model"],
        d_kv=raw.get("d_kv", raw["d_model"] // raw["num_heads"]),
        d_ff=raw["d_ff"],
        n_layers=raw["num_layers"],
        n_dec_layers=raw.get("num_decoder_layers", raw["num_layers"]),
        n_heads=raw["num_heads"],
        rel_buckets=raw.get("relative_attention_num_buckets", 32),
        rel_max_distance=raw.get("relative_attention_max_distance", 128),
        ln_eps=raw.get("layer_norm_epsilon", 1e-6),
        gated=gated, act=act,
        tie_embeddings=raw.get("tie_word_embeddings", True),
        decoder_start_token_id=raw.get("decoder_start_token_id", 0),
        eos_id=raw.get("eos_token_id", 1),
    )

    top: dict[str, Any] = {}
    enc: dict[str, dict[int, np.ndarray]] = {}
    dec: dict[str, dict[int, np.ndarray]] = {}
    lre = re.compile(r"(encoder|decoder)\.block\.(\d+)\.layer\.(\d+)\.(.+)$")
    # sub-layer tensor name -> our param name (weights transposed to (K, N))
    sub_map = {
        (0, "SelfAttention.q.weight"): "wq",
        (0, "SelfAttention.k.weight"): "wk",
        (0, "SelfAttention.v.weight"): "wv",
        (0, "SelfAttention.o.weight"): "wo",
        (0, "layer_norm.weight"): "attn_norm",
        (1, "EncDecAttention.q.weight"): "cross_wq",
        (1, "EncDecAttention.k.weight"): "cross_wk",
        (1, "EncDecAttention.v.weight"): "cross_wv",
        (1, "EncDecAttention.o.weight"): "cross_wo",
    }

    for name, w in _iter_hf_tensors(hf_dir):
        w = np.asarray(w, np.float32)
        if name == "shared.weight" or name in (
            "encoder.embed_tokens.weight",
            "decoder.embed_tokens.weight",
        ):
            top.setdefault("embed", w)
            continue
        if name == "lm_head.weight":
            top["lm_head"] = w.T
            continue
        if name == "encoder.final_layer_norm.weight":
            top["enc_final_norm"] = w
            continue
        if name == "decoder.final_layer_norm.weight":
            top["dec_final_norm"] = w
            continue
        m = lre.match(name)
        if not m:
            log.warning("skipping unrecognized tensor %s", name)
            continue
        stack = enc if m.group(1) == "encoder" else dec
        li, sub_i, sub = int(m.group(2)), int(m.group(3)), m.group(4)
        if sub == "SelfAttention.relative_attention_bias.weight":
            top["enc_rel_bias" if stack is enc
                else "dec_rel_bias"] = w  # (buckets, H)
            continue
        is_dec = stack is dec
        ffn_i = 2 if is_dec else 1
        if sub_i == ffn_i:
            pname = {
                "DenseReluDense.wi_0.weight": "wi0",
                "DenseReluDense.wi_1.weight": "wi1",
                "DenseReluDense.wi.weight": "wi",
                # FFN down proj: distinct from the attention wo
                "DenseReluDense.wo.weight": "wo_ffn",
                "layer_norm.weight": "ffn_norm",
            }.get(sub)
        elif is_dec and sub_i == 1:
            pname = sub_map.get((1, sub)) or (
                "cross_norm" if sub == "layer_norm.weight" else None
            )
        else:
            pname = sub_map.get((0, sub))
        if pname is None:
            log.warning("skipping unrecognized layer tensor %s",
                        name)
            continue
        stack.setdefault(pname, {})[li] = (
            w.T if sub.endswith((".q.weight", ".k.weight",
                                 ".v.weight", ".o.weight",
                                 "wi_0.weight", "wi_1.weight",
                                 "wi.weight", "wo.weight"))
            else w
        )

    def stack_layers(per: dict[str, dict[int, np.ndarray]], L: int):
        out = {}
        for pname, by in per.items():
            missing = [i for i in range(L) if i not in by]
            if missing:
                raise ValueError(f"missing layers {missing} for {pname}")
            out[pname] = np.stack([by[i] for i in range(L)])
        return out

    enc_l = stack_layers(enc, cfg.n_layers)
    dec_l = stack_layers(dec, cfg.n_dec_layers)

    params = {
        **top,
        "enc_layers": enc_l,
        "dec_layers": dec_l,
    }
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg
