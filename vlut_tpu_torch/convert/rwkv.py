"""HF RWKV7 and RWKV6 checkpoints -> the rwkv7 / rwkv6 checkpoints (own
copy of the JAX package's ``vlut_tpu/convert/rwkv.py``: model types rwkv7,
rwkv070, rwkv_hybrid (ARWKV-7), rwkv6 and rwkv6qwen2).

Name scheme per the reference's Rwkv7Model converter registration
(convert_hf_to_gguf.py @register Rwkv7ForCausalLM/RWKV7ForCausalLM) and
gguf-py tensor_mapping rwkv7 rows: model.embeddings / model.pre_ln /
model.ln_out / head, per-layer ln1/ln2, attention.{x_*, w0..2, a0..2,
v0..2, g1..2, k_k, k_a, r_k, receptance|r_proj, key|k_proj, value|v_proj,
output|o_proj, ln_x}, feed_forward.{x_k, key, value}.  The fla-hub lora
naming (*_lora.lora.{0,2}) maps onto the same slots.  The weights stay
float32 on the host, in numpy, read through the port's own safetensors
reader; the checkpoint is array for array the JAX converter's.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
from typing import Any

import numpy as np

from vlut_tpu_torch.convert.convert import _iter_hf_tensors, _save
from vlut_tpu_torch.models.rwkv import Rwkv6Config, Rwkv7Config

log = logging.getLogger("vlut_tpu_torch.convert.rwkv")


def convert_rwkv7(
    hf_dir: str | pathlib.Path, out_dir: str | pathlib.Path
) -> Rwkv7Config:
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    D = raw["hidden_size"]
    arwkv = raw.get("model_type") == "rwkv_hybrid"  # ARWKV-7 (qwen body)
    cfg = Rwkv7Config(
        vocab_size=raw["vocab_size"],
        d_model=D,
        n_layers=raw.get("num_hidden_layers", raw.get("n_layer")),
        head_size=raw.get("head_size", raw.get("head_dim", 64)),
        d_ff=raw.get("intermediate_size") or 4 * D,
        ln_eps=(raw.get("rms_norm_eps", 1e-6) if arwkv else
                raw.get("layer_norm_epsilon", raw.get("norm_eps", 1e-5))),
        has_gate=raw.get("wkv_has_gate", True),
        arch="arwkv7" if arwkv else "rwkv7",
        tie_embeddings=raw.get("tie_word_embeddings", False),
    )
    L = cfg.n_layers
    top: dict[str, Any] = {}
    per: dict[str, dict[int, np.ndarray]] = {}

    def put(pname: str, li: int, v: np.ndarray):
        per.setdefault(pname, {})[li] = v

    def lora_pair(base: str, li: int, sub: str, w: np.ndarray):
        """w1/w2-style pairs: orient by shape so x @ m1 @ m2 works
        (m1 (D, rank), m2 (rank, D)); 0-suffix = the bias vector."""
        which = sub[-1]
        if which == "0":
            put(base + "0", li, w.reshape(-1))
            return
        w = np.asarray(w, np.float32)
        if which == "1":
            put(base + "1", li, w if w.shape[0] == D else w.T)
        else:
            put(base + "2", li, w if w.shape[1] == D else w.T)

    lre = re.compile(r"model\.layers\.(\d+)\.(.+)$")
    for name, w in _iter_hf_tensors(hf_dir):
        w = np.asarray(w, np.float32)
        # fla-hub lora module naming -> flat 0/1/2 slots
        name = name.replace("_lora.lora.0.weight", "1")
        name = name.replace("_lora.lora.2.weight", "2")
        name = name.replace("_lora.lora.2.bias", "0")
        if name == "model.embed_tokens.weight":  # arwkv7
            top["embed"] = w
            continue
        if name == "model.norm.weight":           # arwkv7 final
            top["final_norm"] = w
            continue
        if name == "model.embeddings.weight":
            top["embed"] = w
            continue
        if name in ("model.pre_ln.weight",
                    "model.layers.0.pre_norm.weight"):
            top["pre_ln_w"] = w
            continue
        if name in ("model.pre_ln.bias",
                    "model.layers.0.pre_norm.bias"):
            top["pre_ln_b"] = w
            continue
        if name == "model.ln_out.weight":
            top["final_norm"] = w
            continue
        if name == "model.ln_out.bias":
            top["final_norm_b"] = w
            continue
        if name in ("head.weight", "lm_head.weight"):
            top["lm_head"] = w.T
            continue
        m = lre.match(name)
        if not m:
            log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        sub = sub.replace("self_attn.", "attention.")
        sub = sub.replace("attn.", "attention.")
        sub = sub.replace("time_mixer.", "attention.")
        sub = sub.replace("ffn.", "feed_forward.")
        sub = sub.replace("input_layernorm.", "ln1.")
        sub = sub.replace("post_attention_layernorm.", "ln2.")
        if sub == "ln1.weight":
            put("ln1_w", li, w)
        elif sub == "ln1.bias":
            put("ln1_b", li, w)
        elif sub == "ln2.weight":
            put("ln2_w", li, w)
        elif sub == "ln2.bias":
            put("ln2_b", li, w)
        elif sub.startswith("attention.x_"):
            put("lerp_" + sub[len("attention.x_"):],
                li, w.reshape(-1))
        elif re.fullmatch(r"attention\.[wav]\d(\.weight)?", sub):
            base = sub.split(".")[1][0]
            lora_pair(base, li, sub.split(".")[1], w)
        elif re.fullmatch(r"attention\.g[12](\.weight)?", sub):
            lora_pair("g", li, sub.split(".")[1], w)
        elif sub in ("attention.k_k", "attention.k_a"):
            put(sub.split(".")[1], li, w.reshape(-1))
        elif sub == "attention.r_k":
            put("r_k", li, w.reshape(-1))
        elif sub in ("attention.receptance.weight",
                     "attention.r_proj.weight"):
            put("wr", li, w.T)
        elif sub in ("attention.key.weight",
                     "attention.k_proj.weight"):
            put("wk", li, w.T)
        elif sub in ("attention.value.weight",
                     "attention.v_proj.weight"):
            put("wv", li, w.T)
        elif sub in ("attention.output.weight",
                     "attention.o_proj.weight"):
            put("wo", li, w.T)
        elif sub in ("attention.ln_x.weight",
                     "attention.g_norm.weight"):
            put("ln_x_w", li, w)
        elif sub in ("attention.ln_x.bias",
                     "attention.g_norm.bias"):
            put("ln_x_b", li, w)
        elif sub in ("mlp.gate_proj.weight",
                     "feed_forward.gate_proj.weight"):
            put("w_gate", li, w.T)
        elif sub in ("mlp.up_proj.weight",
                     "feed_forward.up_proj.weight"):
            put("w_up", li, w.T)
        elif sub in ("mlp.down_proj.weight",
                     "feed_forward.down_proj.weight"):
            put("w_down", li, w.T)
        elif sub == "feed_forward.x_k":
            put("cm_lerp_k", li, w.reshape(-1))
        elif sub == "feed_forward.key.weight":
            put("cm_key", li, w.T)
        elif sub == "feed_forward.value.weight":
            put("cm_value", li, w.T)
        else:
            log.warning("skipping rwkv7 layer tensor %s", name)

    # layer 0 may ship dummy/absent v0/v1/v2 (its v IS v_first) — fill
    # zeros so the stacked tree stays homogeneous; forward never reads them
    for nm, like in (("v0", "a0"), ("v1", "a1"), ("v2", "a2")):
        by = per.setdefault(nm, {})
        if 0 not in by and 0 in per.get(like, {}):
            by[0] = np.zeros_like(per[like][0])

    layers: dict[str, np.ndarray] = {}
    for pname, by in per.items():
        missing = [i for i in range(L) if i not in by]
        if missing:
            raise ValueError(f"missing layers {missing} for {pname}")
        layers[pname] = np.stack([by[i] for i in range(L)])
    params = {**top, "layers": layers}
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg


def convert_rwkv6(
    hf_dir: str | pathlib.Path, out_dir: str | pathlib.Path
):
    """HF RWKV6 (rwkv.blocks.* naming, Rwkv6Model gguf registration) and
    rwkv6qwen2 (qwen2 body, RWKV6Qwen2ForCausalLM) -> rwkv6 checkpoint."""
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    D = raw["hidden_size"]
    qr = raw.get("model_type") == "rwkv6qwen2"
    hs = raw.get("head_size", raw.get("head_dim", 64))
    cfg = Rwkv6Config(
        vocab_size=raw["vocab_size"],
        d_model=D,
        n_layers=raw.get("num_hidden_layers", raw.get("n_layer")),
        head_size=hs,
        d_ff=raw.get("intermediate_size") or 4 * D,
        ln_eps=(raw.get("rms_norm_eps", 1e-6) if qr else
                raw.get("layer_norm_epsilon", 1e-5)),
        arch="rwkv6qwen2" if qr else "rwkv6",
        n_kv_heads=(raw.get("num_key_value_heads", 0) or 0) if qr else 0,
        proj_bias=bool(raw.get("attention_bias", qr)),
        tie_embeddings=raw.get("tie_word_embeddings", False),
    )
    L = cfg.n_layers
    top: dict[str, Any] = {}
    per: dict[str, dict[int, np.ndarray]] = {}

    def put(pname, li, v):
        per.setdefault(pname, {})[li] = v

    lre = re.compile(r"(?:rwkv\.blocks|model\.layers)\.(\d+)\.(.+)$")
    for name, w in _iter_hf_tensors(hf_dir):
        w = np.asarray(w, np.float32)
        if name in ("rwkv.embeddings.weight",
                    "model.embed_tokens.weight"):
            top["embed"] = w
            continue
        if name == "model.norm.weight":
            top["final_norm"] = w
            continue
        if name == "rwkv.ln_out.weight":
            top["final_norm"] = w
            continue
        if name == "rwkv.ln_out.bias":
            top["final_norm_b"] = w
            continue
        if name in ("head.weight", "lm_head.weight"):
            top["lm_head"] = w.T
            continue
        m = lre.match(name)
        if not m:
            log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        if sub == "pre_ln.weight":
            top["pre_ln_w"] = w
            continue
        if sub == "pre_ln.bias":
            top["pre_ln_b"] = w
            continue
        sub = sub.replace("self_attn.", "attention.")
        sub = sub.replace("input_layernorm.", "ln1.")
        sub = sub.replace("post_attention_layernorm.", "ln2.")
        if sub == "ln1.weight":
            put("ln1_w", li, w)
        elif sub == "ln1.bias":
            put("ln1_b", li, w)
        elif sub == "ln2.weight":
            put("ln2_w", li, w)
        elif sub == "ln2.bias":
            put("ln2_b", li, w)
        elif sub == "attention.time_maa_x":
            put("maa_x", li, w.reshape(-1))
        elif re.fullmatch(r"attention\.time_maa_[wkvrg]", sub):
            put("maa_" + sub[-1], li, w.reshape(-1))
        elif sub == "attention.time_maa_w1":
            put("maa_w1", li, w if w.shape[0] == D else w.T)
        elif sub == "attention.time_maa_w2":
            # (5, rank, D)
            w5 = w if w.shape[0] == 5 else w.reshape(
                5, -1, w.shape[-1])
            put("maa_w2", li, w5)
        elif sub == "attention.time_decay":
            put("decay", li, w.reshape(-1))
        elif sub == "attention.time_decay_w1":
            put("td_w1", li, w if w.shape[0] == D else w.T)
        elif sub == "attention.time_decay_w2":
            put("td_w2", li, w if w.shape[-1] == D else w.T)
        elif sub == "attention.time_faaaa":
            put("u", li, w.reshape(-1))
        elif sub in ("attention.receptance.weight",
                     "attention.q_proj.weight"):
            put("wr", li, w.T)
        elif sub in ("attention.key.weight",
                     "attention.k_proj.weight"):
            put("wk", li, w.T)
        elif sub in ("attention.value.weight",
                     "attention.v_proj.weight"):
            put("wv", li, w.T)
        elif sub in ("attention.receptance.bias",
                     "attention.q_proj.bias"):
            put("br", li, w)
        elif sub in ("attention.key.bias",
                     "attention.k_proj.bias"):
            put("bk", li, w)
        elif sub in ("attention.value.bias",
                     "attention.v_proj.bias"):
            put("bv", li, w)
        elif sub in ("attention.gate.weight",
                     "attention.g_proj.weight"):
            put("wg", li, w.T)
        elif sub in ("attention.output.weight",
                     "attention.o_proj.weight"):
            put("wo", li, w.T)
        elif sub == "attention.ln_x.weight":
            put("ln_x_w", li, w)
        elif sub == "attention.ln_x.bias":
            put("ln_x_b", li, w)
        elif sub == "feed_forward.time_maa_k":
            put("cm_lerp_k", li, w.reshape(-1))
        elif sub == "feed_forward.time_maa_r":
            put("cm_lerp_r", li, w.reshape(-1))
        elif sub == "feed_forward.key.weight":
            put("cm_key", li, w.T)
        elif sub == "feed_forward.receptance.weight":
            put("cm_receptance", li, w.T)
        elif sub == "feed_forward.value.weight":
            put("cm_value", li, w.T)
        elif sub == "mlp.gate_proj.weight":
            put("w_gate", li, w.T)
        elif sub == "mlp.up_proj.weight":
            put("w_up", li, w.T)
        elif sub == "mlp.down_proj.weight":
            put("w_down", li, w.T)
        else:
            log.warning("skipping rwkv6 layer tensor %s", name)

    layers: dict[str, np.ndarray] = {}
    for pname, by in per.items():
        missing = [i for i in range(L) if i not in by]
        if missing:
            raise ValueError(f"missing layers {missing} for {pname}")
        layers[pname] = np.stack([by[i] for i in range(L)])
    params = {**top, "layers": layers}
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg
