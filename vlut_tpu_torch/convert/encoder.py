"""HF encoder checkpoints -> the encoder checkpoint (own copy of the JAX
package's ``vlut_tpu/convert/encoder.py``: bert, modernbert, neobert,
nomic-bert and its MoE, jina-bert-v2 and jina-bert-v3's task LoRAs, and
xlm-roberta; reference: convert_hf_to_gguf's BertModel / ModernBertModel /
NomicBertModel / JinaBertV2Model / XLMRobertaModel converters and the GGUF
``pooling_type`` metadata).

Weights stay dense float32 on the host, in numpy, read through the port's
own safetensors reader; the checkpoint is array for array the JAX
converter's.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
from typing import Any

import numpy as np

from vlut_tpu_torch.convert.convert import _iter_hf_tensors, _save
from vlut_tpu_torch.models.encoder import EncoderConfig

log = logging.getLogger("vlut_tpu_torch.convert.encoder")


_BERT_LAYER = {
    "attention.self.query.weight": ("wq", True),
    "attention.self.query.bias": ("bq", False),
    "attention.self.key.weight": ("wk", True),
    "attention.self.key.bias": ("bk", False),
    "attention.self.value.weight": ("wv", True),
    "attention.self.value.bias": ("bv", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "attention.output.LayerNorm.weight": ("attn_norm", False),
    "attention.output.LayerNorm.bias": ("attn_norm_b", False),
    "intermediate.dense.weight": ("w_up", True),
    "intermediate.dense.bias": ("b_up", False),
    "output.dense.weight": ("w_down", True),
    "output.dense.bias": ("b_down", False),
    "output.LayerNorm.weight": ("ffn_norm", False),
    "output.LayerNorm.bias": ("ffn_norm_b", False),
}

_NEOBERT_LAYER = {
    "qkv.weight": ("wqkv", True),
    "wo.weight": ("wo", True),
    "attention_norm.weight": ("attn_norm", False),
    "ffn_norm.weight": ("ffn_norm", False),
    "ffn.w12.weight": ("w_in", True),
    "ffn.w3.weight": ("w_out", True),
}

_MODERNBERT_LAYER = {
    "attn.Wqkv.weight": ("wqkv", True),
    "attn.Wo.weight": ("wo", True),
    "attn_norm.weight": ("attn_norm", False),
    "mlp_norm.weight": ("mlp_norm", False),
    "mlp.Wi.weight": ("w_in", True),
    "mlp.Wo.weight": ("w_out", True),
}


def _nomic_max_len(raw: dict) -> int:
    """nomic n_positions clamp (reference NomicBertModel.__init__:
    8192/2048 -> 2048 for v1/v1.5, 2048/2048 -> 512 for v2-moe)."""
    npos = raw.get("n_positions", 2048)
    mtp = raw.get("max_trained_positions", 2048)
    if npos == 8192 and mtp == 2048:
        return 2048
    if npos == 2048 and mtp == 2048:
        return 512
    return npos


def _convert_bert_variant(
    hf_dir: pathlib.Path,
    out_dir: str | pathlib.Path,
    raw: dict,
    arch: str,
    pooling: str,
) -> EncoderConfig:
    """nomic-bert(-moe) / jina-bert-v2 / jina-bert-v3 (reference
    src/models/bert.cpp superset; converters NomicBertModel,
    JinaBertV2Model, XLMRobertaModel in convert_hf_to_gguf.py).
    Layers are stored as a tuple of per-layer dicts (MoE layers are
    heterogeneous); jina-v3 task LoRAs land in params['adapters']."""
    if arch.startswith("nomic"):
        moe = int(raw.get("moe_every_n_layers") or 0)
        cfg = EncoderConfig(
            arch=arch,
            vocab_size=raw["vocab_size"],
            d_model=raw["n_embd"],
            n_layers=raw["n_layer"],
            n_heads=raw["n_head"],
            d_ff=raw["n_inner"],
            max_seq_len=_nomic_max_len(raw),
            ln_eps=raw.get("layer_norm_epsilon", 1e-12),
            rope=True,
            rope_theta_global=raw.get("rotary_emb_base", 10000.0),
            ffn_kind="gelu_seq" if moe else "swiglu_par",
            moe_every=moe,
            n_experts=raw.get("num_experts", 0) or 0,
            moe_top_k=raw.get("moe_top_k", 2),
            pooling=pooling,
        )
    elif arch == "jina-bert-v2":
        cfg = EncoderConfig(
            arch=arch,
            vocab_size=raw["vocab_size"],
            d_model=raw["hidden_size"],
            n_layers=raw["num_hidden_layers"],
            n_heads=raw["num_attention_heads"],
            d_ff=raw["intermediate_size"],
            max_seq_len=raw.get("max_position_embeddings", 8192),
            ln_eps=raw.get("layer_norm_eps", 1e-12),
            alibi=True,                       # f_max_alibi_bias = 8
            ffn_kind="geglu",
            pooling=pooling,
        )
    else:  # jina-bert-v3 (XLMRoberta + lora_adaptations, served with rope)
        cfg = EncoderConfig(
            arch="jina-bert-v3",
            vocab_size=raw["vocab_size"],
            d_model=raw["hidden_size"],
            n_layers=raw["num_hidden_layers"],
            n_heads=raw["num_attention_heads"],
            d_ff=raw["intermediate_size"],
            max_seq_len=raw.get("max_position_embeddings", 8194),
            ln_eps=raw.get("layer_norm_eps", 1e-5),
            rope=True,
            rope_theta_global=raw.get("rotary_emb_base", 10000.0),
            ffn_kind="gelu_seq",
            lora_alpha=float(raw.get("lora_alpha", 1.0)),
            lora_tasks=tuple(raw.get("lora_adaptations", ())),
            pooling=pooling,
        )

    tops = {
        "embeddings.word_embeddings.weight": ("embed", False),
        "embeddings.token_type_embeddings.weight": ("type_embed", False),
        # nomic / jina-v3 flash scheme
        "emb_ln.weight": ("embed_norm", False),
        "emb_ln.bias": ("embed_norm_b", False),
        # jina-v2 bert scheme
        "embeddings.LayerNorm.weight": ("embed_norm", False),
        "embeddings.LayerNorm.bias": ("embed_norm_b", False),
    }
    lmap = {
        # nomic / jina-v3 (flash-attn module scheme)
        "attn.Wqkv.weight": ("wqkv", True),
        "attn.Wqkv.bias": ("bqkv", False),
        "mixer.Wqkv.weight": ("wqkv", True),
        "mixer.Wqkv.bias": ("bqkv", False),
        "attn.out_proj.weight": ("wo", True),
        "attn.out_proj.bias": ("bo", False),
        "mixer.out_proj.weight": ("wo", True),
        "mixer.out_proj.bias": ("bo", False),
        "norm1.weight": ("attn_norm", False),
        "norm1.bias": ("attn_norm_b", False),
        "norm2.weight": ("ffn_norm", False),
        "norm2.bias": ("ffn_norm_b", False),
        "mlp.fc11.weight": ("w_up", True),     # nomic swiglu: fc11 = up
        "mlp.fc12.weight": ("w_gate", True),   # fc12 = gate (silu side)
        "mlp.fc1.weight": ("w_up", True),      # gelu-seq dense layers
        "mlp.fc1.bias": ("b_up", False),
        "mlp.fc2.weight": ("w_down", True),
        "mlp.fc2.bias": ("b_down", False),
        "mlp.router.layer.weight": ("router", True),
        # jina-v2 (bert scheme + GEGLU mlp)
        "attention.self.query.weight": ("wq", True),
        "attention.self.query.bias": ("bq", False),
        "attention.self.key.weight": ("wk", True),
        "attention.self.key.bias": ("bk", False),
        "attention.self.value.weight": ("wv", True),
        "attention.self.value.bias": ("bv", False),
        "attention.self.layer_norm_q.weight": ("q_norm", False),
        "attention.self.layer_norm_q.bias": ("q_norm_b", False),
        "attention.self.layer_norm_k.weight": ("k_norm", False),
        "attention.self.layer_norm_k.bias": ("k_norm_b", False),
        "attention.output.dense.weight": ("wo", True),
        "attention.output.dense.bias": ("bo", False),
        "attention.output.LayerNorm.weight": ("attn_norm", False),
        "attention.output.LayerNorm.bias": ("attn_norm_b", False),
        "layer_norm_1.weight": ("attn_norm2", False),    # jina-v2-code
        "layer_norm_1.bias": ("attn_norm2_b", False),
        "mlp.gated_layers.weight": ("w_in", True),       # GEGLU [gate; up]
        "mlp.gated_layers.bias": ("b_in", False),
        "mlp.up_gated_layer.weight": ("w_in", True),     # jina-v2-code
        "mlp.wo.weight": ("w_down", True),
        "mlp.wo.bias": ("b_down", False),
        "mlp.down_layer.weight": ("w_down", True),       # jina-v2-code
        "mlp.layernorm.weight": ("ffn_norm", False),
        "mlp.layernorm.bias": ("ffn_norm_b", False),
        "layer_norm_2.weight": ("ffn_norm", False),      # jina-v2-code
        "layer_norm_2.bias": ("ffn_norm_b", False),
    }

    top: dict[str, Any] = {}
    per: list[dict[str, Any]] = [{} for _ in range(cfg.n_layers)]
    # adapters[task][path] = (a, b) with w_stored + alpha/r * a @ b
    adapters: dict[str, dict[str, tuple]] = {
        t: {} for t in cfg.lora_tasks
    }
    lre = re.compile(r"encoder\.layers?\.(\d+)\.(.+)$")
    for name, w in _iter_hf_tensors(hf_dir):
        for p in ("bert.", "model.", "roberta."):
            if name.startswith(p):
                name = name[len(p):]
        # jina-v3 parametrized weights: '.parametrizations.weight.original'
        # is the base tensor; '.parametrizations.weight.0.lora_A/B' are the
        # per-task stacks (reference XLMRobertaModel.modify_tensors)
        lora_kind = None
        if ".parametrizations." in name:
            if name.endswith(".original"):
                name = name.replace(".parametrizations.", ".")[
                    : -len(".original")]
            elif name.endswith((".0.lora_A", ".0.lora_B")):
                lora_kind = name[-6:].lower()   # "lora_a" | "lora_b"
                name = name.replace(".parametrizations.", ".")[
                    : -len(".0.lora_A")]
            else:
                continue
        w = np.asarray(w, np.float32)
        if lora_kind is not None:
            # stacked (n_tasks, r, in) A / (n_tasks, out, r) B for a HF
            # (out, in) Linear; stored orientation is (in, out), so the
            # delta is aT @ bT per task
            m = lre.match(name)
            if m and name.endswith(".weight"):
                path = None
                sub = m.group(2)
                ent = lmap.get(sub)
                if ent:
                    # '/'-separated so checkpoint _flatten (dot-nested)
                    # round-trips adapter paths as single keys
                    path = f"layers/{m.group(1)}/{ent[0]}"
            elif name == "embeddings.word_embeddings.weight":
                path = "embed"
            elif name == "embeddings.token_type_embeddings.weight":
                path = "type_embed"
            else:
                path = None
            if path is None:
                log.warning("skipping unrecognized lora tensor %s", name)
                continue
            for ti, task in enumerate(cfg.lora_tasks):
                slot = adapters[task].setdefault(path, [None, None])
                if lora_kind == "lora_a":
                    # embeddings: A indexes rows directly (V, r) after .T
                    slot[0] = np.ascontiguousarray(w[ti].T)
                else:
                    slot[1] = np.ascontiguousarray(w[ti].T)
            continue
        if name in tops:
            top[tops[name][0]] = w
            continue
        m = lre.match(name)
        if not m:
            if not name.startswith(("pooler.", "cls.", "head.", "decoder.",
                                    "classifier.", "lm_head.",
                                    "embeddings.position_embeddings")):
                log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        lp = per[li]
        if sub in ("mlp.experts.mlp.w1", "mlp.experts.mlp.w2"):
            # nomic-moe flat (E*n_inner, n_embd) expert stacks (reference
            # NomicBertModel.modify_tensors view+transpose): per expert
            # y = gelu(h @ w1_e.T) @ w2_e
            E, ff = cfg.n_experts, cfg.d_ff
            w3 = w.reshape(E, ff, cfg.d_model)
            if sub.endswith("w1"):
                lp["e_up"] = np.ascontiguousarray(w3.transpose(0, 2, 1))
            else:
                lp["e_down"] = np.ascontiguousarray(w3)
            continue
        if sub == "mlp.experts.bias":
            continue  # unused in the reference graph too
        ent = lmap.get(sub)
        if ent is None:
            log.warning("skipping unrecognized layer tensor %s", name)
            continue
        pname, transpose = ent
        lp[pname] = w.T if transpose else w

    params: dict[str, Any] = {**top, "layers": tuple(per)}
    if cfg.lora_tasks:
        params["adapters"] = {
            t: {k: {"a": a, "b": b} for k, (a, b) in d.items()
                if a is not None and b is not None}
            for t, d in adapters.items()
        }
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg


def convert_encoder(
    hf_dir: str | pathlib.Path,
    out_dir: str | pathlib.Path,
    pooling: str | None = None,
    dtype_hp: str = "float32",
) -> EncoderConfig:
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    mt = raw.get("model_type", "")
    archs = raw.get("architectures", []) or []
    if mt not in ("bert", "modernbert", "neobert", "nomic_bert",
                  "xlm-roberta"):
        raise ValueError(f"not an encoder checkpoint: model_type={mt!r}")

    if pooling is None:
        # sentence-transformers checkpoints carry a pooling module config
        pooling = "mean"
        pj = hf_dir / "1_Pooling" / "config.json"
        if pj.exists():
            pc = json.loads(pj.read_text())
            if pc.get("pooling_mode_cls_token"):
                pooling = "cls"
        elif mt == "modernbert":
            pooling = raw.get("classifier_pooling", "cls")

    if mt == "nomic_bert":
        arch = ("nomic-bert-moe" if raw.get("moe_every_n_layers")
                else "nomic-bert")
        return _convert_bert_variant(hf_dir, out_dir, raw, arch, pooling)
    if mt == "xlm-roberta" and raw.get("lora_adaptations"):
        return _convert_bert_variant(hf_dir, out_dir, raw, "jina-bert-v3",
                                     pooling)
    if mt == "bert" and any("JinaBert" in a for a in archs):
        return _convert_bert_variant(hf_dir, out_dir, raw, "jina-bert-v2",
                                     pooling)

    if mt == "bert":
        cfg = EncoderConfig(
            arch="bert",
            vocab_size=raw["vocab_size"],
            d_model=raw["hidden_size"],
            n_layers=raw["num_hidden_layers"],
            n_heads=raw["num_attention_heads"],
            d_ff=raw["intermediate_size"],
            max_seq_len=raw.get("max_position_embeddings", 512),
            ln_eps=raw.get("layer_norm_eps", 1e-12),
            type_vocab_size=raw.get("type_vocab_size", 2),
            pooling=pooling,
        )
        layer_map, prefix = _BERT_LAYER, "encoder.layer."
    elif mt == "neobert":
        # NeoBERT (reference src/models/neo-bert.cpp + tensor_mapping
        # 'transformer_encoder' scheme): RMS pre-norms, fused qkv, rope,
        # swiglu-fused w12/w3 FFN
        cfg = EncoderConfig(
            arch="neobert",
            vocab_size=raw["vocab_size"],
            d_model=raw["hidden_size"],
            n_layers=raw["num_hidden_layers"],
            n_heads=raw["num_attention_heads"],
            d_ff=raw["intermediate_size"],
            max_seq_len=raw.get("max_length",
                                raw.get("max_position_embeddings", 4096)),
            ln_eps=raw.get("norm_eps", 1e-5),
            rope_theta_global=raw.get("rope_theta", 10000.0),
            pooling=pooling,
        )
        layer_map, prefix = _NEOBERT_LAYER, "transformer_encoder."
    else:
        cfg = EncoderConfig(
            arch="modernbert",
            vocab_size=raw["vocab_size"],
            d_model=raw["hidden_size"],
            n_layers=raw["num_hidden_layers"],
            n_heads=raw["num_attention_heads"],
            d_ff=raw["intermediate_size"],
            max_seq_len=raw.get("max_position_embeddings", 8192),
            ln_eps=raw.get("norm_eps", 1e-5),
            local_window=raw.get("local_attention", 128),
            global_every=raw.get("global_attn_every_n_layers", 3),
            rope_theta_global=raw.get("global_rope_theta", 160000.0),
            rope_theta_local=(
                raw.get("local_rope_theta") or
                raw.get("global_rope_theta", 160000.0)
            ),
            pooling=pooling,
        )
        layer_map, prefix = _MODERNBERT_LAYER, "layers."

    top: dict[str, Any] = {}
    per: dict[str, dict[int, np.ndarray]] = {}
    lre = re.compile(rf"{re.escape(prefix)}(\d+)\.(.+)$")
    for name, w in _iter_hf_tensors(hf_dir):
        # strip common wrapper prefixes (BertModel inside *ForMaskedLM etc.)
        for p in ("bert.", "model.", "roberta."):
            if name.startswith(p):
                name = name[len(p):]
        w = np.asarray(w, np.float32)
        if mt == "bert":
            tops = {
                "embeddings.word_embeddings.weight": "embed",
                "embeddings.position_embeddings.weight": "pos_embed",
                "embeddings.token_type_embeddings.weight": "type_embed",
                "embeddings.LayerNorm.weight": "embed_norm",
                "embeddings.LayerNorm.bias": "embed_norm_b",
            }
        elif mt == "neobert":
            tops = {
                "encoder.weight": "embed",
                "layer_norm.weight": "final_norm",
            }
        else:
            tops = {
                "embeddings.tok_embeddings.weight": "embed",
                "embeddings.norm.weight": "embed_norm",
                "final_norm.weight": "final_norm",
            }
        if name in tops:
            top[tops[name]] = w
            continue
        m = lre.match(name)
        if not m:
            if not name.startswith(("pooler.", "cls.", "head.",
                                    "decoder.", "classifier.")):
                log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        entry = layer_map.get(sub)
        if entry is None:
            log.warning("skipping unrecognized layer tensor %s", name)
            continue
        pname, transpose = entry
        per.setdefault(pname, {})[li] = w.T if transpose else w

    L = cfg.n_layers
    layers: dict[str, np.ndarray] = {}
    for pname, by_layer in per.items():
        missing = [i for i in range(L) if i not in by_layer]
        if missing:
            if pname == "attn_norm" and mt == "modernbert":
                # layer 0's attn_norm is Identity in ModernBERT — store a
                # unit gain so the stacked scan layout stays homogeneous
                # (forward_encoder skips the norm for layer 0 anyway)
                by_layer = dict(by_layer)
                for i in missing:
                    by_layer[i] = np.ones(cfg.d_model, np.float32)
            else:
                raise ValueError(f"missing layers {missing} for {pname}")
        layers[pname] = np.stack([by_layer[i] for i in range(L)])

    params = {**top, "layers": layers}
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg
