"""HF Gemma3n checkpoints -> the gemma3n checkpoint (own copy of the JAX
package's ``vlut_tpu/convert/gemma3n.py``; reference: the Gemma3NModel
converter, which keeps the altup / laurel / per-layer tensors and drops
the vision and audio towers).

Handles both Gemma3nForCausalLM (flat text config) and
Gemma3nForConditionalGeneration (nested text_config;
``model.language_model.`` tensor prefix).  The weights stay float32 on
the host, in numpy; the checkpoint is array for array the JAX
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
from vlut_tpu_torch.models.gemma3n import Gemma3nConfig

log = logging.getLogger("vlut_tpu_torch.convert.gemma3n")


_TOP = {
    "embed_tokens.weight": ("embed", False),
    "embed_tokens_per_layer.weight": ("embed_per_layer", False),
    "per_layer_model_projection.weight": ("per_layer_model_proj", True),
    "per_layer_projection_norm.weight": ("per_layer_proj_norm", False),
    "norm.weight": ("final_norm", False),
}

_LAYER = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("post_attn_norm", False),
    "pre_feedforward_layernorm.weight": ("ffn_norm", False),
    "post_feedforward_layernorm.weight": ("post_ffn_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "altup.correct_output_scale": ("altup_correct_scale", False),
    "altup.correction_coefs.weight": ("altup_correct_coef", True),
    "altup.prediction_coefs.weight": ("altup_predict_coef", True),
    "altup.modality_router.weight": ("altup_router", True),
    "altup.router_norm.weight": ("altup_router_norm", False),
    "laurel.linear_left.weight": ("laurel_l", True),
    "laurel.linear_right.weight": ("laurel_r", True),
    "laurel.post_laurel_norm.weight": ("laurel_post_norm", False),
    "per_layer_input_gate.weight": ("per_layer_inp_gate", True),
    "per_layer_projection.weight": ("per_layer_proj", True),
    "post_per_layer_input_norm.weight": ("per_layer_post_norm", False),
}


def convert_gemma3n(
    hf_dir: str | pathlib.Path, out_dir: str | pathlib.Path
) -> Gemma3nConfig:
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    tc = raw.get("text_config", raw)
    nl = tc["num_hidden_layers"]
    d_ff = tc["intermediate_size"]
    if isinstance(d_ff, int):
        d_ff = [d_ff] * nl
    lt = tc.get("layer_types") or [
        # gemma3n default 5:1 local/global pattern (set_swa_pattern(5))
        "full_attention" if (i + 1) % 5 == 0 else "sliding_attention"
        for i in range(nl)
    ]
    sparsity = tc.get("activation_sparsity_pattern")
    if sparsity is None:
        # reference n_layer_sparsity=10, f_sparsity_std_mul from 95%
        sparsity = [0.95 if i < 10 else 0.0 for i in range(nl)]
    cfg = Gemma3nConfig(
        vocab_size=tc["vocab_size"],
        d_model=tc["hidden_size"],
        n_layers=nl,
        n_heads=tc["num_attention_heads"],
        n_kv_heads=tc["num_key_value_heads"],
        head_dim=tc.get("head_dim", 256),
        d_ff=tuple(d_ff),
        layer_types=tuple(lt),
        sliding_window=tc.get("sliding_window", 512),
        rms_eps=tc.get("rms_norm_eps", 1e-6),
        rope_theta=tc.get("rope_theta", 1000000.0),
        rope_theta_local=tc.get("rope_local_base_freq", 10000.0),
        n_altup=tc.get("altup_num_inputs", 4),
        altup_active=tc.get("altup_active_idx", 0),
        altup_correct_scale=tc.get("altup_correct_scale", True),
        laurel_rank=tc.get("laurel_rank", 64),
        pl_dim=tc.get("hidden_size_per_layer_input", 256),
        pl_vocab=tc.get("vocab_size_per_layer_input", tc["vocab_size"]),
        n_kv_shared=tc.get("num_kv_shared_layers", 0),
        sparsity=tuple(float(s) for s in sparsity),
        logit_softcap=tc.get("final_logit_softcapping") or 0.0,
        max_seq_len=tc.get("max_position_embeddings", 32768),
    )

    top: dict[str, Any] = {}
    per: list[dict[str, Any]] = [{} for _ in range(nl)]
    aproj: dict[int, np.ndarray] = {}
    uproj: dict[int, np.ndarray] = {}
    lre = re.compile(r"layers\.(\d+)\.(.+)$")
    for name, w in _iter_hf_tensors(hf_dir):
        # undo HF's _checkpoint_conversion_mapping save-time rename
        # ("model" -> "model.language_model" — a substring replace that
        # also mangles per_layer_model_projection)
        name = name.replace("model.language_model", "model")
        for p in ("model.language_model.", "language_model.model.",
                  "model.", "language_model."):
            if name.startswith(p):
                name = name[len(p):]
                break
        if name.startswith(("vision_tower", "audio_tower",
                            "embed_vision", "embed_audio",
                            "multi_modal_projector")):
            continue  # text-only serving (reference drops these too)
        w = np.asarray(w, np.float32)
        if name == "lm_head.weight":
            top["lm_head"] = w.T
            continue
        if name in _TOP:
            pname, tr = _TOP[name]
            top[pname] = w.T if tr else w
            continue
        m = re.match(r"altup_projections\.(\d+)\.weight$", name)
        if m:
            aproj[int(m.group(1))] = w.T
            continue
        m = re.match(r"altup_unembed_projections\.(\d+)\.weight$", name)
        if m:
            uproj[int(m.group(1))] = w.T
            continue
        m = lre.match(name)
        if not m:
            log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        ent = _LAYER.get(sub)
        if ent is None:
            log.warning("skipping unrecognized layer tensor %s", name)
            continue
        pname, tr = ent
        per[li][pname] = w.T if tr else w

    n_extra = cfg.n_altup - 1
    top["altup_proj"] = np.stack([aproj[i] for i in range(n_extra)])
    top["altup_unembed_proj"] = np.stack([uproj[i] for i in range(n_extra)])
    params = {**top, "layers": tuple(per)}
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg
