"""HF checkpoint -> packed ternary checkpoint (own copy of the JAX package's
``vlut_tpu/convert/convert.py``, its text families and Mamba / Mamba2).

Reads a HF directory (``config.json`` + ``*.safetensors``), ternarizes the
projections, packs them to i2 / i1 and writes the checkpoint every serving
path loads, array for array what the JAX converter writes:

* a tensor whose value set is {-s, 0, +s} is packed exactly (lossless);
  anything else goes through BitNet absmean ternarization with a warning;
* HF1BitLLM's packed uint8 (four 2-bit trits along the output axis) with
  its inverted ``weight_scale`` is unpacked;
* fused projections are split, biases and norms mapped, MoE expert stacks
  and MLA's absorbed ``w_uk`` / ``w_uv`` built.

Every float operation that decides a trit, a scale or a stored value runs
on the host in numpy float32, in the JAX converter's order, so the
checkpoint is the same on either device.  The integer work (the uint8
2-bit unpack, the padding and the trits-to-bytes pack) runs on ``device``:
the GPU unless the caller asks for the CPU.  BF16 sources are read through
the port's own safetensors reader and upcast exactly (the bits shifted up
16), and every cast to bf16 rounds a float32 array to nearest even, as
the JAX converter's ``jnp.asarray(float32).astype(bfloat16)`` does.

The family converters (RWKV, the SSM hybrids, the encoders, gemma3n and
T5; ``convert/{rwkv,hybrid,encoder,gemma3n,t5}.py``) are dispatched from
:func:`convert_hf` as the JAX converter dispatches them.  A checkpoint's
vision tower (CLIP/llava, SigLIP, pixtral, qwen2/2.5-vl, internvl, llama4,
idefics3, glm4v, qwen3-vl, janus, lfm2-vl's siglip2) is written beside it
as the JAX converter's sidecar (``convert/vision.py``), and cogvlm's visual
experts are packed as the ``vis_*`` projections.

    python -m vlut_tpu_torch.convert.convert HF OUT [--fmt i1] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import re
from typing import Any, Iterator

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.convert.checkpoint import (
    safetensors_open, safetensors_tensor, save_checkpoint)
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models.dims import make_plan, pad_vec_heads, scatter_vec
from vlut_tpu_torch.models.transformer import pack_weight
from vlut_tpu_torch.ops.packing import pack_ternary, ternarize

log = logging.getLogger("vlut_tpu_torch.convert")

# HF name -> our layer-param name (weights transposed to (K, N) at pack time)
_PROJ_MAP = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    # afmoe sigmoid attention gate (canon renames self_attn.gate_proj)
    "self_attn.attn_gate_proj": "w_attn_gate",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}
_NORM_MAP = {
    "input_layernorm": "attn_norm",
    "post_attention_layernorm": "ffn_norm",
    # BitNet sub-norms (HF 1bitLLM naming)
    "self_attn.inner_attn_ln": "attn_sub_norm",
    "mlp.ffn_layernorm": "ffn_sub_norm",
    "post_attention_layernorm_2": "ffn_sub_norm",
    # qwen3/gemma3 per-head q/k norms
    "self_attn.q_norm": "q_norm",
    "self_attn.k_norm": "k_norm",
    # arctic MoE-branch norm (FFN_NORM_EXPS; canon() renames
    # post_attention_layernorm -> moe_layernorm for that arch)
    "moe_layernorm": "moe_norm",
}
# gemma2/gemma3 sandwich norms: post_attention_layernorm is the POST-attn
# norm there, and the pre-FFN norm has its own name
_NORM_MAP_POSTNORM = {
    **_NORM_MAP,
    "post_attention_layernorm": "post_attn_norm",
    "pre_feedforward_layernorm": "ffn_norm",
    "post_feedforward_layernorm": "post_ffn_norm",
}
_BIAS_MAP = {
    "self_attn.q_proj": "bq",
    "self_attn.k_proj": "bk",
    "self_attn.v_proj": "bv",
}
# gptneox/phi-2/starcoder2 bias-everywhere archs (cfg.proj_bias)
_PROJ_BIAS_MAP = {
    "self_attn.o_proj": "bo",
    "mlp.up_proj": "b_up",
    "mlp.down_proj": "b_down",
}
# MoE: router + per-expert projections (mixtral w1/w3/w2 = gate/up/down)
_MOE_EXPERT_RE = re.compile(
    r"(?:block_sparse_moe|mlp)\.experts\.(\d+)\."
    r"(w1|w2|w3|gate_proj|up_proj|down_proj)$"
)
_MOE_EXPERT_MAP = {
    "w1": "w_gate", "w3": "w_up", "w2": "w_down",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}



def config_from_hf(hf_dir: pathlib.Path) -> ModelConfig:
    """HF config.json -> ModelConfig.  Arch families map onto the
    config-driven superset (the reference's per-arch graph builders,
    src/models/*.cpp): llama/mistral, bitnet, qwen2(+moe), qwen3(+moe),
    gemma/gemma2/gemma3, mixtral, phi3, falcon3/trilm (LLAMA-arch)."""
    raw = json.loads((hf_dir / "config.json").read_text())
    if "text_config" in raw:  # llava-style composite config
        raw = {**raw["text_config"],
               "model_type": raw["text_config"].get("model_type", "llama")}
    archs = raw.get("architectures", [])
    mt = raw.get("model_type", "")
    is_bitnet = any("bitnet" in a.lower() for a in archs) or (
        mt in ("bitnet", "bitllama")
    )
    # key aliases: gpt2/bloom/mpt serialize their own config key names
    # (the analog of gguf-py's per-arch hparam lookups)
    if mt == "gpt2":
        raw.setdefault("hidden_size", raw.get("n_embd"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        raw.setdefault(
            "intermediate_size", raw.get("n_inner") or 4 * raw["n_embd"]
        )
        raw.setdefault("max_position_embeddings", raw.get("n_positions", 1024))
    elif mt == "bloom":
        raw.setdefault("hidden_size", raw.get("n_embed"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        raw.setdefault("intermediate_size", 4 * raw["hidden_size"])
        raw.setdefault("max_position_embeddings", 2048)
    elif mt == "mpt":
        raw.setdefault("hidden_size", raw.get("d_model"))
        raw.setdefault("num_hidden_layers", raw.get("n_layers"))
        raw.setdefault("num_attention_heads", raw.get("n_heads"))
        raw.setdefault(
            "intermediate_size",
            raw.get("expansion_ratio", 4) * raw["d_model"],
        )
        raw.setdefault("max_position_embeddings", raw.get("max_seq_len", 2048))
        kvh = (raw.get("attn_config") or {}).get("kv_n_heads")
        if kvh:
            raw.setdefault("num_key_value_heads", kvh)
    elif mt == "opt":
        raw.setdefault("intermediate_size", raw.get("ffn_dim"))
    elif mt in ("gptj", "gpt_bigcode"):
        raw.setdefault("hidden_size", raw.get("n_embd"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        raw.setdefault(
            "intermediate_size", raw.get("n_inner") or 4 * raw["n_embd"]
        )
        raw.setdefault("max_position_embeddings", raw.get("n_positions", 2048))
        if mt == "gpt_bigcode":
            raw.setdefault(
                "num_key_value_heads",
                1 if raw.get("multi_query", True) else raw["n_head"],
            )
    elif mt == "falcon":
        if raw.get("new_decoder_architecture"):
            nkv = raw.get("num_kv_heads") or raw["num_attention_heads"]
        else:
            nkv = (1 if raw.get("multi_query", True)
                   else raw["num_attention_heads"])
        raw.setdefault("num_key_value_heads", nkv)
        raw.setdefault(
            "intermediate_size",
            raw.get("ffn_hidden_size") or 4 * raw["hidden_size"],
        )
        raw.setdefault("max_position_embeddings", 2048)
    elif mt == "llada":
        raw.setdefault("hidden_size", raw.get("d_model"))
        raw.setdefault("num_hidden_layers", raw.get("n_layers"))
        raw.setdefault("num_attention_heads", raw.get("n_heads"))
        raw.setdefault("num_key_value_heads",
                       raw.get("n_kv_heads") or raw.get("n_heads"))
        raw.setdefault("intermediate_size", raw.get("mlp_hidden_size"))
        raw.setdefault("max_position_embeddings",
                       raw.get("max_sequence_length", 4096))
    elif mt == "qwen":
        raw.setdefault("hidden_size", raw.get("n_embd"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        # qwen v1 serializes DOUBLE the SwiGLU width in intermediate_size
        raw["intermediate_size"] = (
            raw.get("ffn_hidden_size")
            or raw.get("intermediate_size", 4 * raw["hidden_size"])
        ) // 2
        raw.setdefault("rope_theta", raw.get("rotary_emb_base", 10000.0))
        raw.setdefault("max_position_embeddings",
                       raw.get("seq_length", 2048))
        raw.setdefault("rms_norm_eps", raw.get("layer_norm_epsilon", 1e-6))
    elif mt == "exaone":
        # EXAONE-3.x (reference src/models/exaone.cpp — a plain llama
        # graph; convert_hf_to_gguf.py ExaoneModel): own config key names
        raw.setdefault("num_hidden_layers", raw.get("num_layers"))
        raw.setdefault("rms_norm_eps", raw.get("layer_norm_epsilon", 1e-5))
    elif mt == "jais":
        raw.setdefault("hidden_size", raw.get("n_embd"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        raw.setdefault(
            "intermediate_size", raw.get("n_inner") or 4 * raw["hidden_size"]
        )
        raw.setdefault("max_position_embeddings",
                       raw.get("n_positions", 2048))
    elif mt == "chatglm":
        # ChatGLM3/GLM-4 (THUDM): own config key names
        raw.setdefault("num_hidden_layers", raw.get("num_layers"))
        raw.setdefault("vocab_size", raw.get("padded_vocab_size"))
        raw.setdefault("intermediate_size", raw.get("ffn_hidden_size"))
        if raw.get("multi_query_attention"):
            raw.setdefault("num_key_value_heads",
                           raw.get("multi_query_group_num"))
        raw.setdefault("rms_norm_eps", raw.get("layernorm_epsilon", 1e-5))
        # rope_ratio multiplies the 10k base (ChatGLM RotaryEmbedding)
        raw.setdefault("rope_theta", 10000.0 * raw.get("rope_ratio", 1.0))
        raw.setdefault("max_position_embeddings",
                       raw.get("seq_length", 2048))
    elif mt == "codeshell":
        raw.setdefault("hidden_size", raw.get("n_embd"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        raw.setdefault("num_key_value_heads", raw.get("num_query_groups", 1))
        raw.setdefault(
            "intermediate_size", raw.get("n_inner") or 4 * raw["n_embd"]
        )
        raw.setdefault("max_position_embeddings", raw.get("n_positions",
                                                           8192))
    elif mt == "refact":
        # Refact-1.6B: llama-style FFN width derived, not serialized
        # (reference convert RefactModel.set_gguf_parameters)
        raw.setdefault("hidden_size", raw.get("n_embd"))
        raw.setdefault("num_hidden_layers", raw.get("n_layer"))
        raw.setdefault("num_attention_heads", raw.get("n_head"))
        raw.setdefault("num_key_value_heads", 1)  # MQA
        inner = 4 * raw["hidden_size"]
        hidden = int(2 * inner / 3)
        raw.setdefault("intermediate_size", 256 * ((hidden + 255) // 256))
        raw.setdefault("rms_norm_eps", raw.get("layer_norm_epsilon", 1e-5))
        raw.setdefault("max_position_embeddings", raw.get("n_positions",
                                                           4096))
    elif mt == "dbrx":
        ac = raw.get("attn_config") or {}
        fc = raw.get("ffn_config") or {}
        raw.setdefault("hidden_size", raw.get("d_model"))
        raw.setdefault("num_hidden_layers", raw.get("n_layers"))
        raw.setdefault("num_attention_heads", raw.get("n_heads"))
        raw.setdefault("num_key_value_heads",
                       ac.get("kv_n_heads") or raw["n_heads"])
        raw.setdefault("intermediate_size",
                       fc.get("ffn_hidden_size") or 4 * raw["d_model"])
        raw.setdefault("rope_theta", ac.get("rope_theta", 10000.0))
        raw.setdefault("max_position_embeddings",
                       raw.get("max_seq_len", 2048))
    elif mt == "openelm":
        # apple OpenELM (reference src/models/openelm.cpp + OpenELMModel
        # converter): per-layer query/kv head counts and FFN widths
        # (ffn_multipliers -> make_divisible)
        def _mkdiv(v, divisor):
            nv = max(divisor, int(v + divisor / 2) // divisor * divisor)
            return nv + divisor if nv < 0.9 * v else nv

        nqh = raw["num_query_heads"]
        nkvh = raw["num_kv_heads"]
        ffd = [
            _mkdiv(m * raw["model_dim"], raw.get("ffn_dim_divisor", 256))
            for m in raw["ffn_multipliers"]
        ]
        raw.setdefault("hidden_size", raw["model_dim"])
        raw.setdefault("num_hidden_layers", raw["num_transformer_layers"])
        raw.setdefault("num_attention_heads", max(nqh))
        raw.setdefault("num_key_value_heads", max(nkvh))
        raw.setdefault("intermediate_size", max(ffd))
        raw.setdefault("rms_norm_eps", 1e-6)
        raw.setdefault("rope_theta", raw.get("rope_freq_constant", 10000.0))
        raw.setdefault("max_position_embeddings",
                       raw.get("max_context_length", 2048))
        raw.setdefault("head_dim", raw.get("head_dim", 64))
        raw.setdefault("tie_word_embeddings",
                       raw.get("share_input_output_layers", True))
        raw["_openelm_ffd"] = ffd
    elif mt in ("deci", "nemotron-nas") and raw.get("block_configs"):
        # DeciLM / Llama-3_1-Nemotron (reference src/models/deci.cpp +
        # DeciModel converter): per-block attention kind (normal GQA /
        # replace_with_linear / no-op) and FFN width (ffn_mult / no-op)
        def _find_mult(n, k):
            return n if n % k == 0 else n + k - (n % k)

        nh = raw["num_attention_heads"]
        kv_l, ffd = [], []
        for bc in raw["block_configs"]:
            at, ff_ = bc["attention"], bc["ffn"]
            if at.get("n_heads_in_group") is None:
                kv_l.append(
                    (nh, 0) if at.get("replace_with_linear") else (0, 0)
                )
            else:
                kv_l.append((nh, nh // at["n_heads_in_group"]))
            m = ff_.get("ffn_mult")
            ffd.append(
                0 if m is None or ff_.get("no_op")
                else _find_mult(int(2 * m * raw["hidden_size"] / 3), 256)
            )
        raw.setdefault("num_key_value_heads",
                       max((kv for _, kv in kv_l), default=nh) or nh)
        raw.setdefault("intermediate_size", max(ffd) or 256)
        raw["_deci_heads"] = kv_l
        raw["_deci_ffd"] = ffd
    elif mt in ("plamo3", "plamo-3"):
        # PLaMo-3 (reference src/models/plamo3.cpp): fused qkv, per-head
        # qk-norm (+1-offset weights folded at convert), sandwich norms,
        # fused-swiglu SEQ FFN, per-layer local rope theta on SWA layers
        raw.setdefault("num_key_value_heads",
                       raw.get("num_key_value_heads",
                               raw["num_attention_heads"]))
        raw.setdefault("rms_norm_eps", raw.get("rms_norm_eps", 1e-5))
    d_model = raw["hidden_size"]
    extra: dict[str, Any] = {}
    if mt in ("qwen2", "qwen2_moe", "qwen2_vl_text", "qwen2_vl",
              "qwen2_5_vl", "qwen2_5_vl_text"):
        extra.update(qkv_bias=True)
    if mt in ("qwen3_vl_text", "qwen3_vl", "qwen3_vl_moe_text",
              "qwen3_vl_moe"):
        # qwen3-vl text: qwen3 body (per-head qk-norm) with INTERLEAVED
        # M-RoPE (Qwen3VLTextRotaryEmbedding.apply_interleaved_mrope)
        extra.update(qk_norm=True)
        rs = dict(raw.get("rope_scaling") or {})
        rs.setdefault("mrope_section", [24, 20, 20])
        rs["mrope_interleaved"] = True
        raw["rope_scaling"] = rs
    if mt in ("qwen3", "qwen3_moe"):
        extra.update(qk_norm=True)
    if mt.startswith("gemma"):
        extra.update(
            act_fn="gelu", embed_scale=d_model ** 0.5, norm_plus_one=True,
        )
    if mt == "gemma2":
        extra.update(
            post_norms=True,
            attn_logit_softcap=raw.get("attn_logit_softcapping", 50.0),
            final_logit_softcap=raw.get("final_logit_softcapping", 30.0),
            sliding_window=raw.get("sliding_window", 4096),
            sliding_window_pattern=2,
        )
        qpas = raw.get("query_pre_attn_scalar")
        if qpas:
            extra.update(attn_scale=qpas ** -0.5)
    if mt == "gemma3_text" or mt == "gemma3":
        extra.update(
            post_norms=True, qk_norm=True,
            sliding_window=raw.get("sliding_window", 1024),
            sliding_window_pattern=raw.get("sliding_window_pattern", 6),
            # SWA layers rope with rope_local_base_freq and no scaling
            # (reference: gemma3 get_rope_freq_base per-layer dispatch)
            rope_theta_local=raw.get("rope_local_base_freq", 10000.0),
        )
        qpas = raw.get("query_pre_attn_scalar")
        if qpas:
            extra.update(attn_scale=qpas ** -0.5)
    if mt in ("llada", "dream", "rnd1"):
        # masked-diffusion LMs: bidirectional attention + a mask token
        # (reference examples/diffusion; GGUF add_causal_attention(False)).
        # llada predicts in place (no logit shift); dream/rnd1 keep the
        # next-token shift (LLaDAModel add_diffusion_shift_logits(False))
        extra.update(
            causal_attn=False,
            mask_token_id=raw.get("mask_token_id", 0) or 0,
            diffusion_shift_logits=(mt != "llada"),
        )
        if mt == "dream":
            extra.update(qkv_bias=True)
        if mt == "rnd1":
            extra.update(qkv_bias=True)  # qwen2-moe body
    if mt == "baichuan":
        # baichuan 7B = llama + fused W_pack; 13B (hidden 5120) = ALiBi
        # (reference src/models/baichuan.cpp: rope only for LLM_TYPE_7B,
        # 13B relies on max_alibi_bias)
        if raw.get("position_embedding_type") == "alibi" or (
            "position_embedding_type" not in raw and d_model >= 5120
        ):
            extra.update(pos_embed="alibi")
    if mt == "orion":
        # orion: llama body with biased LayerNorms
        # (src/models/orion.cpp LLM_NORM + *_norm_b)
        extra.update(norm_type="ln")
    if mt == "qwen":
        # qwen v1: fused biased c_attn, RMSNorm under gpt2-ish names,
        # w2=gate / w1=up SwiGLU (src/models/qwen.cpp)
        extra.update(qkv_bias=True)
    if mt == "jais":
        # jais: gpt2 body + ALiBi + biased SwiGLU + muP scales
        # (src/models/jais.cpp: LLM_NORM + bqkv + 1/n_embd_head attn scale;
        # embeddings/logit scales folded per convert_hf_to_gguf JaisModel)
        hd_j = d_model // raw["num_attention_heads"]
        emb_s = raw.get("mup_embeddings_scale",
                        raw.get("embeddings_scale", 1.0))
        out_s = raw.get("mup_output_alpha", raw.get(
            "output_logits_scale", 1.0))
        if "mup_output_alpha" in raw:
            out_s = out_s * raw.get("mup_width_scale", 1.0)
        extra.update(
            norm_type="ln", qkv_bias=True, proj_bias=True,
            pos_embed="alibi",
            embed_scale=emb_s, logit_scale=out_s,
            attn_scale=(1.0 / hd_j) if raw.get(
                "mup_scale_qk_dot_by_d", raw.get("scale_qk_dot_by_d", True)
            ) else 0.0,
        )
    if mt == "minicpm3":
        # minicpm3: deepseek-V2 MLA attention + minicpm multipliers
        # (reference src/models/minicpm3.cpp)
        dn = raw.get("qk_nope_head_dim", 64)
        dr = raw.get("qk_rope_head_dim", 32)
        extra.update(
            q_lora_rank=raw.get("q_lora_rank") or 0,
            kv_lora_rank=raw.get("kv_lora_rank", 256),
            qk_nope_dim=dn, qk_rope_dim=dr,
            head_dim=raw.get("v_head_dim", dn),
            attn_scale=(dn + dr) ** -0.5,
            embed_scale=raw.get("scale_emb", 1.0),
            logit_scale=raw.get("dim_model_base", d_model) / d_model,
        )
    if mt == "maincoder":
        # maincoder: llama body with per-head qk-norm applied AFTER rope
        # (src/models/maincoder.cpp: rope_ext then build_norm on Q/K) —
        # the same ordering as hunyuan-v1
        extra.update(qk_norm=True, qk_norm_post_rope=True)
    if mt in ("pangu_embedded", "pangu"):
        # openPangu-Embedded: llama + q/k/v and wo biases
        # (src/models/pangu-embedded.cpp bq/bk/bv + bo)
        extra.update(qkv_bias=True, proj_bias=True)
    if mt == "apertus":
        # apertus: ungated xIELU MLP (learned per-layer alphas), per-head
        # qk-norm, own norm names (reference src/models/apertus.cpp)
        extra.update(ffn_gated=False, act_fn="xielu", qk_norm=True)
    if mt == "chameleon":
        # chameleon: per-head q/k LayerNorm with bias (ChameleonLayerNorm,
        # fixed eps 1e-5); swin_norm (30B alternate ordering) unsupported
        if raw.get("swin_norm"):
            raise ValueError("chameleon swin_norm ordering not supported")
        extra.update(qk_norm=True, qk_norm_type="ln")
    if mt == "arcee":
        # arcee AFM: llama body with an UNGATED relu^2 MLP
        # (reference src/models/arcee.cpp)
        extra.update(ffn_gated=False, act_fn="relu2")
    if mt in ("ernie4_5", "ernie4_5_moe"):
        # ernie 4.5: llama graph; HF omits default keys (theta 5e5, tied)
        raw.setdefault("rope_theta", 500000.0)
        raw.setdefault("tie_word_embeddings", True)
        if raw.get("use_bias"):
            extra.update(qkv_bias=True, proj_bias=True)
    if mt == "ernie4_5_moe":
        # softmax scoring with a selection-only correction bias
        # (Ernie4_5_MoeStatics), always-renormalized top-k, shared experts
        # at n_shared * moe_intermediate_size, dense layers below
        # moe_layer_start_index / off the moe_layer_interval grid
        nl = raw["num_hidden_layers"]
        start = raw.get("moe_layer_start_index", 1)
        step = raw.get("moe_layer_interval", 1)
        dense = [i < start or ((i + 1) % step != 0) for i in range(nl)]
        n_sh = raw.get("moe_num_shared_experts", 2)
        mi = raw.get("moe_intermediate_size", 1536)
        extra.update(
            n_experts=raw.get("moe_num_experts", 64),
            n_experts_used=raw.get("moe_k", 6),
            moe_score="softmax", moe_norm_topk=True,
            d_ff=mi, d_ff_dense=raw["intermediate_size"],
            n_shared_experts=n_sh, d_ff_shared=n_sh * mi,
        )
        if any(dense):
            extra.update(dense_layers=tuple(dense))
    if mt == "seed_oss":
        # q/k/v biases (attention_bias defaults True, o bias stays off)
        extra.update(qkv_bias=raw.get("attention_bias", True))
        raw.setdefault("head_dim", 128)
    if mt == "exaone4":
        # olmo2-style norm-after-block + per-head qk-norm; hybrid SWA via
        # layer_types with NoPE on the global layers (Exaone4Attention
        # applies rope only when is_sliding or no sliding_window)
        extra.update(qk_norm=True, pre_norms=False, post_norms=True)
        sw = raw.get("sliding_window", 4096)
        lt = raw.get("layer_types")
        if lt is None and sw:
            pat = raw.get("sliding_window_pattern", 4)
            if isinstance(pat, str):
                pat = len(pat)
            lt = ["sliding_attention"
                  if (pat and (i + 1) % pat != 0) else "full_attention"
                  for i in range(raw["num_hidden_layers"])]
            raw["layer_types"] = lt
        if sw and lt and "sliding_attention" in lt:
            extra.update(
                sliding_window=sw,
                swa_layers=tuple(t == "sliding_attention" for t in lt),
                nope_layers=tuple(t == "full_attention" for t in lt),
            )
    if mt in ("dots1", "glm4_moe"):
        # deepseek-V3-style router on a STANDARD attention body: sigmoid
        # scores, selection-only correction bias, grouped top-k, shared
        # experts, dense first-k layers (reference src/models/dots1.cpp,
        # glm4-moe.cpp)
        nre = raw.get("n_routed_experts") or (128 if mt == "glm4_moe"
                                              else 0)
        fkd = raw.get("first_k_dense_replace",
                      1 if mt == "glm4_moe" else 0)
        if nre:
            extra.update(
                n_experts=nre,
                n_experts_used=raw.get(
                    "num_experts_per_tok", 8 if mt == "glm4_moe" else 0),
                d_ff=raw.get("moe_intermediate_size", 1408),
                d_ff_dense=raw["intermediate_size"],
                first_k_dense=fkd,
                n_shared_experts=raw.get(
                    "n_shared_experts", 1 if mt == "glm4_moe" else 0) or 0,
                routed_scale=raw.get("routed_scaling_factor", 1.0),
                moe_score="sigmoid",
                n_expert_groups=raw.get("n_group", 1) or 0,
                topk_groups=raw.get("topk_group", 1) or 0,
                moe_norm_topk=raw.get("norm_topk_prob", mt == "glm4_moe"),
            )
            if extra.get("n_expert_groups") == 1:
                extra.update(n_expert_groups=0, topk_groups=0)
        if mt == "dots1":
            extra.update(qk_norm=True)
        else:  # glm4_moe: split-half partial rope (NOT interleaved)
            extra.update(
                qk_norm=raw.get("use_qk_norm", False),
                qkv_bias=raw.get("attention_bias", False),
                rope_pct=raw.get("partial_rotary_factor", 0.5),
            )
    if mt in ("hunyuan_v1_dense", "hunyuan_v1_moe"):
        # hunyuan v1: per-head q/k RMSNorm applied AFTER rope
        # (HunYuanMoEV1Attention), plain softmax top-k MoE with an
        # always-on shared expert at intermediate_size
        extra.update(
            qk_norm=True, qk_norm_post_rope=True,
            qkv_bias=raw.get("attention_bias", False),
        )
        hd_hy = raw.get("head_dim") or raw.get("attention_head_dim")
        if hd_hy:
            raw.setdefault("head_dim", hd_hy)
        if mt == "hunyuan_v1_moe":
            topk = raw.get("moe_topk", 1)
            if isinstance(topk, (list, tuple)):
                if len(set(topk)) != 1:
                    raise ValueError(
                        "per-layer moe_topk lists are not supported"
                    )
                topk = topk[0]
            extra.update(
                n_experts=raw.get("num_experts", 1),
                n_experts_used=topk,
                moe_score="softmax", moe_norm_topk=True,
                n_shared_experts=1,
                d_ff_shared=raw["intermediate_size"],
            )
    if mt in ("llama4", "llama4_text"):
        # Llama-4 Scout/Maverick (reference src/models/llama-iswa.cpp):
        # interleaved rope with every-4th NoPE layer, chunked local
        # attention on the rope layers, weightless post-rope qk L2 norm,
        # NoPE-layer attention temperature tuning, sigmoid-router MoE with
        # input-side weights + always-on shared expert, interleaved dense
        # layers at intermediate_size_mlp; MobileLLM = n_experts 0
        nl4 = raw["num_hidden_layers"]
        iv4 = raw.get("no_rope_layer_interval", 4)
        nrl4 = raw.get("no_rope_layers") or [
            int((i + 1) % iv4 != 0) for i in range(nl4)
        ]
        nope4 = tuple(v == 0 for v in nrl4)
        extra.update(rope_interleaved=True)
        if any(nope4):
            extra.update(nope_layers=nope4)
        if raw.get("use_qk_norm", True):
            extra.update(qk_norm=True, qk_norm_type="l2",
                         qk_norm_post_rope=True)
        acs = raw.get("attention_chunk_size") or 0
        lt4 = raw.get("layer_types")
        if acs and not (lt4 and all(
            t == "full_attention" for t in lt4
        )):
            extra.update(
                sliding_window=acs, swa_type="chunked",
                swa_layers=tuple(not f for f in nope4),
            )
        if raw.get("attn_temperature_tuning"):
            extra.update(
                attn_temp_scale=raw.get("attn_scale", 0.1),
                attn_temp_floor=raw.get("floor_scale", 8192),
                attn_temp_offset=1.0,
            )
        ne4 = raw.get("num_local_experts", 0) or 0
        if ne4:
            step4 = raw.get("interleave_moe_layer_step", 1)
            dense4 = [(i + 1) % step4 != 0 for i in range(nl4)]
            extra.update(
                n_experts=ne4,
                n_experts_used=raw.get("num_experts_per_tok", 1),
                moe_score="sigmoid", moe_norm_topk=False,
                moe_weight_before=True,
                d_ff=raw["intermediate_size"],
                d_ff_dense=raw.get("intermediate_size_mlp",
                                   raw["intermediate_size"]),
                n_shared_experts=1,
                d_ff_shared=raw["intermediate_size"],
            )
            if any(dense4):
                extra.update(dense_layers=tuple(dense4))
        elif raw.get("intermediate_size_mlp"):
            raw.setdefault("intermediate_size",
                           raw["intermediate_size_mlp"])
    if mt in ("bailing_moe", "bailingmoe"):
        # Ling/Ring v1 (BailingMoeForCausalLM): llama attention at an
        # explicit head_dim (rope over the full head), fused
        # query_key_value, softmax top-k routing with optional renorm,
        # always-on shared experts at num_shared * moe_intermediate_size,
        # optional Baichuan2-style NormHead (reference
        # src/models/bailingmoe.cpp + convert_hf_to_gguf BailingMoeModel)
        mi = raw.get("moe_intermediate_size", raw["intermediate_size"])
        n_sh = raw.get("num_shared_experts", 0) or 0
        extra.update(
            qkv_bias=raw.get("use_qkv_bias", False),
            n_experts=raw.get("num_experts", 0) or 0,
            n_experts_used=raw.get("num_experts_per_tok", 4),
            moe_score="softmax",
            moe_norm_topk=raw.get("norm_topk_prob", True),
            d_ff=mi, d_ff_dense=raw["intermediate_size"],
            first_k_dense=raw.get("first_k_dense_replace", 0) or 0,
            n_shared_experts=n_sh, d_ff_shared=n_sh * mi,
        )
    if mt in ("bailing_moe_v2", "bailing_moe2", "bailingmoe2"):
        # Ling/Ring 2.0 (BailingMoeV2ForCausalLM): fused qkv + per-head
        # qk-norm, partial rope (default half), deepseek-V3-style sigmoid
        # router with selection-only expert_bias + routed scaling, shared
        # experts at an explicit width, dense lead layers; trailing
        # nextn-prediction (MTP) layers are dropped (reference
        # src/models/bailingmoe2.cpp + convert BailingMoeV2Model)
        mi = raw.get("moe_intermediate_size", raw["intermediate_size"])
        n_sh = raw.get("num_shared_experts", 0) or 0
        extra.update(
            qk_norm=True,
            rope_pct=raw.get("partial_rotary_factor", 0.5),
            n_experts=raw.get("num_experts", 0) or 0,
            n_experts_used=raw.get("num_experts_per_tok", 8),
            moe_score=("sigmoid"
                       if raw.get("score_function", "sigmoid") == "sigmoid"
                       else "softmax"),
            moe_norm_topk=raw.get("norm_topk_prob", True),
            routed_scale=raw.get("routed_scaling_factor", 1.0),
            d_ff=mi, d_ff_dense=raw["intermediate_size"],
            first_k_dense=raw.get("first_k_dense_replace", 0) or 0,
            n_shared_experts=n_sh,
            d_ff_shared=(raw.get("moe_shared_expert_intermediate_size")
                         or n_sh * mi),
            n_expert_groups=raw.get("n_group", 1) or 0,
            topk_groups=raw.get("topk_group", 1) or 0,
        )
        if extra.get("n_expert_groups", 0) <= 1:
            extra.update(n_expert_groups=0, topk_groups=0)
    if mt == "phimoe":
        # Phi-3.5-MoE: LayerNorm(+bias) body, biased q/k/v/o projections
        # and biased lm_head, mixtral-style block_sparse_moe (w1/w2/w3)
        # with softmax top-2 renorm (the reference serves PhiMoE's
        # sparsemixer checkpoints through plain softmax gating:
        # src/models/phi3.cpp build_moe_ffn(..., SOFTMAX)), longrope
        # scaling + SWA like phi3
        extra.update(
            norm_type="ln",
            qkv_bias=raw.get("attention_bias", True),
            proj_bias=raw.get("attention_bias", True),
            sliding_window=raw.get("sliding_window") or 0,
        )
    if mt == "grovemoe":
        # GroveMoE (reference src/models/grovemoe.cpp): qwen3-style body
        # (per-head qk-norm), softmax top-k renormalized MoE PLUS adjugate
        # "chunk" experts (num_experts / experts_per_group, width
        # head_dim-or-128) applied to the routed output with scale 0.05
        # (convert_hf_to_gguf GroveMoeModel hardcodes group=2, scale=.05)
        ne_g = raw.get("num_experts", 0) or 0
        grp = raw.get("num_experts_per_group", 2)
        extra.update(
            qk_norm=True,
            n_experts=ne_g,
            n_experts_used=raw.get("num_experts_per_tok", 8),
            moe_score="softmax", moe_norm_topk=True,
            d_ff=raw.get("moe_intermediate_size",
                         raw["intermediate_size"]),
            d_ff_dense=raw["intermediate_size"],
            moe_chunk_experts=ne_g // grp,
            moe_chunk_scale=raw.get("expert_group_scale", 0.05),
            d_ff_chunk=(raw.get("moe_chunk_intermediate_size")
                        or raw.get("head_dim") or 128),
        )
    if mt == "arctic":
        # Snowflake Arctic (reference src/models/arctic.cpp): dense
        # residual_mlp at d_model width on every layer PLUS a softmax
        # top-k MoE branch on a separate norm of the layer input
        extra.update(
            n_experts=raw.get("num_local_experts", 128),
            n_experts_used=raw.get("num_experts_per_tok", 2),
            moe_score="softmax", moe_norm_topk=True,
            moe_parallel="arctic",
            d_ff=raw.get("moe_intermediate_size",
                         raw["intermediate_size"]),
            d_ff_dense=d_model,
        )
    if mt in ("grok-1", "grok1", "grok", "grok-2", "grok2"):
        # Grok-1 (reference src/models/grok.cpp): scaled embeddings,
        # gemma2-style sandwich norms, GELU MoE with top-2 renorm,
        # attention logits tanh-capped AFTER the attn_output_multiplier
        # (build_attn_with... llama-graph.cpp:1479: cap*tanh(kq*mult/cap)
        # == softcap(kq*attn_scale)), scaled logits; grok-2 adds yarn rope
        # and a final logit softcap
        hd_g = (raw.get("head_dim")
                or raw["hidden_size"] // raw["num_attention_heads"])
        extra.update(
            act_fn="gelu", post_norms=True,
            embed_scale=raw.get("embedding_multiplier_scale",
                                78.38367176906169),
            logit_scale=raw.get("output_multiplier_scale",
                                0.5773502691896257),
            attn_scale=raw.get("attn_output_multiplier") or hd_g ** -0.5,
            attn_logit_softcap=raw.get(
                "attn_logit_softcapping", raw.get("max_attn_value", 30.0)),
            final_logit_softcap=raw.get("final_logit_softcapping") or 0.0,
            n_experts=raw.get("num_local_experts",
                              raw.get("num_experts", 8)),
            n_experts_used=raw.get("num_experts_per_tok", 2),
            moe_norm_topk=True,
            d_ff=raw.get("moe_intermediate_size", raw["intermediate_size"]),
        )
        if raw.get("rope_type") in ("yarn", "original") and not raw.get(
            "rope_scaling"
        ):
            # grok-2 serializes yarn params as top-level keys (convert
            # GrokModel.set_gguf_parameters maps "original" -> yarn)
            raw["rope_scaling"] = {
                "rope_type": "yarn",
                "factor": raw.get("scaling_factor", 1.0),
                "original_max_position_embeddings": raw.get(
                    "original_max_position_embeddings", 4096),
                "beta_fast": raw.get("beta_fast", 32.0),
                "beta_slow": raw.get("beta_slow", 1.0),
                "attention_factor": raw.get("attn_factor"),
            }
    if mt in ("granite", "granitemoe", "granitemoeshared"):
        # granite's four multipliers (llm_build_granite): embedding and
        # attention map onto existing knobs; logits_scaling DIVIDES the
        # logits; residual_multiplier folds into wo/down weight scales in
        # convert_hf (so the forward graph stays multiplier-free).
        # granitemoe (reference LLM_ARCH_GRANITE_MOE, same builder with
        # build_moe_ffn softmax/renorm; convert GraniteMoeModel): the same
        # multipliers plus a JetMoe-style fused-expert MoE; the shared
        # variant adds an always-on parallel shared FFN (n_ff_shexp)
        extra.update(
            embed_scale=raw.get("embedding_multiplier", 1.0),
            attn_scale=raw.get("attention_multiplier", 0.0) or 0.0,
            logit_scale=1.0 / raw.get("logits_scaling", 1.0),
        )
        if mt != "granite":
            sh = raw.get("shared_intermediate_size", 0) or 0
            extra.update(
                n_experts=raw.get("num_local_experts", 0) or 0,
                n_experts_used=raw.get("num_experts_per_tok", 2),
                n_shared_experts=1 if sh else 0,
                d_ff_shared=sh,
            )
    if mt == "exaone":
        # EXAONE-3.x rope_pct (reference ExaoneModel rotary_factor,
        # convert_hf_to_gguf.py:8401-8403; defaults to full rotary)
        rp = raw.get("partial_rotary_factor") or raw.get("rope_pct")
        if rp:
            extra.update(rope_pct=float(rp))
    if mt == "minicpm":
        # minicpm: scale_emb on embeddings, scale_depth/sqrt(L) on every
        # residual branch (folded into weights), head divided by
        # hidden_size/dim_model_base
        extra.update(
            embed_scale=raw.get("scale_emb", 1.0),
            logit_scale=raw.get("dim_model_base", d_model) / d_model,
        )
    # --- LN / parallel-residual wave (reference src/models/{gptneox,phi2,
    # starcoder2,command-r,stablelm}.cpp) ----------------------------------
    if mt == "gpt_neox":
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn={"gelu": "gelu_exact"}.get(
                raw.get("hidden_act", "gelu"), "gelu"),
            parallel_residual=raw.get("use_parallel_residual", True),
            rope_pct=raw.get("rotary_pct", 0.25),
        )
        raw.setdefault("rope_theta", raw.get("rotary_emb_base", 10000.0))
    if mt == "phi":
        # phi-2: single pre-norm feeds both branches (no ffn_norm tensor)
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn="gelu", parallel_residual=True,
            rope_pct=raw.get("partial_rotary_factor", 0.5),
        )
    if mt == "starcoder2":
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn="gelu",
        )
    if mt == "cohere":
        # command-r: bias-free LN, single-norm parallel residual, scaled
        # logits, tied embeddings, original-GPT interleaved rope
        extra.update(
            norm_type="ln", parallel_residual=True,
            logit_scale=raw.get("logit_scale", 1.0),
            rope_interleaved=True,
        )
    if mt == "stablelm":
        extra.update(
            norm_type="ln",
            qkv_bias=raw.get("use_qkv_bias", False),
            rope_pct=raw.get("partial_rotary_factor", 0.25),
            parallel_residual=raw.get("use_parallel_residual", False),
        )
    # --- absolute/alibi/NoPE positional wave (reference src/models/{gpt2,
    # bloom,mpt,olmo,olmo2,nemotron,cohere2,smollm3,gpt-oss}.cpp) ----------
    if mt == "gpt2":
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn="gelu", pos_embed="learned",
        )
    if mt == "opt":
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn={"relu": "relu", "gelu": "gelu_exact"}.get(
                raw.get("activation_function", "relu"), "relu"),
            pos_embed="learned",
        )
        if not raw.get("do_layer_norm_before", True):
            raise ValueError("OPT-350m post-LN ordering is not supported")
    if mt == "bloom":
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn="gelu", pos_embed="alibi", embed_norm=True,
        )
    if mt == "mpt":
        nb = raw.get("no_bias", False)
        use_alibi = (raw.get("attn_config") or {}).get("alibi", True)
        extra.update(
            norm_type="ln", proj_bias=not nb, qkv_bias=not nb,
            ffn_gated=False, act_fn="gelu",
            pos_embed="alibi" if use_alibi else "rope",
            qkv_clamp=(raw.get("attn_config") or {}).get("clip_qkv") or 0.0,
        )
    if mt == "olmo":
        # non-parametric LayerNorm (weights synthesized =1 at convert time)
        extra.update(
            norm_type="ln", qkv_clamp=raw.get("clip_qkv") or 0.0,
        )
    if mt == "olmo2":
        # norm-AFTER-block ordering: no pre-norms, post_attn/post_ffn RMS
        # norms on each branch output; whole-width q/k RMSNorm
        extra.update(
            qk_norm=True, qk_norm_scope="whole",
            pre_norms=False, post_norms=True,
        )
    if mt == "gptj":
        hd_ = raw["hidden_size"] // raw["num_attention_heads"]
        extra.update(
            norm_type="ln", proj_bias=True, ffn_gated=False, act_fn="gelu",
            parallel_residual=True, rope_interleaved=True,
            rope_pct=raw.get("rotary_dim", hd_) / hd_,
        )
    if mt == "gpt_bigcode":
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn="gelu", pos_embed="learned",
        )
    if mt == "falcon":
        extra.update(
            norm_type="ln", ffn_gated=False,
            # HF "gelu" activation string = the exact (erf) form
            act_fn={"gelu": "gelu_exact"}.get(
                raw.get("activation", "gelu"), "gelu"),
            parallel_residual=raw.get("parallel_attn", True),
            proj_bias=raw.get("bias", False),
            qkv_bias=raw.get("bias", False),
            pos_embed="alibi" if raw.get("alibi", False) else "rope",
            alibi_scaled=bool(raw.get("alibi", False)),
        )
    if mt in ("glm4", "glm4v", "glm4v_text"):
        # sandwich norms (post_self_attn/post_mlp on branch outputs) +
        # partial INTERLEAVED rope; canon() renames the norms to the
        # gemma-style keys the postnorm map understands.  glm4v_text is
        # the same body; its M-RoPE sections (rope_scaling.mrope_section)
        # ride the qwen2-vl mrope machinery for image batches and reduce
        # to standard rope for text (all three position rows equal)
        extra.update(
            post_norms=True,
            qkv_bias=raw.get("attention_bias", True),
            rope_pct=raw.get("partial_rotary_factor", 0.5),
            rope_interleaved=True,
        )
    if mt == "chatglm":
        # ChatGLM3 / GLM-4: fused qkv (+bias) and fused [gate|up] MLP,
        # half-width INTERLEAVED rope, plain RMS pre-norms (glm4 minus
        # the sandwich norms; reference src/models/chatglm.cpp)
        extra.update(
            qkv_bias=raw.get("add_qkv_bias", True),
            rope_pct=0.5, rope_interleaved=True,
        )
    if mt == "codeshell":
        # codeshell: gpt_bigcode body (LN+bias everywhere, MQA fused qkv,
        # ungated gelu MLP) but ROPE positions instead of learned tables
        # (reference src/models/codeshell.cpp, NEOX rope)
        extra.update(
            norm_type="ln", proj_bias=True, qkv_bias=True, ffn_gated=False,
            act_fn="gelu",
        )
    if mt == "refact":
        # refact: rms llama body, MQA (fused kv), gated-silu MLP at the
        # derived llama width, ALiBi positions (reference
        # src/models/refact.cpp; f_max_alibi_bias=8 hardcoded)
        extra.update(pos_embed="alibi")
    if mt == "plamo":
        # plamo-13b: single-norm parallel residual (attn and MLP branch
        # off the same normed input; reference src/models/plamo.cpp),
        # full-head-dim rope; q/o head-shuffle handled at convert
        extra.update(parallel_residual=True)
    if mt == "plm":
        # PLM-1.8B: deepseek-V2 MLA attention (no q-lora) + an UNGATED
        # relu^2 MLP (reference src/models/plm.cpp LLM_FFN_RELU_SQR)
        dn = raw.get("qk_nope_head_dim", 64)
        dr = raw.get("qk_rope_head_dim", 32)
        extra.update(
            kv_lora_rank=raw.get("kv_lora_rank", 512),
            qk_nope_dim=dn, qk_rope_dim=dr,
            head_dim=raw.get("v_head_dim", dn),
            attn_scale=(dn + dr) ** -0.5,
            ffn_gated=False, act_fn="relu2",
        )
    if mt == "llada_moe":
        # LLaDA-MoE diffusion LM: bidirectional attention + per-head
        # qk-norm + softmax MoE WITHOUT top-k renorm (reference
        # src/models/llada-moe.cpp build_moe_ffn(..., norm_w=false));
        # in-place logit selection like llada
        extra.update(
            causal_attn=False,
            mask_token_id=raw.get("mask_token_id", 156895) or 0,
            diffusion_shift_logits=False,
            qk_norm=True,
        )
        if raw.get("expert_intermediate_size"):
            raw.setdefault("moe_intermediate_size",
                           raw["expert_intermediate_size"])
    if mt == "dbrx":
        ac = raw.get("attn_config") or {}
        fc = raw.get("ffn_config") or {}
        extra.update(
            norm_type="ln", qkv_clamp=ac.get("clip_qkv") or 0.0,
            n_experts=fc.get("moe_num_experts", 0) or 0,
            n_experts_used=fc.get("moe_top_k", 1),
            # moe_normalize_expert_weights is an Lp exponent; p=1 over
            # positive softmax weights == top-k renormalization
            moe_norm_topk=bool(fc.get("moe_normalize_expert_weights")),
        )
    if mt == "olmoe":
        # OLMoE: whole-width q/k RMSNorm applied BEFORE clip_qkv,
        # mixtral-style MoE (generic num_experts block below)
        extra.update(
            qk_norm=True, qk_norm_scope="whole",
            qkv_clamp=raw.get("clip_qkv") or 0.0,
        )
    if mt == "nemotron":
        extra.update(
            norm_type="ln", norm_plus_one=True, ffn_gated=False,
            act_fn="relu2",
            rope_pct=raw.get("partial_rotary_factor", 0.5),
        )
    if mt == "cohere2":
        nl = raw["num_hidden_layers"]
        lt = raw.get("layer_types")
        if lt:
            swa = [t == "sliding_attention" for t in lt]
        else:
            pat = raw.get("sliding_window_pattern", 4)
            swa = [i % pat != pat - 1 for i in range(nl)]
        extra.update(
            norm_type="ln", parallel_residual=True,
            logit_scale=raw.get("logit_scale", 1.0), rope_interleaved=True,
            sliding_window=raw.get("sliding_window", 4096),
            swa_layers=tuple(swa),
            # global (non-SWA) layers are NoPE (llm_build_cohere2_iswa)
            nope_layers=tuple(not s for s in swa),
        )
    if mt == "smollm3":
        nrl = raw.get("no_rope_layers")
        if nrl is None:
            iv = raw.get("no_rope_layer_interval", 4)
            # HF semantics: entry 1 = layer USES rope, 0 = NoPE
            nrl = [int((i + 1) % iv != 0)
                   for i in range(raw["num_hidden_layers"])]
        extra.update(nope_layers=tuple(v == 0 for v in nrl))
    if mt == "gpt_oss":
        extra.update(
            qkv_bias=True, proj_bias=True, attn_sinks=True,
            swiglu_limit=raw.get("swiglu_limit", 7.0) or 0.0,
            moe_expert_bias=True,
            sliding_window=raw.get("sliding_window", 128),
            sliding_window_pattern=2,
        )
    if raw.get("layer_types"):
        lt = raw["layer_types"]
        if "sliding_attention" in lt and extra.get(
            "sliding_window", raw.get("sliding_window")
        ):
            extra.update(
                swa_layers=tuple(t == "sliding_attention" for t in lt),
                sliding_window=extra.get(
                    "sliding_window", raw.get("sliding_window")),
            )
    if mt in ("deepseek_v2", "deepseek_v3"):
        # MLA latent-KV attention (src/models/deepseek2.cpp analog);
        # attn scale is 1/sqrt(nope+rope) over the concatenated q head
        dn = raw.get("qk_nope_head_dim", 128)
        dr = raw.get("qk_rope_head_dim", 64)
        extra.update(
            q_lora_rank=raw.get("q_lora_rank") or 0,
            kv_lora_rank=raw.get("kv_lora_rank", 512),
            qk_nope_dim=dn, qk_rope_dim=dr,
            head_dim=raw.get("v_head_dim", 128),
            attn_scale=(dn + dr) ** -0.5,
        )
        # defaults must mirror the HF config classes — save_pretrained
        # omits default-valued keys (V3: sigmoid scoring, scale 2.5,
        # 8 groups/top-4, 1 shared expert, 3 dense head layers)
        v3 = mt == "deepseek_v3"
        fkd = raw.get("first_k_dense_replace", 3 if v3 else 0)
        if (raw.get("n_routed_experts") or 0) and (
            fkd < raw["num_hidden_layers"]
        ):
            # deepseek MoE: sigmoid/softmax scoring, selection bias,
            # grouped top-k, shared experts, dense first-k layers
            extra.update(
                n_experts=raw["n_routed_experts"],
                n_experts_used=raw.get(
                    "num_experts_per_tok", 8 if v3 else 6),
                d_ff=raw.get(
                    "moe_intermediate_size", raw["intermediate_size"]
                ),
                d_ff_dense=raw["intermediate_size"],
                first_k_dense=fkd,
                n_shared_experts=raw.get(
                    "n_shared_experts", 1 if v3 else 0) or 0,
                routed_scale=raw.get(
                    "routed_scaling_factor", 2.5 if v3 else 1.0),
                moe_score=raw.get(
                    "scoring_func", "sigmoid" if v3 else "softmax"),
                n_expert_groups=raw.get("n_group", 8 if v3 else 0) or 0,
                topk_groups=raw.get("topk_group", 4 if v3 else 0) or 0,
                moe_norm_topk=raw.get("norm_topk_prob", True),
            )
    n_experts = raw.get("num_local_experts", raw.get("num_experts", 0)) or 0
    if mt in ("smallthinker", "minimax_m2", "afmoe", "mimo2"):
        n_experts = 0  # these archs configure their MoE in blocks below
    if n_experts and "n_experts" not in extra:
        extra.update(
            n_experts=n_experts,
            n_experts_used=raw.get("num_experts_per_tok", 2),
            # save_pretrained omits default-valued keys: qwen-moe/olmoe
            # HF configs default norm_topk_prob to FALSE, mixtral-style
            # models always renormalize.  qwen3-vl-moe renormalizes
            # UNCONDITIONALLY (Qwen3VLMoeTextSparseMoeBlock comments out
            # its norm_topk_prob check), so the config value is ignored.
            moe_norm_topk=True
            if mt in ("qwen3_vl_moe", "qwen3_vl_moe_text")
            else raw.get(
                "norm_topk_prob",
                mt not in ("qwen2_moe", "qwen3_moe", "olmoe", "rnd1",
                           "llada_moe"),
            ),
            d_ff=raw.get("moe_intermediate_size", raw["intermediate_size"]),
        )
    if mt in ("qwen2_moe", "qwen3_moe", "rnd1") and n_experts:
        # qwen-moe heterogeneity: mlp_only_layers + decoder_sparse_step
        # pick which layers are plain dense MLPs (HF Qwen2MoeDecoderLayer
        # sparse condition); qwen2-moe adds a sigmoid-gated shared expert
        step = raw.get("decoder_sparse_step", 1)
        only = set(raw.get("mlp_only_layers") or [])
        nl = raw["num_hidden_layers"]
        dense = [
            (i in only) or step == 0 or ((i + 1) % step != 0)
            for i in range(nl)
        ]
        if any(dense):
            extra.update(
                dense_layers=tuple(dense),
                d_ff_dense=raw["intermediate_size"],
            )
        if mt in ("qwen2_moe", "rnd1"):
            extra.update(
                n_shared_experts=1,
                d_ff_shared=raw.get(
                    "shared_expert_intermediate_size", 0) or 0,
            )
    if mt == "deepseek":
        # deepseek V1 (DeepseekForCausalLM): llama attention + the original
        # deepseek-MoE — softmax scoring, top-k WITHOUT renormalization,
        # always-on shared experts, leading dense layers (reference
        # src/models/deepseek.cpp: build_moe_ffn norm_w=false scale_w=false)
        fkd = raw.get("first_k_dense_replace", 1)
        if (raw.get("n_routed_experts") or 0) and (
            fkd < raw["num_hidden_layers"]
        ):
            extra.update(
                n_experts=raw["n_routed_experts"],
                n_experts_used=raw.get("num_experts_per_tok", 6),
                d_ff=raw.get(
                    "moe_intermediate_size", raw["intermediate_size"]),
                d_ff_dense=raw["intermediate_size"],
                first_k_dense=fkd,
                n_shared_experts=raw.get("n_shared_experts", 2) or 0,
                moe_score="softmax",
                moe_norm_topk=False,
            )
    if mt == "minimax_m2" or "MiniMaxM2ForCausalLM" in archs:
        # MiniMax-M2 (reference src/models/minimax-m2.cpp): WHOLE-width
        # q/k RMSNorm before the head reshape, partial rotary (rotary_dim),
        # MoE with scoring from config + e_score_correction selection bias
        # + top-k renorm (build_moe_ffn norm_w=true)
        hd_ = raw.get("head_dim") or (
            raw["hidden_size"] // raw["num_attention_heads"])
        extra.update(
            qk_norm=True, qk_norm_scope="whole",
            rope_pct=raw.get("rotary_dim", hd_) / hd_,
            head_dim=hd_,
            n_experts=raw.get(
                "num_local_experts", raw.get("num_experts", 0)) or 0,
            n_experts_used=raw.get("num_experts_per_tok", 2),
            d_ff=raw.get("moe_intermediate_size",
                         raw["intermediate_size"]),
            moe_score=raw.get("scoring_func", "sigmoid"),
            moe_norm_topk=True,
        )
    if mt == "smallthinker":
        # SmallThinker (reference src/models/smallthinker.cpp): router
        # logits computed on the RAW layer input (pre-norm), relu-gated
        # experts, optional NoPE step + sliding-window layout
        nl = raw["num_hidden_layers"]
        extra.update(
            act_fn="relu",
            moe_router_input="layer_input",
            n_experts=raw.get(
                "num_experts", raw.get("moe_num_primary_experts", 0)) or 0,
            n_experts_used=raw.get(
                "num_experts_per_tok",
                raw.get("moe_num_active_primary_experts", 2)),
            d_ff=raw.get("moe_ffn_hidden_size", raw.get(
                "intermediate_size", raw["hidden_size"] * 4)),
            moe_score=("softmax"
                       if raw.get("moe_primary_router_apply_softmax", True)
                       else "sigmoid"),
            moe_norm_topk=True,
        )
        raw.setdefault("intermediate_size",
                       raw.get("moe_ffn_hidden_size", 0))
        swl = raw.get("sliding_window_layout")
        if swl and any(swl):
            extra.update(
                sliding_window=raw.get("sliding_window_size", 4096),
                swa_layers=tuple(bool(v) for v in swl),
            )
        # NoPE layers: HF rope_layout is a per-layer 1=rope mask; absent,
        # the reference uses il % 4 == 0 when SWA is on
        # (llm_build_smallthinker rope condition + set_swa_pattern(4, true))
        rl = raw.get("rope_layout")
        if rl:
            extra.update(nope_layers=tuple(not bool(v) for v in rl))
        elif swl and any(swl):
            extra.update(nope_layers=tuple(i % 4 == 0 for i in range(nl)))
    if mt == "afmoe":
        # AFMoE (reference src/models/afmoe.cpp): muP embedding scale,
        # sandwich (pre+post) norms on both branches, per-head qk-norm,
        # sigmoid-gated attention output (gate from the attn-normed input,
        # applied BEFORE o_proj), NoPE on every n-th (global) layer, MoE
        # with sigmoid scoring + selection bias + renorm + routed scale +
        # shared expert, leading dense layers
        nl = raw["num_hidden_layers"]
        extra.update(
            embed_scale=raw["hidden_size"] ** 0.5,
            post_norms=True,
            qk_norm=True,
            attn_gate="sigmoid",
            n_experts=raw.get("num_experts", 0) or 0,
            n_experts_used=raw.get("num_experts_per_tok", 2),
            d_ff=raw.get("moe_intermediate_size",
                         raw["intermediate_size"]),
            d_ff_dense=raw["intermediate_size"],
            first_k_dense=raw.get("num_dense_layers", 0),
            n_shared_experts=raw.get("num_shared_experts", 0) or 0,
            moe_score=raw.get("scoring_func", "sigmoid"),
            moe_norm_topk=raw.get("route_norm", True),
            routed_scale=raw.get("route_scale", 1.0),
        )
        lt = raw.get("layer_types")
        if lt:
            swa = [t == "sliding_attention" for t in lt]
        else:
            step = raw.get("global_attn_every_n_layers", 4)
            swa = [(i + 1) % step != 0 for i in range(nl)]
        if raw.get("sliding_window"):
            extra.update(sliding_window=raw["sliding_window"],
                         swa_layers=tuple(swa))
        # rope only on sliding layers (use_rope = (il+1) % step != 0)
        extra.update(nope_layers=tuple(not s for s in swa))
    if mt == "mimo2" or "MiMoV2FlashForCausalLM" in archs:
        # MiMo-V2 (reference src/models/mimo2-iswa.cpp): per-layer SWA with
        # its own rope theta (swa_rope_theta), per-layer kv-head counts,
        # learned attention sinks, noaux_tc sigmoid MoE + selection bias
        pat = raw.get("hybrid_layer_pattern") or []
        swa = [bool(v) for v in pat]
        kv_g = raw.get("num_key_value_heads",
                       raw["num_attention_heads"])
        kv_s = raw.get("swa_num_key_value_heads", kv_g)
        hd_ = raw.get("head_dim") or (
            raw["hidden_size"] // raw["num_attention_heads"])
        extra.update(
            head_dim=hd_,
            rope_pct=raw.get("partial_rotary_factor", 1.0),
            attn_sinks=True,
            qkv_bias=bool(raw.get("attention_bias", False)),
        )
        if any(swa):
            extra.update(
                sliding_window=raw.get("sliding_window", 4096),
                swa_layers=tuple(swa),
                rope_theta_local=raw.get(
                    "swa_rope_theta", raw.get("rope_theta", 10000.0)),
            )
            if kv_s != kv_g:
                extra.update(heads_per_layer=tuple(
                    (raw["num_attention_heads"], kv_s if s else kv_g)
                    for s in swa
                ))
        if raw.get("n_routed_experts"):
            extra.update(
                n_experts=raw["n_routed_experts"],
                n_experts_used=raw.get("num_experts_per_tok", 2),
                d_ff=raw.get("moe_intermediate_size",
                             raw["intermediate_size"]),
                d_ff_dense=raw["intermediate_size"],
                first_k_dense=raw.get("first_k_dense_replace", 0),
                moe_score="sigmoid",
                moe_norm_topk=raw.get("norm_topk_prob", True),
            )
        raw.setdefault("rms_norm_eps", raw.get("layernorm_epsilon", 1e-5))
    if mt == "openelm":
        extra.update(
            qk_norm=True,
            heads_per_layer=tuple(
                (int(a), int(b))
                for a, b in zip(raw["num_query_heads"],
                                raw["num_kv_heads"])
            ),
            d_ff_per_layer=tuple(int(v) for v in raw["_openelm_ffd"]),
        )
    if mt in ("deci", "nemotron-nas") and raw.get("_deci_heads"):
        extra.update(
            heads_per_layer=tuple(raw["_deci_heads"]),
            d_ff_per_layer=tuple(raw["_deci_ffd"]),
        )
    if mt in ("plamo3", "plamo-3"):
        extra.update(
            qk_norm=True, post_norms=True,
            sliding_window=raw.get(
                "window_size", raw.get("sliding_window", 0)) or 0,
            sliding_window_pattern=raw.get("sliding_window_pattern", 0),
            rope_theta_local=raw.get("rope_local_theta", 0.0) or 0.0,
        )
    if mt == "cogvlm" or "CogVLMForCausalLM" in archs:
        # cogvlm: llama body with a duplicated visual-expert weight set
        extra.update(dual_expert=True)
    if "LlamaBidirectionalModel" in archs:
        # llama-embed (reference src/models/llama.cpp llm_build_llama<true>
        # via LLM_ARCH_LLAMA_EMBED, llama-arch.cpp:120; converter
        # LlamaEmbedNemotronModel): plain llama body with bidirectional
        # no-cache attention and embedding (t_embd) output — no lm_head
        extra.update(causal_attn=False)
        raw.setdefault("tie_word_embeddings", True)
    if "Gemma3TextModel" in archs or raw.get("use_bidirectional_attention"):
        # EmbeddingGemma (reference src/models/gemma-embedding.cpp +
        # convert_hf_to_gguf.py EmbeddingGemma): the gemma3 text body with
        # BIDIRECTIONAL attention and embedding (t_embd) output — no
        # lm_head; serving pools the hidden states
        extra.update(causal_attn=False)
        raw.setdefault("tie_word_embeddings", True)  # no lm_head tensor
    rope_scaling = raw.get("rope_scaling")
    return ModelConfig(
        arch="bitnet" if is_bitnet else "llama",
        vocab_size=raw["vocab_size"],
        d_model=d_model,
        n_layers=raw["num_hidden_layers"],
        n_heads=raw["num_attention_heads"],
        n_kv_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
        d_ff=extra.pop("d_ff", raw["intermediate_size"]),
        head_dim=extra.pop("head_dim", raw.get("head_dim")),
        rms_eps=raw.get("rms_norm_eps", raw.get(
            "layer_norm_eps", raw.get("layer_norm_epsilon", raw.get(
                "norm_epsilon", raw.get("norm_eps", 1e-5))))),
        rope_theta=raw.get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        # cohere/gpt2/bloom omit the key because tied is their default
        tie_embeddings=raw.get(
            "tie_word_embeddings",
            mt in ("cohere", "cohere2", "gpt2", "bloom", "mpt", "opt",
                   "falcon", "gpt_bigcode"),
        ),
        use_subnorms=is_bitnet,
        max_seq_len=min(raw.get("max_position_embeddings", 4096), 131072),
        **extra,
    )



def _hf_files(hf_dir: pathlib.Path) -> list[pathlib.Path]:
    files = sorted(hf_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {hf_dir}")
    return files


def _float_of(a: np.ndarray, dtype: str) -> np.ndarray:
    """A stored array as the JAX converter sees it: BF16 (read as uint16)
    upcast to float32 exactly, by shifting its bits up 16."""
    if dtype != "BF16":
        return a
    return (a.astype(np.uint32) << 16).view(np.float32)


def _iter_hf_tensors(hf_dir: pathlib.Path) -> Iterator[tuple[str, np.ndarray]]:
    """(name, array) over the shards by sorted file name, and within a
    shard by sorted tensor name (the order ``safe_open(...).keys()``
    yields, whatever the header's)."""
    for f in _hf_files(hf_dir):
        mm, header, base = safetensors_open(f)
        for name in sorted(header):
            info = header[name]
            yield name, _float_of(safetensors_tensor(mm, base, name, info),
                                  info["dtype"])


def _side_scales(hf_dir: pathlib.Path) -> dict[str, np.ndarray]:
    """The ``*weight_scale`` tensors (HF1BitLLM), found from the headers:
    the JAX converter's first pass reads every tensor for them."""
    out: dict[str, np.ndarray] = {}
    for f in _hf_files(hf_dir):
        mm, header, base = safetensors_open(f)
        for name in sorted(header):
            if name.endswith("weight_scale"):
                info = header[name]
                out[name] = _float_of(
                    safetensors_tensor(mm, base, name, info), info["dtype"])
    return out


def _maybe_unpack_2bit(name: str, w: np.ndarray, scales: dict[str, np.ndarray]):
    """HF1BitLLM Llama3-8B-1.58 stores uint8 with 4 packed 2-bit weights and
    a separate inverted `.weight_scale`; unpack to float trits * scale."""
    if w.dtype != np.uint8:
        return w
    parts = [((w >> (2 * i)) & 3).astype(np.float32) - 1.0 for i in range(4)]
    unpacked = np.concatenate(parts, axis=0)
    key = name.replace(".weight", ".weight_scale")
    s = scales.get(key)
    if s is not None:
        unpacked = unpacked / np.asarray(s, np.float32)
    return unpacked


def _is_exact_ternary(w: np.ndarray) -> tuple[bool, float]:
    # the JAX converter's sampled test: every (size // 100_000)-th ROW of
    # the (K, N) matrix; a tensor ternary only there is packed by sign
    return _exact_of(w[:: max(1, w.size // 100_000)])


def _exact_of(sample: np.ndarray) -> tuple[bool, float]:
    vals = np.unique(sample.astype(np.float32))
    if len(vals) > 3:
        return False, 0.0
    nz = vals[vals != 0]
    if len(nz) == 0:
        return True, 1.0
    s = float(np.abs(nz).max())
    ok = np.allclose(np.abs(nz), s, rtol=1e-4)
    return ok, s


@dataclasses.dataclass
class _TwoBit:
    """An HF1BitLLM uint8 projection (R, C) not yet unpacked: its (C, 4R)
    trits come from integer work on the device where the JAX converter's
    float path provably gives the same ones (:meth:`trits`)."""

    name: str
    w: np.ndarray
    scale: np.ndarray | None

    def host(self) -> np.ndarray:
        """The JAX converter's float32 unpack, (4R, C)."""
        key = self.name.replace(".weight", ".weight_scale")
        return _maybe_unpack_2bit(
            self.name, self.w, {} if self.scale is None else {key: self.scale})

    def trits(self, device) -> tuple[torch.Tensor, np.float32] | None:
        """(trits (C, 4R) int8 on ``device``, scale), equal to
        ``np.sign(host().T)`` and the exact branch's scale; None where the
        float path must run (a sample that is not exactly ternary, or a
        divisor that is zero, infinite or NaN).  The sample is the JAX
        converter's rows of ``host().T``, unpacked on the host: for a
        finite nonzero divisor d, sign((f - 1) / d) = sign(d) *
        clamp(f - 1, -1, 1) for every field f in 0..3."""
        r, c = self.w.shape
        step = max(1, 4 * r * c // 100_000)
        d = np.float32(1.0 if self.scale is None
                       else np.asarray(self.scale, np.float32).reshape(()))
        if not (np.isfinite(d) and d != 0):
            return None
        sample = _TwoBit(self.name, self.w[:, ::step], self.scale).host().T
        exact, s = _exact_of(sample)
        if not exact:
            return None
        f = torch.from_numpy(self.w).to(device)
        t = torch.cat([(f >> (2 * i)) & 3 for i in range(4)]).to(torch.int8)
        t = (t - 1).clamp_(max=1)
        if d < 0:
            t = -t
        return t.T, np.float32(s if s > 0 else 1.0)


def _two_bit(name: str, w: np.ndarray, scales: dict[str, np.ndarray]):
    """:func:`_maybe_unpack_2bit` for a tensor that goes straight to
    ``pack_proj``: a uint8 one with a per-tensor scale stays packed
    (:class:`_TwoBit`)."""
    s = scales.get(name.replace(".weight", ".weight_scale"))
    if w.dtype != np.uint8 or (s is not None and np.size(s) != 1):
        return _maybe_unpack_2bit(name, w, scales)
    return _TwoBit(name, w, s)


def _tern(wf: np.ndarray) -> tuple[np.ndarray, np.float32, bool]:
    """(trits, scale, lossy) of a float32 (K, N) matrix: exact ternary
    packs by sign, anything else by BitNet absmean (host numpy)."""
    exact, s = _is_exact_ternary(wf)
    if exact:
        scale = np.float32(s if s > 0 else 1.0)
        return np.sign(wf).astype(np.int8), scale, False
    trits, scale = ternarize(wf)
    return trits, scale, True


def _hp(a: np.ndarray, hp: str) -> torch.Tensor:
    """A float32 host array in the high-precision dtype: bf16 rounds to
    nearest even (on the host, as ``jnp.asarray(a).astype(bfloat16)``)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16) if hp == "bfloat16" else t


def _head(w: np.ndarray, vocab_p: int, hp: str, device) -> torch.Tensor:
    """HF (V, D) float32 head -> (D, vocab_p) in ``hp``, zero-padded.  The
    cast is elementwise, so it runs first on the host and the transpose and
    the pad (data movement) on ``device``."""
    h = _hp(w, hp).to(device)
    out = h.new_zeros((h.shape[1], vocab_p))
    out[:, : h.shape[0]] = h.T
    return out


def _save(out_dir, cfg, params: dict[str, Any], hf_dir, extra_meta) -> None:
    """``save_checkpoint`` of a tree of numpy arrays and tensors, every leaf
    at least 1-d, as the JAX ``save_checkpoint`` stores them
    (``np.ascontiguousarray``)."""
    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [host(x) for x in v]
        t = v.cpu() if torch.is_tensor(v) else torch.from_numpy(
            np.ascontiguousarray(v))
        return t.reshape(1) if t.dim() == 0 else t

    save_checkpoint(out_dir, cfg, host(params), tokenizer_src=hf_dir,
                    extra_meta=extra_meta)


def _stack_packed(ts) -> dict[str, torch.Tensor]:
    """Packed projections -> {"packed": (n, ...), "scale": (n,)}."""
    return {"packed": torch.stack([t.packed for t in ts]),
            "scale": torch.stack([t.scale.reshape(()) for t in ts])}



def convert_mamba(
    hf_dir: str | pathlib.Path,
    out_dir: str | pathlib.Path,
    dtype_hp: str = "bfloat16",
    device: str | torch.device | None = None,
):
    """HF MambaForCausalLM -> packed ternary checkpoint (in/out projections
    ternarized and packed i2 whatever the format asked; SSM-specific small
    tensors kept float)."""
    from vlut_tpu_torch.models.ssm import MambaConfig

    dev = resolve_device(device)
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    dt_rank = raw.get("time_step_rank")
    cfg = MambaConfig(
        vocab_size=raw["vocab_size"],
        d_model=raw["hidden_size"],
        n_layers=raw["num_hidden_layers"],
        d_state=raw.get("state_size", 16),
        d_conv=raw.get("conv_kernel", 4),
        expand=raw.get("expand", 2),
        dt_rank=dt_rank if isinstance(dt_rank, int) else None,
        rms_eps=raw.get("layer_norm_epsilon", 1e-5),
        tie_embeddings=raw.get("tie_word_embeddings", True),
        max_seq_len=raw.get("max_position_embeddings", 2048),
    )
    name_map = {
        "mixer.in_proj.weight": ("in_proj", "tern"),      # (d, 2*di)
        "mixer.out_proj.weight": ("out_proj", "tern"),    # (di, d)
        "norm.weight": ("norm", "raw"),
        "mixer.conv1d.weight": ("conv_w", "conv"),
        "mixer.conv1d.bias": ("conv_b", "raw"),
        "mixer.x_proj.weight": ("x_proj", "t"),           # (di, dr+2ds)
        "mixer.dt_proj.weight": ("dt_proj_w", "t"),       # (dr, di)
        "mixer.dt_proj.bias": ("dt_proj_b", "raw"),
        "mixer.A_log": ("A_log", "raw"),
        "mixer.D": ("D", "raw"),
    }
    return _convert_ssm(hf_dir, out_dir, cfg, name_map, "mamba",
                        dtype_hp, dev)


def convert_mamba2(
    hf_dir: str | pathlib.Path,
    out_dir: str | pathlib.Path,
    dtype_hp: str = "bfloat16",
    device: str | torch.device | None = None,
):
    """HF Mamba2ForCausalLM (codestral-mamba-style) -> packed checkpoint.
    in/out projections ternarize (exact or absmean); conv kernel, dt_bias,
    A_log, D, norms stay float (quantizer policy as convert_mamba)."""
    from vlut_tpu_torch.models.ssm import Mamba2Config

    dev = resolve_device(device)
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    hidden = raw["hidden_size"]
    n_heads = raw.get("num_heads", 128)
    cfg = Mamba2Config(
        vocab_size=raw["vocab_size"],
        d_model=hidden,
        n_layers=raw["num_hidden_layers"],
        n_heads=n_heads,
        head_dim=raw.get("head_dim", 64),
        d_state=raw.get("state_size", 128),
        d_conv=raw.get("conv_kernel", 4),
        expand=raw.get("expand", 2),
        n_groups=raw.get("n_groups", 1),
        rms_eps=raw.get("layer_norm_epsilon", 1e-5),
        tie_embeddings=raw.get("tie_word_embeddings", False),
        max_seq_len=raw.get("max_position_embeddings", 2048),
        time_limit=tuple(raw.get("time_step_limit",
                                 (0.0, float("inf")))),
    )
    name_map = {
        "mixer.in_proj.weight": ("in_proj", "tern"),
        "mixer.out_proj.weight": ("out_proj", "tern"),
        "norm.weight": ("norm", "raw"),
        "mixer.norm.weight": ("norm_w", "raw"),
        "mixer.conv1d.weight": ("conv_w", "conv"),
        "mixer.conv1d.bias": ("conv_b", "raw"),
        "mixer.dt_bias": ("dt_bias", "raw"),
        "mixer.A_log": ("A_log", "raw"),
        "mixer.D": ("D", "raw"),
    }
    return _convert_ssm(hf_dir, out_dir, cfg, name_map, "mamba2",
                        dtype_hp, dev)


def _convert_ssm(hf_dir: pathlib.Path, out_dir, cfg, name_map, what: str,
                 dtype_hp: str, dev: torch.device):
    """The body of the JAX ``convert_mamba`` / ``convert_mamba2``: the
    projections packed i2, the rest float32 (``conv``: (ch, 1, dc) ->
    (dc, ch); ``t``: transposed), layers stacked in the order met."""
    L = cfg.n_layers
    top: dict[str, Any] = {}
    per: dict[str, dict[int, Any]] = {}
    n_approx = 0
    lre = re.compile(r"backbone\.layers\.(\d+)\.(.+)$")
    for name, w in _iter_hf_tensors(hf_dir):
        w = np.asarray(w, np.float32)
        if name == "backbone.embeddings.weight":
            top["embed"] = _hp(w, dtype_hp)
            continue
        if name == "backbone.norm_f.weight":
            top["final_norm"] = w
            continue
        if name == "lm_head.weight":
            top["lm_head"] = _hp(w.T, dtype_hp)
            continue
        m = lre.match(name)
        if not m:
            log.warning("skipping unrecognized %s tensor %s", what, name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        entry = name_map.get(sub)
        if entry is None:
            log.warning("skipping %s layer tensor %s", what, name)
            continue
        pname, kind = entry
        if kind == "tern":
            trits, scale, lossy = _tern(w.T)
            n_approx += lossy
            v = pack_ternary(torch.from_numpy(trits).to(dev), scale, "i2")
        elif kind == "conv":
            v = w[:, 0, :].T
        elif kind == "t":
            v = w.T
        else:
            v = w
        per.setdefault(pname, {})[li] = v

    layers: dict[str, Any] = {}
    for pname, by_layer in per.items():
        vals = [by_layer[i] for i in range(L)]
        layers[pname] = (_stack_packed(vals) if hasattr(vals[0], "packed")
                         else np.stack(vals))
    if n_approx:
        log.warning(
            "%d %s projections were NOT exactly ternary — absmean "
            "ternarized (lossy).", n_approx, what,
        )
    _save(out_dir, cfg, {**top, "layers": layers}, hf_dir,
          {"source": str(hf_dir), "ternarized_tensors": n_approx})
    return cfg



# tensors of a vision tower, converted into a sidecar (convert/vision.py)
_TOWER_PREFIXES = (
    "vision_tower.", "multi_modal_projector.", "vision_model.",
    "connector.", "aligner.", "model.vision_tower.",
    "model.multi_modal_projector.", "model.vision_model.",
    "model.connector.", "model.aligner.",
)
# cogvlm's visual-expert projections -> the vis_* leaves
_VIS_MAP = {
    "self_attn.vis_o_proj": "vis_wo",
    "mlp.vis_gate_proj": "vis_w_gate",
    "mlp.vis_up_proj": "vis_w_up",
    "mlp.vis_down_proj": "vis_w_down",
}


def _convert_lfm2_vl_model(hf_dir: pathlib.Path, out_dir, raw0) -> Any:
    """lfm2-vl: the text side is the lfm2 hybrid (``convert_hybrid``
    descends ``text_config``); the siglip2 tower and its pixel-unshuffle
    projector are written beside it, and the meta rewritten with them."""
    from vlut_tpu_torch.convert.hybrid import convert_hybrid
    from vlut_tpu_torch.convert.vision import _convert_lfm2_vl

    cfg = convert_hybrid(hf_dir, out_dir)
    vis = {name.removeprefix("model."): w
           for name, w in _iter_hf_tensors(hf_dir)
           if name.removeprefix("model.").startswith(
               ("vision_tower.", "multi_modal_projector."))}
    lcfg = _convert_lfm2_vl(vis, raw0, pathlib.Path(out_dir))
    meta_p = pathlib.Path(out_dir) / "vlut_config.json"
    meta = json.loads(meta_p.read_text())
    meta["lfm2vl_config"] = lcfg
    meta["image_token_id"] = raw0.get("image_token_index",
                                      raw0.get("image_token_id"))
    meta_p.write_text(json.dumps(meta, indent=1))
    return cfg


def convert_hf(
    hf_dir: str | pathlib.Path,
    out_dir: str | pathlib.Path,
    fmt: str = "i2",
    dtype_hp: str = "bfloat16",
    device: str | torch.device | None = None,
) -> ModelConfig:
    """Convert a HF causal-LM checkpoint to a packed ternary checkpoint,
    packing on ``device`` (the GPU unless the CPU is asked for).  Refused
    checkpoints raise before anything is written to ``out_dir``."""
    dev = resolve_device(device)
    hf_dir = pathlib.Path(hf_dir)
    raw0 = json.loads((hf_dir / "config.json").read_text())
    if raw0.get("model_type") in ("mamba", "falcon_mamba"):
        return convert_mamba(hf_dir, out_dir, dtype_hp=dtype_hp, device=dev)
    if raw0.get("model_type") == "mamba2":
        return convert_mamba2(hf_dir, out_dir, dtype_hp=dtype_hp, device=dev)
    # the family converters: float weights, every operation on the host
    if raw0.get("model_type") in ("rwkv7", "rwkv070", "rwkv_hybrid"):
        from vlut_tpu_torch.convert.rwkv import convert_rwkv7

        return convert_rwkv7(hf_dir, out_dir)
    if raw0.get("model_type") in ("rwkv6", "rwkv6qwen2"):
        from vlut_tpu_torch.convert.rwkv import convert_rwkv6

        return convert_rwkv6(hf_dir, out_dir)
    if raw0.get("model_type") in ("jamba", "falcon_h1", "granitemoehybrid",
                                  "lfm2", "lfm2_moe", "qwen3_next",
                                  "nemotron_h", "plamo2"):
        from vlut_tpu_torch.convert.hybrid import convert_hybrid

        return convert_hybrid(hf_dir, out_dir)
    if raw0.get("model_type") in ("lfm2_vl", "lfm2-vl"):
        return _convert_lfm2_vl_model(hf_dir, out_dir, raw0)
    if raw0.get("model_type") in ("bert", "modernbert", "neobert",
                                  "nomic_bert", "xlm-roberta"):
        from vlut_tpu_torch.convert.encoder import convert_encoder

        return convert_encoder(hf_dir, out_dir)
    if raw0.get("model_type") in ("gemma3n", "gemma3n_text"):
        from vlut_tpu_torch.convert.gemma3n import convert_gemma3n

        return convert_gemma3n(hf_dir, out_dir)
    if raw0.get("model_type") in ("t5", "mt5"):
        from vlut_tpu_torch.convert.t5 import convert_t5

        return convert_t5(hf_dir, out_dir)
    cfg0 = config_from_hf(hf_dir)
    cfg = ModelConfig(**{**cfg0.__dict__, "weight_fmt": fmt})
    L = cfg.n_layers
    hp = dtype_hp

    # residual-branch multiplier (granite residual_multiplier / minicpm
    # scale_depth/sqrt(L)): folded into the wo + down weight magnitudes so
    # the serving graph needs no extra multiply (see config_from_hf)
    res_mult = 1.0
    if raw0.get("model_type") in ("granite", "granitemoe",
                                  "granitemoeshared"):
        res_mult = float(raw0.get("residual_multiplier", 1.0))
    elif raw0.get("model_type") in ("minicpm", "minicpm3"):
        res_mult = float(raw0.get("scale_depth", L ** 0.5)) / L ** 0.5

    # side scales (HF1BitLLM weight_scale tensors)
    side_scales = _side_scales(hf_dir)

    layers: dict[str, Any] = {}
    top: dict[str, Any] = {}
    per_layer: dict[str, dict[int, Any]] = {}
    n_approx = 0
    plan = make_plan(cfg)
    norm_map = _NORM_MAP_POSTNORM if cfg.post_norms else _NORM_MAP

    def note_layer(pname: str, li: int, value, expert: int | None = None):
        if expert is None:
            per_layer.setdefault(pname, {})[li] = value
        else:
            per_layer.setdefault(pname, {}).setdefault(li, {})[expert] = value

    def pack_proj(pname: str, wf, li: int,
                  expert: int | None = None, cfg_over=None):
        nonlocal n_approx
        fold = res_mult != 1.0 and pname in ("wo", "w_down", "w_shared_down")
        dev_trits = (wf.trits(dev) if isinstance(wf, _TwoBit) and not fold
                     else None)
        if dev_trits is not None:
            trits, scale = dev_trits
        else:
            if isinstance(wf, _TwoBit):
                wf = wf.host()
            wf = np.asarray(wf, np.float32).T  # HF (out,in) -> (K, N)
            if fold:
                # residual-branch multiplier fold (granite ggml_scale on the
                # whole branch output, src/models/granite.cpp:140-142,
                # 200-202 — covers the MoE experts AND the parallel shared
                # FFN); numpy float32 times a Python float stays float32
                wf = wf * res_mult
            trits, scale, lossy = _tern(wf)
            n_approx += lossy
        c = cfg_over or cfg
        if cfg_over is None and (cfg.heads_per_layer or cfg.d_ff_per_layer):
            # per-layer head counts / FFN widths: pack this layer's
            # tensors with its own dims so layouts match the per-layer
            # spec table
            hp = (cfg.heads_per_layer[li] if cfg.heads_per_layer
                  else (cfg.n_heads, cfg.n_kv_heads))
            ffi = (cfg.d_ff_per_layer[li] if cfg.d_ff_per_layer
                   else cfg.d_ff)
            c = dataclasses.replace(
                cfg, n_heads=max(hp[0], 1),
                n_kv_heads=max(hp[1] or hp[0], 1), d_ff=max(ffi, 1),
                heads_per_layer=None, d_ff_per_layer=None,
            )
        note_layer(
            pname, li,
            pack_weight(pname, trits, scale, c, make_plan(c), device=dev),
            expert,
        )

    layer_re = re.compile(r"model\.layers\.(\d+)\.(.+)\.(weight|bias)$")
    vision_raw: dict[str, np.ndarray] = {}
    qwen_vis_raw: dict[str, np.ndarray] = {}
    mt0 = raw0.get("model_type", "")
    is_embgemma = "Gemma3TextModel" in raw0.get("architectures", [])

    def canon(name: str) -> str:
        """Arch-specific HF tensor names -> the llama-style canonical names
        the mapping tables below understand (the analog of the reference's
        per-arch TENSOR_NAMES tables, gguf-py tensor_mapping)."""
        if mt0 in ("qwen2_vl", "qwen2_5_vl", "qwen3_vl",
                   "qwen3_vl_moe"):
            name = name.replace("model.language_model.", "model.")
        elif mt0 == "llada":
            name = name.replace("model.transformer.wte.",
                                "model.embed_tokens.")
            name = name.replace("model.transformer.ln_f.", "model.norm.")
            if name.startswith("model.transformer.ff_out."):
                name = "lm_head." + name[len("model.transformer.ff_out."):]
            name = name.replace("model.transformer.blocks.",
                                "model.layers.")
            name = name.replace(".attn_norm.", ".input_layernorm.")
            name = name.replace(".q_proj.", ".self_attn.q_proj.")
            name = name.replace(".k_proj.", ".self_attn.k_proj.")
            name = name.replace(".v_proj.", ".self_attn.v_proj.")
            name = name.replace(".attn_out.", ".self_attn.o_proj.")
            name = name.replace(".ff_norm.", ".post_attention_layernorm.")
            name = name.replace(".ff_proj.", ".mlp.gate_proj.")
            name = name.replace(".up_proj.", ".mlp.up_proj.")
            name = name.replace(".ff_out.", ".mlp.down_proj.")
        elif mt0 == "baichuan":
            name = name.replace(".self_attn.W_pack.", ".self_attn.qkv_proj.")
        elif mt0 == "qwen":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.c_attn.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.c_proj.", ".self_attn.o_proj.")
            # qwen v1 SwiGLU: w2 is the gate, w1 the up (QWenMLP)
            name = name.replace(".mlp.w2.", ".mlp.gate_proj.")
            name = name.replace(".mlp.w1.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "jais":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.c_attn.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.c_proj.", ".self_attn.o_proj.")
            # jais SwiGLU: act(c_fc) * c_fc2 -> c_fc is the gate
            name = name.replace(".mlp.c_fc2.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_fc.", ".mlp.gate_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "chatglm":
            # ChatGLM/GLM-4 'transformer.encoder.layers' scheme; the
            # fused qkv is a straight [q; k; v] concat and dense_h_to_4h
            # a straight [gate; up] concat (ChatGLM swiglu chunks halves)
            if name.startswith("transformer."):
                name = name[len("transformer."):]
            name = name.replace("embedding.word_embeddings.",
                                "model.embed_tokens.")
            name = name.replace("encoder.final_layernorm.", "model.norm.")
            if name.startswith("output_layer."):
                name = "lm_head." + name[len("output_layer."):]
            name = name.replace("encoder.layers.", "model.layers.")
            name = name.replace(".self_attention.query_key_value.",
                                ".self_attn.qkv_proj.")
            name = name.replace(".self_attention.dense.",
                                ".self_attn.o_proj.")
            name = name.replace(".mlp.dense_h_to_4h.", ".mlp.gate_up_proj.")
            name = name.replace(".mlp.dense_4h_to_h.", ".mlp.down_proj.")
        elif mt0 == "codeshell":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.c_attn.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.c_proj.", ".self_attn.o_proj.")
            name = name.replace(".mlp.c_fc.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "refact":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.q.", ".self_attn.q_proj.")
            name = name.replace(".attn.kv.", ".self_attn.kv_proj.")
            name = name.replace(".attn.c_proj.", ".self_attn.o_proj.")
            # gate_up_proj splits at cfg.d_ff via the phi3 fused path
            name = name.replace(".mlp.linear_3.", ".mlp.down_proj.")
        elif mt0 == "plamo":
            # PlamoForCausalLM nests blocks under model.layers.layers and
            # names the single pre-norm ".norm" (gguf-py tensor_mapping)
            name = name.replace("model.layers.layers.", "model.layers.")
            if name.startswith("model.layers."):
                name = name.replace(".norm.", ".input_layernorm.")
        elif mt0 == "gpt_neox":
            name = name.replace("gpt_neox.embed_in.", "model.embed_tokens.")
            name = name.replace("gpt_neox.final_layer_norm.", "model.norm.")
            if name.startswith("embed_out."):
                name = "lm_head." + name[len("embed_out."):]
            name = name.replace("gpt_neox.layers.", "model.layers.")
            name = name.replace(".attention.dense.", ".self_attn.o_proj.")
            name = name.replace(".attention.query_key_value.",
                                ".self_attn.qkv_interleaved.")
            name = name.replace(".mlp.dense_h_to_4h.", ".mlp.up_proj.")
            name = name.replace(".mlp.dense_4h_to_h.", ".mlp.down_proj.")
        elif mt0 == "phi":
            name = name.replace("model.final_layernorm.", "model.norm.")
            name = name.replace(".self_attn.dense.", ".self_attn.o_proj.")
            name = name.replace(".mlp.fc1.", ".mlp.up_proj.")
            name = name.replace(".mlp.fc2.", ".mlp.down_proj.")
        elif mt0 == "starcoder2":
            name = name.replace(".mlp.c_fc.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "internlm2":
            name = name.replace("model.tok_embeddings.",
                                "model.embed_tokens.")
            if name.startswith("output."):
                name = "lm_head." + name[len("output."):]
            name = name.replace(".attention.wqkv.",
                                ".self_attn.qkv_grouped.")
            name = name.replace(".attention.wo.", ".self_attn.o_proj.")
            name = name.replace(".feed_forward.w1.", ".mlp.gate_proj.")
            name = name.replace(".feed_forward.w3.", ".mlp.up_proj.")
            name = name.replace(".feed_forward.w2.", ".mlp.down_proj.")
            name = name.replace(".attention_norm.", ".input_layernorm.")
            name = name.replace(".ffn_norm.", ".post_attention_layernorm.")
        elif mt0 == "gpt2":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.wpe.", "model.pos_embed.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.c_attn.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.c_proj.", ".self_attn.o_proj.")
            name = name.replace(".mlp.c_fc.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "opt":
            name = name.replace("model.decoder.embed_tokens.",
                                "model.embed_tokens.")
            name = name.replace("model.decoder.embed_positions.",
                                "model.pos_embed.")
            # decoder-level final norm BEFORE the per-layer rename
            name = name.replace("model.decoder.final_layer_norm.",
                                "model.norm.")
            name = name.replace("model.decoder.layers.", "model.layers.")
            name = name.replace(".self_attn.out_proj.", ".self_attn.o_proj.")
            name = name.replace(".self_attn_layer_norm.",
                                ".input_layernorm.")
            name = name.replace(".final_layer_norm.",
                                ".post_attention_layernorm.")
            name = name.replace(".fc1.", ".mlp.up_proj.")
            name = name.replace(".fc2.", ".mlp.down_proj.")
        elif mt0 == "bloom":
            name = name.replace("transformer.word_embeddings_layernorm.",
                                "model.embed_norm.")
            name = name.replace("transformer.word_embeddings.",
                                "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".self_attention.query_key_value.",
                                ".self_attn.qkv_interleaved.")
            name = name.replace(".self_attention.dense.",
                                ".self_attn.o_proj.")
            name = name.replace(".mlp.dense_h_to_4h.", ".mlp.up_proj.")
            name = name.replace(".mlp.dense_4h_to_h.", ".mlp.down_proj.")
        elif mt0 == "gptj":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".attn.out_proj.", ".self_attn.o_proj.")
            name = name.replace(".attn.q_proj.", ".self_attn.q_proj.")
            name = name.replace(".attn.k_proj.", ".self_attn.k_proj.")
            name = name.replace(".attn.v_proj.", ".self_attn.v_proj.")
            name = name.replace(".mlp.fc_in.", ".mlp.up_proj.")
            name = name.replace(".mlp.fc_out.", ".mlp.down_proj.")
        elif mt0 == "gpt_bigcode":
            # gpt2-style names but nn.Linear (out,in) layout — no transpose
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.wpe.", "model.pos_embed.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.c_attn.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.c_proj.", ".self_attn.o_proj.")
            name = name.replace(".mlp.c_fc.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "falcon":
            name = name.replace("transformer.word_embeddings.",
                                "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            # two-norm parallel residual (40B/180B new_decoder_arch)
            name = name.replace(".ln_attn.", ".input_layernorm.")
            name = name.replace(".ln_mlp.", ".post_attention_layernorm.")
            if raw0.get("new_decoder_architecture"):
                qkv = ".self_attn.qkv_grouped."  # (kvh, g+2, hd, D)
            elif raw0.get("multi_query", True):
                qkv = ".self_attn.qkv_proj."     # straight [q*H; k; v]
            else:
                qkv = ".self_attn.qkv_interleaved."  # per-head [q; k; v]
            name = name.replace(".self_attention.query_key_value.", qkv)
            name = name.replace(".self_attention.dense.",
                                ".self_attn.o_proj.")
            name = name.replace(".mlp.dense_h_to_4h.", ".mlp.up_proj.")
            name = name.replace(".mlp.dense_4h_to_h.", ".mlp.down_proj.")
        elif mt0 in ("glm4", "glm4v"):
            # rename the sandwich norms to the gemma-style postnorm keys
            # (order matters: the FFN pre-norm shares HF's usual name);
            # glm4v wraps its text body as model.language_model.*
            name = name.replace("model.language_model.", "model.")
            name = name.replace(".post_attention_layernorm.",
                                ".pre_feedforward_layernorm.")
            name = name.replace(".post_self_attn_layernorm.",
                                ".post_attention_layernorm.")
            name = name.replace(".post_mlp_layernorm.",
                                ".post_feedforward_layernorm.")
        elif mt0 == "dbrx":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.norm_f.", "model.norm.")
            name = name.replace("transformer.blocks.", "model.layers.")
            name = name.replace(".norm_attn_norm.norm_1.",
                                ".input_layernorm.")
            name = name.replace(".norm_attn_norm.norm_2.",
                                ".post_attention_layernorm.")
            name = name.replace(".norm_attn_norm.attn.Wqkv.",
                                ".self_attn.qkv_proj.")
            name = name.replace(".norm_attn_norm.attn.out_proj.",
                                ".self_attn.o_proj.")
            name = name.replace(".ffn.router.layer.", ".mlp.gate.")
        elif mt0 == "mpt":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.norm_f.", "model.norm.")
            name = name.replace("transformer.blocks.", "model.layers.")
            name = name.replace(".norm_1.", ".input_layernorm.")
            name = name.replace(".norm_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.Wqkv.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.out_proj.", ".self_attn.o_proj.")
            name = name.replace(".ffn.up_proj.", ".mlp.up_proj.")
            name = name.replace(".ffn.down_proj.", ".mlp.down_proj.")
        elif mt0 in ("hunyuan_v1_dense", "hunyuan_v1_moe"):
            name = name.replace(".self_attn.query_layernorm.",
                                ".self_attn.q_norm.")
            name = name.replace(".self_attn.key_layernorm.",
                                ".self_attn.k_norm.")
            name = name.replace(".mlp.gate.wg.", ".mlp.gate.")
            name = name.replace(".mlp.shared_mlp.", ".mlp.shared_experts.")
        elif mt0 == "apertus":
            name = name.replace(".attention_layernorm.",
                                ".input_layernorm.")
            name = name.replace(".feedforward_layernorm.",
                                ".post_attention_layernorm.")
            name = name.replace(".mlp.act_fn.alpha_p", ".mlp.xielu_ap")
            name = name.replace(".mlp.act_fn.alpha_n", ".mlp.xielu_an")
        elif mt0 == "ernie4_5_moe":
            # Ernie4_5_MoeStatics stores the selection bias as (1, E)
            name = name.replace(".mlp.moe_statics.e_score_correction_bias",
                                ".mlp.gate.e_score_correction_bias")
        elif mt0 == "arctic":
            # residual_layernorm feeds the dense branch (maps onto the
            # standard ffn_norm slot); post_attention_layernorm is the
            # MoE branch's norm (FFN_NORM_EXPS, gguf-py ARCTIC overrides)
            name = name.replace(".post_attention_layernorm.",
                                ".moe_layernorm.")
            name = name.replace(".residual_layernorm.",
                                ".post_attention_layernorm.")
            name = name.replace(".residual_mlp.w1.",
                                ".residual_mlp.gate_proj.")
            name = name.replace(".residual_mlp.w3.",
                                ".residual_mlp.up_proj.")
            name = name.replace(".residual_mlp.w2.",
                                ".residual_mlp.down_proj.")
        elif mt0 == "idefics3":
            # Idefics3ForConditionalGeneration wraps its llama text model
            # as model.text_model.*; vision_model/connector are collected
            # into vision_raw below
            name = name.replace("model.text_model.", "model.")
        elif mt0 in ("internvl", "janus", "lfm2_vl", "lfm2-vl"):
            # composite VLMs wrapping their text body as
            # model.language_model.* (internvl: qwen2/llama; janus:
            # llama; lfm2-vl: the lfm2 hybrid)
            name = name.replace("model.language_model.", "model.")
        elif mt0 in ("llama4", "llama4_text"):
            name = name.replace(".feed_forward.router.", ".mlp.gate.")
            name = name.replace(".feed_forward.shared_expert.",
                                ".mlp.shared_expert.")
            name = name.replace(".feed_forward.experts.",
                                ".mlp.experts_stacked.")
            name = name.replace(".feed_forward.", ".mlp.")
        elif mt0 in ("bailing_moe", "bailingmoe", "bailing_moe_v2",
                     "bailing_moe2", "bailingmoe2"):
            name = name.replace("model.word_embeddings.",
                                "model.embed_tokens.")
            name = name.replace(".attention.query_key_value.",
                                ".self_attn.qkv_proj.")
            name = name.replace(".attention.dense.", ".self_attn.o_proj.")
            name = name.replace(".attention.query_layernorm.",
                                ".self_attn.q_norm.")
            name = name.replace(".attention.key_layernorm.",
                                ".self_attn.k_norm.")
            name = name.replace(".mlp.gate.expert_bias",
                                ".mlp.gate.e_score_correction_bias")
        elif mt0 in ("grok-1", "grok1", "grok", "grok-2", "grok2"):
            # grok-1 'transformer.decoder_layer' scheme (gguf-py
            # tensor_mapping); grok-2 uses pre/post_attn_norm +
            # pre/post_moe_norm around otherwise-standard names
            name = name.replace("transformer.in_out_embed.",
                                "model.embed_tokens.")
            name = name.replace("transformer.rms_norm.", "model.norm.")
            name = name.replace("transformer.decoder_layer.",
                                "model.layers.")
            name = name.replace(".multi_head_attention.query.",
                                ".self_attn.q_proj.")
            name = name.replace(".multi_head_attention.key.",
                                ".self_attn.k_proj.")
            name = name.replace(".multi_head_attention.value.",
                                ".self_attn.v_proj.")
            name = name.replace(".multi_head_attention.linear.",
                                ".self_attn.o_proj.")
            name = re.sub(r"\.moe\.(\d+)\.linear_v\.",
                          r".block_sparse_moe.experts.\1.w3.", name)
            name = re.sub(r"\.moe\.(\d+)\.linear_1\.",
                          r".block_sparse_moe.experts.\1.w2.", name)
            name = re.sub(r"\.moe\.(\d+)\.linear\.",
                          r".block_sparse_moe.experts.\1.w1.", name)
            name = name.replace(".router.", ".block_sparse_moe.gate.")
            # sandwich-norm keys (grok-1 rms_norm_N / grok-2 named)
            name = name.replace(".rms_norm_1.", ".post_attention_layernorm.")
            name = name.replace(".rms_norm_2.", ".pre_feedforward_layernorm.")
            name = name.replace(".rms_norm_3.",
                                ".post_feedforward_layernorm.")
            name = name.replace(".rms_norm.", ".input_layernorm.")
            name = name.replace(".pre_attn_norm.", ".input_layernorm.")
            name = name.replace(".post_attn_norm.",
                                ".post_attention_layernorm.")
            name = name.replace(".pre_moe_norm.",
                                ".pre_feedforward_layernorm.")
            name = name.replace(".post_moe_norm.",
                                ".post_feedforward_layernorm.")
        elif mt0 == "exaone":
            name = name.replace("transformer.wte.", "model.embed_tokens.")
            name = name.replace("transformer.ln_f.", "model.norm.")
            name = name.replace("transformer.h.", "model.layers.")
            name = name.replace(".ln_1.", ".input_layernorm.")
            name = name.replace(".ln_2.", ".post_attention_layernorm.")
            name = name.replace(".attn.attention.q_proj.",
                                ".self_attn.q_proj.")
            name = name.replace(".attn.attention.k_proj.",
                                ".self_attn.k_proj.")
            name = name.replace(".attn.attention.v_proj.",
                                ".self_attn.v_proj.")
            name = name.replace(".attn.attention.out_proj.",
                                ".self_attn.o_proj.")
            name = name.replace(".mlp.c_fc_0.", ".mlp.gate_proj.")
            name = name.replace(".mlp.c_fc_1.", ".mlp.up_proj.")
            name = name.replace(".mlp.c_proj.", ".mlp.down_proj.")
        elif mt0 == "mistral3":
            # Mistral3ForConditionalGeneration text tower (reference
            # src/models/mistral3.cpp — a plain llama/mistral graph);
            # vision tensors are dropped before canon()
            name = name.replace("model.language_model.", "model.")
            name = name.replace("language_model.model.", "model.")
            if name.startswith("language_model.lm_head."):
                name = name[len("language_model."):]
        elif mt0 == "minimax_m2":
            # MiniMax-M2 (src/models/minimax-m2.cpp): mixtral expert
            # names + deepseek-style selection bias
            name = name.replace(
                ".block_sparse_moe.e_score_correction_bias",
                ".mlp.gate.e_score_correction_bias")
            name = name.replace(".block_sparse_moe.gate.",
                                ".mlp.gate.")
            name = name.replace(".block_sparse_moe.coefficient.",
                                ".mlp.gate.")
        elif mt0 == "smallthinker":
            name = name.replace(".block_sparse_moe.primary_router.",
                                ".mlp.gate.")
            name = re.sub(r"\.block_sparse_moe\.experts\.(\d+)\.gate\.",
                          r".block_sparse_moe.experts.\1.gate_proj.", name)
            name = re.sub(r"\.block_sparse_moe\.experts\.(\d+)\.up\.",
                          r".block_sparse_moe.experts.\1.up_proj.", name)
            name = re.sub(r"\.block_sparse_moe\.experts\.(\d+)\.down\.",
                          r".block_sparse_moe.experts.\1.down_proj.", name)
        elif mt0 == "afmoe":
            # afmoe (src/models/afmoe.cpp): router under mlp.router.gate,
            # selection bias mlp.expert_bias, attention gate
            # self_attn.gate_proj, mlp pre/post norms
            name = name.replace(".mlp.router.gate.", ".mlp.gate.")
            name = name.replace(".mlp.expert_bias",
                                ".mlp.gate.e_score_correction_bias")
            name = name.replace(".self_attn.gate_proj.",
                                ".self_attn.attn_gate_proj.")
            name = name.replace(".pre_mlp_layernorm.",
                                ".pre_feedforward_layernorm.")
            name = name.replace(".post_mlp_layernorm.",
                                ".post_feedforward_layernorm.")
        elif mt0 == "mimo2":
            name = name.replace(".self_attn.attention_sink_bias",
                                ".self_attn.sink_bias")
        elif mt0 == "cogvlm":
            # CogVLM (src/models/cogvlm.cpp): llama body whose per-layer
            # weights come in TWO sets — language expert (text batches)
            # and visual expert (image-embedding batches); vision tower
            # tensors (model.vision.*) are dropped like the reference
            # CogVLMModel converter
            name = name.replace(
                ".self_attn.language_expert_query_key_value.",
                ".self_attn.qkv_proj.")
            name = name.replace(".self_attn.language_expert_dense.",
                                ".self_attn.o_proj.")
            name = name.replace(".mlp.language_mlp.", ".mlp.")
            name = name.replace(
                ".self_attn.vision_expert_query_key_value.",
                ".self_attn.vis_qkv_proj.")
            name = name.replace(".self_attn.vision_expert_dense.",
                                ".self_attn.vis_o_proj.")
            name = name.replace(".mlp.vision_mlp.gate_proj.",
                                ".mlp.vis_gate_proj.")
            name = name.replace(".mlp.vision_mlp.up_proj.",
                                ".mlp.vis_up_proj.")
            name = name.replace(".mlp.vision_mlp.down_proj.",
                                ".mlp.vis_down_proj.")
        elif mt0 == "openelm":
            # apple OpenELM 'transformer.layers' scheme (src/models/
            # openelm.cpp): fused [q;k;v] qkv at per-layer head counts,
            # fused [gate|up] proj_1, per-head q/k norms
            name = name.replace("transformer.token_embeddings.",
                                "model.embed_tokens.")
            name = name.replace("transformer.norm.", "model.norm.")
            name = name.replace("transformer.layers.", "model.layers.")
            name = name.replace(".attn_norm.", ".input_layernorm.")
            name = name.replace(".attn.qkv_proj.", ".self_attn.qkv_proj.")
            name = name.replace(".attn.q_norm.", ".self_attn.q_norm.")
            name = name.replace(".attn.k_norm.", ".self_attn.k_norm.")
            name = name.replace(".attn.out_proj.", ".self_attn.o_proj.")
            name = name.replace(".ffn_norm.", ".post_attention_layernorm.")
            name = name.replace(".ffn.proj_1.", ".mlp.gate_up_proj.")
            name = name.replace(".ffn.proj_2.", ".mlp.down_proj.")
        elif mt0 in ("plamo3", "plamo-3"):
            # PLaMo-3 'model.layers.layers' + mixer scheme
            # (src/models/plamo3.cpp); norm weights carry PLaMo offset
            # parameterization, folded below
            name = name.replace("model.layers.layers.", "model.layers.")
            name = name.replace(".mixer.qkv_proj.", ".self_attn.qkv_proj.")
            name = name.replace(".mixer.o_proj.", ".self_attn.o_proj.")
            name = name.replace(".mixer.q_norm.", ".self_attn.q_norm.")
            name = name.replace(".mixer.k_norm.", ".self_attn.k_norm.")
            name = name.replace(".pre_mixer_norm.", ".input_layernorm.")
            name = name.replace(".post_mixer_norm.",
                                ".post_attention_layernorm.")
            name = name.replace(".pre_mlp_norm.",
                                ".pre_feedforward_layernorm.")
            name = name.replace(".post_mlp_norm.",
                                ".post_feedforward_layernorm.")
        elif is_embgemma and not name.startswith("model."):
            # EmbeddingGemma (Gemma3TextModel): tensors are saved WITHOUT
            # the "model." wrapper (embed_tokens/layers.N/norm)
            name = "model." + name
        return name

    for name, w in _iter_hf_tensors(hf_dir):
        if mt0 == "cogvlm" and name.startswith("model.vision."):
            continue  # cogvlm's EVA2-CLIP tower is not the LM graph's
        name = canon(name)
        if mt0 in ("plamo3", "plamo-3") and name.endswith(".weight"):
            # PLaMo RMSNorm offset parameterization: effective gain =
            # stored + offset (reference Plamo3Model.modify_tensors)
            _off = {
                ".input_layernorm.": 1.0,
                ".post_attention_layernorm.": 1.0 / 5,
                ".pre_feedforward_layernorm.": 1.0,
                ".post_feedforward_layernorm.": 1.0 / 5 ** 1.5,
                ".self_attn.q_norm.": 1.0,
                ".self_attn.k_norm.": 1.0,
            }
            for pat_, o_ in _off.items():
                if pat_ in name:
                    w = np.asarray(w, np.float32) + o_
                    break
            else:
                if name == "model.norm.weight":
                    w = np.asarray(w, np.float32) + 1.0
        if name.endswith("weight_scale"):
            continue
        if name.endswith(".inv_freq"):
            continue  # chatglm/plamo serialize rope tables; recomputed here
        if mt0 in ("gpt2", "jais") and name.endswith(".weight") and any(
            s in name for s in (
                ".self_attn.qkv_proj.", ".self_attn.o_proj.",
                ".mlp.up_proj.", ".mlp.down_proj.", ".mlp.gate_proj.",
            )
        ):
            # HF GPT2 Conv1D stores weights (in, out); normalize to the
            # nn.Linear (out, in) convention the packers expect
            w = np.asarray(w).T
        if name == "model.pos_embed.weight":
            pe = np.asarray(w, np.float32)
            if mt0 == "opt":
                pe = pe[2:]  # OPT offsets positions by 2 reserved rows
            top["pos_embed"] = _hp(pe, hp)
            continue
        if name == "model.embed_norm.weight":
            top["embed_norm"] = np.asarray(w, np.float32)
            continue
        if name == "model.embed_norm.bias":
            top["embed_norm_b"] = np.asarray(w, np.float32)
            continue
        if name.startswith("model.vqmodel."):
            continue  # chameleon/janus image VQ-VAE (generation-side)
        if name.startswith(("model.generation_", "generation_")):
            continue  # janus image-generation head/aligner/embeddings
        if name.startswith(_TOWER_PREFIXES):
            vision_raw[name.removeprefix("model.")] = np.asarray(w)
            continue
        if name.startswith(("model.visual.", "visual.")):
            if mt0 in ("qwen2_vl", "qwen2_5_vl"):
                qwen_vis_raw[name.split("visual.", 1)[1]] = np.asarray(w)
            elif mt0 in ("glm4v", "qwen3_vl", "qwen3_vl_moe"):
                vision_raw["visual." + name.split("visual.", 1)[1]] = (
                    np.asarray(w))
            continue
        if name.startswith("language_model."):
            name = name[len("language_model."):]
        if name == "model.embed_tokens.weight":
            top["embed"] = _hp(np.asarray(
                _maybe_unpack_2bit(name, w, side_scales), np.float32), hp)
            continue
        if name == "lm_head.weight":
            if mt0 == "baichuan" and cfg.vocab_size == 125696:
                # Baichuan2 NormHead: inference uses the row-normalized
                # head (upstream convert_hf_to_gguf BaichuanModel analog)
                wf = np.asarray(w, np.float32)
                w = wf / np.maximum(
                    np.linalg.norm(wf, axis=-1, keepdims=True), 1e-12
                )
            elif mt0 in ("bailing_moe", "bailingmoe") and raw0.get(
                "norm_head"
            ):
                # Bailing norm_head: column L2-normalized at load time
                # (convert_hf_to_gguf BailingMoeModel.modify_tensors)
                wf = np.asarray(w, np.float32)
                w = wf / (np.linalg.norm(wf, axis=0, keepdims=True) + 1e-7)
            plan = make_plan(cfg)
            top["lm_head"] = _head(np.asarray(w, np.float32), plan.vocab_p,
                                   hp, dev)  # (D, vocab_p)
            continue
        if name == "model.norm.weight":
            top["final_norm"] = np.asarray(w, np.float32)
            continue
        if name == "model.norm.bias":
            top["final_norm_b"] = np.asarray(w, np.float32)
            continue
        if name == "lm_head.bias":
            v = np.asarray(w, np.float32)
            top["lm_head_b"] = np.pad(v, (0, plan.vocab_p - v.shape[0]))
            continue
        if name in ("score.weight", "classifier.weight"):
            # *ForSequenceClassification rank head (rerankers): (C, D) ->
            # (D, C); served by /rerank (reference: pooling_type RANK +
            # cls tensor, src/llama-model.cpp classifier tensors)
            top.setdefault("rank_head", {})["w"] = np.asarray(
                w, np.float32
            ).T
            continue
        if name in ("score.bias", "classifier.bias"):
            top.setdefault("rank_head", {})["b"] = np.asarray(w, np.float32)
            continue
        mb = re.match(
            r"model\.layers\.(\d+)\.mlp\.gate\.e_score_correction_bias$",
            name,
        )
        if mb:
            # deepseek V3 selection bias (noaux_tc routing); ernie stores
            # it (1, E) inside moe_statics — flatten either way
            note_layer("router_bias", int(mb.group(1)),
                       np.asarray(w, np.float32).reshape(-1))
            continue
        # gpt-oss / dbrx tensors that carry no .weight/.bias suffix
        # (sinks, stacked expert parameters) or fold a bias into the router
        mg = re.match(r"model\.layers\.(\d+)\.(.+)$", name)
        if mg and mt0 == "apertus" and mg.group(2) in (
            "mlp.xielu_ap", "mlp.xielu_an"
        ):
            note_layer(mg.group(2).split(".")[1], int(mg.group(1)),
                       np.asarray(w, np.float32).reshape(-1))
            continue
        if mg and mt0 == "mimo2" and mg.group(2) in (
            "self_attn.sink_bias", "self_attn.sink_bias.weight"
        ):
            # MiMo-V2 learned per-head attention sinks
            # (src/models/mimo2-iswa.cpp attn_sinks)
            note_layer("sinks", int(mg.group(1)),
                       np.asarray(w, np.float32).reshape(-1))
            continue
        if mg and mt0 == "dbrx":
            li_g, sub_g = int(mg.group(1)), mg.group(2)
            if sub_g in ("ffn.experts.mlp.w1", "ffn.experts.mlp.v1",
                         "ffn.experts.mlp.w2"):
                # (E*ff, D) flat stacks; w1=gate, v1=up are (out,in) per
                # expert, w2=down is (in,out) per expert (DbrxExpertGLU
                # applies it untransposed)
                wf = np.asarray(w, np.float32).reshape(
                    cfg.n_experts, -1, w.shape[-1]
                )
                pname = {"ffn.experts.mlp.w1": "w_gate",
                         "ffn.experts.mlp.v1": "w_up",
                         "ffn.experts.mlp.w2": "w_down"}[sub_g]
                for e in range(cfg.n_experts):
                    we = wf[e].T if pname == "w_down" else wf[e]
                    pack_proj(pname, we, li_g, expert=e)
                continue
        if mg and mt0 in ("qwen3_vl_moe", "qwen3_vl_moe_text"):
            # Qwen3VLMoeTextExperts: stacked (E, D, 2*ff) gate_up with
            # [gate | up] contiguous halves (HF chunk(2, dim=-1)) and
            # (E, ff, D) down — reference src/models/qwen3vl-moe.cpp
            # serves the same softmax top-k renormalized MoE
            li_g, sub_g = int(mg.group(1)), mg.group(2)
            if sub_g == "mlp.experts.gate_up_proj":
                wf = np.asarray(w, np.float32)
                ff2 = wf.shape[-1] // 2
                for e in range(wf.shape[0]):
                    pack_proj("w_gate", wf[e, :, :ff2].T, li_g, expert=e)
                    pack_proj("w_up", wf[e, :, ff2:].T, li_g, expert=e)
                continue
            if sub_g == "mlp.experts.down_proj":
                wf = np.asarray(w, np.float32)  # (E, ff, D)
                for e in range(wf.shape[0]):
                    pack_proj("w_down", wf[e].T, li_g, expert=e)
                continue
        if mg and mt0 in ("llama4", "llama4_text"):
            li_g, sub_g = int(mg.group(1)), mg.group(2)
            if sub_g == "mlp.experts_stacked.gate_up_proj":
                # Llama4TextExperts: (E, D, 2*ff) with [gate | up] as
                # contiguous HALVES of the last dim (HF chunk(2, dim=-1))
                wf = np.asarray(w, np.float32)
                ff2 = wf.shape[-1] // 2
                for e in range(wf.shape[0]):
                    pack_proj("w_gate", wf[e, :, :ff2].T, li_g, expert=e)
                    pack_proj("w_up", wf[e, :, ff2:].T, li_g, expert=e)
                continue
            if sub_g == "mlp.experts_stacked.down_proj":
                wf = np.asarray(w, np.float32)  # (E, ff, D)
                for e in range(wf.shape[0]):
                    pack_proj("w_down", wf[e].T, li_g, expert=e)
                continue
        if mg and mt0 in ("granitemoe", "granitemoeshared"):
            # GraniteMoe (reference convert GraniteMoeModel:8548-8583):
            # JetMoe-style parallel experts — input_linear is a stacked
            # (E, 2*ff, D) with [gate; up] as row halves, output_linear is
            # (E, D, ff); the shared variant carries the same fusion at
            # shared_intermediate_size as plain 2-D tensors
            li_g, sub_g = int(mg.group(1)), mg.group(2)
            if sub_g == "block_sparse_moe.input_linear.weight":
                wf = np.asarray(w, np.float32)
                ff2 = wf.shape[1] // 2
                for e in range(wf.shape[0]):
                    pack_proj("w_gate", wf[e, :ff2], li_g, expert=e)
                    pack_proj("w_up", wf[e, ff2:], li_g, expert=e)
                continue
            if sub_g == "block_sparse_moe.output_linear.weight":
                wf = np.asarray(w, np.float32)  # (E, D, ff)
                for e in range(wf.shape[0]):
                    pack_proj("w_down", wf[e], li_g, expert=e)
                continue
            if sub_g == "block_sparse_moe.router.layer.weight":
                note_layer("router", li_g, np.asarray(w, np.float32).T)
                continue
            if sub_g.startswith("shared_mlp."):
                cfg_sh = dataclasses.replace(cfg, d_ff=cfg.d_ff_shared,
                                     n_experts=0)
                if sub_g == "shared_mlp.input_linear.weight":
                    wf = np.asarray(w, np.float32)  # (2*sh, D)
                    sh2 = wf.shape[0] // 2
                    pack_proj("w_shared_gate", wf[:sh2], li_g,
                              cfg_over=cfg_sh)
                    pack_proj("w_shared_up", wf[sh2:], li_g,
                              cfg_over=cfg_sh)
                    continue
                if sub_g == "shared_mlp.output_linear.weight":
                    pack_proj("w_shared_down", np.asarray(w, np.float32),
                              li_g, cfg_over=cfg_sh)
                    continue
        if mg and mt0 == "gpt_oss":
            li_g, sub_g = int(mg.group(1)), mg.group(2)
            if sub_g == "self_attn.sinks":
                # learned per-head attention-sink logits
                note_layer("sinks", li_g, np.asarray(w, np.float32))
                continue
            if sub_g == "mlp.router.weight":
                note_layer("router", li_g, np.asarray(w, np.float32).T)
                continue
            if sub_g == "mlp.router.bias":
                note_layer("router_b", li_g, np.asarray(w, np.float32))
                continue
            if sub_g == "mlp.experts.gate_up_proj":
                # (E, D, 2*ff) with gate/up INTERLEAVED on the last dim
                wf = np.asarray(w, np.float32)
                for e in range(wf.shape[0]):
                    pack_proj("w_gate", wf[e, :, 0::2].T, li_g, expert=e)
                    pack_proj("w_up", wf[e, :, 1::2].T, li_g, expert=e)
                continue
            if sub_g == "mlp.experts.gate_up_proj_bias":
                bf = np.asarray(w, np.float32)  # (E, 2*ff)
                note_layer("eb_gate", li_g, np.stack([
                    scatter_vec(r, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
                    for r in bf[:, 0::2]
                ]))
                note_layer("eb_up", li_g, np.stack([
                    scatter_vec(r, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
                    for r in bf[:, 1::2]
                ]))
                continue
            if sub_g == "mlp.experts.down_proj":
                wf = np.asarray(w, np.float32)  # (E, ff, D)
                for e in range(wf.shape[0]):
                    pack_proj("w_down", wf[e].T, li_g, expert=e)
                continue
            if sub_g == "mlp.experts.down_proj_bias":
                note_layer("eb_down", li_g, np.asarray(w, np.float32))
                continue
        m = layer_re.match(name)
        if not m:
            log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub, kind = int(m.group(1)), m.group(2), m.group(3)
        # deepseek shared experts + dense first-k layers pack at their own
        # FFN widths (cfg_over carries the width; see pack_weight)
        if cfg.n_shared_experts and sub.startswith(
            ("mlp.shared_experts.", "mlp.shared_expert")
        ):
            if sub == "mlp.shared_expert_gate":
                # qwen2-moe sigmoid shared gate: (1, D) row -> (D,)
                note_layer("shared_gate", li,
                           np.asarray(w, np.float32).reshape(-1))
                continue
            cfg_s = dataclasses.replace(
                cfg,
                d_ff=cfg.d_ff_shared or cfg.n_shared_experts * cfg.d_ff,
                n_experts=0,
            )
            pname = {
                "mlp.shared_experts.gate_proj": "w_shared_gate",
                "mlp.shared_experts.up_proj": "w_shared_up",
                "mlp.shared_experts.down_proj": "w_shared_down",
                # qwen2-moe singular naming
                "mlp.shared_expert.gate_proj": "w_shared_gate",
                "mlp.shared_expert.up_proj": "w_shared_up",
                "mlp.shared_expert.down_proj": "w_shared_down",
            }.get(sub)
            if pname:
                pack_proj(pname, w, li, cfg_over=cfg_s)
                continue
        if cfg.moe_parallel == "arctic" and sub.startswith("residual_mlp."):
            cfg_r = dataclasses.replace(
                cfg, d_ff=cfg.d_ff_dense or cfg.d_ff, n_experts=0
            )
            pname = {"residual_mlp.gate_proj": "w_res_gate",
                     "residual_mlp.up_proj": "w_res_up",
                     "residual_mlp.down_proj": "w_res_down"}.get(sub)
            if pname:
                pack_proj(pname, w, li, cfg_over=cfg_r)
                continue
        if (
            ((cfg.first_k_dense and li < cfg.first_k_dense)
             or (cfg.dense_layers and cfg.dense_layers[li]))
            and sub in ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
        ):
            cfg_d = dataclasses.replace(
                cfg, d_ff=cfg.d_ff_dense or cfg.d_ff, n_experts=0
            )
            pack_proj(_PROJ_MAP[sub], w, li, cfg_over=cfg_d)
            continue
        if kind == "bias":
            v = np.asarray(w, np.float32)
            if sub in _BIAS_MAP and cfg.qkv_bias:
                pname = _BIAS_MAP[sub]
                heads = cfg.n_heads if pname == "bq" else cfg.n_kv_heads
                note_layer(pname, li, pad_vec_heads(
                    v, heads, plan.hd, plan.hd_p))
            elif sub == "self_attn.qkv_interleaved" and cfg.qkv_bias:
                # gptneox/bloom fused qkv bias: per-head [q; k; v] interleave
                h_, hd_ = cfg.n_heads, plan.hd
                v3 = v.reshape(h_, 3, hd_)
                for j, pname in enumerate(("bq", "bk", "bv")):
                    note_layer(pname, li, pad_vec_heads(
                        v3[:, j].reshape(-1), h_, plan.hd, plan.hd_p))
            elif sub == "self_attn.qkv_proj" and cfg.qkv_bias:
                # gpt2/mpt fused qkv bias: straight [q; k; v] concat
                qd, kvd = cfg.q_dim, cfg.kv_dim
                for pname, seg, heads in (
                    ("bq", v[:qd], cfg.n_heads),
                    ("bk", v[qd:qd + kvd], cfg.n_kv_heads),
                    ("bv", v[qd + kvd:], cfg.n_kv_heads),
                ):
                    note_layer(pname, li, pad_vec_heads(
                        seg, heads, plan.hd, plan.hd_p))
            elif cfg.proj_bias and sub in _PROJ_BIAS_MAP:
                pname = _PROJ_BIAS_MAP[sub]
                if pname == "b_up":
                    v = scatter_vec(
                        v, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p
                    )
                note_layer(pname, li, v)
            elif cfg.qk_norm_type == "ln" and sub in (
                "self_attn.q_norm", "self_attn.k_norm"
            ):
                heads = (cfg.n_heads if "q_norm" in sub
                         else cfg.n_kv_heads)
                note_layer(
                    norm_map[sub] + "_b", li,
                    pad_vec_heads(
                        v.reshape(-1), heads, plan.hd, plan.hd_p
                    ).reshape(heads, plan.hd_p),
                )
            elif cfg.norm_type == "ln" and sub in norm_map:
                note_layer(norm_map[sub] + "_b", li, v)
            else:
                log.warning("skipping bias tensor %s", name)
            continue
        if sub in norm_map:
            pname = norm_map[sub]
            v = np.asarray(w, np.float32)
            if pname == "attn_sub_norm":
                v = pad_vec_heads(v, cfg.n_heads, plan.hd, plan.hd_p)
                v = scatter_vec(
                    v, plan.wo_chunk, plan.wo_chunk_p, plan.wo_in_p
                )
            elif pname == "ffn_sub_norm":
                v = scatter_vec(v, plan.ff_chunk, plan.ff_chunk_p, plan.ff_p)
            elif pname in ("q_norm", "k_norm"):
                heads = (cfg.n_heads if pname == "q_norm"
                         else cfg.n_kv_heads)
                if v.ndim == 2:
                    # chameleon: DISTINCT per-head (H, hd) LN gains —
                    # scatter each head's row onto the padded layout
                    v = pad_vec_heads(
                        v.reshape(-1), heads, plan.hd, plan.hd_p
                    ).reshape(heads, plan.hd_p)
                elif cfg.qk_norm_scope == "whole":
                    # olmo2: ONE norm over heads*head_dim — pad per head so
                    # the weight reshapes onto the padded (H, hd_p) layout
                    v = pad_vec_heads(v, heads, plan.hd, plan.hd_p)
                else:
                    # per-head gains ride the rope-aware scattered layout
                    # (dims.head_positions): half-pair j >= hd/2 lives at
                    # hd_p/2 + (j - hd/2), NOT at j — a tail zero-pad would
                    # zero the second half-pair's gains
                    v = pad_vec_heads(v, 1, plan.hd, plan.hd_p)
            note_layer(pname, li, v)
            continue
        # MoE router + experts
        if sub in ("block_sparse_moe.gate", "mlp.gate") and cfg.n_experts:
            note_layer(
                "router", li, np.asarray(w, np.float32).T  # (D, E)
            )
            continue
        if cfg.moe_chunk_experts:
            if sub.endswith(".expert_bias"):
                continue  # grovemoe expert_bias is unused in the modeling
            em_c = re.match(
                r"mlp\.chunk_experts\.(\d+)\."
                r"(gate_proj|up_proj|down_proj)$", sub,
            )
            if em_c:
                cfg_c = dataclasses.replace(
                    cfg, d_ff=cfg.d_ff_chunk or cfg.d_ff, n_experts=0
                )
                pname = {"gate_proj": "w_ch_gate", "up_proj": "w_ch_up",
                         "down_proj": "w_ch_down"}[em_c.group(2)]
                pack_proj(pname, w, li, expert=int(em_c.group(1)),
                          cfg_over=cfg_c)
                continue
        em = _MOE_EXPERT_RE.match(sub)
        if em and cfg.n_experts:
            pack_proj(
                _MOE_EXPERT_MAP[em.group(2)],
                _two_bit(name, w, side_scales),
                li, expert=int(em.group(1)),
            )
            continue
        # deepseek MLA projections (cfg.kv_lora_rank set)
        if cfg.kv_lora_rank and sub.startswith("self_attn."):
            dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
            mla_map = {
                "self_attn.q_a_proj": "wq_a",
                "self_attn.q_b_proj": "wq_b",
                "self_attn.q_proj": "wq_full",
                "self_attn.kv_a_proj_with_mqa": "wkv_a",
            }
            if sub in mla_map:
                pack_proj(mla_map[sub], w, li)
                continue
            if sub == "self_attn.q_a_layernorm":
                note_layer("q_a_norm", li, np.asarray(w, np.float32))
                continue
            if sub == "self_attn.kv_a_layernorm":
                note_layer("kv_a_norm", li, np.asarray(w, np.float32))
                continue
            if sub == "self_attn.kv_b_proj":
                # (H*(dn+v), r_kv) -> absorbed dense factors
                # W_uk (H, dn, r_kv) and W_uv (H, r_kv, v_hd); kept dense —
                # the absorbed einsums run on them directly
                w3 = np.asarray(w, np.float32).reshape(
                    cfg.n_heads, dn + cfg.head_dim_, -1
                )
                note_layer("w_uk", li, w3[:, :dn])
                note_layer("w_uv", li, np.ascontiguousarray(
                    w3[:, dn:].transpose(0, 2, 1)))
                continue
            # o_proj falls through to the standard map below

        # gptneox fused qkv: rows interleave [q; k; v] PER HEAD
        if sub == "self_attn.qkv_interleaved":
            wf = np.asarray(
                _maybe_unpack_2bit(name, w, side_scales), np.float32
            )
            h_, hd_ = cfg.n_heads, cfg.head_dim_
            w3 = wf.reshape(h_, 3, hd_, cfg.d_model)
            for j, pname in enumerate(("wq", "wk", "wv")):
                pack_proj(pname, w3[:, j].reshape(h_ * hd_, -1), li)
            continue
        # internlm2 fused wqkv: rows grouped per KV group [q*g; k; v]
        if sub == "self_attn.qkv_grouped":
            wf = np.asarray(
                _maybe_unpack_2bit(name, w, side_scales), np.float32
            )
            kvh, hd_ = cfg.n_kv_heads, cfg.head_dim_
            g = cfg.n_heads // kvh
            wg = wf.reshape(kvh, g + 2, hd_, cfg.d_model)
            pack_proj("wq", wg[:, :g].reshape(kvh * g * hd_, -1), li)
            pack_proj("wk", wg[:, g].reshape(kvh * hd_, -1), li)
            pack_proj("wv", wg[:, g + 1].reshape(kvh * hd_, -1), li)
            continue
        # refact fused kv: rows [k(kv_dim); v(kv_dim)]
        if sub == "self_attn.kv_proj":
            wf = np.asarray(
                _maybe_unpack_2bit(name, w, side_scales), np.float32
            )
            kvd_ = cfg.kv_dim
            pack_proj("wk", wf[:kvd_], li)
            pack_proj("wv", wf[kvd_:], li)
            continue
        if mt0 == "plamo" and sub in ("self_attn.q_proj",
                                      "self_attn.o_proj"):
            # plamo stores q heads group-major (flat head f attends kv
            # head f % n_kv); reorder to the h // (H/KV) convention the
            # forward uses (reference convert PlamoModel
            # shuffle_attn_q_weight / shuffle_attn_output_weight)
            wf = np.asarray(w, np.float32)
            g_, s_, hd_ = (cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads,
                           cfg.head_dim_)
            if sub == "self_attn.q_proj":
                wf = wf.reshape(g_, s_, hd_, -1).transpose(1, 0, 2, 3)
                w = wf.reshape(cfg.n_heads * hd_, -1)
            else:
                wf = wf.reshape(-1, g_, s_, hd_).transpose(0, 2, 1, 3)
                w = wf.reshape(-1, cfg.n_heads * hd_)
            pack_proj(_PROJ_MAP[sub], w, li)
            continue
        if sub == "self_attn.vis_qkv_proj":
            # cogvlm's visual-expert fused qkv
            wf = np.asarray(w, np.float32)
            qd, kvd = cfg.q_dim, cfg.kv_dim
            pack_proj("vis_wq", wf[:qd], li)
            pack_proj("vis_wk", wf[qd : qd + kvd], li)
            pack_proj("vis_wv", wf[qd + kvd :], li)
            continue
        if sub in _VIS_MAP:
            pack_proj(_VIS_MAP[sub], w, li)
            continue
        # phi3-style fused projections (openelm/plamo3: per-layer head
        # counts — split at this layer's own widths)
        if sub == "self_attn.qkv_proj":
            wf = np.asarray(
                _maybe_unpack_2bit(name, w, side_scales), np.float32
            )
            if cfg.heads_per_layer:
                nh, nkv = cfg.heads_per_layer[li]
                qd, kvd = nh * cfg.head_dim_, nkv * cfg.head_dim_
            else:
                qd, kvd = cfg.q_dim, cfg.kv_dim
            pack_proj("wq", wf[:qd], li)
            pack_proj("wk", wf[qd : qd + kvd], li)
            pack_proj("wv", wf[qd + kvd :], li)
            continue
        if sub == "mlp.gate_up_proj":
            wf = np.asarray(
                _maybe_unpack_2bit(name, w, side_scales), np.float32
            )
            ff2 = wf.shape[0] // 2  # == cfg.d_ff except per-layer widths
            pack_proj("w_gate", wf[:ff2], li)
            pack_proj("w_up", wf[ff2:], li)
            continue
        if sub == "self_attn.linear_attn":
            # deci replace_with_linear layer: wo applied straight to the
            # attn-normed d_model input (src/models/deci.cpp n_head_kv==0)
            pack_proj("w_lin_attn", w, li)
            continue
        if sub not in _PROJ_MAP:
            log.warning("skipping unrecognized layer tensor %s", name)
            continue
        pack_proj(_PROJ_MAP[sub], _two_bit(name, w, side_scales), li)

    if mt0 == "olmo":
        # OLMo-1 uses non-parametric LayerNorm (no weight/bias tensors in
        # the checkpoint): synthesize unit gains so the LN path reproduces
        # OlmoLayerNorm exactly
        for i in range(L):
            note_layer("attn_norm", i, np.ones(cfg.d_model, np.float32))
            note_layer("ffn_norm", i, np.ones(cfg.d_model, np.float32))
        top["final_norm"] = np.ones(cfg.d_model, np.float32)

    if n_approx:
        log.warning(
            "%d tensors were NOT exactly ternary — applied BitNet absmean "
            "ternarization (lossy). Expect quality differences vs the "
            "original float checkpoint.", n_approx,
        )

    # Stack per-layer values.  Heterogeneous stacks (deepseek
    # first_k_dense: dense-FFN head layers + MoE rest) cannot stack into
    # one array per name — emit a TUPLE of per-layer trees instead (the
    # engine's unrolled layer loop consumes it directly; the lax.scan
    # path requires homogeneous stacks and is not used for these models)
    if (cfg.first_k_dense or (cfg.dense_layers and any(cfg.dense_layers))
            or cfg.heads_per_layer or cfg.d_ff_per_layer):
        lt: list[dict[str, Any]] = []
        for i in range(L):
            ld: dict[str, Any] = {}
            for pname, by_layer in per_layer.items():
                if i not in by_layer:
                    continue
                v = by_layer[i]
                if isinstance(v, dict):  # {expert: TernaryTensor}
                    E = (cfg.moe_chunk_experts
                         if pname.startswith("w_ch_") else cfg.n_experts)
                    ld[pname] = _stack_packed([v[e] for e in range(E)])
                elif hasattr(v, "packed"):
                    ld[pname] = {"packed": v.packed,
                                 "scale": v.scale.reshape(())}
                elif pname in ("w_uk", "w_uv"):
                    ld[pname] = {"dense": np.asarray(v, np.float32)}
                else:
                    ld[pname] = np.asarray(v)
            lt.append(ld)
        params = {**top, "layers": tuple(lt)}
        extra_meta_h: dict[str, Any] = {
            "source": str(hf_dir),
            "ternarized_tensors": n_approx,
        }
        if n_approx:
            log.warning(
                "%d tensors were NOT exactly ternary — applied BitNet "
                "absmean ternarization (lossy).", n_approx,
            )
        _save(out_dir, cfg, params, hf_dir, extra_meta_h)
        return cfg

    for pname, by_layer in per_layer.items():
        missing = [i for i in range(L) if i not in by_layer]
        if missing:
            if pname in ("attn_sub_norm", "ffn_sub_norm"):
                continue  # plain-llama checkpoints have no sub-norms
            raise ValueError(f"missing layers {missing} for {pname}")
        vals = [by_layer[i] for i in range(L)]
        if isinstance(vals[0], dict):  # {expert: TernaryTensor} per layer
            E = (cfg.moe_chunk_experts
                 if pname.startswith("w_ch_") else cfg.n_experts)
            for li, v in enumerate(vals):
                if sorted(v.keys()) != list(range(E)):
                    raise ValueError(
                        f"layer {li} {pname}: experts {sorted(v)} != 0..{E-1}"
                    )
            stacks = [_stack_packed([v[e] for e in range(E)]) for v in vals]
            layers[pname] = {k: torch.stack([s[k] for s in stacks])
                             for k in ("packed", "scale")}
        elif hasattr(vals[0], "packed"):  # TernaryTensor
            layers[pname] = _stack_packed(vals)
        else:
            layers[pname] = np.stack(vals)

    # MLA absorbed factors serve as dense leaves ({"dense": (L, H, ...)})
    for nm in ("w_uk", "w_uv"):
        if nm in layers:
            layers[nm] = {"dense": layers[nm].astype(np.float32)}

    params: dict[str, Any] = {**top, "layers": layers}

    from vlut_tpu_torch.convert.vision import convert_towers

    extra_meta = {"source": str(hf_dir), "ternarized_tensors": n_approx}
    extra_meta.update(convert_towers(vision_raw, qwen_vis_raw, raw0,
                                     out_dir))
    _save(out_dir, cfg, params, hf_dir, extra_meta)
    return cfg


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a HF ternary checkpoint to the packed format")
    ap.add_argument("hf_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--fmt", choices=("i2", "i1"), default="i2")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = convert_hf(args.hf_dir, args.out_dir, fmt=args.fmt,
                     device=args.device)
    print(f"converted: {cfg}")


if __name__ == "__main__":
    main()
