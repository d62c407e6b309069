"""HF hybrid SSM+attention checkpoints -> the hybrid checkpoint (own copy
of the JAX package's ``vlut_tpu/convert/hybrid.py``).

Covers JambaForCausalLM, FalconH1ForCausalLM, GraniteMoeHybridForCausalLM
(reference: src/models/{jamba,falcon-h1,granite-hybrid}.cpp graph
builders).  Falcon-H1's muP multipliers are all linear-side and are folded
into the weights here (attention_in/key/attention_out, ssm_in/mup-vector/
ssm_out, mlp gate/down, lm_head), so the forward graph carries no
multiplier ops; granite's residual_multiplier folds into each branch's
final projection the same way (as the main converter does for dense
granite), while attention_multiplier (a score scale) and logits_scaling
stay config fields.  Every float operation (the folds, the +1 gain
offsets, plamo2's -exp(A_log)) runs on the host in numpy float32 in the
JAX converter's order, so the checkpoint is array for array its own.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
from typing import Any

import numpy as np

from vlut_tpu_torch.convert.convert import _iter_hf_tensors, _save
from vlut_tpu_torch.models.hybrid import HybridConfig

log = logging.getLogger("vlut_tpu_torch.convert.hybrid")


def _iter_tensors(hf_dir: pathlib.Path):
    for name, w in _iter_hf_tensors(hf_dir):
        yield name, np.asarray(w, np.float32)


def _config(raw: dict[str, Any]) -> tuple[HybridConfig, dict[str, Any]]:
    mt = raw["model_type"]
    nl = raw["num_hidden_layers"]
    hidden = raw["hidden_size"]
    aux: dict[str, Any] = {}
    if mt == "jamba":
        ap, ao = raw.get("attn_layer_period", 8), raw.get(
            "attn_layer_offset", 4)
        ep, eo = raw.get("expert_layer_period", 2), raw.get(
            "expert_layer_offset", 1)
        n_exp = raw.get("num_experts", 16)
        lt = tuple(
            "attention" if i % ap == ao else "mamba" for i in range(nl)
        )
        ft = tuple(
            "moe" if (n_exp > 1 and i % ep == eo) else "dense"
            for i in range(nl)
        )
        expand = raw.get("mamba_expand", 2)
        dtr = raw.get("mamba_dt_rank")
        if dtr in (None, "auto"):
            dtr = -(-hidden // 16)
        cfg = HybridConfig(
            arch="jamba", vocab_size=raw["vocab_size"], d_model=hidden,
            n_layers=nl, n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            d_ff=raw["intermediate_size"], layer_types=lt, ffn_types=ft,
            rms_eps=raw.get("rms_norm_eps", 1e-6),
            rope=False,  # jamba is NoPE
            m1_d_inner=expand * hidden,
            m1_state=raw.get("mamba_d_state", 16),
            m1_conv=raw.get("mamba_d_conv", 4),
            m1_dt_rank=dtr,
            n_experts=n_exp if any(f == "moe" for f in ft) else 0,
            n_experts_used=raw.get("num_experts_per_tok", 2),
            moe_renorm=False,  # JambaSparseMoeBlock never renormalizes
            tie_embeddings=raw.get("tie_word_embeddings", False),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
    elif mt == "falcon_h1":
        d_ssm = raw.get("mamba_d_ssm") or (
            raw.get("mamba_expand", 2) * hidden
        )
        m2h = raw.get("mamba_n_heads", 128)
        cfg = HybridConfig(
            arch="falcon_h1", vocab_size=raw["vocab_size"], d_model=hidden,
            n_layers=nl, n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            head_dim=raw.get("head_dim") or None,
            d_ff=raw["intermediate_size"],
            layer_types=("parallel",) * nl,
            ffn_types=("dense",) * nl,
            rms_eps=raw.get("rms_norm_eps", 1e-5),
            rope=True, rope_theta=raw.get("rope_theta", 100000.0),
            m2_heads=m2h,
            m2_head_dim=raw.get("mamba_d_head") or d_ssm // m2h,
            m2_groups=raw.get("mamba_n_groups", 1),
            m2_state=raw.get("mamba_d_state", 256),
            m2_conv=raw.get("mamba_d_conv", 4),
            m2_norm_mode=(
                ("norm_first" if raw.get("mamba_norm_before_gate", True)
                 else "gated")
                if raw.get("mamba_rms_norm", False) else "gate_only"
            ),
            embed_scale=raw.get("embedding_multiplier", 1.0),
            tie_embeddings=raw.get("tie_word_embeddings", False),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
        gss = cfg.m2_groups * cfg.m2_state
        mup = np.ones(d_ssm * 2 + 2 * gss + m2h, np.float32)
        zx = raw.get("ssm_multipliers", [1.0] * 5)
        mup[:d_ssm] *= zx[0]
        mup[d_ssm : 2 * d_ssm] *= zx[1]
        mup[2 * d_ssm : 2 * d_ssm + gss] *= zx[2]
        mup[2 * d_ssm + gss : 2 * d_ssm + 2 * gss] *= zx[3]
        mup[2 * d_ssm + 2 * gss :] *= zx[4]
        aux = {
            "mup": mup,
            "ssm_in": raw.get("ssm_in_multiplier", 1.0),
            "ssm_out": raw.get("ssm_out_multiplier", 1.0),
            "attn_in": raw.get("attention_in_multiplier", 1.0),
            "attn_out": raw.get("attention_out_multiplier", 1.0),
            "key": raw.get("key_multiplier", 1.0),
            "mlp": raw.get("mlp_multipliers", [1.0, 1.0]),
            "head": raw.get("lm_head_multiplier", 1.0),
        }
    elif mt == "granitemoehybrid":
        lt_raw = raw.get("layer_types") or raw.get(
            "layers_block_type", ["mamba"] * nl
        )
        lt = tuple(
            "attention" if t == "attention" else "mamba2" for t in lt_raw
        )
        n_exp = raw.get("num_local_experts", 0) or 0
        ft = (("shared_moe" if n_exp else "shared"),) * nl
        m2h = raw.get("mamba_n_heads", 128)
        cfg = HybridConfig(
            arch="granite_hybrid", vocab_size=raw["vocab_size"],
            d_model=hidden, n_layers=nl,
            n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            d_ff=raw["intermediate_size"], layer_types=lt, ffn_types=ft,
            rms_eps=raw.get("rms_norm_eps", 1e-5),
            rope=raw.get("position_embedding_type") == "rope",
            rope_theta=raw.get("rope_theta", 10000.0),
            attn_scale=raw.get("attention_multiplier", 0.0) or 0.0,
            m2_heads=m2h,
            m2_head_dim=raw.get("mamba_d_head")
            or (raw.get("mamba_expand", 2) * hidden) // m2h,
            m2_groups=raw.get("mamba_n_groups", 1),
            m2_state=raw.get("mamba_d_state", 128),
            m2_conv=raw.get("mamba_d_conv", 4),
            n_experts=n_exp,
            n_experts_used=raw.get("num_experts_per_tok", 2),
            moe_renorm=True,  # softmax over the top-k logits
            d_ff_shared=raw.get("shared_intermediate_size",
                                raw["intermediate_size"]),
            embed_scale=raw.get("embedding_multiplier", 1.0),
            logit_scale=1.0 / raw.get("logits_scaling", 1.0),
            tie_embeddings=raw.get("tie_word_embeddings", False),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
        aux = {"residual": raw.get("residual_multiplier", 1.0)}
    elif mt == "nemotron_h":
        # nemotron-h (reference src/models/nemotron-h.cpp): each layer is
        # ONE norm + one of {mamba2, NoPE attention, relu^2 ungated MLP}
        # + residual, chosen by hybrid_override_pattern (M / * / -)
        # MoE variant (reference LLM_ARCH_NEMOTRON_H_MOE, nemotron-h.cpp
        # build_ffn_layer:109-145 + convert NemotronHModel:8728-8790):
        # "E" pattern slots carry a sigmoid-routed, selection-biased,
        # renormalized+scaled ungated-relu^2 MoE with a parallel ungated
        # relu^2 shared expert — the dense "-" body otherwise
        is_moe = "num_experts_per_tok" in raw
        pat = raw.get("hybrid_override_pattern", "M" * nl)
        kind = {"M": "mamba2", "*": "attention", "-": "ffn", "E": "ffn"}
        lt = tuple(kind[c] for c in pat)
        m2h = raw.get("mamba_num_heads", 128)
        cfg = HybridConfig(
            arch="nemotron_h_moe" if is_moe else "nemotron_h",
            vocab_size=raw["vocab_size"],
            d_model=hidden, n_layers=nl,
            n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            head_dim=raw.get("attention_head_dim")
            or raw.get("head_dim") or None,
            d_ff=(raw.get("moe_intermediate_size")
                  if is_moe else raw["intermediate_size"])
            or raw.get("intermediate_size"),
            layer_types=lt, ffn_types=("none",) * nl,
            rms_eps=raw.get("rms_norm_eps", 1e-5),
            rope=False,  # nemotron-h attention is NoPE
            m2_heads=m2h,
            m2_head_dim=raw.get("mamba_head_dim", 64),
            m2_groups=raw.get("n_groups", 8),
            m2_state=raw.get("ssm_state_size", 128),
            m2_conv=raw.get("conv_kernel", 4),
            ffn_act="relu2", ffn_gated=False,
            n_experts=raw.get("n_routed_experts", 0) if is_moe else 0,
            n_experts_used=raw.get("num_experts_per_tok", 0)
            if is_moe else 0,
            moe_score="sigmoid",
            moe_renorm=bool(raw.get("norm_topk_prob", True)),
            routed_scale=float(raw.get("routed_scaling_factor", 1.0)),
            d_ff_shared=raw.get(
                "moe_shared_expert_intermediate_size", 0) or 0,
            tie_embeddings=raw.get("tie_word_embeddings", False),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
    elif mt == "lfm2":
        lt = tuple(
            "attention" if t == "full_attention" else "conv"
            for t in raw.get("layer_types", ["conv"] * nl)
        )
        cfg = HybridConfig(
            arch="lfm2", vocab_size=raw["vocab_size"], d_model=hidden,
            n_layers=nl, n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            # ff width is auto-adjusted by HF (block_auto_adjust_ff_dim);
            # read the real width from w2's shape at tensor time
            d_ff=raw["intermediate_size"],
            layer_types=lt, ffn_types=("dense",) * nl,
            rms_eps=raw.get("norm_eps", 1e-5),
            rope=True, rope_theta=raw.get("rope_theta", 1000000.0),
            qk_norm=True,
            conv_l=raw.get("conv_L_cache", 3),
            tie_embeddings=raw.get("tie_word_embeddings", True),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
    elif mt == "lfm2_moe":
        # LFM2-MoE (reference LLM_ARCH_LFM2MOE, llama-model.cpp:2233-2246
        # + src/models/lfm2.cpp build_moe_feed_forward: SIGMOID gating with
        # a selection-only expert bias, renormalized top-k, silu experts;
        # convert LFM2MoeModel:9951-10010): the lfm2 shortconv/attention
        # body with MoE FFNs after num_dense_layers leading dense blocks
        lt = tuple(
            "attention" if t == "full_attention" else "conv"
            for t in raw.get("layer_types", ["conv"] * nl)
        )
        lead = raw.get("num_dense_layers", 0)
        cfg = HybridConfig(
            arch="lfm2moe", vocab_size=raw["vocab_size"], d_model=hidden,
            n_layers=nl, n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            d_ff=raw.get("moe_intermediate_size",
                         raw.get("intermediate_size")),
            layer_types=lt,
            ffn_types=tuple(
                "dense" if i < lead else "moe" for i in range(nl)
            ),
            rms_eps=raw.get("norm_eps", 1e-5),
            rope=True, rope_theta=raw.get("rope_theta", 1000000.0),
            qk_norm=True,
            conv_l=raw.get("conv_L_cache", 3),
            n_experts=raw.get("num_experts", 0) or 0,
            n_experts_used=raw.get("num_experts_per_tok", 4),
            moe_score="sigmoid", moe_renorm=True,
            tie_embeddings=raw.get("tie_word_embeddings", True),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
    elif mt == "qwen3_next":
        lt = tuple(
            "attention" if t == "full_attention" else "deltanet"
            for t in raw.get("layer_types", [])
        ) or tuple(
            "attention" if (i + 1) % 4 == 0 else "deltanet"
            for i in range(nl)
        )
        n_exp = raw.get("num_experts", 0) or 0
        ft = ("moe_qwen" if n_exp else "dense",) * nl
        cfg = HybridConfig(
            arch="qwen3next", vocab_size=raw["vocab_size"], d_model=hidden,
            n_layers=nl, n_heads=raw["num_attention_heads"],
            n_kv_heads=raw.get("num_key_value_heads",
                               raw["num_attention_heads"]),
            head_dim=raw.get("head_dim") or None,
            d_ff=(raw.get("moe_intermediate_size")
                  if n_exp else raw["intermediate_size"]),
            layer_types=lt, ffn_types=ft,
            rms_eps=raw.get("rms_norm_eps", 1e-6),
            rope=True, rope_theta=raw.get("rope_theta", 10000.0),
            rope_pct=raw.get("partial_rotary_factor", 0.25),
            qk_norm=True, attn_gate=True,
            dn_v_heads=raw.get("linear_num_value_heads", 32),
            dn_k_heads=raw.get("linear_num_key_heads", 16),
            dn_k_dim=raw.get("linear_key_head_dim", 128),
            dn_v_dim=raw.get("linear_value_head_dim", 128),
            dn_conv=raw.get("linear_conv_kernel_dim", 4),
            n_experts=n_exp,
            n_experts_used=raw.get("num_experts_per_tok", 2),
            moe_renorm=raw.get("norm_topk_prob", True),
            d_ff_shared=raw.get("shared_expert_intermediate_size", 0) or 0,
            tie_embeddings=raw.get("tie_word_embeddings", False),
            max_seq_len=raw.get("max_position_embeddings", 4096),
        )
    elif mt == "plamo2":
        # PLaMo-2 (reference src/models/plamo2.cpp + converter
        # Plamo2Model convert_hf_to_gguf.py:4885-4975): mamba2-style
        # scalar-A SSD mixers with dt/B/C RMS norms on layers where
        # i % mamba_step != mamba_step//2, GQA attention (fused qkv,
        # per-head q/k RMS norms, NEOX rope) elsewhere; EVERY layer has a
        # fused-swiglu FFN and sandwich (post_mixer/post_mlp) norms whose
        # +1 / +1/5 / +1/5^1.5 offsets are folded at convert
        step = raw.get("mamba_step", 2)
        enabled = raw.get("mamba_enabled", True)

        def _is_mamba(i: int) -> bool:
            if not enabled:
                return False
            if nl <= step // 2:
                return i != nl - 1
            return (i % step) != (step // 2)

        hd = raw.get("hidden_size_per_head", 128)
        cfg = HybridConfig(
            arch="plamo2", vocab_size=raw["vocab_size"], d_model=hidden,
            n_layers=nl,
            n_heads=raw.get("num_attention_heads", 32),
            n_kv_heads=raw.get("num_key_value_heads", 4),
            head_dim=hd,
            d_ff=raw["intermediate_size"],
            layer_types=tuple(
                "plamo2_mamba" if _is_mamba(i) else "attention"
                for i in range(nl)
            ),
            ffn_types=("dense",) * nl,
            rms_eps=raw.get("rms_norm_eps", 1e-6),
            rope=True, rope_theta=raw.get("rope_theta", 10000.0),
            qk_norm=True,
            m2_heads=raw.get("mamba_num_heads", 64),
            m2_head_dim=hd,
            m2_state=raw.get("mamba_d_state", 64),
            m2_conv=raw.get("mamba_d_conv", 4),
            m2_groups=0,
            tie_embeddings=raw.get("tie_word_embeddings", False),
            max_seq_len=raw.get("max_position_embeddings", 2048),
        )
    else:
        raise ValueError(f"not a hybrid checkpoint: {mt!r}")
    return cfg, aux


def convert_hybrid(
    hf_dir: str | pathlib.Path, out_dir: str | pathlib.Path
) -> HybridConfig:
    hf_dir = pathlib.Path(hf_dir)
    raw = json.loads((hf_dir / "config.json").read_text())
    if raw.get("model_type") in ("lfm2_vl", "lfm2-vl"):
        # LFM2-VL wraps the lfm2 hybrid as text_config /
        # model.language_model.*; its siglip2 tower is not ported
        # (ROADMAP Queue 1 item 8), so convert_hf refuses lfm2-vl
        raw = {**raw["text_config"],
               "model_type": raw["text_config"].get("model_type", "lfm2")}
    cfg, aux = _config(raw)
    mt = raw["model_type"]
    res_mult = aux.get("residual", 1.0)

    # qwen3next's Qwen3NextRMSNorm is zero-init (1 + w): fold the +1 into
    # the stored gains (the gated deltanet norm is a plain ones-init norm).
    # plamo2's final model.norm also takes +1 (Plamo2Model ".norm.weight");
    # its per-layer norm offsets are handled in the plamo2 branch below.
    plus_one = 1.0 if mt in ("qwen3_next", "plamo2") else 0.0

    top: dict[str, Any] = {}
    per: list[dict[str, Any]] = [{} for _ in range(cfg.n_layers)]
    experts: list[dict[str, dict[int, np.ndarray]]] = [
        {} for _ in range(cfg.n_layers)
    ]
    lre = re.compile(r"model\.layers\.(\d+)\.(.+)$")

    def canon(name: str) -> str:
        if mt == "plamo2":
            # PLaMo nests blocks one level deeper
            name = name.replace("model.layers.layers.", "model.layers.")
        if mt == "nemotron_h":
            # backbone.* naming; the block-type-specific "mixer" module
            # maps onto the per-kind names the loop below understands
            name = name.replace("backbone.embeddings.",
                                "model.embed_tokens.")
            name = name.replace("backbone.norm_f.", "model.norm.")
            name = name.replace("backbone.layers.", "model.layers.")
            # the BLOCK norm only — the mamba mixer's gated norm keeps its
            # name and is handled by the mixer rewrite below
            name = re.sub(r"^(model\.layers\.\d+)\.norm\.weight$",
                          r"\1.input_layernorm.weight", name)
            m0 = re.match(r"model\.layers\.(\d+)\.mixer\.(.+)$", name)
            if m0:
                li0, sub0 = int(m0.group(1)), m0.group(2)
                kind0 = cfg.layer_types[li0]
                if kind0 == "attention":
                    name = f"model.layers.{li0}.self_attn.{sub0}"
                elif kind0 == "ffn":
                    name = f"model.layers.{li0}.mlp.{sub0}"
                else:
                    name = f"model.layers.{li0}.mamba.{sub0}"
        return name

    for name, w in _iter_tensors(hf_dir):
        if name.startswith(("model.vision_tower.",
                            "model.multi_modal_projector.",
                            "vision_tower.", "multi_modal_projector.")):
            continue  # lfm2-vl's tower: not ported (ROADMAP item 8)
        name = name.replace("model.language_model.", "model.")
        name = canon(name)
        if name == "model.embed_tokens.weight":
            top["embed"] = w
            continue
        if name == "lm_head.weight":
            top["lm_head"] = w.T * aux.get("head", 1.0)
            continue
        if name in ("model.final_layernorm.weight", "model.norm.weight",
                    "model.embedding_norm.weight"):
            top["final_norm"] = w + plus_one
            continue
        m = lre.match(name)
        if not m:
            log.warning("skipping unrecognized tensor %s", name)
            continue
        li, sub = int(m.group(1)), m.group(2)
        lp = per[li]
        if mt == "plamo2":
            # reference Plamo2Model.modify_tensors: norm offsets folded
            # (+1 pre, +1/5 post-mixer, +1/5^1.5 post-mlp), A_log ->
            # -exp(A_log), fused qkv / gate_up split here (head counts
            # are known at convert)
            if sub == "pre_mixer_norm.weight":
                lp["attn_norm"] = w + 1.0
            elif sub == "post_mixer_norm.weight":
                lp["post_mixer_norm"] = w + 1.0 / 5
            elif sub == "pre_mlp_norm.weight":
                lp["ffn_norm"] = w + 1.0
            elif sub == "post_mlp_norm.weight":
                lp["post_ffn_norm"] = w + 1.0 / 5 ** 1.5
            elif sub == "mixer.qkv_proj.weight":
                hd = cfg.head_dim_
                qn = cfg.n_heads * hd
                kn = cfg.n_kv_heads * hd
                lp["wq"] = w[:qn].T
                lp["wk"] = w[qn : qn + kn].T
                lp["wv"] = w[qn + kn :].T
            elif sub == "mixer.o_proj.weight":
                lp["wo"] = w.T
            elif sub in ("mixer.q_weight", "mixer.q.weight"):
                lp["q_norm"] = w
            elif sub in ("mixer.k_weight", "mixer.k.weight"):
                lp["k_norm"] = w
            elif sub == "mlp.gate_up_proj.weight":
                ff = w.shape[0] // 2
                lp["w_gate"], lp["w_up"] = w[:ff].T, w[ff:].T
            elif sub == "mlp.down_proj.weight":
                lp["w_down"] = w.T
            elif sub == "mixer.in_proj.weight":
                lp["in_proj"] = w.T
            elif sub == "mixer.conv1d.weight":
                lp["conv_w"] = (w[:, 0, :] if w.ndim == 3 else w).T
            elif sub == "mixer.conv1d.bias":
                lp["conv_b"] = w
            elif sub == "mixer.bcdt_proj.weight":
                lp["bcdt_proj"] = w.T
            elif sub == "mixer.dt_proj.weight":
                lp["dt_proj_w"] = w.T
            elif sub in ("mixer.dt_bias", "mixer.dt_proj.bias"):
                lp["dt_proj_b"] = w
            elif sub == "mixer.dt_norm_weight":
                lp["dt_norm"] = w
            elif sub == "mixer.B_norm_weight":
                lp["b_norm"] = w
            elif sub == "mixer.C_norm_weight":
                lp["c_norm"] = w
            elif sub == "mixer.A_log":
                lp["A_log"] = -np.exp(np.asarray(w, np.float64)).astype(
                    np.float32)
            elif sub == "mixer.D":
                lp["D"] = w
            elif sub == "mixer.out_proj.weight":
                lp["out_proj"] = w.T
            else:
                log.warning("skipping unrecognized plamo2 tensor %s", name)
            continue
        # --- norms -------------------------------------------------------
        if sub in ("input_layernorm.weight", "operator_norm.weight"):
            lp["attn_norm"] = w + plus_one
            continue
        if sub in ("pre_ff_layernorm.weight",
                   "post_attention_layernorm.weight",
                   "ffn_norm.weight"):
            lp["ffn_norm"] = w + plus_one
            continue
        # --- lfm2 short conv ------------------------------------------------
        if sub == "conv.conv.weight":
            lp["conv_w"] = w[:, 0, :].T  # (D, 1, L) -> (L, D)
            continue
        if sub == "conv.conv.bias":
            lp["conv_b"] = w
            continue
        if sub == "conv.in_proj.weight":
            lp["in_proj"] = w.T
            continue
        if sub == "conv.out_proj.weight":
            lp["out_proj"] = w.T
            continue
        if sub in ("self_attn.q_layernorm.weight",
                   "self_attn.q_norm.weight"):
            lp["q_norm"] = w + plus_one
            continue
        if sub in ("self_attn.k_layernorm.weight",
                   "self_attn.k_norm.weight"):
            lp["k_norm"] = w + plus_one
            continue
        if sub == "self_attn.out_proj.weight":
            lp["wo"] = w.T
            continue
        # --- qwen3next gated delta net --------------------------------------
        if sub.startswith("linear_attn."):
            key = sub[len("linear_attn."):]
            if key == "in_proj_qkvz.weight":
                # permute grouped-per-k-head rows [q|k|v|z]_g -> flat
                # [q | k | v | z] so the graph splits contiguously
                dk, dv = cfg.dn_k_dim, cfg.dn_v_dim
                Hk, Hv = cfg.dn_k_heads, cfg.dn_v_heads
                rep = Hv // Hk
                blk = 2 * dk + 2 * rep * dv
                idx_q, idx_k, idx_v, idx_z = [], [], [], []
                for gi in range(Hk):
                    base = gi * blk
                    idx_q += list(range(base, base + dk))
                    idx_k += list(range(base + dk, base + 2 * dk))
                    idx_v += list(range(base + 2 * dk,
                                        base + 2 * dk + rep * dv))
                    idx_z += list(range(base + 2 * dk + rep * dv,
                                        base + blk))
                perm = np.asarray(idx_q + idx_k + idx_v + idx_z)
                lp["in_proj_qkvz"] = w[perm].T
            elif key == "in_proj_ba.weight":
                Hk, Hv = cfg.dn_k_heads, cfg.dn_v_heads
                rep = Hv // Hk
                idx_b, idx_a = [], []
                for gi in range(Hk):
                    base = gi * 2 * rep
                    idx_b += list(range(base, base + rep))
                    idx_a += list(range(base + rep, base + 2 * rep))
                perm = np.asarray(idx_b + idx_a)
                lp["in_proj_ba"] = w[perm].T
            elif key == "conv1d.weight":
                lp["conv_w"] = w[:, 0, :].T
            elif key == "conv1d.bias":
                lp["conv_b"] = w
            elif key == "norm.weight":
                lp["norm_w"] = w
            elif key in ("A_log", "dt_bias"):
                lp[key] = w
            elif key == "out_proj.weight":
                lp["out_proj"] = w.T
            else:
                log.warning("skipping deltanet tensor %s", name)
            continue
        if sub == "mlp.gate.weight":
            lp["router"] = w.T
            continue
        if sub == "mlp.shared_expert_gate.weight":
            lp["shared_gate"] = w.T  # (1, D) -> (D, 1)
            continue
        sm = re.match(
            r"mlp\.shared_expert\.(gate|up|down)_proj\.weight$", sub
        )
        if sm:
            lp["w_shared_" + sm.group(1)] = w.T
            continue
        # --- attention ----------------------------------------------------
        amap = {
            "self_attn.q_proj.weight": ("wq", aux.get("attn_in", 1.0)),
            "self_attn.k_proj.weight": (
                "wk", aux.get("attn_in", 1.0) * aux.get("key", 1.0)),
            "self_attn.v_proj.weight": ("wv", aux.get("attn_in", 1.0)),
            "self_attn.o_proj.weight": (
                "wo", aux.get("attn_out", 1.0) * res_mult),
        }
        if sub in amap:
            pname, mult = amap[sub]
            lp[pname] = w.T * mult
            continue
        # --- mamba mixer ---------------------------------------------------
        if sub.startswith("mamba."):
            key = sub[len("mamba."):]
            if key == "in_proj.weight":
                wi = w.T * aux.get("ssm_in", 1.0)
                if "mup" in aux:
                    wi = wi * aux["mup"][None, :]
                lp["in_proj"] = wi
            elif key == "out_proj.weight":
                lp["out_proj"] = w.T * aux.get("ssm_out", 1.0) * res_mult
            elif key == "conv1d.weight":
                lp["conv_w"] = w[:, 0, :].T  # (cd, 1, dc) -> (dc, cd)
            elif key == "conv1d.bias":
                lp["conv_b"] = w
            elif key == "norm.weight":
                lp["norm_w"] = w
            elif key == "dt_bias":
                lp["dt_bias"] = w
            elif key in ("A_log", "D"):
                lp[key] = w
            elif key == "x_proj.weight":
                lp["x_proj"] = w.T
            elif key == "dt_proj.weight":
                lp["dt_proj_w"] = w.T
            elif key == "dt_proj.bias":
                lp["dt_proj_b"] = w
            elif key == "dt_layernorm.weight":
                lp["dt_norm"] = w
            elif key == "b_layernorm.weight":
                lp["b_norm"] = w
            elif key == "c_layernorm.weight":
                lp["c_norm"] = w
            else:
                log.warning("skipping mamba tensor %s", name)
            continue
        # --- FFN -----------------------------------------------------------
        fmap = {
            "feed_forward.gate_proj.weight": (
                "w_gate", aux.get("mlp", [1.0, 1.0])[0]),
            "feed_forward.up_proj.weight": ("w_up", 1.0),
            "feed_forward.down_proj.weight": (
                "w_down", aux.get("mlp", [1.0, 1.0])[1] * res_mult),
            # lfm2 (w1/w3/w2) and qwen3next dense naming
            "feed_forward.w1.weight": ("w_gate", 1.0),
            "feed_forward.w3.weight": ("w_up", 1.0),
            "feed_forward.w2.weight": ("w_down", 1.0),
            "mlp.gate_proj.weight": ("w_gate", 1.0),
            "mlp.up_proj.weight": ("w_up", 1.0),
            "mlp.down_proj.weight": ("w_down", 1.0),
        }
        if sub in fmap:
            pname, mult = fmap[sub]
            lp[pname] = w.T * mult
            continue
        if sub in ("feed_forward.router.weight", "feed_forward.gate.weight"):
            lp["router"] = w.T
            continue
        if sub in ("feed_forward.expert_bias", "feed_forward.expert_bias.bias",
                   "mlp.gate.e_score_correction",
                   "mlp.gate.e_score_correction.bias",
                   "mlp.gate.e_score_correction_bias"):
            # selection-only bias (ffn_exp_probs_b): lfm2moe .expert_bias /
            # nemotron-h-moe mixer.gate.e_score_correction
            lp["e_bias"] = w.reshape(-1)
            continue
        if sub in ("mlp.shared_experts.up_proj.weight",
                   "mlp.shared_experts.down_proj.weight"):
            # nemotron-h-moe parallel ungated relu^2 shared expert
            lp["w_shared_up" if "up_proj" in sub else "w_shared_down"] = w.T
            continue
        if sub == "block_sparse_moe.router.layer.weight":
            lp["router"] = w.T
            continue
        em = re.match(
            r"(?:feed_forward|mlp)\.experts\.(\d+)\."
            r"(gate_proj|up_proj|down_proj|w1|w3|w2)\.weight$",
            sub,
        )
        if em:
            pn = {"gate_proj": "gate", "up_proj": "up", "down_proj": "down",
                  "w1": "gate", "w3": "up", "w2": "down"}[em.group(2)]
            experts[li].setdefault(
                "e_" + pn, {}
            )[int(em.group(1))] = w.T
            continue
        if sub == "shared_mlp.input_linear.weight":
            lp["w_shared_in"] = w.T
            continue
        if sub == "shared_mlp.output_linear.weight":
            lp["w_shared_out"] = w.T * res_mult
            continue
        if sub == "block_sparse_moe.input_linear.weight":
            # granite stacked experts (E, 2*ff, D) -> (E, D, 2*ff)
            lp["e_in"] = np.ascontiguousarray(w.transpose(0, 2, 1))
            continue
        if sub == "block_sparse_moe.output_linear.weight":
            lp["e_out"] = np.ascontiguousarray(
                w.transpose(0, 2, 1)
            ) * res_mult
            continue
        log.warning("skipping unrecognized layer tensor %s", name)

    for li, ex in enumerate(experts):
        for pname, by in ex.items():
            E = cfg.n_experts
            per[li][pname] = np.stack([by[e] for e in range(E)])

    params = {**top, "layers": tuple(per)}
    _save(out_dir, cfg, params, hf_dir, {"source": str(hf_dir)})
    return cfg
