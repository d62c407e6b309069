"""Write a Hugging Face directory from a port tree, for the converter to read
back (``convert/convert.py``): the tests' and the card check's one writer.

Layouts of :func:`write_hf`:

* ``float32``: each projection as ``trits * scale`` (HF (out, in) float32),
  so the converter's exact-ternary test gives each per-tensor scale back
  bit for bit;
* ``hf1bitllm``: HF1BitLLM/Llama3-8B-1.58-100B-tokens' layout, each
  projection as uint8 holding four 2-bit fields (trit + 1) along the output
  axis (field i of byte row r is output row i * out/4 + r, the inverse of
  the converter's ``_maybe_unpack_2bit``) beside a bf16 ``weight_scale`` =
  1 / scale.

Float tensors keep their dtype (bf16 as BF16).  The config is a llama
(``bitnet`` with sub-norms), a mixtral (with experts) or a mamba one, or
one of the float families the family converters read back (``float32``
layout only, each tensor under the HF name its converter maps to the
tree's leaf, (in, out) matrices transposed back to (out, in)): T5,
gemma3n (Gemma3nForCausalLM's flat text config), bert, RWKV7 and the lfm2
and jamba hybrids.
"""

from __future__ import annotations

import json
import pathlib
import shutil
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.convert.checkpoint import write_safetensors
from vlut_tpu_torch.models.dims import (chunk_positions, head_positions,
                                        make_plan)
from vlut_tpu_torch.models.transformer import layer_specs, unpack_weight
from vlut_tpu_torch.ops.packing import TernaryTensor, unpack_ternary

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "special_tokens_map.json", "tokenizer.model")
_PROJ = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
         "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
         "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
         "w_down": "mlp.down_proj"}
_EXPERT = {"w_gate": "w1", "w_down": "w2", "w_up": "w3"}


def _host(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """(numpy array, whether it holds bf16 bits as uint16)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


class _Out:
    """Tensors by HF name, written as shards of at most ``shard_bytes``."""

    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}
        self.bf16: set[str] = set()

    def tensor(self, name: str, t: torch.Tensor) -> None:
        self.arrays[name], is_bf16 = _host(t)
        if is_bf16:
            self.bf16.add(name)

    def proj(self, name: str, trits: torch.Tensor, scale: torch.Tensor,
             layout: str) -> None:
        """One projection from its logical (K, N) trits and () scale."""
        w = trits.T  # HF (out, in)
        if layout == "float32":
            self.arrays[name + ".weight"] = (w.to(torch.float32) * scale.to(
                w.device, torch.float32)).cpu().numpy()
            return
        n = w.shape[0]
        if n % 4:
            raise ValueError(f"{name}: {n} output rows do not split in 4")
        f = (w + 1).to(torch.uint8).reshape(4, n // 4, -1)
        self.arrays[name + ".weight"] = (
            f[0] | (f[1] << 2) | (f[2] << 4) | (f[3] << 6)).cpu().numpy()
        inv = torch.ones((1,), dtype=torch.float32) / scale.cpu().reshape(1)
        self.tensor(name + ".weight_scale", inv.to(torch.bfloat16))

    def write(self, out: pathlib.Path, shard_bytes: int) -> None:
        shards: list[list[str]] = [[]]
        size = 0
        for name in sorted(self.arrays):
            nb = self.arrays[name].nbytes
            if shards[-1] and size + nb > shard_bytes:
                shards.append([])
                size = 0
            shards[-1].append(name)
            size += nb
        n = len(shards)
        files = (["model.safetensors"] if n == 1 else
                 [f"model-{i + 1:05d}-of-{n:05d}.safetensors"
                  for i in range(n)])
        for fname, names in zip(files, shards):
            write_safetensors(out / fname,
                              {k: self.arrays[k] for k in names},
                              frozenset(self.bf16 & set(names)))
        if n > 1:
            index = {"metadata": {"total_size": sum(
                a.nbytes for a in self.arrays.values())},
                "weight_map": {k: f for f, names in zip(files, shards)
                               for k in names}}
            (out / "model.safetensors.index.json").write_text(
                json.dumps(index, indent=1))


def _scale(leaf: dict, i: tuple) -> torch.Tensor:
    s = leaf["scale"][i]
    if s.numel() != 1:
        raise ValueError("only per-tensor scales have an HF layout")
    return s.reshape(())


def _transformer(o: _Out, cfg: ModelConfig, tree: dict, layout: str) -> dict:
    layers = tree["layers"]
    if not isinstance(layers, dict):
        raise ValueError("write the stacked (L, ...) tree")
    plan = make_plan(cfg)
    specs = layer_specs(cfg, 0, moe=True if cfg.n_experts else None)
    o.tensor("model.embed_tokens.weight", tree["embed"])
    if "lm_head" in tree:
        o.tensor("lm_head.weight", tree["lm_head"][:, :cfg.vocab_size].T)
    o.tensor("model.norm.weight", tree["final_norm"])
    hd, hd_p = plan.hd, plan.hd_p
    sub_attn = torch.as_tensor(chunk_positions(
        cfg.n_heads * hd_p, plan.wo_chunk, plan.wo_chunk_p).reshape(
            cfg.n_heads, hd_p)[:, head_positions(hd, hd_p)].reshape(-1))
    sub_ffn = torch.as_tensor(chunk_positions(cfg.d_ff, plan.ff_chunk,
                                              plan.ff_chunk_p))
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        o.tensor(pre + "input_layernorm.weight", layers["attn_norm"][i])
        o.tensor(pre + "post_attention_layernorm.weight",
                 layers["ffn_norm"][i])
        if cfg.use_subnorms:
            o.tensor(pre + "self_attn.inner_attn_ln.weight",
                    layers["attn_sub_norm"][i][sub_attn.to(
                        layers["attn_sub_norm"].device)])
            o.tensor(pre + "mlp.ffn_layernorm.weight",
                    layers["ffn_sub_norm"][i][sub_ffn.to(
                        layers["ffn_sub_norm"].device)])
        if cfg.n_experts:
            o.tensor(pre + "block_sparse_moe.gate.weight",
                    layers["router"][i].T)
        for pname, hf in _PROJ.items():
            leaf, spec = layers[pname], specs[pname]
            experts = range(cfg.n_experts) if (
                cfg.n_experts and pname in _EXPERT) else (None,)
            for e in experts:
                at = (i,) if e is None else (i, e)
                t = TernaryTensor(leaf["packed"][at], _scale(leaf, at),
                                  spec.k, spec.n, spec.fmt, spec.kb)
                name = (pre + hf if e is None else
                        f"{pre}block_sparse_moe.experts.{e}.{_EXPERT[pname]}")
                o.proj(name, unpack_weight(pname, t, cfg, plan, host=False),
                       t.scale, layout)
    conf = {
        "architectures": (["BitnetForCausalLM"] if cfg.arch == "bitnet"
                          else ["MixtralForCausalLM"] if cfg.n_experts
                          else ["LlamaForCausalLM"]),
        "model_type": ("bitnet" if cfg.arch == "bitnet" else "mixtral"
                       if cfg.n_experts else "llama"),
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff, "rms_norm_eps": cfg.rms_eps,
        "rope_theta": cfg.rope_theta, "rope_scaling": cfg.rope_scaling,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
    }
    if cfg.head_dim:
        conf["head_dim"] = cfg.head_dim
    if cfg.n_experts:
        conf.update(num_local_experts=cfg.n_experts,
                    num_experts_per_tok=cfg.n_experts_used)
    if layout == "hf1bitllm":
        conf.update(torch_dtype="bfloat16",
                    quantization_config={"quant_method": "bitnet"})
    return conf


def _mamba(o: _Out, cfg, tree: dict, layout: str) -> dict:
    if layout != "float32":
        raise ValueError("a mamba tree has only the float32 layout")
    layers = tree["layers"]
    o.tensor("backbone.embeddings.weight", tree["embed"])
    o.tensor("backbone.norm_f.weight", tree["final_norm"])
    if "lm_head" in tree:
        o.tensor("lm_head.weight", tree["lm_head"].T)
    widths = {"in_proj": (cfg.d_model, 2 * cfg.d_inner),
              "out_proj": (cfg.d_inner, cfg.d_model)}
    for i in range(cfg.n_layers):
        pre = f"backbone.layers.{i}."
        for pname in ("in_proj", "out_proj"):
            leaf = layers[pname]
            k, n = widths[pname]
            t = TernaryTensor(leaf["packed"][i], _scale(leaf, (i,)), k, n,
                              "i2", 128)
            o.proj(f"{pre}mixer.{pname}", unpack_ternary(t), t.scale, layout)
        o.tensor(pre + "norm.weight", layers["norm"][i])
        o.tensor(pre + "mixer.conv1d.weight",
                 layers["conv_w"][i].T[:, None, :])
        o.tensor(pre + "mixer.conv1d.bias", layers["conv_b"][i])
        o.tensor(pre + "mixer.x_proj.weight", layers["x_proj"][i].T)
        o.tensor(pre + "mixer.dt_proj.weight", layers["dt_proj_w"][i].T)
        o.tensor(pre + "mixer.dt_proj.bias", layers["dt_proj_b"][i])
        o.tensor(pre + "mixer.A_log", layers["A_log"][i])
        o.tensor(pre + "mixer.D", layers["D"][i])
    return {"architectures": ["MambaForCausalLM"], "model_type": "mamba",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
            "num_hidden_layers": cfg.n_layers, "state_size": cfg.d_state,
            "conv_kernel": cfg.d_conv, "expand": cfg.expand,
            "time_step_rank": cfg.dt_rank or "auto",
            "layer_norm_epsilon": cfg.rms_eps,
            "tie_word_embeddings": cfg.tie_embeddings,
            "max_position_embeddings": cfg.max_seq_len}


def _t5(o: _Out, cfg, tree: dict) -> dict:
    o.tensor("shared.weight", tree["embed"])
    if "lm_head" in tree:
        o.tensor("lm_head.weight", tree["lm_head"].T)
    o.tensor("encoder.final_layer_norm.weight", tree["enc_final_norm"])
    o.tensor("decoder.final_layer_norm.weight", tree["dec_final_norm"])
    attn = {"wq": "q", "wk": "k", "wv": "v", "wo": "o"}
    ffn = {"wi0": "wi_0", "wi1": "wi_1", "wi": "wi", "wo_ffn": "wo"}
    for side, n_l in (("encoder", cfg.n_layers), ("decoder", cfg.n_dec_layers)):
        layers = tree["enc_layers" if side == "encoder" else "dec_layers"]
        o.tensor(f"{side}.block.0.layer.0.SelfAttention."
                 "relative_attention_bias.weight",
                 tree["enc_rel_bias" if side == "encoder"
                      else "dec_rel_bias"])
        ffn_i = 2 if side == "decoder" else 1
        for i in range(n_l):
            pre = f"{side}.block.{i}.layer."
            for nm, hf in attn.items():
                o.tensor(f"{pre}0.SelfAttention.{hf}.weight", layers[nm][i].T)
            o.tensor(f"{pre}0.layer_norm.weight", layers["attn_norm"][i])
            if side == "decoder":
                for nm, hf in attn.items():
                    o.tensor(f"{pre}1.EncDecAttention.{hf}.weight",
                             layers["cross_" + nm][i].T)
                o.tensor(f"{pre}1.layer_norm.weight", layers["cross_norm"][i])
            for nm, hf in ffn.items():
                if nm in layers:
                    o.tensor(f"{pre}{ffn_i}.DenseReluDense.{hf}.weight",
                             layers[nm][i].T)
            o.tensor(f"{pre}{ffn_i}.layer_norm.weight", layers["ffn_norm"][i])
    return {"architectures": ["T5ForConditionalGeneration"],
            "model_type": "t5", "vocab_size": cfg.vocab_size,
            "d_model": cfg.d_model, "d_kv": cfg.d_kv, "d_ff": cfg.d_ff,
            "num_layers": cfg.n_layers,
            "num_decoder_layers": cfg.n_dec_layers,
            "num_heads": cfg.n_heads,
            "relative_attention_num_buckets": cfg.rel_buckets,
            "relative_attention_max_distance": cfg.rel_max_distance,
            "layer_norm_epsilon": cfg.ln_eps,
            "feed_forward_proj": ("gated-" if cfg.gated else "") + cfg.act,
            "tie_word_embeddings": cfg.tie_embeddings,
            "decoder_start_token_id": cfg.decoder_start_token_id,
            "eos_token_id": cfg.eos_id}


# gemma3n: the tree's leaf -> (the HF name past "model.", transposed)
_GEMMA3N_TOP = {"embed": ("embed_tokens.weight", False),
                "embed_per_layer": ("embed_tokens_per_layer.weight", False),
                "per_layer_model_proj": ("per_layer_model_projection.weight",
                                         True),
                "per_layer_proj_norm": ("per_layer_projection_norm.weight",
                                        False),
                "final_norm": ("norm.weight", False)}


def _gemma3n(o: _Out, cfg, tree: dict) -> dict:
    from vlut_tpu_torch.convert.gemma3n import _LAYER

    for nm, (hf, tr) in _GEMMA3N_TOP.items():
        o.tensor("model." + hf, tree[nm].T if tr else tree[nm])
    if "lm_head" in tree:
        o.tensor("lm_head.weight", tree["lm_head"].T)
    for i in range(cfg.n_altup - 1):
        o.tensor(f"model.altup_projections.{i}.weight",
                 tree["altup_proj"][i].T)
        o.tensor(f"model.altup_unembed_projections.{i}.weight",
                 tree["altup_unembed_proj"][i].T)
    for i, lp in enumerate(tree["layers"]):
        for hf, (nm, tr) in _LAYER.items():
            if nm in lp:
                o.tensor(f"model.layers.{i}.{hf}", lp[nm].T if tr else lp[nm])
    return {"architectures": ["Gemma3nForCausalLM"],
            "model_type": "gemma3n_text", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "intermediate_size": list(cfg.d_ff),
            "layer_types": list(cfg.layer_types),
            "sliding_window": cfg.sliding_window,
            "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
            "rope_local_base_freq": cfg.rope_theta_local,
            "altup_num_inputs": cfg.n_altup,
            "altup_active_idx": cfg.altup_active,
            "altup_correct_scale": cfg.altup_correct_scale,
            "laurel_rank": cfg.laurel_rank,
            "hidden_size_per_layer_input": cfg.pl_dim,
            "vocab_size_per_layer_input": cfg.pl_vocab,
            "num_kv_shared_layers": cfg.n_kv_shared,
            "activation_sparsity_pattern": list(cfg.sparsity),
            "final_logit_softcapping": cfg.logit_softcap,
            "max_position_embeddings": cfg.max_seq_len}


def _bert(o: _Out, cfg, tree: dict, out: pathlib.Path) -> dict:
    from vlut_tpu_torch.convert.encoder import _BERT_LAYER

    if cfg.arch != "bert" or cfg.pooling not in ("mean", "cls"):
        raise ValueError("the encoder writer takes bert with mean or cls "
                         "pooling")
    for nm, hf in (("embed", "word_embeddings"),
                   ("pos_embed", "position_embeddings"),
                   ("type_embed", "token_type_embeddings"),
                   ("embed_norm", "LayerNorm"), ("embed_norm_b", "LayerNorm")):
        leaf = "bias" if nm.endswith("_b") else "weight"
        o.tensor(f"embeddings.{hf}.{leaf}", tree[nm])
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        for hf, (nm, tr) in _BERT_LAYER.items():
            o.tensor(f"encoder.layer.{i}.{hf}",
                     layers[nm][i].T if tr else layers[nm][i])
    if cfg.pooling == "cls":
        (out / "1_Pooling").mkdir(exist_ok=True)
        (out / "1_Pooling" / "config.json").write_text(json.dumps(
            {"pooling_mode_cls_token": True}))
    return {"architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "intermediate_size": cfg.d_ff,
            "max_position_embeddings": cfg.max_seq_len,
            "layer_norm_eps": cfg.ln_eps,
            "type_vocab_size": cfg.type_vocab_size}


# rwkv7: the tree's leaf -> its HF name past "model.layers.{i}." (the
# (in, out) matrices transposed, the (D,) vectors as (1, 1, D))
_RWKV7_MATS = {"wr": "attention.receptance.weight",
               "wk": "attention.key.weight", "wv": "attention.value.weight",
               "wo": "attention.output.weight",
               "cm_key": "feed_forward.key.weight",
               "cm_value": "feed_forward.value.weight"}
_RWKV7_VECS = {"ln1_w": "ln1.weight", "ln1_b": "ln1.bias",
               "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
               "ln_x_w": "attention.ln_x.weight",
               "ln_x_b": "attention.ln_x.bias"}


def _rwkv7(o: _Out, cfg, tree: dict) -> dict:
    if cfg.arch != "rwkv7":
        raise ValueError("the rwkv writer takes rwkv7")
    d = cfg.d_model
    o.tensor("model.embeddings.weight", tree["embed"])
    o.tensor("model.layers.0.pre_norm.weight", tree["pre_ln_w"])
    o.tensor("model.layers.0.pre_norm.bias", tree["pre_ln_b"])
    o.tensor("model.ln_out.weight", tree["final_norm"])
    o.tensor("model.ln_out.bias", tree["final_norm_b"])
    if "lm_head" in tree:
        o.tensor("head.weight", tree["lm_head"].T)
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        for nm, hf in _RWKV7_MATS.items():
            o.tensor(pre + hf, layers[nm][i].T)
        for nm, hf in _RWKV7_VECS.items():
            o.tensor(pre + hf, layers[nm][i])
        for nm in layers:
            v = layers[nm][i]
            if nm.startswith("lerp_"):
                o.tensor(f"{pre}attention.x_{nm[5:]}", v.reshape(1, 1, d))
            elif nm in ("k_k", "k_a", "cm_lerp_k"):
                hf = "feed_forward.x_k" if nm == "cm_lerp_k" else (
                    "attention." + nm)
                o.tensor(pre + hf, v.reshape(1, 1, d))
            elif nm == "r_k":
                o.tensor(pre + "attention.r_k", v.reshape(-1, cfg.head_size))
            elif nm[0] in "wavg" and nm[1:] in ("0", "1", "2"):
                # the LoRA pairs: 1 (D, rank), 2 (rank, D), 0 the bias
                o.tensor(f"{pre}attention.{nm}",
                         v.reshape(1, 1, d) if nm[1] == "0" else v)
    return {"architectures": ["Rwkv7ForCausalLM"], "model_type": "rwkv7",
            "vocab_size": cfg.vocab_size, "hidden_size": d,
            "num_hidden_layers": cfg.n_layers, "head_size": cfg.head_size,
            "intermediate_size": cfg.d_ff,
            "layer_norm_epsilon": cfg.ln_eps, "wkv_has_gate": cfg.has_gate,
            "tie_word_embeddings": cfg.tie_embeddings}


def _period(flags: list[bool]) -> tuple[int, int]:
    """(period, offset) with ``flags[i] == (i % period == offset)``."""
    on = [i for i, f in enumerate(flags) if f]
    period = on[1] - on[0] if len(on) > 1 else len(flags)
    offset = on[0] % period if on else period
    if [i % period == offset for i in range(len(flags))] != list(flags):
        raise ValueError(f"layer pattern {flags} is not periodic")
    return period, offset


def _hybrid(o: _Out, cfg, tree: dict) -> dict:
    if cfg.arch not in ("lfm2", "jamba"):
        raise ValueError("the hybrid writer takes lfm2 or jamba")
    jamba = cfg.arch == "jamba"
    o.tensor("model.embed_tokens.weight", tree["embed"])
    o.tensor("model.final_layernorm.weight" if jamba
             else "model.embedding_norm.weight", tree["final_norm"])
    if "lm_head" in tree:
        o.tensor("lm_head.weight", tree["lm_head"].T)
    mats = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj",
            "wo": "self_attn.o_proj" if jamba else "self_attn.out_proj",
            "w_gate": "feed_forward.gate_proj" if jamba
            else "feed_forward.w1",
            "w_up": "feed_forward.up_proj" if jamba else "feed_forward.w3",
            "w_down": "feed_forward.down_proj" if jamba
            else "feed_forward.w2",
            "router": "feed_forward.router",
            "in_proj": "mamba.in_proj" if jamba else "conv.in_proj",
            "out_proj": "mamba.out_proj" if jamba else "conv.out_proj",
            "x_proj": "mamba.x_proj", "dt_proj_w": "mamba.dt_proj"}
    vecs = {"attn_norm": "input_layernorm.weight" if jamba
            else "operator_norm.weight",
            "ffn_norm": "pre_ff_layernorm.weight" if jamba
            else "ffn_norm.weight",
            "q_norm": "self_attn.q_layernorm.weight",
            "k_norm": "self_attn.k_layernorm.weight",
            "conv_b": "mamba.conv1d.bias" if jamba else "conv.conv.bias",
            "dt_proj_b": "mamba.dt_proj.bias", "A_log": "mamba.A_log",
            "D": "mamba.D", "dt_norm": "mamba.dt_layernorm.weight",
            "b_norm": "mamba.b_layernorm.weight",
            "c_norm": "mamba.c_layernorm.weight"}
    experts = {"e_gate": "gate_proj", "e_up": "up_proj",
               "e_down": "down_proj"}
    for i, lp in enumerate(tree["layers"]):
        pre = f"model.layers.{i}."
        for nm, v in lp.items():
            if nm in mats:
                o.tensor(f"{pre}{mats[nm]}.weight", v.T)
            elif nm in vecs:
                o.tensor(pre + vecs[nm], v)
            elif nm == "conv_w":
                o.tensor(pre + ("mamba.conv1d.weight" if jamba
                                else "conv.conv.weight"), v.T[:, None, :])
            elif nm in experts:
                for e in range(v.shape[0]):
                    o.tensor(f"{pre}feed_forward.experts.{e}."
                             f"{experts[nm]}.weight", v[e].T)
            else:
                raise ValueError(f"no HF name for layer tensor {nm}")
    conf = {"model_type": cfg.arch, "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff,
            "tie_word_embeddings": cfg.tie_embeddings,
            "max_position_embeddings": cfg.max_seq_len}
    if not jamba:
        return {**conf, "architectures": ["Lfm2ForCausalLM"],
                "layer_types": ["full_attention" if t == "attention"
                                else "conv" for t in cfg.layer_types],
                "norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
                "conv_L_cache": cfg.conv_l}
    ap, ao = _period([t == "attention" for t in cfg.layer_types])
    ep, eo = _period([f == "moe" for f in cfg.ffn_types])
    return {**conf, "architectures": ["JambaForCausalLM"],
            "attn_layer_period": ap, "attn_layer_offset": ao,
            "expert_layer_period": ep, "expert_layer_offset": eo,
            "num_experts": cfg.n_experts or 1,
            "num_experts_per_tok": cfg.n_experts_used,
            "rms_norm_eps": cfg.rms_eps,
            "mamba_expand": cfg.m1_d_inner // cfg.d_model,
            "mamba_dt_rank": cfg.m1_dt_rank,
            "mamba_d_state": cfg.m1_state, "mamba_d_conv": cfg.m1_conv}


def _family(o: _Out, cfg, tree: dict, out: pathlib.Path) -> dict:
    """The config.json of a float family's tree, its tensors put in ``o``."""
    from vlut_tpu_torch.models import encoder, gemma3n, hybrid, rwkv, t5

    if isinstance(cfg, t5.T5Config):
        return _t5(o, cfg, tree)
    if isinstance(cfg, gemma3n.Gemma3nConfig):
        return _gemma3n(o, cfg, tree)
    if isinstance(cfg, encoder.EncoderConfig):
        return _bert(o, cfg, tree, out)
    if isinstance(cfg, rwkv.Rwkv7Config):
        return _rwkv7(o, cfg, tree)
    if isinstance(cfg, hybrid.HybridConfig):
        return _hybrid(o, cfg, tree)
    raise TypeError(f"no HF layout for {type(cfg).__name__}")


def write_hf(out_dir: str | pathlib.Path, cfg, tree: dict[str, Any],
             layout: str = "float32",
             tokenizer_src: str | pathlib.Path | None = None,
             shard_bytes: int = 2 << 30) -> pathlib.Path:
    """Write ``tree`` (a port tree in the checkpoint's layout: stacked
    layers, per-tensor scales; on any device) of ``cfg`` (a
    :class:`ModelConfig`, a Mamba config, or a T5 / gemma3n / bert / RWKV7
    / lfm2 / jamba one) as an HF directory: config.json, safetensors shards
    of at most ``shard_bytes`` and the tokenizer files of
    ``tokenizer_src``."""
    from vlut_tpu_torch.models.ssm import MambaConfig

    if layout not in ("float32", "hf1bitllm"):
        raise ValueError(f"unknown layout {layout!r}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    o = _Out()
    with torch.no_grad():
        if isinstance(cfg, ModelConfig):
            conf = _transformer(o, cfg, tree, layout)
        elif isinstance(cfg, MambaConfig):
            conf = _mamba(o, cfg, tree, layout)
        elif layout != "float32":
            raise ValueError("a float family has only the float32 layout")
        else:
            conf = _family(o, cfg, tree, out)
    o.write(out, shard_bytes)
    (out / "config.json").write_text(json.dumps(conf, indent=1))
    if tokenizer_src is not None:
        src = pathlib.Path(tokenizer_src)
        for f in _TOKENIZER_FILES:
            if (src / f).exists():
                shutil.copy(src / f, out / f)
    return out
