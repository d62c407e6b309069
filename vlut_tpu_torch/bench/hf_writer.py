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
(``bitnet`` with sub-norms), a mixtral (with experts) or a mamba one.
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


def write_hf(out_dir: str | pathlib.Path, cfg, tree: dict[str, Any],
             layout: str = "float32",
             tokenizer_src: str | pathlib.Path | None = None,
             shard_bytes: int = 2 << 30) -> pathlib.Path:
    """Write ``tree`` (a port tree in the checkpoint's layout: stacked
    layers, per-tensor scales; on any device) of ``cfg`` (a
    :class:`ModelConfig` or a Mamba config) as an HF directory: config.json,
    safetensors shards of at most ``shard_bytes`` and the tokenizer files
    of ``tokenizer_src``."""
    if layout not in ("float32", "hf1bitllm"):
        raise ValueError(f"unknown layout {layout!r}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    o = _Out()
    with torch.no_grad():
        conf = (_transformer(o, cfg, tree, layout)
                if isinstance(cfg, ModelConfig) else
                _mamba(o, cfg, tree, layout))
    o.write(out, shard_bytes)
    (out / "config.json").write_text(json.dumps(conf, indent=1))
    if tokenizer_src is not None:
        src = pathlib.Path(tokenizer_src)
        for f in _TOKENIZER_FILES:
            if (src / f).exists():
                shutil.copy(src / f, out / f)
    return out
