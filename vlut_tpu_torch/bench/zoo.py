"""The transformer zoo on the card: each knob, MoE and per-layer family
as a small random-weight model, held against the same model's plain
versions on the CPU, and the zoo presets served at full width.

Families (:data:`FAMILIES`) are configs at d 256, heads of 128 (2 query
heads over 1 KV head), 2 layers and a 512-token vocabulary, each with the
knobs of one group of the HF families the CPU tests hold against the JAX
package (``tests/test_torch_archs*.py``).  Their weights come from the
port's ``init_params`` (numpy draws on the host) with every float vector
moved off its init value, plus the tensors a knob needs that
``init_params`` does not lay out (sinks, the attention gate, learned
positions, the embedding norm, xIELU's alphas, per-head LayerNorm q/k
gains); the same tree is then served on the card and on the CPU.

    python -m vlut_tpu_torch.bench.zoo [--family NAME ...] [--device cpu]
        [--set KEY=VALUE ...] [--trace]

prints one JSON line per family (:func:`card_vs_cpu`; with ``--trace``,
the first intermediates that part from the CPU, :func:`trace`).
:data:`MOE_FAMILIES` adds experts of d_ff 256 (router kinds, shared,
chunk and residual experts, dense lead layers) and per-layer heads and
FFN widths (deci's layer kinds among them) on the same base; their trees
come from ``init_params`` too (one per layer where the shapes differ).
:data:`MLA_FAMILIES` adds deepseek's latent attention (V2's and V3's
routing, minicpm3's narrow v head, plm's MLP) and M-RoPE (chunked and
interleaved, over synthetic position rows, :func:`mrope_rows`).
The presets' serving runs are ``python -m vlut_tpu_torch.bench.engine
--model qwen3_4b`` (or ``gemma2_2b``, or ``mixtral_8x7b``: Mixtral-8x7B's
widths, the MoE model of ``chip_smoke.py`` phase 20, or
``deepseek_v2_lite``: DeepSeek-V2-Lite's, the MLA model of phase 21).
:data:`FALCON_7B` is tiiuae/falcon-7b's published ``config.json``, typed
here; :func:`hf_model` turns it into a config by the port's
``config_from_hf`` and random packed weights (phase 19's multi-query
cell: 71 query heads over one KV head).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.ops import decode_attention as dattn
from vlut_tpu_torch.ops import matmul as mm
from vlut_tpu_torch.ops import norm as nrm

# huggingface.co/tiiuae/falcon-7b config.json: hidden 4544, 32 layers, 71
# heads of 64 over one KV head (multi_query), parallel attention and MLP,
# no biases, rope, vocabulary 65024 (the MLP 4 x 4544 and the exact gelu
# are the converter's falcon defaults, as HF's FalconConfig has them)
FALCON_7B = {
    "alibi": False, "apply_residual_connection_post_layernorm": False,
    "architectures": ["FalconForCausalLM"], "attention_dropout": 0.0,
    "bias": False, "bos_token_id": 11, "eos_token_id": 11,
    "hidden_dropout": 0.0, "hidden_size": 4544, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "model_type": "falcon",
    "multi_query": True, "new_decoder_architecture": False,
    "num_attention_heads": 71, "num_hidden_layers": 32,
    "parallel_attn": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 65024,
}

BASE = ModelConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                   n_kv_heads=1, d_ff=512, head_dim=128, max_seq_len=256)
LN = dict(norm_type="ln")
FAMILIES: dict[str, dict[str, Any]] = {
    "qwen3": dict(qk_norm=True, rms_eps=1e-6),
    "qwen2": dict(qkv_bias=True),
    "gemma2": dict(act_fn="gelu", embed_scale=16.0, post_norms=True,
                   norm_plus_one=True, attn_logit_softcap=50.0,
                   final_logit_softcap=30.0, sliding_window=16,
                   sliding_window_pattern=2, attn_scale=128 ** -0.5,
                   tie_embeddings=True),
    "gemma3": dict(qk_norm=True, post_norms=True, norm_plus_one=True,
                   sliding_window=16, sliding_window_pattern=2,
                   rope_theta=1e6, rope_theta_local=1e4, act_fn="gelu"),
    "granite": dict(embed_scale=12.0, attn_scale=1 / 128, logit_scale=1 / 16,
                    tie_embeddings=True),
    "gptneox": dict(**LN, parallel_residual=True, rope_pct=0.25,
                    ffn_gated=False, act_fn="gelu_exact", proj_bias=True),
    "phi2": dict(**LN, parallel_residual=True, rope_pct=0.5,
                 ffn_gated=False, act_fn="gelu", proj_bias=True,
                 qkv_bias=True),
    "bloom": dict(**LN, pos_embed="alibi", embed_norm=True, proj_bias=True,
                  ffn_gated=False, act_fn="gelu"),
    "gpt2": dict(**LN, pos_embed="learned", ffn_gated=False, act_fn="gelu",
                 proj_bias=True, tie_embeddings=True),
    "olmo2": dict(pre_norms=False, post_norms=True, qk_norm=True,
                  qk_norm_scope="whole", qkv_clamp=2.0),
    "nemotron": dict(**LN, norm_plus_one=True, ffn_gated=False,
                     act_fn="relu2", rope_pct=0.5, rope_interleaved=True),
    "cohere2": dict(**LN, parallel_residual=True, rope_interleaved=True,
                    sliding_window=16, swa_layers=(True, False),
                    nope_layers=(False, True), logit_scale=0.25,
                    qk_norm=True, qk_norm_type="ln", qk_norm_post_rope=True),
    "apertus": dict(ffn_gated=False, act_fn="xielu", qk_norm=True,
                    qk_norm_post_rope=True),
    "gpt_oss": dict(attn_sinks=True, swiglu_limit=0.5, attn_gate="sigmoid"),
    "llama4": dict(qk_norm=True, qk_norm_type="l2", qk_norm_post_rope=True,
                   attn_temp_scale=0.5, attn_temp_floor=8,
                   nope_layers=(False, True), sliding_window=16,
                   swa_type="chunked", sliding_window_pattern=2),
    "nopos_relu2": dict(pos_embed="none", ffn_gated=False, act_fn="relu2"),
}
# the MoE and heterogeneous families: experts of d_ff 256 (4 of top 2
# unless named), each family one group of the MoE / per-layer HF families
# the CPU tests hold against the JAX package (tests/test_torch_moe*.py,
# test_torch_hetero*.py)
MOE = dict(n_experts=4, n_experts_used=2, d_ff=256)
MOE_FAMILIES: dict[str, dict[str, Any]] = {
    # mixtral / qwen3-moe / olmoe: softmax top-k renormalized
    "moe_mixtral": dict(MOE),
    # deepseek V3 / dots1 / glm4-moe: sigmoid scores, a selection bias,
    # grouped top-k, routed scale, a shared expert, a dense lead layer
    "moe_grouped": dict(MOE, n_experts=8, moe_score="sigmoid",
                        n_expert_groups=4, topk_groups=2, routed_scale=2.5,
                        n_shared_experts=1, first_k_dense=1, d_ff_dense=768),
    # qwen2-moe: gated shared expert at its own width, no top-k renorm, a
    # dense layer at d_ff_dense (dense_layers)
    "moe_shared": dict(MOE, moe_norm_topk=False, n_shared_experts=1,
                       d_ff_shared=384, dense_layers=(False, True),
                       d_ff_dense=512),
    # llama4: sigmoid top-1 scaling the experts' input, a shared expert
    "moe_llama4": dict(MOE, n_experts_used=1, moe_score="sigmoid",
                       moe_weight_before=True, n_shared_experts=1),
    # gpt-oss: per-expert biases, a router logits bias, the clamped swiglu
    "moe_gpt_oss": dict(MOE, moe_expert_bias=True, swiglu_limit=0.5),
    # smallthinker: the router reads the raw layer input
    "moe_router_input": dict(MOE, moe_router_input="layer_input"),
    # grovemoe: 2 chunk experts over the routed output
    "moe_grove": dict(MOE, moe_chunk_experts=2, d_ff_chunk=128,
                      moe_chunk_scale=0.5),
    # arctic: the routed branch from its own norm of the layer input beside
    # a residual MLP
    "moe_arctic": dict(MOE, moe_parallel="arctic", d_ff_dense=384),
    # openelm: per-layer query / KV heads and FFN widths
    "hetero_heads": dict(n_heads=4, n_kv_heads=2,
                         heads_per_layer=((2, 1), (4, 2)),
                         d_ff_per_layer=(384, 640)),
    # deci: attention, linear "attention", neither, and an FFN-free layer
    "hetero_deci": dict(n_layers=4, heads_per_layer=((2, 1), (2, 0), (0, 0),
                                                     (2, 1)),
                        d_ff_per_layer=(512, 512, 384, 0)),
}
# MLA and M-RoPE families on the same base: MLA's heads are its own (2
# query heads of nope 128 + rope 64 over a latent of 256, v heads of 128
# unless named), each family one group of the HF families the CPU tests
# hold against the JAX package (tests/test_torch_archs_mla*.py)
MLA = dict(n_kv_heads=2, kv_lora_rank=256, qk_nope_dim=128, qk_rope_dim=64,
           attn_scale=192 ** -0.5)
MLA_FAMILIES: dict[str, dict[str, Any]] = {
    # deepseek V2 (V2-Lite's kinds): no q-LoRA, softmax top-k without
    # renormalisation, 2 shared experts, a dense lead layer, yarn
    "mla_deepseek_v2": dict(MLA, **MOE) | dict(
                            moe_norm_topk=False, n_shared_experts=2,
                            first_k_dense=1, d_ff_dense=512,
                            rope_scaling={"type": "yarn", "factor": 40,
                                          "original_max_position_embeddings":
                                          64, "beta_fast": 32,
                                          "beta_slow": 1}),
    # deepseek V3: q-LoRA, sigmoid grouped routing with a selection bias,
    # routed scale, a shared expert, a dense lead layer
    "mla_deepseek_v3": dict(MLA, **MOE) | dict(q_lora_rank=256, n_experts=8,
                            moe_score="sigmoid", n_expert_groups=4,
                            topk_groups=2, routed_scale=2.5,
                            n_shared_experts=1, first_k_dense=1,
                            d_ff_dense=512),
    # minicpm3: q-LoRA, a v head of 64 (lane-padded into wo's rows)
    "mla_minicpm3": dict(MLA, q_lora_rank=128, kv_lora_rank=128,
                         qk_nope_dim=64, qk_rope_dim=64, head_dim=64,
                         attn_scale=128 ** -0.5),
    # plm: no q-LoRA, an ungated relu^2 MLP
    "mla_plm": dict(MLA, ffn_gated=False, act_fn="relu2"),
    # qwen2-vl: chunked M-RoPE sections (synthetic position rows)
    "mrope_qwen2vl": dict(rope_scaling={"rope_type": "mrope",
                                        "mrope_section": [16, 24, 24]}),
    # qwen3-vl: interleaved M-RoPE, per-head q/k norms
    "mrope_qwen3vl": dict(qk_norm=True, rms_eps=1e-6, rope_scaling={
        "rope_type": "mrope", "mrope_section": [24, 20, 20],
        "mrope_interleaved": True}),
}
ALL_FAMILIES = {**FAMILIES, **MOE_FAMILIES, **MLA_FAMILIES}
TOL = 2e-2  # of the largest value, as the CPU tests hold the JAX package


def family_config(name: str, overrides: dict | None = None) -> ModelConfig:
    return dataclasses.replace(BASE, **{**ALL_FAMILIES[name],
                                        **(overrides or {})})


def family_tree(cfg: ModelConfig, seed: int = 0) -> dict:
    """The tree of ``init_params`` (stacked, or one per layer for a
    heterogeneous stack) with every float vector moved by 0.1 * normals and
    the knobs' extra tensors, on the host.  A MoE layer also gets a
    selection bias under sigmoid scores, a router logits bias beside expert
    biases and a shared-expert gate beside an explicit shared width."""
    rng = np.random.default_rng(seed + 1)
    plan = make_plan(cfg)
    tree = tt.init_params(cfg, seed=seed).tree()
    l = cfg.n_layers

    def move(v):
        return v + torch.from_numpy(
            0.1 * rng.standard_normal(tuple(v.shape))).to(v.dtype)

    def moe_extras(lp, lead=()):
        if "router" not in lp:
            return
        e = cfg.n_experts
        if cfg.moe_score == "sigmoid":
            lp["router_bias"] = torch.from_numpy(
                0.5 * rng.standard_normal(lead + (e,))).float()
        if cfg.moe_expert_bias:
            lp["router_b"] = torch.from_numpy(
                0.1 * rng.standard_normal(lead + (e,))).float()
        if cfg.d_ff_shared:
            lp["shared_gate"] = torch.from_numpy(
                0.1 * rng.standard_normal(lead + (cfg.d_model,))).float()

    if isinstance(tree["layers"], list):
        layers = []
        for lp in tree["layers"]:
            lp = {k: v if isinstance(v, dict) else move(v)
                  for k, v in lp.items()}
            moe_extras(lp)
            layers.append(lp)
        tree["layers"] = layers
        tree["final_norm"] = move(tree["final_norm"])
        return tree
    layers = dict(tree["layers"])
    for k, v in list(layers.items()):
        if not isinstance(v, dict):
            layers[k] = move(v)
    moe_extras(layers, (l,))
    tree["final_norm"] = move(tree["final_norm"])

    def head_vec(*lead):  # heads of 128 are unpadded: no pad to keep zero
        return torch.from_numpy(
            rng.standard_normal(lead + (plan.hd_p,)) * 0.2).float()

    if cfg.qk_norm and cfg.qk_norm_type == "ln":
        for n, heads in (("q_norm", cfg.n_heads), ("k_norm", cfg.n_kv_heads)):
            layers[n] = 1.0 + head_vec(l, heads)
            layers[n + "_b"] = head_vec(l, heads)
    elif cfg.qk_norm and cfg.qk_norm_scope == "whole":
        for n, heads in (("q_norm", cfg.n_heads), ("k_norm", cfg.n_kv_heads)):
            layers[n] = (1.0 + head_vec(l, heads)).reshape(l, -1)
    if cfg.attn_sinks:
        layers["sinks"] = torch.from_numpy(
            rng.standard_normal((l, cfg.n_heads))).float()
    if cfg.attn_gate:
        packed, scales = [], []
        for _ in range(l):
            t = tt.pack_weight("w_attn_gate", rng.integers(
                -1, 2, (cfg.d_model, cfg.q_dim), dtype=np.int8),
                np.float32(0.05), cfg, plan)
            packed.append(t.packed)
            scales.append(t.scale)
        layers["w_attn_gate"] = {"packed": torch.stack(packed),
                                 "scale": torch.stack(scales)}
    if cfg.act_fn == "xielu":
        layers["xielu_ap"] = torch.from_numpy(
            0.8 + 0.3 * rng.standard_normal((l, 1))).float()
        layers["xielu_an"] = torch.from_numpy(
            0.8 + 0.3 * rng.standard_normal((l, 1))).float()
    if cfg.parallel_residual and cfg.qkv_bias:
        # phi-2's single-norm parallel residual: no FFN norm, a head bias
        del layers["ffn_norm"], layers["ffn_norm_b"]
        tree["lm_head_b"] = torch.from_numpy(
            rng.standard_normal(plan.vocab_p) * 0.1).float()
    if cfg.pos_embed == "learned":
        tree["pos_embed"] = torch.from_numpy(rng.standard_normal(
            (cfg.max_seq_len, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.embed_norm:
        tree["embed_norm"] = 1.0 + torch.from_numpy(
            rng.standard_normal(cfg.d_model) * 0.1).float()
        tree["embed_norm_b"] = torch.from_numpy(
            rng.standard_normal(cfg.d_model) * 0.1).float()
    tree["layers"] = layers
    return tree


def hf_config(raw: dict) -> ModelConfig:
    """The port's ``config_from_hf`` of an HF ``config.json`` given as a
    dict (written to a scratch directory under the checkout's build/)."""
    import pathlib
    import tempfile

    from vlut_tpu_torch.convert.convert import config_from_hf
    from vlut_tpu_torch.ops._build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        (pathlib.Path(d) / "config.json").write_text(json.dumps(raw))
        return config_from_hf(pathlib.Path(d))


def hf_model(raw: dict, device, seed: int = 0):
    """(cfg, serving model) of an HF ``config.json`` given as a dict:
    :func:`hf_config`, random packed weights from ``seed`` made on
    ``device`` (int8 head unless tied), fused where the gates let,
    unrolled."""
    cfg = hf_config(raw)
    model = tt.init_params_fast(cfg, seed=seed, device=device)
    model = tt.unstack_layers(tt.fuse_projections(tt.quantize_head(model),
                                                  cfg), cfg)
    return cfg, model


def serving_model(cfg: ModelConfig, tree: dict, device) -> tt.TransformerLM:
    """The serving tree (fused where the gates let, unrolled) on ``device``."""
    model = tt.TransformerLM(cfg, tt._tree_to(tree, device))
    return tt.unstack_layers(tt.fuse_projections(model, cfg), cfg)


def expected_kernels(cfg: ModelConfig, model: tt.TransformerLM,
                     decode_attn: str = "fused") -> tuple[str, ...]:
    """The kernel wrappers a prefill of more than 64 rows plus decode steps
    must launch on the card, by the JAX package's gates, layer by layer:
    the tiled GEMM (#3) for the prefill, the fused decode projection (#1)
    for every projection a gate fuses, the fused-quant GEMM (#4) for every
    other one (every expert's gate, up and down among them), and the
    decode attention (#7) on each layer whose own heads its gate takes,
    else the KV row writer (#5)."""
    std = cfg.norm_type == "rms"
    found = {"ternary_gemm_tiled"}
    for i, lp in enumerate(model.layers):
        if not lp.has_ffn:
            continue  # deci's FFN-free layer skips the block
        fused_qkv = lp.fused and std and cfg.pre_norms
        fused_wo = lp.has_attn and not (cfg.post_norms
                                        or cfg.parallel_residual
                                        or cfg.proj_bias)
        fused_ffn = (not cfg.n_experts and "w_gateup" in lp.proj
                     and cfg.act_fn == "silu" and std and cfg.pre_norms
                     and not (cfg.post_norms or cfg.swiglu_limit
                              or cfg.parallel_residual or cfg.proj_bias))
        if fused_qkv or fused_wo or fused_ffn:
            found.add("ternary_gemm_decode")
        if (not fused_ffn or cfg.attn_gate or "w_lin_attn" in lp.proj
                or (lp.has_attn and not (fused_qkv and fused_wo))):
            found.add("ternary_gemm_fused_quant")
        if not lp.has_attn:
            continue
        cl = tt.layer_config(cfg, i)
        hd_p = make_plan(cl).hd_p  # K and V heads padded alike
        attn = (decode_attn == "fused" and not lp.mla
                and cfg.pos_embed != "alibi"
                and not cfg.attn_sinks and not cfg.attn_logit_softcap
                and cfg.swa_type != "chunked"
                and dattn.supports(cl.n_heads, cl.n_kv_heads, hd_p, hd_p)
                and dattn.fused_pays(cl.n_heads, cl.n_kv_heads, hd_p, hd_p))
        found.add("decode_attention" if attn else "write_rows_pair")
    order = ("ternary_gemm_tiled", "ternary_gemm_decode",
             "ternary_gemm_fused_quant", "decode_attention",
             "write_rows_pair")
    return tuple(k for k in order if k in found)


def mrope_rows(cfg: ModelConfig, b: int, t: int) -> torch.Tensor | None:
    """Synthetic (b, 3, t) M-RoPE position rows for an M-RoPE config (a
    run of text, then a 4 x 4 grid of image positions, then text again),
    else None."""
    if "mrope_section" not in (cfg.rope_scaling or {}):
        return None
    pos = np.tile(np.arange(t), (3, 1))
    grid = np.arange(16)
    lo = min(8, t)
    img = slice(lo, min(lo + 16, t))
    n = img.stop - img.start
    pos[0, img] = lo
    pos[1, img] = lo + grid[:n] // 4
    pos[2, img] = lo + grid[:n] % 4
    pos[:, img.stop:] = np.arange(t - img.stop) + lo + 4
    return torch.from_numpy(np.broadcast_to(pos, (b, 3, t)).copy())


@torch.inference_mode()
def logits_run(model: tt.TransformerLM, cfg: ModelConfig,
               tokens: torch.Tensor, n_decode: int,
               feed: list[torch.Tensor] | None = None,
               decode_attn: str = "fused") -> list[torch.Tensor]:
    """float32 logits (on the host) of a prefill of ``tokens`` (B, T) and
    ``n_decode`` cached decode steps; step i feeds ``feed[i]`` (B,) where
    given, else the greedy token.  An M-RoPE config's prefill takes the
    synthetic position rows of :func:`mrope_rows`."""
    dev = model.device
    b, t = tokens.shape
    cache = tt.init_kv_cache(cfg, b, max_len=t + n_decode + 8, device=dev)
    pos = torch.arange(t, device=dev)[None].repeat(b, 1)
    rows = mrope_rows(cfg, b, t)
    lg, _ = tt.forward(model, cfg, tokens.to(dev), pos, cache,
                       logits_at=torch.full((b,), t - 1, device=dev),
                       mrope_pos=None if rows is None else rows.to(dev))
    out = [lg[:, 0, :cfg.vocab_size].float().cpu()]
    for i in range(n_decode):
        nxt = feed[i] if feed is not None else out[-1].argmax(-1)
        lg, _ = tt.forward(model, cfg, nxt.to(dev)[:, None],
                           torch.full((b, 1), t + i, device=dev), cache,
                           decode_attn=decode_attn)
        out.append(lg[:, 0, :cfg.vocab_size].float().cpu())
    return out


@contextlib.contextmanager
def layers_replaced(seen: list, by: list | None = None):
    """Within: each layer step appends its output (float32, on the host) to
    ``seen`` and, with ``by``, hands on ``by[i]`` (the CPU's output of the
    same step, in call order) in its place: each layer on the card then
    starts from the CPU's input, and no rounding difference carries from one
    layer into the next."""
    step = tt._layer_step

    def hooked(*args, **kw):
        y = step(*args, **kw)
        seen.append(y.float().cpu())
        return y if by is None else by[len(seen) - 1].to(y.device, y.dtype)

    tt._layer_step = hooked
    try:
        yield
    finally:
        tt._layer_step = step


def _pair(name, device, prompt, batch, seed, overrides, source=None):
    """The family's config (or ``source``'s), its serving model on the CPU
    and on ``device`` from one tree, and a (batch, prompt) token prompt."""
    if source is None:
        cfg = family_config(name, overrides)
        tree = family_tree(cfg, seed)
    else:
        cfg, tree = source
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (batch, prompt)))
    return (cfg, serving_model(cfg, tree, "cpu"),
            serving_model(cfg, tree, resolve_device(device)), tokens)


# the intermediates :func:`trace` records, by owner and attribute
TRACED = ((nrm, "rms"), (nrm, "rms_whole"), (nrm, "layer_norm"),
          (nrm, "l2_norm"), (tt, "_qk_norm"), (tt, "rope_prefix"),
          (tt, "_attention"), (mm, "quantize_activations"),
          (tt.TernaryLinear, "forward"))


@contextlib.contextmanager
def _recorded(seen: list):
    """Within: each output tensor of the :data:`TRACED` functions is
    appended to ``seen`` as (label, tensor on the host), in call order."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in TRACED]

    def wrap(label, f):
        def g(*args, **kw):
            out = f(*args, **kw)
            for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
                if torch.is_tensor(o):
                    seen.append((f"{label}[{i}]", o.detach().cpu()))
            return out
        return g

    for owner, attr, f in saved:
        setattr(owner, attr, wrap(attr, f))
    try:
        yield
    finally:
        for owner, attr, f in saved:
            setattr(owner, attr, f)


def trace(name: str, device, n_decode: int = 1, limit: int = 8,
          prompt: int = 40, batch: int = 2, seed: int = 0,
          overrides: dict | None = None) -> list[dict]:
    """Where the family on ``device`` first parts from the CPU: the first
    ``limit`` recorded intermediates (:data:`TRACED`, in call order over a
    prefill and ``n_decode`` steps fed the CPU's greedy tokens) that are not
    bit-equal, each with its largest difference and how many elements (or
    int8 codes) differ."""
    cfg, cpu, card, tokens = _pair(name, device, prompt, batch, seed,
                                   overrides)
    want, got = [], []
    with _recorded(want):
        lg = logits_run(cpu, cfg, tokens, n_decode)
    with _recorded(got):
        logits_run(card, cfg, tokens, n_decode,
                   feed=[w.argmax(-1) for w in lg[:-1]])
    out = []
    for i, ((label, w), (_, g)) in enumerate(zip(want, got)):
        d = (g.float() - w.float()).abs()
        if float(d.max()) > 0:
            out.append({"at": i, "op": label, "shape": list(w.shape),
                        "dtype": str(w.dtype), "max_abs_diff": float(d.max()),
                        "max_abs": float(w.float().abs().max()),
                        "n_diff": int((d > 0).sum()), "n": w.numel()})
            if len(out) == limit:
                break
    return out


def _rel_errs(got: list, want: list) -> list[float]:
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


def card_vs_cpu(name: str, device, counters=None, n_decode: int = 8,
                prompt: int = 40, batch: int = 2, seed: int = 0,
                overrides: dict | None = None, source=None) -> dict:
    """One family on ``device`` and on the CPU from the same tree: the
    prefill (``batch`` x ``prompt`` tokens, M 80: #3 on the card) and
    ``n_decode`` decode steps fed the CPU's greedy tokens.  Each layer step
    on ``device`` takes the CPU's input (:func:`layers_replaced`); its
    output and the logits must come within :data:`TOL` of the CPU's largest
    value, and the greedy tokens must be the CPU's.  Then the graphed decode
    of the same prompt (``cli.run_batched``, greedy) against the eager one
    on ``device``: identical tokens.  ``counters`` (reset, read) brackets
    the graphed run, the family's main path.

    The layers are compared one at a time because these tiny random models
    amplify a last-ulp difference: one float32 ulp of the composed
    attention (CUDA's and the CPU's sums round apart) that moves one int8
    activation code carries through the bf16 roundings of the next layers
    to about 1e-2 of the largest logit.  ``free_rel_logit_err`` reports
    that amplification: the logits of the same steps with the card's layers
    left to run on their own outputs (not held to a tolerance);
    ``overrides`` changes fields of the family's config; ``source`` (cfg,
    host tree) runs that model under the label ``name`` instead."""
    from vlut_tpu_torch.cli import run_batched

    cfg, cpu, card, tokens = _pair(name, device, prompt, batch, seed,
                                   overrides, source)
    t0 = time.perf_counter()
    want_layers, got_layers = [], []
    with layers_replaced(want_layers):
        want = logits_run(cpu, cfg, tokens, n_decode)
    feed = [w.argmax(-1) for w in want[:-1]]
    with layers_replaced(got_layers, by=want_layers):
        got = logits_run(card, cfg, tokens, n_decode, feed=feed)
    free = logits_run(card, cfg, tokens, n_decode, feed=feed)
    errs = _rel_errs(got, want)
    layer_errs = _rel_errs(got_layers, want_layers)
    greedy = all(torch.equal(g.argmax(-1), w.argmax(-1))
                 for g, w in zip(got, want))
    ids = tokens[0].tolist()
    if counters is not None:
        counters[0]()
    graphed = run_batched(card, cfg, ids, batch, n_decode, temp=0.0).cpu()
    launches = counters[1](f"zoo_{name}", expected_kernels(cfg, card)) if (
        counters is not None) else None
    eager = run_batched(card, cfg, ids, batch, n_decode, temp=0.0,
                        cuda_graph=False).cpu()
    return {"family": name, "max_rel_logit_err": max(errs),
            "rel_logit_err_per_step": errs,
            "max_rel_layer_err": max(layer_errs),
            "rel_layer_err_per_step": layer_errs,
            "greedy_equal": greedy,
            "free_rel_logit_err": max(_rel_errs(free, want)),
            "within_tol": max(errs + layer_errs) <= TOL,
            "graph_equals_eager": torch.equal(graphed, eager),
            "tokens": graphed[0].tolist(), "launches": launches,
            "expected_kernels": list(expected_kernels(cfg, card)),
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.zoo")
    ap.add_argument("--family", action="append",
                    choices=list(ALL_FAMILIES))
    ap.add_argument("--device", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a field of each family's config")
    ap.add_argument("--trace", action="store_true",
                    help="print where each family first parts from the CPU")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value
    bad = []
    for name in args.family or list(ALL_FAMILIES):
        if args.trace:
            print(json.dumps({"family": name, "overrides": overrides,
                              "first_differences": trace(
                                  name, args.device, overrides=overrides)}),
                  flush=True)
            continue
        out = card_vs_cpu(name, args.device, overrides=overrides)
        print(json.dumps({"overrides": overrides, **out}), flush=True)
        if not (out["within_tol"] and out["greedy_equal"]
                and out["graph_equals_eager"]):
            bad.append(name)
    if bad:
        raise SystemExit("families out of tolerance, off the CPU's greedy "
                         f"tokens or graph != eager: {bad}")


if __name__ == "__main__":
    main()
