"""Shared checks of the port's dense transformer zoo against the JAX package
(imported by ``tests/test_torch_archs*.py``).

A model is held on identical weights in both packages: the JAX package's
forward runs with ``impl="pallas_interpret"`` (its fused projections then
take the Pallas kernels' own arithmetic, which the port's kernels and
their plain versions follow), the port's on the CPU.  Prefill into a cache
and greedy cached decode are compared on the stacked tree and on the
fused, unrolled one: logits within 2e-2 of the largest logit (room for an
int8 activation code that rounds the other way after a last-ulp
difference of exp or tanh), greedy tokens identical.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vlut_tpu.models import transformer as jt
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

TOL = 2e-2
_JITTED: dict[int, Any] = {}


def jax_forward(params, cfg_j, tokens, positions, cache=None, **kw):
    """The JAX forward with ``impl="pallas_interpret"``, jitted per config
    by closure (a config with a rope_scaling dict does not hash)."""
    key = id(cfg_j)
    if key not in _JITTED:
        _JITTED[key] = (cfg_j, jax.jit(
            lambda p, t, pos, c: jt.forward(p, cfg_j, t, pos, c,
                                            impl="pallas_interpret")))
    return _JITTED[key][1](params, tokens, positions, cache)


def close(got: torch.Tensor, want, what: str = "") -> float:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())
    return err / float(np.abs(want).max())


def trees(cfg_j, params, cfg):
    """[(label, JAX params, port model)] for the stacked and the fused,
    unrolled tree of one JAX parameter tree."""
    fused = jt.unstack_layers(jt.fuse_projections(params, cfg_j), cfg_j)
    out = []
    for label, p in (("stacked", params), ("fused", fused)):
        p = jax.tree.map(jnp.asarray, p)
        out.append((label, p, params_from_numpy(
            jax.tree.map(np.asarray, p), cfg)))
    return out


def check_pair(cfg_j, params_j, cfg, model, tokens: np.ndarray,
               n_decode: int = 3, max_len: int = 32,
               decode_attn: str = "fused",
               jax_cached: bool = True, quantized: bool = False) -> np.ndarray:
    """Prefill ``tokens`` (B, T) into a cache, then ``n_decode`` greedy
    cached steps, in both packages; logits compared at every step.  With
    ``jax_cached`` False the JAX side runs without a cache, over the whole
    sequence so far at every step (its last row compared); ``quantized``
    takes the q8 cache in both.  Returns the prefill's logits (the JAX
    package's)."""
    b, t = tokens.shape
    v = cfg.vocab_size
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jc = (jt.init_kv_cache(cfg_j, b, max_len=max_len, quantized=quantized)
          if jax_cached else None)
    seq = tokens
    jl, jc = jax_forward(params_j, cfg_j, jnp.asarray(tokens, jnp.int32),
                         jnp.asarray(pos), jc)
    tc = tt.init_kv_cache(cfg, b, max_len=max_len, quantized=quantized)
    with torch.inference_mode():
        tl, tc = tt.forward(model, cfg, torch.from_numpy(tokens).long(),
                            torch.from_numpy(pos).long(), tc)
    close(tl, jl, "prefill")
    first = np.asarray(jl)
    cur = first[:, -1, :v].argmax(-1)
    np.testing.assert_array_equal(tl[:, -1, :v].argmax(-1).numpy(), cur)
    for step in range(n_decode):
        p = np.full((b, 1), t + step, np.int32)
        if jax_cached:
            jl, jc = jax_forward(params_j, cfg_j,
                                 jnp.asarray(cur[:, None], jnp.int32),
                                 jnp.asarray(p), jc)
        else:
            seq = np.concatenate([seq, cur[:, None].astype(np.int32)], 1)
            n = seq.shape[1]
            jl, _ = jax_forward(params_j, cfg_j, jnp.asarray(seq),
                                jnp.asarray(np.tile(np.arange(
                                    n, dtype=np.int32), (b, 1))), None)
            jl = jl[:, -1:]
        with torch.inference_mode():
            tl, tc = tt.forward(model, cfg,
                                torch.from_numpy(cur[:, None]).long(),
                                torch.from_numpy(p).long(), tc,
                                decode_attn=decode_attn)
        close(tl, jl, f"decode {step}")
        cur = np.asarray(jl)[:, 0, :v].argmax(-1)
        np.testing.assert_array_equal(tl[:, 0, :v].argmax(-1).numpy(), cur)
    return first


def per_tensor_scales(params):
    """The JAX tree with a tuple-layers checkpoint's per-tensor scales, which
    its ``save_checkpoint`` stores as (1,) (``np.ascontiguousarray`` of a
    0-d array), made 0-d again: the JAX package's Pallas GEMM wrapper takes
    a () or an (N,) scale, not a (1,) one.  A stacked tree is returned as
    it is."""
    if not isinstance(params["layers"], (list, tuple)):
        return params

    def fix(lp):
        return {k: ({**v, "scale": np.asarray(v["scale"]).reshape(())}
                    if isinstance(v, dict) and np.shape(v.get("scale")) == (1,)
                    else v) for k, v in lp.items()}

    return {**params, "layers": tuple(fix(lp) for lp in params["layers"])}


def hf_case(hf_model, tmp_path, t: int = 9, seed: int = 7, ternarize=None,
            jax_cached: bool = True):
    """A tiny HF model with exact-ternary projections (``ternarize``: the
    functions that make them so), converted once by the
    JAX package's ``convert_hf`` and loaded by each package's
    ``load_checkpoint``: the port held against the JAX forward on both
    trees (prefill + cached greedy decode), and both against the HF
    logits as a sanity check (the checkpoint keeps bf16 embeddings and
    the GEMMs quantize activations to int8, so only the greedy token of
    most rows and the logits' scale are held).  ``jax_cached`` False holds
    the port against the JAX forward without a cache (:func:`check_pair`).
    Returns the port's cfg."""
    from test_archs_hf import _ternarize_model as ternarize_a
    from test_archs_hf2 import _ternarize_model as ternarize_b

    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
    from vlut_tpu.convert.convert import convert_hf
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    hf_model = hf_model.float().eval()
    # the two JAX test modules' projection-name lists together cover
    # every dense family here; a MoE family may name its JAX test's own
    for tern in ternarize or (ternarize_a, ternarize_b):
        tern(hf_model)
    hf_model.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    convert_hf(tmp_path / "hf", tmp_path / "out", fmt="i2")
    cfg_j, params, meta = jax_load(tmp_path / "out")
    assert meta["ternarized_tensors"] == 0, "conversion must be lossless"
    params = per_tensor_scales(params)
    cfg, model, _ = load_checkpoint(tmp_path / "out", device="cpu")
    tt.check_supported(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    with torch.no_grad():
        want = hf_model(torch.from_numpy(tokens).long()).logits.numpy()
    for label, p, m in trees(cfg_j, params, cfg):
        got = check_pair(cfg_j, p, cfg, m, tokens, max_len=t + 8,
                         jax_cached=jax_cached)
        got = got[..., :want.shape[-1]]
        agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        scale = np.abs(want).max()
        assert agree >= 0.5 and np.abs(got - want).max() <= 0.5 * scale, (
            label, agree, np.abs(got - want).max(), scale)
    return cfg


# --- the dense HF families (configs of tests/test_archs_hf*.py and
# tests/test_archs_wave4.py) -------------------------------------------------

V, L = 96, 2


def _tf():
    import transformers

    return transformers


def _randomize(model, pick, scale, seed=None):
    """Add ``scale`` * normals to the parameters whose name ``pick`` takes
    (the JAX tests' perturbation of zero-initialised biases and alphas)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if pick(name):
                p.copy_(p + scale * torch.randn_like(p.float()).to(p.dtype))
    return model


def _gptneox():
    tf = _tf()
    return tf.GPTNeoXForCausalLM(tf.GPTNeoXConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, intermediate_size=128, rotary_pct=0.25,
        hidden_act="gelu", use_parallel_residual=True,
        max_position_embeddings=64, layer_norm_eps=1e-5,
        tie_word_embeddings=False))


def _phi2():
    tf = _tf()
    return tf.PhiForCausalLM(tf.PhiConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=4, intermediate_size=128,
        partial_rotary_factor=0.5, hidden_act="gelu_new",
        max_position_embeddings=64, layer_norm_eps=1e-5,
        tie_word_embeddings=False))


def _starcoder2():
    tf = _tf()
    return tf.Starcoder2ForCausalLM(tf.Starcoder2Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, hidden_act="gelu_pytorch_tanh",
        norm_epsilon=1e-5, use_bias=True, max_position_embeddings=64,
        tie_word_embeddings=False))


def _cohere():
    tf = _tf()
    return tf.CohereForCausalLM(tf.CohereConfig(
        vocab_size=V, hidden_size=256, num_hidden_layers=L,
        num_attention_heads=2, num_key_value_heads=2,
        intermediate_size=128, logit_scale=0.25,
        max_position_embeddings=64, layer_norm_eps=1e-5,
        use_qk_norm=False, tie_word_embeddings=True))


def _stablelm():
    tf = _tf()
    return tf.StableLmForCausalLM(tf.StableLmConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, partial_rotary_factor=0.25,
        hidden_act="silu", use_qkv_bias=True, use_parallel_residual=False,
        layer_norm_eps=1e-5, max_position_embeddings=64,
        tie_word_embeddings=False))


def _gpt2():
    tf = _tf()
    return tf.GPT2LMHeadModel(tf.GPT2Config(
        vocab_size=V, n_embd=64, n_layer=L, n_head=4, n_inner=None,
        n_positions=64, activation_function="gelu_new",
        layer_norm_epsilon=1e-5))


def _opt():
    tf = _tf()
    return tf.OPTForCausalLM(tf.OPTConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, ffn_dim=128, max_position_embeddings=64,
        activation_function="relu", do_layer_norm_before=True,
        word_embed_proj_dim=64))


def _bloom():
    tf = _tf()
    return tf.BloomForCausalLM(tf.BloomConfig(
        vocab_size=V, hidden_size=64, n_layer=L, n_head=4,
        layer_norm_epsilon=1e-5, slow_but_exact=False))


def _mpt(d=64, heads=4):
    tf = _tf()
    return tf.MptForCausalLM(tf.MptConfig(
        vocab_size=V, d_model=d, n_layers=L, n_heads=heads,
        expansion_ratio=4, max_seq_len=64, layer_norm_epsilon=1e-5))


def _olmo():
    tf = _tf()
    return tf.OlmoForCausalLM(tf.OlmoConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        clip_qkv=0.003, max_position_embeddings=64,
        tie_word_embeddings=False))


def _olmo2():
    tf = _tf()
    return tf.Olmo2ForCausalLM(tf.Olmo2Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        rms_norm_eps=1e-5, max_position_embeddings=64,
        tie_word_embeddings=False))


def _nemotron():
    tf = _tf()
    return tf.NemotronForCausalLM(tf.NemotronConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        norm_eps=1e-5, partial_rotary_factor=0.5, hidden_act="relu2",
        max_position_embeddings=64, tie_word_embeddings=False))


def _cohere2():
    tf = _tf()
    return tf.Cohere2ForCausalLM(tf.Cohere2Config(
        vocab_size=V, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=2, num_key_value_heads=2, intermediate_size=128,
        logit_scale=0.25, sliding_window=8, sliding_window_pattern=4,
        layer_types=["sliding_attention", "sliding_attention",
                     "sliding_attention", "full_attention"],
        max_position_embeddings=64, layer_norm_eps=1e-5))


def _smollm3():
    tf = _tf()
    return tf.SmolLM3ForCausalLM(tf.SmolLM3Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        no_rope_layer_interval=2, max_position_embeddings=64,
        tie_word_embeddings=True, pad_token_id=0))


def _gptj():
    tf = _tf()
    return tf.GPTJForCausalLM(tf.GPTJConfig(
        vocab_size=V, n_embd=256, n_layer=L, n_head=2, n_inner=None,
        rotary_dim=32, n_positions=64, activation_function="gelu_new",
        layer_norm_epsilon=1e-5, tie_word_embeddings=False))


def _gpt_bigcode():
    tf = _tf()
    return tf.GPTBigCodeForCausalLM(tf.GPTBigCodeConfig(
        vocab_size=V, n_embd=64, n_layer=L, n_head=4, n_inner=128,
        n_positions=64, activation_function="gelu_pytorch_tanh",
        layer_norm_epsilon=1e-5, multi_query=True))


def _falcon(**kw):
    tf = _tf()
    return tf.FalconForCausalLM(tf.FalconConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, layer_norm_epsilon=1e-5, **kw))


def _glm4():
    tf = _tf()
    return tf.Glm4ForCausalLM(tf.Glm4Config(
        vocab_size=V, hidden_size=256, num_hidden_layers=L,
        num_attention_heads=2, num_key_value_heads=2, head_dim=128,
        intermediate_size=128, partial_rotary_factor=0.5,
        attention_bias=True, rms_norm_eps=1e-5,
        max_position_embeddings=64, tie_word_embeddings=False,
        pad_token_id=0))


def _gemma1():
    tf = _tf()
    return tf.GemmaForCausalLM(tf.GemmaConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, max_position_embeddings=64))


def _gemma3():
    tf = _tf()
    return tf.Gemma3ForCausalLM(tf.Gemma3TextConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, max_position_embeddings=64,
        sliding_window=4, sliding_window_pattern=2,
        rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
        query_pre_attn_scalar=256))


def _arcee():
    tf = _tf()
    return tf.ArceeForCausalLM(tf.ArceeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=64))


def _ernie45():
    tf = _tf()
    return tf.Ernie4_5ForCausalLM(tf.Ernie4_5Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=64, pad_token_id=0))


def _seed_oss():
    tf = _tf()
    return _randomize(tf.SeedOssForCausalLM(tf.SeedOssConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, max_position_embeddings=64)),
        lambda n: n.endswith(".bias"), 0.1)


def _exaone4():
    tf = _tf()
    return tf.Exaone4ForCausalLM(tf.Exaone4Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, sliding_window=8,
        sliding_window_pattern=4, max_position_embeddings=64))


def _hunyuan():
    tf = _tf()
    return tf.HunYuanDenseV1ForCausalLM(tf.HunYuanDenseV1Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, max_position_embeddings=64))


def _apertus():
    tf = _tf()
    return _randomize(tf.ApertusForCausalLM(tf.ApertusConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=64)),
        lambda n: "alpha" in n, 0.3)


def _chameleon():
    tf = _tf()
    return _randomize(tf.ChameleonForConditionalGeneration(
        tf.ChameleonConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=L,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=64,
            vocabulary_map={"<image>": V - 1}, swin_norm=False)),
        lambda n: "q_norm" in n or "k_norm" in n, 0.2)


# name -> (constructor, torch seed, prompt length): the JAX tests' seeds; the
# sliding-window families take prompts past their windows
HF_FAMILIES = {
    "gptneox": (_gptneox, 0, 9),
    "phi2": (_phi2, 1, 9),
    "starcoder2": (_starcoder2, 2, 9),
    "cohere": (_cohere, 3, 9),
    "stablelm": (_stablelm, 4, 9),
    "gpt2": (_gpt2, 0, 9),
    "opt": (_opt, 1, 9),
    "bloom": (_bloom, 2, 9),
    "mpt": (_mpt, 3, 9),
    "mpt_extra_heads": (functools.partial(_mpt, 96, 6), 4, 9),
    "olmo": (_olmo, 5, 9),
    "olmo2": (_olmo2, 6, 9),
    "nemotron": (_nemotron, 7, 9),
    "cohere2": (_cohere2, 8, 16),
    "smollm3": (_smollm3, 9, 9),
    "gptj": (_gptj, 13, 9),
    "gpt_bigcode": (_gpt_bigcode, 14, 9),
    "falcon_7b": (functools.partial(
        _falcon, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, bias=False, alibi=False), 15, 9),
    "falcon_40b": (functools.partial(
        _falcon, num_kv_heads=2, multi_query=False, parallel_attn=True,
        new_decoder_architecture=True, bias=False, alibi=False), 16, 9),
    "falcon_rw_alibi": (functools.partial(
        _falcon, multi_query=False, parallel_attn=False,
        new_decoder_architecture=False, bias=True, alibi=True), 17, 9),
    "glm4": (_glm4, 18, 9),
    "gemma1": (_gemma1, 30, 9),
    "gemma3": (_gemma3, 40, 12),
    "arcee": (_arcee, 31, 9),
    "ernie45": (_ernie45, 32, 9),
    "seed_oss": (_seed_oss, 34, 9),
    "exaone4": (_exaone4, 35, 16),
    "hunyuan": (_hunyuan, 38, 9),
    "apertus": (_apertus, 40, 9),
    "chameleon": (_chameleon, 41, 9),
}


def run_family(name: str, tmp_path):
    make, seed, t = HF_FAMILIES[name]
    torch.manual_seed(seed)
    return hf_case(make(), tmp_path, t=t)


# --- the MoE HF families (configs of tests/test_archs_hf2.py,
# test_archs_hf3.py, test_archs_wave6.py and test_llama4.py) ----------------


def _randomize_buffers(model, pick, scale):
    """Set the buffers ``pick`` takes to ``scale`` * normals (the JAX tests'
    draw of the zero-initialised e_score_correction_bias)."""
    with torch.no_grad():
        for name, b in model.named_buffers():
            if pick(name):
                b.copy_(scale * torch.randn_like(b.float()).to(b.dtype))
    return model


def _mixtral():
    tf = _tf()
    return tf.MixtralForCausalLM(tf.MixtralConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=32, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, tie_word_embeddings=False))


def _qwen2_moe():
    tf = _tf()
    return tf.Qwen2MoeForCausalLM(tf.Qwen2MoeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, moe_intermediate_size=32,
        shared_expert_intermediate_size=64, num_experts=4,
        num_experts_per_tok=2, decoder_sparse_step=1, mlp_only_layers=[1],
        max_position_embeddings=64, tie_word_embeddings=False))


def _qwen3_moe():
    tf = _tf()
    return tf.Qwen3MoeForCausalLM(tf.Qwen3MoeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, moe_intermediate_size=32, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=True,
        max_position_embeddings=64, tie_word_embeddings=False))


def _olmoe():
    tf = _tf()
    return tf.OlmoeForCausalLM(tf.OlmoeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=32,
        num_experts=4, num_experts_per_tok=2, clip_qkv=0.003,
        max_position_embeddings=64, tie_word_embeddings=False))


def _gpt_oss():
    tf = _tf()
    return _randomize(tf.GptOssForCausalLM(tf.GptOssConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=64, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, layer_types=["sliding_attention", "full_attention"],
        rope_scaling=None, max_position_embeddings=64,
        tie_word_embeddings=False)),
        lambda n: "sinks" in n or n.endswith("_bias") or (
            "router" in n and n.endswith("bias")), 0.1)


def _dbrx():
    tf = _tf()
    return tf.DbrxForCausalLM(tf.DbrxConfig(
        vocab_size=V, d_model=64, n_layers=L, n_heads=4, max_seq_len=64,
        attn_config={"clip_qkv": 0.003, "kv_n_heads": 2,
                     "rope_theta": 10000.0},
        ffn_config={"ffn_hidden_size": 32, "moe_num_experts": 4,
                    "moe_top_k": 2, "moe_normalize_expert_weights": 1.0,
                    "moe_jitter_eps": None},
        tie_word_embeddings=False))


def _ernie45_moe():
    tf = _tf()
    model = tf.Ernie4_5_MoeForCausalLM(tf.Ernie4_5_MoeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, moe_intermediate_size=64,
        moe_num_experts=4, moe_k=2, moe_num_shared_experts=1,
        moe_layer_start_index=1, max_position_embeddings=64,
        pad_token_id=0))
    pick = lambda n: "e_score_correction_bias" in n  # noqa: E731
    return _randomize(_randomize_buffers(model, pick, 0.5), pick, 0.5)


def _dots1():
    tf = _tf()
    return _randomize_buffers(tf.Dots1ForCausalLM(tf.Dots1Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, moe_intermediate_size=64,
        n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, n_group=2, topk_group=1,
        routed_scaling_factor=1.5, max_position_embeddings=64)),
        lambda n: "e_score_correction_bias" in n, 0.5)


def _glm4_moe():
    tf = _tf()
    model = tf.Glm4MoeForCausalLM(tf.Glm4MoeConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, moe_intermediate_size=64,
        n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, n_group=2, topk_group=1,
        use_qk_norm=True, attention_bias=True,
        max_position_embeddings=64, pad_token_id=0))
    _randomize(model, lambda n: n.endswith(".bias"), 0.1)
    return _randomize_buffers(model, lambda n: "e_score_correction_bias" in n,
                              0.5)


def _hunyuan_moe():
    tf = _tf()
    return tf.HunYuanMoEV1ForCausalLM(tf.HunYuanMoEV1Config(
        vocab_size=V, hidden_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=64, num_experts=4, moe_topk=2,
        max_position_embeddings=64))


def _granitemoe(shared: int = 0):
    tf = _tf()
    kw = dict(vocab_size=V, hidden_size=64, num_hidden_layers=L,
              num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=32, num_local_experts=4,
              num_experts_per_tok=2, max_position_embeddings=64,
              tie_word_embeddings=False)
    if shared:
        return tf.GraniteMoeSharedForCausalLM(tf.GraniteMoeSharedConfig(
            shared_intermediate_size=shared, embedding_multiplier=2.0,
            logits_scaling=4.0, residual_multiplier=0.25,
            attention_multiplier=0.125, **kw))
    return tf.GraniteMoeForCausalLM(tf.GraniteMoeConfig(
        embedding_multiplier=6.0, logits_scaling=8.0,
        residual_multiplier=0.5, attention_multiplier=0.1, **kw))


def _llama4():
    tf = _tf()
    return tf.Llama4ForCausalLM(tf.Llama4TextConfig(
        vocab_size=V, hidden_size=64, intermediate_size=96,
        intermediate_size_mlp=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=128,
        num_local_experts=4, num_experts_per_tok=2,
        interleave_moe_layer_step=2, no_rope_layer_interval=2,
        attention_chunk_size=8, attn_temperature_tuning=True,
        floor_scale=8, attn_scale=0.1, use_qk_norm=True,
        max_position_embeddings=64, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        rope_scaling=None, attention_bias=False))


def _tern_marked(*markers):
    """A ternarizer of the 2-D ``.weight`` parameters whose names hold one
    of ``markers`` (mixtral's experts are w1/w2/w3)."""
    def tern(model, seed=0, scale=0.02):
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if (p.ndim == 2 and name.endswith(".weight")
                        and any(m in name for m in markers)):
                    trits = rng.integers(-1, 2, size=tuple(p.shape))
                    p.copy_(torch.tensor(trits * scale, dtype=p.dtype))
    return tern


def _tern_granitemoe(model):
    from test_archs_wave6 import _ternarize_granitemoe

    _ternarize_granitemoe(model)


def _tern_llama4(model):
    from test_llama4 import _ternarize

    _ternarize(model)


# name -> (constructor, torch seed, prompt length, ternarizers or None): the
# JAX tests' seeds
MOE_FAMILIES = {
    "mixtral": (_mixtral, 50, 9, (_tern_marked(
        "q_proj", "k_proj", "v_proj", "o_proj", ".experts."),)),
    "qwen2_moe": (_qwen2_moe, 11, 9, None),
    "qwen3_moe": (_qwen3_moe, 51, 9, None),
    "olmoe": (_olmoe, 12, 9, None),
    "gpt_oss": (_gpt_oss, 10, 16, None),
    "dbrx": (_dbrx, 19, 9, None),
    "ernie45_moe": (_ernie45_moe, 33, 9, None),
    "dots1": (_dots1, 36, 9, None),
    "glm4_moe": (_glm4_moe, 37, 9, None),
    "hunyuan_moe": (_hunyuan_moe, 39, 9, None),
    "granitemoe": (_granitemoe, 21, 9, (_tern_granitemoe,)),
    "granitemoe_shared": (functools.partial(_granitemoe, 48), 22, 9,
                          (_tern_granitemoe,)),
    "llama4": (_llama4, 42, 12, (_tern_llama4,)),
}


def run_moe_family(name: str, tmp_path):
    make, seed, t, tern = MOE_FAMILIES[name]
    torch.manual_seed(seed)
    return hf_case(make(), tmp_path, t=t, ternarize=tern)


# --- the JAX tests' transcription writers (tests/test_archs_moe_wave.py,
# test_archs_wave5.py): HF-style checkpoints written from numpy -----------

class _Written(Exception):
    pass


def written_by(test_fn, tmp_path, monkeypatch, nth: int = 0) -> Any:
    """Run a JAX transcription test up to its ``nth`` ``convert_hf`` call
    (counting from 0: its writer and the JAX converter, not its own
    logits); returns that converted checkpoint's directory."""
    import sys

    import vlut_tpu.convert.convert as conv

    mod = sys.modules[test_fn.__module__]
    real = conv.convert_hf
    out = []

    def convert_then_stop(src, dst, **kw):
        real(src, dst, **kw)
        out.append(dst)
        if len(out) > nth:
            raise _Written

    # the test module's own name, and the converter module's for a test
    # that imports it inside its body
    owners = [conv] + ([mod] if hasattr(mod, "convert_hf") else [])
    for owner in owners:
        monkeypatch.setattr(owner, "convert_hf", convert_then_stop)
    try:
        test_fn(tmp_path)
    except _Written:
        pass
    for owner in owners:
        monkeypatch.setattr(owner, "convert_hf", real)
    return out[nth]


def jax_cache_reads_own_heads(cfg) -> bool:
    """Whether the JAX package's cached forward attends over each layer's
    own KV heads.  Its cache holds the largest count on every layer, and a
    layer with fewer KV heads writes its first heads but attends over all
    of them (query heads grouped by the largest count), so its cached
    logits part from its own cacheless forward there; the port's layers
    hold their own heads (``layer_kv_heads``)."""
    return not cfg.heads_per_layer or all(
        nkv in (0, cfg.n_kv_heads) or not nh
        for nh, nkv in cfg.heads_per_layer)


def checkpoint_case(ckpt, seed: int = 3, t: int = 7, b: int = 2,
                    jax_cached: bool | None = None):
    """A converted checkpoint loaded by both packages, the port held
    against the JAX forward on the stacked and the fused tree (for a
    tuple-layers checkpoint the two are one unrolled tree), prefill and
    cached greedy decode (:func:`check_pair`); where the JAX package's
    cached forward misreads a layer's KV heads
    (:func:`jax_cache_reads_own_heads`), against its cacheless forward
    over the whole sequence at every step (or as ``jax_cached`` says).
    Returns the port's cfg."""
    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    cfg_j, params, meta = jax_load(ckpt)
    assert meta["ternarized_tensors"] == 0, "conversion must be lossless"
    params = per_tensor_scales(params)
    cfg, _, _ = load_checkpoint(ckpt, device="cpu")
    tt.check_supported(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    cached = (jax_cache_reads_own_heads(cfg_j) if jax_cached is None
              else jax_cached)
    for label, p, m in trees(cfg_j, params, cfg):
        check_pair(cfg_j, p, cfg, m, tokens, max_len=t + 8,
                   jax_cached=cached)
    return cfg
