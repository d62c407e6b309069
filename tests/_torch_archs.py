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
               decode_attn: str = "fused") -> np.ndarray:
    """Prefill ``tokens`` (B, T) into a cache, then ``n_decode`` greedy
    cached steps, in both packages; logits compared at every step.  Returns
    the prefill's logits (the JAX package's)."""
    b, t = tokens.shape
    v = cfg.vocab_size
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jc = jt.init_kv_cache(cfg_j, b, max_len=max_len)
    jl, jc = jax_forward(params_j, cfg_j, jnp.asarray(tokens, jnp.int32),
                         jnp.asarray(pos), jc)
    tc = tt.init_kv_cache(cfg, b, max_len=max_len)
    with torch.inference_mode():
        tl, tc = tt.forward(model, cfg, torch.from_numpy(tokens).long(),
                            torch.from_numpy(pos).long(), tc)
    close(tl, jl, "prefill")
    first = np.asarray(jl)
    cur = first[:, -1, :v].argmax(-1)
    np.testing.assert_array_equal(tl[:, -1, :v].argmax(-1).numpy(), cur)
    for step in range(n_decode):
        p = np.full((b, 1), t + step, np.int32)
        jl, jc = jax_forward(params_j, cfg_j,
                             jnp.asarray(cur[:, None], jnp.int32),
                             jnp.asarray(p), jc)
        with torch.inference_mode():
            tl, tc = tt.forward(model, cfg,
                                torch.from_numpy(cur[:, None]).long(),
                                torch.from_numpy(p).long(), tc,
                                decode_attn=decode_attn)
        close(tl, jl, f"decode {step}")
        cur = np.asarray(jl)[:, 0, :v].argmax(-1)
        np.testing.assert_array_equal(tl[:, 0, :v].argmax(-1).numpy(), cur)
    return first


def hf_case(hf_model, tmp_path, t: int = 9, seed: int = 7):
    """A tiny HF model with exact-ternary projections, converted once by the
    JAX package's ``convert_hf`` and loaded by each package's
    ``load_checkpoint``: the port held against the JAX forward on both
    trees (prefill + cached greedy decode), and both against the HF
    logits as a sanity check (the checkpoint keeps bf16 embeddings and
    the GEMMs quantize activations to int8, so only the greedy token of
    most rows and the logits' scale are held).  Returns the port's cfg."""
    from test_archs_hf import _ternarize_model as ternarize_a
    from test_archs_hf2 import _ternarize_model as ternarize_b

    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
    from vlut_tpu.convert.convert import convert_hf
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    hf_model = hf_model.float().eval()
    # the two JAX test modules' projection-name lists together cover
    # every family here
    ternarize_a(hf_model)
    ternarize_b(hf_model)
    hf_model.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    convert_hf(tmp_path / "hf", tmp_path / "out", fmt="i2")
    cfg_j, params, meta = jax_load(tmp_path / "out")
    assert meta["ternarized_tensors"] == 0, "conversion must be lossless"
    cfg, model, _ = load_checkpoint(tmp_path / "out", device="cpu")
    tt.check_supported(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    with torch.no_grad():
        want = hf_model(torch.from_numpy(tokens).long()).logits.numpy()
    for label, p, m in trees(cfg_j, params, cfg):
        got = check_pair(cfg_j, p, cfg, m, tokens, max_len=t + 8)
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
