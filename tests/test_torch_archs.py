"""The port's dense knobs against the JAX package on the CPU.

* the tiny presets of the knob family (qwen2, qwen3, gemma2, granite) from
  the JAX package's ``init_params`` with random gains;
* the fused decode attention of a sliding-window model takes the layer's
  window;
* the presets ``qwen3_4b`` and ``gemma2_2b`` at full width (depth and
  vocabulary cut for the CPU) from ``init_params_fast``.

Tolerances are those of ``tests/_torch_archs.py``: 2e-2 of the largest
logit, greedy tokens identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import check_pair, trees
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.models import transformer as tt

TINY_PRESETS = ["tiny_qwen2", "tiny_qwen3", "tiny_gemma2", "tiny_granite"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _random_gains(params, seed=3):
    """Every float vector of the tree (gains and biases) moved by 0.1 *
    normals, so that a gain of one hides no (1 + w) or ordering fault."""
    rng = np.random.default_rng(seed)

    def move(v):
        a = np.asarray(v)
        return jnp.asarray(a + 0.1 * rng.standard_normal(a.shape).astype(
            a.dtype))

    layers = {k: (v if isinstance(v, dict) else move(v))
              for k, v in params["layers"].items()}
    out = {**params, "layers": layers, "final_norm": move(params[
        "final_norm"])}
    return out


def _tokens(vocab, t, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (2, t)).astype(
        np.int32)


@pytest.mark.parametrize("name", TINY_PRESETS)
def test_init_params_matches_jax(name):
    """The port's numpy-seeded init_params draws the JAX package's tree,
    knob vectors included."""
    want = _flat(jt.init_params(JAX_PRESETS[name], seed=0))
    got = _flat(tt.init_params(PRESETS[name], seed=0).tree())
    assert set(got) == set(want)
    for key, a in want.items():
        np.testing.assert_array_equal(
            _as_np(got[key]).view(np.uint8), np.asarray(a).view(np.uint8),
            err_msg=key)


@pytest.mark.parametrize("name", TINY_PRESETS)
def test_tiny_preset_matches_jax(name):
    cfg_j, cfg = JAX_PRESETS[name], PRESETS[name]
    params = _random_gains(jt.init_params(cfg_j, seed=0))
    tokens = _tokens(cfg.vocab_size, 20)
    for _, p, model in trees(cfg_j, params, cfg):
        check_pair(cfg_j, p, cfg, model, tokens)


def test_swa_fused_attention_takes_the_window():
    """One decode step past a window of 4: the fused attention (#7's plain
    version on the CPU) equals the composed one, which masks by the
    window; attending over the whole cache (window 0) does not."""
    cfg = dataclasses.replace(PRESETS["tiny"], sliding_window=4,
                              sliding_window_pattern=0)
    model = tt.unstack_layers(tt.fuse_projections(
        tt.init_params(cfg, seed=0), cfg), cfg)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, 12)).long()
    pos = torch.arange(12)[None].repeat(2, 1)
    out = {}
    with torch.inference_mode():
        for mode in ("fused", "composed"):
            cache = tt.init_kv_cache(cfg, 2, max_len=32)
            tt.forward(model, cfg, tokens, pos, cache)
            out[mode], _ = tt.forward(model, cfg, tokens[:, :1],
                                      torch.full((2, 1), 12), cache,
                                      decode_attn=mode)
        model.windows = (0,) * cfg.n_layers
        cache = tt.init_kv_cache(cfg, 2, max_len=32)
        tt.forward(model, cfg, tokens, pos, cache)
        whole, _ = tt.forward(model, cfg, tokens[:, :1],
                              torch.full((2, 1), 12), cache)
    torch.testing.assert_close(out["fused"], out["composed"], rtol=0,
                               atol=1e-5)
    assert (whole - out["fused"]).abs().max() > 1e-3


def _cut(name, **kw):
    """A preset at its full width, its depth and vocabulary cut for the
    CPU."""
    return dataclasses.replace(PRESETS[name], n_layers=2, vocab_size=1024,
                               max_seq_len=64, **kw)


@pytest.mark.parametrize("name", ["qwen3_4b", "gemma2_2b"])
def test_presets_run_from_fast_random_weights(name):
    """Both presets at full width from init_params_fast: every vector their
    layers need is laid out, the stacked and the fused tree give the same
    greedy tokens, and the JAX package's init_params_fast lays out no q/k
    or post-norm gains (a fault of the reference: its own presets do not
    run from its fast random weights)."""
    tt.check_supported(PRESETS[name])
    cfg = _cut(name)
    model = tt.init_params_fast(cfg, seed=0, device="cpu")
    fused = tt.unstack_layers(tt.fuse_projections(model, cfg), cfg)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, 6)).long()
    pos = torch.arange(6)[None].repeat(2, 1)
    got = []
    with torch.inference_mode():
        for m in (model, fused):
            cache = tt.init_kv_cache(cfg, 2, max_len=16)
            lg, _ = tt.forward(m, cfg, tokens, pos, cache)
            nxt = lg[:, -1, :cfg.vocab_size].argmax(-1)
            lg2, _ = tt.forward(m, cfg, nxt[:, None], torch.full((2, 1), 6),
                                cache)
            assert torch.isfinite(lg2).all()
            got.append((nxt, lg2[:, 0, :cfg.vocab_size].argmax(-1)))
    assert all(torch.equal(a, b) for a, b in zip(*got))
    fast_j = jt.init_params_fast(
        dataclasses.replace(JAX_PRESETS[name], n_layers=1, vocab_size=1024),
        seed=0)
    have = set(model.layers.tree())
    missing = {"q_norm", "k_norm", "post_attn_norm", "post_ffn_norm"} & have
    assert missing and not missing & set(fast_j["layers"])


def test_unported_configs_raise():
    """Every config field is ported now: MoE, per-layer heads and FFN
    widths, MLA, M-RoPE, non-causal attention, the diffusion fields and
    cogvlm's visual experts pass the check; an unknown activation still
    raises."""
    base = PRESETS["tiny"]
    with pytest.raises(NotImplementedError, match="act_fn"):
        tt.check_supported(dataclasses.replace(base, act_fn="swish9"))
    for change in (dict(dual_expert=True),
                   dict(causal_attn=False), dict(mask_token_id=5),
                   dict(diffusion_shift_logits=False),
                   dict(n_experts=4, n_experts_used=2),
                   dict(heads_per_layer=((4, 2), (4, 2))),
                   dict(d_ff_per_layer=(256, 128)), dict(q_lora_rank=64),
                   dict(rope_scaling={"rope_type": "mrope",
                                      "mrope_section": [4, 6, 6]})):
        tt.check_supported(dataclasses.replace(base, **change))
    for name in ("qwen3_4b", "gemma2_2b", "tiny_moe", "mixtral_8x7b",
                 "tiny_mla", "deepseek_v2_lite",
                 "llada_8b") + tuple(TINY_PRESETS):
        tt.check_supported(PRESETS[name])


def test_zoo_families_run_on_the_cpu():
    """The chip script's knob families (``bench/zoo.py``) build, serve and
    decode with their plain versions; each one's expected kernels follow
    the JAX gates (a fused projection, an unfused one, the attention)."""
    from vlut_tpu_torch.bench import zoo

    kinds = set()
    for name in zoo.FAMILIES:
        r = zoo.card_vs_cpu(name, "cpu", n_decode=2)
        assert r["max_rel_logit_err"] == 0.0 and r["graph_equals_eager"]
        assert r["max_rel_layer_err"] == 0.0 and r["greedy_equal"]
        assert r["free_rel_logit_err"] == 0.0
        kinds.update(r["expected_kernels"])
    assert kinds == {"ternary_gemm_tiled", "ternary_gemm_decode",
                     "ternary_gemm_fused_quant", "decode_attention",
                     "write_rows_pair"}


def test_zoo_overrides_and_trace_on_the_cpu():
    """``bench/zoo.py``'s ``--set`` overrides reach the family's config, and
    its trace records every traced intermediate of the CPU against the CPU
    as bit-equal; a changed tree parts at the first intermediate it moves."""
    from vlut_tpu_torch.bench import zoo

    assert zoo.family_config("qwen3", {"rms_eps": 1e-5}).rms_eps == 1e-5
    assert zoo.family_config("qwen3").rms_eps == 1e-6
    assert zoo.trace("qwen3", "cpu", overrides={"qk_norm": False}) == []
    seen = []
    with zoo._recorded(seen):
        r = zoo.card_vs_cpu("qwen3", "cpu", n_decode=1)
    labels = {label.split("[")[0] for label, _ in seen}
    assert {"rms", "_qk_norm", "rope_prefix", "_attention",
            "quantize_activations", "forward"} <= labels
    assert r["greedy_equal"] and r["max_rel_layer_err"] == 0.0

