"""The port against the JAX package on MLA and M-RoPE models from HF, on the
CPU.

Each case is converted once by the JAX converter and loaded by both
packages; the port's forward is held against the JAX forward
(``impl="pallas_interpret"``) on the stacked and the fused tree (one
unrolled tree for a tuple-layers checkpoint), prefill and cached greedy
decode, within 2e-2 of the largest logit with identical greedy tokens
(``_torch_archs.hf_case`` / ``checkpoint_case``).  The JAX side runs
without a cache, over the whole sequence at every step: its cached forward
rounds apart from its own cacheless one on these models (XLA's float32
attention sum over the cache's empty rows moves the output by an ulp,
which flips int8 activation codes: 0.047 of the largest logit on
deepseek V3's MoE), while the port's cached and cacheless forwards agree
bit for bit.  The JAX cache is held against the port's through the
engines (``tests/test_torch_mla.py``).

* deepseek V3 with dense layers (q-LoRA, latent KV, interleaved rope on
  the rope dims) and with its MoE (sigmoid grouped routing with a
  selection bias, a shared expert, a dense lead layer), built with
  ``transformers`` as ``tests/test_archs_hf.py`` builds them;
* deepseek V2 with DeepSeek-V2-Lite's routing (no q-LoRA, softmax top 6 of
  8 without renormalisation, 2 shared experts, one dense lead layer);
* (``tests/test_torch_archs_mla2.py``) minicpm3, plm and qwen3-vl-moe's
  text model, written by the JAX tests.

The port's ``deepseek_v2_lite`` preset equals what the JAX converter makes
of DeepSeek-V2-Lite's published ``config.json``, and yarn at its settings
is measured against HF's ``DeepseekV2ForCausalLM``.
"""

import dataclasses
import json

import pytest

pytest.importorskip("transformers")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402
from _torch_archs import V, hf_case, jax_forward  # noqa: E402
from test_archs_hf import _ternarize_model  # noqa: E402

from vlut_tpu.convert.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load)
from vlut_tpu.convert.convert import config_from_hf, convert_hf  # noqa: E402
from vlut_tpu_torch.config import PRESETS  # noqa: E402
from vlut_tpu_torch.convert.checkpoint import load_checkpoint  # noqa: E402
from vlut_tpu_torch.models import transformer as tt  # noqa: E402

_MLA = dict(vocab_size=V, hidden_size=256, num_attention_heads=4,
            num_key_value_heads=4, q_lora_rank=256, kv_lora_rank=256,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            max_position_embeddings=64, rope_scaling=None,
            tie_word_embeddings=False)


def _deepseek_v3_mla():
    return transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
        **_MLA, num_hidden_layers=2, intermediate_size=128,
        first_k_dense_replace=2, n_routed_experts=4))


def _deepseek_v3_moe():
    model = transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
        **_MLA, num_hidden_layers=3, intermediate_size=128,
        moe_intermediate_size=64, n_routed_experts=8, num_experts_per_tok=2,
        n_group=2, topk_group=1, n_shared_experts=1,
        routed_scaling_factor=2.5, norm_topk_prob=True,
        first_k_dense_replace=1))
    # the V3 selection bias is zero-initialised; give it values, as the
    # JAX test does
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "e_score_correction_bias" in name:
                p.copy_(torch.randn_like(p))
    return model


def _deepseek_v2_lite_routing():
    """DeepSeek-V2-Lite's kinds at tiny widths: no q-LoRA, softmax top 6 of
    8 without renormalisation, 2 shared experts, one dense lead layer."""
    return transformers.DeepseekV2ForCausalLM(transformers.DeepseekV2Config(
        **{**_MLA, "q_lora_rank": None}, num_hidden_layers=3,
        intermediate_size=128, moe_intermediate_size=64,
        n_routed_experts=8, num_experts_per_tok=6, n_shared_experts=2,
        first_k_dense_replace=1, norm_topk_prob=False, topk_method="greedy",
        n_group=1, topk_group=1, routed_scaling_factor=1.0))


# name -> (constructor, torch seed: the JAX tests' where they have one)
HF_BUILT = {"deepseek_v3_mla": (_deepseek_v3_mla, 5),
            "deepseek_v3_moe": (_deepseek_v3_moe, 6),
            "deepseek_v2_lite_routing": (_deepseek_v2_lite_routing, 14)}


@pytest.mark.parametrize("name", list(HF_BUILT))
def test_mla_hf_families_match_jax(name, tmp_path):
    make, seed = HF_BUILT[name]
    torch.manual_seed(seed)
    cfg = hf_case(make(), tmp_path, ternarize=(_ternarize_model,),
                  jax_cached=False)
    assert cfg.kv_lora_rank and cfg.qk_rope_dim
    if name == "deepseek_v2_lite_routing":
        assert (cfg.q_lora_rank, cfg.moe_norm_topk, cfg.n_shared_experts,
                cfg.first_k_dense) == (0, False, 2, 1)


# DeepSeek-V2-Lite's config.json (deepseek-ai/DeepSeek-V2-Lite), the fields
# the converter reads
V2_LITE = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "n_shared_experts": 2, "n_routed_experts": 64,
    "routed_scaling_factor": 1.0, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "greedy", "n_group": 1, "topk_group": 1,
    "num_experts_per_tok": 6, "moe_layer_freq": 1,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "scoring_func": "softmax", "hidden_act": "silu",
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "attention_bias": False, "bos_token_id": 100000, "eos_token_id": 100001,
}


def test_deepseek_v2_lite_preset_is_the_converters(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(V2_LITE))
    want = dataclasses.asdict(config_from_hf(tmp_path))
    assert dataclasses.asdict(PRESETS["deepseek_v2_lite"]) == want


def test_yarn_at_v2_lite_settings_against_hf(tmp_path):
    """Yarn at DeepSeek-V2-Lite's settings (factor 40, mscale =
    mscale_all_dim = 0.707): the JAX package scales the rope tables by
    0.1 ln(40) + 1 = 1.369 and ignores mscale; HF's DeepseekV2 infers an
    attention factor of mscale(40, 0.707) / mscale(40, 0.707) = 1.  The port
    follows JAX (held within 2e-2 of its largest logit); with the config's
    ``attention_factor`` set to 1 it follows HF.  The gap to HF's logits is
    measured for both (a fault of the reference, ROADMAP Queue 3)."""
    scaling = dict(V2_LITE["rope_scaling"],
                   original_max_position_embeddings=16)
    torch.manual_seed(14)
    hf = transformers.DeepseekV2ForCausalLM(transformers.DeepseekV2Config(
        **{**_MLA, "q_lora_rank": None, "rope_scaling": scaling},
        num_hidden_layers=2, intermediate_size=128, n_routed_experts=4,
        first_k_dense_replace=2))
    hf = hf.float().eval()
    _ternarize_model(hf)
    hf.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    convert_hf(tmp_path / "hf", tmp_path / "out", fmt="i2")
    cfg_j, params, _ = jax_load(tmp_path / "out")
    cfg, model, _ = load_checkpoint(tmp_path / "out", device="cpu")
    assert cfg.rope_scaling["type"] == "yarn"
    # past the original context, where yarn's frequencies and factor act
    t = 48
    tokens = np.random.default_rng(3).integers(0, V, (1, t)).astype(np.int32)
    pos = np.arange(t, dtype=np.int32)[None]
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens).long()).logits.numpy()
    jl = np.asarray(jax_forward(params, cfg_j, tokens, pos)[0])

    def port(c):
        m = tt.TransformerLM(c, model.tree())
        with torch.inference_mode():
            return tt.forward(m, c, torch.from_numpy(tokens).long(),
                              torch.from_numpy(pos).long())[0].numpy()

    got = port(cfg)
    hf_factor = port(dataclasses.replace(cfg, rope_scaling=dict(
        cfg.rope_scaling, attention_factor=1.0)))
    scale = np.abs(jl).max()
    assert np.abs(got - jl).max() <= 2e-2 * scale
    v = want.shape[-1]
    gap_jax = float(np.abs(got[..., :v] - want).max() / np.abs(want).max())
    gap_hf = float(np.abs(hf_factor[..., :v] - want).max()
                   / np.abs(want).max())
    print(f"yarn gap to HF, of its largest logit: JAX's factor {gap_jax:.4f},"
          f" HF's {gap_hf:.4f}")
    assert gap_hf < gap_jax
