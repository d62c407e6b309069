"""LoRA adapters and control vectors in the port against the JAX package on
the CPU, on a config whose heads and chunks pad (head_dim 32 -> 128, d_ff
192 in two chunks of 96 -> 128), so a delta applied in unpadded
coordinates would be wrong.

A random rank-8 PEFT adapter written as safetensors loads into the same
padded A/B on both sides; the delta ``(h @ A) @ B * scale`` (a bf16
product with float32 accumulation) is within rtol 1e-2 / atol 1e-3 of
JAX's; the engine's greedy tokens with the adapter, and with a control
vector, equal the JAX engine's (``impl="pallas_interpret"``); a LoRA on
wq/wk/wv/w_gate/w_up keeps the tree unfused, one on wo/w_down only does
not.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime import lora as jl
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import write_safetensors
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.runtime import lora as pl
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

CFG_J = dataclasses.replace(JAX_PRESETS["tiny"], d_ff=192, tp_pack=2)
CFG = dataclasses.replace(PRESETS["tiny"], d_ff=192, tp_pack=2)
MODULES = {"q_proj": "self_attn", "v_proj": "self_attn",
           "o_proj": "self_attn", "up_proj": "mlp", "down_proj": "mlp"}
KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))
PROMPTS = [[5, 17, 42, 7], [9, 9, 3, 11, 12, 13], [1, 2]]


def test_config_pads_heads_and_chunks():
    plan = make_plan(CFG)
    assert plan.hd != plan.hd_p and plan.ff_chunk != plan.ff_chunk_p


@functools.lru_cache(maxsize=None)
def _params():
    params = jt.init_params(CFG_J, seed=0)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), CFG)


def _write_adapter(path, modules=MODULES, r=8, scale=0.02, seed=1):
    """A random PEFT adapter directory: A (r, K) and B (N, r) per module
    and layer in HF orientation."""
    rng = np.random.default_rng(seed)
    d, q, kv, ff = CFG.d_model, CFG.q_dim, CFG.kv_dim, CFG.d_ff
    shapes = {"q_proj": (d, q), "k_proj": (d, kv), "v_proj": (d, kv),
              "o_proj": (q, d), "gate_proj": (d, ff), "up_proj": (d, ff),
              "down_proj": (ff, d)}
    arrays = {}
    for li in range(CFG.n_layers):
        for mod, block in modules.items():
            k, n = shapes[mod]
            pre = f"base_model.model.model.layers.{li}.{block}.{mod}"
            arrays[f"{pre}.lora_A.weight"] = (
                rng.standard_normal((r, k)) * scale).astype(np.float32)
            arrays[f"{pre}.lora_B.weight"] = (
                rng.standard_normal((n, r)) * scale).astype(np.float32)
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(path / "adapter_model.safetensors", arrays)
    (path / "adapter_config.json").write_text(
        json.dumps({"r": r, "lora_alpha": 16}))
    return path


@pytest.fixture(scope="module")
def adapter_dir(tmp_path_factory):
    return _write_adapter(tmp_path_factory.mktemp("lora") / "adapter")


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy())


def test_adapter_loads_to_the_same_padded_layout(adapter_dir):
    aj = jl.load_peft_adapter(adapter_dir, CFG_J)
    ap = pl.load_peft_adapter(adapter_dir, CFG)
    assert (aj["alpha"], aj["r"]) == (ap["alpha"], ap["r"])
    assert set(aj["layers"]) == set(ap["layers"]) == {
        "wq", "wv", "wo", "w_up", "w_down"}
    plan = make_plan(CFG)
    for name, ab in ap["layers"].items():
        for leaf in ("a", "b"):
            want = np.asarray(aj["layers"][name][leaf])
            np.testing.assert_array_equal(_bits(ab[leaf]),
                                          want.view(np.int16))
    assert ap["layers"]["wq"]["b"].shape[-1] == plan.q_dim_p
    assert ap["layers"]["w_up"]["b"].shape[-1] == plan.ff_p
    assert ap["layers"]["wo"]["a"].shape[1] == plan.wo_in_p
    assert ap["layers"]["w_down"]["a"].shape[1] == plan.ff_p


@pytest.mark.parametrize("name", ["wq", "wo", "w_up", "w_down"])
def test_delta_matches_jax(adapter_dir, name):
    aj = jl.load_peft_adapter(adapter_dir, CFG_J)
    ap = pl.load_peft_adapter(adapter_dir, CFG)
    a_j, b_j = aj["layers"][name]["a"][1], aj["layers"][name]["b"][1]
    scale = 1.5 * aj["alpha"] / aj["r"]
    rng = np.random.default_rng(7)
    h = rng.standard_normal((3, 5, a_j.shape[0])).astype(np.float32)
    h_bf = jnp.asarray(h, jnp.bfloat16)
    want = (jnp.dot(jnp.dot(h_bf.astype(a_j.dtype), a_j), b_j,
                    preferred_element_type=jnp.float32) * scale)
    model = pl.apply_lora(_params()[1], ap, scale=1.5)
    lin = model.layers[1].proj[name]
    assert lin.has_lora and float(lin.lora_scale) == pytest.approx(scale)
    x = torch.from_numpy(np.array(h_bf.astype(jnp.float32))).to(
        torch.bfloat16)
    got = lin.lora_delta(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-3)


def test_fusion_follows_the_lora(adapter_dir, tmp_path):
    model = _params()[1]
    full = pl.apply_lora(model, pl.load_peft_adapter(adapter_dir, CFG))
    assert not tt.fuse_projections(full, CFG).layers[0].fused
    out_only = pl.load_peft_adapter(
        _write_adapter(tmp_path / "o", {"o_proj": "self_attn",
                                        "down_proj": "mlp"}), CFG)
    fused = tt.unstack_layers(tt.fuse_projections(
        pl.apply_lora(model, out_only), CFG), CFG)
    assert fused.layers[0].fused
    assert fused.layers[0].proj["wo"].has_lora
    assert fused.layers[0].proj["w_down"].has_lora


def _jax_tokens(params):
    eng = JaxEngine(CFG_J, params, impl="pallas_interpret", **KW)
    reqs = [JaxRequest(prompt=p, max_new_tokens=8,
                       sampler=JaxSampler(temperature=0.0)) for p in PROMPTS]
    eng.run(reqs)
    return [r.output for r in reqs]


def _port_tokens(model, q8=False):
    eng = Engine(CFG, model, kv_quant=q8, **KW)
    reqs = [Request(prompt=p, max_new_tokens=8,
                    sampler=SamplerParams(temperature=0.0)) for p in PROMPTS]
    eng.run(reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("modules", ["all", "out_only"])
def test_engine_with_lora_matches_jax(adapter_dir, tmp_path, modules):
    path = adapter_dir if modules == "all" else _write_adapter(
        tmp_path / "o", {"o_proj": "self_attn", "down_proj": "mlp"},
        scale=0.05)
    params, model = _params()
    want = _jax_tokens(jl.apply_lora(
        params, jl.load_peft_adapter(path, CFG_J), scale=2.0))
    got = _port_tokens(pl.apply_lora(model, pl.load_peft_adapter(path, CFG),
                                     scale=2.0))
    assert got == want
    assert got != _port_tokens(model)  # the adapter changes the output


def test_engine_with_control_vector_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    dirs = (rng.standard_normal((CFG.n_layers, CFG.d_model)) * 0.5).astype(
        np.float32)
    path = tmp_path / "cv.safetensors"
    write_safetensors(path, {f"direction.{i}": dirs[i]
                             for i in range(CFG.n_layers)})
    np.testing.assert_array_equal(pl.load_cvector_file(path, CFG), dirs)
    np.testing.assert_array_equal(jl.load_cvector_file(str(path), CFG_J),
                                  dirs)
    params, model = _params()
    want = _jax_tokens(jl.apply_cvector(params, dirs, scale=0.7))
    got = _port_tokens(pl.apply_cvector(model, dirs, scale=0.7))
    assert got == want
    assert got != _port_tokens(model)
