"""The runtime extras over the dense knobs, against the JAX package on the
CPU: speculative decoding (a draft model) and lookahead rounds on a model
with sliding windows and softcaps (tiny_gemma2, whose 16-row window the
40-token prompt passes), whose verify and lookahead forwards take the
composed attention under the window, the softcap and the round's mask; and
a LoRA adapter beside q/k/v biases (the delta added to the projection,
then the bias, in the JAX package's ``proj`` order).  Greedy tokens equal
plain greedy and the JAX engine's (``impl="pallas_interpret"``), but for
lookahead, where the JAX package drops the window under the round's mask.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_lora import _write_adapter
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime import lora as jl
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.runtime import lora as pl
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))


@functools.lru_cache(maxsize=None)
def _pair(name, seed, **change):
    cfg_j = dataclasses.replace(JAX_PRESETS[name], **change)
    cfg = dataclasses.replace(PRESETS[name], **change)
    params = jt.init_params(cfg_j, seed=seed)
    return cfg_j, params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def _workload():
    rng = np.random.default_rng(3)
    return [dict(prompt=[int(x) for x in rng.integers(3, 256, 40)],
                 max_new_tokens=8),
            dict(prompt=[5, 9, 11, 5, 9, 11, 5, 9], max_new_tokens=10),
            dict(prompt=[1, 2], max_new_tokens=6)]


def _run(engine, request, sampler):
    reqs = [request(sampler=sampler(temperature=0.0), **w)
            for w in _workload()]
    engine.run(reqs)
    return [r.output for r in reqs], engine.perf


@pytest.mark.parametrize("mode", ["draft", "lookahead"])
def test_rounds_under_windows_and_softcaps_match_jax(mode):
    cfg_j, params, cfg, model = _pair("tiny_gemma2", 0)
    _, params_d, _, model_d = _pair("tiny_gemma2", 5)
    kw_j = (dict(draft=(cfg_j, params_d), k_draft=3) if mode == "draft"
            else dict(lookahead=(3, 3)))
    kw = (dict(draft=(cfg, model_d), k_draft=3) if mode == "draft"
          else dict(lookahead=(3, 3)))
    want, perf = _run(JaxEngine(cfg_j, params, impl="pallas_interpret",
                                **kw_j, **KW), JaxRequest, JaxSampler)
    got, pperf = _run(Engine(cfg, model, **kw, **KW), Request, SamplerParams)
    plain, _ = _run(Engine(cfg, model, **KW), Request, SamplerParams)
    assert got == plain
    assert pperf.n_spec_drafted > 0
    if mode == "draft":
        assert got == want
        assert pperf.n_spec_drafted == perf.n_spec_drafted
        assert pperf.n_spec_accepted == perf.n_spec_accepted
    else:
        # the JAX package's lookahead mask replaces the sliding window, so
        # its rounds attend past the window and leave plain greedy on the
        # 40-token prompt (a fault of the reference); the port keeps the
        # window under the round's mask
        assert want != plain and want[1:] == plain[1:]


def test_lora_beside_qkv_biases_matches_jax(tmp_path):
    """The adapter's wq/wv deltas sit beside the q/v biases (the tree stays
    unfused: a qkv-bias model never fuses)."""
    change = dict(d_ff=192, tp_pack=2)
    cfg_j, params, cfg, model = _pair("tiny_qwen2", 0, **change)
    path = _write_adapter(tmp_path / "a", {"q_proj": "self_attn",
                                           "v_proj": "self_attn",
                                           "up_proj": "mlp"}, scale=0.05)
    with_j = jl.apply_lora(params, jl.load_peft_adapter(path, cfg_j),
                           scale=2.0)
    with_p = pl.apply_lora(model, pl.load_peft_adapter(path, cfg), scale=2.0)
    assert with_p.layers[0].proj["wq"].has_lora and hasattr(
        with_p.layers[0], "bq")
    want, _ = _run(JaxEngine(cfg_j, with_j, impl="pallas_interpret", **KW),
                   JaxRequest, JaxSampler)
    got, _ = _run(Engine(cfg, with_p, **KW), Request, SamplerParams)
    plain, _ = _run(Engine(cfg, model, **KW), Request, SamplerParams)
    assert got == want
    assert got != plain  # the adapter changes the output
