"""Models whose head shape the fused decode attention (#7/#8) took only
since it serves any group size: the port's engine, fused, against the JAX
engine on the CPU, and the gate that sends a layer to the kernel.

On the CPU the fused path runs the kernels' plain versions, so a model of
7 or 12 query heads over one KV head (heads of 64, padded to 128) decodes
through ``decode_attention_plain`` where it went composed before.  The JAX
engine runs with ``impl="pallas_interpret"``, as in
``tests/test_torch_engine.py``, whose tolerance the logprobs are held to.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.ops import decode_attention as da
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

ENGINE_KW = dict(n_slots=2, max_len=64, prefill_buckets=(16,))
HEADS = {"g7": dict(n_heads=7, n_kv_heads=1, head_dim=64),
         "g12": dict(n_heads=12, n_kv_heads=1, head_dim=64)}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX cfg, JAX params, port cfg, port model): ``tiny`` with the
    heads of ``HEADS[name]`` and one layer, identical weights."""
    over = dict(HEADS[name], n_layers=1)
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny"], **over)
    cfg = dataclasses.replace(PRESETS["tiny"], **over)
    params = jt.init_params(cfg_j, seed=0)
    return cfg_j, params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def _workload():
    """Three requests over two slots: one waits, one is chunked past the
    bucket, one asks for the top-3 logprobs."""
    return [dict(prompt=[5, 17, 42, 7], max_new_tokens=6, n_probs=3),
            dict(prompt=[9] * 20, max_new_tokens=5),
            dict(prompt=[1, 2], max_new_tokens=4, n_probs=3)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("name", sorted(HEADS))
def test_fused_engine_matches_jax(name, q8, monkeypatch):
    """Greedy tokens equal to the JAX engine's, logprobs within 1e-3; every
    decode step's attention went through the fused path (its plain
    version here)."""
    cfg_j, params, cfg, model = _models(name)
    je = JaxEngine(cfg_j, params, impl="pallas_interpret", kv_quant=q8,
                   **ENGINE_KW)
    want = [JaxRequest(sampler=JaxSampler(temperature=0.0), **kw)
            for kw in _workload()]
    je.run(want)
    calls = []
    plain = (da.decode_attention_int8_plain if q8
             else da.decode_attention_plain)
    monkeypatch.setattr(da, plain.__name__,
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    eng = Engine(cfg, model, kv_quant=q8, decode_attn="fused", **ENGINE_KW)
    got = [Request(sampler=SamplerParams(temperature=0.0), **kw)
           for kw in _workload()]
    eng.run(got)
    assert [r.output for r in got] == [r.output for r in want]
    assert len(calls) == eng.perf.n_decode_steps * cfg.n_layers > 0
    for g, w in zip(got, want):
        assert len(g.logprobs) == len(w.logprobs)
        for (gi, gl, gc), (wi, wl, wc) in zip(g.logprobs, w.logprobs):
            np.testing.assert_array_equal(gi, np.asarray(wi))
            np.testing.assert_allclose(gl, np.asarray(wl), atol=1e-3)
            assert abs(gc - float(wc)) < 1e-3


@pytest.mark.parametrize("heads,widths,ok", [
    ((14, 2), (128, 128), True),    # OuteTTS: G 7
    ((71, 1), (128, 128), True),    # falcon-7b: G 71
    ((12, 1), (384, 384), True),
    ((8, 2), (512, 128), True),     # hdv != hd
    ((8, 2), (640, 640), False),    # past the kernels' 512
    ((8, 2), (128, 640), False),
    ((6, 4), (128, 128), False)])   # H not a multiple of Hkv
def test_fused_gate_takes_the_kernels_head_shapes(heads, widths, ok):
    """``_fused_attn_ok`` sends a decode step to #7/#8 at any group size
    and K / V widths of 128-512, and keeps a wider head composed."""
    kvio = SimpleNamespace(slots=None)
    assert tt._fused_attn_ok(PRESETS["tiny"], heads, widths, 1, kvio,
                             "fused") is ok
    assert da.supports(*heads, *widths) is ok


def test_wrapper_names_the_head_width_limit():
    """A head wider than 512 is refused by the kernel's wrapper with the
    limit in its message (before any device work)."""
    q = torch.zeros(1, 1, 4, 640)
    kn, vn = torch.zeros(1, 1, 2, 640), torch.zeros(1, 1, 2, 640)
    kc = torch.zeros(1, 16, 2, 640, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="512"):
        da._launch(q, kn, vn, kc, kc.clone(), None, None,
                   torch.zeros(1, dtype=torch.int32), 0, 0.1)


def test_falcon_7b_config_is_transformers_own(tmp_path):
    """``bench/zoo.py:FALCON_7B`` (the published config.json, typed) gives
    the config that transformers' FalconConfig of the same fields, with its
    own defaults for the rest, gives: falcon-7b's widths, 71 heads over
    one, served by the fused attention."""
    from transformers import FalconConfig

    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.convert.convert import config_from_hf

    fields = {k: v for k, v in zoo.FALCON_7B.items() if k != "model_type"}
    FalconConfig(**fields).save_pretrained(tmp_path)
    cfg = zoo.hf_config(zoo.FALCON_7B)
    assert cfg == config_from_hf(tmp_path)
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (4544, 32, 71, 1, 4 * 4544, 65024)
    assert (cfg.norm_type, cfg.parallel_residual, cfg.act_fn,
            cfg.pos_embed, cfg.proj_bias) == ("ln", True, "gelu_exact",
                                             "rope", False)
    hd_p = tt.make_plan(cfg).hd_p
    assert hd_p == 128 and tt._fused_attn_ok(
        cfg, (71, 1), (hd_p, hd_p), 1, SimpleNamespace(slots=None), "fused")



def test_attention_paths_check_tells_a_fault():
    """``bench/engine.py:paths_ok``, the card's fused-against-composed
    check, passes the fused path and fails each of
    ``bench/paths_check.py:FAULTS`` (a head lost, the value columns
    shifted): 7 heads over one, 4 layers, four slots of 20 rows (a floor
    of 5.2e-3, the faults 0.42 and 1.07)."""
    from vlut_tpu_torch.bench import paths_check

    cfg = dataclasses.replace(PRESETS["tiny"], **HEADS["g7"], n_layers=4)
    model = tt.unstack_layers(tt.fuse_projections(tt.quantize_head(
        tt.init_params_fast(cfg, seed=0, device="cpu")), cfg), cfg)
    rows = paths_check.check(cfg, model, 4, 20, "cpu")
    assert [r["case"] for r in rows] == ["sound", *paths_check.FAULTS]
    assert [r["ok"] for r in rows] == [True] + [False] * len(
        paths_check.FAULTS)
