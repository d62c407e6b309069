"""MLA, M-RoPE and the stacked cache layout in the port, against the JAX
package on the CPU (tiny shapes, ``tiny_mla``: d 256, 4 heads, q-LoRA 256,
a latent of 256, nope 128, rope 64):

* ``init_params`` lays out MLA's projections, gains and absorbed factors
  bit for bit as the JAX package's, and a checkpoint written by either
  package loads in the other;
* prefill and cached greedy decode equal the JAX forward
  (``impl="pallas_interpret"``) within 2e-2 of the largest logit with
  identical greedy tokens, with and without q-LoRA, bf16 and q8 cache;
* the slot engine's greedy tokens equal the JAX engine's (bf16 and q8),
  and ``Engine(unroll=False)`` over a stacked cache gives the unrolled
  engine's tokens;
* a context shift rotates only the rope dims of the latent row, as a
  fresh prefill of the kept tokens writes them (the JAX package's shift
  fails on the latent row);
* a slot saved by either package's engine restores in the other;
* speculative and lookahead rounds on an MLA target give plain greedy;
* requantization repacks MLA's projections byte for byte as the JAX
  package's packer lays them out (its ``requantize_params`` raises on them)
  and round-trips; a LoRA on MLA's projections is refused;
* (``tests/test_torch_mla2.py``) M-RoPE, ``generate`` and ``serve`` of
  an MLA checkpoint, the MLA / M-RoPE zoo families and fast weights.
"""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import check_pair, trees
from test_torch_quantize import _assert_trees_equal
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.convert.checkpoint import save_checkpoint as jax_save
from vlut_tpu.convert.quantize import requantize_params as jax_requantize
from vlut_tpu.models import transformer as jt
from vlut_tpu.ops import rope as jrope
from vlut_tpu.runtime import kv_cache as jax_kv
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint, save_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.convert.quantize import requantize_params
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.ops.packing import TernaryTensor
from vlut_tpu_torch.runtime import kv_cache as kvc
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))


@functools.lru_cache(maxsize=None)
def _pair(**change):
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny_mla"], **change)
    cfg = dataclasses.replace(PRESETS["tiny_mla"], **change)
    params = jt.init_params(cfg_j, seed=0)
    return cfg_j, params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def _workload():
    """A prompt chunked past the largest bucket, a prompt that shares its
    prefix (those rows reused) and more requests than slots."""
    rng = np.random.default_rng(0)
    long = [int(x) for x in rng.integers(3, 256, 40)]
    return [dict(prompt=[5, 17, 42, 7], max_new_tokens=6),
            dict(prompt=long, max_new_tokens=4),
            dict(prompt=long[:20] + [4, 4], max_new_tokens=5)]


def _run(engine, request=Request, sampler=SamplerParams):
    reqs = [request(sampler=sampler(temperature=0.0), **w)
            for w in _workload()]
    engine.run(reqs)
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_engine(q8):
    cfg_j, params, _, _ = _pair()
    eng = JaxEngine(cfg_j, params, impl="pallas_interpret", kv_quant=q8,
                    **KW)
    return eng, _run(eng, JaxRequest, JaxSampler)


def test_init_params_and_checkpoints_match_jax(tmp_path):
    cfg_j, params, cfg, model = _pair()
    _assert_trees_equal(tt.init_params(cfg, seed=0).tree(), model.tree())
    save_checkpoint(tmp_path / "port", cfg, model)
    cfg2, params2, _ = jax_load(tmp_path / "port", stream=False)
    assert cfg2 == cfg_j
    _assert_trees_equal(params2, params)
    jax_save(tmp_path / "jax", cfg_j, params)
    cfg3, model3, _ = load_checkpoint(tmp_path / "jax", device="cpu")
    assert cfg3 == cfg
    _assert_trees_equal(model3.tree(), model.tree())


@pytest.mark.parametrize("case", ["bf16", "q8", "no_q_lora"])
def test_prefill_and_decode_match_jax(case):
    cfg_j, params, cfg, _ = _pair(**({"q_lora_rank": 0}
                                     if case == "no_q_lora" else {}))
    tokens = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
        np.int32)
    for _, p, m in trees(cfg_j, params, cfg):
        check_pair(cfg_j, p, cfg, m, tokens, max_len=24,
                   quantized=case == "q8")


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_engine_matches_jax(q8):
    jax_eng, want = _jax_engine(q8)
    _, _, cfg, model = _pair()
    eng = Engine(cfg, model, kv_quant=q8, **KW)
    assert _run(eng) == want
    assert eng.perf.n_reused_tokens == jax_eng.perf.n_reused_tokens > 0
    # one latent head of 256 + 64, padded to 384
    assert tuple(eng.cache["k"][0].shape) == (2, 64, 1, 384)


@pytest.mark.parametrize("name", ["tiny_mla", "tiny_mla_q8", "tiny"])
def test_stacked_engine_equals_layered(name):
    q8 = name.endswith("q8")
    if name == "tiny":
        cfg = PRESETS["tiny"]
        model = tt.init_params(cfg, seed=0)
    else:
        _, _, cfg, model = _pair()
    layered = Engine(cfg, model, kv_quant=q8, **KW)
    stacked = Engine(cfg, model, kv_quant=q8, unroll=False, **KW)
    assert isinstance(stacked.params.layers, tt.StackedLayers)
    assert not kvc.is_layered(stacked.cache)
    assert stacked.cache["k"].dim() == 5
    ptr = stacked.cache["k"].data_ptr()
    assert _run(stacked) == _run(layered)
    assert stacked.cache["k"].data_ptr() == ptr  # updated in place
    # the two layouts hold the same rows
    for key, arrs in kvc.to_layered(stacked.cache).items():
        for a, b in zip(arrs, layered.cache[key]):
            assert torch.equal(a, b)
    again = kvc.to_stacked(layered.cache)
    assert all(torch.equal(again[k], stacked.cache[k]) for k in again)


N, KEEP, DROP, MAX = 20, 4, 6, 32


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_context_shift_rotates_only_the_latent_rows_rope_dims(q8):
    """The shifted cache's kept rows against a fresh prefill of the kept
    tokens at their new positions, layer 0: the latent dims bit for bit
    (bf16; q8 within the codes' step), the rope dims within a bf16 ulp of
    the prefill's rope output."""
    cfg_j, params, cfg, model = _pair()
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, N)
    kept = np.concatenate([toks[:KEEP], toks[KEEP + DROP:]])
    r_kv, dr = cfg.kv_lora_rank, cfg.qk_rope_dim

    def port_rows(ids, shift):
        cache = tt.init_kv_cache(cfg, 1, max_len=MAX, quantized=q8)
        with torch.inference_mode():
            tt.forward(model, cfg, torch.from_numpy(ids)[None].long(),
                       torch.arange(len(ids))[None], cache)
        if shift:
            kvc.seq_shift(cache, 0, KEEP + DROP, DROP, tt.shift_tables(cfg))
        k = cache["k"][0]
        if q8:
            k = kvc.dequantize_kv(k, cache["k_scale"][0])
        return k.float().numpy()[0, :N - DROP, 0]

    got, want = port_rows(toks, True), port_rows(kept, False)
    lat = slice(0, r_kv)
    rope = slice(r_kv, r_kv + dr)
    step = np.abs(want).max() / 127 if q8 else 0.0
    assert np.abs(got[:, lat] - want[:, lat]).max() <= step
    err = np.abs(got[:, rope] - want[:, rope]).max() / np.abs(
        want[:, rope]).max()
    assert err < 1e-2 + (2 * step / np.abs(want[:, rope]).max()), err
    assert not got[:, r_kv + dr:].any()  # the pad stays zero
    # the JAX package's shift rotates whole rows with the model's head
    # tables (hd_p / 2 frequencies), which do not fit the latent row
    plan = jt.make_plan(cfg_j)
    tabs = jrope.rope_table(cfg_j.max_seq_len, plan.hd, cfg_j.rope_theta,
                            cfg_j.rope_scaling, pad_to=plan.hd_p,
                            with_mscale=False)
    cache_j = jt.init_kv_cache(cfg_j, 1, max_len=MAX, quantized=q8)
    with pytest.raises((TypeError, ValueError)):
        jax_kv.seq_shift(cache_j, jnp.int32(0), jnp.int32(KEEP + DROP),
                         jnp.int32(DROP), *tabs)


def test_engine_context_shift_on_a_latent_cache():
    """An engine request past the context shifts and finishes; its tokens
    before the shift are the unshifted engine's."""
    _, _, cfg, model = _pair()
    prompt = [int(x) for x in np.random.default_rng(2).integers(3, 256, 26)]
    outs = {}
    for max_len in (32, 64):
        eng = Engine(cfg, model, n_slots=1, max_len=max_len,
                     prefill_buckets=(16, 32))
        req = Request(prompt=prompt, max_new_tokens=12,
                      sampler=SamplerParams(temperature=0.0))
        eng.run([req])
        outs[max_len] = (req.output, eng.perf.n_shifted_tokens)
    assert outs[32][1] > 0 and outs[64][1] == 0
    assert len(outs[32][0]) == 12
    assert outs[32][0][:5] == outs[64][0][:5]


def _arrays(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_latent_slot_files_restore_across_packages(q8):
    jax_eng, _ = _jax_engine(q8)
    _, params, cfg, model = _pair()
    saved_j = jax_eng.save_slot(0)
    eng = Engine(cfg, model, kv_quant=q8, **KW)
    eng.restore_slot(1, saved_j)
    again = _arrays(eng.save_slot(1))
    want = _arrays(saved_j)
    assert set(again) == set(want) and want["kv_k"].shape[-2:] == (1, 384)
    for k in want:
        np.testing.assert_array_equal(again[k], want[k])
    # the port's file into a fresh JAX engine, and back out of it
    fresh = JaxEngine(_pair()[0], params, impl="pallas_interpret",
                      kv_quant=q8, **KW)
    fresh.restore_slot(1, eng.save_slot(1))
    back = _arrays(fresh.save_slot(1))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


@pytest.mark.parametrize("mode", ["draft", "lookahead"])
def test_rounds_on_an_mla_target_equal_plain_greedy(mode):
    _, _, cfg, model = _pair()
    kw = (dict(draft=(cfg, model), k_draft=3) if mode == "draft"
          else dict(lookahead=(3, 3)))
    eng = Engine(cfg, model, **kw, **KW)
    assert _run(eng) == _run(Engine(cfg, model, **KW))
    assert eng.perf.n_spec_drafted > 0
    if mode == "draft":
        assert eng.perf.n_spec_accepted == eng.perf.n_spec_drafted


def test_requantize_mla_bytes_and_roundtrip():
    cfg_j, params, cfg, model = _pair()
    with pytest.raises(KeyError):  # the JAX package's unpack_weight
        jax_requantize(cfg_j, params, "i1")
    cfg1, p1 = requantize_params(cfg, model, "i1")
    cfg1_j = dataclasses.replace(cfg_j, weight_fmt="i1")
    specs = jt.weight_specs(cfg_j)
    for name, val in p1["layers"].items():
        if not (isinstance(val, dict) and "packed" in val):
            continue
        for i in range(cfg.n_layers):
            src = params["layers"][name]
            t = TernaryTensor(torch.from_numpy(np.array(src["packed"][i])),
                              torch.tensor(float(src["scale"][i])),
                              specs[name].k, specs[name].n, "i2", 128)
            trits = tt.unpack_weight(name, t, cfg)
            want = jt.pack_weight(name, trits, np.float32(src["scale"][i]),
                                  cfg1_j)
            np.testing.assert_array_equal(val["packed"][i].numpy(),
                                          np.asarray(want.packed), name)
    cfg2, p2 = requantize_params(cfg1, p1, "i2")
    assert cfg2 == cfg
    _assert_trees_equal(p2, model.tree())
    m1 = tt.TransformerLM(cfg1, p1)
    assert _run(Engine(cfg1, m1, **KW)) == _run(Engine(cfg, model, **KW))


def test_lora_on_mla_projections_is_refused():
    _, _, cfg, model = _pair()
    tree = model.tree()
    wq = tree["layers"]["wq_a"]
    tree["layers"]["wq_a"] = {**wq, "lora_a": torch.zeros(2, 256, 4),
                              "lora_b": torch.zeros(2, 4, 256),
                              "lora_scale": torch.ones(2)}
    with pytest.raises(ValueError, match="LoRA"):
        tt.TransformerLM(cfg, tree).layers[0]
