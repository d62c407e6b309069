"""Heterogeneous layer stacks in the port, held against the JAX package on
the CPU: per-layer head counts and FFN widths (``heads_per_layer``,
``d_ff_per_layer``), deci's linear "attention", attention-free and
FFN-free layers, in ``layers_tuple`` checkpoints.

* the JAX tests' transcription writers (``tests/test_archs_wave5.py``):
  mimo2, openelm, deci and plamo3, through ``_torch_archs.checkpoint_case``
  (both packages' forwards, prefill and cached greedy decode, 2e-2 of the
  largest logit, identical greedy tokens).  The JAX package's cache holds
  the largest KV-head count on every layer and a narrower layer attends
  over all of its heads, so for mimo2 and openelm its cached logits part
  from its own cacheless forward; there the port's cached steps are held
  against the JAX cacheless forward over the whole sequence;
* the slot engine on openelm's checkpoint: its greedy tokens equal those
  of repeated JAX cacheless forwards;
* a context shift on a layer narrower than the model: its keys equal a
  fresh prefill's of the kept tokens at their new positions;
* slot save/restore keeps the JAX package's npz layout (each layer's rows
  padded with zero heads to the largest count) and a restored slot
  continues as the saved one.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_archs_wave5 as wave5
from _torch_archs import (checkpoint_case, jax_cache_reads_own_heads,
                          jax_forward, per_tensor_scales, written_by)
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.runtime import state as jax_state
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime import kv_cache as kvc
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

WRITERS = {
    "mimo2": wave5.test_mimo2_transcription,
    "openelm": wave5.test_openelm_transcription,
    "deci": wave5.test_deci_transcription,
    "plamo3": wave5.test_plamo3_transcription,
}


@pytest.mark.parametrize("name", list(WRITERS))
def test_hetero_writer_matches_jax(name, tmp_path, monkeypatch):
    cfg = checkpoint_case(written_by(WRITERS[name], tmp_path, monkeypatch))
    if name in ("mimo2", "openelm"):
        assert not jax_cache_reads_own_heads(cfg)
        assert len(set(tt.layer_kv_heads(cfg))) == 2


def test_engine_on_hetero_kv_heads_matches_jax_cacheless(tmp_path,
                                                          monkeypatch):
    """openelm (layers of (4, 2) and (2, 1) heads) through the port's slot
    engine: each request's greedy tokens equal repeated JAX cacheless
    forwards' (the JAX engine's cache misreads the narrower layer)."""
    ckpt = written_by(WRITERS["openelm"], tmp_path, monkeypatch)
    cfg_j, params, _ = jax_load(ckpt)
    params = jax.tree.map(jnp.asarray, per_tensor_scales(params))
    cfg, model, _ = load_checkpoint(ckpt, device="cpu")
    prompts = [[5, 17, 42, 7], [3, 30, 60, 11, 50, 8, 2], [9] * 10]
    want = []
    for p in prompts:
        ids = list(p)
        for _ in range(3):
            n = len(ids)
            lg, _ = jax_forward(params, cfg_j, jnp.asarray([ids], jnp.int32),
                                jnp.arange(n, dtype=jnp.int32)[None], None)
            ids.append(int(np.asarray(lg)[0, -1, :cfg.vocab_size].argmax()))
        want.append(ids[len(p):])
    eng = Engine(cfg, model, n_slots=2, max_len=32, prefill_buckets=(8, 16))
    assert [c.shape[2] for c in eng.cache["k"]] == [2, 1]
    reqs = [Request(prompt=p, max_new_tokens=3,
                    sampler=SamplerParams(temperature=0.0)) for p in prompts]
    eng.run(reqs)
    assert [r.output for r in reqs] == want


def _hetero_model(change=None):
    # the narrower layer first: layer 0's keys do not depend on the context
    # a shift drops
    cfg = dataclasses.replace(
        PRESETS["tiny"], n_heads=4, n_kv_heads=2, head_dim=32,
        heads_per_layer=((2, 1), (4, 2)), d_ff_per_layer=(128, 256),
        **(change or {}))
    return cfg, tt.init_params(cfg, seed=0)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_context_shift_on_a_narrower_layer(q8):
    cfg, model = _hetero_model(dict(rope_pct=0.5))
    n, keep, drop = 20, 4, 6
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, n)
    kept = np.concatenate([toks[:keep], toks[keep + drop:]])

    def keys(ids, shift):
        cache = tt.init_kv_cache(cfg, 1, max_len=32, dtype=torch.float32,
                                 quantized=q8)
        with torch.inference_mode():
            tt.forward(model, cfg, torch.from_numpy(ids)[None].long(),
                       torch.arange(len(ids))[None], cache)
        if shift:
            kvc.seq_shift(cache, 0, keep + drop, drop, tt.shift_tables(cfg))
        k = cache["k"][0]
        if q8:
            k = kvc.dequantize_kv(k, cache["k_scale"][0])
        assert k.shape[2] == 1
        return k[0, :n - drop].float().numpy()

    a, b = keys(toks, True), keys(kept, False)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-2


def test_slot_save_restore_keeps_the_jax_layout():
    cfg, model = _hetero_model()
    prompt = [int(t) for t in np.random.default_rng(1).integers(3, 200, 12)]

    def engine():
        return Engine(cfg, model, n_slots=2, max_len=64,
                      prefill_buckets=(16,))

    eng = engine()
    first = Request(prompt=prompt, max_new_tokens=4,
                    sampler=SamplerParams(temperature=0.0))
    eng.run([first])
    data = eng.save_slot(0)
    with np.load(io.BytesIO(data)) as z:
        k = z["kv_k"]
        assert k.shape[:3] == (2, len(prompt) + 3, 2)
        assert not k[0, :, 1:].any() and k[0, :, :1].any()
    # the JAX package reads the file into its cache of the largest count
    jcache = {n: jnp.zeros((2, 2, 64, 2, 128), jnp.bfloat16) for n in ("k", "v")}
    jcache, hist = jax_state.load_slot_state(jcache, 1, data)
    assert hist == eng.slots[0].history
    np.testing.assert_array_equal(
        np.asarray(jcache["k"][1, 1, :len(prompt) + 3], np.float32), k[1])
    # restored into a fresh engine's other slot, the slot continues as an
    # uninterrupted request does (its prefix reused, not prefilled again)
    whole = Request(prompt=prompt, max_new_tokens=8,
                    sampler=SamplerParams(temperature=0.0))
    engine().run([whole])
    eng2 = engine()
    eng2.restore_slot(1, data)
    hist = eng2.slots[1].history
    assert hist == prompt + first.output[:3]
    cont = Request(prompt=hist, max_new_tokens=5,
                   sampler=SamplerParams(temperature=0.0))
    eng2.run([cont])
    assert eng2.perf.n_reused_tokens > 0
    assert first.output == whole.output[:4]
    assert cont.output == whole.output[3:]
