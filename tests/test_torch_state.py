"""Slot save/restore in the port against the JAX package on the CPU.

Both packages write the same npz (``version``, ``tokens``, ``kv_<name>``
rows of (L, length, Hkv, hd_p), float32 for floats, int8 codes): a slot
saved by the JAX engine restores into the port's and the reverse, the
restored arrays round-trip bit for bit, and a request that continues the
restored prefix reuses its rows and gives the tokens of a fresh engine
(bf16 and q8 cache).  A restore writes the cache in place.
"""

import functools
import io

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
from vlut_tpu_torch.runtime import state
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

CFG_J, CFG = JAX_PRESETS["tiny"], PRESETS["tiny"]
KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))
PROMPT = [5, 17, 42, 7, 9, 9, 3, 11, 12]
MORE = [13, 4, 4]


@functools.lru_cache(maxsize=None)
def _params():
    params = jt.init_params(CFG_J, seed=0)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), CFG)


def _arrays(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def _jax_side(q8):
    """The JAX engine's saved slot after PROMPT, and its continuation of
    PROMPT + output + MORE after restoring that slot into a fresh engine."""
    params, _ = _params()
    eng = JaxEngine(CFG_J, params, impl="pallas_interpret", kv_quant=q8, **KW)
    r = JaxRequest(prompt=PROMPT, max_new_tokens=4,
                   sampler=JaxSampler(temperature=0.0))
    eng.run([r])
    saved = eng.save_slot(0)
    return saved, r.output


def _port_engine(q8):
    return Engine(CFG, _params()[1], kv_quant=q8, **KW)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_jax_saved_slot_restores_into_the_port(q8):
    saved, out_j = _jax_side(q8)
    arrays_j = _arrays(saved)
    eng = _port_engine(q8)
    cache_ptrs = [a.data_ptr() for arrs in eng.cache.values() for a in arrs]
    eng.restore_slot(1, saved)
    assert [a.data_ptr() for arrs in eng.cache.values()
            for a in arrs] == cache_ptrs  # written in place
    hist = eng.slots[1].history
    assert hist == PROMPT + out_j[:-1]
    # restored arrays round-trip bit for bit
    again = _arrays(eng.save_slot(1))
    assert set(again) == set(arrays_j)
    for k in arrays_j:
        assert again[k].dtype == arrays_j[k].dtype, k
        np.testing.assert_array_equal(again[k], arrays_j[k])
    # the continuation reuses the restored rows and equals a fresh run
    prompt = hist + MORE
    req = Request(prompt=prompt, max_new_tokens=6,
                  sampler=SamplerParams(temperature=0.0))
    eng.run([req])
    assert eng.perf.n_reused_tokens == len(hist)
    fresh = _port_engine(q8)
    want = Request(prompt=prompt, max_new_tokens=6,
                   sampler=SamplerParams(temperature=0.0))
    fresh.run([want])
    assert req.output == want.output


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_port_saved_slot_restores_into_jax(q8):
    _, out_j = _jax_side(q8)
    eng = _port_engine(q8)
    r = Request(prompt=PROMPT, max_new_tokens=4,
                sampler=SamplerParams(temperature=0.0))
    eng.run([r])
    assert r.output == out_j
    saved = eng.save_slot(0)
    params, _ = _params()
    jeng = JaxEngine(CFG_J, params, impl="pallas_interpret", kv_quant=q8,
                     **KW)
    jeng.restore_slot(1, saved)
    assert jeng.slots[1].history == eng.slots[0].history
    again = _arrays(jeng.save_slot(1))
    for k, v in _arrays(saved).items():
        np.testing.assert_array_equal(again[k], v)
    prompt = jeng.slots[1].history + MORE
    jr = JaxRequest(prompt=prompt, max_new_tokens=6,
                    sampler=JaxSampler(temperature=0.0))
    jeng.run([jr])
    assert jeng.perf.n_reused_tokens == len(prompt) - len(MORE)
    pr = Request(prompt=prompt, max_new_tokens=6,
                 sampler=SamplerParams(temperature=0.0))
    _port_engine(q8).run([pr])
    assert jr.output == pr.output


def test_state_file_roundtrip_and_mismatch(tmp_path):
    eng = _port_engine(False)
    eng.run([Request(prompt=PROMPT, max_new_tokens=2,
                     sampler=SamplerParams(temperature=0.0))])
    path = tmp_path / "slot.npz"
    state.save_slot_file(path, eng.cache, 0, len(eng.slots[0].history),
                         eng.slots[0].history)
    other = _port_engine(False)
    assert state.load_slot_file(path, other.cache, 0) == eng.slots[0].history
    with pytest.raises(ValueError, match="cache type"):
        _port_engine(True).restore_slot(0, path.read_bytes())
    busy = _port_engine(False)
    busy.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    busy.step()
    with pytest.raises(RuntimeError, match="busy"):
        busy.restore_slot(0, path.read_bytes())


def test_version1_file_restores_in_both_packages():
    """A version-1 file from before the q8 cache (``k`` / ``v`` entries, no
    ``kv_`` prefix), written with numpy, restores into a bf16 cache of
    either package with the same rows and history, and the port's
    continuation of it equals a fresh run."""
    saved, _ = _jax_side(False)
    arrays = _arrays(saved)
    buf = io.BytesIO()
    np.savez(buf, version=1, tokens=arrays["tokens"], k=arrays["kv_k"],
             v=arrays["kv_v"])
    old = buf.getvalue()
    hist = [int(t) for t in arrays["tokens"]]
    eng = _port_engine(False)
    eng.restore_slot(1, old)
    jeng = JaxEngine(CFG_J, _params()[0], impl="pallas_interpret", **KW)
    jeng.restore_slot(1, old)
    assert eng.slots[1].history == jeng.slots[1].history == hist
    for again in (_arrays(eng.save_slot(1)), _arrays(jeng.save_slot(1))):
        np.testing.assert_array_equal(again["kv_k"], arrays["kv_k"])
        np.testing.assert_array_equal(again["kv_v"], arrays["kv_v"])
    req = Request(prompt=hist + MORE, max_new_tokens=6,
                  sampler=SamplerParams(temperature=0.0))
    eng.run([req])
    assert eng.perf.n_reused_tokens == len(hist)
    want = Request(prompt=hist + MORE, max_new_tokens=6,
                   sampler=SamplerParams(temperature=0.0))
    _port_engine(False).run([want])
    assert req.output == want.output
