"""The port's slot engine serving Mamba (``runtime/engine.py``'s recurrent
branch) against the JAX engine (``impl="pallas_interpret"``) on the CPU:
mixed prompt lengths in left-padded groups, state isolation between
slots, slot reuse, save / restore in both packages' files, ``fork_slot``,
and the CLI's and server's Mamba paths.  The pattern is
``tests/test_ssm.py:176-241``.
"""

import io

import numpy as np
import pytest
import torch

from _torch_recurrent import greedy_ref, mamba_pair
from vlut_tpu.models import ssm as js
from vlut_tpu.runtime import state as jax_state
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.models import ssm as ps
from vlut_tpu_torch.runtime import state as state_mod
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

PROMPTS = [[5, 17, 42, 7, 3], [9, 9], list(range(3, 40)),
           list(range(60, 80)), [1], [33, 44, 55, 66, 77, 88]]
GREEDY = SamplerParams(temperature=0.0)


@pytest.fixture(scope="module")
def pair():
    return mamba_pair()


def _run_both(pair, prompts, n_new=6, n_slots=4, **kw):
    cfg_j, pj, cfg, model = pair
    je = JaxEngine(cfg_j, pj, n_slots=n_slots, max_len=64,
                   impl="pallas_interpret", **kw)
    jr = [JaxRequest(prompt=p, max_new_tokens=n_new,
                     sampler=JaxSampler(temperature=0.0)) for p in prompts]
    je.run(jr)
    pe = Engine(cfg, model, n_slots=n_slots, max_len=64, **kw)
    pr = [Request(prompt=p, max_new_tokens=n_new,
                  sampler=SamplerParams(temperature=0.0)) for p in prompts]
    pe.run(pr)
    return [r.output for r in jr], [r.output for r in pr], je, pe


@pytest.mark.parametrize("n_slots", [2, 4, 8])
def test_engine_greedy_equals_jax_engine(pair, n_slots):
    """Six prompts of 1-37 tokens: groups of the 16 / 64 buckets, queued
    past the slots (2 and 4) or all at once (8)."""
    want, got, _, pe = _run_both(pair, PROMPTS, n_slots=n_slots)
    assert got == want
    _, _, cfg, model = pair
    assert got == [greedy_ref(cfg, model, p, 6) for p in PROMPTS]
    assert pe.perf.n_prompt_tokens == sum(map(len, PROMPTS))
    assert pe.perf.n_reused_tokens == 0


def test_prompts_past_the_largest_bucket_equal_jax(pair):
    """Prompts of 17, 40 and 16 tokens in one batch with one bucket of 16:
    the long ones run in full 16-token chunks, each continuing its slot's
    state, and their left-padded remainders (1 and 8 tokens) join the
    16-token prompt's group, as the JAX engine's chunk rounds run them.
    Fresh slots: the greedy tokens are the JAX engine's and plain
    greedy's, and every prompt token is prefilled once."""
    prompts = [list(range(3, 20)), list(range(40, 80)), list(range(7, 23))]
    want, got, _, pe = _run_both(pair, prompts, prefill_buckets=(16,))
    assert got == want
    _, _, cfg, model = pair
    assert got == [greedy_ref(cfg, model, p, 6) for p in prompts]
    assert pe.perf.n_prompt_tokens == sum(map(len, prompts))


def test_chunks_continue_the_slot_state(pair):
    """A 40-token prompt in chunks of 16: the slot's final state is the
    state of one unchunked prefill of the prompt (a larger bucket), though
    its 8-token remainder runs left-padded from the carried state: a pad
    step is the identity.  The JAX engine's remainder decays the carried
    state through its pads and convolves them in place of the carried
    window (ROADMAP, faults of the reference)."""
    cfg_j, pj, cfg, model = pair
    prompt = list(range(40, 80))
    states, jax_states = [], []
    for buckets in ((16,), (64,)):
        eng = Engine(cfg, model, n_slots=2, max_len=64,
                     prefill_buckets=buckets)
        eng.run([Request(prompt=prompt, max_new_tokens=1, sampler=GREEDY)])
        states.append(eng.cache)
        je = JaxEngine(cfg_j, pj, n_slots=2, max_len=64,
                       impl="pallas_interpret", prefill_buckets=buckets)
        je.run([JaxRequest(prompt=prompt, max_new_tokens=1,
                           sampler=JaxSampler(temperature=0.0))])
        jax_states.append(np.asarray(je.cache["ssm"]))
    for k in ("conv", "ssm"):
        torch.testing.assert_close(states[0][k], states[1][k], rtol=1e-5,
                                   atol=1e-6)
    torch.testing.assert_close(states[1]["ssm"],
                               torch.from_numpy(jax_states[1]), rtol=1e-4,
                               atol=1e-6)
    assert not np.allclose(jax_states[0], jax_states[1], rtol=1e-2,
                           atol=1e-4)


def test_slot_reuse_starts_from_a_zero_state(pair):
    """A third request in a slot that served another: its prefill starts
    from zeros (the port), so its tokens and final state are a fresh
    engine's.  The JAX engine starts the prefill from the slot's state
    (ROADMAP, faults of the reference); its greedy tokens agree on this
    model, its state does not."""
    cfg_j, pj, cfg, model = pair
    eng = Engine(cfg, model, n_slots=1, max_len=64)
    fresh = Engine(cfg, model, n_slots=1, max_len=64)
    je = JaxEngine(cfg_j, pj, n_slots=1, max_len=64,
                   impl="pallas_interpret")
    for p in (PROMPTS[0], PROMPTS[1]):
        eng.run([Request(prompt=p, max_new_tokens=4, sampler=GREEDY)])
        je.run([JaxRequest(prompt=p, max_new_tokens=4,
                           sampler=JaxSampler(temperature=0.0))])
    r3, rf = (Request(prompt=PROMPTS[3], max_new_tokens=5,
                      sampler=SamplerParams(temperature=0.0))
              for _ in range(2))
    eng.run([r3])
    fresh.run([rf])
    assert r3.output == rf.output == greedy_ref(cfg, model, PROMPTS[3], 5)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(eng.cache[k], fresh.cache[k], rtol=0,
                                   atol=0)
    j3 = JaxRequest(prompt=PROMPTS[3], max_new_tokens=5,
                    sampler=JaxSampler(temperature=0.0))
    je.run([j3])
    assert j3.output == r3.output
    assert not np.allclose(np.asarray(je.cache["ssm"]),
                           eng.cache["ssm"].numpy(), rtol=1e-3, atol=1e-5)


def test_idle_slots_keep_their_state(pair):
    """While one slot decodes, a finished slot's state stays as its request
    left it (the JAX engine steps idle slots on token 0)."""
    _, _, cfg, model = pair
    eng = Engine(cfg, model, n_slots=2, max_len=64)
    eng.run([Request(prompt=PROMPTS[0], max_new_tokens=2, sampler=GREEDY),
             Request(prompt=PROMPTS[1], max_new_tokens=9, sampler=GREEDY)])
    alone = Engine(cfg, model, n_slots=2, max_len=64)
    alone.run([Request(prompt=PROMPTS[0], max_new_tokens=2, sampler=GREEDY)])
    for k in ("conv", "ssm"):
        torch.testing.assert_close(eng.cache[k][:, 0], alone.cache[k][:, 0],
                                   rtol=1e-6, atol=1e-8)


def test_no_capacity_limit_but_the_requests(pair):
    """A recurrent slot decodes past ``max_len`` (no context shift, no
    capacity wall); a prompt of ``max_len`` tokens is refused as in JAX."""
    _, _, cfg, model = pair
    eng = Engine(cfg, model, n_slots=1, max_len=16, prefill_buckets=(16,))
    req = Request(prompt=PROMPTS[0], max_new_tokens=30, sampler=GREEDY)
    eng.run([req])
    assert len(req.output) == 30 and eng.perf.n_shifted_tokens == 0
    assert req.output == greedy_ref(cfg, model, PROMPTS[0], 30)
    long = Request(prompt=list(range(1, 17)), max_new_tokens=2)
    eng.run([long])
    assert long.done and "exceeds context" in long.error


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_slot_state_files_restore_in_both_packages(pair, writer):
    """A slot saved by either package restores in the other: the same
    history and the same state entries (``recurrent=1``, ``rs_conv``,
    ``rs_ssm``)."""
    cfg_j, pj, cfg, model = pair
    _, _, je, pe = _run_both(pair, PROMPTS[:2], n_new=3, n_slots=2)
    src = pe if writer == "port" else je
    blob = src.save_slot(1)
    with np.load(io.BytesIO(blob)) as z:
        assert int(z["recurrent"]) == 1
        assert {"rs_conv", "rs_ssm", "tokens", "version"} <= set(z.files)
    eng = Engine(cfg, model, n_slots=3, max_len=64)
    eng.restore_slot(2, blob)
    jeng = JaxEngine(cfg_j, pj, n_slots=3, max_len=64,
                     impl="pallas_interpret")
    jeng.restore_slot(2, blob)
    assert eng.slots[2].history == jeng.slots[2].history == (
        src.slots[1].history)
    for k in ("conv", "ssm"):
        want = np.asarray(src.cache[k][:, 1], np.float32)
        np.testing.assert_array_equal(eng.cache[k][:, 2].numpy(), want)
        np.testing.assert_array_equal(np.asarray(jeng.cache[k][:, 2]), want)
    # the port's file is the JAX reader's, entry for entry
    st, hist = jax_state.load_recurrent_state(
        js.init_state(cfg_j, 1), 0, state_mod.save_recurrent_state(
            eng.cache, 2, eng.slots[2].history))
    assert hist == eng.slots[2].history
    np.testing.assert_array_equal(np.asarray(st["ssm"][:, 0]),
                                  eng.cache["ssm"][:, 2].numpy())
    with pytest.raises(ValueError, match="KV cache"):
        state_mod.load_slot_state({"k": [torch.zeros(1, 4, 1, 8)],
                                   "v": [torch.zeros(1, 4, 1, 8)]}, 0, blob)


def test_fork_slot_copies_the_whole_state(pair):
    _, _, cfg, model = pair
    eng = Engine(cfg, model, n_slots=3, max_len=64)
    eng.run([Request(prompt=PROMPTS[2], max_new_tokens=3, sampler=GREEDY)])
    eng.fork_slot(0, 2)
    assert eng.slots[2].history == eng.slots[0].history
    for k in ("conv", "ssm"):
        torch.testing.assert_close(eng.cache[k][:, 2], eng.cache[k][:, 0],
                                   rtol=0, atol=0)
    eng.slots[1].req = Request(prompt=[1])
    with pytest.raises(RuntimeError, match="busy"):
        eng.fork_slot(0, 1)


def test_seeded_sampling_is_reproducible(pair):
    """Sampled requests (temperature 0.8, top-k 20, seeds) through the
    recurrent engine: the same seeds give the same tokens on a fresh
    engine, every token in the vocabulary."""
    _, _, cfg, model = pair

    def run():
        eng = Engine(cfg, model, n_slots=3, max_len=64)
        reqs = [Request(prompt=p, max_new_tokens=8,
                        sampler=SamplerParams(temperature=0.8, top_k=20,
                                              seed=i))
                for i, p in enumerate(PROMPTS[:3])]
        eng.run(reqs)
        return [r.output for r in reqs]

    a, b = run(), run()
    assert a == b
    assert all(0 <= t < cfg.vocab_size for r in a for t in r)
