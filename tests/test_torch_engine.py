"""The port's slot engine against the JAX package's on the CPU.

Both engines serve the same weights (``tiny`` from ``init_params``, and the
trained ``tiny_real`` checkpoint) and the same requests; greedy tokens,
prefix-reuse and context-shift counts and ``n_probs`` ids must be equal,
for the bf16 and the q8 cache and for both decode-attention paths of the
port.

The JAX engine runs with ``impl="pallas_interpret"``: its projections then
go through the Pallas kernels in interpret mode, the kernels the port's
CUDA kernels and their plain versions reproduce bit for bit.  Its
``impl="xla"`` fallback rounds a fused projection's residual add to bf16
twice where the kernel rounds once, which on ``tiny`` flips a greedy token
whose top-two logits lie 0.0018 apart.
"""

import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
JAX_IMPL = "pallas_interpret"


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX cfg, JAX params, port cfg, port model) on identical weights."""
    if name == "tiny_real":
        cfg_j, params, _ = jax_load(TINY_REAL, stream=False)
        cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
        return cfg_j, params, cfg, model
    cfg_j, cfg = JAX_PRESETS[name], PRESETS[name]
    params = jt.init_params(cfg_j, seed=0)
    return cfg_j, params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def _workload(vocab):
    """Mixed lengths, more requests than slots, a prompt chunked past the
    largest bucket (32), a repeated prompt and n_probs."""
    rng = np.random.default_rng(0)
    long = [int(x) for x in rng.integers(3, vocab, 40)]
    return [
        dict(prompt=[5, 17, 42, 7], max_new_tokens=6),
        dict(prompt=[9] * 10, max_new_tokens=5),
        dict(prompt=long, max_new_tokens=4),
        dict(prompt=[1, 2], max_new_tokens=4, n_probs=3),
        dict(prompt=[5, 17, 42, 7], max_new_tokens=6),
        dict(prompt=long[:20] + [4, 4], max_new_tokens=3),
    ]


ENGINE_KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))


@functools.lru_cache(maxsize=None)
def _jax_run(name, q8):
    cfg_j, params, _, _ = _models(name)
    eng = JaxEngine(cfg_j, params, impl=JAX_IMPL, kv_quant=q8, **ENGINE_KW)
    reqs = [JaxRequest(sampler=JaxSampler(temperature=0.0), **kw)
            for kw in _workload(cfg_j.vocab_size)]
    eng.run(reqs)
    return reqs, eng.perf


def _port_run(name, q8, decode_attn, **over):
    _, _, cfg, model = _models(name)
    eng = Engine(cfg, model, kv_quant=q8, decode_attn=decode_attn,
                 **{**ENGINE_KW, **over})
    reqs = [Request(sampler=SamplerParams(temperature=0.0), **kw)
            for kw in _workload(cfg.vocab_size)]
    eng.run(reqs)
    return reqs, eng


@pytest.mark.parametrize("decode_attn", ["fused", "composed"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("name", ["tiny", "tiny_real"])
def test_engine_matches_jax(name, q8, decode_attn):
    want, perf = _jax_run(name, q8)
    got, eng = _port_run(name, q8, decode_attn)
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.done for r in got)
    assert eng.perf.n_reused_tokens == perf.n_reused_tokens
    assert eng.perf.n_prompt_tokens == perf.n_prompt_tokens
    assert eng.perf.n_decode_tokens == perf.n_decode_tokens
    for g, w in zip(got, want):
        assert len(g.logprobs) == len(w.logprobs)
        for (gi, gl, gc), (wi, wl, wc) in zip(g.logprobs, w.logprobs):
            np.testing.assert_array_equal(gi, np.asarray(wi))
            np.testing.assert_allclose(gl, np.asarray(wl), atol=1e-3)
            assert abs(gc - float(wc)) < 1e-3


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_context_shift_matches_jax(q8):
    """Generation past the cache capacity shifts the context (rows dropped
    and keys re-rotated, requantized in q8) exactly as the JAX engine."""
    cfg_j, params, cfg, model = _models("tiny")
    je = JaxEngine(cfg_j, params, n_slots=1, max_len=24, impl=JAX_IMPL,
                   kv_quant=q8)
    jr = JaxRequest(prompt=[3, 5, 7, 9], max_new_tokens=40,
                    sampler=JaxSampler(temperature=0.0))
    je.run([jr])
    eng = Engine(cfg, model, n_slots=1, max_len=24, kv_quant=q8)
    req = Request(prompt=[3, 5, 7, 9], max_new_tokens=40,
                  sampler=SamplerParams(temperature=0.0))
    eng.run([req])
    assert len(req.output) == 40
    assert req.output == jr.output
    assert eng.perf.n_shifted_tokens == je.perf.n_shifted_tokens > 0


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_prefix_reuse_matches_jax(q8):
    """A follow-up prompt that extends an earlier request's prompt and
    output reuses that slot's cached rows: same tokens and the same reuse
    count as the JAX engine."""
    cfg_j, params, cfg, model = _models("tiny_real")
    first = [2] + [int(c) for c in b"The little model"]
    je = JaxEngine(cfg_j, params, n_slots=2, max_len=64, impl=JAX_IMPL,
                   kv_quant=q8)
    eng = Engine(cfg, model, n_slots=2, max_len=64, kv_quant=q8)
    outs = []
    for e, req_t, sp in ((je, JaxRequest, JaxSampler(temperature=0.0)),
                         (eng, Request, SamplerParams(temperature=0.0))):
        a = req_t(prompt=first, max_new_tokens=6, sampler=sp)
        e.run([a])
        b = req_t(prompt=first + a.output + [32, 33], max_new_tokens=6,
                  sampler=sp)
        e.run([b])
        outs.append((a.output, b.output, e.perf.n_reused_tokens))
    assert outs[1] == outs[0]
    assert outs[1][2] == len(first) + 5  # the last output row is rewritten


def test_no_context_shift_stops_at_capacity_and_rejects_long_prompts():
    _, _, cfg, model = _models("tiny")
    eng = Engine(cfg, model, n_slots=1, max_len=24, context_shift=False)
    req = Request(prompt=[3, 5, 7, 9], max_new_tokens=48,
                  sampler=SamplerParams(temperature=0.0))
    big = Request(prompt=list(range(3, 40)), max_new_tokens=4)
    eng.run([req, big])
    assert 0 < len(req.output) < 48
    assert big.done and big.output == [] and "exceeds context" in big.error


def test_stop_token():
    _, _, cfg, model = _models("tiny")
    first, _ = _port_run("tiny", False, "fused")
    stop = first[0].output[2]
    eng = Engine(cfg, model, n_slots=1, max_len=64)
    req = Request(prompt=[5, 17, 42, 7], max_new_tokens=50,
                  sampler=SamplerParams(temperature=0.0), stop_tokens=(stop,))
    eng.run([req])
    assert req.output == first[0].output[:first[0].output.index(stop) + 1]


def test_grouped_prefill_equals_serial():
    """Requests admitted as one batched prefill group give the outputs of
    one-at-a-time admission."""
    _, _, cfg, model = _models("tiny")

    def run(n_slots):
        eng = Engine(cfg, model, n_slots=n_slots, max_len=64)
        reqs = [Request(prompt=[3 + j, 5, 7, 9 + j], max_new_tokens=5,
                        sampler=SamplerParams(temperature=0.0))
                for j in range(4)]
        eng.run(reqs)
        return [r.output for r in reqs]

    assert run(4) == run(1)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_idle_slot_steps_do_not_corrupt_cached_prefix(q8):
    """Idle slots still run through the decode step; their write lands on
    the scratch row max_len-1, never on a cached prefix row."""
    _, _, cfg, model = _models("tiny")
    eng = Engine(cfg, model, n_slots=2, max_len=32, kv_quant=q8)
    eng.run([Request(prompt=[9, 9, 3], max_new_tokens=2,
                     sampler=SamplerParams(temperature=0.0))])
    assert eng.slots[0].history
    eng.fork_slot(0, 1)
    before = [a[1, :8].clone() for arrs in eng.cache.values() for a in arrs]
    eng.run([Request(prompt=[5, 17, 42], max_new_tokens=10,
                     sampler=SamplerParams(temperature=0.0))])
    after = [a[1, :8] for arrs in eng.cache.values() for a in arrs]
    assert all(torch.equal(x, y) for x, y in zip(before, after))


def test_cancel_keeps_history_and_unported_features_raise():
    _, _, cfg, model = _models("tiny")
    eng = Engine(cfg, model, n_slots=1, max_len=64)
    req = Request(prompt=[4, 5, 6], max_new_tokens=30,
                  sampler=SamplerParams(temperature=0.0))
    eng.submit(req)
    eng.step()
    eng.step()
    assert eng.cancel(req.rid) and req.done and not eng.cancel(req.rid)
    assert eng.slots[0].history[:3] == [4, 5, 6]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(Request(prompt=[1], grammar=object()))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.save_slot(0)
    for kw in (dict(draft=object()), dict(lookahead=(4, 3)),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(cfg, model, **kw)


def test_seeded_sampling_is_reproducible_and_in_range():
    """The default server sampler (top-k 40, top-p 0.95, min-p 0.05,
    temperature 0.8) with a seed: the same request gives the same tokens on
    a fresh engine, and every token is a vocabulary id."""
    _, _, cfg, model = _models("tiny")
    sp = SamplerParams(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05,
                       repeat_penalty=1.1, seed=11)

    def run():
        eng = Engine(cfg, model, n_slots=2, max_len=64)
        reqs = [Request(prompt=[7, 8, 9], max_new_tokens=8, sampler=sp),
                Request(prompt=[1, 2], max_new_tokens=8,
                        sampler=SamplerParams(temperature=0.0))]
        eng.run(reqs)
        return [r.output for r in reqs]

    a, b = run(), run()
    assert a == b
    assert all(0 <= t < cfg.vocab_size for t in a[0])


def test_prefix_reuse_at_the_end_of_the_context():
    """A reused prefix that ends near max_len leaves a short remainder whose
    prefill bucket runs past the cache and the rope table: the pad tokens
    land on the scratch row and the output equals a run without reuse.
    (The JAX engine's clamped dynamic_update_slice shifts such a write onto
    the reused rows instead.)"""
    _, _, cfg, model = _models("tiny")
    rng = np.random.default_rng(3)
    prompt = [int(x) for x in rng.integers(3, cfg.vocab_size, 120)]
    sp = SamplerParams(temperature=0.0)
    eng = Engine(cfg, model, n_slots=1, max_len=cfg.max_seq_len)
    first = Request(prompt=prompt, max_new_tokens=1, sampler=sp)
    eng.run([first])
    again = Request(prompt=prompt + first.output, max_new_tokens=5, sampler=sp)
    eng.run([again])
    assert eng.perf.n_reused_tokens == len(prompt)
    fresh = Request(prompt=prompt + first.output, max_new_tokens=5, sampler=sp)
    Engine(cfg, model, n_slots=1, max_len=cfg.max_seq_len).run([fresh])
    assert again.output == fresh.output
