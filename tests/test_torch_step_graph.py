"""The decode step as a CUDA graph captures it, run eagerly on the CPU.

The engine's and ``generate``'s decode step is one function over static
tensors (``Engine._decode_step``, ``make_generate_fn``'s step) that the
card captures once and replays.  On the CPU the same function runs
eagerly, so here it is held against the JAX engine (with
``impl="pallas_interpret"``), against the eager step as it ran before it
became a program over static tensors (each step's tensors made anew, the
sampler drawing its own noise), and the graph's bookkeeping (launch counts
added per replay) against a stub that stands in for the graph.  The card's
side (graph equals eager, bit for bit) is in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import functools
import importlib
import pathlib
import pkgutil

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
from vlut_tpu_torch import ops
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models.transformer import forward, init_kv_cache
from vlut_tpu_torch.ops import decode_attention as da
from vlut_tpu_torch.ops import kv_update, ternary_gemm as tg
from vlut_tpu_torch.runtime import engine as te
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.generate import make_generate_fn
from vlut_tpu_torch.runtime.sampling import (
    NEG_INF,
    SamplerParams,
    draw_noise,
    features_of,
    init_state,
    noise_shapes,
    row_generators,
    sample,
    sample_ex,
    stack_params,
)
from vlut_tpu_torch.runtime.step_graph import (
    EagerStep,
    StepGraph,
    step_runner,
)

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
JAX_IMPL = "pallas_interpret"
ENGINE_KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))


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
    """More requests than slots, a prompt chunked past the largest bucket,
    a repeated prompt and n_probs."""
    rng = np.random.default_rng(4)
    long = [int(x) for x in rng.integers(3, vocab, 40)]
    return [dict(prompt=[5, 17, 42, 7], max_new_tokens=5),
            dict(prompt=long, max_new_tokens=4, n_probs=2),
            dict(prompt=[9] * 10, max_new_tokens=5),
            dict(prompt=[5, 17, 42, 7], max_new_tokens=3)]


class PriorStepEngine(Engine):
    """The engine with the decode step as it ran before it was a program
    over static tensors: its inputs made anew each step, the sampler drawing
    its own noise from the slots' generators, its state rebound."""

    @torch.inference_mode()
    def step(self) -> bool:
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return bool(self.queue)
        tokens = torch.zeros((self.n_slots,), dtype=torch.long)
        lengths = torch.full((self.n_slots,), self.max_len - 1,
                             dtype=torch.long)
        for i in active:
            s = self.slots[i]
            tokens[i] = s.req.output[-1]
            lengths[i] = s.length + s.generated - 1
        k_probs = max(self.slots[i].req.n_probs for i in active)
        logits, _ = forward(self.params, self.cfg, tokens[:, None],
                            lengths[:, None], self.cache,
                            decode_attn=self.decode_attn)
        logits = te._mask_pad_vocab(logits[:, 0].to(torch.float32),
                                    self.cfg.vocab_size)
        sp = {k: v.clone() for k, v in self._sp.items()}
        valid = te._window_mask(self.ring_cnt, sp["penalty_last_n"])
        nxt, self._sampler_state = sample_ex(
            logits, sp, self._gens, self._sampler_state, self.ring, valid,
            features=self._features)
        rows = torch.arange(self.n_slots)
        self.ring[rows, (self.ring_cnt % te.PENALTY_WINDOW).long()] = nxt.to(
            torch.int32)
        self.ring_cnt += 1
        if k_probs:
            lp = torch.log_softmax(logits, dim=-1)
            top_lp, top_id = torch.topk(lp, k_probs, dim=-1)
            chosen = torch.gather(lp, 1, nxt[:, None])[:, 0]
        self.perf.n_decode_tokens += len(active)
        self.perf.n_decode_steps += 1
        for i in active:
            req = self.slots[i].req
            self.slots[i].kv_hist.append(int(tokens[i]))
            if k_probs and req.n_probs:
                req.logprobs.append((top_id[i, :req.n_probs].numpy(),
                                     top_lp[i, :req.n_probs].numpy(),
                                     float(chosen[i])))
            self._push_token_host_only(i, int(nxt[i]))
        return True


def _run(cls, name, q8, decode_attn, samplers=None):
    _, _, cfg, model = _models(name)
    eng = cls(cfg, model, kv_quant=q8, decode_attn=decode_attn, **ENGINE_KW)
    work = _workload(cfg.vocab_size)
    samplers = samplers or [SamplerParams(temperature=0.0)] * len(work)
    reqs = [Request(sampler=sp, **kw) for kw, sp in zip(work, samplers)]
    eng.run(reqs)
    return reqs, eng


@functools.lru_cache(maxsize=None)
def _jax_outputs(name, q8):
    cfg_j, params, _, _ = _models(name)
    eng = JaxEngine(cfg_j, params, impl=JAX_IMPL, kv_quant=q8, **ENGINE_KW)
    reqs = [JaxRequest(sampler=JaxSampler(temperature=0.0), **kw)
            for kw in _workload(cfg_j.vocab_size)]
    eng.run(reqs)
    return [r.output for r in reqs], [[lp[0].tolist() for lp in r.logprobs]
                                      for r in reqs]


@pytest.mark.parametrize("decode_attn", ["fused", "composed"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("name", ["tiny", "tiny_real"])
def test_static_step_matches_prior_step_and_jax(name, q8, decode_attn,
                                                monkeypatch):
    """Engine._decode_step, the function the card captures, run eagerly:
    greedy tokens and n_probs ids equal the prior eager step's and the JAX
    engine's, and every decode step went through it (no graph on the
    CPU)."""
    calls = []
    real = Engine._decode_step

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(Engine, "_decode_step", spy)
    got, eng = _run(Engine, name, q8, decode_attn)
    monkeypatch.undo()
    prior, _ = _run(PriorStepEngine, name, q8, decode_attn)
    want, want_ids = _jax_outputs(name, q8)
    assert [r.output for r in got] == [r.output for r in prior] == want
    assert [[lp[0].tolist() for lp in r.logprobs] for r in got] == want_ids
    assert len(calls) == eng.perf.n_decode_steps > 0
    assert not eng.cuda_graph and eng.perf.n_captures == 0
    assert all("capture_ms" not in p for p in eng.step_programs())


def test_admission_writes_sampler_settings_in_place():
    """Admission writes the slots' settings into the static ``_sp`` (a
    captured step keeps its tensors): the values equal a fresh
    stack_params, and the tokens those of the prior step, which rebinds
    them; logit bias, penalties and greedy rows mixed."""
    samplers = [SamplerParams(temperature=0.0, logit_bias=((65, 30.0),)),
                SamplerParams(temperature=0.0, repeat_penalty=1.3,
                              presence_penalty=0.5, penalty_last_n=8),
                SamplerParams(temperature=0.0),
                SamplerParams(temperature=0.0, frequency_penalty=0.7)]
    _, _, cfg, model = _models("tiny_real")
    eng = Engine(cfg, model, **ENGINE_KW)
    ptrs = {k: v.data_ptr() for k, v in eng._sp.items()}
    work = _workload(cfg.vocab_size)
    reqs = [Request(sampler=sp, **kw) for kw, sp in zip(work, samplers)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.step():
        steps += 1
        assert all(v.data_ptr() == ptrs[k] for k, v in eng._sp.items())
    assert steps > 0
    prior, _ = _run(PriorStepEngine, "tiny_real", False, "fused", samplers)
    assert [r.output for r in reqs] == [r.output for r in prior]
    assert any(t == 65 for t in reqs[0].output)


def test_admission_values_equal_fresh_stack_params():
    _, _, cfg, model = _models("tiny_real")
    eng = Engine(cfg, model, **ENGINE_KW)
    sps = [SamplerParams(temperature=0.7, top_k=5, seed=3),
           SamplerParams(temperature=0.0, min_p=0.2, logit_bias=((7, -2.0),))]
    for sp in sps:
        eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=3, sampler=sp))
    eng._admit()
    want = stack_params(sps)
    for k, v in want.items():
        assert torch.equal(eng._sp[k], v), k
    assert eng._features == features_of(sps)


SEEDED = dict(temperature=0.8, top_k=40, xtc_p=0.6, xtc_t=0.02)


@pytest.mark.parametrize("mirostat", [False, True])
def test_predrawn_noise_gives_the_same_seeded_tokens(mirostat):
    """The XTC roll, the categorical draw and mirostat's, drawn ahead into
    tensors in the chain's order, give the tokens and state of the chain
    drawing for itself, over several steps of the same generators; a
    greedy chain draws nothing."""
    rng = np.random.default_rng(0)
    b, v = 5, 300
    sps = [SamplerParams(seed=i, mirostat_tau=5.0 if mirostat and i % 2
                         else 0.0, **SEEDED) for i in range(b)]
    sps[3] = SamplerParams(temperature=0.0)
    p = stack_params(sps)
    feats = features_of(sps)
    assert ("mirostat" in feats) == mirostat and "xtc" in feats
    gens_a = row_generators(p, 7, "cpu")
    gens_b = row_generators(p, 7, "cpu")
    gens_a[3] = gens_b[3] = None
    state_a, state_b = init_state(b), init_state(b)
    shapes = noise_shapes(b, v, feats)
    assert list(shapes) == ["xtc", "categorical"] + (
        ["mirostat"] if mirostat else [])
    static = {k: torch.zeros(sh) for k, sh in shapes.items()}
    for _ in range(4):
        logits = torch.from_numpy(
            rng.standard_normal((b, v)).astype(np.float32) * 3)
        want, state_a = sample_ex(logits, p, gens_a, state_a, features=feats)
        draw_noise(gens_b, shapes, "cpu", out=static)
        got, state_b = sample_ex(logits, p, None, state_b, features=feats,
                                 noise=static)
        assert torch.equal(got, want)
        assert torch.equal(state_a["mu"], state_b["mu"])
    assert noise_shapes(b, v, ("penalties", "top_k")) == {}


def _prior_generate(cfg, params, cache, last, lengths, sp, features, seed,
                    n, decode_attn):
    """make_generate_fn's loop as it ran before its step was a program:
    fresh tensors every step, the sampler drawing for itself."""
    gens = row_generators(sp, seed, "cpu") if features else None
    at = torch.zeros((last.shape[0],), dtype=torch.long)
    tokens, lens, out = last, lengths, []
    for _ in range(n):
        logits, cache = forward(params, cfg, tokens[:, None], lens[:, None],
                                cache, logits_at=at, decode_attn=decode_attn)
        logits = logits[:, 0].to(torch.float32)
        vv = logits.shape[-1]
        if vv != cfg.vocab_size:
            logits = logits.masked_fill(torch.arange(vv) >= cfg.vocab_size,
                                        NEG_INF)
        tokens = sample(logits, sp, gens, features)
        lens = lens + 1
        out.append(tokens)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("decode_attn", ["fused", "composed"])
def test_generate_step_matches_prior_loop(decode_attn, sampled):
    """generate's static step, eager on the CPU, gives the prior loop's
    tokens (greedy, and seeded with XTC and mirostat), call after call on
    one cache (one program kept), and a new program for a new cache."""
    _, _, cfg, model = _models("tiny_real")
    b, t, n = 3, 6, 5
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        3, cfg.vocab_size, (b, t)))
    sps = [SamplerParams(seed=i, mirostat_tau=4.0 if i == 1 else 0.0,
                         **SEEDED) if sampled
           else SamplerParams(temperature=0.0) for i in range(b)]
    feats = features_of(sps)
    sp = stack_params(sps)
    lengths = torch.full((b,), t)

    def prefill():
        cache = init_kv_cache(cfg, b, max_len=t + n + 2)
        with torch.inference_mode():
            logits, _ = forward(model, cfg, ids, torch.arange(t)[None].repeat(
                b, 1), cache)
        return cache, logits[:, -1, :cfg.vocab_size].argmax(-1)

    gen = make_generate_fn(cfg, n, features=feats, decode_attn=decode_attn)
    cache, last = prefill()
    with torch.inference_mode():
        want = _prior_generate(cfg, model, cache, last, lengths, sp, feats,
                               5, n, decode_attn)
    outs = []
    for _ in range(2):  # a new cache: a new program
        cache2, last2 = prefill()
        for _ in range(2):  # the same cache again: the kept program (each
            # step writes the row it reads, so the run needs no rewind)
            outs.append(gen(model, cache2, last2, lengths, sp, 5)[0])
    for out in outs:
        assert torch.equal(out, want)


class StubGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the capture runs the
    step once (its wrappers count as under a real capture), a replay runs
    nothing."""

    def __init__(self):
        self.replays = 0

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


def test_every_kernel_wrapper_is_counted():
    """Every wrapper under ``ops/`` with a ``launches`` counter is in the
    registry a replay adds to (one left out would read near zero on a
    graphed path)."""
    found = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"vlut_tpu_torch.ops.{info.name}")
        found |= {f for f in vars(mod).values()
                  if callable(f) and hasattr(f, "launches")}
    names = {f.__name__ for f in found}
    assert {"ternary_gemm_decode", "ternary_gemm_fused_quant",
            "ternary_gemm_tiled", "write_rows_pair", "decode_attention",
            "decode_attention_int8", "tq_gemm"} <= names
    assert found <= set(ops.COUNTED)


def test_replay_adds_the_captured_launch_counts():
    counters = ops.COUNTED
    assert kv_update.write_rows_pair in counters
    assert tg.ternary_gemm_decode in counters
    before = {w: w.launches for w in counters}

    def step():
        tg.ternary_gemm_decode.launches += 4
        kv_update.write_rows_pair.launches += 2
        return torch.ones(3)

    stub = StubGraph()
    g = StepGraph(step, graph=stub)
    out = g.capture()
    assert g.captured and torch.equal(out, torch.ones(3))
    # the capture launched nothing: the counts are taken back
    assert all(w.launches == n for w, n in before.items())
    for _ in range(3):
        assert g.replay() is out
    assert stub.replays == 3
    assert tg.ternary_gemm_decode.launches == before[
        tg.ternary_gemm_decode] + 12
    assert kv_update.write_rows_pair.launches == before[
        kv_update.write_rows_pair] + 6
    assert g.stats()["launches_per_replay"] == {
        "ternary_gemm_decode": 4, "write_rows_pair": 2}
    for w, n in before.items():
        w.launches = n


def test_failed_capture_raises_and_keeps_the_counts():
    before = {w: w.launches for w in ops.COUNTED}

    def step():
        tg.ternary_gemm_decode.launches += 4
        raise RuntimeError("decode attention: the workspace must be "
                           "allocated before a CUDA graph is captured")

    g = StepGraph(step, graph=StubGraph())
    with pytest.raises(RuntimeError, match="workspace"):
        g.capture()
    assert not g.captured
    assert all(w.launches == n for w, n in before.items())


def test_step_runner_is_eager_then_captured_then_replayed():
    """The capture policy: on the card a step's first call runs it
    eagerly, the second captures and replays it, later calls replay; on
    the CPU and with ``cuda_graph=False`` every call is eager."""
    calls = []

    def step():
        calls.append(1)
        return torch.ones(2)

    for run in (step_runner(step, torch.device("cpu")),
                step_runner(step, torch.device("cpu"), cuda_graph=False)):
        assert isinstance(run, EagerStep)
    stub = StubGraph()
    g = StepGraph(step, graph=stub)
    g()
    assert g.warm and not g.captured and len(calls) == 1
    out = g()  # captured (the stub runs the step once) and replayed
    assert g.captured and len(calls) == 2 and stub.replays == 1
    assert g() is out and len(calls) == 2 and stub.replays == 2
    assert g.stats()["replays"] == 2


def test_graph_keeps_the_buffers_held_at_its_capture(monkeypatch):
    """A graph keeps the decode-attention workspace it was captured
    with, so a larger call may replace the workspace without freeing
    memory the graph replays with."""
    old = (torch.zeros(8), torch.zeros(2, dtype=torch.int32))
    monkeypatch.setattr(da, "_work", {0: old})
    g = StepGraph(lambda: torch.ones(1), graph=StubGraph())
    g.capture()
    da._work[0] = (torch.zeros(16), torch.zeros(4, dtype=torch.int32))
    assert any(t is old[0] for t in g.held)
    assert any(t is old[1] for t in g.held)


def _stub_runner(fn, device, cuda_graph=True, pool=None):
    return StepGraph(fn, graph=StubGraph())


def test_engine_captures_at_a_keys_second_step(monkeypatch):
    """On the card the engine runs a key's first step eagerly, captures at
    its second and replays from then on.  Shown on the CPU with the stub in
    place of the graph (whose replays compute nothing: only the counts are
    checked)."""
    monkeypatch.setattr(te, "step_runner", _stub_runner)
    _, _, cfg, model = _models("tiny_real")
    eng = Engine(cfg, model, **ENGINE_KW)
    reqs = [Request(prompt=[5, 17, 42, 7], max_new_tokens=6,
                    sampler=SamplerParams(temperature=0.0))]
    eng.run(reqs)
    (prog,) = eng._steps.values()
    # steps: 1 from the prefill, then 5 decode steps: eager, capture
    # (the capture runs the step once in the stub), replays
    assert prog.run.warm and prog.run.captured
    assert eng.perf.n_captures == 1 and prog.run.replays == 4


def test_engine_keys_programs_by_features_alone(monkeypatch):
    """Log-probs are computed outside the step, so a request with
    n_probs runs the same program as one without; another feature set is
    another program."""
    monkeypatch.setattr(te, "step_runner", _stub_runner)
    _, _, cfg, model = _models("tiny_real")
    eng = Engine(cfg, model, **ENGINE_KW)
    greedy = SamplerParams(temperature=0.0)
    eng.run([Request(prompt=[5, 17, 42, 7], max_new_tokens=4, sampler=greedy),
             Request(prompt=[9, 8], max_new_tokens=4, sampler=greedy,
                     n_probs=2)])
    assert [p["features"] for p in eng.step_programs()] == [[]]
    eng.run([Request(prompt=[5, 6], max_new_tokens=3,
                     sampler=SamplerParams(temperature=0.7, seed=1))])
    assert len(eng.step_programs()) == 2
