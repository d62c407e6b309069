"""The port's speculative paths against the JAX package's on the CPU.

Draft-model speculation and lookahead through the engine (bf16 and q8
cache): tokens and ``n_spec_drafted`` / ``n_spec_accepted`` equal the JAX
engine's (``impl="pallas_interpret"``, as ``test_torch_engine.py`` runs it)
and the port's plain greedy engine's.  The standalone
``make_speculative_fn`` / ``make_lookup_fn`` / ``make_lookahead_fn`` give
the JAX functions' tokens, counts and per-round acceptances; the
vocab-translation case of ``tests/test_speculative.py`` is mirrored; the
attention under a mask override gives the JAX output within 1e-5; idle slots
of speculative and lookahead rounds leave a cached prefix alone.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime import speculative as jspec
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime import speculative as spec
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

JAX_IMPL = "pallas_interpret"
CFG_J, CFG = JAX_PRESETS["tiny"], PRESETS["tiny"]
ENGINE_KW = dict(n_slots=2, max_len=64, prefill_buckets=(16, 32))


@functools.lru_cache(maxsize=None)
def _pair(seed):
    """(JAX params, port model) on identical tiny weights."""
    params = jt.init_params(CFG_J, seed=seed)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), CFG)


@functools.lru_cache(maxsize=None)
def _served(seed):
    """The fused, unrolled tree on both sides (the standalone functions
    take the serving tree)."""
    params, _ = _pair(seed)
    pj = jt.unstack_layers(jt.fuse_projections(params, CFG_J), CFG_J)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), CFG)


def _workload():
    """Greedy requests, more than slots, one chunked past the largest
    bucket, a repetitive one (lookahead hits), and one with n_probs (its
    steps run the normal step, so the draft cache drifts)."""
    rng = np.random.default_rng(3)
    long = [int(x) for x in rng.integers(3, 256, 40)]
    return [
        dict(prompt=[5, 17, 42, 7], max_new_tokens=9),
        dict(prompt=[5, 9, 11, 5, 9, 11, 5, 9], max_new_tokens=12),
        dict(prompt=long, max_new_tokens=6),
        dict(prompt=[1, 2], max_new_tokens=4, n_probs=2),
        dict(prompt=[7, 7, 3], max_new_tokens=10),
    ]


@functools.lru_cache(maxsize=None)
def _jax_engine(q8, mode):
    params, _ = _pair(0)
    kw = {}
    if mode == "draft":
        kw = dict(draft=(CFG_J, _pair(5)[0]), k_draft=3)
    elif mode == "lookahead":
        kw = dict(lookahead=(3, 3))
    eng = JaxEngine(CFG_J, params, impl=JAX_IMPL, kv_quant=q8, **kw,
                    **ENGINE_KW)
    reqs = [JaxRequest(sampler=JaxSampler(temperature=0.0), **w)
            for w in _workload()]
    eng.run(reqs)
    return [r.output for r in reqs], eng.perf


def _port_engine(q8, mode, cuda_graph=True):
    kw = {}
    if mode == "draft":
        kw = dict(draft=(CFG, _pair(5)[1]), k_draft=3)
    elif mode == "lookahead":
        kw = dict(lookahead=(3, 3))
    eng = Engine(CFG, _pair(0)[1], kv_quant=q8, cuda_graph=cuda_graph, **kw,
                 **ENGINE_KW)
    reqs = [Request(sampler=SamplerParams(temperature=0.0), **w)
            for w in _workload()]
    eng.run(reqs)
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("mode", ["draft", "lookahead"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_engine_modes_match_jax_and_plain_greedy(q8, mode):
    want, perf = _jax_engine(q8, mode)
    got, eng = _port_engine(q8, mode)
    plain, _ = _port_engine(q8, "plain")
    assert got == want
    assert got == plain
    assert eng.perf.n_spec_drafted == perf.n_spec_drafted > 0
    assert eng.perf.n_spec_accepted == perf.n_spec_accepted
    assert eng.perf.n_decode_tokens == perf.n_decode_tokens
    assert eng.perf.n_spec_rounds > 0
    round_key = "speculative" if mode == "draft" else "lookahead"
    assert any(p["features"][0] == round_key for p in eng.step_programs())


def test_draft_with_own_weights_accepts_every_proposal():
    """The target as its own draft: every proposal is accepted, so a round
    emits k+1 tokens."""
    _, model = _pair(0)
    outs = []
    for kw in ({}, dict(draft=(CFG, model), k_draft=4)):
        eng = Engine(CFG, model, **kw, **ENGINE_KW)
        reqs = [Request(prompt=[5, 17, 42, 7], max_new_tokens=11,
                        sampler=SamplerParams(temperature=0.0))]
        eng.run(reqs)
        outs.append(reqs[0].output)
    assert outs[0] == outs[1]
    assert eng.perf.n_spec_accepted == eng.perf.n_spec_drafted > 0


def test_modes_are_exclusive_and_mesh_still_refused():
    """Draft and lookahead exclude each other, and a mesh refuses both
    with the JAX engine's message (its other mesh refusals are held in
    test_torch_parallel_engine.py)."""
    from vlut_tpu.parallel.sharding import make_mesh as jax_mesh

    params, model = _pair(0)
    with pytest.raises(ValueError, match="exclusive"):
        Engine(CFG, model, draft=(CFG, model), lookahead=(3, 3))
    # the refusal comes before the mesh is used: its shape is all it reads
    mesh = SimpleNamespace(shape={"dp": 1, "tp": 2})
    for kw, jkw in (({"draft": (CFG, model)},
                     {"draft": (CFG_J, params)}),
                    ({"lookahead": (3, 3)}, {"lookahead": (3, 3)})):
        with pytest.raises(ValueError) as want:
            JaxEngine(CFG_J, params, n_slots=2,
                      mesh=jax_mesh(dp=1, tp=2), **jkw)
        with pytest.raises(ValueError) as got:
            Engine(CFG, model, n_slots=2, mesh=mesh, **kw)
        assert str(got.value) == str(want.value) == (
            "mesh serving: speculative/lookahead decode modes are "
            "single-device for now")


def _prefill(params, cfg, prompts, max_len, jax_side):
    b, t = prompts.shape
    if jax_side:
        cache = jt.init_kv_cache(cfg, b, max_len=max_len, layout="layers")
        pos = jnp.tile(jnp.arange(t, dtype=jnp.int32), (b, 1))
        lg, cache = jt.forward(params, cfg, jnp.asarray(prompts, jnp.int32),
                               pos, cache, impl=JAX_IMPL,
                               logits_at=jnp.full((b,), t - 1, jnp.int32))
        return jnp.argmax(lg[:, 0, :cfg.vocab_size], -1).astype(
            jnp.int32), cache
    cache = tt.init_kv_cache(cfg, b, max_len)
    pos = torch.arange(t)[None].repeat(b, 1)
    lg, cache = tt.forward(params, cfg, torch.from_numpy(prompts).long(), pos,
                           cache, logits_at=torch.full((b,), t - 1))
    return torch.argmax(lg[:, 0, :cfg.vocab_size], -1), cache


PROMPTS = np.asarray([[5, 9, 11, 5, 9, 11, 5, 9], [3, 4, 5, 6, 3, 4, 5, 6]])


def _compare(j_out, p_out):
    """(out, cnt, accs) of both sides equal."""
    for a, b in zip(j_out[:3], p_out[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_speculative_fn_matches_jax():
    pj, pp = _served(0)
    dj, dp = _served(5)
    b, t = PROMPTS.shape
    last_j, cj = _prefill(pj, CFG_J, PROMPTS, 64, True)
    _, cdj = _prefill(dj, CFG_J, PROMPTS, 64, True)
    last_p, cp = _prefill(pp, CFG, PROMPTS, 64, False)
    _, cdp = _prefill(dp, CFG, PROMPTS, 64, False)
    assert last_p.tolist() == np.asarray(last_j).tolist()
    fj = jspec.make_speculative_fn(CFG_J, CFG_J, 3, 9, impl=JAX_IMPL)
    fp = spec.make_speculative_fn(CFG, CFG, 3, 9)
    _compare(fj(pj, dj, cj, cdj, last_j, jnp.full((b,), t, jnp.int32)),
             fp(pp, dp, cp, cdp, last_p, torch.full((b,), t)))


def test_lookup_fn_matches_jax():
    pj, pp = _served(0)
    b, t = PROMPTS.shape
    last_j, cj = _prefill(pj, CFG_J, PROMPTS, 64, True)
    last_p, cp = _prefill(pp, CFG, PROMPTS, 64, False)
    hist = np.zeros((b, 32), np.int64)
    hist[:, :t] = PROMPTS
    fj = jspec.make_lookup_fn(CFG_J, 3, 10, ngram=2, impl=JAX_IMPL)
    fp = spec.make_lookup_fn(CFG, 3, 10, ngram=2)
    j = fj(pj, cj, jnp.asarray(hist, jnp.int32), jnp.full((b,), t, jnp.int32),
           last_j, jnp.full((b,), t, jnp.int32))
    p = fp(pp, cp, torch.from_numpy(hist), torch.full((b,), t), last_p,
           torch.full((b,), t))
    _compare(j, p)
    assert int(p[2].sum()) > 0


def test_lookahead_fn_matches_jax():
    pj, pp = _served(0)
    b, t = PROMPTS.shape
    last_j, cj = _prefill(pj, CFG_J, PROMPTS, 96, True)
    last_p, cp = _prefill(pp, CFG, PROMPTS, 96, False)
    fj = jspec.make_lookahead_fn(CFG_J, 13, window=4, ngram=3, pool_size=16,
                                 impl=JAX_IMPL)
    fp = spec.make_lookahead_fn(CFG, 13, window=4, ngram=3, pool_size=16)
    _compare(fj(pj, cj, last_j, jnp.full((b,), t, jnp.int32)),
             fp(pp, cp, last_p, torch.full((b,), t)))


def _greedy(model, prompts, n_new):
    b, t = prompts.shape
    last, cache = _prefill(model, CFG, prompts, 64, False)
    toks = [last]
    for j in range(n_new - 1):
        lg, _ = tt.forward(model, CFG, toks[-1][:, None],
                           torch.full((b, 1), t + j), cache)
        toks.append(torch.argmax(lg[:, 0, :CFG.vocab_size], -1))
    return torch.stack(toks, 1)


def test_speculative_vocab_translation_matches_greedy():
    """A draft in a permuted vocabulary with holes: proposals translate
    through the piece-text maps, untranslatable ones self-reject, and the
    output still equals the target's greedy tokens (the port's mirror of
    tests/test_speculative.py's case)."""
    _, model = _served(0)
    v = CFG.vocab_size
    rng = np.random.default_rng(4)
    perm = rng.permutation(v)
    tree = model.tree()
    tree["embed"] = tree["embed"][torch.from_numpy(perm)]
    head = tree["lm_head"].clone()
    head[:, :v] = tree["lm_head"][:, torch.from_numpy(perm)]
    tree["lm_head"] = head
    draft = tt.TransformerLM(CFG, tree)
    pieces_t = [f"p{i}" for i in range(v)]
    pieces_d = [pieces_t[perm[j]] for j in range(v)]
    for j in (3, 77):
        pieces_d[j] = f"draft-only-{j}"
    d2t = spec.build_vocab_translation(pieces_d, pieces_t)
    t2d = spec.build_vocab_translation(pieces_t, pieces_d)
    np.testing.assert_array_equal(
        d2t, jspec.build_vocab_translation(pieces_d, pieces_t))
    assert d2t[3] == -1 and (d2t >= -1).all()
    prompts = rng.integers(0, v, (2, 5))
    n_new, k = 8, 3
    ref = _greedy(model, prompts, n_new)
    b, t = prompts.shape
    last, cache_t = _prefill(model, CFG, prompts, 64, False)
    cache_d = tt.init_kv_cache(CFG, b, 64)
    prompts_d = torch.clamp(torch.from_numpy(t2d).long()[
        torch.from_numpy(prompts)], min=0)
    tt.forward(draft, CFG, prompts_d, torch.arange(t)[None].repeat(b, 1),
               cache_d)
    fn = spec.make_speculative_fn(CFG, CFG, k, n_new - 1,
                                  vocab_map=(d2t, t2d))
    out, cnt, accs, _, _ = fn(model, draft, cache_t, cache_d, last,
                              torch.full((b,), t))
    assert (cnt >= n_new - 1).all()
    got = torch.cat([last[:, None], out[:, :n_new - 1]], dim=1)
    assert torch.equal(got, ref)
    assert int(accs.sum()) > 0
    # the engine with the same translation gives plain greedy too
    eng = Engine(CFG, model, draft=(CFG, draft, (d2t, t2d)), k_draft=k,
                 **ENGINE_KW)
    reqs = [Request(prompt=[int(x) for x in row], max_new_tokens=n_new,
                    sampler=SamplerParams(temperature=0.0))
            for row in prompts]
    eng.run(reqs)
    assert [r.output for r in reqs] == ref.tolist()
    assert eng.perf.n_spec_accepted > 0


@pytest.mark.parametrize("s", [48, 1100], ids=["dense", "chunked"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_attention_mask_override_matches_jax(q8, s):
    """The attention under a (B, T, S) mask override, dense and past
    ATTN_CHUNK (online softmax), with and without deferred int8 scales:
    within 1e-5 of the JAX function's output."""
    b, t, h, hkv, hd = 2, 7, 4, 2, 32
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    ks = vs = None
    if q8:
        k = rng.integers(-127, 128, k.shape).astype(np.int8)
        v = rng.integers(-127, 128, v.shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (b, s, hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (b, s, hkv)).astype(np.float32)
    mask = rng.random((b, t, s)) < 0.3
    mask[:, :, 0] = True
    qpos = np.tile(np.arange(t) + 5, (b, 1))
    kpos = np.tile(np.arange(s), (b, 1))
    want = jt._attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), hd, mask_override=jnp.asarray(mask),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    t_ = (lambda a: None if a is None else torch.from_numpy(a))
    got = tt._attention(t_(q), t_(k), t_(v), t_(qpos), t_(kpos), hd,
                        k_scale=t_(ks), v_scale=t_(vs),
                        mask_override=t_(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_attn_mask_forward_matches_jax():
    """A lookahead-style (B, T, S) mask through the whole forward over the
    cache (bf16 and q8): the JAX forward's logits within the relative 2e-2
    of test_torch_model.py's comparison and the same argmax (the int8
    activation codes of a T-row projection round apart, as in every
    forward comparison), and the causal mask given as an override equals
    the forward without one bit for bit."""
    pj, pp = _served(0)
    b, t, s = 2, 7, 48
    t_total, _, m_small, _ = spec._la_structure(2, 3)
    assert t_total == t
    rng = np.random.default_rng(1)
    prompts = rng.integers(3, 256, (b, 12))
    seq = rng.integers(3, 256, (b, t))
    lengths = np.asarray([12, 9])
    s_idx = np.arange(s)
    rel = s_idx[None, None, :] - lengths[:, None, None]
    block = m_small[np.arange(t)[None, :, None], np.clip(rel, 0, t - 1)]
    mask = (s_idx[None, None, :] < lengths[:, None, None]) | (
        (rel >= 0) & (rel < t) & block)
    pos = lengths[:, None] + np.asarray([0, 1, 2, 1, 2, 1, 2])[None, :]
    causal = s_idx[None, None, :] <= (lengths[:, None, None]
                                      + np.arange(t)[None, :, None])
    p0 = np.tile(np.arange(12), (b, 1))
    for q8 in (False, True):
        def port(pos_, mask_):
            cp = tt.init_kv_cache(CFG, b, s, quantized=q8)
            tt.forward(pp, CFG, torch.from_numpy(prompts),
                       torch.from_numpy(p0), cp)
            return tt.forward(
                pp, CFG, torch.from_numpy(seq), torch.from_numpy(pos_), cp,
                attn_mask=None if mask_ is None else torch.from_numpy(mask_))[0]

        cj = jt.init_kv_cache(CFG_J, b, max_len=s, layout="layers",
                              quantized=q8)
        _, cj = jt.forward(pj, CFG_J, jnp.asarray(prompts, jnp.int32),
                           jnp.asarray(p0, jnp.int32), cj, impl=JAX_IMPL)
        lj, _ = jt.forward(pj, CFG_J, jnp.asarray(seq, jnp.int32),
                           jnp.asarray(pos, jnp.int32), cj, impl=JAX_IMPL,
                           attn_mask=jnp.asarray(mask))
        lp = port(pos, mask)
        want = np.asarray(lj)
        assert np.abs(lp.numpy() - want).max() <= 2e-2 * np.abs(want).max()
        v = CFG.vocab_size
        np.testing.assert_array_equal(lp[..., :v].argmax(-1).numpy(),
                                      want[..., :v].argmax(-1))
        contiguous = lengths[:, None] + np.arange(t)[None, :]
        assert torch.equal(port(contiguous, causal), port(contiguous, None))


@pytest.mark.parametrize("mode", ["draft", "lookahead"])
def test_idle_slot_rounds_do_not_corrupt_cached_prefix(mode):
    """An idle slot in a speculative round parks at the scratch row; in a
    lookahead round at ``max_len - T - 1``, with its history cut below the
    round's rows.  The rows of the prefix it keeps are untouched."""
    _, model = _pair(0)
    kw = (dict(draft=(CFG, model), k_draft=3) if mode == "draft"
          else dict(lookahead=(4, 3)))
    eng = Engine(CFG, model, n_slots=2, max_len=32, **kw)
    eng.run([Request(prompt=list(range(3, 27)), max_new_tokens=2,
                     sampler=SamplerParams(temperature=0.0))])
    eng.fork_slot(0, 1)
    before = [a[1].clone() for arrs in eng.cache.values() for a in arrs]
    eng.run([Request(prompt=[5, 17, 42], max_new_tokens=6,
                     sampler=SamplerParams(temperature=0.0))])
    assert eng.perf.n_spec_rounds > 0
    kept = len(eng.slots[1].history)
    if mode == "lookahead":
        assert kept == 32 - 11 - 1
    after = [a[1] for arrs in eng.cache.values() for a in arrs]
    assert all(torch.equal(x[:kept], y[:kept]) for x, y in zip(before, after))


@pytest.mark.parametrize("flags", [
    ["--prompt-lookup", "3"], ["--lookahead", "--lookahead-window", "4"],
    ["--draft-model", "{m}", "--draft-k", "2"]], ids=["lookup", "lookahead",
                                                      "draft"])
def test_cli_speculative_generate_equals_plain(flags, capsys):
    """``generate`` through prompt lookup, lookahead and a draft model
    prints the text of plain greedy ``generate`` on tiny_real."""
    import pathlib

    from vlut_tpu_torch import cli

    model = str(pathlib.Path(__file__).parent / "fixtures" / "tiny_real")
    base = ["generate", "--model", model, "-p", "The little model reads",
            "-n", "12", "--temp", "0", "--ctx", "128", "--device", "cpu"]
    cli.main(base)
    plain = capsys.readouterr().out
    cli.main(base + [f.replace("{m}", model) for f in flags])
    assert capsys.readouterr().out == plain
