"""The port's sampler chain against the JAX package's on the CPU.

Every deterministic transform takes the same numpy logits and parameters
in both packages and must give the same float32 logits, bit for bit
(masked entries are -1e30 in both).  The draws take their noise from
torch generators (Philox) where JAX uses threefry, so they are held to
their distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.runtime import sampling as js
from vlut_tpu_torch.runtime import sampling as ts

torch.set_num_threads(1)

B, V, P = 4, 96, 24


def _logits(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    x[1, 5] = x[1, 7] = x[1].max() + 1.0  # a tie at the top
    return x


def _window(seed=1):
    """A recent-token window with repeats (so DRY finds sequences) and
    invalid leading entries."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 12, (B, P)).astype(np.int32)
    base[:, P // 2:] = base[:, : P - P // 2]  # repeat the first half
    valid = np.ones((B, P), bool)
    valid[0, :5] = False
    valid[3, :] = np.arange(P) >= P - 6
    return base, valid


SETTINGS = [
    js.SamplerParams(temperature=0.8, top_k=5, top_p=0.9, min_p=0.05,
                     typical_p=0.7, top_n_sigma=1.5, repeat_penalty=1.3,
                     presence_penalty=0.4, frequency_penalty=0.2,
                     dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2,
                     logit_bias=((3, 5.0), (7, -2.5), (3, 1.0)), seed=3,
                     xtc_p=1.0, xtc_t=0.05, dynatemp_range=0.5,
                     dynatemp_exponent=1.3),
    js.SamplerParams(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
                     typical_p=1.0, seed=1),
    js.SamplerParams(temperature=1.2, top_k=40, top_p=0.5, min_p=0.2,
                     typical_p=0.95, top_n_sigma=0.5, repeat_penalty=0.8,
                     dry_multiplier=2.0, dry_allowed_length=1,
                     logit_bias=((0, 100.0),), xtc_p=0.0, seed=2),
    js.SamplerParams(temperature=0.5, top_k=1, mirostat_tau=3.0,
                     mirostat_eta=0.2, penalty_last_n=8, seed=4),
]


def _params():
    jp = js.stack_params(SETTINGS)
    tp = ts.stack_params([ts.SamplerParams(**dataclasses.asdict(s))
                          for s in SETTINGS])
    return jp, tp


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stack_params_and_features_match():
    jp, tp = _params()
    assert set(jp) == set(tp)
    for k in jp:
        _same(tp[k], jp[k])
    tset = [ts.SamplerParams(**dataclasses.asdict(s)) for s in SETTINGS]
    for i in range(len(SETTINGS)):
        assert ts.features_of(tset[i:i + 1]) == js.features_of(
            SETTINGS[i:i + 1])
    assert ts.features_of(tset) == js.features_of(SETTINGS)


@pytest.mark.parametrize("name", [
    "apply_logit_bias", "apply_top_k", "apply_top_p", "apply_min_p",
    "apply_typical", "apply_top_n_sigma", "apply_temperature"])
def test_transform_matches_jax(name):
    """Bit-exact, except the rows with a dynamic temperature: it divides by
    the entropy of a float32 softmax, and XLA's exp and sums round
    differently from PyTorch's by an ulp, so those rows are held to rtol
    2e-6 (the masks of top-p, min-p and typical, which compare softmax
    values with a threshold, came out identical)."""
    jp, tp = _params()
    arg = {"apply_top_k": "top_k", "apply_top_p": "top_p",
           "apply_min_p": "min_p", "apply_typical": "typical_p",
           "apply_top_n_sigma": "top_n_sigma"}.get(name)
    for seed in range(3):
        x = _logits(seed)
        jf = jax.jit(lambda l, p: getattr(js, name)(l, p[arg] if arg else p))
        want = jf(jnp.asarray(x), jp)
        got = getattr(ts, name)(torch.from_numpy(x), tp[arg] if arg else tp)
        if name == "apply_temperature":
            dyn = tp["dynatemp_range"].numpy() > 0
            np.testing.assert_allclose(got.numpy()[dyn],
                                       np.asarray(want)[dyn], rtol=2e-6)
            got, want = got[~torch.from_numpy(dyn)], np.asarray(want)[~dyn]
        _same(got, want)


@pytest.mark.parametrize("name", ["apply_penalties", "apply_dry"])
def test_window_transform_matches_jax(name):
    jp, tp = _params()
    toks, valid = _window()
    x = _logits(5)
    jf = jax.jit(lambda l, t, v, p: getattr(js, name)(l, t, v, p))
    want = jf(jnp.asarray(x), jnp.asarray(toks), jnp.asarray(valid), jp)
    got = getattr(ts, name)(torch.from_numpy(x), torch.from_numpy(toks),
                            torch.from_numpy(valid), tp)
    _same(got, want)
    assert not np.array_equal(np.asarray(want), x)  # the transform acted


def test_dry_sequence_breakers_match_jax():
    jp, tp = _params()
    toks, valid = _window(2)
    x = _logits(6)
    brk = np.asarray([3, 4], np.int32)
    want = jax.jit(js.apply_dry)(jnp.asarray(x), jnp.asarray(toks),
                                 jnp.asarray(valid), jp, jnp.asarray(brk))
    got = ts.apply_dry(torch.from_numpy(x), torch.from_numpy(toks),
                       torch.from_numpy(valid), tp, torch.from_numpy(brk))
    _same(got, want)


@pytest.mark.parametrize("xtc_p", [0.0, 1.0])
def test_xtc_matches_jax_when_the_roll_is_decided(xtc_p):
    """xtc_p 0 never fires and 1 always does, whatever the roll."""
    jp, tp = _params()
    jp = dict(jp, xtc_p=jnp.full((B,), xtc_p, jnp.float32))
    tp = dict(tp, xtc_p=torch.full((B,), xtc_p))
    x = _logits(7)
    want = js.apply_xtc(jnp.asarray(x), jp["xtc_p"], jp["xtc_t"],
                        jax.random.PRNGKey(0))
    roll = torch.rand((B, 1), generator=torch.Generator().manual_seed(0))
    got = ts.apply_xtc(torch.from_numpy(x), tp["xtc_p"], tp["xtc_t"], roll)
    _same(got, want)


def test_greedy_chain_matches_jax():
    """Logit bias + penalties + DRY, then greedy (every row temperature 0):
    the whole deterministic chain of sample_ex, tokens equal."""
    settings = [dataclasses.replace(s, temperature=0.0, mirostat_tau=0.0)
                for s in SETTINGS]
    jp = js.stack_params(settings)
    tp = ts.stack_params([ts.SamplerParams(**dataclasses.asdict(s))
                          for s in settings])
    toks, valid = _window(3)
    feats = js.features_of(settings)
    for seed in range(4):
        x = _logits(10 + seed)
        want, _ = js.sample_ex(jnp.asarray(x), jp, jax.random.PRNGKey(0),
                               js.init_state(B), jnp.asarray(toks),
                               jnp.asarray(valid), features=feats)
        got, _ = ts.sample_ex(torch.from_numpy(x), tp, None,
                              ts.init_state(B), torch.from_numpy(toks),
                              torch.from_numpy(valid), features=feats)
        _same(got, want)


def test_truncated_draws_follow_the_kept_distribution():
    """top-k 3 at temperature 0.7: draws land only on the three kept tokens,
    with frequencies of softmax(kept / 0.7) within four standard
    deviations."""
    x = torch.tensor([[2.0, 1.5, 1.0, 0.5, -1.0, -3.0]])
    p = ts.stack_params([ts.SamplerParams(temperature=0.7, top_k=3, seed=9)])
    gens = ts.row_generators(p, seed=0, device="cpu")
    n = 3000
    feats = ("top_k", "sampling")
    draws = torch.stack([ts.sample(x, p, gens, feats) for _ in range(n)])
    freq = torch.bincount(draws[:, 0], minlength=6).double() / n
    want = torch.softmax(torch.tensor([2.0, 1.5, 1.0]).double() / 0.7, 0)
    assert freq[3:].sum() == 0
    assert ((freq[:3] - want).abs() <= 4 * (want * (1 - want) / n).sqrt()).all()


def test_mirostat_updates_mu_as_jax():
    """Mirostat v2 on a peaked row: the kept set is the argmax alone, so the
    draw is decided and mu follows the JAX update exactly."""
    s = js.SamplerParams(temperature=1.0, mirostat_tau=0.5, mirostat_eta=0.3)
    x = np.asarray([[9.0, 0.0, -1.0, -2.0]], np.float32)
    jp = js.stack_params([s])
    tp = ts.stack_params([ts.SamplerParams(**dataclasses.asdict(s))])
    jstate, tstate = js.init_state(1), ts.init_state(1)
    gens = ts.row_generators(tp, seed=0, device="cpu")
    for _ in range(3):
        jt, jstate = js.sample_ex(jnp.asarray(x), jp, jax.random.PRNGKey(1),
                                  jstate, features=("sampling", "mirostat"))
        tt, tstate = ts.sample_ex(torch.from_numpy(x), tp, gens, tstate,
                                  features=("sampling", "mirostat"))
        _same(tt, jt)
        np.testing.assert_allclose(tstate["mu"].numpy(),
                                   np.asarray(jstate["mu"]), rtol=1e-6)
