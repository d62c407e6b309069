"""The port's RWKV7, arwkv7 and RWKV6 (``vlut_tpu_torch/models/rwkv.py``)
against the JAX package on the CPU: the WKV recurrences on random inputs,
and each family's forward (stateless and state-carrying) and greedy
``generate`` loop on the checkpoint the JAX converter writes in
``tests/test_rwkv7.py`` (HF-named tensors from numpy; no HF
implementation of RWKV7 exists).  float32 throughout: logits within 2e-2
of the largest (exp, tanh, sigmoid round apart from XLA's), greedy tokens
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_rwkv7
from _torch_recurrent import close, family_case, jax_family_generate
from vlut_tpu.models import rwkv as jr
from vlut_tpu_torch.cli import family_generate
from vlut_tpu_torch.models import rwkv as pr

CASES = {
    "rwkv7": (test_rwkv7.test_rwkv7_forward_and_state_carry, "forward"),
    "arwkv7": (test_rwkv7.test_arwkv7_forward_and_state_carry, "forward"),
    "rwkv6": (test_rwkv7.test_rwkv6_forward_and_state_carry, "forward6"),
}


def _inputs(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * 0.5
            for _ in range(n)]


def test_wkv7_scan_matches_jax():
    r, k, v, a, b = _inputs(1, (2, 6, 3, 8), 5)
    w = np.random.default_rng(2).uniform(0.5, 0.99, r.shape).astype(
        np.float32)
    S0 = _inputs(3, (2, 3, 8, 8), 1)[0] * 0.2
    want, S_want = jr._wkv7_scan(*(jnp.asarray(x) for x in
                                   (r, w, k, v, a, b, S0)))
    got, S = pr._wkv7_scan(*(torch.from_numpy(x) for x in
                             (r, w, k, v, a, b, S0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["wkv6", "gla"])
def test_wkv6_and_gla_scans_match_jax(kind):
    r, k, v = _inputs(4, (2, 5, 3, 8), 3)
    w = np.random.default_rng(5).uniform(0.5, 0.99, r.shape).astype(
        np.float32)
    S0 = _inputs(6, (2, 3, 8, 8), 1)[0] * 0.2
    if kind == "wkv6":
        u = _inputs(7, (3, 8), 1)[0]
        want = jr._wkv6_scan(*(jnp.asarray(x) for x in (r, w, k, v, u, S0)))
        got = pr._wkv6_scan(*(torch.from_numpy(x)
                              for x in (r, w, k, v, u, S0)))
    else:
        want = jr._gla_scan(*(jnp.asarray(x) for x in (r, w, k, v, S0)),
                            8 ** -0.5)
        got = pr._gla_scan(*(torch.from_numpy(x) for x in (r, w, k, v, S0)),
                           8 ** -0.5)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_rwkv_family_matches_jax(name, tmp_path, monkeypatch):
    """Stateless logits, then a split prefill whose state carries into the
    second part, and the greedy ``generate`` loop, against JAX's."""
    test_fn, fname = CASES[name]
    fj, fp = getattr(jr, fname), getattr(pr, fname)
    cfg_j, pj, cfg, model = family_case(
        test_fn, 0, tmp_path, monkeypatch,
        lambda p, c, t: fj(p, c, t)[0], lambda m, c, t: fp(m, c, t)[0],
        zoo=name)
    assert cfg.arch == name
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 10))
    st_j, st = jr.init_state(cfg_j, 2), pr.init_state(cfg, 2)
    _, st_j = fj(pj, cfg_j, jnp.asarray(toks[:, :6], jnp.int32), st_j)
    _, st = fp(model, cfg, torch.from_numpy(toks[:, :6]), st)
    for k in st:
        want_k = np.asarray(st_j[k])
        np.testing.assert_allclose(st[k].numpy(), want_k, rtol=1e-4,
                                   atol=1e-5 * np.abs(want_k).max())
    want, _ = fj(pj, cfg_j, jnp.asarray(toks[:, 6:], jnp.int32), st_j)
    got, _ = fp(model, cfg, torch.from_numpy(toks[:, 6:]), st)
    close(got, want, "carried")
    full, _ = fp(model, cfg, torch.from_numpy(toks))
    close(got, full[:, 6:].numpy(), "carried vs full", tol=1e-4)
    ids = [int(t) for t in toks[0, :5]]
    assert family_generate(model, cfg, ids, 8) == jax_family_generate(
        pj, cfg_j, ids, 8)
