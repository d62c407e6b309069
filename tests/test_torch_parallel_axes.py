"""The port's expert-, sequence- and pipeline-parallel forwards against the
JAX package's ``make_forward_ep`` / ``make_forward_sp`` / ``make_forward_pp``
on the CPU.

The port runs in gloo ranks (``tests/_torch_parallel.py``: ep and sp over
4, pp over 2, one spawn per world size); JAX runs in this process on its
virtual CPU mesh with ``impl="xla"``, as ``tests/test_parallel.py:87-157``
does, on the same weights and inputs, at that file's tolerances: ep 2e-4,
sp and pp 5e-4 (rtol and atol), with equal argmax.  Each forward is also
held against the port's single-device forward at the same tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vlut_tpu.config import PRESETS
from vlut_tpu.models.transformer import init_params
from vlut_tpu.parallel.pipeline import make_forward_pp
from vlut_tpu.parallel.spmd import make_forward_ep, make_forward_sp
from vlut_tpu_torch.config import PRESETS as TORCH_PRESETS
from vlut_tpu_torch.convert.from_jax import _convert
from vlut_tpu_torch.models.transformer import TransformerLM, forward
from vlut_tpu_torch.parallel.distributed import launch

# (preset, batch, tokens, rng seed) of tests/test_parallel.py's cases
EP = ("tiny_moe", 2, 8, 0)
SP = ("tiny", 2, 16, 1)
PP = ("tiny", 4, 8, 2)


@functools.cache
def _params(preset):
    params = init_params(PRESETS[preset], seed=0)
    return params, _convert(jax.tree.map(np.asarray, params))


def _inputs(case):
    preset, b, t, seed = case
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, PRESETS[preset].vocab_size, (b, t))
    return tokens, np.tile(np.arange(t), (b, 1))


def _jax(kind):
    case = {"ep": EP, "sp": SP, "pp": PP}[kind]
    preset = case[0]
    cfg = PRESETS[preset]
    params, _ = _params(preset)
    tokens, pos = (jnp.asarray(a, jnp.int32) for a in _inputs(case))
    n = 2 if kind == "pp" else 4
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), (kind,))
    fwd = {"ep": lambda: make_forward_ep(cfg, mesh, params, impl="xla"),
           "sp": lambda: make_forward_sp(cfg, mesh, impl="xla"),
           "pp": lambda: make_forward_pp(cfg, mesh, params, n_microbatches=2,
                                         impl="xla")}[kind]()
    return np.asarray(jax.jit(fwd)(params, tokens, pos))


def _single(kind):
    case = {"ep": EP, "sp": SP, "pp": PP}[kind]
    model = TransformerLM(TORCH_PRESETS[case[0]], _params(case[0])[1])
    tokens, pos = (torch.as_tensor(a) for a in _inputs(case))
    return forward(model, model.cfg, tokens, pos, None)[0].numpy()


# tests/test_ring_attention.py's variants of the ring against the dense
# attention (sp 4, B 2, T 16, 4 heads over 2 of 8), and a ragged row
RING = {
    "causal": {},
    "swa": {"window": 5},
    "chunked": {"window": 4, "chunked_window": True},
    "alibi": {"alibi": np.geomspace(1.0, 1 / 64, 4).astype(np.float32)},
    "sinks": {"sinks": np.linspace(-1.0, 1.0, 4).astype(np.float32)},
    "softcap": {"softcap": 30.0},
    "bidir": {"causal": False},
    "bidir_symmetric_swa": {"causal": False, "window": 5},
    "scale": {"scale": 0.31},
    "ragged": {},
    "window_zero": {"window": 0},
}


def _ring_inputs(i, name):
    rng = np.random.default_rng(100 + i)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    pos = np.tile(np.arange(16, dtype=np.int64), (2, 1))
    if name == "ragged":  # a shard of padding only (position -1)
        pos[1, 16 - 5:] = -1
    return q, k, v, pos


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ring = [(name, kw, *_ring_inputs(i, name))
            for i, (name, kw) in enumerate(sorted(RING.items()))]
    groups = {
        4: [("ep_forward", (_params("tiny_moe")[1], *_inputs(EP))),
            ("sp_forward", (_params("tiny")[1], *_inputs(SP))),
            ("ring_cases", (ring,))],
        2: [("pp_forward", (_params("tiny")[1], *_inputs(PP)))],
    }
    return {n: launch("_torch_parallel:run_cases", (cases,), nprocs=n,
                      timeout=240, folder=tmp_path_factory.mktemp(f"w{n}"))
            for n, cases in groups.items()}


def _port(ranks, kind):
    if kind == "ep":
        return [r[0] for r in ranks[4]]
    if kind == "sp":
        return [r[1] for r in ranks[4]]
    return [r[0] for r in ranks[2]]


def _assembled(kind, per_rank):
    if kind != "sp":
        for r in per_rank[1:]:  # every rank holds the whole logits
            np.testing.assert_array_equal(r["logits"], per_rank[0]["logits"])
        return per_rank[0]["logits"]
    return np.concatenate([r["logits"] for r in
                           sorted(per_rank, key=lambda r: r["cols"])], 1)


TOL = {"ep": 2e-4, "sp": 5e-4, "pp": 5e-4}


@pytest.mark.parametrize("kind", ["ep", "sp", "pp"])
def test_matches_jax(ranks, kind):
    got = _assembled(kind, _port(ranks, kind))
    want = _jax(kind)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[kind], atol=TOL[kind])
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("kind", ["ep", "sp", "pp"])
def test_matches_single_device(ranks, kind):
    got = _assembled(kind, _port(ranks, kind))
    ref = _single(kind)
    np.testing.assert_allclose(got, ref, rtol=TOL[kind], atol=TOL[kind])
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_shards_and_collectives(ranks):
    """Each rank holds its share (1 of tiny_moe's 4 experts per rank, 1 of
    tiny's 2 layers per stage) and issues the JAX bodies' collectives: the
    expert combine's psum per layer; per layer the ring's sp steps of
    (K, V, positions) permutes (and nothing gathered); per schedule step
    one hand-off, then the outputs' psum."""
    cfg_moe, cfg = PRESETS["tiny_moe"], PRESETS["tiny"]
    for r in _port(ranks, "ep"):
        assert r["experts"] == cfg_moe.n_experts // 4
        assert r["census"] == {"all-reduce": {
            "count": cfg_moe.n_layers,
            "bytes": cfg_moe.n_layers * 4 * EP[1] * EP[2] * cfg_moe.d_model}}
    for r in _port(ranks, "sp"):
        assert set(r["census"]) == {"collective-permute"}
        assert r["census"]["collective-permute"]["count"] == (
            cfg.n_layers * 4 * 3)
    for r in _port(ranks, "pp"):
        assert r["layers"] == cfg.n_layers // 2
        c = r["census"]
        assert c["collective-permute"]["count"] == 2 + 2 - 1
        assert c["all-reduce"]["count"] == 1


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_matches_dense(ranks, name):
    """The ring's output, each rank's T slice, against JAX's dense
    ``_attention`` of the whole context at ``tests/test_ring_attention.py``'s
    tolerance (rtol 2e-5, atol 2e-6): masks from the global positions;
    a pad row is invisible, window 0 is no window."""
    from vlut_tpu.models.transformer import _attention

    i = sorted(RING).index(name)
    q, k, v, pos = _ring_inputs(i, name)
    kw = dict(RING[name])
    if "window" in kw:
        kw["window"] = (jnp.asarray(kw["window"], jnp.int32) if kw["window"]
                        else None)
    want = np.asarray(_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(pos, jnp.int32),
                                 jnp.asarray(pos, jnp.int32), 8, **kw))
    got = np.zeros_like(want)
    for r in ranks[4]:
        lo, hi = r[2]["cols"]
        got[:, lo:hi] = r[2]["out"][name]
    real = pos >= 0
    np.testing.assert_allclose(got[real], want[real], rtol=2e-5, atol=2e-6)
