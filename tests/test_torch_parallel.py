"""The port's tensor-parallel forward against the JAX package's on the CPU.

The port runs in gloo ranks (``tests/_torch_parallel.py``, one spawn per
world size through a module fixture); JAX runs ``make_forward_tp`` in this
process on its 8-device virtual CPU mesh (``tests/conftest.py``) with
``impl="xla"``, as ``tests/test_parallel.py`` does, on the same weights.

Tolerances: against JAX at the same mesh shape, 1e-4 of the largest logit
with equal argmax (both sum the same partials: the K-sharded products are
exact, the sub-norm statistics sum in the same halves); against the port's
single-device forward, JAX's own ``rtol=atol=0.05`` with equal argmax
(``tests/test_parallel.py:55-64``: the shards' norm sums round apart and
the single device quantizes its small-M rows in the kernels' way).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from vlut_tpu.config import PRESETS
from vlut_tpu.models.transformer import init_kv_cache, init_params
from vlut_tpu.parallel.sharding import cache_specs, make_mesh, shard_params
from vlut_tpu.parallel.spmd import make_forward_tp
from vlut_tpu_torch.convert.from_jax import _convert
from vlut_tpu_torch.parallel.distributed import launch

B, T = 4, 6
TP_CASES = [("tiny", 1, 2), ("tiny", 4, 2), ("tiny_bitnet", 1, 4),
            ("tiny_bitnet", 2, 4)]


@functools.cache
def _params(preset):
    params = init_params(PRESETS[preset], seed=0)
    return params, _convert(jax.tree.map(np.asarray, params))


def _inputs(preset, t=T):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, PRESETS[preset].vocab_size, (B, t))
    pos = np.tile(np.arange(t), (B, 1))
    return tokens, pos, np.full((B,), t - 1)


def _jax_tp(preset, dp, tp, t=T):
    cfg = PRESETS[preset]
    params, _ = _params(preset)
    tokens, pos, at = _inputs(preset, t)
    mesh = make_mesh(dp=dp, tp=tp)
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        init_kv_cache(cfg, B, max_len=32, dtype=jnp.float32), cache_specs())
    fwd = jax.jit(make_forward_tp(cfg, mesh, params_tree=params, impl="xla"))
    got, _ = fwd(shard_params(params, mesh, cfg), cache,
                 jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32),
                 jnp.asarray(at, jnp.int32))
    return np.asarray(got)


def _tp_args(preset, dp, tp, census=False):
    return ("tp_forward", (preset, _params(preset)[1], dp, tp,
                           *_inputs(preset), census))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world size's cases, spawned once: {world: [rank results]}."""
    groups = {
        2: [_tp_args("tiny", 1, 2, census=True),
            ("single_forward", ("tiny", _params("tiny")[1], *_inputs("tiny"))),
            ("sharded_matmul", (8, 512, 256, 0)),
            ("sharded_matmul", (64, 1024, 384, 1))],
        4: [_tp_args("tiny_bitnet", 1, 4, census=True),
            ("single_forward", ("tiny_bitnet", _params("tiny_bitnet")[1],
                                *_inputs("tiny_bitnet")))],
        8: [_tp_args("tiny", 4, 2), _tp_args("tiny_bitnet", 2, 4)],
    }
    return {n: launch("_torch_parallel:run_cases", (cases,), nprocs=n,
                      timeout=240, folder=tmp_path_factory.mktemp(f"w{n}"))
            for n, cases in groups.items()}


def _case(ranks, preset, dp, tp):
    n = dp * tp
    idx = {2: {("tiny", 1, 2): 0}, 4: {("tiny_bitnet", 1, 4): 0},
           8: {("tiny", 4, 2): 0, ("tiny_bitnet", 2, 4): 1}}[n]
    return [r[idx[(preset, dp, tp)]] for r in ranks[n]]


def _gathered(per_rank):
    """The rows of every dp group, from its tp rank 0 (every tp rank of a
    group holds the same, whole-vocabulary rows)."""
    out = np.zeros((B,) + per_rank[0]["logits"].shape[1:], np.float32)
    for r in per_rank:
        lo, hi = r["rows"]
        out[lo:hi] = r["logits"]
    return out


@pytest.mark.parametrize("preset,dp,tp", TP_CASES)
def test_tp_matches_jax_tp(ranks, preset, dp, tp):
    per_rank = _case(ranks, preset, dp, tp)
    # the tp ranks of a dp group agree to the bit
    for r in per_rank:
        mate = next(o for o in per_rank if o["rows"] == r["rows"])
        np.testing.assert_array_equal(r["logits"], mate["logits"])
    got = _gathered(per_rank)
    want = _jax_tp(preset, dp, tp)
    assert got.shape == want.shape
    tol = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("preset,dp,tp", TP_CASES)
def test_tp_matches_single_device(ranks, preset, dp, tp):
    got = _gathered(_case(ranks, preset, dp, tp))
    world = {"tiny": 2, "tiny_bitnet": 4}[preset]
    ref = ranks[world][0][1]
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_cache_sharding_layout(ranks):
    """The cache's spec is JAX's (None, "dp", None, "tp", None): each rank
    holds its dp group's slots and its tp share of the KV heads."""
    cfg = PRESETS["tiny_bitnet"]
    for r in _case(ranks, "tiny_bitnet", 2, 4):
        l, b, s, h, hd = r["cache_k"]
        assert (l, b, s, h) == (cfg.n_layers, B // 2, 32,
                                cfg.n_kv_heads // 4)
    coords = sorted((r["coords"]["dp"], r["coords"]["tp"])
                    for r in _case(ranks, "tiny_bitnet", 2, 4))
    assert coords == [(d, t) for d in range(2) for t in range(4)]


def test_census_counts_what_the_code_predicts(ranks):
    """One tp forward's collectives: per layer the psums after wo and
    w_down and their pmax scales, bitnet's two sub-norm statistics, and
    one logits gather; bytes from the shapes."""
    for preset, world, dp, tp in (("tiny", 2, 1, 2),
                                  ("tiny_bitnet", 4, 1, 4)):
        cfg = PRESETS[preset]
        m = B * T
        d_p = -(-cfg.d_model // 128) * 128
        per_layer = 4 + (2 if cfg.use_subnorms else 0)
        reduce_bytes = cfg.n_layers * (
            2 * (4 * m + 4 * m * d_p)
            + (2 * 4 * m if cfg.use_subnorms else 0))
        vocab_p = ranks[world][0][1].shape[-1]
        want = {"all-reduce": {"count": cfg.n_layers * per_layer,
                               "bytes": reduce_bytes},
                "all-gather": {"count": 1, "bytes": 4 * B * vocab_p}}
        for r in ranks[world]:
            assert r[0]["census"] == want, (preset, r[0]["census"])


@pytest.mark.parametrize("case", [2, 3], ids=["M8", "M64"])
def test_k_sharded_route_is_exact(ranks, case):
    """Under a K-sharded reduce, M <= 64 takes the global scale and #3 with
    unit scales: bit-equal to the unsharded product, and never #4 (whose
    local max gives other codes on these shards)."""
    for r in ranks[2]:
        out = r[case]
        np.testing.assert_array_equal(out["got"], out["want"])
        assert out["fused_quant_calls"] == []
        assert not np.array_equal(out["local_max_route"], out["want"])
