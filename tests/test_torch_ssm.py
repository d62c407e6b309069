"""The port's Mamba and Mamba2 (``vlut_tpu_torch/models/ssm.py``) against
the JAX package's ``vlut_tpu/models/ssm.py`` on the CPU.

The scans reproduce ``jax.lax.associative_scan``'s recursion with its
combine, whose ``b1*a2 + b2`` XLA's CPU fuses into one multiply-add, as
``torch.addcmul`` does: bit for bit.  The forwards run the same weights
(the JAX ``init_params`` draws, or a Mamba2 checkpoint the JAX converter
wrote from an HF model built in code); the JAX side's ternary products go
through the interpreted Pallas kernels (``VLUT_TPU_MATMUL_IMPL=
pallas_interpret``), whose arithmetic the port's kernels and their plain
versions follow.  Logits within 2e-2 of the largest (``_torch_recurrent.
TOL``; exp, softplus and silu round apart from XLA's by an ulp), greedy
tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_mamba2
from _torch_recurrent import (
    both,
    close,
    greedy_ref,
    loaded_by,
    mamba_cfgs,
    mamba_pair,
    structure,
)
from vlut_tpu.models import ssm as js
from vlut_tpu_torch.bench.recurrent_zoo import STRUCTURES
from vlut_tpu_torch.models import ssm as ps


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")


def _jax_combine(a, b):
    a1, a2 = a
    b1, b2 = b
    return a1 * b1, b1 * a2 + b2


@pytest.mark.parametrize("t", [1, 2, 5, 8, 13, 64])
def test_scan_is_jax_associative_scan_bit_for_bit(t):
    """The Mamba scan (h0 folded into step 0) against ``_ssm_scan``."""
    rng = np.random.default_rng(t)
    dA = rng.uniform(0.5, 1.0, (2, t, 6, 4)).astype(np.float32)
    dBx = rng.standard_normal((2, t, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    want = np.asarray(jax.jit(js._ssm_scan)(dA, dBx, h0))
    got = ps._ssm_scan(*(torch.from_numpy(a) for a in (dA, dBx, h0)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the jitted scan fuses b1*a2 + b2 (one rounding): the same recursion
    # with two roundings parts from it
    scan = jax.jit(lambda x, y: jax.lax.associative_scan(
        _jax_combine, (x, y), axis=1)[1])
    pair = [torch.from_numpy(dA), torch.from_numpy(dBx)]
    fused = ps.associative_scan(
        lambda a, b: [a[0] * b[0], torch.addcmul(b[1], b[0], a[1])], pair, 1)
    np.testing.assert_array_equal(fused[1].numpy(), np.asarray(scan(dA, dBx)))
    if t == 64:
        plain = ps.associative_scan(
            lambda a, b: [a[0] * b[0], b[0] * a[1] + b[1]], pair, 1)
        assert not torch.equal(plain[1], fused[1])


def test_init_params_are_the_jax_draws():
    cfg_j, cfg = mamba_cfgs()
    want = jax.tree.map(np.asarray, js.init_params(cfg_j, seed=3))
    got = ps.init_params(cfg, seed=3).tree()

    def walk(w, g, key=""):
        if isinstance(w, dict):
            assert set(w) == set(g), key
            for k in w:
                walk(w[k], g[k], f"{key}.{k}")
            return
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            g = g.view(torch.int16).numpy().view(np.uint16)
            w = w.view(np.uint16)
        else:
            g = g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=key)
        assert g.shape == w.shape, key  # 0-d scales stay per-tensor

    walk(want, got)


@pytest.mark.parametrize("t", [12, 40], ids=["M24", "M80"])
def test_forward_matches_jax(interpret, t):
    """Stateless forward; M 24 runs the fused-quant GEMM (#4), M 80 the
    tiled one (#3)."""
    cfg_j, pj, cfg, model = mamba_pair()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, t))
    want, _ = js.forward(pj, cfg_j, jnp.asarray(toks, jnp.int32))
    got, none = ps.forward(model, cfg, torch.from_numpy(toks))
    assert none is None
    close(got, want, "stateless")


def test_state_carry_matches_jax(interpret):
    """A prefill then one-token steps, state carried (in place in the
    port, as the engine's step does), against JAX's carried state."""
    cfg_j, pj, cfg, model = mamba_pair()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10))
    st_j = js.init_state(cfg_j, 2)
    st = ps.init_state(cfg, 2)
    lj, st_j = js.forward(pj, cfg_j, jnp.asarray(toks[:, :6], jnp.int32),
                          st_j, logits_last_only=True)
    lp, st = ps.forward(model, cfg, torch.from_numpy(toks[:, :6]), st,
                        logits_last_only=True)
    close(lp, lj, "prefill")
    for i in range(6, 10):
        lj, st_j = js.forward(pj, cfg_j,
                              jnp.asarray(toks[:, i:i + 1], jnp.int32), st_j)
        lp, st = ps.forward(model, cfg, torch.from_numpy(toks[:, i:i + 1]),
                            st, inplace=True)
        close(lp, lj, f"step {i}")
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_j[k]),
                                   rtol=1e-4, atol=1e-6)
    # the full sequence in one forward gives the carried logits
    full, _ = ps.forward(model, cfg, torch.from_numpy(toks))
    close(lp[:, 0], full[:, -1].numpy(), "carried vs full")


def test_left_padded_rows_end_in_their_unpadded_state(interpret):
    """Mixed prompt lengths in one left-padded group: each row's last
    logits and final state equal its own unpadded prefill's (within 1e-5),
    and the JAX padded forward's."""
    cfg_j, pj, cfg, model = mamba_pair()
    rng = np.random.default_rng(4)
    lens, tb = [9, 3, 6], 9
    toks = np.zeros((3, tb), np.int64)
    valid = np.zeros((3, tb), bool)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in lens]
    for r, p in enumerate(prompts):
        toks[r, tb - len(p):] = p
        valid[r, tb - len(p):] = True
    lp, st = ps.forward(model, cfg, torch.from_numpy(toks),
                        ps.init_state(cfg, 3), logits_last_only=True,
                        valid=torch.from_numpy(valid))
    lj, st_j = js.forward(pj, cfg_j, jnp.asarray(toks, jnp.int32),
                          js.init_state(cfg_j, 3), logits_last_only=True,
                          valid=jnp.asarray(valid))
    close(lp, lj, "padded group")
    for r, p in enumerate(prompts):
        one, st1 = ps.forward(model, cfg, torch.from_numpy(p)[None],
                              ps.init_state(cfg, 1), logits_last_only=True)
        # the pads are identity steps, but the scan's tree (and the float
        # products' blocking) differs with T and M: equal to float rounding
        close(lp[r], one[0].numpy(), f"row {r}", tol=1e-5)
        for k in ("conv", "ssm"):
            torch.testing.assert_close(st[k][:, r], st1[k][:, 0], rtol=1e-5,
                                       atol=1e-7)


def test_generate_fn_matches_jax(interpret):
    cfg_j, pj, cfg, model = mamba_pair()
    toks = np.asarray([[5, 9, 11], [7, 7, 2]])
    want = np.asarray(js.make_generate_fn(cfg_j, 6)(
        pj, jnp.asarray(toks, jnp.int32)))
    got = ps.make_generate_fn(cfg, 6)(model, torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].tolist() == greedy_ref(cfg, model, [5, 9, 11], 6)


def test_scan_chunks_give_the_unchunked_result(monkeypatch):
    """The scan cut into channel chunks (a long prefill on the card) is the
    same computation: bit-equal logits and state."""
    _, _, cfg, model = mamba_pair()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 11)))
    whole = ps.forward(model, cfg, toks, ps.init_state(cfg, 2))
    monkeypatch.setattr(ps, "SCAN_CHUNK_BYTES", 2 * 11 * 8 * 4 * 24)
    assert len(ps._chunks(cfg.d_inner, 2 * 11 * 8 * 4)) == 6
    cut = ps.forward(model, cfg, toks, ps.init_state(cfg, 2))
    torch.testing.assert_close(cut[0], whole[0], rtol=0, atol=0)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(cut[1][k], whole[1][k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def mamba2_ckpt(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return loaded_by(test_mamba2.test_mamba2_parity,
                         tmp_path_factory.mktemp("m2"), mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("impl", ["auto", "dequant"])
def test_mamba2_forward_matches_jax(mamba2_ckpt, interpret, impl):
    """Mamba2 on the JAX converter's checkpoint of an HF Mamba2 (2 layers,
    8 heads of 8, 2 groups, state 16): stateless, in both impls."""
    cfg_j, pj, cfg, model = both(mamba2_ckpt)
    assert structure(mamba2_ckpt) == STRUCTURES["mamba2"]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16))
    want, _ = js.forward2(pj, cfg_j, jnp.asarray(toks, jnp.int32), impl=impl)
    got, _ = ps.forward2(model, cfg, torch.from_numpy(toks), impl=impl)
    close(got, want, impl)


def test_mamba2_state_carry_and_padding_match_jax(mamba2_ckpt, interpret):
    cfg_j, pj, cfg, model = both(mamba2_ckpt)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    st_j, st = js.init_state2(cfg_j, 2), ps.init_state2(cfg, 2)
    lj, st_j = js.forward2(pj, cfg_j, jnp.asarray(toks[:, :7], jnp.int32),
                           st_j, logits_last_only=True)
    lp, st = ps.forward2(model, cfg, torch.from_numpy(toks[:, :7]), st,
                         logits_last_only=True, inplace=True)
    close(lp, lj, "prefill")
    for i in range(7, 12):
        lj, st_j = js.forward2(pj, cfg_j,
                               jnp.asarray(toks[:, i:i + 1], jnp.int32), st_j)
        lp, st = ps.forward2(model, cfg, torch.from_numpy(toks[:, i:i + 1]),
                             st, inplace=True)
        close(lp, lj, f"step {i}")
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(st_j["ssm"]),
                               rtol=1e-4, atol=1e-6)
    # a left-padded row (dt 0 at pads) ends in its unpadded state
    valid = np.ones((2, 12), bool)
    valid[1, :5] = False
    padded = toks.copy()
    padded[1, :5] = 0
    lp, stp = ps.forward2(model, cfg, torch.from_numpy(padded),
                          ps.init_state2(cfg, 2), logits_last_only=True,
                          valid=torch.from_numpy(valid))
    one, st1 = ps.forward2(model, cfg, torch.from_numpy(toks[1:, 5:]),
                           ps.init_state2(cfg, 1), logits_last_only=True)
    close(lp[1], one[0].numpy(), "padded row", tol=1e-5)
    torch.testing.assert_close(stp["ssm"][:, 1], st1["ssm"][:, 0], rtol=1e-5,
                               atol=1e-7)
    lj, _ = js.forward2(pj, cfg_j, jnp.asarray(padded, jnp.int32),
                        js.init_state2(cfg_j, 2), logits_last_only=True,
                        valid=jnp.asarray(valid))
    close(lp, lj, "padded")


@pytest.mark.parametrize("kind", ["mamba", "mamba2"])
def test_fast_random_weights_are_valid(kind):
    """``init_params_fast`` (the full-width presets' weights, made on the
    device) at a small width: valid trits, zero past K and N, finite
    logits, and the same weights from the same seed."""
    from vlut_tpu_torch.ops.packing import unpack_fields

    cfg = (ps.MambaConfig(vocab_size=96, d_model=64, n_layers=2, d_state=8)
           if kind == "mamba" else
           ps.Mamba2Config(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                           head_dim=16, d_state=16, n_groups=2))
    a = ps.init_params_fast(cfg, seed=1, device="cpu")
    b = ps.init_params_fast(cfg, seed=1, device="cpu")
    for name in ("in_proj", "out_proj"):
        t = a.layers.proj(name, 1)
        fields = unpack_fields(t.packed, "i2", t.kb)
        assert int(fields.max()) <= 2
        assert bool((fields[t.k:] == 1).all() and (fields[:, t.n:] == 1).all())
        assert torch.equal(t.packed, b.layers.proj(name, 1).packed)
    fwd = ps.forward if kind == "mamba" else ps.forward2
    logits, _ = fwd(a, cfg, torch.tensor([[1, 2, 3, 4]]))
    assert logits.shape == (1, 4, 96) and bool(torch.isfinite(logits).all())
