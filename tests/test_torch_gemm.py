"""Port parity of the kernels' plain versions against the JAX package's
Pallas kernels run in interpret mode on the CPU, plus the routing of
vlut_tpu_torch.ops.matmul.  The CUDA kernels are held against the same
plain versions on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vlut_tpu.ops import kv_update as jkv
from vlut_tpu.ops import matmul as jmm
from vlut_tpu.ops import pallas_gemm as jpg
from vlut_tpu.ops.packing import pack_ternary as jpack
from vlut_tpu_torch.ops import kv_update as tkv
from vlut_tpu_torch.ops import matmul as tmm
from vlut_tpu_torch.ops import ternary_gemm as tg
from vlut_tpu_torch.ops.packing import pack_ternary as tpack

torch.set_num_threads(1)


def _round_up(x, m):
    return (x + m - 1) // m * m


def _weights(k, n, fmt, per_channel, seed):
    rng = np.random.default_rng(seed)
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    scale = (rng.uniform(0.01, 0.1, n).astype(np.float32) if per_channel
             else np.float32(0.031))
    return jpack(trits, scale, fmt), tpack(trits, scale, fmt)


def _jax_ws(tj):
    ws = jnp.asarray(tj.scale, jnp.float32)
    if ws.ndim == 0:
        return jnp.full((tj.n_padded,), ws, jnp.float32)
    return jnp.pad(ws, (0, tj.n_padded - tj.n))


# --- kernel 3: tiled GEMM on pre-quantized activations -------------------------

@pytest.mark.parametrize("m", [1, 5, 32, 65, 200])
@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_tiled_plain_bit_equal(m, fmt, per_channel):
    k, n = (640, 256) if m != 5 else (300, 130)
    tj, tt = _weights(k, n, fmt, per_channel, seed=m)
    rng = np.random.default_rng(100 + m)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    xs = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    want = np.asarray(jmm.ternary_matmul_quantized(
        jnp.asarray(xq), jnp.asarray(xs), tj, impl="pallas_interpret"))
    got = tg.ternary_gemm_tiled(
        torch.from_numpy(xq), tt.packed, torch.from_numpy(xs),
        tt.scale_vector(), fmt=fmt, kb=tt.kb, k=k)
    assert got.dtype == torch.float32 and got.shape == (m, tt.n_padded)
    np.testing.assert_array_equal(got[:, :n].numpy(), want)


# --- kernel 4: fused-quant GEMM --------------------------------------------------

@pytest.mark.parametrize("m", [1, 5, 32])
@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_fused_quant_plain_bit_equal(m, fmt, per_channel):
    k, n = (640, 256) if m != 5 else (300, 130)
    tj, tt = _weights(k, n, fmt, per_channel, seed=7 * m)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    x[0, :5] = 0.0
    kp, np_ = tj.k_padded, tj.n_padded
    mp = _round_up(max(m, 32), 32)
    _, bn, bk = jpg.default_block_shapes(mp, np_, kp, tj.kb)
    want = np.asarray(jpg.ternary_gemm_fused_quant(
        jnp.pad(jnp.asarray(x), ((0, mp - m), (0, kp - k))),
        jnp.asarray(tj.packed), _jax_ws(tj), fmt=fmt, kb=tj.kb, k=k, bn=bn,
        bk=bk, interpret=True))[:m, :n]
    got = tg.ternary_gemm_fused_quant(torch.from_numpy(x), tt.packed,
                                      tt.scale_vector(), fmt=fmt, kb=tt.kb,
                                      k=k)
    np.testing.assert_array_equal(got[:, :n].numpy(), want)


# --- kernel 1: fused decode projection --------------------------------------------

def _jax_prologue_codes(x1, x2, g, mode, sub_norm, norm_n, eps):
    """The Pallas decode kernel's prologue (pallas_gemm.py:405-426) run
    eagerly in JAX, for its int8 codes."""
    xf = jnp.asarray(x1).astype(jnp.float32)
    if mode == "silu_mul":
        xf = xf * jax.lax.logistic(xf) * jnp.asarray(x2).astype(jnp.float32)
        if sub_norm:
            xf = xf.astype(jnp.bfloat16).astype(jnp.float32)
    if mode == "norm" or sub_norm:
        ss = jnp.sum(xf * xf, axis=-1, keepdims=True)
        xf = xf * jax.lax.rsqrt(ss / norm_n + eps) * jnp.asarray(g)
    if mode != "plain":
        xf = xf.astype(jnp.bfloat16).astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    inv = jnp.where(amax > 0, 127.0 / jnp.maximum(amax, 1e-30), 0.0)
    return np.asarray(jnp.clip(jnp.round(xf * inv), -127, 127), np.int32)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("mode,sub_norm", [("plain", False), ("norm", False),
                                           ("silu_mul", False),
                                           ("silu_mul", True)])
@pytest.mark.parametrize("with_res", [False, True])
def test_decode_plain_vs_interpret(fmt, mode, sub_norm, with_res):
    m, k, n = 6, 640, 256
    tj, tt = _weights(k, n, fmt, True, seed=11)
    rng = np.random.default_rng(5)
    x_dtype = np.float32 if mode == "plain" else jnp.bfloat16
    x1 = rng.standard_normal((m, k)).astype(np.float32)
    x2 = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, k).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    x1j = jnp.asarray(x1, x_dtype)
    x2j = jnp.asarray(x2, jnp.bfloat16)
    resj = jnp.asarray(res, jnp.bfloat16) if with_res else None
    norm_n = k - 40
    kw = dict(mode=mode, norm_n=norm_n, eps=1e-5, sub_norm=sub_norm)
    gj = jnp.asarray(g) if (mode == "norm" or sub_norm) else None
    want = jmm.ternary_matmul_fused(
        x1j, tj, x2=x2j if mode == "silu_mul" else None, norm_g=gj,
        residual=resj, impl="pallas_interpret", **kw)
    to_t = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    got = tmm.ternary_matmul_fused(
        to_t(x1j), tt.__class__(tt.packed, tt.scale_vector(), k, n, fmt, tt.kb),
        x2=to_t(x2j) if mode == "silu_mul" else None,
        norm_g=torch.from_numpy(g) if gj is not None else None,
        residual=to_t(resj) if with_res else None, **kw)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == (torch.bfloat16 if x_dtype != np.float32
                         else torch.float32)
    got = got.float().numpy()
    if mode == "plain":
        np.testing.assert_array_equal(got, want)
        return
    # Float prologue: the JAX kernel and the port reduce the sum of squares
    # in another order, so an int8 code may differ by 1 in at most 0.1% of
    # entries; outputs then agree to within (differing codes in the row + 1)
    # code steps times the scales, plus one bf16 step before and after the
    # residual add.
    x2t = to_t(x2j) if mode == "silu_mul" else None
    codes_t, xs_t = tg.decode_prologue(to_t(x1j), x2t,
                                       torch.from_numpy(g), mode, sub_norm,
                                       norm_n, 1e-5)
    codes_j = _jax_prologue_codes(x1j, x2j, g, mode, sub_norm, norm_n, 1e-5)
    d = np.abs(codes_t.numpy().astype(np.int32) - codes_j)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    ws = tt.scale_vector()[:n].numpy()
    mag = np.abs(want) + (np.abs(res) if with_res else 0.0)
    tol = ((d > 0).sum(1, keepdims=True) + 1) * xs_t.numpy() * ws[None] \
        + 2.0 ** -6 * mag
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m", [1, 17, 64])
def test_afrag_layout_is_a_bijection(fmt, m):
    """The decode prologue's A-fragment layout places every (row, K) code
    of the 16-row tiles at its own byte, and the four field-0..3 codes of a
    slab row in one aligned word (the kernel stores them as one int32)."""
    kb = 128 if fmt == "i2" else 160
    kp = 3 * kb
    mp = -(-m // 16) * 16
    offs = tg.afrag_offsets(mp, kp, kb)
    assert sorted(offs.flatten().tolist()) == list(range(mp * kp))
    w = torch.arange(kp) % kb
    field0 = offs[:, w < 32]
    for q in range(4):
        fq = offs[:, (w >= 32 * q) & (w < 32 * q + 32)]
        assert torch.equal(fq, field0 + q)
    assert bool((field0 % 4 == 0).all())
    # the first m rows are the same offsets with M = m (rows >= m are pad)
    assert torch.equal(tg.afrag_offsets(m, kp, kb), offs[:m])


def test_decode_rejects_large_m():
    tt = tpack(np.zeros((128, 128), np.int8))
    with pytest.raises(ValueError):
        tg.ternary_gemm_decode(torch.zeros(65, 128), tt.packed,
                               tt.scale_vector(), fmt="i2", kb=128, k=128)


# --- kernels 5/6: KV row writer ------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_kv_writer_plain_bit_equal(dtype):
    rng = np.random.default_rng(3)
    b, s, h, d = 3, 9, 2, 128
    kc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ku = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    vu = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    start = np.array([0, 8, 4], np.int32)
    kj, vj = jkv.write_rows_pair_pallas(
        jnp.asarray(kc, dtype), jnp.asarray(vc, dtype), jnp.asarray(ku, dtype),
        jnp.asarray(vu, dtype), jnp.asarray(start), interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    kt = torch.from_numpy(kc).to(tdt)
    vt = torch.from_numpy(vc).to(tdt)
    out = tkv.write_rows_pair(kt, vt, torch.from_numpy(ku).to(tdt),
                              torch.from_numpy(vu).to(tdt),
                              torch.from_numpy(start))
    assert out[0] is kt and out[1] is vt  # in place
    np.testing.assert_array_equal(kt.float().numpy(),
                                  np.asarray(kj.astype(jnp.float32)))
    np.testing.assert_array_equal(vt.float().numpy(),
                                  np.asarray(vj.astype(jnp.float32)))
    one = jkv.write_rows_pallas(jnp.asarray(kc, dtype), jnp.asarray(ku, dtype),
                                jnp.asarray(start), interpret=True)
    c1 = torch.from_numpy(kc).to(tdt)
    tkv.write_rows(c1, torch.from_numpy(ku).to(tdt), torch.from_numpy(start))
    np.testing.assert_array_equal(c1.float().numpy(),
                                  np.asarray(one.astype(jnp.float32)))


# --- routing -------------------------------------------------------------------

@pytest.mark.parametrize("m,small", [(1, True), (64, True), (65, False),
                                     (200, False)])
def test_routing(monkeypatch, m, small):
    calls = []
    for name in ("ternary_gemm_fused_quant", "ternary_gemm_tiled",
                 "ternary_gemm_decode"):
        real = getattr(tg, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tg, name, spy)
    _, tt = _weights(256, 128, "i2", False, seed=1)
    x = torch.randn(m, 256)
    tmm.ternary_matmul(x, tt)
    tmm.ternary_matmul_fused(x.to(torch.bfloat16), tt, mode="norm",
                             norm_g=torch.ones(256))
    if small:
        assert calls == ["ternary_gemm_fused_quant", "ternary_gemm_decode"]
    else:
        assert calls == ["ternary_gemm_tiled", "ternary_gemm_tiled"]


def test_dequant_impl():
    tj, tt = _weights(300, 130, "i2", True, seed=2)
    x = np.random.default_rng(0).standard_normal((4, 300)).astype(np.float32)
    want = np.asarray(jmm.ternary_matmul(jnp.asarray(x), tj, impl="dequant"))
    got = tmm.ternary_matmul(torch.from_numpy(x), tt, impl="dequant")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
