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


# The shapes the port gives #3: llama3_8b's flagship projections (prefill
# M 4096, e2e pp 512 at batch 1 and 32), the `bench` lanes (dxd, dxff, ffxd
# at M 32 and 256) and the card tests' small shapes.
_PROJ = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]
_LANES = [(4096, 4096), (4096, 14336), (14336, 4096)]
_PLAN_SHAPES = ([(m, k, n) for k, n in _PROJ for m in (512, 4096, 16384)]
                + [(m, k, n) for k, n in _LANES for m in (32, 256)]
                + [(m, 1280, 384) for m in (1, 32, 65, 200, 256, 513)])


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m,k,n", _PLAN_SHAPES)
def test_tiled_plan_covers_the_card(fmt, m, k, n):
    """Tiles cover Np; BM follows M; the splits divide the pack blocks,
    leave each split two of them and keep the grid in one wave of 132
    blocks, as many as that allows; the wave is at least half full unless
    K cannot be split further."""
    from vlut_tpu_torch.ops.packing import padded_k

    np_ = -(-n // 128) * 128
    kp = padded_k(k, fmt)
    nb = kp // (128 if fmt == "i2" else 160)
    bm, bn, splits = tg.tiled_plan(m, np_, kp, fmt)
    assert np_ % bn == 0 and nb % splits == 0
    assert bm == (32 if m <= 32 else 64 if m <= 256
                  and np_ // 128 * -(-m // 64) <= 132 else 128)
    assert bn == (256 if bm == 128 and np_ % 256 == 0 else 128)
    tiles = np_ // bn * -(-m // bm)
    assert splits == 1 or (nb // splits >= 2 and tiles * splits <= 132)
    assert not any(nb % s == 0 and nb // s >= 2 and tiles * s <= 132
                   for s in range(splits + 1, nb + 1))
    assert tiles * splits >= 66 or nb // splits < 4


def test_tiled_plan_reaches_every_split_count():
    """The card tests' plan shapes take every block row count with and
    without a split, and several split counts."""
    from test_torch_cuda import TILED_PLAN_SHAPES
    from vlut_tpu_torch.ops.packing import padded_k

    seen = set()
    for fmt in ("i2", "i1"):
        for m, k, n in TILED_PLAN_SHAPES:
            bm, _, s = tg.tiled_plan(m, -(-n // 128) * 128, padded_k(k, fmt),
                                     fmt)
            seen.add((fmt, bm, s > 1))
            seen.add((fmt, s))
    for fmt in ("i2", "i1"):
        for bm in (32, 64, 128):
            assert (fmt, bm, False) in seen and (fmt, bm, True) in seen
    assert {("i2", s) for s in (1, 2, 3, 5, 6, 10, 15)} <= seen


_QP = {"i2": 2, "i1": 3}


def _b_slot(qp, nt, lane, bn):
    """csrc/ternary_gemm.cu:b_slot."""
    return ((qp * (bn // 8) + nt) * 32
            + (lane ^ ((nt & 3) | ((lane >> 2) & 4))))


def _decode_to_slots(block, fmt):
    """The kernel's decode_column on one pack block of one column tile:
    block (32, BN) packed bytes -> (slots, 4) int8 words of trits, each
    16-byte slot written once."""
    from vlut_tpu_torch.ops.packing import unpack_fields

    kb = 128 if fmt == "i2" else 160
    bn = block.shape[1]
    # field q of slab row j, column n -> trit, as the decode computes it
    trits = (unpack_fields(torch.from_numpy(block), fmt, kb).numpy()
             .astype(np.int8) - 1).reshape(kb // 32, 32, bn)
    slots = np.zeros((_QP[fmt] * bn // 8 * 32, 4, 4), np.int8)
    written = np.zeros(len(slots), int)
    for cq in range(bn // 4):
        for r4 in range(4):
            for e in range(4):
                col = 4 * cq + e
                nt, lane = col >> 3, (col & 7) * 4 + r4
                for qp in range(_QP[fmt]):
                    s = _b_slot(qp, nt, lane, bn)
                    written[s] += 1
                    for w, (h, dq) in enumerate(((0, 0), (1, 0), (0, 1),
                                                 (1, 1))):
                        q = 2 * qp + dq
                        if q < kb // 32:
                            rows = 16 * h + 4 * r4 + np.arange(4)
                            slots[s, w] = trits[q, rows, col]
    assert (written == 1).all()
    return slots


def _slots_to_trits(slots, fmt, bn):
    """The mma warps' view of the slots: the (kb, BN) trits of the block's
    K (chunk q = K 32q..32q+31) and columns, from registers b0/b1 of every
    (warp column, n-tile, lane) as mma m16n8k32 reads them."""
    kb = 128 if fmt == "i2" else 160
    nt_w = bn // 32  # n-tiles of each of the four warp columns
    w = np.full((kb, bn), 99, np.int8)
    for wn in range(4):
        for nt in range(nt_w):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                col = (wn * nt_w + nt) * 8 + g
                for qp in range(_QP[fmt]):
                    v = slots[_b_slot(qp, wn * nt_w + nt, lane, bn)]
                    for h in range(2):
                        q = 2 * qp + h
                        if q >= kb // 32:
                            continue
                        w[32 * q + 4 * t + np.arange(4), col] = v[2 * h]
                        w[32 * q + 16 + 4 * t + np.arange(4), col] = v[2 * h + 1]
    return w


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m,k,splits,bn", [(5, 300, 1, 128), (33, 1000, 2, 128),
                                           (70, 640, 5, 128),
                                           (130, 900, 2, 256)])
def test_tiled_kernel_order_emulated(fmt, m, k, splits, bn):
    """The tiled kernel's data movement emulated on the CPU: the decoded B
    tile in fragment order, read back as the mma reads it, gives each pack
    block's trits in x's natural K order; the splits' int32 sums meet in a
    workspace; the epilogue then equals _gemm_plain bit for bit at a ragged
    k."""
    kb = 128 if fmt == "i2" else 160
    n = 256
    _, tt = _weights(k, n, fmt, True, seed=k + m)
    packed = tt.packed.numpy()
    kp = tt.k_padded
    nb = kp // kb
    splits = max(s for s in range(1, splits + 1) if nb % s == 0)
    rng = np.random.default_rng(m)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    xs = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    xpad = np.zeros((m, kp), np.int64)  # the copy's zero fill past k
    xpad[:, :k] = xq
    work = np.zeros((m, tt.n_padded), np.int64)
    for z in range(splits):
        for n0 in range(0, tt.n_padded, bn):
            acc = np.zeros((m, bn), np.int64)
            for b in range(z * nb // splits, (z + 1) * nb // splits):
                block = packed[b * 32:(b + 1) * 32, n0:n0 + bn]
                w = _slots_to_trits(_decode_to_slots(block, fmt), fmt, bn)
                assert (np.abs(w) <= 1).all()
                acc += xpad[:, b * kb:(b + 1) * kb] @ w.astype(np.int64)
            work[:, n0:n0 + bn] += acc
    got = tg._epilogue_plain(torch.from_numpy(work).to(torch.int32),
                             torch.from_numpy(xs), tt.scale_vector(), None,
                             torch.float32)
    want = tg._gemm_plain(torch.from_numpy(xq), torch.from_numpy(xs),
                          tt.packed, tt.scale_vector(), fmt, kb, k, None,
                          torch.float32)
    assert torch.equal(got, want)


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
