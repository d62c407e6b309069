"""The port's TQ2_0/TQ1_0 lane against the JAX package on the CPU.

Packing is byte-identical.  ``tq_gemm_plain`` (what the wrapper runs on a
CPU tensor, and what the CUDA kernel is held to on the card) equals the JAX
``tq_gemm`` run in interpret mode bit for bit: the block dots are exact
integers and the float32 sum follows the order XLA compiles the Pallas
kernel's ``acc + dot*s`` chain into (fused multiply-adds; see
``tq_gemm_plain``).  The "large" inputs (x codes near 127, trits mostly +1)
make every block dot need more than 13 bits, so its product with an fp16
scale is not exact in float32 and a wrong rounding order shows.  Against
the float64 oracle of ``tests/test_tq.py`` the tolerance is rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.ops import tq as jtq
from vlut_tpu_torch.ops import tq

torch.set_num_threads(1)

QK = tq.QK


def _weights(rng, k, n, large):
    if large:
        trits = (rng.random((k, n)) < 0.9).astype(np.float32)
        d = rng.uniform(0.3, 0.9, size=(k // QK, n)).astype(np.float16)
    else:
        trits = rng.integers(-1, 2, size=(k, n)).astype(np.float32)
        d = rng.uniform(0.02, 0.1, size=(k // QK, n)).astype(np.float16)
    return trits, trits * np.repeat(d.astype(np.float32), QK, axis=0)


def _x(rng, m, k, large):
    lo, hi = (90, 128) if large else (-100, 100)
    return (rng.integers(lo, hi, (m, k)).astype(np.int8),
            rng.uniform(0.001, 0.01, (m, 1)).astype(np.float32))


@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
@pytest.mark.parametrize("k,n", [(512, 64), (300, 24), (768, 32)])
def test_packing_byte_identical(fmt, k, n):
    rng = np.random.default_rng(k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column: scale 0
    pack = {"tq2": (tq.pack_tq2, jtq.pack_tq2),
            "tq1": (tq.pack_tq1, jtq.pack_tq1)}[fmt]
    unpack = {"tq2": (tq.unpack_tq2, jtq.unpack_tq2),
              "tq1": (tq.unpack_tq1, jtq.unpack_tq1)}[fmt]
    got, want = pack[0](w), pack[1](w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == -(-k // QK) * tq.ROWS_PER_BLOCK[fmt]
    np.testing.assert_array_equal(unpack[0](*got), unpack[1](*want))
    # the torch trit decode (the plain GEMM's) agrees with the numpy one
    trits = tq.tq_trits(torch.from_numpy(got[0]), fmt).float()
    scaled = trits * torch.from_numpy(
        np.repeat(got[1].astype(np.float32), QK, axis=0))
    np.testing.assert_array_equal(scaled.numpy(), unpack[1](*want))


@pytest.mark.parametrize("large", [False, True], ids=["random", "large"])
@pytest.mark.parametrize("bk", [256, 512, 1024, 2048])
@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
def test_plain_equals_jax_interpret(fmt, bk, large):
    rng = np.random.default_rng(bk + large)
    m, k, n = 32, max(1024, bk), 256  # bk 2048: the bench's 8-block tiles
    _, w = _weights(rng, k, n, large)
    packed, scales = (tq.pack_tq2 if fmt == "tq2" else tq.pack_tq1)(w)
    xq, xs = _x(rng, m, k, large)
    want = np.asarray(jtq.tq_gemm(
        jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(scales),
        jnp.asarray(xs), fmt=fmt, bm=32, bn=128, bk=bk, interpret=True))
    before = tq.tq_gemm.launches
    got = tq.tq_gemm(torch.from_numpy(xq), torch.from_numpy(packed),
                     torch.from_numpy(scales), torch.from_numpy(xs), fmt=fmt,
                     bk=bk)
    assert tq.tq_gemm.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
def test_plain_matches_float64_oracle(fmt):
    rng = np.random.default_rng(2)
    m, k, n = 32, 1024, 256
    trits, w = _weights(rng, k, n, large=False)
    packed, scales = (tq.pack_tq2 if fmt == "tq2" else tq.pack_tq1)(w)
    xq, xs = _x(rng, m, k, large=False)
    got = tq.tq_gemm_plain(torch.from_numpy(xq), torch.from_numpy(packed),
                           torch.from_numpy(scales), torch.from_numpy(xs),
                           fmt=fmt, bk=512).numpy()
    blocks = xq.reshape(m, k // QK, QK).astype(np.int64)
    tb = trits.reshape(k // QK, QK, n).astype(np.int64)
    want = np.zeros((m, n), np.float64)
    for b in range(k // QK):
        want += (blocks[:, b] @ tb[b]).astype(np.float64) * \
            scales[b].astype(np.float64)
    want *= xs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fma_rounds_once():
    # a*b = 1 + 2**-11 + 2**-24 exactly: a float32 midpoint, so a c far
    # below the float64 step of the sum still decides the rounding
    a = torch.tensor([1 + 2.0**-12] * 3, dtype=torch.float32)
    c = torch.tensor([2.0**-80, -(2.0**-80), 0.0], dtype=torch.float32)
    got = tq._fma(a, a, c)
    up, down = 1 + 2.0**-11 + 2.0**-23, 1 + 2.0**-11
    assert got.tolist() == [up, down, down]  # the tie goes to even
    # away from midpoints it is the product and sum rounded once
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
               for _ in range(3))
    exact = a.double() * b.double() + c.double()
    assert torch.equal(tq._fma(a, b, c), exact.float())


def test_bf16_output_and_argument_checks():
    rng = np.random.default_rng(7)
    _, w = _weights(rng, 512, 64, large=False)
    packed, scales = (torch.from_numpy(a) for a in tq.pack_tq2(w))
    xq, xs = (torch.from_numpy(a) for a in _x(rng, 5, 512, large=False))
    f32 = tq.tq2_gemm(xq, packed, scales, xs, bk=512)
    bf = tq.tq2_gemm(xq, packed, scales, xs, bk=512, out_dtype=torch.bfloat16)
    assert torch.equal(bf, f32.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bk"):
        tq.tq_gemm(xq, packed, scales, xs, fmt="tq2", bk=2048)
    with pytest.raises(ValueError, match="packed"):
        tq.tq_gemm(xq, packed, scales, xs, fmt="tq1", bk=512)
    with pytest.raises(ValueError, match="x_scale"):
        tq.tq_gemm(xq, packed, scales, xs[:1], fmt="tq2", bk=512)


# --- the kernel's plan and an emulation of its order ---------------------


def _ranges(nk, splits):
    """The bk tiles of each split, as the kernel computes them."""
    return [range(z * nk // splits, (z + 1) * nk // splits)
            for z in range(splits)]


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("bk", [256, 512, 2048])
def test_tq_plan_keeps_one_wave_and_splits_at_tiles(sms, bk):
    for m in (1, 17, 32, 64, 100, 256, 1000):
        for kp, n in ((4096, 4096), (4096, 14336), (14336, 4096),
                      (2048, 1024), (6144, 80), (12288, 272)):
            if kp % bk:
                continue
            nk = kp // bk
            bm, bn, splits = tq.tq_plan(m, n, kp, bk, sms)
            assert (bm, bn) in tq.TILES
            tiles = -(-n // bn) * -(-m // bm)
            assert 1 <= splits <= nk
            if bk == tq.QK:
                assert splits == 1  # one chained sum never splits
            if splits > 1:
                assert tiles * splits <= sms  # one wave
            # every bk tile belongs to exactly one split, in order
            covered = [t for r in _ranges(nk, splits) for t in r]
            assert covered == list(range(nk))
            assert all(len(r) for r in _ranges(nk, splits))


def test_tq_plan_reaches_every_tile_and_split_count():
    """The plan shapes of the card's checks (the card tests, chip_smoke.py
    and the study) take every tile of the kernel with one split and with
    several, and uneven splits."""
    seen = set()
    for m, k, n, bk in tq.PLAN_SHAPES:
        bm, bn, splits = tq.tq_plan(m, -(-n // 16) * 16, k, bk, 132)
        seen.add(((bm, bn), min(splits, 2)))
        seen.add(("uneven", (k // bk) % splits != 0))
    for tile in tq.TILES:
        assert (tile, 1) in seen and (tile, 2) in seen, tile
    assert ("uneven", True) in seen


def test_tq_plan_splits_narrow_grids():
    # llama3_8b dxd and ffxd at M 32: the tiles alone leave the card idle
    dxd = tq.tq_plan(32, 4096, 4096, 2048, 132)
    ffxd = tq.tq_plan(32, 4096, 14336, 2048, 132)
    assert dxd[2] > 1 and ffxd[2] > 1
    # 7 tiles can split unevenly
    assert [len(r) for r in _ranges(7, 4)] == [1, 2, 2, 2]
    # M 256 fills the card with tiles: no split
    assert tq.tq_plan(256, 14336, 4096, 2048, 132)[2] == 1


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (selector nibble i) of the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * sel)) & np.uint64(0xff)
        out |= (byte.astype(np.uint32) << np.uint32(8 * i))
    return out


def _transpose4(v):
    t0 = _byte_perm(v[0], v[1], 0x5140)
    t1 = _byte_perm(v[0], v[1], 0x7362)
    t2 = _byte_perm(v[2], v[3], 0x5140)
    t3 = _byte_perm(v[2], v[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _tq1_digits2(v):
    """tq_gemm.cu:tq1_digits2 on uint32 words: two bytes in 16-bit halves ->
    the five digit words."""
    v = v.astype(np.uint32)
    t1 = ((v * np.uint32(171)) >> np.uint32(9)) & np.uint32(0x007F007F)
    a = ((v * np.uint32(57)) >> np.uint32(9)) & np.uint32(0x001F001F)
    b = ((v * np.uint32(19)) >> np.uint32(9)) & np.uint32(0x000F000F)
    c = ((b * np.uint32(11)) >> np.uint32(5)) & np.uint32(0x00030003)
    three = np.uint32(3)
    return [v - three * t1, t1 - three * a, a - three * b, b - three * c, c]


def _b_slot(qp, nt, lane, bn):
    return (qp * (bn // 8) + nt) * 32 + (lane ^ (((nt & 3) << 1) | ((lane >> 4) & 1)))


def _b_word(f, trits):
    """tq_gemm.cu:b_word: a word of fields, or of trits (byte + 0x7f, then
    the xor takes 0x80 off)."""
    f = f.astype(np.uint32)
    return (f + np.uint32(0x7F7F7F7F)) ^ np.uint32(0x80808080) if trits else f


def _decode_tile(raw, fmt, bn, trits):
    """One K block's packed rows (rpb, bn) -> the B tile's 32-bit words of
    stored fields {0, 1, 2} or trits as the kernel's decode writes them
    (tq2_load / tq2_store, tq1_unit)."""
    bt = np.full(4 * (bn // 8) * 32 * 4, 0xDEADBEEF, np.uint32)
    cq = np.arange(bn // 4)

    def word(row):  # the little-endian words of columns 4cq..4cq+3
        return raw[row].reshape(-1, 4).copy().view("<u4")[:, 0]
    if fmt == "tq2":
        for t in range(4):
            w = [_transpose4([word(4 * t + 16 * h + i) for i in range(4)])
                 for h in range(4)]
            for q in range(4):
                for e in range(4):
                    col = 4 * cq + e
                    slot = _b_slot(q, col >> 3, (col & 7) * 4 + t, bn)
                    for h in range(4):
                        bt[4 * slot + h] = _b_word(
                            (w[h][e] >> np.uint32(2 * q))
                            & np.uint32(0x03030303), trits)
    else:
        for r4 in range(13):
            w = _transpose4([word(4 * r4 + i) for i in range(4)])
            for e in range(4):
                mask = np.uint32(0x00FF00FF)
                lo = _tq1_digits2(w[e] & mask)
                hi = _tq1_digits2((w[e] >> np.uint32(8)) & mask)
                d = [_b_word(lo[q] | (hi[q] << np.uint32(8)), trits)
                     for q in range(5)]
                col = 4 * cq + e
                groups = ([(12 * q + r4, d[q]) for q in range(5)] if r4 < 12
                          else [(60 + q, d[q]) for q in range(4)])
                for grp, v in groups:
                    slot = _b_slot(grp >> 4, col >> 3, (col & 7) * 4 + (grp & 3),
                                   bn)
                    bt[4 * slot + ((grp >> 2) & 3)] = v
    assert not (bt == 0xDEADBEEF).any()  # every word of the tile is written
    return bt


def _mma_b(bt, bn, trits):
    """The (256, bn) B the mma reads from the B tile (int8 trits or uint8
    fields): chunk c, lane 4g + t of n-tile nt takes words 2(c % 2) and
    2(c % 2) + 1 of its slot of pair c // 2 as B registers 0 and 1 (K 4t..
    and 16 + 4t.. of column g)."""
    b = np.zeros((256, bn), np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for c in range(8):
        for nt in range(bn // 8):
            slot = _b_slot(c // 2, nt, lane, bn)
            for reg in range(2):
                v = bt[4 * slot + 2 * (c % 2) + reg]
                for i in range(4):
                    byte = (v >> np.uint32(8 * i)) & np.uint32(0xff)
                    if trits:
                        byte = byte.astype(np.uint8).view(np.int8)
                    b[32 * c + 16 * reg + 4 * t + i, nt * 8 + g] = byte
    return b


def _ldmatrix_a(x_tile, bm, wm, mt, c):
    """The mma's A (16 x 32) of chunk c, m-tile mt of the warp at row wm:
    the TMA writes the 16-byte unit u of row r of x box c // 4 (BM rows x
    128 bytes) at u ^ (r % 8), and lane L reads row wm + 16 mt + (L & 15),
    unit 2 (c % 4) + (L >> 4) at the kernel's address; register j of lane
    4g + t holds bytes 4t.. of row g of the matrix whose rows lanes 8j..
    address."""
    boxes = np.zeros(2 * bm * 128, np.uint8)
    for bx in range(2):
        for r in range(bm):
            for u in range(8):
                o = bx * bm * 128 + r * 128 + (u ^ (r & 7)) * 16
                k0 = 128 * bx + 16 * u
                boxes[o:o + 16] = x_tile[r, k0:k0 + 16]
    a = np.zeros((16, 32), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            src = 8 * j + g
            addr = ((wm + 16 * mt + (src & 15)) * 128 + (c >> 2) * bm * 128
                    + ((2 * (c & 3) + (src >> 4)) ^ (src & 7)) * 16 + 4 * t)
            row = g + 8 * (j & 1)
            a[row, 16 * (j >> 1) + 4 * t:16 * (j >> 1) + 4 * t + 4] = \
                boxes[addr:addr + 4].view(np.int8)
    return a


def _kernel_emulation(xq, packed, scales, xs, fmt, bk, tile, splits):
    """The kernel's arithmetic in its own order: per column tile the B tile
    of each K block from the decode, A from the swizzled x boxes, exact
    int32 dots (trits, or fields less the row sums of x), the float chain
    in registers, each bk tile's partial written by its split and the
    partials added in tile order."""
    bm, bn = tile
    m, kp = xq.shape
    n = packed.shape[1]
    rpb = tq.ROWS_PER_BLOCK[fmt]
    nb, nbt, nk = kp // QK, bk // QK, kp // bk
    ntiles = -(-n // bn)
    raw = np.zeros((nb * rpb, ntiles * bn), np.uint8)  # the TMA's zero fill
    raw[:, :n] = packed
    sc = np.zeros((nb, ntiles * bn), np.float32)
    sc[:, :n] = scales.astype(np.float32)
    mp = -(-m // bm) * bm
    xpad = np.zeros((mp, kp), np.int8)
    xpad[:m] = xq
    warps_m = 4 if bm == 128 else 2  # the kernel's warps: 2 x 4 or 4 x 2
    trits = bm == 128  # B as trits, else fields less the row sums
    mt_n = bm // (16 * warps_m)
    dots = np.zeros((nb, mp, ntiles * bn), np.int64)
    for b in range(nb):
        for j in range(ntiles):
            bmat = _mma_b(_decode_tile(raw[b * rpb:(b + 1) * rpb,
                                           j * bn:(j + 1) * bn], fmt, bn,
                                       trits), bn, trits)
            for m0 in range(0, mp, bm):
                xt = xpad[m0:m0 + bm, b * QK:(b + 1) * QK]
                for wm in range(0, bm, bm // warps_m):
                    for mt in range(mt_n):
                        a = np.concatenate([_ldmatrix_a(xt, bm, wm, mt, c)
                                            for c in range(8)], axis=1)
                        r0 = m0 + wm + 16 * mt
                        # fields less the row sums (an mma against ones)
                        rows = 0 if trits else a @ np.ones((256, 1), np.int64)
                        dots[b, r0:r0 + 16, j * bn:(j + 1) * bn] = \
                            a @ bmat - rows
    d = torch.from_numpy(dots[:, :m, :n].astype(np.float32))
    s = torch.from_numpy(sc[:, None, :n])
    parts = [None] * nk
    totals = []
    for tiles in _ranges(nk, splits):
        total = torch.zeros((m, n))
        for kt in tiles:
            for it in range(nbt):
                i = kt * nbt + it
                if nbt == 1:
                    total = tq._fma(d[i], s[i], total)
                elif it == 0:
                    p = d[i]
                elif it == 1:
                    p = tq._fma(p, s[i - 1], d[i] * s[i])
                else:
                    p = tq._fma(d[i], s[i], p)
            if nbt > 1:
                if splits > 1:
                    assert parts[kt] is None
                    parts[kt] = p
                else:
                    total = total + p
        totals.append(total)
    if splits > 1:
        total = torch.zeros((m, n))
        for p in parts:
            total = total + p
    else:
        (total,) = totals
    return total * torch.from_numpy(xs)


@pytest.mark.parametrize("m", [1, 17, 100])
@pytest.mark.parametrize("bk,k,splits", [(256, 768, 1), (512, 1536, 1),
                                         (512, 1536, 2), (512, 3584, 4),
                                         (2048, 4096, 1), (2048, 4096, 2)])
@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
def test_kernel_order_emulation_is_bit_exact(fmt, bk, k, splits, m):
    """The new kernel's decode into the B tile, the mma's reads of it and
    of the swizzled x, its per-block chain and the per-tile partials summed
    in order equal tq_gemm_plain bit for bit (and so the JAX interpret run,
    test_plain_equals_jax_interpret) on the "large" inputs, at an N that is
    not a multiple of BN and a ragged M."""
    rng = np.random.default_rng(k + m + splits)
    n = 80
    _, w = _weights(rng, k, n, large=True)
    packed, scales = (tq.pack_tq2 if fmt == "tq2" else tq.pack_tq1)(w)
    xq, xs = _x(rng, m, k, large=True)
    tile = ((32, 64) if fmt == "tq2" else (32, 128)) if m <= 32 else (128, 64)
    got = _kernel_emulation(xq, packed, scales, xs, fmt, bk, tile, splits)
    want = tq.tq_gemm_plain(torch.from_numpy(xq), torch.from_numpy(packed),
                            torch.from_numpy(scales), torch.from_numpy(xs),
                            fmt=fmt, bk=bk)
    assert torch.equal(got, want)
