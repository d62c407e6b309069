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
    bm, bn, splits = tg.tiled_plan(m, np_, kp, fmt, sms=132)
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
                                     fmt, sms=132)
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


# --- kernels 1 and 4: the decode GEMM's data order emulated on the CPU -------


def _dcfg(m, bn, fmt):
    """csrc/decode_gemm.cu Cfg: (L, Nw, WN, WK, x boxes, rows)."""
    kb = 128 if fmt == "i2" else 160
    mtl = -(-m // 16)
    el = 4 if fmt == "i2" and mtl <= 2 else 2
    wn = bn // (32 * el)
    wk = 8 // wn
    assert wk == tg.decode_stage_blocks(m, bn, fmt)
    return el, 32 * el, wn, wk, -(-wk * kb // 128), 16 * mtl


def _tma_box(src, c0, c1, rows):
    """A 128-byte x ``rows`` box of the 2-D uint8 ``src`` at (c0 inner, c1
    outer) as the TMA unit writes it: zero past the tensor, each row's
    16-byte units XORed with the row % 8 (the 128-byte swizzle)."""
    box = np.zeros((rows, 128), np.uint8)
    sub = src[c1:c1 + rows, c0:c0 + 128]
    box[:sub.shape[0], :sub.shape[1]] = sub
    r = np.arange(rows)[:, None]
    b = np.arange(128)[None, :]
    out = np.zeros(rows * 128, np.uint8)
    out[r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)] = box
    return out


def _word(mem, addr):
    """Little-endian uint32 words of ``mem`` at byte addresses ``addr``."""
    return (mem[addr].astype(np.uint32) | mem[addr + 1].astype(np.uint32) << 8
            | mem[addr + 2].astype(np.uint32) << 16
            | mem[addr + 3].astype(np.uint32) << 24)


def _transpose4(v):
    """csrc transpose4: byte j of v[i] becomes byte i of v[j]."""
    b = [[(v[i] >> (8 * j)) & 0xFF for j in range(4)] for i in range(4)]
    return [b[0][j] | b[1][j] << 8 | b[2][j] << 16 | b[3][j] << 24
            for j in range(4)]


def _i1_step(lo, hi):
    """csrc i1_step: the next base-3 digit of four bytes, two per lane."""
    ql = ((lo * 171) >> 9) & 0x007F007F
    qh = ((hi * 171) >> 9) & 0x007F007F
    return ((lo - 3 * ql) | ((hi - 3 * qh) << 8)) & 0xFFFFFFFF, ql, qh


def _bytes_of(reg):
    """(lanes,) uint32 -> (lanes, 4) unsigned bytes."""
    return np.stack([(reg >> (8 * i)) & 0xFF for i in range(4)], 1)


def _emulate_decode_gemm(codes, packed, m, fmt, bn, splits):
    """The decode GEMM's int32 sums (the fields' dot less the codes' row
    sums) as the kernel moves its data: each stage's TMA boxes, a consumer
    lane's word loads from the swizzled weight rows, the transposes, the
    fields (i2) or base-3 steps (i1) into B registers, ldmatrix's A from the
    swizzled code boxes, mma m16n8k32 per lane fragment, the K groups' adds
    in each block's reduction tiles, the splits' sums in the workspace (the
    kernel adds them as floats, exact below 2^24)."""
    kb = 128 if fmt == "i2" else 160
    nq = kb // 32
    kp, np_ = codes.shape[1], packed.shape[1]
    nb = kp // kb
    el, nw, wn_n, wk_n, nxb, rows = _dcfg(m, bn, fmt)
    mtl = rows // 16
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    work = np.zeros((m, np_), np.int64)
    for bx in range(np_ // bn):
        n0 = bx * bn
        for z in range(splits):
            p0 = z * nb // splits
            nbs = (z + 1) * nb // splits - p0
            red = np.zeros((rows, bn), np.int64)
            for s in range(-(-nbs // wk_n)):
                k0 = (p0 + s * wk_n) * kb
                xmem = np.concatenate([_tma_box(codes, k0 + 128 * b, 0, rows)
                                       for b in range(nxb)])
                wmem = np.concatenate([
                    _tma_box(packed, n0 + 128 * b, (p0 + s * wk_n) * 32,
                             wk_n * 32) for b in range(bn // 128)])
                for warp in range(8):
                    wn, wk = warp % wn_n, warp // wn_n
                    if s * wk_n + wk >= nbs:
                        continue
                    words = []  # [l][h][e] (lanes,) uint32
                    for l in range(el):
                        cb = wn * nw + 32 * l + 4 * g
                        bp = (cb >> 7) * wk_n * 32 * 128 + wk * 32 * 128
                        u, inn = (cb & 127) >> 4, cb & 15
                        words.append([_transpose4([
                            _word(wmem, bp + j * 128 + ((u ^ (j & 7)) << 4)
                                  + inn)
                            for j in (16 * h + 4 * t + i for i in range(4))])
                            for h in range(2)])
                    if fmt == "i1":
                        state = [[[[w & 0x00FF00FF, (w >> 8) & 0x00FF00FF]
                                   for w in wh] for wh in wl] for wl in words]
                    acc = np.zeros((mtl, 4 * el, 16, 8), np.int64)
                    for q in range(nq):
                        off = wk * kb + 32 * q + 16 * (lane >> 4)
                        a_tiles = []
                        for mt in range(mtl):
                            addr = ((off >> 7) * rows * 128 + mt * 16 * 128
                                    + (lane & 15) * 128
                                    + ((((off >> 4) & 7) ^ (lane & 7)) << 4))
                            # ldmatrix x4: register i of lane 4g + t is bytes
                            # 4t..4t+3 of row g of matrix i (lanes 8i..8i+7)
                            a = np.zeros((16, 32), np.int64)
                            for i in range(4):
                                reg = xmem[addr[8 * i + g][:, None] + 4 * t[:, None]
                                           + np.arange(4)].astype(np.int8)
                                r0, kk = g + 8 * (i & 1), 16 * (i >> 1) + 4 * t
                                a[r0[:, None], kk[:, None] + np.arange(4)] = reg
                            a_tiles.append(a)
                        for l in range(el):
                            for e in range(4):
                                if fmt == "i2":
                                    b0 = (words[l][0][e] >> (2 * q)) & 0x03030303
                                    b1 = (words[l][1][e] >> (2 * q)) & 0x03030303
                                else:
                                    regs = []
                                    for h in range(2):
                                        lo, hi = state[l][h][e]
                                        if q < 4:
                                            d, lo, hi = _i1_step(lo, hi)
                                            state[l][h][e] = [lo, hi]
                                        else:
                                            d = lo | (hi << 8)
                                        regs.append(d)
                                    b0, b1 = regs
                                bmat = np.zeros((32, 8), np.int64)
                                kk = 4 * t[:, None] + np.arange(4)
                                bmat[kk, g[:, None]] = _bytes_of(b0)
                                bmat[16 + kk, g[:, None]] = _bytes_of(b1)
                                assert bmat.max() <= 2
                                for mt in range(mtl):
                                    acc[mt, 4 * l + e] += a_tiles[mt] @ bmat
                    # D register e of lane 4g + t: row g + 8(e >> 1), mma
                    # column c = 2t + (e & 1) = column 4c + e2 of group l
                    for mt in range(mtl):
                        for l in range(el):
                            for e2 in range(4):
                                for e in range(4):
                                    row = mt * 16 + g + 8 * (e >> 1)
                                    c = 2 * t + (e & 1)
                                    col = wn * nw + 32 * l + 4 * c + e2
                                    np.add.at(red, (row, col),
                                              acc[mt, 4 * l + e2, row - mt * 16, c])
            work[:, n0:n0 + bn] += red[:m]
    return work - codes.view(np.int8).astype(np.int64).sum(1, keepdims=True)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m", [1, 17, 64])
@pytest.mark.parametrize("bn", [128, 256])
def test_decode_kernel_order_emulated(fmt, m, bn):
    """The decode GEMM's data order emulated on the CPU (x codes in natural
    order through swizzled TMA boxes, the weight ring's slots, the decode
    into B registers, mma fragments, the K groups' and splits' integer
    sums, the row-sum correction), then the epilogue with a residual: bit
    for bit _gemm_plain at every split of K."""
    kb = 128 if fmt == "i2" else 160
    k = 6 * kb - 37
    n = 256
    _, tt = _weights(k, n, fmt, True, seed=m + bn)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    xq, xs = tg.kernel_quantize(x)
    codes = np.zeros((m, tt.k_padded), np.int8)
    codes[:, :k] = xq.numpy()
    res = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    want = tg._gemm_plain(xq, xs, tt.packed, tt.scale_vector(), fmt, kb, k,
                          res, torch.float32)
    nb = tt.k_padded // kb
    for splits in range(1, min(nb, tg.MAX_SPLITS) + 1):
        acc = _emulate_decode_gemm(codes.view(np.uint8), tt.packed.numpy(), m,
                                   fmt, bn, splits)
        got = tg._epilogue_plain(torch.from_numpy(acc).to(torch.int32), xs,
                                 tt.scale_vector(), res, torch.float32)
        assert torch.equal(got, want), splits


_DECODE_PROJ = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                (4096, 1024), (4096, 14336)]


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m", [1, 17, 32, 33, 64])
@pytest.mark.parametrize("k,n", _DECODE_PROJ)
def test_decode_plan_fills_one_wave(fmt, m, k, n):
    """BN is 128 unless its tiles alone overfill the wave of 132 blocks
    (then 256 where Np allows); the splits keep the grid in one wave, as
    many as that allows while every range of K is at least one stage deep,
    at most 4, and none where the float sums could pass 2^24."""
    from vlut_tpu_torch.ops.packing import padded_k

    np_ = -(-n // 128) * 128
    kp = padded_k(k, fmt)
    nb = kp // (128 if fmt == "i2" else 160)
    bn, splits = tg.decode_plan(m, np_, kp, fmt, 132)
    assert bn == (256 if np_ // 128 > 132 and np_ % 256 == 0 else 128)
    tiles = np_ // bn
    stage = tg.decode_stage_blocks(m, bn, fmt)
    assert 1 <= splits <= min(nb, 4)
    assert splits == 1 or (tiles * splits <= 132 and nb // splits >= stage)
    assert splits == (1 if 254 * kp >= 1 << 24
                      else max(1, min(132 // tiles, nb // stage, 4)))


def test_decode_plan_shapes_reach_every_tile_and_split_count():
    """The card checks' shapes (ops/ternary_gemm.py:DECODE_PLAN_SHAPES) take
    every kernel instantiation the plan uses (16-row tiles 1-4; BN 128 with
    one split and with several, BN 256 with one; i2 and i1) and every split
    count in each format."""
    from vlut_tpu_torch.ops.packing import padded_k

    seen, counts = set(), {"i2": set(), "i1": set()}
    for m, k, n in tg.DECODE_PLAN_SHAPES:
        for fmt in ("i2", "i1"):
            bn, s = tg.decode_plan(m, -(-n // 128) * 128, padded_k(k, fmt),
                                   fmt, 132)
            seen.add((fmt, -(-m // 16), bn, s > 1))
            counts[fmt].add(s)
    assert seen == {(f, mt, bn, sp) for f in ("i2", "i1") for mt in range(1, 5)
                    for bn, sp in ((128, False), (128, True), (256, False))}
    assert all(c == set(range(1, tg.MAX_SPLITS + 1)) for c in counts.values())


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m,k,n", tg.DECODE_PLAN_SHAPES)
def test_decode_scratch_layout(fmt, m, k, n):
    """A call's one scratch allocation (the C call's codes, scales, row sums
    and split workspace, and the prologue's buffers when it runs alone):
    the parts are aligned for their types (the workspace to 16 bytes, for
    the kernel's vector adds), disjoint, and as large as the kernels write."""
    from vlut_tpu_torch.ops.packing import padded_k

    np_, kp = -(-n // 128) * 128, padded_k(k, fmt)
    bn, splits = tg.decode_plan(m, np_, kp, fmt, 132)
    xs, rowsum, work, nbytes = tg._scratch_layout(m, kp, np_, bn, splits)
    assert (xs, rowsum) == (m * kp, m * kp + 4 * m) and xs % 16 == 0
    if splits == 1:
        assert work is None and nbytes == rowsum + 4 * m
    else:
        assert work % 16 == 0 and rowsum + 4 * m <= work < rowsum + 4 * m + 16
        assert nbytes == work + 4 * (m * np_ + np_ // bn)
    codes, xs_t, rs_t, work_t = tg._decode_buffers(m, kp, np_, bn, splits,
                                                   torch.device("cpu"))
    base = codes.data_ptr()
    assert codes.shape == (m, kp) and codes.dtype == torch.int8
    assert xs_t.shape == (m,) and xs_t.data_ptr() == base + xs
    assert rs_t.dtype == torch.int32 and rs_t.data_ptr() == base + rowsum
    if splits > 1:
        assert work_t.data_ptr() == base + work
        assert work_t.numel() == m * np_ + np_ // bn
    else:
        assert work_t is None


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


def _kv_layer(b, s, hkv, hd, q8, seed, g=2):
    """A layer's update as the composed path hands it to #5 (numpy): the
    caches, K rows, V rows as a strided column slice of a fused qkv output
    and starts; for q8 the codes and the (B, S, Hkv) scale planes."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, 1, (g + 2) * hkv * hd)).astype(np.float32)
    qd, kvd = g * hkv * hd, hkv * hd
    k = qkv[..., qd:qd + kvd].reshape(b, 1, hkv, hd)
    start = rng.integers(0, s, b)
    start[0], start[-1] = 0, s - 1
    caches = [rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
              for _ in range(2)]
    if not q8:
        return caches, [k, qkv], start
    codes = [rng.integers(-127, 128, (b, s, hkv, hd)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0, 1, (b, s, hkv)).astype(np.float32)
              for _ in range(2)]
    rows = [rng.integers(-127, 128, (b, 1, hkv, hd)).astype(np.int8),
            rng.integers(-127, 128, (b, 1, hkv, hd)).astype(np.int8),
            rng.uniform(0, 1, (b, 1, hkv)).astype(np.float32),
            rng.uniform(0, 1, (b, 1, hkv)).astype(np.float32)]
    return codes + scales, rows, start


def _torch_rows(rows, q8, hkv, hd, g=2):
    """The rows as torch tensors, V (bf16) a strided slice of the qkv."""
    if q8:
        return [torch.from_numpy(r) for r in rows]
    k, qkv = rows
    qkv_t = torch.from_numpy(qkv).to(torch.bfloat16)
    v = qkv_t[..., (g + 1) * hkv * hd:].reshape(qkv.shape[0], 1, hkv, hd)
    assert not v.is_contiguous()
    return [torch.from_numpy(k).to(torch.bfloat16), v]


@pytest.mark.parametrize("st_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_kv_writer_layer_forms_match_pallas(q8, st_dtype):
    """The layer's update in one call (K, V and, for q8, the two scale
    planes; V a strided slice of the fused qkv; int32 or int64 starts) is
    the JAX kernels' update bit for bit (interpret mode)."""
    b, s, hkv, hd = 3, 9, 2, 128
    caches, rows, start = _kv_layer(b, s, hkv, hd, q8, seed=11)
    trows = _torch_rows(rows, q8, hkv, hd)
    if q8:
        tc = [torch.from_numpy(c.copy()) for c in caches]
        jrows = rows
    else:
        tc = [torch.from_numpy(c).to(torch.bfloat16) for c in caches]
        jrows = [r.float().numpy() for r in trows]
    jdt = [jnp.bfloat16] * 2 if not q8 else [jnp.int8] * 2 + [jnp.float32] * 2
    want = []
    for a in range(0, len(caches), 2):
        want += jkv.write_rows_pair_pallas(
            jnp.asarray(caches[a], jdt[a]), jnp.asarray(caches[a + 1],
                                                        jdt[a + 1]),
            jnp.asarray(jrows[a], jdt[a]), jnp.asarray(jrows[a + 1],
                                                       jdt[a + 1]),
            jnp.asarray(start, jnp.int32), interpret=True)
    out = tkv.write_rows_pair(tc[0], tc[1], trows[0], trows[1],
                              torch.from_numpy(start).to(st_dtype),
                              scales=tuple(tc[2:] + trows[2:]) or None)
    assert out[0] is tc[0] and out[1] is tc[1]
    for got, w in zip(tc, want):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("bad", [-1, 9])
def test_kv_writer_plain_refuses_a_start_out_of_range(bad):
    kc, vc = torch.zeros(3, 9, 2, 128), torch.zeros(3, 9, 2, 128)
    u = torch.ones(3, 1, 2, 128)
    with pytest.raises(IndexError):
        tkv.write_rows_pair(kc, vc, u, u, torch.tensor([0, bad, 3]))
    with pytest.raises(IndexError):
        tkv.write_rows(kc, u, torch.tensor([bad, 0, 3]))


class _EmulatedWriter:
    """Stands in for the built library: takes the C call's arguments as the
    kernel would (every array's chunk size from its row size, slot stride
    and addresses; threads over (slot, array, chunk); a start outside [0,
    S) skipped) and performs the copies on the CPU tensors behind the
    pointers."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []

    @staticmethod
    def _bytes(t):
        raw = torch.empty(0, dtype=torch.uint8).set_(t.untyped_storage())
        return raw, t.storage_offset() * t.element_size()

    def vlut_write_rows(self, n, caches, rows, lds, nbytes, start, start64, b,
                        s, stream):
        self.calls.append(dict(n=n, lds=list(lds), nbytes=list(nbytes),
                               start64=start64, b=b, s=s))
        st = self.by_ptr[start].tolist()
        arrays = []
        for i in range(n):
            c, u = self.by_ptr[caches[i]], self.by_ptr[rows[i]]
            bits = caches[i] | rows[i] | lds[i] | nbytes[i]
            lg = 4
            while lg > 0 and bits & ((1 << lg) - 1):
                lg -= 1
            arrays.append((c, u, lds[i], nbytes[i], lg))
        per_slot = sum(rb >> lg for *_, rb, lg in arrays)
        for t in range(b * per_slot):
            slot, c = divmod(t, per_slot)
            if not 0 <= st[slot] < s:
                continue
            for cache, row, ld, rb, lg in arrays:
                if c < rb >> lg:
                    break
                c -= rb >> lg
            dst, d0 = self._bytes(cache)
            src, s0 = self._bytes(row)
            off = c << lg
            at = d0 + (slot * s + st[slot]) * rb + off
            frm = s0 + slot * ld + off
            dst[at:at + (1 << lg)] = src[frm:frm + (1 << lg)]
        return 0


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_kv_writer_launch_arguments_emulated(q8, monkeypatch):
    """The wrapper's one call (arrays, slot strides in bytes, row sizes,
    int64 starts) run through an emulation of the kernel's thread mapping
    gives the plain assignment, a start out of range skipped."""
    b, s, hkv, hd = 4, 7, 2, 128
    caches, rows, start = _kv_layer(b, s, hkv, hd, q8, seed=12)
    start[1] = s  # out of range: the kernel writes nothing there
    trows = _torch_rows(rows, q8, hkv, hd)
    tc = [torch.from_numpy(c.copy()) if q8 else torch.from_numpy(c).to(
        torch.bfloat16) for c in caches]
    want = [c.clone() for c in tc]
    ok = torch.from_numpy(start) < s
    for c, u in zip(want, trows):
        for slot in range(b):
            if ok[slot]:
                c[slot, start[slot]] = u[slot, 0]
    st = torch.from_numpy(start).long()
    lib = _EmulatedWriter(tc + trows + [st])
    monkeypatch.setattr(tkv, "_stream", lambda: 0)
    tkv._launch(tc, trows, st, lib=lib)
    (call,) = lib.calls
    assert call["n"] == len(tc) and call["start64"] == 1
    assert call["lds"] == [u.stride(0) * u.element_size() for u in trows]
    assert call["nbytes"] == [c[0, 0].numel() * c.element_size() for c in tc]
    if not q8:
        assert call["lds"][1] == 4 * hkv * hd * 2  # the fused qkv row
    for i, (got, w) in enumerate(zip(tc, want)):
        assert torch.equal(got[ok], w[ok]), i
        assert torch.equal(got[~ok], torch.from_numpy(caches[i]).to(
            got.dtype)[~ok]), i


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
