"""The plain versions of the port's decode-attention kernels (#7 bf16 cache,
#8 int8 cache) against the Pallas kernels in interpret mode on the CPU.

Cache rows, int8 codes and scales must be bit-exact.  The attention output
is float32 summed in another order (the Pallas kernel streams chunks
through an online softmax; the plain version takes one dense softmax), so
it is held to rtol 2e-5 and atol 2e-5, the tolerance of the JAX package's
own kernel-vs-composed test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.ops.decode_attention import (
    decode_attention_int8_pallas,
    decode_attention_pallas,
)
from vlut_tpu.runtime.kv_cache import quantize_kv as jax_quantize_kv
from vlut_tpu_torch.bench import attention_study as study
from vlut_tpu_torch.ops import _build, decode_attention as da
from vlut_tpu_torch.runtime import kv_cache

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(jnp.bfloat16)


def _inputs(b, s, hkv, g, hd, seed, hdv=None):
    rng = np.random.default_rng(seed)
    h, hdv = hkv * g, hdv or hd
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    q, kn, vn = f32(b, 1, h, hd), f32(b, 1, hkv, hd), f32(b, 1, hkv, hdv)
    kf, vf = f32(b, s, hkv, hd), f32(b, s, hkv, hdv)
    # ragged lengths incl. 0 (empty history) and S - 1 (full cache)
    start = np.asarray([0, 1, s // 2, s - 1][:b], np.int32)
    return q, kn, vn, kf, vf, start


CASES = [
    # (b, s, hkv, g, hd, window, cs): GQA over several chunks, one chunk,
    # a sliding window, MHA
    dict(b=4, s=96, hkv=2, g=2, hd=64, window=0, cs=32),
    dict(b=4, s=96, hkv=2, g=4, hd=128, window=0, cs=512),
    dict(b=4, s=96, hkv=2, g=2, hd=64, window=7, cs=32),
    dict(b=4, s=64, hkv=4, g=1, hd=64, window=0, cs=16),
    # the head shapes the kernel takes past G in (1, 2, 4, 8) and hdv = hd:
    # an odd G with hdv > hd, OuteTTS's G 7 with hdv < hd, G 12 at hd 256
    # (two groups of 6 in the kernel), falcon-7b's 71 over 1 (five groups)
    dict(b=4, s=96, hkv=2, g=3, hd=128, hdv=256, window=0, cs=32),
    dict(b=4, s=64, hkv=1, g=7, hd=256, hdv=128, window=9, cs=32),
    dict(b=4, s=64, hkv=2, g=12, hd=256, window=0, cs=32),
    dict(b=4, s=64, hkv=1, g=71, hd=128, window=0, cs=32),
]
IDS = ["gqa", "single_chunk", "window", "mha", "g3_hdv256", "g7_hdv128",
       "g12_hd256", "g71"]
# the seed of the first four cases' bf16 inputs (the others take their G)
SEED = 4


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_plain_matches_pallas(case):
    b, s, hkv, g, hd = (case[k] for k in ("b", "s", "hkv", "g", "hd"))
    hdv = case.get("hdv", hd)
    q, kn, vn, kf, vf, start = _inputs(b, s, hkv, g, hd,
                                       seed=SEED if g <= 4 else g, hdv=hdv)
    scale = 1.0 / float(np.sqrt(hd))
    kc_j = jnp.asarray(kf, jnp.bfloat16)
    vc_j = jnp.asarray(vf, jnp.bfloat16)
    want, kc_w, vc_w = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kc_j.copy(),
        vc_j.copy(), jnp.asarray(start), case["window"], scale=scale,
        cs=case["cs"], interpret=True)
    kc = torch.from_numpy(kf).to(torch.bfloat16)
    vc = torch.from_numpy(vf).to(torch.bfloat16)
    got = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), kc,
        vc, torch.from_numpy(start), case["window"], scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(_bf16_np(kc).view(np.uint16),
                                  np.asarray(kc_w).view(np.uint16))
    np.testing.assert_array_equal(_bf16_np(vc).view(np.uint16),
                                  np.asarray(vc_w).view(np.uint16))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_int8_plain_matches_pallas(case):
    b, s, hkv, g, hd = (case[k] for k in ("b", "s", "hkv", "g", "hd"))
    hdv = case.get("hdv", hd)
    q, kn, vn, kf, vf, start = _inputs(b, s, hkv, g, hd, seed=7, hdv=hdv)
    scale = 1.0 / float(np.sqrt(hd))
    quant = jax.jit(jax_quantize_kv)
    kc_j, ksc_j = quant(jnp.asarray(kf))
    vc_j, vsc_j = quant(jnp.asarray(vf))
    want, kc_w, vc_w, ksc_w, vsc_w = decode_attention_int8_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kc_j.copy(),
        vc_j.copy(), jnp.asarray(start), case["window"], ksc_j.copy(),
        vsc_j.copy(), scale=scale, cs=case["cs"], interpret=True)
    kc, ksc = kv_cache.quantize_kv(torch.from_numpy(kf))
    vc, vsc = kv_cache.quantize_kv(torch.from_numpy(vf))
    got = da.decode_attention_int8(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), kc,
        vc, ksc, vsc, torch.from_numpy(start), case["window"], scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for mine, theirs in ((kc, kc_w), (vc, vc_w), (ksc, ksc_w), (vsc, vsc_w)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_write_skips_out_of_range_start():
    """A start outside [0, S) writes nothing (the kernel's rule too)."""
    q, kn, vn, kf, vf, _ = _inputs(2, 16, 2, 2, 64, seed=1)
    kc = torch.from_numpy(kf).to(torch.bfloat16)
    vc = torch.from_numpy(vf).to(torch.bfloat16)
    before = kc.clone()
    att = da.decode_attention(torch.from_numpy(q), torch.from_numpy(kn),
                              torch.from_numpy(vn), kc, vc,
                              torch.tensor([16, -1]), scale=0.125)
    assert torch.equal(kc, before) and bool(torch.isfinite(att).all())


@pytest.mark.parametrize("shape", [(3, 5, 2, 128), (1, 7, 8, 64)])
def test_quantize_kv_matches_jitted_jax(shape):
    """Codes and scales bit-equal to the JAX package's quantize_kv as its
    jitted engine step computes it (``amax / 127`` as a multiply by the
    float32 reciprocal)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 20.0, shape[:-1] + (1,))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero row: scale 0, codes 0
    q_j, s_j = jax.jit(jax_quantize_kv)(jnp.asarray(x))
    q_t, s_t = kv_cache.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    deq = kv_cache.dequantize_kv(q_t, s_t)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(q_j, np.float32) * np.asarray(s_j)[..., None])


# --- the Hopper kernel's arithmetic, emulated on the CPU --------------------
#
# csrc/decode_attention.cu computes in another order than the plain version:
# q * scale and p enter the tensor cores as three bf16 terms each, the mma
# sums 16 exact products per k-step into float32, the softmax runs online
# per 16-row stage (a lane keeps its own partial denominator), the warps'
# teams (the stages dealt in turn) and then the splits of `rows` cache rows
# meet in order.  A KV head's query heads run in groups of
# da.head_groups' size, whose m-tile count and the V width set the teams.
# The emulation below repeats that order; a kernel built on two terms, or
# merging the splits in the order the blocks arrive, fails these tests.

TERMS = 3  # bf16 terms of a float32 operand
NEG_F32 = -1e30


def _split_terms(x):
    """x (float32) as TERMS bf16 values (held as float32) summing to it."""
    out, r = [], x
    for _ in range(TERMS):
        t = r.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        r = r - t
    return out + [torch.zeros_like(x)] * (3 - TERMS)


def _mma(acc, a, b):
    """acc + a @ b as mma.sync sums it: exact products of bf16 values, one
    rounding to float32 per 16-wide k-step."""
    return (acc.double() + a.double() @ b.double()).float()


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _team_cfg(heads, hdv):
    """Teams of warps in a block of ``heads`` query heads (its m-tiles:
    ceil(heads / 4)) over V heads of width hdv: a team's warps split the
    value columns so that a lane keeps at most 64 accumulators."""
    mt = (heads + 3) // 4
    vw = mt * hdv // 128
    return 4 // (1 if vw <= 1 else 2 if vw <= 2 else 4)


def _emulate(q, kn, vn, kc, vc, ksc, vsc, start, window, scale, rows,
             arrival=None):
    """The kernel's output (B, 1, H, hdv) for caches kc/vc (bf16, or int8
    codes with scales ksc/vsc); ``arrival(b, kvh, n)`` is the order in
    which the n split blocks of a (slot, KV head, head group) finish."""
    b, s, hkv, hd = kc.shape
    h, hdv = q.shape[2], vc.shape[-1]
    g = h // hkv
    q8 = ksc is not None
    heads, _ = da.head_groups(g, hd, hdv)
    nt = _team_cfg(heads, hdv)
    kflat = kc.reshape(b * s, hkv, hd).float()
    vflat = vc.reshape(b * s, hkv, hdv).float()
    if q8:
        kn_q, kn_s = kv_cache.quantize_kv(kn[:, 0].float())
        vn_q, vn_s = kv_cache.quantize_kv(vn[:, 0].float())
        knv = kn_q.float() * kn_s[..., None]
        vnv = vn_q.float() * vn_s[..., None]
        ksf, vsf = ksc.reshape(b * s, hkv), vsc.reshape(b * s, hkv)
    else:
        knv = kn[:, 0].to(torch.bfloat16).float()
        vnv = vn[:, 0].to(torch.bfloat16).float()
    out = torch.zeros(b, 1, h, hdv)
    neg = torch.tensor(NEG_F32)
    for bi in range(b):
        st = int(start[bi])
        hi_r = min(st, s)
        lo_r = max(0, st - window + 1) if window > 0 else 0
        n_act = -(-(hi_r - lo_r) // rows) if hi_r > lo_r else 0
        for kvh, h0 in ((k, k * g + i) for k in range(hkv)
                        for i in range(0, g, heads)):
            gc = min(heads, (kvh + 1) * g - h0)  # the group's heads
            qs = q[bi, 0, h0:h0 + gc].float() * scale  # (gc, hd)
            qt = _split_terms(qs)
            splits = []
            for sp in range(max(n_act, 1)):
                r0 = lo_r + sp * rows
                r1 = min(hi_r, r0 + rows)
                nch = -(-(r1 - r0) // 16) if r1 > r0 else 0
                teams = [[neg.expand(gc).clone(), torch.zeros(gc, 4),
                          [torch.zeros(gc, hdv) for _ in range(3)]]
                         for _ in range(nt)]
                for c in range(nch):
                    team = c % nt
                    m, lp, acc = teams[team]
                    rb = r0 + 16 * c
                    idx = torch.arange(rb, rb + 16) + bi * s
                    inside = idx < b * s
                    kr = torch.where(inside[:, None],
                                     kflat[idx.clamp(max=b * s - 1), kvh], 0)
                    vr = torch.where(inside[:, None],
                                     vflat[idx.clamp(max=b * s - 1), kvh], 0)
                    sc = [torch.zeros(gc, 16) for _ in range(3)]
                    for ks in range(hd // 16):
                        d = slice(16 * ks, 16 * ks + 16)
                        for t in range(3):
                            sc[t] = _mma(sc[t], qt[t][:, d], kr[:, d].T)
                    score = (sc[0] + sc[2]) + sc[1]
                    valid = (torch.arange(rb, rb + 16) < r1)[None, :]
                    if q8:
                        ks_r = torch.where(inside, ksf[idx.clamp(
                            max=b * s - 1), kvh], 0)
                        score = score * ks_r[None, :]
                    score = torch.where(valid, score, neg)
                    m_new = torch.maximum(m, score.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(valid, torch.exp(score - m_new[:, None]),
                                    torch.zeros(()))
                    # lane t's rows 2t, 2t+1, 8+2t, 9+2t, summed in order
                    pl = p.view(gc, 2, 4, 2)
                    part = ((pl[:, 0, :, 0] + pl[:, 0, :, 1]) + pl[:, 1, :, 0]
                            ) + pl[:, 1, :, 1]
                    lp = _fma(lp, alpha[:, None], part)
                    if q8:
                        vs_r = torch.where(inside, vsf[idx.clamp(
                            max=b * s - 1), kvh], 0)
                        pv = torch.where(valid, p * vs_r[None, :],
                                         torch.zeros(()))
                    else:
                        pv = p
                    pt = _split_terms(pv)
                    acc = [_mma(acc[t] * alpha[:, None], pt[t], vr)
                           for t in range(3)]
                    teams[team] = [m_new, lp, acc]
                states = []
                for m, lp, acc in teams:
                    lsum = (lp[:, 0] + lp[:, 1]) + (lp[:, 2] + lp[:, 3])
                    states.append((m, lsum, (acc[0] + acc[2]) + acc[1]))
                splits.append(_merge(states))
            if n_act > 1:
                # the last block to arrive merges, reading the states in
                # split order whatever the arrival
                came = arrival(bi, kvh, n_act) if arrival else range(n_act)
                order = sorted(came)
                state = _merge([splits[i] for i in order])
            else:
                state = splits[0]
            out[bi, 0, h0:h0 + gc] = _finish(state, qs, knv[bi, kvh],
                                             vnv[bi, kvh])
    return out



def _merge(states):
    """(m, l, numerator) states merged in the given order."""
    mm = states[0][0]
    for m, _, _ in states[1:]:
        mm = torch.maximum(mm, m)
    ll = torch.zeros_like(mm)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        f = torch.exp(m - mm)
        ll = _fma(l, f, ll)
        acc = _fma(a, f[:, None], acc)
    return mm, ll, acc


def _finish(state, qs, knv, vnv):
    """The new token's term: a lane's fma chain over its hd / 32 elements,
    then a butterfly over the warp; the output row of each head."""
    mm, ll, acc = state
    g, hd = qs.shape
    epl = hd // 32
    prod = qs.view(g, 32, epl)
    lanes = torch.zeros(g, 32)
    for e in range(epl):
        lanes = _fma(prod[:, :, e], knv.view(32, epl)[None, :, e], lanes)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ o]
    sn = lanes[:, 0]
    m_new = torch.maximum(mm, sn)
    alpha = torch.exp(mm - m_new)
    pn = torch.exp(sn - m_new)
    l_new = _fma(ll, alpha, pn)
    num = _fma(acc, alpha[:, None], pn[:, None] * vnv[None, :])
    return num / l_new[:, None]


def _emu_inputs(b, s, hkv, g, hd, seed, q_spread=0.0, hdv=None):
    """_inputs with starts that give several splits of 32 rows, and q's
    elements spread over 2^-q_spread..2^q_spread in magnitude."""
    q, kn, vn, kf, vf, _ = _inputs(b, s, hkv, g, hd, seed, hdv)
    rng = np.random.default_rng(seed + 1)
    if q_spread:
        q = (q * np.exp2(rng.uniform(-q_spread, q_spread, q.shape))
             ).astype(np.float32)
    start = np.asarray([0, 50, s - 1, 17][:b], np.int32)
    return q, kn, vn, kf, vf, start


def _emulate_case(q8, g, hd, window, seed, q_spread=0.0, arrival=None,
                  hdv=None, hkv=2):
    """(emulated kernel, plain version, JAX kernel in interpret mode)."""
    b, s = 3, 96
    q, kn, vn, kf, vf, start = _emu_inputs(b, s, hkv, g, hd, seed, q_spread,
                                           hdv)
    scale = 1.0 / float(np.sqrt(hd))
    tq, tkn, tvn, tst = (torch.from_numpy(x) for x in (q, kn, vn, start))
    if q8:
        kc, ksc = kv_cache.quantize_kv(torch.from_numpy(kf))
        vc, vsc = kv_cache.quantize_kv(torch.from_numpy(vf))
        got = _emulate(tq, tkn, tvn, kc, vc, ksc, vsc, tst, window, scale, 32,
                       arrival)
        plain = da.decode_attention_int8_plain(
            tq, tkn, tvn, kc.clone(), vc.clone(), ksc.clone(), vsc.clone(),
            tst, window, scale=scale)
        quant = jax.jit(jax_quantize_kv)
        kc_j, ksc_j = quant(jnp.asarray(kf))
        vc_j, vsc_j = quant(jnp.asarray(vf))
        want = decode_attention_int8_pallas(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kc_j, vc_j,
            jnp.asarray(start), window, ksc_j, vsc_j, scale=scale, cs=32,
            interpret=True)[0]
    else:
        kc = torch.from_numpy(kf).to(torch.bfloat16)
        vc = torch.from_numpy(vf).to(torch.bfloat16)
        got = _emulate(tq, tkn, tvn, kc, vc, None, None, tst, window, scale,
                       32, arrival)
        plain = da.decode_attention_plain(tq, tkn, tvn, kc.clone(), vc.clone(),
                                          tst, window, scale=scale)
        want = decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16),
            jnp.asarray(start), window, scale=scale, cs=32,
            interpret=True)[0]
    return got.numpy(), plain.numpy(), np.asarray(want)


EMULATED = [
    (1, 128, 128, 0), (2, 256, 256, 0), (4, 128, 128, 9), (8, 128, 128, 0),
    (8, 256, 256, 9), (4, 256, 256, 0),
    # head groups: G 7 (one group of two m-tiles), G 12 at hd 256 (two
    # groups of 6), G 71 (five groups, 15 heads but the last's 11), and
    # hdv != hd (the teams set by hdv)
    (7, 128, 128, 0), (12, 256, 256, 9), (71, 128, 128, 0), (3, 128, 256, 0),
    (4, 256, 128, 9)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g,hd,hdv,window", EMULATED, ids=[
    f"{g}-{hd}-{window}" if hdv == hd else f"{g}-{hd}-{hdv}-{window}"
    for g, hd, hdv, window in EMULATED])
def test_kernel_order_emulated(q8, g, hd, hdv, window):
    """The kernel's arithmetic (three-term operands, float32 per k-step,
    online softmax per stage, teams and splits merged in order) within
    1e-5 of the plain version and 2e-5 of the JAX kernel."""
    got, plain, want = _emulate_case(q8, g, hd, window, seed=g + hd,
                                     hdv=hdv, hkv=1 if g > 8 else 2)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_kernel_order_emulated_wide_q(q8):
    """q's elements spread over many binary orders of magnitude: two bf16
    terms (16 significant bits) put the scores off by more than the
    tolerance; three are exact."""
    got, plain, want = _emulate_case(q8, 4, 128, 0, seed=3, q_spread=Q_SPREAD)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, **TOL)


Q_SPREAD = 5.0


@pytest.mark.parametrize("q8,g", [
    (False, 2), (True, 2), (False, 7), (True, 7), (False, 71), (True, 71)],
    ids=["bf16", "int8", "bf16-g7", "int8-g7", "bf16-g71", "int8-g71"])
def test_kernel_merge_is_independent_of_arrival(q8, g):
    """Whichever split block arrives last, the output is bit-identical: the
    last block merges the splits' states in split order."""
    outs = [
        _emulate_case(q8, g, 128, 0, seed=11, hkv=1 if g > 8 else 2,
                      arrival=(lambda b, kvh, n, r=r: list(r.permutation(n))))[0]
        for r in (np.random.default_rng(i) for i in range(3))]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_attn_plan_fills_half_a_wave_at_every_plan_shape():
    """At each PLAN_SHAPES entry a full cache gives at least half a wave of
    blocks (of (slot, KV head, head group)) on 132 SMs (or the plan takes
    the fewest rows), and the list reaches every rows-per-block choice and
    a shape whose head groups move the plan."""
    seen, moved = set(), False
    for b, hkv, s, g in da.PLAN_SHAPES:
        groups = da.head_groups(g, 128, 128)[1]
        rows = da.attn_plan(b, hkv, s, 132, groups)
        assert rows in da.ROWS and rows % 16 == 0
        assert (2 * b * hkv * groups * -(-s // rows) >= 132
                or rows == da.ROWS[0])
        seen.add(rows)
        moved |= rows != da.attn_plan(b, hkv, s, 132)
    assert seen == set(da.ROWS) and moved


PLANNED = [
    (32, 8, 2048, 0, 4), (32, 8, 2048, 512, 4), (1, 8, 552, 0, 4),
    (32, 8, 552, 0, 4), (32, 8, 184, 0, 4), (4, 2, 256, 0, 2), (1, 1, 1, 0, 1),
    (1, 2, 8192, 0, 7), (16, 1, 2048, 0, 71), (16, 1, 2048, 0, 48)]


@pytest.mark.parametrize("b,hkv,s,window,g", PLANNED, ids=[
    f"{b}-{hkv}-{s}-{window}" + (f"-g{g}" if g > 4 else "")
    for b, hkv, s, window, g in PLANNED])
def test_attn_plan_rows(b, hkv, s, window, g):
    """The plan takes the most rows per block that still give a full cache
    half a wave of blocks (of (slot, KV head, head group)), else the
    fewest; a window caps the span."""
    span = da.span(s, window)
    units = b * hkv * da.head_groups(g, 128, 128)[1]
    rows = da.attn_plan(b, hkv, span, 132, units // (b * hkv))
    assert rows == da.ROWS[0] or 2 * units * -(-span // rows) >= 132
    bigger = [r for r in da.ROWS if r > rows]
    assert all(2 * units * -(-span // r) < 132 for r in bigger)


def test_head_groups():
    """The fewest groups of at most 4 x 512 / max(hd, hdv) heads, equal but
    the last; G <= 8 at hd 128 or 256 stays one group (one block
    per KV head, as before head groups)."""
    for g in (1, 2, 4, 8):
        for hd in (128, 256):
            assert da.head_groups(g, hd, hd) == (g, 1)
    assert da.head_groups(7, 128, 128) == (7, 1)
    assert da.head_groups(71, 128, 128) == (15, 5)
    assert da.head_groups(48, 128, 128) == (16, 3)
    assert da.head_groups(12, 256, 256) == (6, 2)
    assert da.head_groups(4, 512, 128) == (4, 1)
    assert da.head_groups(5, 384, 128) == (3, 2)
    for g in range(1, 80):
        for hd, hdv in ((128, 128), (256, 128), (512, 384)):
            heads, n = da.head_groups(g, hd, hdv)
            assert heads * n >= g > heads * (n - 1)
            assert heads <= 4 * (512 // max(hd, hdv))


@pytest.mark.parametrize("name", [*sorted(study.ABLATIONS), "timeline"])
def test_study_edits_match_the_kernel_source(name):
    """bench/attention_study.py's ablations and timeline patch the kernel's
    lines by text: each edit still finds its line in the source."""
    src = (_build.CSRC / study.SOURCE).read_text()
    for old, new in {**study.ABLATIONS, "timeline": study.TIMELINE}[name]:
        assert old in src, old
        src = src.replace(old, new, 1)
