"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Integer paths must match bit for bit.  The float-prologue modes of the
decode kernel are held bit for bit (codes, scales and output) to
``decode_input_kernel_order``, the emulation of the kernel's own order of
operations; ``tests/test_torch_prologue_order.py`` bounds its distance from
the emulation held to the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from vlut_tpu_torch.ops import decode_attention as da
from vlut_tpu_torch.ops import kv_update, ternary_gemm as tg, tq
from vlut_tpu_torch.bench.attention_study import SHAPES as ATT_SHAPES
from vlut_tpu_torch.bench.kv_study import SHAPES as KV_SHAPES
from vlut_tpu_torch.ops.packing import pack_ternary

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _weights(k, n, fmt, seed):
    rng = np.random.default_rng(seed)
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    return pack_ternary(trits, rng.uniform(0.01, 0.1, n).astype(np.float32),
                        fmt)


def _tiled_matches_plain(dev, fmt, m, k, n, seed, strided=False):
    """#3 on the card equals its plain version bit for bit, in float32 and
    bf16; ``strided`` hands it x as a view whose rows are not 16-byte
    aligned."""
    t = _weights(k, n, fmt, seed=seed)
    packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    xd = xq.to(dev)
    if strided:
        wide = torch.zeros((m, k + 3), dtype=torch.int8, device=dev)
        wide[:, 3:] = xd
        xd = wide[:, 3:]
    for od in (torch.float32, torch.bfloat16):
        want = tg.ternary_gemm_tiled(xq, t.packed, xs, t.scale_vector(),
                                     fmt=fmt, kb=t.kb, k=k, out_dtype=od)
        before = tg.ternary_gemm_tiled.launches
        got = tg.ternary_gemm_tiled(xd, packed, xs.to(dev), ws, fmt=fmt,
                                    kb=t.kb, k=k, out_dtype=od)
        torch.cuda.synchronize()
        assert tg.ternary_gemm_tiled.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m", [1, 32, 40, 64, 65, 200, 256, 513])
def test_tiled_and_fused_quant_match_plain(dev, fmt, m):
    k, n = 1280, 384
    _tiled_matches_plain(dev, fmt, m, k, n, seed=m)
    # a K that is not a multiple of 16, x as a view with unaligned rows
    _tiled_matches_plain(dev, fmt, m, 1283, n, seed=m + 1, strided=True)
    t = _weights(k, n, fmt, seed=m)
    packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
    rng = np.random.default_rng(m)
    if m <= tg.MAX_DECODE_M:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        want = tg.ternary_gemm_fused_quant(x, t.packed, t.scale_vector(),
                                           fmt=fmt, kb=t.kb, k=k)
        got = tg.ternary_gemm_fused_quant(x.to(dev), packed, ws, fmt=fmt,
                                          kb=t.kb, k=k)
        assert torch.equal(got.cpu(), want)


# Shapes that make tiled_plan take each block row count (32, 64, 128) with
# one split and with several, and at K 3840 (i2: 30 pack blocks) the split
# counts 2, 3, 5, 6, 10 and 15 (tests/test_torch_gemm.py checks the plans).
TILED_PLAN_SHAPES = [
    (20, 2560, 17000), (200, 2560, 4224), (300, 1280, 8320), (1, 3840, 128),
    (32, 3840, 1664), (32, 3840, 2816), (32, 3840, 3200), (32, 3840, 4480),
    (32, 3840, 7040), (256, 3840, 128), (513, 3840, 1024)]


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m,k,n", TILED_PLAN_SHAPES)
def test_tiled_plan_shapes_match_plain(dev, fmt, m, k, n):
    _tiled_matches_plain(dev, fmt, m, k, n, seed=m + k + n)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("mode,sub_norm", [("plain", False), ("norm", False),
                                           ("silu_mul", False),
                                           ("silu_mul", True)])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m", [1, 17, 32, 33, 64])
def test_decode_matches_plain(dev, fmt, mode, sub_norm, with_res, m):
    _decode_case(dev, fmt, mode, sub_norm, with_res, m, 1280, 384)


@pytest.mark.parametrize("m", [1, 32, 64])
@pytest.mark.parametrize("k,n,mode,with_res", [
    (4096, 12288, "norm", False), (4096, 24576, "norm", False),
    (12288, 4096, "silu_mul", True)], ids=["qkv", "gateup", "down"])
def test_decode_float_prologue_at_llada_widths(dev, m, k, n, mode,
                                               with_res):
    """llada_8b's fused projections through #1 (a cluster of three blocks
    per row at K 12288) bit for bit against the kernel-order reference."""
    _decode_case(dev, "i2", mode, False, with_res, m, k, n)


def _decode_case(dev, fmt, mode, sub_norm, with_res, m, k, n):
    t = _weights(k, n, fmt, seed=3)
    packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
    rng = np.random.default_rng(4)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    x1 = randn(m, k, dtype=torch.float32 if mode == "plain" else torch.bfloat16)
    x2 = randn(m, k) if mode == "silu_mul" else None
    g = (torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32)).to(dev)
         if mode == "norm" or sub_norm else None)
    res = randn(m, n) if with_res else None
    od = torch.bfloat16 if with_res else torch.float32
    kw = dict(x2=x2, norm_g=g, residual=res, fmt=fmt, kb=t.kb, k=k, mode=mode,
              sub_norm=sub_norm, norm_n=k, eps=1e-5, out_dtype=od)
    got = tg.ternary_gemm_decode(x1, packed, ws, **kw).float()
    if mode == "plain":
        codes, xs = tg.decode_prologue(x1, x2, g, mode, sub_norm, k, 1e-5)
        want = tg._gemm_plain(codes, xs, packed, ws, fmt, t.kb, k, res,
                              od).float()
        assert torch.equal(got, want)
        return
    # the float prologue against its kernel-order emulation: codes, scales
    # and the output bit for bit
    codes, xs = tg.kernel_quantize(tg.decode_input_kernel_order(
        x1, x2, g, mode, sub_norm, k, 1e-5, t.k_padded))
    want = tg._gemm_plain(codes, xs, packed, ws, fmt, t.kb, k, res, od).float()
    codes_k, xs_k = tg.prologue_codes(x1, x2, g, mode, sub_norm, k, 1e-5,
                                      t.k_padded)
    assert torch.equal(codes_k, codes)
    assert torch.equal(xs_k.reshape(-1), xs.reshape(-1))
    assert torch.equal(got, want)


def _decode_matches_plain(dev, fmt, m, k, n, seed, plans=(None,)):
    """#1 (plain mode, bf16 residual narrower than Np) and #4 on the card
    equal their plain versions bit for bit, as planned or at each forced
    (BN, splits)."""
    t = _weights(k, n, fmt, seed=seed)
    packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        torch.bfloat16)
    want = tg.ternary_gemm_decode(x, t.packed, t.scale_vector(), residual=res,
                                  fmt=fmt, kb=t.kb, k=k,
                                  out_dtype=torch.bfloat16)
    for plan in plans:
        if plan is None:
            before = tg.ternary_gemm_decode.launches
            got = tg.ternary_gemm_decode(x.to(dev), packed, ws,
                                         residual=res.to(dev), fmt=fmt,
                                         kb=t.kb, k=k, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            assert tg.ternary_gemm_decode.launches == before + 1
        else:
            got = tg._decode_cuda(x.to(dev), packed, ws, None, None,
                                  res.to(dev), fmt, t.kb, "plain", False, 0,
                                  0.0, torch.bfloat16, plan=plan)
        assert torch.equal(got.cpu(), want), plan
    fq = tg.ternary_gemm_fused_quant(x.to(dev), packed, ws, fmt=fmt, kb=t.kb,
                                     k=k)
    assert torch.equal(fq.cpu(), tg.ternary_gemm_fused_quant(
        x, t.packed, t.scale_vector(), fmt=fmt, kb=t.kb, k=k))


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m,k,n", tg.DECODE_PLAN_SHAPES)
def test_decode_plan_shapes_match_plain(dev, fmt, m, k, n):
    _decode_matches_plain(dev, fmt, m, k, n, seed=m + k + n)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m,k,n", [(17, 3840, 512), (64, 3840, 384)])
def test_decode_every_tile_and_split_matches_plain(dev, fmt, m, k, n):
    from vlut_tpu_torch.ops.packing import padded_k

    nb = padded_k(k, fmt) // (128 if fmt == "i2" else 160)
    np_ = -(-n // 128) * 128
    _decode_matches_plain(dev, fmt, m, k, n, seed=m + n, plans=[
        (bn, s) for bn in (128, 256) if np_ % bn == 0
        for s in range(1, min(nb, tg.MAX_SPLITS) + 1)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_writer_matches_plain(dev, dtype):
    b, s, h, d = 5, 40, 2, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    kc = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    vc = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    ku = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    vu = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    start = torch.tensor([0, 39, 7, 7, 20], dtype=torch.int32, device=dev)
    wk, wv = kc.clone(), vc.clone()
    kv_update._write_plain(wk, ku, start)
    kv_update._write_plain(wv, vu, start)
    before = kv_update.write_rows_pair.launches
    out = kv_update.write_rows_pair(kc, vc, ku, vu, start)
    assert out[0] is kc and out[1] is vc
    assert kv_update.write_rows_pair.launches == before + 1
    assert torch.equal(kc, wk) and torch.equal(vc, wv)
    one, w1 = kc.clone(), kc.clone()
    kv_update._write_plain(w1, vu, start)
    kv_update.write_rows(one, vu, start)
    assert torch.equal(one, w1)


def kv_layer_inputs(dev, b, s, hkv, q8, seed):
    from vlut_tpu_torch.bench.kv_study import layer_update

    return layer_update(torch.Generator(device=dev).manual_seed(seed), b, s,
                        hkv, q8)


@pytest.mark.parametrize("b,s,hkv,q8", [sh[1:] for sh in KV_SHAPES])
def test_kv_writer_takes_the_layer_tensors(dev, b, s, hkv, q8):
    """One launch writes every array of the layer (K, V and the q8 scale
    planes) from the rows as the layer gives them (V strided, int64
    starts), bit for bit as the plain assignment; int32 starts too."""
    caches, rows, start = kv_layer_inputs(dev, b, s, hkv, q8, seed=s + b)
    assert not rows[1].is_contiguous() or q8
    for st in (start, start.to(torch.int32)):
        want = [c.clone() for c in caches]
        for c, u in zip(want, rows):
            kv_update._write_plain(c, u, st)
        before = kv_update.write_rows_pair.launches
        kv_update.write_rows_pair(
            caches[0], caches[1], rows[0], rows[1], st,
            scales=tuple(caches[2:] + rows[2:]) or None)
        torch.cuda.synchronize()
        assert kv_update.write_rows_pair.launches == before + 1
        for got, w in zip(caches, want):
            assert torch.equal(got, w)


def test_kv_writer_skips_starts_out_of_range(dev):
    caches, rows, start = kv_layer_inputs(dev, 6, 40, 2, True, seed=5)
    start[1], start[4] = -1, 40
    ok = (start >= 0) & (start < 40)
    want = [c.clone() for c in caches]
    for c, u in zip(want, rows):
        c[ok.nonzero()[:, 0], start[ok]] = u[ok][:, 0]
    kv_update.write_rows_pair(caches[0], caches[1], rows[0], rows[1], start,
                              scales=tuple(caches[2:] + rows[2:]))
    torch.cuda.synchronize()
    for got, w in zip(caches, want):
        assert torch.equal(got, w)
    with pytest.raises(IndexError):
        kv_update._write_plain(want[0], rows[0], start)


def _attn_inputs(dev, b, s, hkv, g, hd, seed, starts=None, hdv=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
    if starts is None:
        start = torch.randint(0, s, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        start[0], start[-1] = 0, s - 1
    else:
        start = torch.tensor(starts, device=dev, dtype=torch.int32)
    hdv = hdv or hd
    return (rn(b, 1, hkv * g, hd), rn(b, 1, hkv, hd), rn(b, 1, hkv, hdv),
            rn(b, s, hkv, hd), rn(b, s, hkv, hdv), start)


def _hidden(start, s, window):
    """(B, S) bool: the cache rows a slot does not see."""
    idx = torch.arange(s, device=start.device)[None, :]
    st = start.long()[:, None]
    hidden = idx >= st
    if window:
        hidden |= idx <= st - window
    return hidden


# Attention outputs are float32 sums taken in another order than the plain
# version's dense softmax (per-stage online softmax, then the merge of the
# warps' and the splits' states), so they are held to rtol 1e-5 and atol
# 1e-5; cache rows, codes and scales must be bit-exact, and two calls on
# the same inputs bit-identical.
ATT_TOL = dict(rtol=1e-5, atol=1e-5)

# (B, S, Hkv, G, hd, window, starts, large finite values in the rows a slot
# does not see): GQA shapes with and without a window; the plan's shapes
# (ops/decode_attention.py:PLAN_SHAPES); B 1; starts 0, S - 1 and out of
# range (the write skipped)
_ATT_BASE = [(5, 300, hkv, g, hd, w, None, False)
             for hkv, g, hd in ((8, 4, 128), (2, 1, 128), (4, 8, 256),
                                (2, 2, 256))
             for w in (0, 37)]
_ATT_MORE = (
    [(b, s, hkv, g, 256 if i % 3 == 2 and g <= 8 else 128, 0, None, False)
     for i, (b, hkv, s, g) in enumerate(da.PLAN_SHAPES)]
    + [(1, 40, 8, 4, 128, 0, [39], False)]
    + [(5, 300, 2, 4, 128, w, [0, 299, 300, -1, 17], True) for w in (0, 37)])


def _attn_check(dev, q8, b, s, hkv, g, hd, window, starts, hide, seed,
                hdv=None):
    from vlut_tpu_torch.runtime.kv_cache import quantize_kv

    q, kn, vn, kf, vf, start = _attn_inputs(dev, b, s, hkv, g, hd, seed,
                                            starts, hdv)
    if q8:
        (kc, ksc), (vc, vsc) = quantize_kv(kf), quantize_kv(vf)
        cache = [kc, vc, ksc, vsc]
    else:
        cache = [kf.to(torch.bfloat16), vf.to(torch.bfloat16)]
    if hide:
        hidden = _hidden(start, s, window)
        for t in cache[:2]:
            t[hidden] = 127 if q8 else 3e38
        for t in cache[2:]:
            t[hidden] = 1e30
    ref = [t.clone() for t in cache]
    plain = da.decode_attention_int8_plain if q8 else da.decode_attention_plain
    kernel = da.decode_attention_int8 if q8 else da.decode_attention
    want = plain(q, kn, vn, *ref, start, window, scale=hd ** -0.5)
    outs = []
    for _ in range(2):
        mine = [t.clone() for t in cache]
        before = kernel.launches
        got = kernel(q, kn, vn, *mine, start, window, scale=hd ** -0.5)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        torch.testing.assert_close(got, want, **ATT_TOL)
        for m, r in zip(mine, ref):
            assert torch.equal(m, r)
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("case", _ATT_BASE + _ATT_MORE)
def test_decode_attention_matches_plain(dev, case):
    _attn_check(dev, False, *case, seed=case[3])


@pytest.mark.parametrize("case", [c for c in _ATT_BASE if c[2:5] != (
    2, 2, 256)] + _ATT_MORE)
def test_decode_attention_int8_matches_plain(dev, case):
    _attn_check(dev, True, *case, seed=9)


# (B, S, Hkv, G, hd, hdv, window, starts, hidden rows): the head shapes
# past G in (1, 2, 4, 8) and hdv = hd: OuteTTS's G 7, falcon-7b's 71 and
# starcoder's 48 over one KV head (five and three head groups), G 3 and 12
# at hd 256, hdv != hd both ways, hd 384 and 512
_ATT_GROUPS = [
    (3, 300, 2, 7, 128, 128, 0, None, False),
    (3, 300, 2, 7, 128, 128, 37, [0, 299, 150], True),
    (4, 300, 1, 71, 128, 128, 37, [0, 299, 300, 17], True),
    (4, 300, 1, 48, 128, 128, 0, None, False),
    (4, 300, 2, 3, 256, 256, 0, None, False),
    (4, 300, 2, 12, 256, 256, 37, None, False),
    (4, 300, 2, 4, 128, 256, 0, None, False),
    (4, 300, 2, 4, 256, 128, 37, None, False),
    (2, 300, 2, 5, 384, 128, 0, None, False),
    (4, 300, 2, 4, 512, 512, 0, None, False),
]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", _ATT_GROUPS)
def test_decode_attention_head_groups_and_widths(dev, q8, case):
    """#7 / #8 at any group size (head groups) and hd, hdv each up to 512:
    rows, codes and scales bit-exact, the output within ATT_TOL, two calls
    bit-identical, one launch."""
    b, s, hkv, g, hd, hdv, window, starts, hide = case
    _attn_check(dev, q8, b, s, hkv, g, hd, window, starts, hide, seed=g,
                hdv=hdv)


# the wide path (hd or hdv above 512: K pieces, V slices) at chip_smoke.py
# phase 2's shapes (bench/attention_study.py:SHAPES): DeepSeek-V2-Lite's
# latent widths, 1024 / 1024, 128 / 2048, 2048 / 128, 4096 / 4096, G 7 at
# 768 over 8,192 rows
_ATT_WIDE = [sh for sh in ATT_SHAPES if da.wide(sh[5], sh[6])]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", _ATT_WIDE, ids=[sh[0] for sh in _ATT_WIDE])
def test_decode_attention_wide_heads(dev, q8, shape):
    """#7 / #8 past heads of 512 against the plain version: rows, codes and
    scales (over the whole rows) bit-exact, the output within ATT_TOL, two
    calls bit-identical, one launch."""
    _, b, s, hkv, g, hd, hdv, window, starts = shape
    starts = ([starts] * b if isinstance(starts, int) else
              np.linspace(s // 16, s - 1, b).round().astype(int).tolist())
    _attn_check(dev, q8, b, s, hkv, g, hd, window, starts, False, seed=g,
                hdv=hdv)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_decode_attention_takes_the_layer_tensors(dev, q8):
    """The tensors _layer_step hands the kernel (bf16 q and new rows, v a
    strided slice of the qkv output, int64 starts) go in as they are."""
    from vlut_tpu_torch.runtime.kv_cache import quantize_kv

    b, s, hkv, g, hd = 4, 200, 2, 2, 128
    q, kn, vn, kf, vf, start = _attn_inputs(dev, b, s, hkv, g, hd, 3)
    qkv = torch.cat([q, kn, vn], dim=2).reshape(b, 1, -1).to(torch.bfloat16)
    qd, kvd = hkv * g * hd, hkv * hd
    qb = qkv[..., :qd].reshape(b, 1, hkv * g, hd).contiguous()
    kb = qkv[..., qd:qd + kvd].reshape(b, 1, hkv, hd).contiguous()
    vb = qkv[..., qd + kvd:].reshape(b, 1, hkv, hd)
    assert not vb.is_contiguous()
    st = start.long()
    if q8:
        (kc, ksc), (vc, vsc) = quantize_kv(kf), quantize_kv(vf)
        cache = [kc, vc, ksc, vsc]
    else:
        cache = [kf.to(torch.bfloat16), vf.to(torch.bfloat16)]
    ref = [t.clone() for t in cache]
    plain = da.decode_attention_int8_plain if q8 else da.decode_attention_plain
    kernel = da.decode_attention_int8 if q8 else da.decode_attention
    want = plain(qb, kb, vb, *ref, st, 0, scale=hd ** -0.5)
    got = kernel(qb, kb, vb, *cache, st, 0, scale=hd ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATT_TOL)
    for m, r in zip(cache, ref):
        assert torch.equal(m, r)


def test_quantize_kv_same_on_card_and_cpu(dev):
    from vlut_tpu_torch.runtime.kv_cache import quantize_kv

    x = torch.randn((64, 8, 128), generator=torch.Generator().manual_seed(1))
    x = x * torch.rand((64, 8, 1), generator=torch.Generator().manual_seed(2))
    qc, sc = quantize_kv(x)
    qg, sg = quantize_kv(x.to(dev))
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_engine_tiny_real_card_equals_cpu(dev, q8):
    import pathlib

    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    path = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
    outs = []
    for device in ("cuda", "cpu"):
        cfg, model, _ = load_checkpoint(path, device=device)
        eng = Engine(cfg, model, n_slots=4, max_len=256, kv_quant=q8)
        reqs = [Request(prompt=[2] + list(p), max_new_tokens=12,
                        sampler=SamplerParams(temperature=0.0))
                for p in (b"The little model", b"reads", b"its own repo.")]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def _tiny_real(device):
    import pathlib

    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    path = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
    cfg, model, _ = load_checkpoint(path, device=device)
    return cfg, model


def _engine_tokens(device, q8, decode_attn, cuda_graph, samplers):
    from vlut_tpu_torch import ops
    from vlut_tpu_torch.runtime.engine import Engine, Request

    cfg, model = _tiny_real(device)
    eng = Engine(cfg, model, n_slots=4, max_len=256, kv_quant=q8,
                 decode_attn=decode_attn, cuda_graph=cuda_graph)
    texts = (b"The little model", b"reads", b"its own repo.", b"The",
             b"little model reads the lines of its own repo.", b"re")
    # one request asks for log-probs (computed outside the step program)
    reqs = [Request(prompt=[2] + list(p), max_new_tokens=12, sampler=sp,
                    n_probs=3 if i == 4 else 0)
            for i, (p, sp) in enumerate(zip(texts, samplers))]
    before = {w: w.launches for w in ops.COUNTED}
    eng.run(reqs)
    counts = {w.__name__: w.launches - before.get(w, 0) for w in ops.COUNTED}
    eng.ids = [lp[0].tolist() for lp in reqs[4].logprobs]
    return [r.output for r in reqs], counts, eng


@pytest.mark.parametrize("decode_attn", ["fused", "composed"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_engine_graph_equals_eager_and_cpu(dev, q8, decode_attn):
    """tiny_real through the engine: the replayed step gives the eager
    step's greedy tokens and the CPU's, and a replay counts the launches
    the eager step makes."""
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    greedy = [SamplerParams(temperature=0.0)] * 6
    graph, n_graph, eng = _engine_tokens("cuda", q8, decode_attn, True,
                                         greedy)
    eager, n_eager, eng_e = _engine_tokens("cuda", q8, decode_attn, False,
                                           greedy)
    cpu, _, _ = _engine_tokens("cpu", q8, decode_attn, True, greedy)
    assert graph == eager == cpu
    assert eng.ids == eng_e.ids and len(eng.ids) == 12
    assert n_graph == n_eager and sum(n_graph.values()) > 0
    progs = eng.step_programs()
    assert len(progs) == 1 and progs[0]["replays"] > 0


def test_engine_seeded_sampling_graph_equals_eager(dev):
    """temperature 0.8, top-k 40, XTC and mirostat: the noise drawn before
    each replay gives the eager step's seeded tokens."""
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    samplers = [SamplerParams(temperature=0.8, top_k=40, seed=i,
                              xtc_p=0.5 if i % 2 else 0.0, xtc_t=0.05,
                              mirostat_tau=5.0 if i % 3 == 2 else 0.0)
                for i in range(6)]
    graph, _, eng = _engine_tokens("cuda", False, "fused", True, samplers)
    eager, _, _ = _engine_tokens("cuda", False, "fused", False, samplers)
    assert graph == eager
    assert any(p.get("replays") for p in eng.step_programs())


def test_engine_programs_in_one_pool_graph_equals_eager(dev):
    """Two step programs (greedy, seeded) captured into the engine's one
    memory pool and replayed in turn as the active feature set flips give
    the eager step's tokens."""
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    def run(graph):
        cfg, model = _tiny_real("cuda")
        eng = Engine(cfg, model, n_slots=2, max_len=256, cuda_graph=graph)
        greedy = SamplerParams(temperature=0.0)
        reqs = [Request(prompt=[2, 84, 104, 101], max_new_tokens=30,
                        sampler=greedy)]
        reqs += [Request(prompt=[2, 108 + i], max_new_tokens=5,
                         sampler=SamplerParams(temperature=0.8, top_k=40,
                                               seed=i) if i % 2 == 0
                         else greedy) for i in range(6)]
        eng.run(reqs)
        return [r.output for r in reqs], eng.step_programs()

    graph, progs = run(True)
    eager, _ = run(False)
    assert graph == eager
    assert len(progs) == 2 and all(p["replays"] > 1 for p in progs)


@pytest.mark.parametrize("decode_attn", ["fused", "composed"])
def test_batched_graph_equals_eager_and_cpu(dev, decode_attn):
    from vlut_tpu_torch.cli import run_batched

    ids = [2] + list(b"The little model reads the lines of its own repo.")
    out = {}
    for device, graph in (("cuda", True), ("cuda", False), ("cpu", True)):
        cfg, model = _tiny_real(device)
        out[device, graph] = run_batched(
            model, cfg, ids, 4, 12, temp=0.0, decode_attn=decode_attn,
            cuda_graph=graph).cpu()
    assert torch.equal(out["cuda", True], out["cuda", False])
    assert torch.equal(out["cuda", True], out["cpu", True])
    # seeded sampling through generate: graphed equals eager
    cfg, model = _tiny_real("cuda")
    sampled = [run_batched(model, cfg, ids, 4, 12, temp=0.8, seed=3,
                           decode_attn=decode_attn, cuda_graph=graph).cpu()
               for graph in (True, False)]
    assert torch.equal(sampled[0], sampled[1])


def test_capture_raises_where_a_workspace_is_missing(dev, monkeypatch):
    """A step captured before its decode attention ran once at its size
    (no workspace yet) raises: nothing falls back to an eager step, and
    the launch counters keep their counts."""
    from vlut_tpu_torch.runtime.step_graph import StepGraph

    monkeypatch.setattr(da, "_work", {})
    q, kn, vn, kf, vf, start = _attn_inputs(dev, 4, 64, 2, 2, 128, 1)
    kc, vc = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    before = da.decode_attention.launches
    g = StepGraph(lambda: da.decode_attention(q, kn, vn, kc, vc, start, 0,
                                              scale=0.1))
    with pytest.raises(RuntimeError, match="workspace"):
        g.capture()
    assert not g.captured and da.decode_attention.launches == before
    torch.cuda.synchronize()


def _tq_inputs(dev, fmt, m, k, n, seed):
    from vlut_tpu_torch.bench.kernels import rand_packed

    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = rand_packed(fmt, k, n, gen, dev)
    scales = (torch.rand((k // 256, n), generator=gen, device=dev) * 0.6
              + 0.3).to(torch.float16)
    # codes near 127 make block dots whose products with an fp16 scale
    # round in float32, so the order of the float sum shows
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    xq[: m // 2] = xq[: m // 2].abs()
    xs = torch.rand((m, 1), generator=gen, device=dev) * 0.01
    return xq, packed, scales, xs


# #9 sums exact int32 block dots in float32 in the JAX interpret run's
# order (tq_gemm_plain), so the kernel matches its plain version bit for bit.
_TQ_SHAPES = [(1, 512, 64, 256), (40, 1024, 200, 512), (32, 4096, 4096, 2048),
              (100, 1536, 128, 512), (256, 2048, 1024, 1024)]


@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
@pytest.mark.parametrize("m,k,n,bk", _TQ_SHAPES + [
    s for s in tq.PLAN_SHAPES if s not in _TQ_SHAPES])
def test_tq_gemm_matches_plain(dev, fmt, m, k, n, bk):
    xq, packed, scales, xs = _tq_inputs(dev, fmt, m, k, n, seed=m + k)
    want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt, bk=bk)
    before = tq.tq_gemm.launches
    got = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=bk)
    torch.cuda.synchronize()
    assert tq.tq_gemm.launches == before + 1
    assert got.shape == (m, n) and torch.equal(got, want)
    bf = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=bk,
                    out_dtype=torch.bfloat16)
    # a second call of the same plan, to bfloat16
    assert torch.equal(bf, want.to(torch.bfloat16))
    # an x whose rows are not 16-byte aligned goes through one copy
    wide = torch.zeros((m, k + 1), dtype=torch.int8, device=dev)
    wide[:, 1:] = xq
    got = tq.tq_gemm(wide[:, 1:], packed, scales, xs, fmt=fmt, bk=bk)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
@pytest.mark.parametrize("m,k,n,bk", [(40, 4096, 1000, 2048),
                                      (130, 3584, 264, 512)])
def test_tq_every_tile_and_split_matches_plain(dev, fmt, m, k, n, bk):
    xq, packed, scales, xs = _tq_inputs(dev, fmt, m, k, n, seed=m + n)
    want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt, bk=bk)
    for bm, bn in tq.TILES:
        for splits in range(1, k // bk + 1):
            got = tq._tq_cuda(xq, packed, scales, xs, fmt, bk, torch.float32,
                              plan=(bm, bn, splits))
            assert torch.equal(got, want), (bm, bn, splits)


@pytest.mark.parametrize("fmt", ["i2", "i1", "tq2", "tq1"])
def test_bench_lane_runs_on_card(dev, fmt):
    from vlut_tpu_torch.bench.kernels import bench_gemm

    out = bench_gemm(fmt, 32, 1024, 512, repeats=1, iters=8)
    assert out["us"] > 0 and out["fmt"] == fmt


def _slice_engine(mode, graph, device="cuda", q8=False):
    """tiny_real through the engine in one of this slice's modes: draft
    (itself as its draft), lookahead, or a grammar on one request."""
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams
    from vlut_tpu_torch.utils.tokenizer import Tokenizer
    import pathlib

    cfg, model = _tiny_real(device)
    kw = {"draft": dict(draft=(cfg, model), k_draft=3),
          "lookahead": dict(lookahead=(4, 3))}.get(mode, {})
    eng = Engine(cfg, model, n_slots=4, max_len=256, kv_quant=q8,
                 cuda_graph=graph, **kw)
    tok = Tokenizer(pathlib.Path(__file__).parent / "fixtures" / "tiny_real")
    texts = (b"The little model", b"reads", b"its own repo.", b"The")
    reqs = [Request(prompt=[2] + list(p), max_new_tokens=16,
                    sampler=SamplerParams(temperature=0.0),
                    stop_tokens=(tok.eos_id,),
                    grammar=(tok.make_grammar('root ::= [a-z ]+ "."')
                             if mode == "grammar" and i < 2 else None))
            for i, p in enumerate(texts)]
    eng.run(reqs)
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("mode", ["draft", "lookahead", "grammar"])
def test_slice_step_programs_graph_equals_eager_and_cpu(dev, mode):
    """The speculative round, the lookahead round and the grammar step:
    replayed, they give the eager program's tokens and the CPU's; the
    round or grammar program was captured and replayed."""
    graph, eng = _slice_engine(mode, True)
    eager, _ = _slice_engine(mode, False)
    cpu, _ = _slice_engine(mode, True, device="cpu")
    assert graph == eager == cpu
    key = {"draft": "speculative", "lookahead": "lookahead"}.get(mode)
    progs = [p for p in eng.step_programs()
             if (p["features"][0] == key if key else "grammar"
                 in p["features"])]
    assert progs and progs[0].get("replays", 0) > 0
    if mode != "grammar":
        plain, _ = _slice_engine("plain", True)
        assert graph == plain


@pytest.mark.parametrize("mode", ["draft", "lookahead", "grammar"])
def test_slice_round_replay_is_bit_identical(dev, mode):
    """One program replayed twice on the same inputs, cache and carried
    state gives the same outputs bit for bit."""
    _, eng = _slice_engine(mode, True)
    key = {"draft": ("speculative", "k=3"),
           "lookahead": ("lookahead", "W=4", "G=3")}.get(mode, ("grammar",))
    prog = eng._steps[key]
    assert prog.run.captured
    # the state a replay writes: the cache, and the lookahead's carry
    state = [a for arrs in eng.cache.values() for a in arrs]
    state += list(eng._la["state"].values()) if eng._la else []
    snap = [a.clone() for a in state]
    outs = []
    for _ in range(2):
        for a, s in zip(state, snap):
            a.copy_(s)
        out = prog.run()
        outs.append([o.clone() for o in out])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_restore_into_a_captured_engine(dev):
    """A slot saved after decoding restores into another slot of an engine
    whose decode graph is captured (written in place): the continuation
    equals the one from the slot it was saved from."""
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    cfg, model = _tiny_real("cuda")
    greedy = SamplerParams(temperature=0.0)
    prompt = [2] + list(b"The little model reads")

    def run(restore):
        eng = Engine(cfg, model, n_slots=2, max_len=256)
        first = Request(prompt=prompt, max_new_tokens=6, sampler=greedy)
        eng.run([first])
        assert any(p.get("replays") for p in eng.step_programs())
        hist = list(eng.slots[0].history)
        if restore:
            data = eng.save_slot(0)
            eng.slots[0].history = []
            eng.restore_slot(1, data)
        nxt = Request(prompt=hist + list(b" the"), max_new_tokens=10,
                      sampler=greedy)
        eng.run([nxt])
        assert eng.perf.n_reused_tokens == len(hist)
        return nxt.output

    assert run(True) == run(False)


# The server's cacheless forwards at the flagship's widths (llama3_8b_158):
# a rerank of 32 documents in a 256 bucket (M 8192) through #3 at the fused
# tree's four projections, and embeddings of one and three inputs (bucket
# 16: M 16 and 48) through #1 and #4 at the projections of either tree.
FLAGSHIP_FUSED = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]
FLAGSHIP_UNFUSED = [(4096, 1024), (4096, 14336)]


def _card_weights(dev, fmt, k, n, seed):
    """Random valid packed weights, made on the card (the plain versions
    below also run there: at these widths the CPU's integer products take
    minutes)."""
    from vlut_tpu_torch.ops.packing import (
        DEFAULT_BLOCK, TRITS_PER_BYTE, padded_k, random_packed_bytes)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = random_packed_bytes(
        (padded_k(k, fmt) // TRITS_PER_BYTE[fmt], n), fmt, gen, dev)
    ws = torch.rand(n, generator=gen, device=dev) * 0.09 + 0.01
    return gen, packed, ws, DEFAULT_BLOCK[fmt]


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("k,n", FLAGSHIP_FUSED)
def test_tiled_at_the_rerank_shape_matches_plain(dev, fmt, k, n):
    m = 8192
    gen, packed, ws, kb = _card_weights(dev, fmt, k, n, seed=k + n)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    xs = torch.rand((m, 1), generator=gen, device=dev) * 0.1 + 1e-3
    got = tg.ternary_gemm_tiled(xq, packed, xs, ws, fmt=fmt, kb=kb, k=k)
    want = tg._gemm_plain(xq, xs, packed, ws, fmt, kb, k, None,
                          torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [16, 48])
@pytest.mark.parametrize("k,n", FLAGSHIP_FUSED + FLAGSHIP_UNFUSED)
def test_decode_at_the_embedding_shapes_matches_plain(dev, m, k, n):
    """#1 in plain mode with a bf16 residual, and #4, bit for bit."""
    gen, packed, ws, kb = _card_weights(dev, "i2", k, n, seed=m + k + n)
    x = torch.randn((m, k), generator=gen, device=dev)
    res = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
    got = tg.ternary_gemm_decode(x, packed, ws, residual=res, fmt="i2",
                                 kb=kb, k=k, out_dtype=torch.bfloat16)
    codes, xs = tg.decode_prologue(x, None, None, "plain", False, k, 1e-5)
    assert torch.equal(got, tg._gemm_plain(codes, xs, packed, ws, "i2", kb,
                                           k, res, torch.bfloat16))
    got = tg.ternary_gemm_fused_quant(x, packed, ws, fmt="i2", kb=kb, k=k)
    assert torch.equal(got, tg._gemm_plain(*tg.kernel_quantize(x), packed,
                                           ws, "i2", kb, k, None,
                                           torch.float32))


def test_embed_rerank_tiny_real_card_equals_cpu(dev):
    """The server's embeddings (mean, last, cls; one input and four) and
    rerank scores on the card agree with the CPU's on tiny_real."""
    import pathlib

    from vlut_tpu_torch.runtime.engine import Engine
    from vlut_tpu_torch.serving.server import ServerState
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(pathlib.Path(__file__).parent / "fixtures" / "tiny_real")
    states = [ServerState(Engine(*_tiny_real(d), n_slots=1, max_len=256),
                          tok) for d in ("cuda", "cpu")]
    texts = ["The little model reads the lines of its own repo.", "reads",
             "of its own repo, and some more words past sixteen", "T"]
    ids = [tok.encode(t) for t in texts]
    for batch in (ids[:1], ids):
        for pooling in ("mean", "last", "cls"):
            a, b = (st.embed(batch, pooling) for st in states)
            assert float((a * b).sum(-1).min()) >= 0.9999
    q = tok.encode("The little model")
    docs = [tok.encode(d, add_bos=False) for d in
            (" reads the lines", " zq xv", " of its own repo.", "!!")]
    a, b = (st.rerank(q, docs) for st in states)
    np.testing.assert_allclose(a, b, rtol=1e-3)
    assert np.argsort(a).tolist() == np.argsort(b).tolist()


@pytest.mark.parametrize("name", ["qwen3", "gemma2", "gemma3", "gptneox",
                                  "bloom", "olmo2", "cohere2", "gpt_oss",
                                  "llama4"])
def test_zoo_family_card_equals_cpu(dev, name):
    """A knob family of the dense zoo (``bench/zoo.py``) on the card and on
    the CPU over a prefill and 8 decode steps: each layer from the CPU's
    input and the logits within 2e-2 of the largest, the CPU's greedy
    tokens, graphed tokens equal to eager ones."""
    from vlut_tpu_torch.bench import zoo

    r = zoo.card_vs_cpu(name, dev)
    assert r["within_tol"] and r["greedy_equal"], r
    assert r["graph_equals_eager"], r


# --- heterogeneous stacks and mixture of experts ---------------------------

@pytest.mark.parametrize("m", [1, 16, 33, 64])
def test_mixtral_expert_shapes_match_plain(dev, m):
    """#4 at Mixtral-8x7B's expert projections (gate and up 4096 -> 14336,
    down 14336 -> 4096) at a decode step's M, and #3 at a prefill chunk's
    M 512 past it: bit for bit against the plain versions."""
    for k, n in ((4096, 14336), (14336, 4096)):
        t = _weights(k, n, "i2", seed=m + k)
        packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
        rng = np.random.default_rng(m + n)
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        want = tg.ternary_gemm_fused_quant(x, t.packed, t.scale_vector(),
                                           fmt="i2", kb=t.kb, k=k)
        before = tg.ternary_gemm_fused_quant.launches
        got = tg.ternary_gemm_fused_quant(x.to(dev), packed, ws, fmt="i2",
                                          kb=t.kb, k=k)
        torch.cuda.synchronize()
        assert tg.ternary_gemm_fused_quant.launches == before + 1
        assert torch.equal(got.cpu(), want)
        if m == 16:
            _tiled_matches_plain(dev, "i2", 512, k, n, seed=k)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_hetero_layer_attention_matches_plain(dev, q8):
    """#7/#8 on the narrower layer of a heterogeneous stack (bench/zoo.py
    hetero_heads: 2 query heads over 1 KV head in a model of 4 over 2), on
    that layer's cache as ``init_kv_cache`` makes it (its own head), and
    the wider layer's: the kernels against their plain versions."""
    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.models import transformer as tt

    cfg = zoo.family_config("hetero_heads")
    cache = tt.init_kv_cache(cfg, 4, 200, device=dev, quantized=q8)
    assert [c.shape[2] for c in cache["k"]] == [1, 2]
    for i, (nh, nkv) in enumerate(cfg.heads_per_layer):
        _attn_check(dev, q8, 4, 200, nkv, nh // nkv, 128, 0, None, False,
                    seed=i)


def test_moe_and_hetero_families_card_equals_cpu(dev):
    """Two zoo families on the card against the CPU, each layer from the
    CPU's input (bench/zoo.py card_vs_cpu): a Mixtral-style MoE and the
    per-layer heads; graphed tokens equal eager ones."""
    from vlut_tpu_torch.bench import zoo

    for fam in ("moe_mixtral", "hetero_heads"):
        r = zoo.card_vs_cpu(fam, dev, n_decode=3)
        assert r["within_tol"] and r["greedy_equal"], r
        assert r["graph_equals_eager"], r


# --- MLA (DeepSeek-V2-Lite's widths), M-RoPE and the stacked cache ----------

# (K, N as the checkpoint stores them) of DeepSeek-V2-Lite's projections
# that #4 runs at decode: wq_full, wkv_a (576 packed 640 wide), an expert's
# gate / up and down (1408 chunk-padded to 2048 by the plan's tp_pack 8),
# the shared experts' (2 x 1408 -> 3072) and the dense lead layer's (10944
# -> 11264)
V2_LITE_FUSED_QUANT = [(2048, 3072), (2048, 640), (2048, 2048),
                       (2048, 3072), (3072, 2048), (2048, 11264),
                       (11264, 2048)]


@pytest.mark.parametrize("m", [1, 16, 64])
def test_v2_lite_projection_shapes_match_plain(dev, m):
    """#4 at DeepSeek-V2-Lite's projections at a decode step's M and #3 at
    the prefill bucket's M 512 (at M 16), bit for bit against the plain
    versions; wo (2048 -> 2048) runs #1, whose shapes the flagship's
    checks cover."""
    for k, n in V2_LITE_FUSED_QUANT:
        t = _weights(k, n, "i2", seed=m + k + n)
        packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
        rng = np.random.default_rng(m + n)
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        want = tg.ternary_gemm_fused_quant(x, t.packed, t.scale_vector(),
                                           fmt="i2", kb=t.kb, k=k)
        got = tg.ternary_gemm_fused_quant(x.to(dev), packed, ws, fmt="i2",
                                          kb=t.kb, k=k)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (k, n)
        if m == 16:
            _tiled_matches_plain(dev, "i2", 512, k, n, seed=k)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_kv_writer_takes_the_latent_rows(dev, q8):
    """#5 writes MLA's latent rows (one head of 640: [latent | k_pe | 0] and
    [latent | 0], as ``_mla_attention`` builds them contiguous; q8: the
    codes and one scale per row) in one launch, bit for bit as the plain
    assignment."""
    from vlut_tpu_torch.runtime.kv_cache import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(14)
    b, s, w = 16, 2048, 640
    cache = [torch.randn((b, s, 1, w), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    rows = [torch.randn((b, 1, 1, w), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    rows[0][..., 576:] = 0
    rows[1][..., 512:] = 0
    start = torch.linspace(0, s - 1, b, device=dev).long()
    if q8:
        (kc, ksc), (vc, vsc) = quantize_kv(cache[0]), quantize_kv(cache[1])
        (kq, ks), (vq, vs) = quantize_kv(rows[0]), quantize_kv(rows[1])
        cache, rows = [kc, vc, ksc, vsc], [kq, vq, ks, vs]
    want = [c.clone() for c in cache]
    for c, u in zip(want, rows):
        kv_update._write_plain(c, u, start)
    before = kv_update.write_rows_pair.launches
    kv_update.write_rows_pair(cache[0], cache[1], rows[0], rows[1], start,
                              scales=tuple(cache[2:] + rows[2:]) or None)
    torch.cuda.synchronize()
    assert kv_update.write_rows_pair.launches == before + 1
    for got, w_ in zip(cache, want):
        assert torch.equal(got, w_)


@pytest.mark.parametrize("name", ["mla_deepseek_v2", "mla_minicpm3",
                                  "mrope_qwen2vl"])
def test_mla_and_mrope_families_card_equals_cpu(dev, name):
    """An MLA or M-RoPE family of the zoo on the card against the CPU, each
    layer from the CPU's input; graphed tokens equal eager ones."""
    from vlut_tpu_torch.bench import zoo

    r = zoo.card_vs_cpu(name, dev, n_decode=3)
    assert r["within_tol"] and r["greedy_equal"], r
    assert r["graph_equals_eager"], r


@pytest.mark.parametrize("name", ["tiny_real", "mla_plm"])
def test_stacked_engine_equals_unrolled_on_the_card(dev, name):
    """``Engine(unroll=False)`` over a stacked cache, graphed, gives the
    unrolled engine's tokens."""
    from vlut_tpu_torch.bench import zoo
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    if name == "tiny_real":
        cfg, model = _tiny_real("cuda")
    else:
        cfg = zoo.family_config(name)
        model = tt.TransformerLM(cfg, tt._tree_to(zoo.family_tree(cfg),
                                                  "cuda"))
    outs = []
    for unroll in (True, False):
        eng = Engine(cfg, model, n_slots=2, max_len=128, unroll=unroll)
        reqs = [Request(prompt=[2, 5 + i, 9, 11, 3], max_new_tokens=8,
                        sampler=SamplerParams(temperature=0.0))
                for i in range(3)]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["mamba", "mamba2", "rwkv7", "arwkv7",
                                  "rwkv6", "jamba", "falcon_h1",
                                  "qwen3next_moe", "plamo2",
                                  "nemotron_h_moe"])
def test_recurrent_families_card_equals_cpu(dev, name):
    """A recurrent family of ``bench/recurrent_zoo.py`` on the card against
    the CPU, each layer from the CPU's input: layers within 2e-2 of the
    largest value, logits within 1e-5, the CPU's greedy tokens, with TF32
    allowed for matmuls and convolutions around the call: the forwards
    compute in full float32 whatever the caller allows."""
    from vlut_tpu_torch.bench import recurrent_zoo as rz
    from vlut_tpu_torch.device import tf32

    with tf32(matmul=True, conv=True):
        r = rz.card_vs_cpu(name, dev, n_decode=3, prompt=40)
    assert r["within_tol"] and r["greedy_equal"], r


def test_mamba_engine_graphed_equals_eager_and_cpu(dev):
    """The tiny Mamba of the recurrent zoo through the engine: the graphed
    step, the eager step and the CPU give the same greedy tokens."""
    from vlut_tpu_torch.bench import recurrent_zoo as rz
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    cfg, tree = rz.family("mamba")
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 40, 17, 90, 1)]
    outs = []
    for device, graph in (("cuda", True), ("cuda", False), ("cpu", True)):
        eng = Engine(cfg, rz.model_on(cfg, tree, device), n_slots=4,
                     max_len=256, cuda_graph=graph)
        reqs = [Request(prompt=p, max_new_tokens=10,
                        sampler=SamplerParams(temperature=0.0))
                for p in prompts]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("name", __import__(
    "vlut_tpu_torch.bench.encoder_zoo", fromlist=["FAMILIES"]).FAMILIES)
def test_encoder_family_card_equals_cpu(dev, name):
    """``chip_smoke.py`` phase 23's families: the encoders', T5's and
    gemma3n's outputs within their tolerances of the CPU's, pooled
    embeddings and greedy tokens the CPU's, the diffusion families' denoised
    tokens (packed and float twin) the CPU's."""
    from vlut_tpu_torch.bench import encoder_zoo as ez

    r = ez.card_vs_cpu(name, dev)
    assert r["within_tol"] and r["equal"], r


def _converter_source(name, d):
    """An HF directory of ``bench/hf_writer.py``: HF1BitLLM's layout of a
    small llama, the zoo's mixtral, or the recurrent zoo's mamba."""
    from vlut_tpu_torch.bench import hf_writer, recurrent_zoo, zoo
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.models import transformer as tt

    if name == "hf1bitllm":
        cfg = ModelConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                          n_kv_heads=1, d_ff=512, head_dim=128,
                          max_seq_len=256)
        return hf_writer.write_hf(d, cfg, tt.init_params_fast(
            cfg, seed=1, device="cpu").tree(), layout="hf1bitllm")
    if name == "mixtral":
        cfg = zoo.family_config("moe_mixtral")
        return hf_writer.write_hf(d, cfg, zoo.family_tree(cfg, 0))
    return hf_writer.write_hf(d, *recurrent_zoo.family("mamba"))


@pytest.mark.parametrize("name", ["hf1bitllm", "mixtral", "mamba"])
def test_conversion_on_the_card_equals_the_cpus(dev, name, tmp_path):
    """``convert/convert.py`` packs on the card (the uint8 2-bit unpack, the
    padding and the trits-to-bytes pack) and decides every trit and scale
    on the host: the checkpoint equals the CPU's, array for array."""
    import json

    from vlut_tpu_torch.convert.checkpoint import safetensors_arrays
    from vlut_tpu_torch.convert.convert import convert_hf

    src = _converter_source(name, tmp_path / "hf")
    convert_hf(src, tmp_path / "card", device=dev)
    convert_hf(src, tmp_path / "cpu", device="cpu")
    a = safetensors_arrays(tmp_path / "card" / "model.safetensors")
    b = safetensors_arrays(tmp_path / "cpu" / "model.safetensors")
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert (json.loads((tmp_path / "card" / "vlut_config.json").read_text())
            == json.loads((tmp_path / "cpu" / "vlut_config.json").read_text()))


@pytest.mark.parametrize("name", ["rwkv7", "jamba", "bert", "t5_gated",
                                  "gemma3n"])
def test_family_conversion_on_the_card_equals_the_cpus(dev, name, tmp_path):
    """A family converter called with the card as its device (``convert_hf``
    keeps the device rule; the family's floats stay on the host) writes
    the CPU's checkpoint."""
    from vlut_tpu_torch.bench import encoder_zoo, hf_writer, recurrent_zoo
    from vlut_tpu_torch.convert.checkpoint import safetensors_arrays
    from vlut_tpu_torch.convert.convert import convert_hf

    zoo_mod = recurrent_zoo if name in ("rwkv7", "jamba") else encoder_zoo
    src = hf_writer.write_hf(tmp_path / "hf", *zoo_mod.family(name, seed=1))
    convert_hf(src, tmp_path / "card", device=dev)
    convert_hf(src, tmp_path / "cpu", device="cpu")
    a = safetensors_arrays(tmp_path / "card" / "model.safetensors")
    b = safetensors_arrays(tmp_path / "cpu" / "model.safetensors")
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe", "tiny_bitnet"])
def test_pack_params_on_the_card_equals_the_cpus(dev, preset):
    """``train/finetune.py``: a QAT step on the card gives the CPU's loss
    (within 1e-5, with TF32 allowed around it: the step holds it off), and
    ``pack_params`` of the same masters packs the same bytes and scales on
    the card as on the CPU (each scale decided on the host in numpy, the
    trits rounded by a true division)."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.device import tf32
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.train import finetune as ft

    cfg = PRESETS[preset]
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    losses, trained = [], []
    for device in ("cpu", dev):
        params = ft.trainable(ft.float_twin_params(
            tt.init_params(cfg, seed=2, device=device), cfg))
        opt = torch.optim.SGD(ft.leaves(params), lr=0.1)
        with tf32(matmul=True, conv=True):
            losses.append(float(ft.make_train_step(cfg, opt, qat=True)(
                params, toks.to(device))))
        trained.append(params)
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), losses
    masters = {"layers": {name: {"dense": v["dense"].detach()}
                          for name, v in trained[0]["layers"].items()
                          if isinstance(v, dict)}}
    on_cpu = ft.pack_params(masters, cfg)
    on_card = ft.pack_params({"layers": {
        name: {"dense": v["dense"].to(dev)}
        for name, v in masters["layers"].items()}}, cfg)
    for name, leaves in on_cpu["layers"].items():
        for leaf in ("packed", "scale"):
            assert torch.equal(on_card["layers"][name][leaf].cpu(),
                               leaves[leaf]), (name, leaf)


@pytest.mark.parametrize("name", ["gemma3", "qwen3vl", "cogvlm", "kimivl"])
def test_vision_family_card_equals_cpu(dev, name):
    """``bench/vision_zoo.py``: a tower family converted on the card and on
    the CPU (equal files), each tower function on the card from the CPU's
    inputs (within 1e-4), and the CPU's image rows spliced into the
    language model on both (DeepStack's planes for qwen3vl, cogvlm's
    visual experts): each layer within ``bench/zoo.py:TOL``, the CPU's
    greedy tokens; a twin's tower alone; with TF32 allowed for matmuls
    and convolutions around the call: the towers compute in full float32
    whatever the caller allows."""
    from vlut_tpu_torch.bench import vision_zoo as vz
    from vlut_tpu_torch.device import tf32

    with tf32(matmul=True, conv=True):
        r = vz.card_vs_cpu(name, dev, seed=3)
    assert r["ok"], r


def test_describe_splice_on_the_card(dev):
    """``cli.describe`` at tiny widths on the card: a llava-shaped tower's
    rows spliced into tiny_real, the prefill over more than 64 rows (#3),
    the decode through #1 and #7 (each launched), its steps a CUDA graph;
    two graphed runs and an eager one give the same tokens."""
    import pathlib
    import types

    from vlut_tpu_torch.cli import describe
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.models import vision as pv
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    fixture = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
    cfg, model, _ = load_checkpoint(fixture, device=dev)
    model = tt.unstack_layers(tt.fuse_projections(model, cfg), cfg)
    vcfg = pv.VisionConfig(image_size=112, patch_size=14, d_model=64,
                           n_layers=2, n_heads=4, d_ff=128,
                           d_llm=cfg.d_model)
    vp = pv.init_params(vcfg, seed=2, device=dev)
    img = np.random.default_rng(4).random((112, 112, 3)).astype(np.float32)
    x = torch.from_numpy(pv.preprocess_image(img, 112)).to(dev)[None]
    embeds = pv.encode_image(vp, vcfg, x)[0]
    tok = types.SimpleNamespace(encode=Tokenizer(fixture).encode,
                                eos_id=None)
    before = {f: f.launches for f in (tg.ternary_gemm_tiled,
                                      tg.ternary_gemm_decode,
                                      da.decode_attention)}
    a = describe(model, cfg, tok, embeds, "The <image> little model", 8)
    assert all(f.launches > n for f, n in before.items())
    assert a == describe(model, cfg, tok, embeds, "The <image> little model",
                         8)
    assert a == describe(model, cfg, tok, embeds, "The <image> little model",
                         8, cuda_graph=False)
    assert len(a) == 8


AUDIO_FAMILIES = ["encode_ultravox", "encode_voxtral", "encode_music_flamingo",
                  "encode_glma", "encode_qwen2a", "conformer", "vocoder_tiny",
                  "vocoder_tiny_istft1280"]


@pytest.mark.parametrize("name", AUDIO_FAMILIES)
def test_audio_family_card_equals_cpu(dev, name):
    """``bench/audio_zoo.py``: each audio encoder's projector, lfm2-a's
    conformer and the vocoder + ISTFT (tiny and n_fft 1280 / hop 320) on
    the card against the CPU on the same seeded weights and inputs, within
    1e-4 of the largest output, with TF32 allowed for matmuls and
    convolutions around the call: the functions compute in full float32
    whatever the caller allows."""
    from vlut_tpu_torch.bench import audio_zoo
    from vlut_tpu_torch.device import tf32

    with tf32(matmul=True, conv=True):
        r = audio_zoo.card_vs_cpu(dev)[name]
    assert r["ok"], r


@pytest.mark.parametrize("m", [1, 64])
def test_outetts_projection_shapes_match_plain(dev, m):
    """OuteTTS-0.2-500M's projections at a decode step's M (and M 64): wo
    through #1 (plain, with its residual), the rest through #4, bit for bit
    against the plain versions."""
    from vlut_tpu_torch.bench import audio_zoo

    for label, k, n, mode, _, has_res, fused in (
            audio_zoo.outetts_projections()):
        t = _weights(k, n, "i2", seed=m + k + n)
        packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
        rng = np.random.default_rng(m + n)
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        if fused:
            res = torch.from_numpy(rng.standard_normal((m, n)).astype(
                np.float32)).to(torch.bfloat16)
            kw = dict(fmt="i2", kb=t.kb, k=k, mode=mode,
                      out_dtype=torch.bfloat16)
            want = tg.ternary_gemm_decode(x, t.packed, t.scale_vector(),
                                          residual=res, **kw)
            got = tg.ternary_gemm_decode(x.to(dev), packed, ws,
                                         residual=res.to(dev), **kw)
        else:
            want = tg.ternary_gemm_fused_quant(x, t.packed, t.scale_vector(),
                                               fmt="i2", kb=t.kb, k=k)
            got = tg.ternary_gemm_fused_quant(x.to(dev), packed, ws,
                                              fmt="i2", kb=t.kb, k=k)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), label


def test_audio_prefill_shapes_match_plain(dev):
    """#3 at the full-width audio prefills' M: the flagship's four fused
    projections at ``describe --audio``'s rows, OuteTTS's seven at the
    tts prompt's (a seeded speaker profile, each code one token), bit for
    bit."""
    import pathlib

    from vlut_tpu_torch.bench import audio_zoo

    rows = audio_zoo.prefill_rows(pathlib.Path(__file__).parent / "fixtures"
                                  / "tiny_real")
    for k, n in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        _tiled_matches_plain(dev, "i2", rows["describe"], k, n, seed=k + n)
    for _, k, n, *_ in audio_zoo.outetts_projections():
        _tiled_matches_plain(dev, "i2", rows["tts"], k, n, seed=k + n)


def test_kv_writer_takes_outetts_rows(dev):
    """#5 at OuteTTS's cache (one slot of 8,192 rows, 2 KV heads of 64
    padded to 128) as the composed step gives it, bit for bit."""
    from vlut_tpu_torch.bench import kv_study

    gen = torch.Generator(device=dev).manual_seed(20)
    caches, rows, start = kv_study.layer_update(gen, 1, 8192, 2, False,
                                                hd=128)
    want = [c.clone() for c in caches]
    for c, u in zip(want, rows):
        kv_update._write_plain(c, u, start)
    before = kv_update.write_rows_pair.launches
    kv_update.write_rows_pair(caches[0], caches[1], rows[0], rows[1], start)
    torch.cuda.synchronize()
    assert kv_update.write_rows_pair.launches == before + 1
    for got, w_ in zip(caches, want):
        assert torch.equal(got, w_)


def test_tts_and_describe_audio_on_the_card(dev, tmp_path):
    """tiny_real on the card: ``generate_codes`` graphed, eager and on the
    CPU give one token stream (#1 and #7 launched); ``cli describe
    --audio`` and ``cli tts`` print the CPU's text and write the CPU's WAV
    from one converted ultravox encoder and one converted vocoder, run
    under PyTorch's default TF32 settings (cuDNN's on), as a user runs
    them."""
    import contextlib
    import dataclasses
    import io
    import pathlib

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.bench import audio_zoo
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.device import tf32
    from vlut_tpu_torch.runtime import tts
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    fixture = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
    tok = Tokenizer(fixture)
    ids, proc = tts.prompt_ids(tok, "The little model",
                               audio_zoo.speaker_profile(3, n_words=1))
    assert len(ids) + 24 < 256  # tiny_real's context
    guide = tts.prepare_guide_tokens(tok, proc)
    streams = []
    for device, graph in ((dev, True), (dev, False), ("cpu", True)):
        cfg, model, _ = load_checkpoint(fixture, device=device)
        before = {f: f.launches for f in (tg.ternary_gemm_decode,
                                          da.decode_attention)}
        streams.append(tts.generate_codes(
            cfg, model, tok, ids, guide_tokens=guide, n_predict=24, seed=2,
            cuda_graph=graph))
        if device == dev and graph:
            assert all(f.launches > n for f, n in before.items())
    assert streams[0] == streams[1] == streams[2]

    acfg = dataclasses.replace(audio_zoo.TINY, d_llm=128)
    audio_zoo.write_ultravox_source(tmp_path / "hf_a", acfg, seed=5,
                                    proj_hidden=24)
    audio_zoo.write_wavtokenizer_source(tmp_path / "hf_v", dataclasses.replace(
        audio_zoo.TINY_VOCODER, vocab_size=256), seed=5)
    tts.save_wav(str(tmp_path / "a.wav"), np.sin(np.arange(16000) * 0.05
                                                 ).astype(np.float32), 16000)
    texts = {}
    # PyTorch's default TF32 settings (cuDNN's on), whatever an earlier
    # test left
    with tf32(conv=True):
        for device in ("cuda", "cpu"):
            flag = ["--device", device]
            cli.main(["convert-audio", str(tmp_path / "hf_a"),
                      str(tmp_path / f"enc_{device}"), "--d-llm", "128"]
                     + flag)
            cli.main(["convert-vocoder", str(tmp_path / "hf_v"),
                      str(tmp_path / f"voc_{device}")] + flag)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["describe", "--model", str(fixture), "--audio",
                          str(tmp_path / "a.wav"), "--audio-encoder",
                          str(tmp_path / f"enc_{device}"), "-p",
                          "The <audio> little", "-n", "8"] + flag)
            texts[device] = out.getvalue()
            cli.main(["tts", "--model", str(fixture), "--vocoder",
                      str(tmp_path / f"voc_{device}"), "-p", "The model",
                      "--guide-tokens", "-n", "24", "--code-offset", "0", "-o",
                      str(tmp_path / f"{device}.wav")] + flag)
    assert texts["cuda"] == texts["cpu"]
    card = np.frombuffer((tmp_path / "cuda.wav").read_bytes()[44:], "<i2")
    host = np.frombuffer((tmp_path / "cpu.wav").read_bytes()[44:], "<i2")
    assert card.shape == host.shape and card.size > 0
    assert np.abs(card.astype(np.int32) - host).max() <= 1
