"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Integer paths must match bit for bit.  In the float-prologue modes of the
decode kernel the sum of squares is reduced in another order than in the
plain version, so an int8 code may differ by 1 in at most 0.1% of entries;
the outputs then agree to within (differing codes in the row + 1) code
steps times the scales, plus one bf16 step before and after the residual
add.
"""

import numpy as np
import pytest
import torch

from vlut_tpu_torch.ops import kv_update, ternary_gemm as tg
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


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("m", [1, 32, 40, 64, 200])
def test_tiled_and_fused_quant_match_plain(dev, fmt, m):
    k, n = 1280, 384
    t = _weights(k, n, fmt, seed=m)
    packed, ws = t.packed.to(dev), t.scale_vector().to(dev)
    rng = np.random.default_rng(m)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32))
    want = tg.ternary_gemm_tiled(xq, t.packed, xs, t.scale_vector(), fmt=fmt,
                                 kb=t.kb, k=k)
    got = tg.ternary_gemm_tiled(xq.to(dev), packed, xs.to(dev), ws, fmt=fmt,
                                kb=t.kb, k=k)
    assert torch.equal(got.cpu(), want)
    if m <= tg.MAX_DECODE_M:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        want = tg.ternary_gemm_fused_quant(x, t.packed, t.scale_vector(),
                                           fmt=fmt, kb=t.kb, k=k)
        got = tg.ternary_gemm_fused_quant(x.to(dev), packed, ws, fmt=fmt,
                                          kb=t.kb, k=k)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("mode,sub_norm", [("plain", False), ("norm", False),
                                           ("silu_mul", False),
                                           ("silu_mul", True)])
@pytest.mark.parametrize("with_res", [False, True])
def test_decode_matches_plain(dev, fmt, mode, sub_norm, with_res):
    m, k, n = 32, 1280, 384
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
    codes, xs = tg.decode_prologue(x1, x2, g, mode, sub_norm, k, 1e-5)
    want = tg._gemm_plain(codes, xs, packed, ws, fmt, t.kb, k, res, od).float()
    if mode == "plain":
        assert torch.equal(got, want)
        return
    codes_k = tg.prologue_codes(x1, x2, g, mode, sub_norm, k, 1e-5, fmt,
                                t.kb, t.k_padded)[0][:, :k]
    d = (codes_k.int() - codes.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    mag = want.abs() + (torch.nn.functional.pad(res.float().abs(),
                                                (0, want.shape[1] - n))
                        if with_res else 0.0)
    tol = (((d > 0).sum(1, keepdim=True) + 1) * xs * ws[None]
           + 2.0 ** -6 * mag)
    assert bool(((got - want).abs() <= tol).all())


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


def _attn_inputs(dev, b, s, hkv, g, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
    start = torch.randint(0, s, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    start[0], start[-1] = 0, s - 1
    return (rn(b, 1, hkv * g, hd), rn(b, 1, hkv, hd), rn(b, 1, hkv, hd),
            rn(b, s, hkv, hd), rn(b, s, hkv, hd), start)


# Attention outputs are float32 sums taken in another order than the plain
# version's dense softmax (per-warp online softmax, then a merge), so they
# are held to rtol 1e-5 and atol 1e-5; cache rows, codes and scales must be
# bit-exact.
ATT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("hkv,g,hd", [(8, 4, 128), (2, 1, 128), (4, 8, 256),
                                      (2, 2, 256)])
def test_decode_attention_matches_plain(dev, hkv, g, hd, window):
    from vlut_tpu_torch.ops import decode_attention as da

    q, kn, vn, kf, vf, start = _attn_inputs(dev, 5, 300, hkv, g, hd, seed=g)
    kc, vc = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    kw, vw = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, kn, vn, kw, vw, start, window,
                                     scale=hd ** -0.5)
    before = da.decode_attention.launches
    got = da.decode_attention(q, kn, vn, kc, vc, start, window,
                              scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    torch.testing.assert_close(got, want, **ATT_TOL)
    assert torch.equal(kc, kw) and torch.equal(vc, vw)


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("hkv,g,hd", [(8, 4, 128), (2, 1, 128), (4, 8, 256)])
def test_decode_attention_int8_matches_plain(dev, hkv, g, hd, window):
    from vlut_tpu_torch.ops import decode_attention as da
    from vlut_tpu_torch.runtime.kv_cache import quantize_kv

    q, kn, vn, kf, vf, start = _attn_inputs(dev, 5, 300, hkv, g, hd, seed=9)
    (kc, ksc), (vc, vsc) = quantize_kv(kf), quantize_kv(vf)
    ref = [t.clone() for t in (kc, vc, ksc, vsc)]
    want = da.decode_attention_int8_plain(q, kn, vn, *ref, start, window,
                                          scale=hd ** -0.5)
    before = da.decode_attention_int8.launches
    got = da.decode_attention_int8(q, kn, vn, kc, vc, ksc, vsc, start,
                                   window, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert da.decode_attention_int8.launches == before + 1
    torch.testing.assert_close(got, want, **ATT_TOL)
    for mine, theirs in zip((kc, vc, ksc, vsc), ref):
        assert torch.equal(mine, theirs)


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
@pytest.mark.parametrize("fmt", ["tq2", "tq1"])
@pytest.mark.parametrize("m,k,n,bk", [(1, 512, 64, 256), (40, 1024, 200, 512),
                                      (32, 4096, 4096, 2048),
                                      (100, 1536, 128, 512),
                                      (256, 2048, 1024, 1024)])
def test_tq_gemm_matches_plain(dev, fmt, m, k, n, bk):
    from vlut_tpu_torch.ops import tq

    xq, packed, scales, xs = _tq_inputs(dev, fmt, m, k, n, seed=m + k)
    want = tq.tq_gemm_plain(xq, packed, scales, xs, fmt=fmt, bk=bk)
    before = tq.tq_gemm.launches
    got = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=bk)
    torch.cuda.synchronize()
    assert tq.tq_gemm.launches == before + 1
    assert got.shape == (m, n) and torch.equal(got, want)
    bf = tq.tq_gemm(xq, packed, scales, xs, fmt=fmt, bk=bk,
                    out_dtype=torch.bfloat16)
    assert torch.equal(bf, want.to(torch.bfloat16))
    # an x whose rows are not 16-byte aligned takes the scalar loads
    wide = torch.zeros((m, k + 1), dtype=torch.int8, device=dev)
    wide[:, 1:] = xq
    got = tq.tq_gemm(wide[:, 1:], packed, scales, xs, fmt=fmt, bk=bk)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", ["i2", "i1", "tq2", "tq1"])
def test_bench_lane_runs_on_card(dev, fmt):
    from vlut_tpu_torch.bench.kernels import bench_gemm

    out = bench_gemm(fmt, 32, 1024, 512, repeats=1, iters=8)
    assert out["us"] > 0 and out["fmt"] == fmt
