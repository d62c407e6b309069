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
