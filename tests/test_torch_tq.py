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
