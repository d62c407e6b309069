"""Port parity: packing, activation quantization, RoPE and RMSNorm of
vlut_tpu_torch against the JAX package, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlut_tpu.ops import norm as jnorm
from vlut_tpu.ops import packing as jpack
from vlut_tpu.ops import quant as jquant
from vlut_tpu.ops import rope as jrope
from vlut_tpu_torch.ops import norm as tnorm
from vlut_tpu_torch.ops import packing as tpack
from vlut_tpu_torch.ops import quant as tquant
from vlut_tpu_torch.ops import rope as trope

torch.set_num_threads(1)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("k,n", [(128, 128), (300, 130), (640, 256),
                                 (2600, 64)])
def test_pack_byte_identical(fmt, k, n):
    rng = np.random.default_rng(k * 7 + n)
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    want = jpack.pack_ternary(trits, np.float32(0.5), fmt)
    got = tpack.pack_ternary(trits, np.float32(0.5), fmt)
    assert got.packed.dtype == torch.uint8
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    assert (got.k, got.n, got.kb, got.k_padded, got.n_padded) == (
        want.k, want.n, want.kb, want.k_padded, want.n_padded)
    assert got.k_padded == tpack.padded_k(k, fmt)
    np.testing.assert_array_equal(tpack.unpack_ternary(got).numpy(), trits)
    padded = tpack.unpack_ternary(got, keep_padding=True).numpy()
    assert not padded[k:].any() and not padded[:, n:].any()


def test_word_layout_refused():
    with pytest.raises(TypeError, match="uint32"):
        tpack.TernaryTensor(torch.zeros((4, 128), dtype=torch.int32),
                            torch.tensor(1.0), 16, 128, "i2", 128)


def test_pack_rejects_non_trits():
    with pytest.raises(ValueError):
        tpack.pack_ternary(np.full((4, 4), 2, np.int8))


def test_ternarize_matches():
    w = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    for method in ("bitnet", "sign"):
        t_j, s_j = jpack.ternarize(w, method)
        t_t, s_t = tpack.ternarize(w, method)
        np.testing.assert_array_equal(t_t, t_j)
        assert s_t == s_j


def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 96)).astype(np.float32) * 3
    x[1] = 0.0  # zero row: scale 0, codes 0
    # exact .5 ties: with max|x| = 127 the multiplier is 1.0
    x[2] = 0.0
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[3] = np.float32(1e-30)  # tiny amax
    return x


def test_quantize_bit_equal():
    x = _quant_inputs()
    qj, sj = jquant.quantize_activations(jnp.asarray(x))
    qt, st = tquant.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and st.shape == (6, 1)
    assert not qt[1].any() and st[1, 0] == 0
    # half-to-even on the tie row
    assert qt[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_quantize_bf16_input():
    x = _quant_inputs()
    qj, sj = jquant.quantize_activations(jnp.asarray(x, jnp.bfloat16))
    qt, st = tquant.quantize_activations(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("scaling,pad_to", [
    (None, None),
    (None, 128),
    ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
      "high_freq_factor": 4.0, "original_max_position_embeddings": 64}, None),
    ({"rope_type": "linear", "factor": 2.0}, None),
    ({"rope_type": "yarn", "factor": 4.0,
      "original_max_position_embeddings": 32}, None),
])
def test_rope_matches(scaling, pad_to):
    cj, sj = jrope.rope_table(96, 64, 500000.0, scaling, pad_to=pad_to)
    ct, st = trope.rope_table(96, 64, 500000.0, scaling, pad_to=pad_to)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6, rtol=0)
    rng = np.random.default_rng(1)
    hd = ct.shape[1] * 2
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 96, size=(2, 5)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), cj, sj)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                           ct, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    c_rows = ct[torch.from_numpy(pos).long()][..., None, :]
    s_rows = st[torch.from_numpy(pos).long()][..., None, :]
    np.testing.assert_allclose(
        trope.apply_rope_rows(torch.from_numpy(x), c_rows, s_rows).numpy(),
        got.numpy(), atol=0, rtol=0)


def test_rms_norm_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 7, 96)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    want = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    gb = tnorm.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(w))
    assert gb.dtype == torch.bfloat16
