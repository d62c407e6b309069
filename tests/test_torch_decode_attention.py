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
from vlut_tpu_torch.ops import decode_attention as da
from vlut_tpu_torch.runtime import kv_cache

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(jnp.bfloat16)


def _inputs(b, s, hkv, g, hd, seed):
    rng = np.random.default_rng(seed)
    h = hkv * g
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    q, kn, vn = f32(b, 1, h, hd), f32(b, 1, hkv, hd), f32(b, 1, hkv, hd)
    kf, vf = f32(b, s, hkv, hd), f32(b, s, hkv, hd)
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
]
IDS = ["gqa", "single_chunk", "window", "mha"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_plain_matches_pallas(case):
    b, s, hkv, g, hd = (case[k] for k in ("b", "s", "hkv", "g", "hd"))
    q, kn, vn, kf, vf, start = _inputs(b, s, hkv, g, hd, seed=len(IDS))
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
    q, kn, vn, kf, vf, start = _inputs(b, s, hkv, g, hd, seed=7)
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
