"""#1/#4's float prologue: the kernel-order emulation and how far it may part
from the emulation held to the JAX package.

``decode_input_kernel_order`` follows ``decode_prologue_kernel``
(csrc/decode_gemm.cu) op for op and is the card reference of #1 and #4;
``decode_input`` is the emulation held to the JAX package.  The two take the
sum of squares in another order and the logistic and the reciprocal root by
other operations, so after the bf16 round their h may differ by one bf16
step, and the int8 codes by one.  These tests state that bound at the
flagship's, the zoo presets' and LLaDA-8B's widths, and check the
emulation's pieces against exact scalar arithmetic.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from vlut_tpu_torch.ops import ternary_gemm as tg

torch.set_num_threads(1)

# (K, mode, sub_norm): the float-prologue projections of the flagship
# (llama3_8b_158: qkv / gate-up norm at d 4096, down silu_mul at 14336), the
# zoo presets (qwen3_4b d 2560, ff 9728; gemma2_2b qkv at d 2304) and
# LLaDA-8B (d 4096, ff 12288), and a bitnet down with its sub-norm
WIDTHS = [
    (4096, "norm", False), (14336, "silu_mul", False),
    (2560, "norm", False), (9728, "silu_mul", False),
    (2304, "norm", False),
    (12288, "silu_mul", False), (6912, "silu_mul", True),
]
# one bf16 step relative to the value: h may round to the neighbouring bf16
BF16_STEP = 2.0 ** -7


def _inputs(k, mode, sub, m, seed):
    rng = np.random.default_rng(seed)
    x1 = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16)
    x2 = (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        torch.bfloat16) if mode == "silu_mul" else None)
    g = (torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32))
         if mode == "norm" or sub else None)
    return x1, x2, g


@pytest.mark.parametrize("k,mode,sub", WIDTHS)
def test_emulations_part_by_at_most_one_code(k, mode, sub):
    m = 8
    kp = -(-k // 128) * 128
    x1, x2, g = _inputs(k, mode, sub, m, seed=k)
    h_jax = tg.decode_input(x1, x2, g, mode, sub, k, 1e-5)
    h_ker = tg.decode_input_kernel_order(x1, x2, g, mode, sub, k, 1e-5, kp)
    # h: at most one bf16 step apart, relative to the value
    err = (h_ker - h_jax).abs()
    assert bool((err <= BF16_STEP * h_jax.abs()).all()), float(err.max())
    q_jax, s_jax = tg.kernel_quantize(h_jax)
    q_ker, s_ker = tg.kernel_quantize(h_ker)
    d = (q_ker.int() - q_jax.int()).abs()
    assert int(d.max()) <= 1
    assert bool(((s_ker - s_jax).abs() <= BF16_STEP * s_jax).all())


def test_plain_mode_is_the_input():
    x = torch.randn(3, 1000)
    assert torch.equal(tg.decode_input_kernel_order(x, kp=1024),
                       tg.decode_input(x))


def _f32(x) -> np.float32:
    return np.float32(x)


def _round_f32(fr: Fraction) -> np.float32:
    """The float32 nearest an exact rational (ties to even)."""
    lo = np.float32(float(fr))  # float(fr) rounds to double first
    if Fraction(float(lo)) == fr:
        return lo
    cands = [lo, np.nextafter(lo, np.float32(np.inf)),
             np.nextafter(lo, np.float32(-np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(np.float32(c).view(np.int32)) & 1))
    return best


def test_fma_is_rounded_once():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32) * np.float32(3.0)
    c = np.abs(rng.standard_normal(4000)).astype(np.float32) * np.float32(
        100.0)
    # values near a float32 tie after the square: a * a lands on a
    # midpoint of c's grid
    a[:8] = np.float32(1.0) + np.float32(2.0 ** -12)
    c[:8] = np.float32(2.0 ** 24)
    got = tg._fma_nonneg(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) ** 2 + Fraction(float(y)))
                     for x, y in zip(a, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _scalar_sum_squares(row: np.ndarray, kp: int) -> np.float32:
    """The kernel's sum of squares of one row in scalar float32: per thread
    fmaf in order, the shuffle tree of each warp, the warps' tree, the
    blocks in rank order."""
    k = row.shape[0]
    cs = min(8, -(-k // 4096))
    chunk = -(-(-(-kp // cs)) // 16) * 16
    blocks = []
    for b in range(cs):
        k0, k1 = b * chunk, min(kp, (b + 1) * chunk)
        ss = []
        for t in range(512):
            acc = np.float32(0.0)
            for i in range(k0 + t, min(k, k1), 512):
                v = row[i]
                acc = _round_f32(Fraction(float(v)) ** 2 + Fraction(float(acc)))
            ss.append(acc)

        def tree(vals):
            vals = list(vals)
            while len(vals) > 1:
                h = len(vals) // 2
                vals = [_f32(vals[i] + vals[i + h]) for i in range(h)]
            return vals[0]

        warps = [tree(ss[w * 32:(w + 1) * 32]) for w in range(16)]
        blocks.append(tree(warps))
    total = blocks[0]
    for b in blocks[1:]:
        total = _f32(total + b)
    return total


@pytest.mark.parametrize("k", [300, 5000])
def test_sum_squares_in_the_kernel_order(k):
    """One block (K <= 4096) and a cluster of two: the tensor emulation
    equals the scalar walk through the kernel's loops."""
    kp = -(-k // 128) * 128
    rng = np.random.default_rng(k)
    row = (rng.standard_normal(k) * 2.0).astype(np.float32)
    got = tg.prologue_sum_squares(torch.from_numpy(row[None]), kp)[0, 0]
    want = _scalar_sum_squares(row, kp)
    assert np.float32(got.item()).view(np.int32) == want.view(np.int32)
