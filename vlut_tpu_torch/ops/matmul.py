"""Ternary matmul front end (port of vlut_tpu/ops/matmul.py).

Routing depends on the rows M = prod(x.shape[:-1]) and the weight's
shape:

* M <= 64: the small-M kernels (fused-quant GEMM, or the fused decode
  projection for :func:`ternary_matmul_fused`), as on the TPU, except
  where the card's autotune table (``bench/autotune.py:lookup_route``)
  measured ``"tiled"`` for :func:`ternary_matmul`'s shape: then the same
  int8 codes and scales (:func:`ternary_gemm.kernel_quantize`) go through
  the tiled GEMM, which gives the same int32 accumulator and epilogue, so
  the same result.
* M > 64: :func:`quantize_activations` then the tiled GEMM.
* K sharded over a tensor-parallel axis (``tp_group``, wo and w_down
  under tp), at every M: :func:`quantize_activations` with the row's max
  over the whole axis, the tiled GEMM with unit scales (its float32
  output is then the int32 accumulator, exact below 2^24: at most
  14,336 x 127 = 1,820,672 at the flagship's w_down), the accumulators
  summed over the axis, and ``(acc * x_scale) * w_scale`` on every rank:
  bit-equal to the unsharded product through the same route
  (``vlut_tpu/ops/matmul.py:89-97,327-340``).  The small-M kernels would
  quantize with the shard's own max, so they are not taken.

The TPU's XLA-vs-Pallas crossover (``VLUT_TPU_XLA_MIN_M``) and its table
were measured on a TPU and are not carried over: the H100's table is the
port's own (``bench/autotune_h100.json``).  :func:`ternary_matmul_fused`
keeps M <= 64 on the fused decode kernel whatever the table says: its
composed path adds the residual after a cast, so it rounds apart.  On the
CPU every wrapper runs its plain PyTorch version, so the same routing
runs the same integer math on both devices.

``impl`` (also an argument of the model's ``forward``) is ``"auto"``, the
routing above, or ``"dequant"``, the float-dequant accuracy reference:
float32 products with the dequantized weights and no activation
quantization, composed around :func:`ternary_matmul_fused`'s prologue as
the JAX package composes it.  The quantized-vs-dequant KL of
``eval/perplexity.py`` compares the two.  ``"tiled"`` takes the tiled
route at every M and the composed projections (``forward``'s ``unfused``
ablation, ``bench/ablate.py``).
"""

from __future__ import annotations

import math

import torch

from vlut_tpu_torch.bench import autotune
from vlut_tpu_torch.ops import ternary_gemm
from vlut_tpu_torch.ops.packing import (
    TRITS_PER_BYTE,
    TernaryTensor,
    unpack_ternary,
)
from vlut_tpu_torch.ops.quant import quantize_activations
from vlut_tpu_torch.parallel._comm import psum

SMALL_M = ternary_gemm.MAX_DECODE_M


def _rows(x: torch.Tensor, t: TernaryTensor) -> tuple[list[int], int]:
    *batch, k = x.shape
    if k != t.k:
        raise ValueError(f"x K={k} vs weight K={t.k}")
    return batch, math.prod(batch)


def ternary_matmul(
    x: torch.Tensor,
    t: TernaryTensor,
    *,
    impl: str = "auto",
    out_dtype=None,
    tp_group=None,
) -> torch.Tensor:
    """x (..., K) float @ ternary W (K, N) -> (..., N).

    ``round(x*127/max|x|) @ trits * (max|x|/127) * w_scale`` with an int32
    accumulator.  ``tp_group``: this K shard's mesh axis (the exact
    K-sharded form above).
    """
    out_dtype = out_dtype or (x.dtype if x.dtype != torch.float64
                              else torch.float32)
    batch, m = _rows(x, t)
    x2d = x.reshape(m, t.k)
    reduce = tp_group is not None and tp_group.size > 1
    if impl == "dequant":
        w = unpack_ternary(t, dtype=torch.float32) * t.scale_vector()[: t.n]
        out = psum(x2d.to(torch.float32) @ w, tp_group if reduce else None)
        return out.to(out_dtype).reshape(*batch, t.n)
    if impl not in ("auto", "tiled"):
        raise ValueError(f"unknown impl {impl!r}")
    if reduce:
        x_q, x_scale = quantize_activations(x2d, tp_group)
        ws = t.scale_vector()
        acc = ternary_gemm.ternary_gemm_tiled(
            x_q, t.packed, torch.ones_like(x_scale), torch.ones_like(ws),
            fmt=t.fmt, kb=t.kb, k=t.k, out_dtype=torch.float32)
        out = psum(acc, tp_group) * x_scale * ws[None, :]
        return out[:, : t.n].to(out_dtype).reshape(*batch, t.n)
    if m <= SMALL_M and (impl == "tiled" or autotune.lookup_route(
            t.fmt, m, t.packed.shape[0] * TRITS_PER_BYTE[t.fmt],
            t.packed.shape[1], x.device.index or 0) == "tiled"):
        # the small-M kernels' quantization, so the result is theirs
        x_q, x_scale = ternary_gemm.kernel_quantize(x2d)
        out = ternary_matmul_quantized(x_q, x_scale, t, out_dtype=out_dtype)
        return out.reshape(*batch, t.n)
    if m <= SMALL_M:
        out = ternary_gemm.ternary_gemm_fused_quant(
            x2d, t.packed, t.scale_vector(), fmt=t.fmt, kb=t.kb, k=t.k,
            out_dtype=torch.float32,
        )
        return out[:, : t.n].to(out_dtype).reshape(*batch, t.n)
    x_q, x_scale = quantize_activations(x2d)
    out = ternary_matmul_quantized(x_q, x_scale, t, out_dtype=out_dtype)
    return out.reshape(*batch, t.n)


def ternary_matmul_quantized(
    x_q: torch.Tensor,  # (M, K) int8
    x_scale: torch.Tensor,  # (M, 1) f32
    t: TernaryTensor,
    *,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """GEMM on pre-quantized activations (tiled kernel, any M)."""
    out = ternary_gemm.ternary_gemm_tiled(
        x_q, t.packed, x_scale, t.scale_vector(), fmt=t.fmt, kb=t.kb, k=t.k,
        out_dtype=torch.float32,
    )
    return out[:, : t.n].to(out_dtype)


def ternary_matmul_fused(
    x: torch.Tensor,  # (..., K) bf16/f32, the raw layer input
    t: TernaryTensor,
    *,
    mode: str = "plain",  # "plain" | "norm" | "silu_mul"
    x2: torch.Tensor | None = None,  # up-projection half for silu_mul
    norm_g: torch.Tensor | None = None,  # (K,) RMSNorm gain
    norm_n: int = 0,  # logical norm width (padded tail is zero)
    eps: float = 1e-5,
    sub_norm: bool = False,  # RMSNorm after silu_mul (bitnet ffn_sub_norm)
    residual: torch.Tensor | None = None,  # (..., N) added to the output
    impl: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """Projection with the surrounding elementwise chain fused:

      h   = rms(x)*g | silu(x)*x2 [rms*g] | x      (mode)
      out = ternary_matmul(h, t) [+ residual]

    with h rounded through bf16 except in plain mode.  M <= 64 is one fused
    decode launch; larger M composes the same steps around the tiled GEMM.
    ``impl="dequant"`` composes them around the dequant product, with the
    residual added in ``out_dtype`` (``vlut_tpu/ops/matmul.py:221-235``).
    """
    out_dtype = out_dtype or (x.dtype if x.dtype != torch.float64
                              else torch.float32)
    if impl not in ("auto", "dequant", "tiled"):
        raise ValueError(f"unknown impl {impl!r}")
    batch, m = _rows(x, t)
    x2d = x.reshape(m, t.k)
    x2_2d = x2.reshape(m, t.k) if mode == "silu_mul" else None
    res2d = residual.reshape(m, t.n) if residual is not None else None
    if impl == "dequant":
        h = ternary_gemm.decode_input(x2d, x2_2d, norm_g, mode, sub_norm,
                                      norm_n or t.k, eps)
        out = ternary_matmul(h, t, impl="dequant", out_dtype=out_dtype)
        if res2d is not None:
            out = res2d.to(out_dtype) + out
        return out.reshape(*batch, t.n)
    if m <= SMALL_M and impl == "auto":
        out = ternary_gemm.ternary_gemm_decode(
            x2d, t.packed, t.scale_vector(), x2=x2_2d, norm_g=norm_g,
            residual=res2d, fmt=t.fmt, kb=t.kb, k=t.k, mode=mode,
            sub_norm=sub_norm, norm_n=norm_n or t.k, eps=eps,
            out_dtype=out_dtype,
        )
        return out[:, : t.n].reshape(*batch, t.n)
    xq, xs = quantize_activations(ternary_gemm.decode_input(
        x2d, x2_2d, norm_g, mode, sub_norm, norm_n or t.k, eps))
    out = ternary_matmul_quantized(xq, xs, t, out_dtype=out_dtype)
    if res2d is not None:
        out = res2d.to(out_dtype) + out
    return out.reshape(*batch, t.n)
