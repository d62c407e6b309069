"""Ternary matmul front end (port of vlut_tpu/ops/matmul.py).

Routing depends on the rows M = prod(x.shape[:-1]) only:

* M <= 64: the small-M kernels (fused-quant GEMM, or the fused decode
  projection for :func:`ternary_matmul_fused`), as on the TPU.
* M > 64: :func:`quantize_activations` then the tiled GEMM.

The TPU's XLA-vs-Pallas crossover (``VLUT_TPU_XLA_MIN_M``) and its autotune
table were measured on a TPU and are not carried over; block shapes are the
kernels' own constants.  On the CPU every wrapper runs its plain PyTorch
version, so the same routing runs the same integer math on both devices.

``impl`` (also an argument of the model's ``forward``) is ``"auto"``, the
routing above, or ``"dequant"``, the float-dequant accuracy reference:
float32 products with the dequantized weights and no activation
quantization, composed around :func:`ternary_matmul_fused`'s prologue as
the JAX package composes it.  The quantized-vs-dequant KL of
``eval/perplexity.py`` compares the two.
"""

from __future__ import annotations

import math

import torch

from vlut_tpu_torch.ops import ternary_gemm
from vlut_tpu_torch.ops.packing import TernaryTensor, unpack_ternary
from vlut_tpu_torch.ops.quant import quantize_activations

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
) -> torch.Tensor:
    """x (..., K) float @ ternary W (K, N) -> (..., N).

    ``round(x*127/max|x|) @ trits * (max|x|/127) * w_scale`` with an int32
    accumulator.
    """
    out_dtype = out_dtype or (x.dtype if x.dtype != torch.float64
                              else torch.float32)
    batch, m = _rows(x, t)
    x2d = x.reshape(m, t.k)
    if impl == "dequant":
        w = unpack_ternary(t, dtype=torch.float32) * t.scale_vector()[: t.n]
        return (x2d.to(torch.float32) @ w).to(out_dtype).reshape(*batch, t.n)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
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
    if impl not in ("auto", "dequant"):
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
    if m <= SMALL_M:
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
