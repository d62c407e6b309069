"""Per-token int8 activation quantization (port of vlut_tpu/ops/quant.py)."""

from __future__ import annotations

import torch


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) float -> (q int8 (..., K), scale float32 (..., 1)).

    q = round_half_even(x * 127 / max|x|), clipped to [-127, 127];
    q * scale ~= x.  Zero rows get scale 0 and q 0.  ``torch.round`` rounds
    half to even, as ``jnp.round`` does, and both divisions are true
    divisions (:func:`true_div`), so codes and scales are bit-equal.
    """
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    inv = torch.where(amax > 0, true_div(127.0, amax), torch.zeros_like(amax))
    q = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return q, true_div(amax, 127.0)


def true_div(a, b) -> torch.Tensor:
    """Elementwise IEEE a / b with a Python float on either side.

    PyTorch evaluates ``c / t`` as ``reciprocal(t) * c`` and, on CUDA,
    ``t / c`` as ``t * (1 / c)``; either can differ from the division
    by one ulp, which moves int8 codes across rounding boundaries.  A tensor
    divisor and dividend keep the true division on every device.
    """
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b
