"""Norms in float32 math with the IO dtype kept (port of vlut_tpu/ops/norm.py
and of the norm helpers of vlut_tpu/models/transformer.py).

Every divisor is the *logical* width: padded tails (head padding, chunk
padding) are zero and do not skew the statistics.  Divisions by the width
are true divisions (``true_div``), as the JAX package's ``ss / n`` is.
"""

from __future__ import annotations

import torch

from vlut_tpu_torch.ops.quant import true_div
from vlut_tpu_torch.parallel._comm import copy_to, psum

# chameleon's per-head LayerNorm fixes its epsilon (ChameleonLayerNorm)
HEAD_LN_EPS = 1e-5


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return out.to(x.dtype)


def _shard_sum(s: torch.Tensor, group) -> torch.Tensor:
    """A statistic of a dim sharded over ``group``: the shards' sums added,
    and (the statistic scales every shard's outputs) its gradient summed
    from every shard's."""
    return copy_to(psum(s, group), group)


def gain(weight: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """The float32 gain: ``w``, or gemma's ``1 + w``."""
    w = weight.to(torch.float32)
    return 1.0 + w if plus_one else w


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float, n_logical: int,
        plus_one: bool = False, group=None) -> torch.Tensor:
    """RMSNorm over the last dim whose zero-padded tail does not skew the
    mean; ``plus_one``: the gain is ``1 + w``.  ``group``: the dim is
    sharded over that mesh axis (bitnet's sub-norms under tp), and the sum
    of squares is summed over it."""
    xf = x.to(torch.float32)
    ss = _shard_sum((xf * xf).sum(dim=-1, keepdim=True), group)
    out = (xf * torch.rsqrt(true_div(ss, float(n_logical)) + eps)
           * gain(weight, plus_one))
    return out.to(x.dtype)


def rms_whole(z: torch.Tensor, weight: torch.Tensor, eps: float,
              n_logical: int) -> torch.Tensor:
    """RMSNorm over the last two dims jointly (olmo2's whole-width q/k norm):
    z (..., H, hd_p), weight flat (H * hd_p,) in the head-padded layout."""
    zf = z.to(torch.float32)
    ms = true_div((zf * zf).sum(dim=(-2, -1), keepdim=True), float(n_logical))
    w = weight.to(torch.float32).reshape(z.shape[-2], z.shape[-1])
    return (zf * torch.rsqrt(ms + eps) * w).to(z.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, eps: float, n_logical: int,
               plus_one: bool = False, group=None) -> torch.Tensor:
    """Mean-centred LayerNorm from the sums of x and x*x (the JAX package's
    one-pass form); ``bias`` None for bias-free variants, ``plus_one`` for
    nemotron's (1 + w); ``group`` as for :func:`rms`."""
    xf = x.to(torch.float32)
    n = float(n_logical)
    mean = true_div(_shard_sum(xf.sum(dim=-1, keepdim=True), group), n)
    var = (true_div(_shard_sum((xf * xf).sum(dim=-1, keepdim=True), group),
                    n)
           - mean * mean)
    out = (xf - mean) * torch.rsqrt(var + eps) * gain(weight, plus_one)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def head_layer_norm(z: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    valid: torch.Tensor, n_logical: int) -> torch.Tensor:
    """Per-head LayerNorm over the head dim (chameleon's q/k norm): z (..., H,
    hd_p), weight/bias (H, hd_p) in the head-padded layout, ``valid`` (hd_p,)
    1.0 at the logical positions; the pad positions come out zero.  Returns
    float32."""
    zf = z.to(torch.float32)
    n = float(n_logical)
    mu = true_div(zf.sum(dim=-1, keepdim=True), n)
    zc = (zf - mu) * valid
    var = true_div((zc * zc).sum(dim=-1, keepdim=True), n)
    return (zc * torch.rsqrt(var + HEAD_LN_EPS) * weight.to(torch.float32)
            + bias.to(torch.float32)) * valid


def l2_norm(z: torch.Tensor, eps: float, n_logical: int) -> torch.Tensor:
    """Weightless per-head RMS normalization (llama4's L2 q/k norm)."""
    zf = z.to(torch.float32)
    ss = true_div((zf * zf).sum(dim=-1, keepdim=True), float(n_logical))
    return (zf * torch.rsqrt(ss + eps)).to(z.dtype)
