"""Lossless ternary weight packing (byte slab layout), PyTorch port.

Port of ``vlut_tpu/ops/packing.py``.  Only the byte layout exists here:

    byte[block b, row j, col n] field q  <->  W[b*kb + q*(kb/r) + j, n]

with r trits per byte (i2: 4 two-bit fields, 2.0 bpw; i1: 5 base-3 digits,
1.6 bpw) and kb = 128 (i2) / 160 (i1), so every slab is kb/r = 32 rows.
The JAX package's uint32 "word" layout exists only for the TPU compiler's
sublane bitcast; :class:`TernaryTensor` refuses it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

Format = Literal["i2", "i1"]

TRITS_PER_BYTE = {"i2": 4, "i1": 5}
DEFAULT_BLOCK = {"i2": 128, "i1": 160}
LANES = 128  # packed channel dim is padded to this (checkpoint format)

_POW3 = (1, 3, 9, 27, 81)


@dataclasses.dataclass
class TernaryTensor:
    """A packed ternary weight matrix with its magnitude scale.

    ``packed``: (k_padded // r, n_padded) uint8.  ``scale``: float32 of shape
    () (per-tensor) or (n,) / (n_padded,) (per-channel).  ``k``/``n`` are the
    logical dims, ``kb`` the pack block.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    n: int
    fmt: Format
    kb: int

    def __post_init__(self):
        if self.packed.dtype != torch.uint8:
            raise TypeError(
                f"packed must be the uint8 byte layout, got {self.packed.dtype}"
                " (the uint32 word layout is TPU-only and not supported here)"
            )

    @property
    def k_padded(self) -> int:
        return self.packed.shape[-2] * TRITS_PER_BYTE[self.fmt]

    @property
    def n_padded(self) -> int:
        return self.packed.shape[-1]

    def scale_vector(self) -> torch.Tensor:
        """Weight scale broadcast to (n_padded,) float32, zero past n."""
        s = self.scale.to(torch.float32)
        np_ = self.n_padded
        if s.dim() == 0 or s.shape == (1,):
            # per-tensor (a tuple-layers checkpoint stores it as (1,))
            return s.reshape(()).expand(np_).contiguous()
        if s.shape[0] == np_:
            return s.contiguous()
        if s.shape != (self.n,):
            raise ValueError(f"scale of shape {tuple(s.shape)} fits neither "
                             f"n={self.n} nor n_padded={np_}")
        out = torch.zeros(np_, dtype=torch.float32, device=s.device)
        out[: s.shape[0]] = s
        return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_k(k: int, fmt: str, kb: int | None = None) -> int:
    """Packed K for a logical K (pack_ternary's alignment rule)."""
    kb = kb or DEFAULT_BLOCK[fmt]
    k_align = math.lcm(kb, LANES)
    if fmt == "i1" and k >= 4 * k_align:
        # large-K i1 weights pad to 4*640 = 2560 multiples, as the JAX
        # converter does, so checkpoints keep the same byte layout
        k_align *= 4
    return _round_up(k, k_align)


def pack_ternary(
    trits,
    scale=1.0,
    fmt: Format = "i2",
    kb: int | None = None,
) -> TernaryTensor:
    """Pack a {-1, 0, +1} (K, N) matrix (numpy or torch) into a TernaryTensor.

    Byte-identical to the JAX package's ``pack_ternary``; padding trits are
    zero.  The packed tensor lies on the trits' device (CPU for numpy).
    """
    t_in = torch.as_tensor(np.asarray(trits) if not torch.is_tensor(trits)
                           else trits)
    if t_in.dim() != 2:
        raise ValueError(f"expected 2-D (K, N) trits, got {tuple(t_in.shape)}")
    r = TRITS_PER_BYTE[fmt]
    kb = kb or DEFAULT_BLOCK[fmt]
    if kb % r:
        raise ValueError(f"kb={kb} must be divisible by {r} for fmt={fmt}")
    k, n = t_in.shape
    kp = padded_k(k, fmt, kb)
    npad = _round_up(n, LANES)
    t = torch.zeros((kp, npad), dtype=torch.int16, device=t_in.device)
    t[:k, :n] = t_in.to(torch.int16)
    if not bool(((t >= -1) & (t <= 1)).all()):
        raise ValueError("trits must be in {-1, 0, +1}")
    nb, slab = kp // kb, kb // r
    t = (t + 1).reshape(nb, r, slab, npad)
    acc = torch.zeros((nb, slab, npad), dtype=torch.int16, device=t.device)
    for q in range(r):
        acc += t[:, q] << (2 * q) if fmt == "i2" else t[:, q] * _POW3[q]
    packed = acc.to(torch.uint8).reshape(kp // r, npad)
    scale_t = torch.as_tensor(np.asarray(scale, dtype=np.float32)
                              if not torch.is_tensor(scale) else scale,
                              dtype=torch.float32, device=packed.device)
    return TernaryTensor(packed=packed, scale=scale_t, k=k, n=n, fmt=fmt,
                         kb=kb)


def random_packed_bytes(shape, fmt: str, gen: torch.Generator,
                        device) -> torch.Tensor:
    """Random valid packed bytes (benchmark weights made on the device):
    i1 bytes uniform in [0, 243); i2 bytes of four 2-bit fields, each in
    {0, 1, 2}, from base-3 codes < 81 (a random byte could hold field value
    3, which is not a trit)."""
    if fmt == "i1":
        return torch.randint(0, 243, shape, generator=gen, device=device,
                             dtype=torch.int32).to(torch.uint8)
    c = torch.randint(0, 81, shape, generator=gen, device=device,
                      dtype=torch.int32)
    out = torch.zeros_like(c)
    for q in range(4):
        out |= (c % 3) << (2 * q)
        c = c // 3
    return out.to(torch.uint8)


def unpack_fields(packed: torch.Tensor, fmt: str, kb: int) -> torch.Tensor:
    """(Kp/r, Np) uint8 -> (Kp, Np) int16 FIELDS in {0, 1, 2} (trit + 1)."""
    r = TRITS_PER_BYTE[fmt]
    rows, np_ = packed.shape
    slab = kb // r
    nb = rows // slab
    p = packed.to(torch.int16).reshape(nb, slab, np_)
    if fmt == "i2":
        fields = [(p >> (2 * q)) & 3 for q in range(r)]
    else:
        fields = [(p // _POW3[q]) % 3 for q in range(r)]
    return torch.stack(fields, dim=1).reshape(nb * kb, np_)


def unpack_ternary(
    t: TernaryTensor, dtype=torch.int8, keep_padding: bool = False
) -> torch.Tensor:
    """Exact inverse of :func:`pack_ternary`: (k, n) trits (or the padded
    (k_padded, n_padded) matrix with ``keep_padding``)."""
    w = unpack_fields(t.packed, t.fmt, t.kb) - 1
    if not keep_padding:
        w = w[: t.k, : t.n]
    return w.to(dtype)


def ternarize(w, method: str = "bitnet") -> tuple[np.ndarray, np.float32]:
    """Float weights -> (trits, scale) with BitNet absmean scaling (host,
    numpy); identical to the JAX package's ``ternarize``."""
    w = np.asarray(w, dtype=np.float32)
    if method == "sign":
        trits = np.where(np.abs(w) > 1e-6, np.sign(w), 0.0)
        return trits.astype(np.int8), np.float32(1.0)
    nz = w != 0
    s = np.abs(w[nz]).mean() if nz.any() else 0.0
    s = max(float(s), 1e-8)
    trits = np.clip(np.round(w / s), -1, 1)
    return trits.astype(np.int8), np.float32(s)
