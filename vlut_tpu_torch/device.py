"""The port's device rule.

Entry points run on the GPU unless the caller asks for the CPU; without a
GPU they raise instead of falling back.  Float32 work that must match the
CPU holds TF32 off itself (:func:`full_float32`).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def tf32(matmul: bool = False, conv: bool = False):
    """TF32 allowed (or not) for float32 matmuls and for cuDNN
    convolutions inside, the caller's settings restored after
    (``tf32(conv=True)`` is PyTorch's default), through the
    ``fp32_precision`` settings: reading the older ``allow_tf32`` ones
    raises once a caller has set these."""
    flags = ((torch.backends.cuda.matmul, "fp32_precision",
              "tf32" if matmul else "ieee"),
             (torch.backends.cudnn.conv, "fp32_precision",
              "tf32" if conv else "ieee"))
    before = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, before):
            setattr(obj, name, value)


def full_float32():
    """Float32 matmuls and convolutions in full float32 whatever the
    caller's setting (PyTorch leaves cuDNN's TF32 on by default, which
    moves a float32 convolution by about 1e-3); as a decorator,
    ``@full_float32()``, it holds for each call."""
    return tf32()
