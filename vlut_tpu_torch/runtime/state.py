"""Slot state serialization (port of vlut_tpu/runtime/state.py).

A slot's valid KV rows and its token history round-trip through an npz
file in the JAX package's format, so a state saved by either package
restores in the other:

* ``version`` (1) and ``tokens`` int64;
* ``kv_<name>`` for every cache entry: (L, length, Hkv, hd_p) rows of the
  slot (scale planes (L, length, Hkv)), floats stored as float32, the int8
  codes of a q8 cache as int8.  Files from before the q8 cache hold ``k``
  and ``v`` instead, and restore into a bf16 cache.

The port writes the zip entries stored rather than deflated; ``np.load``
reads either.

A restore writes into the cache tensors in place (``copy_``): a captured
decode graph holds them by pointer.
"""

from __future__ import annotations

import io
import pathlib

import numpy as np
import torch

from vlut_tpu_torch.runtime.kv_cache import max_len_of

STATE_VERSION = 1


def _store(t: torch.Tensor) -> np.ndarray:
    # npz cannot hold bfloat16: floats go as float32 (exact for bf16), the
    # int8 codes keep their type
    if t.dtype.is_floating_point:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save_slot_state(cache: dict, slot: int, length: int,
                    history: list[int]) -> bytes:
    """Serialize rows [0, length) of ``slot`` and its token history."""
    arrays = {name: np.stack([_store(a[slot, :length]) for a in arrs])
              for name, arrs in cache.items()}
    buf = io.BytesIO()
    # stored, not deflated (the JAX package deflates; np.load reads both):
    # deflating a 305-row llama3_8b_158 slot (80 MB) took 19 s on the host
    # of an H100 server (chip_smoke.py phase 17)
    np.savez(
        buf, version=STATE_VERSION,
        tokens=np.asarray(history[:length], np.int64),
        **{f"kv_{name}": a for name, a in arrays.items()})
    return buf.getvalue()


@torch.no_grad()
def load_slot_state(cache: dict, slot: int, data: bytes) -> list[int]:
    """Write a serialized slot into ``slot`` of ``cache`` in place; returns
    its token history."""
    with np.load(io.BytesIO(data)) as z:
        if int(z["version"]) != STATE_VERSION:
            raise ValueError("unsupported state version")
        if "recurrent" in z.files:
            raise NotImplementedError(
                "recurrent slot state is not ported to vlut_tpu_torch "
                "(recurrent models are refused)")
        tokens = z["tokens"]
        arrays = {name[3:]: z[name] for name in z.files
                  if name.startswith("kv_")}
        if not arrays:  # version-1 files from before the q8 cache
            arrays = {"k": z["k"], "v": z["v"]}
    if set(arrays) != set(cache):
        raise ValueError(
            f"state keys {sorted(arrays)} don't match cache {sorted(cache)}"
            " (saved with a different KV cache type?)")
    length = arrays["k"].shape[1]
    if length > max_len_of(cache):
        raise ValueError("state longer than cache capacity")
    for name, arrs in cache.items():
        rows = arrays[name]
        if rows.shape[0] != len(arrs) or rows.shape[2:] != tuple(
                arrs[0].shape[2:]):
            raise ValueError(f"state entry {name} {rows.shape} does not fit "
                             f"the cache {tuple(arrs[0].shape)}")
        for i, a in enumerate(arrs):
            a[slot, :length].copy_(torch.from_numpy(rows[i]))
    return [int(t) for t in tokens]


def save_slot_file(path, cache: dict, slot: int, length: int,
                   history: list[int]) -> None:
    pathlib.Path(path).write_bytes(
        save_slot_state(cache, slot, length, history))


def load_slot_file(path, cache: dict, slot: int) -> list[int]:
    return load_slot_state(cache, slot, pathlib.Path(path).read_bytes())
