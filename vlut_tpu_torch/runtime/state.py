"""Slot state serialization (port of vlut_tpu/runtime/state.py).

A slot's valid KV rows and its token history round-trip through an npz
file in the JAX package's format, so a state saved by either package
restores in the other:

* ``version`` (1) and ``tokens`` int64;
* ``kv_<name>`` for every cache entry: (L, length, Hkv, hd_p) rows of the
  slot (scale planes (L, length, Hkv)), floats stored as float32, the int8
  codes of a q8 cache as int8.  Files from before the q8 cache hold ``k``
  and ``v`` instead, and restore into a bf16 cache.  In a heterogeneous
  stack, whose layers hold their own KV heads, Hkv is the largest; a
  layer's rows fill its first heads and zeros the rest, as the JAX
  package's cache of the largest count holds them.

A recurrent model's slot (Mamba) holds no rows: its whole state
serializes (:func:`save_recurrent_state`): ``version``, ``recurrent`` (1),
``tokens`` and ``rs_<name>`` (L, ...) float32 for each state entry
(``conv``, ``ssm``).

The port writes the zip entries stored rather than deflated; ``np.load``
reads either.

A restore writes into the cache tensors in place (``copy_``): a captured
decode graph holds them by pointer.  Under tp each rank's cache holds a
contiguous block of every layer's KV heads (``parallel/sharding.py:
cache_specs_for``); the file holds them whole, in global head order, so
it is the same whatever the mesh (``Engine.save_slot`` gathers the
blocks, ``shard=`` restores one).
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
    heads = max(a.shape[2] for a in cache["k"])

    def rows(a):
        r = _store(a[slot, :length])
        pad = [(0, 0)] * r.ndim
        pad[1] = (0, heads - r.shape[1])
        return np.pad(r, pad)

    arrays = {name: np.stack([rows(a) for a in arrs])
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
def load_slot_state(cache: dict, slot: int | None, data: bytes,
                    shard: tuple[int, int] = (0, 1)) -> list[int]:
    """Write a serialized slot into ``slot`` of ``cache`` in place; returns
    its token history.  ``shard`` (index, count): ``cache`` holds block
    ``index`` of ``count`` of every layer's KV heads (a tp rank's), and
    takes those heads of the file.  ``slot`` None: check the file against
    the cache and write nothing."""
    with np.load(io.BytesIO(data)) as z:
        if int(z["version"]) != STATE_VERSION:
            raise ValueError("unsupported state version")
        if "recurrent" in z.files:
            raise ValueError("a recurrent slot state does not restore into a "
                             "KV cache")
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
    index, count = shard
    heads = max(a.shape[2] for a in cache["k"]) * count
    for name, arrs in cache.items():
        rows = arrays[name]
        if rows.shape[0] != len(arrs) or rows.shape[2] != heads or (
                rows.shape[3:] != tuple(arrs[0].shape[3:])):
            raise ValueError(f"state entry {name} {rows.shape} does not fit "
                             f"the cache {tuple(arrs[0].shape)}"
                             + (f" x {count} head blocks" if count > 1
                                else ""))
        if slot is None:
            continue
        for i, a in enumerate(arrs):
            h = a.shape[2]
            a[slot, :length].copy_(torch.from_numpy(
                np.ascontiguousarray(rows[i][:, index * h:(index + 1) * h])))
    return [int(t) for t in tokens]


def save_recurrent_state(state: dict[str, torch.Tensor], slot: int,
                         history: list[int]) -> bytes:
    """Serialize the whole recurrent state of ``slot`` (every entry's
    (L, ...) slice) and its token history."""
    buf = io.BytesIO()
    np.savez(buf, version=STATE_VERSION, recurrent=np.int64(1),
             tokens=np.asarray(history, np.int64),
             **{f"rs_{name}": _store(a[:, slot]) for name, a in state.items()})
    return buf.getvalue()


@torch.no_grad()
def load_recurrent_state(state: dict[str, torch.Tensor], slot: int,
                         data: bytes) -> list[int]:
    """Write a serialized recurrent slot into ``slot`` of ``state`` in
    place; returns its token history."""
    with np.load(io.BytesIO(data)) as z:
        if int(z["version"]) != STATE_VERSION or "recurrent" not in z.files:
            raise ValueError("not a recurrent slot state")
        tokens = z["tokens"]
        arrays = {name[3:]: z[name] for name in z.files
                  if name.startswith("rs_")}
    if set(arrays) != set(state):
        raise ValueError("state keys don't match recurrent cache")
    for name, a in state.items():
        if arrays[name].shape != tuple(a[:, slot].shape):
            raise ValueError(f"state entry {name} {arrays[name].shape} does "
                             f"not fit the state {tuple(a[:, slot].shape)}")
        a[:, slot].copy_(torch.from_numpy(arrays[name]))
    return [int(t) for t in tokens]


def save_slot_file(path, cache: dict, slot: int, length: int,
                   history: list[int]) -> None:
    pathlib.Path(path).write_bytes(
        save_slot_state(cache, slot, length, history))


def load_slot_file(path, cache: dict, slot: int) -> list[int]:
    return load_slot_state(cache, slot, pathlib.Path(path).read_bytes())
