"""Padded dimension plan (own copy of vlut_tpu/models/dims.py).

The port reads and writes the JAX package's checkpoint layout, so the plan
that fixes every padded width is copied here unchanged.  Original notes:

TPU-first re-think of the reference's layouts (which are byte-exact GGUF and
don't care about lanes): the checkpoint is packed once with enough padding
that the same arrays shard evenly over any tensor-parallel degree dividing
``plan.tp_pack``, with zero-trit padding keeping all math exact.

Three padding mechanisms, all applied at pack time:

* **head padding** — head_dim is padded to a lane multiple (BitNet-3B's
  hd=100 -> 128) using a rope-aware per-head column permutation: logical
  half-pairs (i, i+hd/2) land at padded positions (i, i+hd_p/2), so
  split-half rotary on the padded layout equals logical rotary and pad
  components stay exactly zero.
* **chunk padding** — K-sharded weights (wo, w_down) are laid out as
  ``tp_pack`` row chunks, each padded to a multiple of lcm(kb, 128); the
  activations feeding them (attention output, gate*up) are produced in the
  same chunk layout, so every shard boundary falls on a pack-block boundary
  for any tp | tp_pack.  For i2 (kb=128) the chunk pad is a no-op.
* **vocab padding** — the lm_head vocab dim is padded to 128 * tp_pack;
  engines mask logits >= vocab_size before sampling.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.ops.packing import DEFAULT_BLOCK, LANES


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DimPlan:
    tp_pack: int  # effective pack-sharding degree (divides n_heads)
    kb: int       # pack block
    hd: int       # logical head dim
    hd_p: int     # padded head dim (lane multiple)
    q_dim_p: int  # n_heads * hd_p — attention-layout width
    kv_dim_p: int
    wo_chunk: int    # q_dim_p / tp_pack
    wo_chunk_p: int  # chunk padded to lcm(kb, 128)
    wo_in_p: int     # tp_pack * wo_chunk_p — wo packed K
    ff_chunk: int    # ceil(d_ff / tp_pack) — logical cols per chunk
    ff_chunk_p: int
    ff_p: int        # tp_pack * ff_chunk_p — gate/up N and down K
    vocab_p: int


def make_plan(cfg: ModelConfig, tp_pack: int | None = None) -> DimPlan:
    tp = tp_pack or cfg.tp_pack
    tp = math.gcd(tp, cfg.n_heads)  # wo chunking needs tp_pack | n_heads
    kb = DEFAULT_BLOCK[cfg.weight_fmt]
    align = math.lcm(kb, LANES)
    # an MLA model's head_dim is its v head (the converter's mapping): wo's
    # rows pad by it, as minicpm3's 64 pads to 128
    hd = cfg.head_dim_
    hd_p = _round_up(hd, LANES)
    q_dim_p = cfg.n_heads * hd_p
    wo_chunk = q_dim_p // tp
    wo_chunk_p = _round_up(wo_chunk, align)
    ff_chunk = -(-cfg.d_ff // tp)
    ff_chunk_p = _round_up(ff_chunk, align)
    return DimPlan(
        tp_pack=tp,
        kb=kb,
        hd=hd,
        hd_p=hd_p,
        q_dim_p=q_dim_p,
        kv_dim_p=cfg.n_kv_heads * hd_p,
        wo_chunk=wo_chunk,
        wo_chunk_p=wo_chunk_p,
        wo_in_p=tp * wo_chunk_p,
        ff_chunk=ff_chunk,
        ff_chunk_p=ff_chunk_p,
        ff_p=tp * ff_chunk_p,
        vocab_p=_round_up(cfg.vocab_size, LANES * tp),
    )


def _zeros(like, shape):
    """Zeros of ``like``'s kind (a numpy array or a tensor on its device)
    and dtype: the padding below moves numpy trits on the host and a
    tensor's on its device."""
    if isinstance(like, np.ndarray):
        return np.zeros(shape, like.dtype)
    return like.new_zeros(shape)


def _at(like, idx: np.ndarray):
    """An index array usable on ``like``."""
    if isinstance(like, np.ndarray):
        return idx
    return torch.as_tensor(idx, device=like.device)


# --- head padding (rope-pairing preserving) ---------------------------------

def head_positions(hd: int, hd_p: int) -> np.ndarray:
    """Padded position of each logical head dim."""
    if hd == hd_p:
        return np.arange(hd)
    if hd % 2:
        raise ValueError(f"odd head_dim {hd} unsupported")
    half, half_p = hd // 2, hd_p // 2
    pos = np.empty(hd, np.int64)
    pos[:half] = np.arange(half)
    pos[half:] = half_p + np.arange(half)
    return pos


def pad_heads_cols(w: np.ndarray, n_heads: int, hd: int, hd_p: int) -> np.ndarray:
    """(K, n_heads*hd) -> (K, n_heads*hd_p) with the rope-aware layout."""
    if hd == hd_p:
        return w
    k = w.shape[0]
    out = _zeros(w, (k, n_heads, hd_p))
    out[:, :, _at(w, head_positions(hd, hd_p))] = w.reshape(k, n_heads, hd)
    return out.reshape(k, n_heads * hd_p)


def pad_heads_rows(w: np.ndarray, n_heads: int, hd: int, hd_p: int) -> np.ndarray:
    """(n_heads*hd, N) -> (n_heads*hd_p, N) matching pad_heads_cols."""
    if hd == hd_p:
        return w
    n = w.shape[1]
    out = _zeros(w, (n_heads, hd_p, n))
    out[:, _at(w, head_positions(hd, hd_p))] = w.reshape(n_heads, hd, n)
    return out.reshape(n_heads * hd_p, n)


# --- chunk padding -----------------------------------------------------------

def chunk_positions(n_logical: int, chunk: int, chunk_p: int) -> np.ndarray:
    """Padded position of each logical index for the chunk layout."""
    idx = np.arange(n_logical)
    return (idx // chunk) * chunk_p + (idx % chunk)


def scatter_rows(w: np.ndarray, chunk: int, chunk_p: int, total_p: int):
    """(K_logical, N) -> (total_p, N), chunk-padded rows."""
    if chunk == chunk_p and total_p == w.shape[0]:
        return w
    out = _zeros(w, (total_p, w.shape[1]))
    out[_at(w, chunk_positions(w.shape[0], chunk, chunk_p))] = w
    return out


def scatter_cols(w: np.ndarray, chunk: int, chunk_p: int, total_p: int):
    """(K, N_logical) -> (K, total_p), chunk-padded columns."""
    if chunk == chunk_p and total_p == w.shape[1]:
        return w
    out = _zeros(w, (w.shape[0], total_p))
    out[:, _at(w, chunk_positions(w.shape[1], chunk, chunk_p))] = w
    return out


def scatter_vec(v: np.ndarray, chunk: int, chunk_p: int, total_p: int):
    if chunk == chunk_p and total_p == v.shape[0]:
        return v
    out = np.zeros((total_p,), v.dtype)
    out[chunk_positions(v.shape[0], chunk, chunk_p)] = v
    return out


def pad_vec_heads(v: np.ndarray, n_heads: int, hd: int, hd_p: int) -> np.ndarray:
    """(n_heads*hd,) norm weights -> (n_heads*hd_p,), pad zero."""
    if hd == hd_p:
        return v
    out = np.zeros((n_heads, hd_p), v.dtype)
    out[:, head_positions(hd, hd_p)] = v.reshape(n_heads, hd)
    return out.reshape(-1)
