"""Slot KV cache (port of vlut_tpu/runtime/kv_cache.py, bf16 "layers"
layout only).

The cache is ``{"k": [L tensors], "v": [L tensors]}`` with one
(n_slots, max_len, n_kv_heads, head_dim) tensor per layer, so every layer's
rows update in place.  The int8 (q8) cache is not ported yet.
"""

from __future__ import annotations

import torch


def new_cache(
    n_layers: int, n_slots: int, max_len: int, n_kv_heads: int,
    head_dim: int, dtype=torch.bfloat16, device="cpu",
) -> dict[str, list[torch.Tensor]]:
    shape = (n_slots, max_len, n_kv_heads, head_dim)
    return {
        name: [torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)]
        for name in ("k", "v")
    }


def max_len_of(cache: dict) -> int:
    return cache["k"][0].shape[1]
