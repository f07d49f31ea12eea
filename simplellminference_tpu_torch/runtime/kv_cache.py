"""The dense per-sequence KV arena.

Counterpart of simplellminference_tpu/runtime/kv_cache.py:27
(``DenseKVCache``) and :50 (``update_layer``). Layout k/v
[L, B, kvN, Smax, D]: one row of ``max_seq`` slots per sequence, the
layout ``flash_decode`` and ``kv_append`` read and write. The arena is
updated in place (the JAX package keeps it as donated loop state).
"""

from __future__ import annotations

import dataclasses

import torch

from simplellminference_tpu_torch.core.device import resolve_device
from simplellminference_tpu_torch.ops.kv_append import kv_append


@dataclasses.dataclass
class DenseKVCache:
    """Dense KV arena: k/v of shape [L, B, kv_heads, max_seq, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, num_layers: int, batch: int, max_seq: int,
               num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device=None) -> "DenseKVCache":
        """A zeroed arena on ``device`` (CUDA unless ``device="cpu"``)."""
        dev = resolve_device(device)
        shape = (num_layers, batch, num_kv_heads, max_seq, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def update_layer(cache_k_layer: torch.Tensor, cache_v_layer: torch.Tensor,
                 new_k: torch.Tensor, new_v: torch.Tensor,
                 offsets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write [B, S, kvN, D] projections into one layer's [B, kvN, Smax, D]
    arena in place, sequence b from slot ``offsets[b]`` (through
    :func:`kv_append` on the layer as a one-layer stack)."""
    kv_append(cache_k_layer[None], cache_v_layer[None], new_k, new_v, 0,
              offsets)
    return cache_k_layer, cache_v_layer
