"""Device-side paged KV cache: page pools + block-table indexed access.

Counterpart of simplellminference_tpu/memory/paged_kv.py:47-415 for bf16
and f32 storage. Pool layout k/v [L, num_pages + 1, kvN, page_size, D]:
the last page row is the TRASH page, which unmapped (-1) table entries
write to and the allocator never hands out, so pools compare page for
page with the JAX package's.

The pools are updated IN PLACE by the write functions (the JAX package
donates the cache to its jitted graphs and the Pallas kernels alias it);
they return the same tensors for symmetry with the reference.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from simplellminference_tpu_torch.core.device import resolve_device
from simplellminference_tpu_torch.ops.paged_append import (
    paged_append_decode, paged_append_prefill)


def kv_storage_dtype(name: str) -> torch.dtype:
    """KV storage dtypes: bf16, f32, fp8 (e4m3), int8."""
    return {"bf16": torch.bfloat16, "f32": torch.float32,
            "fp8": torch.float8_e4m3fn, "int8": torch.int8}[name]


@dataclasses.dataclass
class PagedKVCache:
    """k/v: [L, num_pages + 1, kv_heads, page_size, head_dim]."""

    k: torch.Tensor
    v: typing.Optional[torch.Tensor] = None

    @classmethod
    def create(cls, num_layers: int, num_pages: int, num_kv_heads: int,
               page_size: int, head_dim: int, dtype=torch.bfloat16,
               shared_kv: bool = False, device=None) -> "PagedKVCache":
        """Allocates ``num_pages`` usable pages + one trash page, zeroed,
        on ``device`` (CUDA unless ``device="cpu"``)."""
        if shared_kv:
            raise NotImplementedError("shared-KV pools (absorbed MLA)")
        if dtype in (torch.int8, torch.float8_e4m3fn):
            raise NotImplementedError(f"{dtype} KV storage")
        dev = resolve_device(device)
        shape = (num_layers, num_pages + 1, num_kv_heads, page_size,
                 head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))

    def with_windowed(self, num_layers_w: int, num_pages_w: int):
        raise NotImplementedError("windowed ring pools (sliding-window KV "
                                  "reclamation)")

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def dtype(self):
        return self.k.dtype


def write_prefill_stacked(pool_k, pool_v, new_k, new_v, tables, layer: int,
                          pool_ks=None, pool_vs=None, page_offset=None):
    """Stacked-pool prefill write of S new rows per sequence: a whole
    prompt from position 0, or with ``page_offset`` (the first table
    column to write, a scalar or [B]: chunks and prefix-cached suffixes
    start at their own page-aligned offsets) a chunk. Table columns past
    the width map to -1, the trash page. Returns (pool_k, pool_v, None,
    None), updated in place."""
    if pool_ks is not None or pool_vs is not None:
        raise NotImplementedError("INT8 KV (scale pools)")
    if page_offset is not None:
        b, mp = tables.shape
        npg = -(-new_k.shape[1] // pool_k.shape[3])
        po = torch.as_tensor(page_offset, dtype=torch.long,
                             device=tables.device)
        if po.ndim == 0:
            po = po.expand(b)
        cols = po[:, None] + torch.arange(npg, device=tables.device)[None]
        got = tables.gather(1, cols.clamp(max=mp - 1))
        tables = torch.where(cols < mp, got, torch.full_like(got, -1))
    pk, pv = paged_append_prefill(pool_k, pool_v, new_k, new_v, tables,
                                  layer)
    return pk, pv, None, None


def write_decode_stacked(pool_k, pool_v, new_k, new_v, tables, positions,
                         layer: int, pool_ks=None, pool_vs=None):
    """Stacked-pool decode write: one token per sequence at ``layer``.
    Returns (pool_k, pool_v, None, None), updated in place."""
    if pool_ks is not None or pool_vs is not None:
        raise NotImplementedError("INT8 KV (scale pools)")
    pk, pv = paged_append_decode(pool_k, pool_v, new_k, new_v, tables,
                                 positions, layer)
    return pk, pv, None, None


def gather_dense(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 tables: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference path: gather pages into a dense [B, kvN, MP*ps, D] view.

    pool_k/v: one layer, [P, kvN, ps, D]. Unmapped (-1) pages come back as
    zeros, which is what the decode kernel reads there too. (The JAX
    ``mode="fill"`` gather normalizes -1 to the last row first and so
    reads the trash page; callers mask by kv_len, so only dead rows
    differ.)"""
    p, kvn, ps, d = pool_k.shape
    b, mp = tables.shape
    idx = tables.reshape(-1).long()
    valid = ((idx >= 0) & (idx < p))[:, None, None, None]

    def g(pool):
        x = pool[idx.clamp(0, p - 1)]
        x = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
        return (x.reshape(b, mp, kvn, ps, d).permute(0, 2, 1, 3, 4)
                .reshape(b, kvn, mp * ps, d))

    return g(pool_k), g(pool_v)
