"""Device-side paged KV cache: page pools + block-table indexed access.

Counterpart of simplellminference_tpu/memory/paged_kv.py:47-415 for bf16,
f32, FP8 (float8_e4m3fn, no scale pools: the rows are cast with the JAX
package's rounding, ``ops.ref_ops.to_e4m3``) and INT8 storage. Pool layout
k/v [L, num_pages + 1, kvN, page_size, D]: the last page row is the TRASH
page, which unmapped (-1) table entries write to and the allocator never
hands out, so pools compare page for page with the JAX package's. INT8
pools carry per-token-per-head f32 scale pools k/v_scale [L, num_pages +
1, kvN, page_size] at the same page ids, written beside the codes and read
back through the same tables.

The windowed group (paged_kv.py:71-119, the grouped engine's
sliding-window KV reclamation): models with sliding layers keep those
layers' KV in separate pools k_w/v_w [Lw, Pw+1, kvN, ps, D] (with
k_w_scale/v_w_scale for INT8 KV), Pw = max_batch * R ring pages, which
the engine addresses through static per-slot ring tables; over FP8 KV
they are e4m3 ring pools, with no scale pools.

A shared-KV cache (absorbed MLA, paged_kv.py:63-66, :84-101) holds one
pool: ``v`` is None and the K pool's row (the latent row) is also the
value. Its writes store the K rows alone (kernels 1l and 2l), its
attention reads each page once for both products (4l, 8l), and
:func:`gather_dense` returns K as V. bf16 and f32 only: INT8 and e4m3
shared pools, and the span write over one, are not ported.

The pools are updated IN PLACE by the write functions (the JAX package
donates the cache to its jitted graphs and the Pallas kernels alias it);
they return the same tensors for symmetry with the reference.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from simplellminference_tpu_torch.core.device import resolve_device
# quantize_kv lives beside the kernels that repeat its math and is
# exported here, where the JAX package keeps it
from simplellminference_tpu_torch.ops.paged_append import (  # noqa: F401
    check_scale_pools, paged_append_decode, paged_append_decode_quant,
    paged_append_prefill, paged_append_prefill_quant, paged_append_span,
    quantize_kv, span_slots)


def kv_storage_dtype(name: str) -> torch.dtype:
    """KV storage dtypes: bf16, f32, fp8 (e4m3), int8."""
    return {"bf16": torch.bfloat16, "f32": torch.float32,
            "fp8": torch.float8_e4m3fn, "int8": torch.int8}[name]


@dataclasses.dataclass
class PagedKVCache:
    """k/v: [L, num_pages + 1, kv_heads, page_size, head_dim]; for int8
    storage k/v_scale: [L, num_pages + 1, kv_heads, page_size] f32. The
    windowed group's pools k_w/v_w (and k_w_scale/v_w_scale): the same
    with Lw layers and Pw + 1 pages, None without a windowed group."""

    k: torch.Tensor
    v: typing.Optional[torch.Tensor] = None
    k_scale: typing.Optional[torch.Tensor] = None
    v_scale: typing.Optional[torch.Tensor] = None
    k_w: typing.Optional[torch.Tensor] = None
    v_w: typing.Optional[torch.Tensor] = None
    k_w_scale: typing.Optional[torch.Tensor] = None
    v_w_scale: typing.Optional[torch.Tensor] = None

    @classmethod
    def create(cls, num_layers: int, num_pages: int, num_kv_heads: int,
               page_size: int, head_dim: int, dtype=torch.bfloat16,
               shared_kv: bool = False, device=None) -> "PagedKVCache":
        """Allocates ``num_pages`` usable pages + one trash page, zeroed,
        on ``device`` (CUDA unless ``device="cpu"``); int8 pools get zeroed
        scale pools, float8_e4m3fn pools none. ``shared_kv``: one pool
        serves as K and V (absorbed MLA's latent rows), ``v`` stays None
        (bf16 and f32 only)."""
        dev = resolve_device(device)
        shape = (num_layers, num_pages + 1, num_kv_heads, page_size,
                 head_dim)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        if shared_kv:
            if dtype not in (torch.bfloat16, torch.float32):
                raise NotImplementedError(
                    f"{dtype} shared-KV pools (INT8/FP8 KV under absorbed "
                    f"MLA)")
            return cls(k=zeros(shape, dtype))

        if dtype == torch.int8:
            return cls(k=zeros(shape, dtype), v=zeros(shape, dtype),
                       k_scale=zeros(shape[:-1], torch.float32),
                       v_scale=zeros(shape[:-1], torch.float32))
        return cls(k=zeros(shape, dtype), v=zeros(shape, dtype))

    def with_windowed(self, num_layers_w: int,
                      num_pages_w: int) -> "PagedKVCache":
        """This cache with a windowed-group pool set attached: zeroed
        [Lw, Pw+1, kvN, ps, D] pools (the usual trash page last) of this
        cache's geometry, dtype and device, and zeroed f32 scale pools for
        int8 storage (e4m3 storage: none)."""
        _, _, kvn, ps, d = self.k.shape
        shape = (num_layers_w, num_pages_w + 1, kvn, ps, d)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=self.k.device)

        kw = dict(k_w=zeros(shape, self.k.dtype),
                  v_w=zeros(shape, self.k.dtype))
        if self.k_scale is not None:
            kw.update(k_w_scale=zeros(shape[:-1], torch.float32),
                      v_w_scale=zeros(shape[:-1], torch.float32))
        return dataclasses.replace(self, **kw)

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
    the width map to -1, the trash page. With scale pools the rows are
    quantized (:func:`quantize_kv`); into e4m3 pools they are converted
    with the JAX package's rounding (kernel 2e). A shared pool
    (``pool_v`` None) takes the K rows alone (kernel 2l; ``new_v`` is not
    read). Returns (pool_k, pool_v, pool_ks, pool_vs), updated in place
    (the scale pools None without them)."""
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
    if pool_ks is not None or pool_vs is not None:
        return paged_append_prefill_quant(pool_k, pool_v, pool_ks, pool_vs,
                                          new_k, new_v, tables, layer)
    pk, pv = paged_append_prefill(pool_k, pool_v, new_k,
                                  None if pool_v is None else new_v, tables,
                                  layer)
    return pk, pv, None, None


def write_decode_stacked(pool_k, pool_v, new_k, new_v, tables, positions,
                         layer: int, pool_ks=None, pool_vs=None):
    """Stacked-pool decode write: one token per sequence at ``layer``,
    quantized when scale pools are given, converted into e4m3 pools
    (kernel 1e); into a shared pool (``pool_v`` None) the K row alone
    (kernel 1l). Returns (pool_k, pool_v, pool_ks, pool_vs), updated in
    place."""
    if pool_ks is not None or pool_vs is not None:
        return paged_append_decode_quant(pool_k, pool_v, pool_ks, pool_vs,
                                         new_k, new_v, tables, positions,
                                         layer)
    pk, pv = paged_append_decode(pool_k, pool_v, new_k,
                                 None if pool_v is None else new_v, tables,
                                 positions, layer)
    return pk, pv, None, None


def write_span_stacked(pool_k, pool_v, new_k, new_v, tables, positions,
                       layer: int, pool_ks=None, pool_vs=None):
    """Write T consecutive tokens per sequence at ``positions`` (the
    speculative verify step; new_k/v [B, T, kvN, D], T <= 8), quantized
    when scale pools are given. bf16/f32 pools take kernel 11
    (:func:`paged_append_span`), e4m3 pools its form 11e; INT8 pools
    quantize with :func:`quantize_kv` and write codes and scales by
    indexed assignment, plain torch operations on every device, as the JAX
    package leaves them to XLA (paged_kv.py:363-374). Unmapped pages and
    columns past the table go to the trash page. Returns (pool_k, pool_v,
    pool_ks, pool_vs), updated in place. A shared pool (``pool_v`` None)
    raises: the span write over latent pools is not ported."""
    if pool_v is None:
        raise NotImplementedError("the span write over a shared-KV pool "
                                  "(speculative decoding under absorbed "
                                  "MLA)")
    if pool_ks is None and pool_vs is None:
        pk, pv = paged_append_span(pool_k, pool_v, new_k, new_v, tables,
                                   positions, layer)
        return pk, pv, None, None
    check_scale_pools(pool_k, pool_v, pool_ks, pool_vs)
    page, slot = span_slots(tables, positions, new_k.shape[1],
                            pool_k.shape[1], pool_k.shape[3])
    for pool, scales, x in ((pool_k, pool_ks, new_k), (pool_v, pool_vs,
                                                        new_v)):
        q, sc = quantize_kv(x)
        pool[layer][page, :, slot, :] = q
        scales[layer][page, :, slot] = sc
    return pool_k, pool_v, pool_ks, pool_vs


def gather_dense(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 tables: torch.Tensor, pool_ks: torch.Tensor | None = None,
                 pool_vs: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference path: gather pages into a dense [B, kvN, MP*ps, D] view,
    dequantizing int8 storage through the scale pools (f32 codes x
    scale, in f32); e4m3 storage comes back as its exact f32 values (JAX
    gathers the e4m3 values, which its callers cast).

    pool_k/v: one layer, [P, kvN, ps, D] (scale pools [P, kvN, ps]); a
    shared pool (``pool_v`` None) gives K as V (paged_kv.py:413).
    Unmapped (-1) pages come back as zeros, which is what the attention
    kernels read there too. (The JAX ``mode="fill"`` gather normalizes -1
    to the last row first and so reads the trash page; callers mask by
    kv_len, so only dead rows differ.)"""
    if pool_ks is not None or pool_vs is not None:
        check_scale_pools(pool_k, pool_v, pool_ks, pool_vs)
    p, kvn, ps, d = pool_k.shape
    b, mp = tables.shape
    idx = tables.reshape(-1).long()
    valid = (idx >= 0) & (idx < p)
    safe = idx.clamp(0, p - 1)

    def g(pool, scales):
        x = pool[safe]
        if x.dtype == torch.float8_e4m3fn:
            x = x.float()
        if scales is not None:
            x = x.float() * scales[safe][..., None]
        x = torch.where(valid[:, None, None, None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        return (x.reshape(b, mp, kvn, ps, d).permute(0, 2, 1, 3, 4)
                .reshape(b, kvn, mp * ps, d))

    ck = g(pool_k, pool_ks)
    if pool_v is None:
        return ck, ck
    return ck, g(pool_v, pool_vs)
