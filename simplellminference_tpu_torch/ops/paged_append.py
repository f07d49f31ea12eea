"""In-place paged KV writes: one decode row per sequence, and whole prompt
pages at prefill.

Counterpart of simplellminference_tpu/ops/paged_append.py:54 and :129.
For CUDA tensors the wrappers launch the hand-written kernels of
``csrc/paged_append.cu``; for CPU tensors they run the plain versions
below (``*_ref``), which are also what the kernels are held against on
the card.

Pools are [L, P+1, kvN, ps, D] and are updated in place (the JAX package
aliases them through the Pallas call). An unmapped (-1) table entry, or a
column past the table, writes to the TRASH page — the pool's last page
row, which the allocator never hands out — as the TPU kernels and the
JAX scatter (where -1 wraps to the last row) both do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simplellminference_tpu_torch.ops import cuda_build


def _pages(tables: torch.Tensor, cols: torch.Tensor,
           num_pages1: int) -> torch.Tensor:
    """Page id of table column ``cols`` per row; unmapped -> trash page.
    tables [B, MP]; cols [B] or [B, C] (int64)."""
    mp = tables.shape[1]
    two_d = cols.ndim == 2
    c2 = cols if two_d else cols[:, None]
    ok = (c2 >= 0) & (c2 < mp)
    page = tables.long().gather(1, c2.clamp(0, mp - 1))
    page = torch.where(ok & (page >= 0), page, num_pages1 - 1)
    return page if two_d else page[:, 0]


def paged_append_decode_ref(pool_k, pool_v, new_k, new_v, tables, positions,
                            layer: int):
    """Plain version of :func:`paged_append_decode` (in place)."""
    if pool_k.is_cuda:
        paged_append_decode_ref.cuda_calls += 1
    p1, ps = pool_k.shape[1], pool_k.shape[3]
    pos = positions.long()
    page = _pages(tables, torch.where(pos >= 0, pos // ps, -1), p1)
    slot = torch.where(pos >= 0, pos % ps, 0)
    pool_k[layer][page, :, slot, :] = new_k.to(pool_k.dtype)
    pool_v[layer][page, :, slot, :] = new_v.to(pool_v.dtype)
    return pool_k, pool_v


paged_append_decode_ref.cuda_calls = 0


def paged_append_prefill_ref(pool_k, pool_v, new_k, new_v, tables,
                             layer: int):
    """Plain version of :func:`paged_append_prefill` (in place)."""
    if pool_k.is_cuda:
        paged_append_prefill_ref.cuda_calls += 1
    _, p1, kvn, ps, d = pool_k.shape
    b, s = new_k.shape[:2]
    npg = -(-s // ps)
    pad = npg * ps - s

    def chunks(x, dtype):
        x = F.pad(x.to(dtype), (0, 0, 0, 0, 0, pad)) if pad else x.to(dtype)
        return (x.reshape(b, npg, ps, kvn, d).permute(0, 1, 3, 2, 4)
                .reshape(b * npg, kvn, ps, d))

    cols = torch.arange(npg, device=tables.device)[None].expand(b, npg)
    idx = _pages(tables, cols, p1).reshape(-1)
    pool_k[layer].index_copy_(0, idx, chunks(new_k, pool_k.dtype))
    pool_v[layer].index_copy_(0, idx, chunks(new_v, pool_v.dtype))
    return pool_k, pool_v


paged_append_prefill_ref.cuda_calls = 0


def _check_pools(pool_k, pool_v, new_k, layer):
    if pool_v is None:
        raise NotImplementedError("shared-KV pools (absorbed MLA)")
    if (pool_k.shape != pool_v.shape or pool_k.dtype != pool_v.dtype
            or pool_k.ndim != 5):
        raise ValueError("pools must be matching [L, P+1, kvN, ps, D]")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if pool_k.device != new_k.device:
        raise ValueError("pools and new rows must share a device")
    if not 0 <= layer < pool_k.shape[0]:
        raise IndexError(f"layer {layer} out of range")
    cuda_build.dtype_code(pool_k.dtype)


def _rows(x, kvn, d, dtype):
    """New K/V rows cast to the pool dtype, with [kvN, D] contiguous."""
    x = x.to(dtype)
    if x.shape[-2:] != (kvn, d):
        raise ValueError(f"new rows {tuple(x.shape)} do not match "
                         f"kvN={kvn}, D={d}")
    if x.stride(-1) != 1 or x.stride(-2) != d:
        x = x.contiguous()
    return x


def _vec16(row_bytes, *tensors_and_strides) -> int:
    ok = row_bytes % 16 == 0
    for t in tensors_and_strides:
        if isinstance(t, torch.Tensor):
            ok = ok and t.data_ptr() % 16 == 0
        else:
            ok = ok and t % 16 == 0
    return int(ok)


def _index(x: torch.Tensor, b: int, name: str) -> torch.Tensor:
    x = x.to(torch.int32).contiguous()
    if x.shape[0] != b:
        raise ValueError(f"{name} has {x.shape[0]} rows, expected {b}")
    return x


def paged_append_decode(pool_k, pool_v, new_k, new_v, tables, positions,
                        layer: int):
    """Write one token per sequence into the stacked pools in place.

    pool_k/v: [L, P+1, kvN, ps, D] (last page = trash); new_k/v:
    [B, kvN, D]; tables: [B, MP] (-1 = unmapped); positions: [B];
    ``layer``: int. Returns (pool_k, pool_v)."""
    if not pool_k.is_cuda:
        return paged_append_decode_ref(pool_k, pool_v, new_k, new_v, tables,
                                       positions, layer)
    _check_pools(pool_k, pool_v, new_k, layer)
    n_layers, p1, kvn, ps, d = pool_k.shape
    b = new_k.shape[0]
    if b == 0:
        return pool_k, pool_v
    nk = _rows(new_k, kvn, d, pool_k.dtype)
    nv = _rows(new_v, kvn, d, pool_v.dtype)
    tables = _index(tables, b, "tables")
    positions = _index(positions, b, "positions")
    es = pool_k.element_size()
    row_bytes = d * es
    kbs, vbs = nk.stride(0) * es, nv.stride(0) * es
    lib = cuda_build.load()
    rc = lib.sli_paged_append_decode(
        pool_k.data_ptr(), pool_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        kbs, vbs, tables.data_ptr(), positions.data_ptr(), layer, p1, kvn,
        ps, row_bytes, tables.shape[1], b,
        _vec16(row_bytes, pool_k, pool_v, nk, nv, kbs, vbs),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_append_decode")
    paged_append_decode.launches += 1
    return pool_k, pool_v


paged_append_decode.launches = 0


def paged_append_prefill(pool_k, pool_v, new_k, new_v, tables, layer: int):
    """Write a right-padded prompt into pages in place.

    new_k/v: [B, S, kvN, D]; ``tables[:, :ceil(S/ps)]`` names the target
    pages; -1 entries land in the trash page; rows past S in the last
    page are written as zeros. Returns (pool_k, pool_v)."""
    if not pool_k.is_cuda:
        return paged_append_prefill_ref(pool_k, pool_v, new_k, new_v, tables,
                                        layer)
    _check_pools(pool_k, pool_v, new_k, layer)
    n_layers, p1, kvn, ps, d = pool_k.shape
    b, s = new_k.shape[:2]
    if b == 0 or s == 0:
        return pool_k, pool_v
    nk = _rows(new_k, kvn, d, pool_k.dtype)
    nv = _rows(new_v, kvn, d, pool_v.dtype)
    tables = _index(tables, b, "tables")
    es = pool_k.element_size()
    row_bytes = d * es
    st = [nk.stride(0) * es, nk.stride(1) * es, nv.stride(0) * es,
          nv.stride(1) * es]
    lib = cuda_build.load()
    rc = lib.sli_paged_append_prefill(
        pool_k.data_ptr(), pool_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        *st, tables.data_ptr(), layer, p1, kvn, ps, row_bytes,
        tables.shape[1], b, s,
        _vec16(row_bytes, pool_k, pool_v, nk, nv, *st),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_append_prefill")
    paged_append_prefill.launches += 1
    return pool_k, pool_v


paged_append_prefill.launches = 0
