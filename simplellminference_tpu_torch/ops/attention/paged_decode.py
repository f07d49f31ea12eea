"""Paged flash-decode attention: one query per sequence through the block
tables.

Counterpart of simplellminference_tpu/ops/attention/paged_decode.py:165
(``paged_flash_decode`` with one query row per sequence; the speculative
``paged_flash_verify`` is not ported yet). For CUDA tensors
:func:`paged_flash_decode` launches the hand-written kernel of
``csrc/paged_decode.cu`` (one block per sequence and kv head, page ids
read from the table in the block, f32 online softmax over the live keys
only); for CPU tensors it runs :func:`paged_flash_decode_ref`, the
gather + dense reference path of the JAX dispatcher.

Unmapped (-1) pages inside kv_len read as zeros in both versions. The
JAX package reads something else there — its TPU kernel clamps them to
page 0, its reference gather reads the trash page (``mode="fill"``
normalizes -1 to the last row first) — but only dead burst rows, whose
outputs are discarded, hit that case.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.memory.paged_kv import gather_dense
from simplellminference_tpu_torch.ops import cuda_build, ref_ops

HEAD_DIMS = (32, 64, 128)


def paged_flash_decode_ref(q, k_pool, v_pool, tables, kv_lens, layer: int,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Plain version: gather the pages densely, mask key_pos < kv_len,
    reference attention; a row with kv_len <= 0 is zero, as in the kernel.
    q: [B, N, D] -> [B, N, D]."""
    if q.is_cuda:
        paged_flash_decode_ref.cuda_calls += 1
    ck, cv = gather_dense(k_pool[layer], v_pool[layer], tables)
    smax = ck.shape[2]
    lens = kv_lens.long()
    key_pos = torch.arange(smax, device=q.device)
    mask = key_pos[None, None, None, :] < lens[:, None, None, None]
    out = ref_ops.attention(q[:, None], ck.transpose(1, 2),
                            cv.transpose(1, 2), mask, scale=sm_scale)[:, 0]
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))


paged_flash_decode_ref.cuda_calls = 0


def paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer: int,
                       sm_scale: float | None = None) -> torch.Tensor:
    """q: [B, N, D]; k/v_pool: stacked [L, P+1, kvN, ps, D] with an int
    ``layer``; tables: [B, MP] int32 (-1 = unmapped); kv_lens: [B] ->
    out [B, N, D] in q's dtype. Keys are positions < min(kv_len, MP*ps)."""
    if not q.is_cuda:
        return paged_flash_decode_ref(q, k_pool, v_pool, tables, kv_lens,
                                      layer, sm_scale)
    b, n, d = q.shape
    if v_pool is None:
        raise NotImplementedError("shared-KV pools (absorbed MLA)")
    n_layers, p1, kvn, ps, pd = k_pool.shape
    if pd != d or v_pool.shape != k_pool.shape:
        raise ValueError("pools must be matching [L, P+1, kvN, ps, D]")
    if n % kvn:
        raise ValueError(f"{n} heads do not group over {kvn} kv heads")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} (kernel takes {HEAD_DIMS})")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise NotImplementedError(
            f"q {q.dtype} with {k_pool.dtype} pools (quantized KV)")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(q.dtype)
    out = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    if q.stride(-1) != 1 or q.stride(-2) != d:
        q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    if tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError("tables/kv_lens rows do not match q")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    lib = cuda_build.load()
    rc = lib.sli_paged_flash_decode(
        q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), b, layer, p1,
        kvn, ps, tables.shape[1], n // kvn, d, scale, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
