"""Flash decode attention over the dense KV arena: one query row per
sequence against arena slots [0, kv_len).

Counterpart of simplellminference_tpu/ops/attention/flash_decode.py:114
(``flash_decode``). For CUDA tensors :func:`flash_decode` launches the
dense form of the hand-written kernel of ``csrc/paged_decode.cu``
(``sli_flash_decode``): a dense arena [L, B', kvN, Smax, D] is a page pool
with one page of Smax slots per sequence, so kernel 4's body serves it:
the live keys below min(kv_len, Smax) split over blocks
(:func:`~simplellminference_tpu_torch.ops.attention.paged_decode.
decode_splits` on the span Smax), each block holding the GQA group's query
rows with an f32 online softmax, the splits merged by log-sum-exp. For
CPU tensors it runs :func:`flash_decode_ref`, which is also what the
kernel is held against on the card.

A row with kv_len <= 0 comes out as zeros, as from the JAX kernel (its
running sum stays 0). ``bk``, ``rows_target`` and ``max_kv`` are the TPU
kernel's tiling hints and bounds on its grid; the kernel stops at kv_len
by itself, so they are taken and ignored. Sliding windows, the logit
soft cap and attention sinks are not ported and raise.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.attention.paged_decode import (
    HEAD_DIMS, MAX_ROWS, decode_splits, row_blocks, workspace)

# launches at head_dim 256 (Gemma; each also counts in ``launches``)
D256_LAUNCHES = {"flash_decode": 0}


def _stacked(k_cache, v_cache, layer):
    """[B, kvN, Smax, D] caches become a one-layer stack (layer 0)."""
    if k_cache.ndim == 4:
        return k_cache[None], v_cache[None], 0
    if layer is None:
        raise ValueError("a stacked cache needs a layer index")
    return k_cache, v_cache, int(layer)


def _check_opts(window, logit_cap, sinks):
    if window is not None:
        raise NotImplementedError("sliding-window attention")
    if logit_cap:
        raise NotImplementedError("attention logit soft cap")
    if sinks is not None:
        raise NotImplementedError("attention sinks")


def flash_decode_ref(q, k_cache, v_cache, kv_lens, layer=None,
                     sm_scale: float | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode`: reference attention over the
    arena rows of the batch, keys at slots < kv_len; zeros where
    kv_len <= 0. q [B, N, D] -> [B, N, D]."""
    if q.is_cuda:
        flash_decode_ref.cuda_calls += 1
    ck, cv, layer = _stacked(k_cache, v_cache, layer)
    b = q.shape[0]
    ck, cv = ck[layer, :b], cv[layer, :b]                  # [B, kvN, Smax, D]
    lens = kv_lens.long().to(q.device)
    mask = (torch.arange(ck.shape[2], device=q.device)[None, None, None, :]
            < lens[:, None, None, None])
    out = ref_ops.attention(q[:, None], ck.transpose(1, 2),
                            cv.transpose(1, 2), mask, scale=sm_scale)[:, 0]
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))


flash_decode_ref.cuda_calls = 0


def flash_decode(q, k_cache, v_cache, kv_lens, bk: int | None = None,
                 layer=None, rows_target: int = 16, max_kv: int | None = None,
                 window: int | None = None, sm_scale: float | None = None,
                 logit_cap: float | None = None, sinks=None) -> torch.Tensor:
    """q: [B, N, D]; k/v_cache: [B', kvN, Smax, D], or the stacked arena
    [L, B', kvN, Smax, D] with an int ``layer``, B <= B'; kv_lens: [B]
    -> out [B, N, D] in q's dtype, attending arena slots [0, kv_len)."""
    del bk, rows_target, max_kv   # TPU tiling hints
    _check_opts(window, logit_cap, sinks)
    if not q.is_cuda:
        return flash_decode_ref(q, k_cache, v_cache, kv_lens, layer,
                                sm_scale)
    ck, cv, layer = _stacked(k_cache, v_cache, layer)
    b, n, d = q.shape
    n_layers, arena_rows, kvn, smax, cd = ck.shape
    if cd != d or cv.shape != ck.shape:
        raise ValueError("caches must be matching [L, B, kvN, Smax, D]")
    if b > arena_rows:
        raise ValueError(f"{b} sequences for an arena of {arena_rows} rows")
    if n % kvn:
        raise ValueError(f"{n} heads do not group over {kvn} kv heads")
    if n // kvn > MAX_ROWS:
        raise NotImplementedError(f"{n // kvn} heads per kv head (the "
                                  f"kernel holds at most {MAX_ROWS})")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} (kernel takes {HEAD_DIMS})")
    if not (q.dtype == ck.dtype == cv.dtype):
        raise NotImplementedError(f"q {q.dtype} with a {ck.dtype} arena")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("caches must be contiguous")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(q.dtype)
    out = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    if q.stride(-1) != 1 or q.stride(-2) != d:
        q = q.contiguous()
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_lens.shape != (b,):
        raise ValueError("kv_lens rows do not match q")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    splits = decode_splits(b, kvn, smax, row_blocks(n // kvn))
    part = workspace(b, n, d, splits, q.device)
    lib = cuda_build.load()
    rc = lib.sli_flash_decode(
        q.data_ptr(), q.stride(0), ck.data_ptr(), cv.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), b, layer, arena_rows, kvn,
        smax, n // kvn, d, splits, scale, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "flash_decode")
    flash_decode.launches += 1
    if d == 256:
        D256_LAUNCHES["flash_decode"] += 1
    return out


flash_decode.launches = 0
