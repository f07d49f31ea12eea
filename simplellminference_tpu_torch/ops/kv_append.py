"""In-place KV append into the stacked dense arena.

Counterpart of simplellminference_tpu/ops/kv_append.py:63 (``kv_append``)
and :119 (``kv_append_ref``). For CUDA tensors :func:`kv_append` launches
the hand-written row-copy kernel of ``csrc/paged_append.cu``
(``sli_kv_append``: one block per (sequence, row, kv head) stores only
the row it owns); for CPU tensors it runs :func:`kv_append_ref`, which is
also what the kernel is held against on the card.

Differences by design from the JAX package:
- any offset works for S > 1 (the TPU kernel's 8-row read-modify-write
  windows, kv_append.py:10-18, are what asked for multiples of 8);
- a row whose slot falls outside [0, Smax) is dropped. JAX's
  ``kv_append_ref`` (``dynamic_update_slice``) clamps the start instead,
  which shifts the whole block; no caller reaches that case (the
  Generator raises first, the draft arena keeps G + 2 spare slots).

The arena [L, B', kvN, Smax, D] is written in place (the JAX package
aliases it through the Pallas call); row b of the new K/V goes to arena
row b, so B <= B'.

FP8 (float8_e4m3fn) arenas, form 12e (the TPU kernel casts the new rows
to the arena dtype, kv_append.py:49-58, :78-79; its plain version
:130-137): the rows are converted from their own dtype (bf16 or f32) with
the JAX package's rounding (:func:`~simplellminference_tpu_torch.ops.
ref_ops.to_e4m3`: nearest even, NaN past 464, whatever PyTorch's own cast
does), in the kernel on the card (``sli_kv_append_e4m3``, the conversion
of the paged e4m3 writes with this module's dense addressing) and by
``to_e4m3`` in the plain version, which writes through ``uint8`` views.
On the card :func:`kv_append` hands e4m3 arenas to
:func:`kv_append_fp8kv`, with its own launch count (and its launches at
head_dim 256 in :data:`D256_LAUNCHES`).
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build
from simplellminference_tpu_torch.ops.paged_append import (_as_pool, _index,
                                                           _qrows, _rows,
                                                           _stored, _vec16)
from simplellminference_tpu_torch.ops.ref_ops import E4M3

# the e4m3 form's launches at head_dim 256 (each also in its ``launches``)
D256_LAUNCHES = {"kv_append_fp8kv": 0}


def _check(cache_k, cache_v, new_k, new_v, layer):
    if (cache_k.shape != cache_v.shape or cache_k.dtype != cache_v.dtype
            or cache_k.ndim != 5):
        raise ValueError("caches must be matching [L, B, kvN, Smax, D]")
    if new_k.ndim != 4 or new_k.shape != new_v.shape:
        raise ValueError("new rows must be matching [B, S, kvN, D]")
    if new_k.shape[0] > cache_k.shape[1]:
        raise ValueError(f"{new_k.shape[0]} sequences for an arena of "
                         f"{cache_k.shape[1]} rows")
    if not 0 <= layer < cache_k.shape[0]:
        raise IndexError(f"layer {layer} out of range")


def _check_card(cache_k, cache_v, new_k, new_v, layer):
    """What the kernels need beyond :func:`_check`."""
    _check(cache_k, cache_v, new_k, new_v, layer)
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("caches must be contiguous")
    if new_k.device != cache_k.device:
        raise ValueError("caches and new rows must share a device")


def kv_append_ref(cache_k, cache_v, new_k, new_v, layer: int, offsets):
    """Plain version of :func:`kv_append` (in place): rows at slots
    outside [0, Smax) are dropped (they go to a scratch row past the
    layer's rows, so nothing here waits for the device)."""
    if cache_k.is_cuda:
        kv_append_ref.cuda_calls += 1
    _check(cache_k, cache_v, new_k, new_v, layer)
    b, s, kvn, d = new_k.shape
    smax = cache_k.shape[3]
    n_rows = cache_k.shape[1] * kvn * smax
    dev = cache_k.device
    slots = (offsets.long().to(dev)[:, None]
             + torch.arange(s, device=dev)[None])[:, :, None]   # [B, S, 1]
    flat = ((torch.arange(b, device=dev)[:, None, None] * kvn
             + torch.arange(kvn, device=dev)[None, None, :]) * smax + slots)
    flat = torch.where((slots >= 0) & (slots < smax), flat, n_rows)
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        store = _stored(cache)      # e4m3 arenas: their codes, as uint8
        rows = torch.cat([store[layer].reshape(n_rows, d),
                          store.new_zeros((1, d))])
        rows[flat.reshape(-1)] = _as_pool(new, cache).reshape(-1, d)
        store[layer].copy_(rows[:n_rows].view(store.shape[1:]))
    return cache_k, cache_v


kv_append_ref.cuda_calls = 0


def kv_append(cache_k, cache_v, new_k, new_v, layer: int, offsets):
    """Write S new K/V rows per sequence into the stacked arena in place.

    cache_k/v: [L, B', kvN, Smax, D] (bf16/f32, or float8_e4m3fn: 12e,
    :func:`kv_append_fp8kv`); new_k/v: [B, S, kvN, D] with B <= B';
    ``layer``: int; offsets: [B] the first target slot of each sequence
    (any value; rows outside [0, Smax) are dropped).
    Returns (cache_k, cache_v)."""
    if cache_k.dtype == E4M3:
        return kv_append_fp8kv(cache_k, cache_v, new_k, new_v, layer,
                               offsets)
    if not cache_k.is_cuda:
        return kv_append_ref(cache_k, cache_v, new_k, new_v, layer, offsets)
    _check_card(cache_k, cache_v, new_k, new_v, layer)
    cuda_build.dtype_code(cache_k.dtype)
    _, arena_rows, kvn, smax, d = cache_k.shape
    b, s = new_k.shape[:2]
    if b == 0 or s == 0:
        return cache_k, cache_v
    nk = _rows(new_k, kvn, d, cache_k.dtype)
    nv = _rows(new_v, kvn, d, cache_v.dtype)
    offsets = _index(offsets.to(cache_k.device), b, "offsets")
    es = cache_k.element_size()
    row_bytes = d * es
    st = [nk.stride(0) * es, nk.stride(1) * es, nv.stride(0) * es,
          nv.stride(1) * es]
    lib = cuda_build.load()
    rc = lib.sli_kv_append(
        cache_k.data_ptr(), cache_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        *st, offsets.data_ptr(), layer, arena_rows, kvn, smax, row_bytes, b,
        s, _vec16(row_bytes, cache_k, cache_v, nk, nv, *st),
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    cuda_build.check(lib, rc, "kv_append")
    kv_append.launches += 1
    return cache_k, cache_v


kv_append.launches = 0


def kv_append_fp8kv(cache_k, cache_v, new_k, new_v, layer: int, offsets):
    """12e: :func:`kv_append` into float8_e4m3fn arenas, each element
    converted from new_k/v's dtype (bf16 or f32) with the JAX package's
    rounding in the kernel. Returns (cache_k, cache_v)."""
    if not cache_k.is_cuda:
        return kv_append_ref(cache_k, cache_v, new_k, new_v, layer, offsets)
    _check_card(cache_k, cache_v, new_k, new_v, layer)
    if cache_k.dtype != E4M3:
        raise ValueError(f"the FP8-KV form takes float8_e4m3fn arenas, not "
                         f"{cache_k.dtype}")
    _, arena_rows, kvn, smax, d = cache_k.shape
    b, s = new_k.shape[:2]
    if b == 0 or s == 0:
        return cache_k, cache_v
    nk, nv = _qrows(new_k, new_v, kvn, d)
    offsets = _index(offsets.to(cache_k.device), b, "offsets")
    es = nk.element_size()
    st = [nk.stride(0), nk.stride(1), nv.stride(0), nv.stride(1)]
    vec8 = int(d % 8 == 0 and _vec16(d * es, nk, nv,
                                     *[x * es for x in st]) == 1)
    lib = cuda_build.load()
    rc = lib.sli_kv_append_e4m3(
        cache_k.data_ptr(), cache_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        *st, offsets.data_ptr(), layer, arena_rows, kvn, smax, d, b, s,
        cuda_build.dtype_code(nk.dtype), vec8,
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    cuda_build.check(lib, rc, "kv_append_fp8kv")
    kv_append_fp8kv.launches += 1
    D256_LAUNCHES["kv_append_fp8kv"] += int(d == 256)
    return cache_k, cache_v


kv_append_fp8kv.launches = 0
