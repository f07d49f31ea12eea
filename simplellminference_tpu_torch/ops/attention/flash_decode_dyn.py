"""Dense decode attention with the key loop inside the kernel.

Counterpart of simplellminference_tpu/ops/attention/flash_decode_dyn.py:105
(``flash_decode_dyn``): one query row per sequence against slots
[0, kv_len) of the dense KV arena, a stacked [L, B', kvN, Smax, D] arena
with an int ``layer`` or a 4-D [B', kvN, Smax, D] cache, scale D**-0.5.
For CUDA tensors :func:`flash_decode_dyn` launches the hand-written kernel
of ``csrc/flash_decode_dyn.cu`` (a block per sequence and kv head, its
GQA group's query rows, the live keys streamed in 32-key tiles through a
two-stage cp.async pipeline, f32 online softmax); for CPU tensors it runs
:func:`flash_decode_dyn_ref`, which is also what the kernel is held
against on the card.

Like the JAX package, no model path calls it: the dense path decodes
with ``flash_decode`` (kernel 13). The TPU wrapper's asserts stay:
D % 128 == 0 and Smax % min(bk, Smax) == 0 (ValueError here); ``bk``
is the TPU's tile length and does not change the result. kv_len <= 0
gives a zero row, as the TPU kernel's empty loop does.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops

MAX_ROWS = 64    # query rows (the GQA group) a block holds


def _stacked(k_cache, v_cache, layer):
    """[B', kvN, Smax, D] caches become a one-layer stack (layer 0)."""
    if k_cache.ndim == 4:
        return k_cache[None], v_cache[None], 0
    if layer is None:
        raise ValueError("a stacked cache needs a layer index")
    return k_cache, v_cache, int(layer)


def _check(q, ck, bk: int):
    d, smax = q.shape[-1], ck.shape[3]
    tile = min(int(bk), smax)
    if d % 128 or tile <= 0 or smax % tile:
        raise ValueError(f"flash_decode_dyn takes D % 128 == 0 and Smax a "
                         f"multiple of bk (D {d}, Smax {smax}, bk {bk})")


def flash_decode_dyn_ref(q, k_cache, v_cache, kv_lens, bk: int = 256,
                         layer=None) -> torch.Tensor:
    """Plain version of :func:`flash_decode_dyn`: reference attention over
    arena rows [0, B), keys at slots < kv_len; zeros where kv_len <= 0.
    q [B, N, D] -> [B, N, D]."""
    if q.is_cuda:
        flash_decode_dyn_ref.cuda_calls += 1
    ck, cv, layer = _stacked(k_cache, v_cache, layer)
    _check(q, ck, bk)
    b = q.shape[0]
    ck, cv = ck[layer, :b], cv[layer, :b]                 # [B, kvN, Smax, D]
    lens = kv_lens.long().to(q.device)
    mask = (torch.arange(ck.shape[2], device=q.device)[None, None, None, :]
            < lens[:, None, None, None])
    out = ref_ops.attention(q[:, None], ck.transpose(1, 2),
                            cv.transpose(1, 2), mask)[:, 0]
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))


flash_decode_dyn_ref.cuda_calls = 0


def flash_decode_dyn(q, k_cache, v_cache, kv_lens, bk: int = 256,
                     layer=None) -> torch.Tensor:
    """q: [B, N, D]; k/v_cache: [B', kvN, Smax, D], or the stacked arena
    [L, B', kvN, Smax, D] with an int ``layer``, B <= B'; kv_lens: [B]
    -> out [B, N, D] in q's dtype, attending arena slots [0, kv_len)."""
    if not q.is_cuda:
        return flash_decode_dyn_ref(q, k_cache, v_cache, kv_lens, bk, layer)
    ck, cv, layer = _stacked(k_cache, v_cache, layer)
    _check(q, ck, bk)
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
    if d not in (128, 256):
        raise NotImplementedError(f"head_dim {d} (kernel takes 128, 256)")
    if not (q.dtype == ck.dtype == cv.dtype):
        raise NotImplementedError(f"q {q.dtype} with a {ck.dtype} arena")
    if not (ck.is_contiguous() and cv.is_contiguous()
            and ck.data_ptr() % 16 == 0 and cv.data_ptr() % 16 == 0):
        raise ValueError("caches must be contiguous and 16-byte aligned")
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
    lib = cuda_build.load()
    rc = lib.sli_flash_decode_dyn(
        q.data_ptr(), q.stride(0), ck.data_ptr(), cv.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), b, layer, arena_rows, kvn, smax,
        n // kvn, d, d ** -0.5, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "flash_decode_dyn")
    flash_decode_dyn.launches += 1
    return out


flash_decode_dyn.launches = 0
