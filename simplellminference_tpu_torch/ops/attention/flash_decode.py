"""Flash decode attention over the dense KV arena: one query row per
sequence against arena slots [0, kv_len), or with a sliding window only
the last ``window`` of them.

Counterpart of simplellminference_tpu/ops/attention/flash_decode.py:114
(``flash_decode``). For CUDA tensors :func:`flash_decode` launches the
dense form of the hand-written kernel of ``csrc/paged_decode.cu``
(``sli_flash_decode``): a dense arena [L, B', kvN, Smax, D] is a page pool
with one page of Smax slots per sequence, so kernel 4's body serves it:
the live keys below min(kv_len, Smax) split over blocks
(:func:`~simplellminference_tpu_torch.ops.attention.paged_decode.
decode_splits` on the span the walk can meet: Smax, or the window), each
block holding the GQA group's query rows with an f32 online softmax, the
splits merged by log-sum-exp. For CPU tensors it runs
:func:`flash_decode_ref`, which is also what the kernel is held against on
the card.

The sliding-window form (``window``: keys kv_len - window <= k < kv_len;
flash_decode.py:67-70, :83-86) walks from the band's first key and reads
none below it, as the TPU kernel's index map clamps the blocks before it
(flash_decode.py:172-181); on the card it is its own wrapper,
:func:`flash_decode_window` (13w), with its own launch count. Gemma-2's
soft cap (``logit_cap``: each score becomes cap * tanh(s * scale *
(1 / cap)) before the mask, flash_decode.py:80-81) is a compile-time flag
of the kernel (13c, 13wc); capped launches count in their form's
``launches`` and in :data:`~.flash_prefill.CAP_LAUNCHES` by (form, head
dim). GPT-OSS's attention sinks (``sinks`` [N], a learned logit per q head
in each row's softmax denominator, flash_decode.py:43-62, :191-194) are
the kernel's pointer argument, as on the paged forms: split 0 seeds each
row with (sink, 1) (13s, 13ws; bf16/f32 arenas at D 32-128); launches
with sinks count in their form's ``launches`` and in
:data:`~.flash_prefill.SINK_LAUNCHES` by (form, head dim).

FP8 (float8_e4m3fn) arenas under bf16 or f32 q (forms 13e, 13ew and,
with the cap and sinks, 13ec, 13ewc, 13es, 13ews; the TPU kernel casts
each e4m3 element straight to f32, flash_decode.py:74-75, :95): the
kernel converts each staged code exactly in registers, the plain version
reads the exact f32 values. Each is a form of its own,
:func:`flash_decode_fp8kv` and :func:`flash_decode_fp8kv_window`, with its
own launch count; a call of :func:`flash_decode` over an e4m3 arena
counts as the form its options and arena name (as
:mod:`~simplellminference_tpu_torch.ops.attention.paged_decode`'s forms
do), and in :data:`D256_LAUNCHES`, ``CAP_LAUNCHES`` and ``SINK_LAUNCHES``
as the bf16 forms are. Slots past kv_len, or below a window's band, are
never read by the kernel, so a stale slot (an e4m3 code 0x7f is NaN)
reaches no sum; the plain version zeroes them before its products.

A row with kv_len <= 0 comes out as zeros, as from the JAX kernel (its
running sum stays 0). ``bk``, ``rows_target`` and ``max_kv`` are the TPU
kernel's tiling hints and bounds on its grid; the kernel stops at kv_len
by itself, so they are taken and ignored.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.attention.flash_prefill import (
    cap_value, check_sinks_head_dim, count_launch, sink_values, window_size)
from simplellminference_tpu_torch.ops.attention.paged_decode import (
    HEAD_DIMS, MAX_ROWS, decode_splits, row_blocks, workspace)

E4M3 = torch.float8_e4m3fn


def _stacked(k_cache, v_cache, layer):
    """[B, kvN, Smax, D] caches become a one-layer stack (layer 0)."""
    if k_cache.ndim == 4:
        return k_cache[None], v_cache[None], 0
    if layer is None:
        raise ValueError("a stacked cache needs a layer index")
    return k_cache, v_cache, int(layer)


def flash_decode_ref(q, k_cache, v_cache, kv_lens, layer=None,
                     sm_scale: float | None = None,
                     window: int | None = None,
                     logit_cap: float | None = None,
                     sinks=None) -> torch.Tensor:
    """Plain version of :func:`flash_decode` and its window, capped, sink
    and FP8-KV forms (an e4m3 arena read as its exact f32 values):
    reference attention over the arena rows of the batch,
    keys at slots < kv_len (and >= kv_len - ``window``), the scores
    soft-capped by ``logit_cap`` before the mask, each head's ``sinks``
    logit in the softmax; zeros for a row with no such slot (kv_len <= 0,
    or a window wholly past Smax).
    q [B, N, D] -> [B, N, D]."""
    if q.is_cuda:
        flash_decode_ref.cuda_calls += 1
    ck, cv, layer = _stacked(k_cache, v_cache, layer)
    b = q.shape[0]
    ck, cv = ck[layer, :b], cv[layer, :b]                  # [B, kvN, Smax, D]
    lens = kv_lens.long().to(q.device)[:, None, None, None]
    key_pos = torch.arange(ck.shape[2], device=q.device)[None, None, None, :]
    mask = key_pos < lens
    if window is not None:
        mask = mask & (key_pos >= lens - window_size(window))
    if ck.dtype == E4M3:
        # the exact values of the codes; slots outside the mask (a stale
        # code may be NaN) zeroed, as the kernel never reads them
        live_kv = mask[:, 0, 0][:, None, :, None]          # [B, 1, Smax, 1]
        ck, cv = (torch.where(live_kv, c.float(), 0.0) for c in (ck, cv))
    out = ref_ops.attention(q[:, None], ck.transpose(1, 2),
                            cv.transpose(1, 2), mask, scale=sm_scale,
                            logit_cap=cap_value(logit_cap),
                            sinks=sinks)[:, 0]
    live = mask.any(-1)                                    # [B, 1, 1]
    return torch.where(live, out, torch.zeros_like(out))


flash_decode_ref.cuda_calls = 0


def flash_decode(q, k_cache, v_cache, kv_lens, bk: int | None = None,
                 layer=None, rows_target: int = 16, max_kv: int | None = None,
                 window: int | None = None, sm_scale: float | None = None,
                 logit_cap: float | None = None, sinks=None) -> torch.Tensor:
    """q: [B, N, D]; k/v_cache: [B', kvN, Smax, D], or the stacked arena
    [L, B', kvN, Smax, D] with an int ``layer``, B <= B', of q's dtype or
    float8_e4m3fn (FP8 KV); kv_lens: [B] -> out [B, N, D] in q's dtype,
    attending arena slots [0, kv_len). ``window`` takes
    :func:`flash_decode_window`; ``logit_cap`` > 0 is Gemma-2's soft cap
    (13c); ``sinks`` [N] f32 add each head's sink logit to its softmax
    (13s). The launch counts as the form the options and the arena name
    (13, 13w, 13e, 13ew; a capped or sink form in the count of the form it
    caps or seeds)."""
    del bk, rows_target, max_kv   # TPU tiling hints
    return _run("flash_decode", q, k_cache, v_cache, kv_lens, layer,
                sm_scale, window, logit_cap, sinks)


def flash_decode_window(q, k_cache, v_cache, kv_lens, window: int,
                        layer=None, sm_scale: float | None = None,
                        logit_cap: float | None = None,
                        sinks=None) -> torch.Tensor:
    """13w: :func:`flash_decode` over arena slots kv_len - window ..
    kv_len - 1 only; no slot below them is read (13wc with a
    ``logit_cap``, 13ws with ``sinks``; over an e4m3 arena 13ew and its
    forms)."""
    return _run("flash_decode", q, k_cache, v_cache, kv_lens, layer,
                sm_scale, window_size(window), logit_cap, sinks)


def flash_decode_fp8kv(q, k_cache, v_cache, kv_lens, layer=None,
                       sm_scale: float | None = None,
                       logit_cap: float | None = None,
                       sinks=None) -> torch.Tensor:
    """13e: :func:`flash_decode` of q [B, N, D] bf16 or f32 against a
    float8_e4m3fn arena (no scales); out in q's dtype (13ec with a
    ``logit_cap``, 13es with ``sinks``)."""
    _check_e4m3(k_cache, v_cache)
    return _run("flash_decode", q, k_cache, v_cache, kv_lens, layer,
                sm_scale, None, logit_cap, sinks)


def flash_decode_fp8kv_window(q, k_cache, v_cache, kv_lens, window: int,
                              layer=None, sm_scale: float | None = None,
                              logit_cap: float | None = None,
                              sinks=None) -> torch.Tensor:
    """13ew: :func:`flash_decode_fp8kv` over arena slots kv_len - window ..
    kv_len - 1 only (13ewc with a ``logit_cap``, 13ews with ``sinks``)."""
    _check_e4m3(k_cache, v_cache)
    return _run("flash_decode", q, k_cache, v_cache, kv_lens, layer,
                sm_scale, window_size(window), logit_cap, sinks)


def _check_e4m3(k_cache, v_cache):
    if k_cache.dtype != E4M3 or v_cache.dtype != E4M3:
        raise ValueError("the FP8-KV forms take float8_e4m3fn arenas")


# name -> the form whose launch count a call adds to
_FORMS = {f.__name__: f for f in (flash_decode, flash_decode_window,
                                  flash_decode_fp8kv,
                                  flash_decode_fp8kv_window)}
for _f in _FORMS.values():
    _f.launches = 0
# each form's launches at head_dim 256 (Gemma; each also counts in its
# form's ``launches``)
D256_LAUNCHES = {name: 0 for name in _FORMS}


def _run(name, q, k_cache, v_cache, kv_lens, layer, sm_scale, window,
         logit_cap, sinks):
    """Every form's body: the plain version for CPU tensors; for CUDA
    tensors the kernel, one launch added to the count of the form the
    options name (``name``, ``_fp8kv`` over an e4m3 arena, ``_window``
    with a window)."""
    cap = cap_value(logit_cap)
    check_sinks_head_dim(sinks, q.shape[-1])
    if window is not None:
        window = window_size(window)
    form = _FORMS[name + "_fp8kv" * (k_cache.dtype == E4M3)
                  + "_window" * (window is not None)]
    if not q.is_cuda:
        return flash_decode_ref(q, k_cache, v_cache, kv_lens, layer,
                                sm_scale, window, cap, sinks)
    out = _launch(q, k_cache, v_cache, kv_lens, layer, sm_scale,
                  window or 0, cap, form.__name__, sinks)
    form.launches += 1
    count_launch(form.__name__, q.shape[-1], cap, D256_LAUNCHES, sinks)
    return out


def _launch(q, k_cache, v_cache, kv_lens, layer, sm_scale, window: int,
            cap, what: str, sinks=None) -> torch.Tensor:
    """The kernel on q [B, N, D] -> [B, N, D]."""
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
    if ck.dtype != cv.dtype or not (
            q.dtype == ck.dtype or (ck.dtype == E4M3 and q.dtype in (
                torch.bfloat16, torch.float32))):
        raise NotImplementedError(f"q {q.dtype} with a {ck.dtype} arena "
                                  f"(quantized KV)")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("caches must be contiguous")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(q.dtype)
    sinks = sink_values(sinks, n, q.device)
    out = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    if q.stride(-1) != 1 or q.stride(-2) != d:
        q = q.contiguous()
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_lens.shape != (b,):
        raise ValueError("kv_lens rows do not match q")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    span = min(smax, window) if window else smax
    splits = decode_splits(b, kvn, span, row_blocks(n // kvn))
    part = workspace(b, n, d, splits, q.device)
    lib = cuda_build.load()
    rc = lib.sli_flash_decode(
        q.data_ptr(), q.stride(0), ck.data_ptr(), cv.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), b, layer, arena_rows, kvn,
        smax, n // kvn, d, window, splits, scale, cap or 0.0, code,
        cuda_build.pool_code(ck.dtype),
        0 if sinks is None else sinks.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, what)
    return out
