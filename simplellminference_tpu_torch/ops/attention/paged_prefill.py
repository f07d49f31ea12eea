"""Paged flash prefill attention: a chunk of queries per sequence against
the KV already in its pages, found through the block tables.

Counterpart of simplellminference_tpu/ops/attention/paged_prefill.py:156.
Row b's queries sit at absolute positions ``chunk_offset[b] + 0..Sq-1``
(a prefill chunk, or a prefix-cached suffix, already written to its
pages); each attends to every cached position < kv_lens[b] up to its
causal frontier. For CUDA tensors :func:`paged_flash_prefill` launches the
hand-written kernel of ``csrc/paged_prefill.cu``: with bf16 q on the
tensor cores (each 64-row tile packs the positions x q heads of one kv
head, :mod:`.prefill_tiles`; K/V tiles of 64 keys through a cp.async
ring, each key's page looked up in the table; f32 online softmax, P split
into two bf16 parts for the PV product; the key walk split over blocks
when the tiles alone leave the card idle), with f32 q on FMAs; for CPU
tensors it runs :func:`paged_flash_prefill_ref`, the gather + masked
dense reference of the JAX dispatcher (dispatch.py:172-194).

INT8 KV (int8 pools with ``k_scale``/``v_scale`` [L, P+1, kvN, ps] f32):
the kernel dequantizes each staged K/V row in f32 and rounds it to
q's dtype, as the TPU kernel dequantizes its page slabs
(paged_prefill.py:105-110); the INT8-KV form has a wrapper of its name,
:func:`paged_flash_prefill_int8kv`, and its own launch count, and a call
counts as the form its options name. The plain
version does the same to the gathered pages (dequantize in f32, round to
q's dtype): in f32 that is the JAX CPU path (dispatch.py:182-194); with
bf16 q the JAX CPU path keeps f32 K/V, and the rounding moved the
outputs by up to 0.25 at the card tests' shapes (NVIDIA H100 80GB HBM3,
700.00 W), so the plain version repeats the kernel's rounding instead.

FP8 KV (float8_e4m3fn pools, no scales; the TPU kernel casts its page
slabs to q's dtype, paged_prefill.py:108-110): form 8e,
:func:`paged_flash_prefill_fp8kv`, with its own launch count. With bf16 q
the tensor-core kernel converts each staged e4m3 row exactly to bf16 where
INT8 KV dequantizes; with f32 q the FMA kernel reads each code exactly as
f32; the plain version gathers the exact values and casts them to q's
dtype (exact too). With a window (8ew,
:func:`paged_flash_prefill_fp8kv_window`) and with sinks (8es, 8ews) as
over pools of q's dtype: the converted codes enter the scores, the sink
stays a raw logit outside that conversion.

The kernel takes every Sq (the TPU kernel needs Sq % bq == 0, and its
dispatcher Sq % 128 == 0). ``bq`` and ``pages_per_block``, the TPU's MXU
block knobs (paged_prefill.py:13-21, :180-182), have no counterpart.
Unmapped (-1) pages inside kv_len read as zeros in both versions, as in
:func:`~simplellminference_tpu_torch.memory.paged_kv.gather_dense`.

The sliding-window forms (``window``: query q_pos attends keys q_pos -
window < k_pos <= q_pos; paged_prefill.py:90-92, :131-132) start each q
tile's key walk at its oldest row's first key and read no key below it,
which keeps the grouped engine's ring pools right (a column below the
band aliases the live page of a newer position). They are
:func:`paged_flash_prefill_window`,
:func:`paged_flash_prefill_int8kv_window` and
:func:`paged_flash_prefill_fp8kv_window`, each with its own launch count.

Gemma-2's soft cap (``logit_cap``: cap * tanh(s * scale * (1 / cap))
before the mask, paged_prefill.py:123-124) over every pool dtype, with or
without a window (forms 8c, 8wc, 8qc, 8qwc, 8ec, 8ewc): a compile-time
flag of the kernels, applied to the scores of the dequantized (or
converted) K as JAX applies it; capped launches count in their form's
``launches`` and in :data:`~.flash_prefill.CAP_LAUNCHES`.

GPT-OSS's attention sinks (``sinks`` [N], a logit per q head in each
row's softmax denominator, no value; paged_prefill.py:259) over every
pool dtype, with or without a window (forms 8s, 8ws, 8qs, 8qws, 8es,
8ews): a pointer argument of both kernels, each row's softmax state
seeded with (sink, 1), by split 0 only when the key walk splits; launches
with sinks count in their form's ``launches`` and in
:data:`~.flash_prefill.SINK_LAUNCHES`. Head dim 256 (Gemma) on every form
over every pool dtype (its launches there also in :data:`D256_LAUNCHES`).
Sinks at D 256 are not ported yet and raise.

Shared-KV pools (absorbed MLA: ``v_pool`` None, one pool whose latent row
is both the key and the value; paged_prefill.py:44, :55-58, :114-118,
:188): form 8l, :func:`paged_flash_prefill_shared`, with its own launch
count; ``paged_flash_prefill`` hands a shared pool to it. Its kernels
(``csrc/paged_prefill_shared.cu`` over ``csrc/prefill_shared.cuh``) stage
each key tile once for both products and make the output in passes of 128
columns: bf16 on the tensor cores, f32 on FMAs, at head dims 128 and 640
(DeepSeek-V2-Lite's latent row), with no window, cap, sinks or scales.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.memory.paged_kv import gather_dense
from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.attention import prefill_tiles
from simplellminference_tpu_torch.ops.attention.flash_prefill import (
    cap_value, check_sinks_head_dim, count_launch, heads_contiguous,
    sink_values, window_size)
from simplellminference_tpu_torch.ops.attention.paged_decode import (
    _check_e4m3, _check_float_pools, _refuse_shared_options, band_tables)
from simplellminference_tpu_torch.ops.paged_append import check_scale_pools

HEAD_DIMS = (32, 64, 128, 256)
SHARED_HEAD_DIMS = (128, 640)   # form 8l's (absorbed MLA's latent lanes)


def _check_options(k_pool, v_pool, window, k_scale, v_scale) -> bool:
    """Raise for the options not ported; True for INT8 KV (scale pools
    given and checked)."""
    if window is not None:
        window_size(window)
    if k_scale is None and v_scale is None:
        return False
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return True


def paged_flash_prefill_ref(q, k_pool, v_pool, tables, kv_lens, chunk_offset,
                            layer: int, sm_scale: float | None = None,
                            window=None, logit_cap=None, sinks=None,
                            k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version: gather the pages densely (dequantized in f32 through
    the scale pools when given, then rounded to q's dtype as the kernel
    rounds), mask key_pos <= q_pos and key_pos < kv_len per element (and
    key_pos > q_pos - window with a sliding window, the pages wholly below
    the band left ungathered), reference attention, the scores capped by
    ``logit_cap`` before the mask, each head's ``sinks`` logit in its
    softmax. q: [B, Sq, N, D] -> [B, Sq, N, D]."""
    quant = _check_options(k_pool, v_pool, window, k_scale, v_scale)
    if q.is_cuda:
        paged_flash_prefill_ref.cuda_calls += 1
    if v_pool is None:
        _refuse_shared_options(k_scale, v_scale, window, logit_cap, sinks)
        return paged_flash_prefill_shared_ref(q, k_pool, tables, kv_lens,
                                              chunk_offset, layer, sm_scale)
    if window is not None:
        # no page below the oldest row's band: chunk_offset - window + 1
        tables = band_tables(tables, chunk_offset.long() - int(window) + 1,
                             k_pool.shape[3])
    ck, cv = gather_dense(k_pool[layer], v_pool[layer], tables,
                          k_scale[layer] if quant else None,
                          v_scale[layer] if quant else None)
    if quant or k_pool.dtype == torch.float8_e4m3fn:
        ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    smax = ck.shape[2]
    s = q.shape[1]
    key_pos = torch.arange(smax, device=q.device)[None, None, None, :]
    q_pos = (chunk_offset.long().to(q.device)[:, None]
             + torch.arange(s, device=q.device)[None])            # [B, Sq]
    mask = ((key_pos <= q_pos[:, None, :, None])
            & (key_pos < kv_lens.long().to(q.device)[:, None, None, None]))
    if window is not None:
        mask = mask & (key_pos > q_pos[:, None, :, None] - int(window))
    return ref_ops.attention(q, ck.transpose(1, 2), cv.transpose(1, 2),
                             mask, scale=sm_scale,
                             logit_cap=cap_value(logit_cap), sinks=sinks)


paged_flash_prefill_ref.cuda_calls = 0


def paged_flash_prefill(q, k_pool, v_pool, tables, kv_lens, chunk_offset,
                        layer: int, sm_scale: float | None = None,
                        window=None, logit_cap=None, sinks=None,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """q: [B, Sq, N, D] at absolute positions chunk_offset[b] + 0..Sq-1;
    k/v_pool: stacked [L, P+1, kvN, ps, D] with an int ``layer`` (q's
    dtype, float8_e4m3fn for FP8 KV, or int8 with f32
    ``k_scale``/``v_scale`` [L, P+1, kvN, ps] for INT8 KV);
    tables: [B, MP] int32 (-1 = unmapped); kv_lens: [B] valid tokens
    after the chunk's write; chunk_offset: [B] -> out [B, Sq, N, D] in q's
    dtype. Keys are positions < min(kv_len, MP*ps) up to each row's
    position, and within ``window`` of it with a sliding window;
    ``logit_cap`` > 0 soft-caps the scores and ``sinks`` [N] add each
    head's sink logit to its softmax. The launch counts as the form the
    options and pools name (8, 8q, 8e, 8w, 8qw, 8ew; a capped or sink form
    in the count of the form it caps or seeds). A shared pool (``v_pool``
    None) takes form 8l."""
    if v_pool is None:
        _refuse_shared_options(k_scale, v_scale, window, logit_cap, sinks)
        return paged_flash_prefill_shared(q, k_pool, tables, kv_lens,
                                          chunk_offset, layer, sm_scale)
    quant = _check_options(k_pool, v_pool, window, k_scale, v_scale)
    check_sinks_head_dim(sinks, q.shape[-1])
    cap = cap_value(logit_cap)
    if window is not None:
        window = window_size(window)
    kind = ("int8kv" if quant else "fp8kv"
            if k_pool.dtype == torch.float8_e4m3fn else "")
    form = _FORMS[kind, window is not None]
    if not q.is_cuda:
        return paged_flash_prefill_ref(q, k_pool, v_pool, tables, kv_lens,
                                       chunk_offset, layer, sm_scale,
                                       window=window, logit_cap=cap,
                                       sinks=sinks, k_scale=k_scale,
                                       v_scale=v_scale)
    if quant:
        _check_scale_devices(q, k_pool, v_pool, k_scale, v_scale)
    else:
        _check_float_pools(q, k_pool, v_pool)
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, tables, kv_lens,
                  chunk_offset, layer, sm_scale, window or 0, cap,
                  form.__name__, sinks)
    form.launches += 1
    count_launch(form.__name__, q.shape[-1], cap, D256_LAUNCHES, sinks)
    return out


def paged_flash_prefill_window(q, k_pool, v_pool, tables, kv_lens,
                               chunk_offset, layer: int, window: int,
                               sm_scale: float | None = None,
                               logit_cap: float | None = None,
                               sinks=None) -> torch.Tensor:
    """8w: :func:`paged_flash_prefill` with a sliding window (8wc with a
    ``logit_cap``, 8ws with ``sinks``)."""
    return paged_flash_prefill(q, k_pool, v_pool, tables, kv_lens,
                               chunk_offset, layer, sm_scale,
                               window=window_size(window),
                               logit_cap=logit_cap, sinks=sinks)


def paged_flash_prefill_int8kv(q, k_pool, v_pool, k_scale, v_scale, tables,
                               kv_lens, chunk_offset, layer: int,
                               sm_scale: float | None = None) -> torch.Tensor:
    """8q: :func:`paged_flash_prefill` of q [B, Sq, N, D] bf16 or f32
    against int8 pools and their f32 scale pools; out in q's dtype."""
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return paged_flash_prefill(q, k_pool, v_pool, tables, kv_lens,
                               chunk_offset, layer, sm_scale,
                               k_scale=k_scale, v_scale=v_scale)


def paged_flash_prefill_int8kv_window(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, kv_lens, chunk_offset,
                                      layer: int, window: int,
                                      sm_scale: float | None = None
                                      ) -> torch.Tensor:
    """8qw: :func:`paged_flash_prefill_int8kv` with a sliding window."""
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return paged_flash_prefill(q, k_pool, v_pool, tables, kv_lens,
                               chunk_offset, layer, sm_scale,
                               window=window_size(window), k_scale=k_scale,
                               v_scale=v_scale)


def paged_flash_prefill_fp8kv(q, k_pool, v_pool, tables, kv_lens,
                              chunk_offset, layer: int,
                              sm_scale: float | None = None) -> torch.Tensor:
    """8e: :func:`paged_flash_prefill` of q [B, Sq, N, D] bf16 or f32
    against float8_e4m3fn pools (no scales); out in q's dtype."""
    _check_e4m3(k_pool, v_pool)
    return paged_flash_prefill(q, k_pool, v_pool, tables, kv_lens,
                               chunk_offset, layer, sm_scale)


def paged_flash_prefill_fp8kv_window(q, k_pool, v_pool, tables, kv_lens,
                                     chunk_offset, layer: int, window: int,
                                     sm_scale: float | None = None,
                                     sinks=None) -> torch.Tensor:
    """8ew: :func:`paged_flash_prefill_fp8kv` with a sliding window (8ews
    with ``sinks``)."""
    _check_e4m3(k_pool, v_pool)
    return paged_flash_prefill(q, k_pool, v_pool, tables, kv_lens,
                               chunk_offset, layer, sm_scale,
                               window=window_size(window), sinks=sinks)


# (KV kind, sliding window) -> the form whose launch count a call adds to
_FORMS = {("", False): paged_flash_prefill,
          ("", True): paged_flash_prefill_window,
          ("int8kv", False): paged_flash_prefill_int8kv,
          ("int8kv", True): paged_flash_prefill_int8kv_window,
          ("fp8kv", False): paged_flash_prefill_fp8kv,
          ("fp8kv", True): paged_flash_prefill_fp8kv_window}
for _f in _FORMS.values():
    _f.launches = 0
# every form takes head_dim 256 (Gemma); each form's launches at that head
# dim (each also in its ``launches``)
D256_LAUNCHES = {f.__name__: 0 for f in _FORMS.values()}


def _check_scale_devices(q, k_pool, v_pool, k_scale, v_scale):
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    if any(t.device != q.device for t in (k_scale, v_scale)):
        raise ValueError("q and the scale pools must share a device")


def _launch(q, k_pool, v_pool, k_scale, v_scale, tables, kv_lens,
            chunk_offset, layer, sm_scale, window: int, cap, what,
            sinks=None):
    b, s, n, d = q.shape
    n_layers, p1, kvn, ps, pd = k_pool.shape
    if pd != d or v_pool.shape != k_pool.shape:
        raise ValueError("pools must be matching [L, P+1, kvN, ps, D]")
    if n % kvn:
        raise ValueError(f"{n} heads do not group over {kvn} kv heads")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} (kernel takes {HEAD_DIMS})")
    if any(t.device != q.device
           for t in (k_pool, v_pool, tables, kv_lens, chunk_offset)):
        raise ValueError("q, pools, tables, kv_lens and chunk_offset must "
                         "share a device")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if q.dtype == torch.bfloat16 and (k_pool.data_ptr() % 16
                                      or v_pool.data_ptr() % 16):
        raise ValueError("pools must start 16-byte aligned (16-byte copies)")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(q.dtype)
    sinks = sink_values(sinks, n, q.device)
    out = torch.empty((b, s, n, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    q = heads_contiguous(q)
    tables = tables.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    offs = chunk_offset.to(torch.int32).contiguous()
    if tables.shape[0] != b or kv_lens.shape != (b,) or offs.shape != (b,):
        raise ValueError("tables/kv_lens/chunk_offset rows do not match q")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    splits, work = prefill_tiles.workspace(q, kvn, window,
                                           tables.shape[1] * ps)
    lib = cuda_build.load()
    rc = lib.sli_paged_flash_prefill(
        q.data_ptr(), q.stride(0), q.stride(1), k_pool.data_ptr(),
        v_pool.data_ptr(), 0 if k_scale is None else k_scale.data_ptr(),
        0 if v_scale is None else v_scale.data_ptr(), tables.data_ptr(),
        kv_lens.data_ptr(), offs.data_ptr(), out.data_ptr(), b, s, n, layer,
        p1, kvn, ps, tables.shape[1], n // kvn, d, window, scale,
        cap or 0.0, code,
        cuda_build.pool_code(k_pool.dtype),
        0 if work is None else work.data_ptr(), splits,
        0 if sinks is None else sinks.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, what)
    return out


def paged_flash_prefill_shared_ref(q, pool, tables, kv_lens, chunk_offset,
                                   layer: int,
                                   sm_scale: float | None = None
                                   ) -> torch.Tensor:
    """Plain version of :func:`paged_flash_prefill_shared`: the pages
    gathered densely (K as V), key_pos <= q_pos and key_pos < kv_len
    masked per element, reference attention. q: [B, Sq, N, D] ->
    [B, Sq, N, D]."""
    if q.is_cuda:
        paged_flash_prefill_shared_ref.cuda_calls += 1
    ck, _ = gather_dense(pool[layer], None, tables)
    s = q.shape[1]
    key_pos = torch.arange(ck.shape[2], device=q.device)[None, None, None, :]
    q_pos = (chunk_offset.long().to(q.device)[:, None]
             + torch.arange(s, device=q.device)[None])            # [B, Sq]
    mask = ((key_pos <= q_pos[:, None, :, None])
            & (key_pos < kv_lens.long().to(q.device)[:, None, None, None]))
    kt = ck.transpose(1, 2)
    return ref_ops.attention(q, kt, kt, mask, scale=sm_scale)


paged_flash_prefill_shared_ref.cuda_calls = 0


def paged_flash_prefill_shared(q, pool, tables, kv_lens, chunk_offset,
                               layer: int,
                               sm_scale: float | None = None) -> torch.Tensor:
    """8l: chunked-prefill attention through the page tables of a shared-KV
    pool (absorbed MLA), whose row is both the key and the value. q [B,
    Sq, N, D] at positions chunk_offset[b] + 0..Sq-1; pool [L, P+1, kvN,
    ps, D] of q's dtype (bf16 or f32); tables [B, MP] int32 (-1
    unmapped); kv_lens [B] valid tokens after the chunk's write -> out [B,
    Sq, N, D]. Head dims 128 and 640."""
    b, s, n, d = q.shape
    if d not in SHARED_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} over a shared-KV pool "
                                  f"(form 8l takes {SHARED_HEAD_DIMS})")
    if not q.is_cuda:
        return paged_flash_prefill_shared_ref(q, pool, tables, kv_lens,
                                              chunk_offset, layer, sm_scale)
    n_layers, p1, kvn, ps, pd = pool.shape
    if pd != d or n % kvn:
        raise ValueError(f"pool {tuple(pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if pool.dtype != q.dtype:
        raise NotImplementedError(f"q {q.dtype} with a {pool.dtype} shared "
                                  f"pool (quantized KV)")
    if any(t.device != q.device
           for t in (pool, tables, kv_lens, chunk_offset)):
        raise ValueError("q, pool, tables, kv_lens and chunk_offset must "
                         "share a device")
    if not pool.is_contiguous() or pool.data_ptr() % 16:
        raise ValueError("the pool must be contiguous and 16-byte aligned")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(q.dtype)
    out = torch.empty((b, s, n, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    q = heads_contiguous(q)
    tables = tables.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    offs = chunk_offset.to(torch.int32).contiguous()
    if tables.shape[0] != b or kv_lens.shape != (b,) or offs.shape != (b,):
        raise ValueError("tables/kv_lens/chunk_offset rows do not match q")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    splits, work = prefill_tiles.workspace(q, kvn, 0, tables.shape[1] * ps)
    lib = cuda_build.load()
    rc = lib.sli_paged_flash_prefill_shared(
        q.data_ptr(), q.stride(0), q.stride(1), pool.data_ptr(),
        tables.data_ptr(), kv_lens.data_ptr(), offs.data_ptr(),
        out.data_ptr(), b, s, n, layer, p1, kvn, ps, tables.shape[1], d,
        scale, code, 0 if work is None else work.data_ptr(), splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_flash_prefill_shared")
    paged_flash_prefill_shared.launches += 1
    return out


paged_flash_prefill_shared.launches = 0
