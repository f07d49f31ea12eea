"""Paged flash-decode attention through the block tables: one query per
sequence (decode), or a window of S <= 8 queries per sequence (the
speculative verify step).

Counterpart of simplellminference_tpu/ops/attention/paged_decode.py:165
(``paged_flash_decode``, one query row per sequence) and :136
(``paged_flash_verify``, the same kernel with ``wins = S``: row s sits at
position kv_len - S + s and attends the keys up to it), over bf16/f32
pools, FP8 (float8_e4m3fn) pools, or INT8 pools with their
per-token-per-head scale pools (``k_scale``/``v_scale``). For CUDA tensors
the wrappers launch the hand-written kernel of ``csrc/paged_decode.cu``:
the live keys of each sequence split over blocks (flash-decoding;
:func:`decode_splits` picks the number of splits from shapes alone,
:func:`split_keys` is the cut a block makes), each block holding every
query row of its GQA group and window (up to 32 rows), page ids read from
the table in the block, f32 online softmax over its keys, f32 partials
merged by log-sum-exp in a second small kernel. Each form has its own
launch count and a wrapper of its name (:func:`paged_flash_decode`,
:func:`paged_flash_decode_int8kv`, :func:`paged_flash_decode_fp8kv`,
:func:`paged_flash_verify`, :func:`paged_flash_verify_int8kv`,
:func:`paged_flash_verify_fp8kv`), and a call counts as one launch of the
form its options and pools name. For CPU tensors they run the plain
versions, the gather (+ dequant) + mask + dense reference path of the JAX
dispatcher (dispatch.py:239-269).

INT8 KV: the kernel dequantizes late, as the TPU kernel does
(paged_decode.py:84-89, :116-120): the K scale multiplies each score after
q.k, the V scale folds into p before the PV product, so the int8 codes
enter the dot products as exact floats. The plain version dequantizes the
gathered pages to f32 first; the two agree to f32 rounding.

FP8 KV (forms 4e and 4ve, e4m3 pools with bf16 or f32 q): the TPU kernel
casts each e4m3 element straight to f32 (paged_decode.py:79-80, :113);
the kernel converts each staged code exactly in registers, the plain
version gathers the exact f32 values. The window forms (4ew, 4vew), the
sink forms (4es, 4ews, 4ves, 4vews) and the capped forms (4ec, 4ewc,
4vec, 4vewc) take e4m3 pools as they take pools of q's dtype: the walk
reads no ring column below the band, the sink, a raw logit, seeds split
0's state, and the cap takes the score of the exact values.

The sliding-window forms (``window``: row s attends keys with row_pos -
k_pos < window; paged_decode.py:73-75, :98-101) walk the keys from the
oldest row's first key in the window, kv_len - S - window + 1, and read
none below it: over the grouped engine's ring pools the table columns
below the band alias live pages of newer positions (engine.py:483-492),
so the walk's start, not the mask, keeps the answer right. They are
:func:`paged_flash_decode_window`,
:func:`paged_flash_decode_int8kv_window`,
:func:`paged_flash_decode_fp8kv_window`, :func:`paged_flash_verify_window`,
:func:`paged_flash_verify_int8kv_window` and
:func:`paged_flash_verify_fp8kv_window`, each with its own launch count.

Gemma-2's soft cap (``logit_cap``: each score becomes
cap * tanh(s * scale * (1 / cap)) before the mask, paged_decode.py:90-91)
on the decode and verify forms over every pool dtype, with or without a
window (4c, 4wc, 4vc, 4vwc; 4qc, 4qwc, 4vqc, 4vqwc; 4ec, 4ewc, 4vec,
4vewc): a compile-time flag of the kernel, so the uncapped forms run the
code they ran before; over INT8 pools the cap takes the dequantized score
(q.k x the K scale x scale), JAX's order (paged_decode.py:84-91), over
e4m3 pools the score of the exact f32 values (:79-80, :90-91). Capped
launches count in their form's ``launches`` and in
:data:`~.flash_prefill.CAP_LAUNCHES`.

GPT-OSS's attention sinks (``sinks`` [N], a learned logit per q head that
joins each row's softmax denominator and adds no value,
paged_decode.py:29-35, :57-67) on the decode and verify forms over every
pool dtype, with or without a window (4s, 4ws, 4vs, 4vws; 4qs, 4qws,
4vqs, 4vqws; 4es, 4ews, 4ves, 4vews: the sink is a raw logit, outside
every scale, while INT8 KV scales each score and each probability): a pointer
argument of the kernel; split 0's block seeds each row's state with
(sink, 1), so the log-sum-exp merge counts it once, and a verify row
takes its head's sink whatever its window row (gpt-oss-20b's group of 8
x 5 rows fills two row blocks, each seeding its own rows). Launches with
sinks count in their form's ``launches`` and in
:data:`~.flash_prefill.SINK_LAUNCHES`. Sinks at head_dim 256 raise (not
ported yet), on the CPU as on the card.

Head dim 256 (Gemma) on every form over every pool dtype, each form's
launches there also in :data:`D256_LAUNCHES`.

Shared-KV pools (absorbed MLA: ``v_pool`` None, one pool whose latent row
is both the key and the value; paged_decode.py:24, :36-40, :110-111,
:192): form 4l, :func:`paged_flash_decode_shared`, with its own launch
count; ``paged_flash_decode`` hands a shared pool to it. The kernel
stages each key tile once for both products (``csrc/
paged_decode_shared.cu``), at head dims 128 and 640 (DeepSeek-V2-Lite's
latent row), bf16 and f32, with no window, cap, sinks or scales; other
head dims raise by name, and so does the verify form over a shared pool
(not ported).

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
from simplellminference_tpu_torch.ops.attention.flash_prefill import (
    cap_value, check_sinks_head_dim, count_launch, sink_values, window_size)
from simplellminference_tpu_torch.ops.matmul import SM_COUNT
from simplellminference_tpu_torch.ops.paged_append import check_scale_pools

HEAD_DIMS = (32, 64, 128, 256)
SHARED_HEAD_DIMS = (128, 640)   # form 4l's (absorbed MLA's latent lanes)
MAX_ROWS = 128   # query rows (GQA group x window rows) a call takes
ROW_BLOCK = 32   # query rows a block of the kernel holds (16 past D 256)
TILE_KEYS = 64   # keys per tile of the kernel; splits cut whole tiles
MAX_SPLITS = 32


def decode_splits(b: int, kvn: int, span: int, row_blocks: int = 1) -> int:
    """Splits of the key walk for a grid of ``b`` sequences x ``kvn`` kv
    heads x ``row_blocks``: as many as one wave of two blocks per SM holds
    (a grid just past it would run a second, nearly empty wave), at most
    one per 64-key tile of ``span`` (the most keys a block can meet:
    MP * ps, the window band, or the dense arena's Smax) and at most 32.
    From shapes alone, never from kv_lens: the call needs no host sync."""
    blocks = max(1, b * kvn * row_blocks)
    want = 2 * SM_COUNT // blocks
    return max(1, min(want, -(-span // TILE_KEYS), MAX_SPLITS))


def split_keys(kv_len: int, wins: int, window: int, n_cap: int,
               splits: int) -> list[tuple[int, int]]:
    """The key range [lo, hi) each split of the kernel walks for one
    sequence (empty: lo == hi), as the kernel computes it: the live keys
    [k_lo, min(kv_len, n_cap)) (k_lo = kv_len - wins - window + 1 with a
    sliding ``window`` > 0, else 0) cut into ``splits`` runs of whole
    64-key tiles, tile-aligned to the pool, ceil(tiles / splits) each."""
    n_keys = max(0, min(kv_len, n_cap))
    k_lo = max(0, kv_len - wins - window + 1) if window > 0 else 0
    t_lo = k_lo // TILE_KEYS
    nt = max(0, -(-n_keys // TILE_KEYS) - t_lo)
    per = -(-nt // splits)
    out = []
    for z in range(splits):
        ta, tb = t_lo + min(nt, z * per), t_lo + min(nt, (z + 1) * per)
        lo = max(k_lo, ta * TILE_KEYS)
        out.append((lo, max(lo, min(n_keys, tb * TILE_KEYS))))
    return out


def row_block(d: int) -> int:
    """Query rows a block holds at head dim ``d`` (paged_decode.cuh's
    row_block)."""
    return 16 if d > 256 else ROW_BLOCK


def row_blocks(rows: int, d: int = 128) -> int:
    """Blocks a (sequence, kv head) takes for ``rows`` query rows."""
    return -(-rows // row_block(d))


def workspace(b: int, rows: int, d: int, splits: int, device):
    """The f32 partials of a split call (acc, then m and l, per split and
    output row), or None with one split."""
    if splits == 1:
        return None
    return torch.empty((splits * b * rows * (d + 2),), dtype=torch.float32,
                       device=device)


def _check_scales(k_pool, v_pool, k_scale, v_scale) -> bool:
    """True for INT8 pools with scale pools (checked), False without."""
    if k_scale is None and v_scale is None:
        return False
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return True


def band_tables(tables: torch.Tensor, k_lo: torch.Tensor,
                ps: int) -> torch.Tensor:
    """``tables`` with every column that ends at or below key ``k_lo[b]``
    unmapped (-1): the plain versions of the window forms gather, as the
    kernels read, no page wholly below the window band (over the ring
    pools those columns alias live pages of newer positions)."""
    ends = (torch.arange(tables.shape[1], device=tables.device) + 1) * ps
    keep = ends[None, :] > k_lo.to(tables.device).long()[:, None]
    return torch.where(keep, tables, torch.full_like(tables, -1))


def _attend_ref(q, k_pool, v_pool, tables, kv_lens, layer, sm_scale,
                k_scale, v_scale, window=None, logit_cap=None, sinks=None):
    """Gather the pages densely (dequantized in f32 through the scale pools
    when given), mask window row s to keys at positions <= kv_len - S + s
    (and, with a sliding ``window``, > kv_len - S + s - window), reference
    attention with the scores capped by ``logit_cap`` before the mask and
    each head's ``sinks`` logit in the softmax; a row with no key is zero,
    as in the kernel.
    q: [B, S, N, D] -> [B, S, N, D]."""
    quant = _check_scales(k_pool, v_pool, k_scale, v_scale)
    s = q.shape[1]
    if window is not None:
        tables = band_tables(tables, kv_lens.long() - s - window_size(window)
                             + 1, k_pool.shape[3])
    ck, cv = gather_dense(k_pool[layer],
                          None if v_pool is None else v_pool[layer], tables,
                          k_scale[layer] if quant else None,
                          v_scale[layer] if quant else None)
    q_pos = (kv_lens.long()[:, None] - s
             + torch.arange(s, device=q.device)[None])           # [B, S]
    key_pos = torch.arange(ck.shape[2], device=q.device)
    mask = key_pos[None, None, None, :] <= q_pos[:, None, :, None]
    if window is not None:
        mask = mask & (key_pos[None, None, None, :]
                       > q_pos[:, None, :, None] - window_size(window))
    out = ref_ops.attention(q, ck.transpose(1, 2), cv.transpose(1, 2), mask,
                            scale=sm_scale, logit_cap=cap_value(logit_cap),
                            sinks=sinks)
    return torch.where((q_pos >= 0)[:, :, None, None], out,
                       torch.zeros_like(out))


def paged_flash_decode_ref(q, k_pool, v_pool, tables, kv_lens, layer: int,
                           sm_scale: float | None = None, k_scale=None,
                           v_scale=None, window=None,
                           logit_cap=None, sinks=None) -> torch.Tensor:
    """Plain version of :func:`paged_flash_decode` and its INT8-KV, FP8-KV,
    window, capped and sink forms: keys at positions < kv_len (and >=
    kv_len - window); q: [B, N, D] -> [B, N, D]."""
    if q.is_cuda:
        paged_flash_decode_ref.cuda_calls += 1
    if v_pool is None:
        _refuse_shared_options(k_scale, v_scale, window, logit_cap, sinks)
    return _attend_ref(q[:, None], k_pool, v_pool, tables, kv_lens, layer,
                       sm_scale, k_scale, v_scale, window, logit_cap,
                       sinks)[:, 0]


paged_flash_decode_ref.cuda_calls = 0


def paged_flash_verify_ref(q, k_pool, v_pool, tables, kv_lens, layer: int,
                           sm_scale: float | None = None, k_scale=None,
                           v_scale=None, window=None,
                           logit_cap=None, sinks=None) -> torch.Tensor:
    """Plain version of :func:`paged_flash_verify` and its INT8-KV,
    FP8-KV, window, capped and sink forms, the gather + mask + reference
    attention of the JAX dispatcher's S > 1 branch (dispatch.py:239-269).
    q: [B, S, N, D] -> [B, S, N, D]."""
    if q.is_cuda:
        paged_flash_verify_ref.cuda_calls += 1
    return _attend_ref(q, k_pool, v_pool, tables, kv_lens, layer, sm_scale,
                       k_scale, v_scale, window, logit_cap, sinks)


paged_flash_verify_ref.cuda_calls = 0


def paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer: int,
                       sm_scale: float | None = None, k_scale=None,
                       v_scale=None, window=None,
                       logit_cap=None, sinks=None) -> torch.Tensor:
    """q: [B, N, D]; k/v_pool: stacked [L, P+1, kvN, ps, D] with an int
    ``layer`` (q's dtype, float8_e4m3fn for FP8 KV, or int8 with f32
    ``k_scale``/``v_scale`` [L, P+1, kvN, ps] for INT8 KV); tables:
    [B, MP] int32 (-1 = unmapped); kv_lens: [B] -> out [B, N, D] in q's
    dtype. Keys are positions < min(kv_len, MP*ps), and >= kv_len -
    ``window`` with a sliding window; ``logit_cap`` > 0 soft-caps the
    scores and ``sinks`` [N] add each head's sink logit to its softmax.
    The launch counts as the form the options and pools name (4, 4q, 4e,
    4w, 4qw, 4ew; a capped or sink form in the count of the form it caps
    or seeds). A shared pool (``v_pool`` None) takes form 4l."""
    if v_pool is None:
        _refuse_shared_options(k_scale, v_scale, window, logit_cap, sinks)
        return paged_flash_decode_shared(q, k_pool, tables, kv_lens, layer,
                                         sm_scale)
    return _run("paged_flash_decode", q[:, None], k_pool, v_pool, k_scale,
                v_scale, tables, kv_lens, layer, sm_scale, window,
                logit_cap, sinks)[:, 0]


def paged_flash_verify(q, k_pool, v_pool, tables, kv_lens, layer: int,
                       sm_scale: float | None = None, k_scale=None,
                       v_scale=None, window=None,
                       logit_cap=None, sinks=None) -> torch.Tensor:
    """Multi-row decode windows (the speculative verify step): q
    [B, S, N, D], where row s sits at position kv_len - S + s and attends
    the keys at positions <= that one, through the same page walk as
    :func:`paged_flash_decode` (KV traffic of one decode step). Pools,
    tables, scale pools, ``window``, ``logit_cap`` and ``sinks`` as
    there (each row takes its head's sink); out [B, S, N, D] in q's dtype.
    The launch counts as the form the options and pools name (4v, 4vq,
    4ve, 4vw, 4vqw, 4vew; a capped or sink form in the count of the form
    it caps or seeds)."""
    if v_pool is None:
        raise NotImplementedError("the verify form over a shared-KV pool "
                                  "(speculative decoding under absorbed "
                                  "MLA)")
    return _run("paged_flash_verify", q, k_pool, v_pool, k_scale, v_scale,
                tables, kv_lens, layer, sm_scale, window, logit_cap, sinks)


def paged_flash_decode_window(q, k_pool, v_pool, tables, kv_lens,
                              layer: int, window: int,
                              sm_scale: float | None = None,
                              logit_cap=None, sinks=None) -> torch.Tensor:
    """4w: :func:`paged_flash_decode` over keys kv_len - window ..
    kv_len - 1; no page below them is read (4wc with a ``logit_cap``, 4ws
    with ``sinks``)."""
    return paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, window=window_size(window),
                              logit_cap=logit_cap, sinks=sinks)


def paged_flash_decode_int8kv(q, k_pool, v_pool, k_scale, v_scale, tables,
                              kv_lens, layer: int,
                              sm_scale: float | None = None) -> torch.Tensor:
    """4q: :func:`paged_flash_decode` of q [B, N, D] bf16 or f32 against
    int8 pools and their f32 scale pools; out in q's dtype."""
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, k_scale, v_scale)


def paged_flash_decode_int8kv_window(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, kv_lens, layer: int,
                                     window: int,
                                     sm_scale: float | None = None
                                     ) -> torch.Tensor:
    """4qw: :func:`paged_flash_decode_int8kv` with a sliding window."""
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, k_scale, v_scale, window_size(window))


def paged_flash_decode_fp8kv(q, k_pool, v_pool, tables, kv_lens,
                             layer: int,
                             sm_scale: float | None = None) -> torch.Tensor:
    """4e: :func:`paged_flash_decode` of q [B, N, D] bf16 or f32 against
    float8_e4m3fn pools (no scales); out in q's dtype."""
    _check_e4m3(k_pool, v_pool)
    return paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale)


def paged_flash_verify_fp8kv(q, k_pool, v_pool, tables, kv_lens,
                             layer: int,
                             sm_scale: float | None = None) -> torch.Tensor:
    """4ve: :func:`paged_flash_verify` of q [B, S, N, D] bf16 or f32
    against float8_e4m3fn pools (no scales)."""
    _check_e4m3(k_pool, v_pool)
    return paged_flash_verify(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale)


def paged_flash_decode_fp8kv_window(q, k_pool, v_pool, tables, kv_lens,
                                    layer: int, window: int,
                                    sm_scale: float | None = None,
                                    sinks=None) -> torch.Tensor:
    """4ew: :func:`paged_flash_decode_fp8kv` with a sliding window (4ews
    with ``sinks``)."""
    _check_e4m3(k_pool, v_pool)
    return paged_flash_decode(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, window=window_size(window),
                              sinks=sinks)


def paged_flash_verify_fp8kv_window(q, k_pool, v_pool, tables, kv_lens,
                                    layer: int, window: int,
                                    sm_scale: float | None = None,
                                    sinks=None) -> torch.Tensor:
    """4vew: :func:`paged_flash_verify_fp8kv` with a sliding window (4vews
    with ``sinks``)."""
    _check_e4m3(k_pool, v_pool)
    return paged_flash_verify(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, window=window_size(window),
                              sinks=sinks)


def _check_e4m3(k_pool, v_pool):
    if (k_pool.dtype != torch.float8_e4m3fn
            or v_pool is None or v_pool.dtype != torch.float8_e4m3fn):
        raise ValueError("the FP8-KV forms take float8_e4m3fn pools")


def paged_flash_verify_window(q, k_pool, v_pool, tables, kv_lens,
                              layer: int, window: int,
                              sm_scale: float | None = None,
                              logit_cap=None, sinks=None) -> torch.Tensor:
    """4vw: :func:`paged_flash_verify` where row s attends keys
    kv_len - S + s - window < k_pos <= kv_len - S + s; no page below the
    oldest row's band is read (4vwc with a ``logit_cap``, 4vws with
    ``sinks``)."""
    return paged_flash_verify(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, window=window_size(window),
                              logit_cap=logit_cap, sinks=sinks)


def paged_flash_verify_int8kv(q, k_pool, v_pool, k_scale, v_scale, tables,
                              kv_lens, layer: int,
                              sm_scale: float | None = None) -> torch.Tensor:
    """4vq: :func:`paged_flash_verify` of q [B, S, N, D] bf16 or f32
    against int8 pools and their f32 scale pools."""
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return paged_flash_verify(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, k_scale, v_scale)


def paged_flash_verify_int8kv_window(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, kv_lens, layer: int,
                                     window: int,
                                     sm_scale: float | None = None
                                     ) -> torch.Tensor:
    """4vqw: :func:`paged_flash_verify_int8kv` with a sliding window."""
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    return paged_flash_verify(q, k_pool, v_pool, tables, kv_lens, layer,
                              sm_scale, k_scale, v_scale, window_size(window))


# name -> the form whose launch count a call adds to
_FORMS = {f.__name__: f for f in (
    paged_flash_decode, paged_flash_decode_int8kv, paged_flash_decode_fp8kv,
    paged_flash_decode_window, paged_flash_decode_int8kv_window,
    paged_flash_decode_fp8kv_window, paged_flash_verify,
    paged_flash_verify_int8kv, paged_flash_verify_fp8kv,
    paged_flash_verify_window, paged_flash_verify_int8kv_window,
    paged_flash_verify_fp8kv_window)}
for _f in _FORMS.values():
    _f.launches = 0
# every form takes head_dim 256 (Gemma); each form's launches at that head
# dim (each also in its ``launches``)
D256_LAUNCHES = {name: 0 for name in _FORMS}


def _run(name, q, k_pool, v_pool, k_scale, v_scale, tables, kv_lens, layer,
         sm_scale, window, logit_cap=None, sinks=None):
    """Every form's body on q [B, S, N, D]: the plain version for CPU
    tensors; for CUDA tensors the kernel, one launch added to the count
    of the form the options name (``name``, ``_int8kv`` with scale pools,
    ``_fp8kv`` with e4m3 pools, ``_window`` with a window)."""
    quant = _check_scales(k_pool, v_pool, k_scale, v_scale)
    check_sinks_head_dim(sinks, q.shape[-1])
    cap = cap_value(logit_cap)
    if window is not None:
        window = window_size(window)
    fp8 = k_pool.dtype == torch.float8_e4m3fn
    form = _FORMS[name + "_int8kv" * quant + "_fp8kv" * fp8
                  + "_window" * (window is not None)]
    if not q.is_cuda:
        return _attend_ref(q, k_pool, v_pool, tables, kv_lens, layer,
                           sm_scale, k_scale, v_scale, window, cap, sinks)
    if quant:
        _check_scale_devices(q, k_pool, v_pool, k_scale, v_scale)
    else:
        _check_float_pools(q, k_pool, v_pool)
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, tables, kv_lens,
                  layer, sm_scale, window or 0, cap, form.__name__, sinks)
    form.launches += 1
    count_launch(form.__name__, q.shape[-1], cap, D256_LAUNCHES, sinks)
    return out


def _check_float_pools(q, k_pool, v_pool):
    """Pools of q's dtype, or float8_e4m3fn pools (FP8 KV) under bf16 or
    f32 q."""
    if k_pool.dtype != v_pool.dtype or not (
            q.dtype == k_pool.dtype or (k_pool.dtype == torch.float8_e4m3fn
                                        and q.dtype in (torch.bfloat16,
                                                        torch.float32))):
        raise NotImplementedError(
            f"q {q.dtype} with {k_pool.dtype} pools (quantized KV)")


def _check_scale_devices(q, k_pool, v_pool, k_scale, v_scale):
    check_scale_pools(k_pool, v_pool, k_scale, v_scale)
    if any(t.device != q.device for t in (k_scale, v_scale)):
        raise ValueError("q and the scale pools must share a device")


def _launch(q, k_pool, v_pool, k_scale, v_scale, tables, kv_lens, layer,
            sm_scale, window: int, cap, what, sinks=None):
    """The kernel on q [B, S, N, D] (S = 1: decode) -> [B, S, N, D]."""
    b, s, n, d = q.shape
    n_layers, p1, kvn, ps, pd = k_pool.shape
    if pd != d or (v_pool is not None and v_pool.shape != k_pool.shape):
        raise ValueError("pools must be matching [L, P+1, kvN, ps, D]")
    if n % kvn:
        raise ValueError(f"{n} heads do not group over {kvn} kv heads")
    if (n // kvn) * s > MAX_ROWS:
        raise NotImplementedError(
            f"{n // kvn} heads per kv head x {s} window rows (the kernel "
            f"holds at most {MAX_ROWS} query rows per block)")
    dims = HEAD_DIMS if v_pool is not None else SHARED_HEAD_DIMS
    if d not in dims:
        raise NotImplementedError(f"head_dim {d} (kernel takes {dims})")
    if not (k_pool.is_contiguous()
            and (v_pool is None or v_pool.is_contiguous())):
        raise ValueError("pools must be contiguous")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(q.dtype)
    sinks = sink_values(sinks, n, q.device)
    out = torch.empty((b, s, n, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    if q.stride(-1) != 1 or q.stride(-2) != d:
        q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    if tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError("tables/kv_lens rows do not match q")
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    mp = tables.shape[1]
    span = mp * ps if not window else min(mp * ps, window + s - 1)
    splits = decode_splits(b, kvn, span, row_blocks((n // kvn) * s, d))
    part = workspace(b, s * n, d, splits, q.device)
    lib = cuda_build.load()
    rc = lib.sli_paged_flash_decode(
        q.data_ptr(), q.stride(0), q.stride(1), k_pool.data_ptr(),
        0 if v_pool is None else v_pool.data_ptr(),
        0 if k_scale is None else k_scale.data_ptr(),
        0 if v_scale is None else v_scale.data_ptr(),
        tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), b, layer, p1, kvn, ps, mp,
        n // kvn, s, d, window, splits, scale, cap or 0.0, code,
        cuda_build.pool_code(k_pool.dtype),
        0 if sinks is None else sinks.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, what)
    return out


def _refuse_shared_options(k_scale, v_scale, window, logit_cap, sinks):
    """Raise, naming it, for an option form 4l does not take (no model
    with MLA has one)."""
    given = (("INT8 scale pools", k_scale is not None or v_scale is not None),
             ("a sliding window", window is not None),
             ("a logit soft cap", cap_value(logit_cap) is not None),
             ("attention sinks", sinks is not None))
    for name, on in given:
        if on:
            raise NotImplementedError(f"{name} over a shared-KV pool "
                                      f"(absorbed MLA)")


def paged_flash_decode_shared(q, pool, tables, kv_lens, layer: int,
                              sm_scale: float | None = None) -> torch.Tensor:
    """4l: decode attention over a shared-KV pool (absorbed MLA), whose
    row is both the key and the value: q [B, N, D]; pool [L, P+1, kvN, ps,
    D] of q's dtype (bf16 or f32); tables [B, MP] int32 (-1 unmapped);
    kv_lens [B] -> out [B, N, D], softmax(scale q.K^T, keys < kv_len) K.
    Head dims 128 and 640."""
    d = q.shape[-1]
    if d not in SHARED_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} over a shared-KV pool "
                                  f"(form 4l takes {SHARED_HEAD_DIMS})")
    if not q.is_cuda:
        return paged_flash_decode_ref(q, pool, None, tables, kv_lens, layer,
                                      sm_scale)
    if pool.dtype != q.dtype:
        raise NotImplementedError(f"q {q.dtype} with a {pool.dtype} "
                                  f"shared pool (quantized KV)")
    out = _launch(q[:, None], pool, None, None, None, tables, kv_lens, layer,
                  sm_scale, 0, None, "paged_flash_decode_shared")[:, 0]
    paged_flash_decode_shared.launches += 1
    return out


paged_flash_decode_shared.launches = 0
