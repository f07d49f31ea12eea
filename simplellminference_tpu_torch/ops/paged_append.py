"""In-place paged KV writes: one decode row per sequence, a span of T <= 8
consecutive rows per sequence (speculative verify), and whole prompt pages
at prefill, into bf16/f32 pools, FP8 (e4m3) pools or, quantizing, into
INT8 pools.

Counterpart of simplellminference_tpu/ops/paged_append.py:54, :129, :392
(bf16 and f32 pools) and :210, :295 (the ``*_quant`` forms for INT8 pools
with per-token-per-head f32 scale pools; an INT8 span is quantized and
written by plain torch ops, as the JAX package leaves it to XLA). For
CUDA tensors the wrappers launch
the hand-written kernels of ``csrc/paged_append.cu`` and
``csrc/paged_append_quant.cu``; for CPU tensors they run the plain
versions below (``*_ref``), which are also what the kernels are held
against on the card.

Pools are [L, P+1, kvN, ps, D] (scale pools [L, P+1, kvN, ps]) and are
updated in place (the JAX package aliases them through the Pallas call).
An unmapped (-1) table entry, or a column past the table, writes to the
TRASH page — the pool's last page row, which the allocator never hands
out — as the TPU kernels and the JAX scatter (where -1 wraps to the last
row) both do.

FP8 (float8_e4m3fn) pools, forms 1e, 2e and 11e (the same TPU kernels
over e4m3 pools, whose rows are cast to the pool dtype at
paged_append.py:45, :49, :74, :148-151): the rows are converted from
their own dtype (bf16 or f32) with the JAX package's rounding
(:func:`~simplellminference_tpu_torch.ops.ref_ops.to_e4m3`: nearest even,
NaN past 464, whatever PyTorch's own cast does), in the kernel on the card
and by ``to_e4m3`` in the plain versions, which write e4m3 pools through
``uint8`` views (CPU PyTorch has no ``index_copy_`` for float8). On the
card ``paged_append_decode``/``_span``/``_prefill`` hand e4m3 pools to
their wrappers of the form's name (``*_fp8kv``), each with its launch
count.

Shared-KV pools (absorbed MLA: one pool, ``pool_v`` None; the TPU
kernels' ``dual=False`` forms, paged_append.py:34-47, :108, :116-126,
:184): forms 1l (:func:`paged_append_decode_shared`) and 2l
(:func:`paged_append_prefill_shared`) of ``csrc/paged_append_shared.cu``
write the K rows alone, at any head dim whose row is a whole number of
16-byte vectors (DeepSeek-V2-Lite's latent row is 640 lanes, 1280 bytes in
bf16). ``paged_append_decode``/``_prefill`` hand a shared pool to them;
the span write over one raises (not ported).

Head dims: every form takes D 32-256. The quantizing forms at D 256
(Gemma over INT8 KV; a warp holds a row's 256 values, 8 a lane) and the
e4m3 forms there (Gemma over FP8 KV: a row is 32 groups of 8 codes) also
count their launches in :data:`D256_LAUNCHES`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simplellminference_tpu_torch.ops import cuda_build
from simplellminference_tpu_torch.ops.ref_ops import E4M3, to_e4m3

SPAN_MAX = 8   # rows a span writes per sequence (the JAX kernel's _ROWS)
# the quantizing and e4m3 forms' launches at head_dim 256 (each also in
# its ``launches``)
D256_LAUNCHES = {"paged_append_decode_quant": 0,
                 "paged_append_prefill_quant": 0,
                 "paged_append_decode_fp8kv": 0,
                 "paged_append_prefill_fp8kv": 0,
                 "paged_append_span_fp8kv": 0}


def _stored(pool):
    """The pool as the plain versions write it: e4m3 pools as uint8."""
    return pool.view(torch.uint8) if pool.dtype == E4M3 else pool


def _as_pool(x, pool):
    """Rows in the pool's storage: e4m3 codes (:func:`to_e4m3`, as uint8)
    for an e4m3 pool, else x cast to the pool dtype."""
    if pool.dtype == E4M3:
        return to_e4m3(x).view(torch.uint8)
    return x.to(pool.dtype)


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


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric INT8: x [..., D] -> (q int8 [..., D],
    scale f32 [...]), scale = max(absmax / 127, 1e-8), q = x / scale
    rounded half to even and clipped to +-127 (simplellminference_tpu/
    memory/paged_kv.py:134)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient that
    # jnp and the kernels compute
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _decode_slots(tables, positions, p1, ps):
    pos = positions.long()
    page = _pages(tables, torch.where(pos >= 0, pos // ps, -1), p1)
    return page, torch.where(pos >= 0, pos % ps, 0)


def span_slots(tables, positions, t: int, p1: int, ps: int):
    """(page [B, t], slot [B, t]) of rows positions[b] + 0..t-1: the trash
    page for an unmapped page, a column past the table or a negative
    position (slot 0)."""
    pos = positions.long()[:, None] + torch.arange(t, device=positions.device)
    return _decode_slots(tables, pos, p1, ps)


def paged_append_decode_ref(pool_k, pool_v, new_k, new_v, tables, positions,
                            layer: int):
    """Plain version of :func:`paged_append_decode` (in place)."""
    if pool_k.is_cuda:
        paged_append_decode_ref.cuda_calls += 1
    page, slot = _decode_slots(tables, positions, pool_k.shape[1],
                               pool_k.shape[3])
    _stored(pool_k)[layer][page, :, slot, :] = _as_pool(new_k, pool_k)
    _stored(pool_v)[layer][page, :, slot, :] = _as_pool(new_v, pool_v)
    return pool_k, pool_v


paged_append_decode_ref.cuda_calls = 0


def paged_append_span_ref(pool_k, pool_v, new_k, new_v, tables, positions,
                          layer: int):
    """Plain version of :func:`paged_append_span` (in place)."""
    if pool_k.is_cuda:
        paged_append_span_ref.cuda_calls += 1
    page, slot = span_slots(tables, positions, new_k.shape[1],
                            pool_k.shape[1], pool_k.shape[3])
    _stored(pool_k)[layer][page, :, slot, :] = _as_pool(new_k, pool_k)
    _stored(pool_v)[layer][page, :, slot, :] = _as_pool(new_v, pool_v)
    return pool_k, pool_v


paged_append_span_ref.cuda_calls = 0


def _page_chunks(x, npg, ps):
    """[B, S, kvN, ...] -> [B*npg, kvN, ps, ...], zero rows past S."""
    b, s, kvn = x.shape[:3]
    pad = npg * ps - s
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    x = x.reshape(b, npg, ps, kvn, *x.shape[3:]).transpose(2, 3)
    return x.reshape(b * npg, kvn, ps, *x.shape[4:])


def _prefill_pages(tables, b, npg, p1):
    cols = torch.arange(npg, device=tables.device)[None].expand(b, npg)
    return _pages(tables, cols, p1).reshape(-1)


def paged_append_prefill_ref(pool_k, pool_v, new_k, new_v, tables,
                             layer: int):
    """Plain version of :func:`paged_append_prefill` (in place)."""
    if pool_k.is_cuda:
        paged_append_prefill_ref.cuda_calls += 1
    ps = pool_k.shape[3]
    b, s = new_k.shape[:2]
    npg = -(-s // ps)
    idx = _prefill_pages(tables, b, npg, pool_k.shape[1])
    for pool, x in ((pool_k, new_k), (pool_v, new_v)):
        _stored(pool)[layer].index_copy_(0, idx, _page_chunks(
            _as_pool(x, pool), npg, ps))
    return pool_k, pool_v


paged_append_prefill_ref.cuda_calls = 0


def paged_append_decode_quant_ref(pool_k, pool_v, pool_ks, pool_vs, new_k,
                                  new_v, tables, positions, layer: int):
    """Plain version of :func:`paged_append_decode_quant` (in place)."""
    if pool_k.is_cuda:
        paged_append_decode_quant_ref.cuda_calls += 1
    page, slot = _decode_slots(tables, positions, pool_k.shape[1],
                               pool_k.shape[3])
    for pool, scales, x in ((pool_k, pool_ks, new_k), (pool_v, pool_vs,
                                                        new_v)):
        q, s = quantize_kv(x)
        pool[layer][page, :, slot, :] = q
        scales[layer][page, :, slot] = s
    return pool_k, pool_v, pool_ks, pool_vs


paged_append_decode_quant_ref.cuda_calls = 0


def paged_append_prefill_quant_ref(pool_k, pool_v, pool_ks, pool_vs, new_k,
                                   new_v, tables, layer: int):
    """Plain version of :func:`paged_append_prefill_quant` (in place). Rows
    past S in the last page get code 0 and scale 0, as the JAX package's
    zero pad after quantizing gives."""
    if pool_k.is_cuda:
        paged_append_prefill_quant_ref.cuda_calls += 1
    ps = pool_k.shape[3]
    b, s = new_k.shape[:2]
    npg = -(-s // ps)
    idx = _prefill_pages(tables, b, npg, pool_k.shape[1])
    for pool, scales, x in ((pool_k, pool_ks, new_k), (pool_v, pool_vs,
                                                        new_v)):
        q, sc = quantize_kv(x)
        pool[layer].index_copy_(0, idx, _page_chunks(q, npg, ps))
        scales[layer].index_copy_(0, idx, _page_chunks(sc[..., None], npg,
                                                       ps)[..., 0])
    return pool_k, pool_v, pool_ks, pool_vs


paged_append_prefill_quant_ref.cuda_calls = 0


def _check_layout(pool_k, pool_v, new_k, layer):
    if pool_v is None:
        raise NotImplementedError("shared-KV pools (absorbed MLA) in a "
                                  "two-pool form")
    if (pool_k.shape != pool_v.shape or pool_k.dtype != pool_v.dtype
            or pool_k.ndim != 5):
        raise ValueError("pools must be matching [L, P+1, kvN, ps, D]")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if pool_k.device != new_k.device:
        raise ValueError("pools and new rows must share a device")
    if not 0 <= layer < pool_k.shape[0]:
        raise IndexError(f"layer {layer} out of range")


def _check_pools(pool_k, pool_v, new_k, layer):
    """Matching bf16 or f32 pools for the row-copy kernels."""
    _check_layout(pool_k, pool_v, new_k, layer)
    cuda_build.dtype_code(pool_k.dtype)


def check_scale_pools(pool_k, pool_v, pool_ks, pool_vs):
    """INT8 pools [L, P+1, kvN, ps, D] with their contiguous f32 scale
    pools [L, P+1, kvN, ps]; a K scale pool alone (the shared-KV INT8
    pools of absorbed MLA) is not ported."""
    if pool_v is None or pool_vs is None:
        raise NotImplementedError("INT8 KV with a K scale pool and no V "
                                  "scale pool (shared-KV, absorbed MLA)")
    if pool_ks is None:
        raise ValueError("a V scale pool needs a K scale pool")
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise ValueError(f"scale pools go with int8 pools, not "
                         f"{pool_k.dtype}/{pool_v.dtype}")
    for s, p in ((pool_ks, pool_k), (pool_vs, pool_v)):
        if (s.dtype != torch.float32 or s.shape != p.shape[:-1]
                or not s.is_contiguous()):
            raise ValueError("scale pools must be contiguous f32 "
                             "[L, P+1, kvN, ps] beside their pools")


def _check_quant_pools(pool_k, pool_v, pool_ks, pool_vs, new_k, layer):
    """What the quantizing kernels need beyond :func:`check_scale_pools`
    (which every caller runs first)."""
    if pool_k.shape != pool_v.shape or pool_k.ndim != 5:
        raise ValueError("pools must be matching [L, P+1, kvN, ps, D]")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if any(t.device != new_k.device for t in (pool_k, pool_v, pool_ks,
                                              pool_vs)):
        raise ValueError("pools and new rows must share a device")
    if not 0 <= layer < pool_k.shape[0]:
        raise IndexError(f"layer {layer} out of range")


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
    ``layer``: int. Returns (pool_k, pool_v). A shared pool (``pool_v``
    None) takes form 1l, the K rows alone."""
    if pool_v is None:
        return paged_append_decode_shared(pool_k, new_k, tables, positions,
                                          layer), None
    if pool_k.dtype == E4M3:
        return paged_append_decode_fp8kv(pool_k, pool_v, new_k, new_v,
                                         tables, positions, layer)
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
    _launch_rows(pool_k, pool_v, nk[:, None], nv[:, None], tables, positions,
                 layer, "paged_append_decode")
    paged_append_decode.launches += 1
    return pool_k, pool_v


paged_append_decode.launches = 0


def paged_append_span(pool_k, pool_v, new_k, new_v, tables, positions,
                      layer: int):
    """Write T <= 8 consecutive tokens per sequence, starting at
    ``positions[b]``, into the stacked pools in place (the speculative
    verify step: T = draft + 1). Row t goes to table column
    (positions[b] + t) // ps, so a span may cross a page boundary; a
    column past the table or an unmapped (-1) page goes to the trash page.

    pool_k/v: [L, P+1, kvN, ps, D]; new_k/v: [B, T, kvN, D]; tables:
    [B, MP]; positions: [B]; ``layer``: int. Returns (pool_k, pool_v)."""
    if pool_v is None:
        raise NotImplementedError("the span write over a shared-KV pool "
                                  "(speculative decoding under absorbed "
                                  "MLA)")
    if not pool_k.is_cuda:
        return paged_append_span_ref(pool_k, pool_v, new_k, new_v, tables,
                                     positions, layer)
    if pool_k.dtype == E4M3:
        return paged_append_span_fp8kv(pool_k, pool_v, new_k, new_v, tables,
                                       positions, layer)
    _check_pools(pool_k, pool_v, new_k, layer)
    n_layers, p1, kvn, ps, d = pool_k.shape
    b, t = new_k.shape[:2]
    if not 1 <= t <= SPAN_MAX:
        raise ValueError(f"a span of {t} rows (the kernel takes 1 to "
                         f"{SPAN_MAX})")
    if b == 0:
        return pool_k, pool_v
    nk = _rows(new_k, kvn, d, pool_k.dtype)
    nv = _rows(new_v, kvn, d, pool_v.dtype)
    _launch_rows(pool_k, pool_v, nk, nv, tables, positions, layer,
                 "paged_append_span")
    paged_append_span.launches += 1
    return pool_k, pool_v


paged_append_span.launches = 0


def _launch_rows(pool_k, pool_v, nk, nv, tables, positions, layer, what):
    """The row-copy kernel: nk/nv [B, T, kvN, D] (kvN, D contiguous)."""
    _, p1, kvn, ps, d = pool_k.shape
    b, t = nk.shape[:2]
    tables = _index(tables, b, "tables")
    positions = _index(positions, b, "positions")
    es = pool_k.element_size()
    row_bytes = d * es
    st = [nk.stride(0) * es, nk.stride(1) * es, nv.stride(0) * es,
          nv.stride(1) * es]
    lib = cuda_build.load()
    rc = lib.sli_paged_append_span(
        pool_k.data_ptr(), pool_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        *st, tables.data_ptr(), positions.data_ptr(), layer, p1, kvn, ps,
        row_bytes, tables.shape[1], b, t,
        _vec16(row_bytes, pool_k, pool_v, nk, nv, *st),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, what)


def paged_append_prefill(pool_k, pool_v, new_k, new_v, tables, layer: int):
    """Write a right-padded prompt into pages in place.

    new_k/v: [B, S, kvN, D]; ``tables[:, :ceil(S/ps)]`` names the target
    pages; -1 entries land in the trash page; rows past S in the last
    page are written as zeros. Returns (pool_k, pool_v). A shared pool
    (``pool_v`` None) takes form 2l, the K rows alone."""
    if pool_v is None:
        return paged_append_prefill_shared(pool_k, new_k, tables,
                                           layer), None
    if pool_k.dtype == E4M3:
        return paged_append_prefill_fp8kv(pool_k, pool_v, new_k, new_v,
                                          tables, layer)
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


def _check_e4m3_pools(pool_k, pool_v, new_k, layer):
    """Matching float8_e4m3fn pools for the FP8-KV forms."""
    _check_layout(pool_k, pool_v, new_k, layer)
    if pool_k.dtype != E4M3:
        raise ValueError(f"the FP8-KV forms take float8_e4m3fn pools, not "
                         f"{pool_k.dtype}")


def _launch_e4m3(fn, pool_k, pool_v, nk, nv, tables, positions, layer, n,
                 what):
    """A conversion kernel of ``csrc/paged_append.cu`` on rows nk/nv
    [B, n, kvN, D] (f32 or bf16, kvN and D contiguous; n: the span T, or
    the prompt's S for prefill, ``positions`` then None)."""
    _, p1, kvn, ps, d = pool_k.shape
    b = nk.shape[0]
    tables = _index(tables, b, "tables")
    es = nk.element_size()
    st = [nk.stride(0), nk.stride(1), nv.stride(0), nv.stride(1)]
    vec8 = int(d % 8 == 0 and _vec16(d * es, nk, nv,
                                     *[x * es for x in st]) == 1)
    pos = () if positions is None else (
        _index(positions, b, "positions").data_ptr(),)
    lib = cuda_build.load()
    rc = getattr(lib, fn)(
        pool_k.data_ptr(), pool_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        *st, tables.data_ptr(), *pos, layer, p1, kvn, ps, d, tables.shape[1],
        b, n, cuda_build.dtype_code(nk.dtype), vec8,
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, what)


def paged_append_decode_fp8kv(pool_k, pool_v, new_k, new_v, tables,
                              positions, layer: int):
    """1e: :func:`paged_append_decode` into float8_e4m3fn pools, each
    element converted from new_k/v's dtype (bf16 or f32) with the JAX
    package's rounding in the kernel. Returns (pool_k, pool_v)."""
    if not pool_k.is_cuda:
        return paged_append_decode_ref(pool_k, pool_v, new_k, new_v, tables,
                                       positions, layer)
    _check_e4m3_pools(pool_k, pool_v, new_k, layer)
    kvn, d = pool_k.shape[2], pool_k.shape[4]
    if new_k.shape[0] == 0:
        return pool_k, pool_v
    nk, nv = _qrows(new_k, new_v, kvn, d)
    _launch_e4m3("sli_paged_append_span_e4m3", pool_k, pool_v, nk[:, None],
                 nv[:, None], tables, positions, layer, 1,
                 "paged_append_decode_fp8kv")
    paged_append_decode_fp8kv.launches += 1
    D256_LAUNCHES["paged_append_decode_fp8kv"] += int(d == 256)
    return pool_k, pool_v


paged_append_decode_fp8kv.launches = 0


def paged_append_span_fp8kv(pool_k, pool_v, new_k, new_v, tables, positions,
                            layer: int):
    """11e: :func:`paged_append_span` (T <= 8 rows per sequence) into
    float8_e4m3fn pools, converted in the kernel. Returns (pool_k,
    pool_v)."""
    if not pool_k.is_cuda:
        return paged_append_span_ref(pool_k, pool_v, new_k, new_v, tables,
                                     positions, layer)
    _check_e4m3_pools(pool_k, pool_v, new_k, layer)
    kvn, d = pool_k.shape[2], pool_k.shape[4]
    b, t = new_k.shape[:2]
    if not 1 <= t <= SPAN_MAX:
        raise ValueError(f"a span of {t} rows (the kernel takes 1 to "
                         f"{SPAN_MAX})")
    if b == 0:
        return pool_k, pool_v
    nk, nv = _qrows(new_k, new_v, kvn, d)
    _launch_e4m3("sli_paged_append_span_e4m3", pool_k, pool_v, nk, nv,
                 tables, positions, layer, t, "paged_append_span_fp8kv")
    paged_append_span_fp8kv.launches += 1
    D256_LAUNCHES["paged_append_span_fp8kv"] += int(d == 256)
    return pool_k, pool_v


paged_append_span_fp8kv.launches = 0


def paged_append_prefill_fp8kv(pool_k, pool_v, new_k, new_v, tables,
                               layer: int):
    """2e: :func:`paged_append_prefill` into float8_e4m3fn pools, converted
    in the kernel; rows past S in the last page get code 0. Returns
    (pool_k, pool_v)."""
    if not pool_k.is_cuda:
        return paged_append_prefill_ref(pool_k, pool_v, new_k, new_v, tables,
                                        layer)
    _check_e4m3_pools(pool_k, pool_v, new_k, layer)
    kvn, d = pool_k.shape[2], pool_k.shape[4]
    b, s = new_k.shape[:2]
    if b == 0 or s == 0:
        return pool_k, pool_v
    nk, nv = _qrows(new_k, new_v, kvn, d)
    _launch_e4m3("sli_paged_append_prefill_e4m3", pool_k, pool_v, nk, nv,
                 tables, None, layer, s, "paged_append_prefill_fp8kv")
    paged_append_prefill_fp8kv.launches += 1
    D256_LAUNCHES["paged_append_prefill_fp8kv"] += int(d == 256)
    return pool_k, pool_v


paged_append_prefill_fp8kv.launches = 0


def _qrows(new_k, new_v, kvn, d):
    """New K/V rows for the quantizing and converting kernels: f32 or bf16
    (others go to
    f32, exactly), both of one dtype, [kvN, D] contiguous."""
    dt = (new_k.dtype if new_k.dtype in (torch.float32, torch.bfloat16)
          and new_v.dtype == new_k.dtype else torch.float32)
    return _rows(new_k, kvn, d, dt), _rows(new_v, kvn, d, dt)


def paged_append_decode_quant(pool_k, pool_v, pool_ks, pool_vs, new_k, new_v,
                              tables, positions, layer: int):
    """Quantize one token per sequence (:func:`quantize_kv`) and write its
    int8 rows and scales into the stacked pools in place.

    pool_k/v: [L, P+1, kvN, ps, D] int8; pool_ks/vs: [L, P+1, kvN, ps]
    f32; new_k/v: [B, kvN, D] f32 or bf16; tables: [B, MP] (-1 =
    unmapped, the trash page); positions: [B]. Returns (pool_k, pool_v,
    pool_ks, pool_vs)."""
    check_scale_pools(pool_k, pool_v, pool_ks, pool_vs)
    if not pool_k.is_cuda:
        return paged_append_decode_quant_ref(pool_k, pool_v, pool_ks,
                                             pool_vs, new_k, new_v, tables,
                                             positions, layer)
    _check_quant_pools(pool_k, pool_v, pool_ks, pool_vs, new_k, layer)
    n_layers, p1, kvn, ps, d = pool_k.shape
    b = new_k.shape[0]
    if b == 0:
        return pool_k, pool_v, pool_ks, pool_vs
    nk, nv = _qrows(new_k, new_v, kvn, d)
    tables = _index(tables, b, "tables")
    positions = _index(positions, b, "positions")
    lib = cuda_build.load()
    rc = lib.sli_paged_append_decode_quant(
        pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
        pool_vs.data_ptr(), nk.data_ptr(), nv.data_ptr(), nk.stride(0),
        nv.stride(0), tables.data_ptr(), positions.data_ptr(), layer, p1, kvn,
        ps, d, tables.shape[1], b, cuda_build.dtype_code(nk.dtype),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_append_decode_quant")
    paged_append_decode_quant.launches += 1
    D256_LAUNCHES["paged_append_decode_quant"] += int(d == 256)
    return pool_k, pool_v, pool_ks, pool_vs


paged_append_decode_quant.launches = 0


def paged_append_prefill_quant(pool_k, pool_v, pool_ks, pool_vs, new_k,
                               new_v, tables, layer: int):
    """Quantize a right-padded prompt (:func:`quantize_kv`) and write its
    int8 pages and scale pages in place.

    new_k/v: [B, S, kvN, D] f32 or bf16; ``tables[:, :ceil(S/ps)]`` names
    the target pages (-1: the trash page); rows past S in the last page
    get code 0 and scale 0. Returns (pool_k, pool_v, pool_ks, pool_vs)."""
    check_scale_pools(pool_k, pool_v, pool_ks, pool_vs)
    if not pool_k.is_cuda:
        return paged_append_prefill_quant_ref(pool_k, pool_v, pool_ks,
                                              pool_vs, new_k, new_v, tables,
                                              layer)
    _check_quant_pools(pool_k, pool_v, pool_ks, pool_vs, new_k, layer)
    n_layers, p1, kvn, ps, d = pool_k.shape
    b, s = new_k.shape[:2]
    if b == 0 or s == 0:
        return pool_k, pool_v, pool_ks, pool_vs
    nk, nv = _qrows(new_k, new_v, kvn, d)
    tables = _index(tables, b, "tables")
    lib = cuda_build.load()
    rc = lib.sli_paged_append_prefill_quant(
        pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
        pool_vs.data_ptr(), nk.data_ptr(), nv.data_ptr(), nk.stride(0),
        nk.stride(1), nv.stride(0), nv.stride(1), tables.data_ptr(), layer,
        p1, kvn, ps, d, tables.shape[1], b, s,
        cuda_build.dtype_code(nk.dtype),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_append_prefill_quant")
    paged_append_prefill_quant.launches += 1
    D256_LAUNCHES["paged_append_prefill_quant"] += int(d == 256)
    return pool_k, pool_v, pool_ks, pool_vs


paged_append_prefill_quant.launches = 0


# --- shared-KV pools (absorbed MLA): forms 1l and 2l ----------------------

def _check_shared_pool(pool_k, new_k, layer):
    """A bf16 or f32 shared pool [L, P+1, kvN, ps, D] for 1l and 2l."""
    if pool_k.ndim != 5 or not pool_k.is_contiguous():
        raise ValueError("the pool must be a contiguous [L, P+1, kvN, ps, D]")
    if pool_k.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{pool_k.dtype} shared-KV pools "
                                  f"(INT8/FP8 KV under absorbed MLA)")
    if pool_k.device != new_k.device:
        raise ValueError("the pool and the new rows must share a device")
    if not 0 <= layer < pool_k.shape[0]:
        raise IndexError(f"layer {layer} out of range")


def paged_append_decode_shared_ref(pool_k, new_k, tables, positions,
                                   layer: int):
    """Plain version of :func:`paged_append_decode_shared` (in place)."""
    if pool_k.is_cuda:
        paged_append_decode_shared_ref.cuda_calls += 1
    page, slot = _decode_slots(tables, positions, pool_k.shape[1],
                               pool_k.shape[3])
    pool_k[layer][page, :, slot, :] = new_k.to(pool_k.dtype)
    return pool_k


paged_append_decode_shared_ref.cuda_calls = 0


def paged_append_prefill_shared_ref(pool_k, new_k, tables, layer: int):
    """Plain version of :func:`paged_append_prefill_shared` (in place)."""
    if pool_k.is_cuda:
        paged_append_prefill_shared_ref.cuda_calls += 1
    ps = pool_k.shape[3]
    b, s = new_k.shape[:2]
    npg = -(-s // ps)
    idx = _prefill_pages(tables, b, npg, pool_k.shape[1])
    pool_k[layer].index_copy_(0, idx, _page_chunks(new_k.to(pool_k.dtype),
                                                   npg, ps))
    return pool_k


paged_append_prefill_shared_ref.cuda_calls = 0


def paged_append_decode_shared(pool_k, new_k, tables, positions,
                               layer: int):
    """1l: one latent row per sequence into a shared pool, in place.

    pool_k: [L, P+1, kvN, ps, D] bf16 or f32 (last page = trash); new_k:
    [B, kvN, D]; tables: [B, MP] (-1 = unmapped, the trash page);
    positions: [B]. Returns pool_k."""
    _check_shared_pool(pool_k, new_k, layer)
    if not pool_k.is_cuda:
        return paged_append_decode_shared_ref(pool_k, new_k, tables,
                                              positions, layer)
    _, p1, kvn, ps, d = pool_k.shape
    b = new_k.shape[0]
    if b == 0:
        return pool_k
    nk = _rows(new_k, kvn, d, pool_k.dtype)
    tables = _index(tables, b, "tables")
    positions = _index(positions, b, "positions")
    es = pool_k.element_size()
    lib = cuda_build.load()
    rc = lib.sli_paged_append_decode_shared(
        pool_k.data_ptr(), nk.data_ptr(), nk.stride(0) * es,
        tables.data_ptr(), positions.data_ptr(), layer, p1, kvn, ps, d * es,
        tables.shape[1], b, _vec16(d * es, pool_k, nk, nk.stride(0) * es),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_append_decode_shared")
    paged_append_decode_shared.launches += 1
    return pool_k


paged_append_decode_shared.launches = 0


def prefill_parts(blocks: int, ps: int) -> int:
    """Blocks each page of :func:`paged_append_prefill_shared` takes for a
    grid of ``blocks`` (sequence, page, kv head) tiles: enough for two
    blocks an SM, at most one a row of the page. From shapes alone."""
    from simplellminference_tpu_torch.ops.matmul import SM_COUNT
    return max(1, min(ps, -(-2 * SM_COUNT // max(1, blocks))))


def paged_append_prefill_shared(pool_k, new_k, tables, layer: int):
    """2l: a right-padded prompt's (or chunk's) latent rows into a shared
    pool's pages, in place. new_k: [B, S, kvN, D]; ``tables[:, :ceil(S /
    ps)]`` names the pages (-1: the trash page); rows past S in the last
    page are written as zeros. Each page's rows are cut over
    :func:`prefill_parts` blocks. Returns pool_k."""
    _check_shared_pool(pool_k, new_k, layer)
    if not pool_k.is_cuda:
        return paged_append_prefill_shared_ref(pool_k, new_k, tables, layer)
    _, p1, kvn, ps, d = pool_k.shape
    b, s = new_k.shape[:2]
    if b == 0 or s == 0:
        return pool_k
    nk = _rows(new_k, kvn, d, pool_k.dtype)
    tables = _index(tables, b, "tables")
    es = pool_k.element_size()
    st = (nk.stride(0) * es, nk.stride(1) * es)
    parts = prefill_parts(b * -(-s // ps) * kvn, ps)
    lib = cuda_build.load()
    rc = lib.sli_paged_append_prefill_shared(
        pool_k.data_ptr(), nk.data_ptr(), *st, tables.data_ptr(), layer, p1,
        kvn, ps, d * es, tables.shape[1], b, s, parts,
        _vec16(d * es, pool_k, nk, *st),
        torch.cuda.current_stream(pool_k.device).cuda_stream)
    cuda_build.check(lib, rc, "paged_append_prefill_shared")
    paged_append_prefill_shared.launches += 1
    return pool_k


paged_append_prefill_shared.launches = 0
