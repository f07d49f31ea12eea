"""Fused decode attention input: rmsnorm -> int8 qkv matmul x per-channel
scale -> RoPE on q and k -> k/v appended in place to the paged pools.

Counterpart of simplellminference_tpu/ops/qkv_fused.py:229
(``fused_qkv_append``, kernel ``_kernel`` :37) in its paged form (with
``tables``), and of ``fused_qkv_available`` (:414). For CUDA tensors
:func:`fused_qkv_append` launches the hand-written kernels of one of two
regimes, chosen before the launch by :func:`qkv_regime` and each counted
in :data:`QKV_REGIME_LAUNCHES` (every form together; each form's wrapper
counts its own calls in ``launches``): ``mma`` (bf16 activations, H a
multiple of 64 and the qkv columns of 128: ``csrc/qkv_fused_mma.cu``, the
rmsnorm once, then the product on the bf16 tensor cores with all rows in
one weight pass, K split over blocks by :func:`qkv_split` and the tail in
the last block at a column tile) and ``fma`` (the rest, f32 activations
among them: ``csrc/qkv_fused.cu``, f32 FMAs, 8 rows at a time). For CPU
tensors it runs :func:`fused_qkv_append_ref`, which is also what the
kernels are held against on the card.

Rounding: the TPU kernel rounds x and the normalized rows to bf16
whatever the activation dtype (qkv_fused.py:264, :76-77). Here both
versions round the normalized rows to the activation dtype (x's) and keep
f32 from there on: q is rounded to x's dtype, k/v to the pool dtype. With
bf16 activations that is the TPU kernel's math; with f32 ones nothing is
rounded, as on the JAX package's CPU path.

The quantizing form (``cache_ks``/``cache_vs``, INT8 KV; qkv_fused.py:
139-151, :176-184): the rotated k and the v rows are rounded to the
activation dtype (the TPU kernel rounds them to bf16, as its unfused path
does through ``apply_rope``), then quantized per (token, kv head) with
``quantize_kv``'s math, and the codes and the scale are written to the
page slot. On the card it is its own wrapper,
:func:`fused_qkv_append_int8kv`, with its own launch count. At head_dim
256 (Gemma over INT8 KV) a head's columns lie in two column blocks of
either kernel, so the blocks leave the rounded k/v rows in an f32 scratch
[B, 2 kvN, D] and a further small launch quantizes whole heads from it.

The FP8-KV form (float8_e4m3fn pools, paged, no scale pools): k/v are
rounded from f32 to e4m3 once, with the JAX package's rounding
(:func:`~simplellminference_tpu_torch.ops.ref_ops.to_e4m3`), as the TPU
kernel rounds its f32 rows into slabs of the pool dtype
(qkv_fused.py:155-158, :370-371); on the card it is its own wrapper,
:func:`fused_qkv_append_fp8kv` (6e), with its own launch count. The pool
dtype goes to the kernels as its own code (``cuda_build.pool_code``),
apart from the activation dtype. With a ``kv_layer`` (6ek: the grouped
engine's e4m3 ring pools) it is the same wrapper, its launches with a
kv_layer also in :data:`KV_LAYER_LAUNCHES`. On an e4m3 dense arena
(``tables=None``, 6de) it is the same wrapper again, k/v rounded from f32
to e4m3 once as the JAX dense form rounds them into its window slabs
(qkv_fused.py:155-158, :370-371), its dense launches also in
:data:`DENSE_LAUNCHES`. At head_dim 256 (Gemma over FP8 KV, 6e/256,
6ek/256 and 6de/256) a head's columns lie in two column blocks, as for
6q/256, but each element rounds to e4m3 on its own, so each block writes
the codes of its own columns and no further launch is needed.

Pools are [L, P+1, kvN, ps, D] and are written in place; an unmapped (-1)
page, or a position past the table, writes to the trash page (the last
page row), as :func:`~simplellminference_tpu_torch.ops.paged_append.
paged_append_decode` does.

The dense-arena form (``tables=None``; qkv_fused.py:302-304): the
"pools" are the dense arena [L, B', kvN, Smax, D] with B' >= B rows, x
row b writes arena row b at slot ``offsets[b]``, and a slot outside
[0, Smax) is dropped (:func:`~simplellminference_tpu_torch.ops.kv_append.
kv_append`'s rule). The rounding is the paged form's. On the card it is
its own wrapper, :func:`fused_qkv_append_dense`, with its own launch
count over bf16/f32 arenas (an e4m3 arena goes to the FP8-KV form, 6de);
its quantizing (INT8-KV) form stays paged-only and raises, as the JAX
wrapper asserts (qkv_fused.py:291-292): the JAX dense arena has no scale
pools.

The ``kv_layer`` form (qkv_fused.py:294-299, the grouped engine's ring
pools): the pools are indexed by ``kv_layer`` (the windowed group's local
layer) while the weights and the norm keep the global ``layer``. The
kernel indexes the pools only by the layer it is given, so the form needs
no kernel change; over bf16/f32 pools it is its own wrapper,
:func:`fused_qkv_append_kv_layer` (6k), with its own launch count, and
the quantizing and FP8-KV wrappers take ``kv_layer`` too (INT8 and e4m3
ring pools). The dense arena has no caller with a kv_layer and raises for
one.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.ffn_fused import ffn_split
from simplellminference_tpu_torch.ops.kv_append import kv_append_ref
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.ops.paged_append import (
    _check_e4m3_pools, _check_pools, _check_quant_pools, _index,
    check_scale_pools, paged_append_decode_quant_ref,
    paged_append_decode_ref)
from simplellminference_tpu_torch.ops.ref_ops import E4M3

MAX_ROWS = 64
HEAD_DIMS = (32, 64, 128, 256)
# launches of each regime at head_dim 256, the forms together (each also
# counts in QKV_REGIME_LAUNCHES), and there of the kv_layer form (6k:
# Gemma-2's grouped pools), of the quantizing form (6q/256) and of the
# FP8-KV form (6e/256), those of the last two with a kv_layer (INT8 and
# e4m3 ring pools) apart too, and those of the FP8-KV form on the dense
# arena (6de/256)
D256_LAUNCHES = {"mma": 0, "fma": 0}
D256_FORM_LAUNCHES = {"fused_qkv_append_kv_layer": 0,
                      "fused_qkv_append_int8kv": 0,
                      "fused_qkv_append_int8kv_kv_layer": 0,
                      "fused_qkv_append_fp8kv": 0,
                      "fused_qkv_append_fp8kv_kv_layer": 0,
                      "fused_qkv_append_fp8kv_dense": 0}
# launches of the FP8-KV form with a kv_layer (6ek: e4m3 ring pools), each
# also in the form's own count
KV_LAYER_LAUNCHES = {"fused_qkv_append_fp8kv": 0}
# launches of the FP8-KV form on the dense arena (6de: an e4m3 arena,
# tables=None), each also in the form's own count
DENSE_LAUNCHES = {"fused_qkv_append_fp8kv": 0}
MMA_KT = 64               # K rows a stage of the tensor-core kernel
MMA_COLS = 128            # qkv columns a block of it: whole heads
MMA_MAX_TILES = 4096      # most column tiles (its arrival counters)
# launches of each regime's kernels, the four forms together
QKV_REGIME_LAUNCHES = {"mma": 0, "fma": 0}


def qkv_regime(m: int, h: int, nq: int, d: int, dtype) -> str:
    """The kernels of a fused qkv append of ``m`` rows (m <= 64) at hidden
    size ``h`` into ``nq`` qkv columns of heads of ``d``, from dtype and
    shape alone: "mma" (the bf16 tensor cores) for bf16 activations with H
    a multiple of the 64-row stage and Nq of the 128-column block (whole
    heads a block at D 32, 64 and 128, so every RoPE pair and every INT8-KV
    head stays in one block; at D 256 two 64-column runs of one head, 128
    apart, so the pairs still do); "fma" (f32 FMAs) otherwise: the port
    never rounds f32 activations to bf16."""
    if (dtype == torch.bfloat16 and m <= MAX_ROWS and d in HEAD_DIMS
            and h % MMA_KT == 0 and nq % MMA_COLS == 0
            and nq // MMA_COLS <= MMA_MAX_TILES):
        return "mma"
    return "fma"


def qkv_split(m: int, h: int, tiles: int) -> int:
    """H rows a block of the tensor-core qkv kernel takes over ``tiles``
    128-column tiles: the rule of the FFN's products
    (:func:`~simplellminference_tpu_torch.ops.ffn_fused.ffn_split`), whose
    launch bounds and finish the kernel shares: 64-row stages while the
    grid fits the blocks the card holds at once, at most 8 ranges of at
    least 256 rows. 7B (96 tiles, m 8): 5 ranges; Mistral-7B (48): 8."""
    return ffn_split(m, h, tiles)


def _check(x, pool_k, pool_v, tables, cache_ks, cache_vs, kv_layer,
           layer) -> bool:
    """Raise for the forms not ported; True for the quantizing form
    (scale pools given and checked)."""
    if tables is None and (cache_ks is not None or cache_vs is not None):
        raise NotImplementedError("INT8 KV on a dense KV arena (tables="
                                  "None): the quantizing append is a "
                                  "paged-pool path")
    if (tables is None and kv_layer is not None
            and int(kv_layer) != int(layer)):
        raise NotImplementedError("kv_layer apart from the weight layer on "
                                  "a dense KV arena (tables=None)")
    if x.ndim != 2:
        raise ValueError(f"x must be [B, H], got {tuple(x.shape)}")
    if cache_ks is None and cache_vs is None:
        return False
    check_scale_pools(pool_k, pool_v, cache_ks, cache_vs)
    return True


def _heads(wq, pool_k, n_heads, kv_heads):
    nq = wq.shape[-1]
    kvn, d = pool_k.shape[2], pool_k.shape[4]
    kvh = kv_heads if kv_heads is not None else kvn
    n = n_heads if n_heads is not None else nq // d - 2 * kvh
    if (n + 2 * kvh) * d != nq or kvh != kvn:
        raise ValueError(f"{n} + 2 x {kvh} heads of {d} do not make the "
                         f"{nq} qkv columns over {kvn} pool heads")
    return n, kvh, d


def fused_qkv_append_ref(x, norm_w, wq, ws, sin, cos, pool_k, pool_v,
                         layer: int, offsets, n_heads: int | None = None,
                         kv_heads: int | None = None, eps: float = 1e-5,
                         tables=None, cache_ks=None, cache_vs=None,
                         kv_layer=None):
    """Plain version of :func:`fused_qkv_append` (pools in place, at
    ``kv_layer`` when given)."""
    if x.is_cuda:
        fused_qkv_append_ref.cuda_calls += 1
    quant = _check(x, pool_k, pool_v, tables, cache_ks, cache_vs, kv_layer,
                   layer)
    kli = layer if kv_layer is None else int(kv_layer)
    n, kvn, d = _heads(wq, pool_k, n_heads, kv_heads)
    b = x.shape[0]
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    nw = norm_w[layer].reshape(-1).float()
    xn = (xf * inv * nw).to(x.dtype)
    qkv = ref_ops.quantized_matmul_ref(xn, wq[layer],
                                       ws[layer].reshape(1, -1),
                                       out_dtype=torch.float32)
    half = d // 2
    s, c = sin.float()[:, None, :], cos.float()[:, None, :]

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

    q = rope(qkv[:, :n * d].reshape(b, n, d))
    k = rope(qkv[:, n * d:(n + kvn) * d].reshape(b, kvn, d))
    v = qkv[:, (n + kvn) * d:].reshape(b, kvn, d)
    if quant:
        paged_append_decode_quant_ref(pool_k, pool_v, cache_ks, cache_vs,
                                      k.to(x.dtype), v.to(x.dtype), tables,
                                      offsets, kli)
        return q.to(x.dtype), pool_k, pool_v, cache_ks, cache_vs
    if tables is None:
        kv_append_ref(pool_k, pool_v, k[:, None], v[:, None], kli, offsets)
    else:
        paged_append_decode_ref(pool_k, pool_v, k, v, tables, offsets, kli)
    return q.to(x.dtype), pool_k, pool_v


fused_qkv_append_ref.cuda_calls = 0


def fused_qkv_append(x, norm_w, wq, ws, sin, cos, pool_k, pool_v,
                     layer: int, offsets, n_heads: int | None = None,
                     kv_heads: int | None = None, eps: float = 1e-5,
                     tables=None, cache_ks=None, cache_vs=None,
                     kv_layer=None):
    """x: [B, H] (B <= 64, the residual stream); norm_w: [L, H] (or
    [L, 1, H]); wq: [L, H, (N + 2 kvN) D] int8 with per-channel ws
    [L, 1, (N + 2 kvN) D] f32; sin/cos: [B, D/2]; pool_k/v: [L, P+1, kvN,
    ps, D] with tables [B, MP], or (``tables=None``) the dense arena
    [L, B', kvN, Smax, D], B' >= B; layer: int; offsets: [B] write
    positions.
    Returns (q [B, N, D] rotated, in x's dtype; pool_k; pool_v), the new
    k/v rows already written in place. With the scale pools
    ``cache_ks``/``cache_vs`` [L, P+1, kvN, ps] f32 of int8 pools, k/v
    are quantized into them and (q, pool_k, pool_v, cache_ks, cache_vs)
    come back. ``kv_layer``: the pool layer, when it is not ``layer``
    (the grouped engine's ring pools)."""
    quant = _check(x, pool_k, pool_v, tables, cache_ks, cache_vs, kv_layer,
                   layer)
    if not x.is_cuda:
        return fused_qkv_append_ref(x, norm_w, wq, ws, sin, cos, pool_k,
                                    pool_v, layer, offsets, n_heads,
                                    kv_heads, eps, tables, cache_ks,
                                    cache_vs, kv_layer)
    if quant:
        return fused_qkv_append_int8kv(x, norm_w, wq, ws, sin, cos, pool_k,
                                       pool_v, cache_ks, cache_vs, layer,
                                       offsets, n_heads, kv_heads, eps,
                                       tables, kv_layer)
    if pool_k.dtype == E4M3:
        return fused_qkv_append_fp8kv(x, norm_w, wq, ws, sin, cos, pool_k,
                                      pool_v, layer, offsets, tables,
                                      n_heads, kv_heads, eps, kv_layer)
    if tables is None:
        return fused_qkv_append_dense(x, norm_w, wq, ws, sin, cos, pool_k,
                                      pool_v, layer, offsets, n_heads,
                                      kv_heads, eps)
    if kv_layer is not None:
        return fused_qkv_append_kv_layer(x, norm_w, wq, ws, sin, cos, pool_k,
                                         pool_v, layer, kv_layer, offsets,
                                         tables, n_heads, kv_heads, eps)
    _check_pools(pool_k, pool_v, x, layer)
    q = _launch(x, norm_w, wq, ws, sin, cos, pool_k, pool_v, None, None,
                layer, layer, offsets, n_heads, kv_heads, eps, tables,
                "fused_qkv_append")
    fused_qkv_append.launches += 1
    return q, pool_k, pool_v


fused_qkv_append.launches = 0


def fused_qkv_append_kv_layer(x, norm_w, wq, ws, sin, cos, pool_k, pool_v,
                              layer: int, kv_layer: int, offsets, tables,
                              n_heads: int | None = None,
                              kv_heads: int | None = None,
                              eps: float = 1e-5):
    """The kv_layer form of :func:`fused_qkv_append` (6k): weights and
    norm of ``layer``, k/v written into the bf16/f32 pools at
    ``kv_layer``. Returns (q, pool_k, pool_v)."""
    if not x.is_cuda:
        return fused_qkv_append_ref(x, norm_w, wq, ws, sin, cos, pool_k,
                                    pool_v, layer, offsets, n_heads,
                                    kv_heads, eps, tables, kv_layer=kv_layer)
    _check(x, pool_k, pool_v, tables, None, None, kv_layer, layer)
    _check_pools(pool_k, pool_v, x, int(kv_layer))
    q = _launch(x, norm_w, wq, ws, sin, cos, pool_k, pool_v, None, None,
                layer, int(kv_layer), offsets, n_heads, kv_heads, eps, tables,
                "fused_qkv_append_kv_layer")
    fused_qkv_append_kv_layer.launches += 1
    D256_FORM_LAUNCHES["fused_qkv_append_kv_layer"] += int(
        pool_k.shape[-1] == 256)
    return q, pool_k, pool_v


fused_qkv_append_kv_layer.launches = 0


def fused_qkv_append_fp8kv(x, norm_w, wq, ws, sin, cos, pool_k, pool_v,
                           layer: int, offsets, tables,
                           n_heads: int | None = None,
                           kv_heads: int | None = None, eps: float = 1e-5,
                           kv_layer=None):
    """The FP8-KV form of :func:`fused_qkv_append` (6e): k/v rounded from
    f32 to e4m3 into the float8_e4m3fn pools, at ``kv_layer`` when given
    (6ek: e4m3 ring pools), or with ``tables=None`` into an e4m3 dense
    arena [L, B', kvN, Smax, D], B <= B' (6de). Returns (q, pool_k,
    pool_v)."""
    if not x.is_cuda:
        return fused_qkv_append_ref(x, norm_w, wq, ws, sin, cos, pool_k,
                                    pool_v, layer, offsets, n_heads,
                                    kv_heads, eps, tables, kv_layer=kv_layer)
    _check(x, pool_k, pool_v, tables, None, None, kv_layer, layer)
    kli = layer if kv_layer is None else int(kv_layer)
    _check_e4m3_pools(pool_k, pool_v, x, kli)
    dense = tables is None
    if dense and x.shape[0] > pool_k.shape[1]:
        raise ValueError(f"{x.shape[0]} rows for an arena of "
                         f"{pool_k.shape[1]} rows")
    q = _launch(x, norm_w, wq, ws, sin, cos, pool_k, pool_v, None, None,
                layer, kli, offsets, n_heads, kv_heads, eps, tables,
                "fused_qkv_append_fp8kv")
    fused_qkv_append_fp8kv.launches += 1
    KV_LAYER_LAUNCHES["fused_qkv_append_fp8kv"] += int(kv_layer is not None)
    DENSE_LAUNCHES["fused_qkv_append_fp8kv"] += int(dense)
    if pool_k.shape[-1] == 256:
        D256_FORM_LAUNCHES["fused_qkv_append_fp8kv"] += 1
        D256_FORM_LAUNCHES["fused_qkv_append_fp8kv_kv_layer"] += int(
            kv_layer is not None)
        D256_FORM_LAUNCHES["fused_qkv_append_fp8kv_dense"] += int(dense)
    return q, pool_k, pool_v


fused_qkv_append_fp8kv.launches = 0


def fused_qkv_append_dense(x, norm_w, wq, ws, sin, cos, cache_k, cache_v,
                           layer: int, offsets, n_heads: int | None = None,
                           kv_heads: int | None = None, eps: float = 1e-5):
    """The dense-arena form of :func:`fused_qkv_append` (``tables=None``):
    x [B, H] into the arena [L, B', kvN, Smax, D], B <= B', row b at slot
    ``offsets[b]``; an e4m3 arena takes the FP8-KV form (6de). Returns
    (q, cache_k, cache_v)."""
    if cache_k.dtype == E4M3:
        return fused_qkv_append_fp8kv(x, norm_w, wq, ws, sin, cos, cache_k,
                                      cache_v, layer, offsets, None, n_heads,
                                      kv_heads, eps)
    if not x.is_cuda:
        return fused_qkv_append_ref(x, norm_w, wq, ws, sin, cos, cache_k,
                                    cache_v, layer, offsets, n_heads,
                                    kv_heads, eps)
    _check(x, cache_k, cache_v, None, None, None, None, layer)
    _check_pools(cache_k, cache_v, x, layer)
    if x.shape[0] > cache_k.shape[1]:
        raise ValueError(f"{x.shape[0]} rows for an arena of "
                         f"{cache_k.shape[1]} rows")
    q = _launch(x, norm_w, wq, ws, sin, cos, cache_k, cache_v, None, None,
                layer, layer, offsets, n_heads, kv_heads, eps, None,
                "fused_qkv_append_dense")
    fused_qkv_append_dense.launches += 1
    return q, cache_k, cache_v


fused_qkv_append_dense.launches = 0


def fused_qkv_append_int8kv(x, norm_w, wq, ws, sin, cos, pool_k, pool_v,
                            cache_ks, cache_vs, layer: int, offsets,
                            n_heads: int | None = None,
                            kv_heads: int | None = None, eps: float = 1e-5,
                            tables=None, kv_layer=None):
    """The quantizing form of :func:`fused_qkv_append` (INT8 KV): int8
    pools with their f32 scale pools, written at ``kv_layer`` when given
    (INT8 ring pools). Returns (q, pool_k, pool_v, cache_ks, cache_vs)."""
    if not x.is_cuda:
        return fused_qkv_append_ref(x, norm_w, wq, ws, sin, cos, pool_k,
                                    pool_v, layer, offsets, n_heads,
                                    kv_heads, eps, tables, cache_ks,
                                    cache_vs, kv_layer)
    _check(x, pool_k, pool_v, tables, cache_ks, cache_vs, kv_layer, layer)
    kli = layer if kv_layer is None else int(kv_layer)
    _check_quant_pools(pool_k, pool_v, cache_ks, cache_vs, x, kli)
    q = _launch(x, norm_w, wq, ws, sin, cos, pool_k, pool_v, cache_ks,
                cache_vs, layer, kli, offsets, n_heads, kv_heads, eps, tables,
                "fused_qkv_append_int8kv")
    fused_qkv_append_int8kv.launches += 1
    if pool_k.shape[-1] == 256:
        D256_FORM_LAUNCHES["fused_qkv_append_int8kv"] += 1
        D256_FORM_LAUNCHES["fused_qkv_append_int8kv_kv_layer"] += int(
            kv_layer is not None)
    return q, pool_k, pool_v, cache_ks, cache_vs


fused_qkv_append_int8kv.launches = 0


def _launch(x, norm_w, wq, ws, sin, cos, pool_k, pool_v, cache_ks, cache_vs,
            layer, kv_layer, offsets, n_heads, kv_heads, eps, tables, what):
    n, kvn, d = _heads(wq, pool_k, n_heads, kv_heads)
    b, h = x.shape
    n_layers, p1, _, ps, _ = pool_k.shape
    if b > MAX_ROWS:
        raise ValueError(f"fused_qkv_append takes at most {MAX_ROWS} rows")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} (kernel takes {HEAD_DIMS})")
    nq = wq.shape[-1]
    if (wq.dtype != torch.int8 or wq.ndim != 3 or wq.shape[1] != h
            or not wq.is_contiguous() or ws.numel() != wq.shape[0] * nq):
        raise ValueError("wq must be a contiguous [L, H, Nq] int8 weight "
                         "with [L, 1, Nq] scales")
    out = torch.empty((b, n, d), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    xc = x if x.stride(-1) == 1 else x.contiguous()
    nw = norm_w[layer].reshape(-1).contiguous()
    if nw.dtype not in (torch.float32, torch.bfloat16) or nw.numel() != h:
        raise ValueError("norm weight must be [L, H] f32 or bf16")
    wl = wq[layer]
    sl = ws[layer].reshape(-1).to(torch.float32).contiguous()
    sin = sin.to(torch.float32).contiguous()
    cos = cos.to(torch.float32).contiguous()
    if sin.shape != (b, d // 2) or cos.shape != (b, d // 2):
        raise ValueError("sin/cos must be [B, D/2]")
    offsets = _index(offsets, b, "offsets")
    if tables is not None:
        tables = _index(tables, b, "tables")
    regime = qkv_regime(b, h, nq, d, x.dtype)
    # INT8 KV at D 256: the blocks' rounded k/v rows for the quantizing
    # launch (a head's columns lie in two blocks)
    kv_rows = (torch.empty((b, 2 * kvn, d), dtype=torch.float32,
                           device=x.device)
               if cache_ks is not None and d == 256 else None)
    kv_rows_p = 0 if kv_rows is None else kv_rows.data_ptr()
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if regime == "mma":
        # the 16-byte copies and the tail's vector loads
        wl, sl, sin, cos = (t if t.data_ptr() % 16 == 0 else t.clone()
                            for t in (wl, sl, sin, cos))
        kch = qkv_split(b, h, nq // MMA_COLS)
        chunks = -(-h // kch)
        work = torch.empty((chunks * b * nq if chunks > 1 else 0,),
                           dtype=torch.float32, device=x.device)
        xn = torch.empty((b, h), dtype=x.dtype, device=x.device)
        rc = lib.sli_qkv_fused_mma(
            xc.data_ptr(), xc.stride(0), nw.data_ptr(),
            int(nw.dtype == torch.bfloat16), wl.data_ptr(), sl.data_ptr(),
            sin.data_ptr(), cos.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), 0 if cache_ks is None else cache_ks.data_ptr(),
            0 if cache_vs is None else cache_vs.data_ptr(),
            cuda_build.pool_code(pool_k.dtype), out.data_ptr(),
            0 if tables is None else tables.data_ptr(), offsets.data_ptr(),
            kv_layer, p1, kvn, ps, 1 if tables is None else tables.shape[1],
            b, h, n, d, float(eps), xn.data_ptr(),
            work.data_ptr() if chunks > 1 else 0, kch, kv_rows_p, stream)
        cuda_build.check(lib, rc, f"{what} (mma)")
        QKV_REGIME_LAUNCHES["mma"] += 1
        D256_LAUNCHES["mma"] += int(d == 256)
        return out
    vec = int(nq % 16 == 0 and wl.data_ptr() % 16 == 0)
    if tables is None:
        rc = lib.sli_qkv_fused_dense(
            xc.data_ptr(), xc.stride(0), nw.data_ptr(),
            int(nw.dtype == torch.bfloat16), wl.data_ptr(), sl.data_ptr(),
            sin.data_ptr(), cos.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), cuda_build.pool_code(pool_k.dtype),
            out.data_ptr(), offsets.data_ptr(), layer, p1, kvn, ps, b, h, n,
            d, float(eps), cuda_build.dtype_code(x.dtype), vec, stream)
        cuda_build.check(lib, rc, f"{what} (fma)")
        QKV_REGIME_LAUNCHES["fma"] += 1
        D256_LAUNCHES["fma"] += int(d == 256)
        return out
    rc = lib.sli_qkv_fused(
        xc.data_ptr(), xc.stride(0), nw.data_ptr(),
        int(nw.dtype == torch.bfloat16), wl.data_ptr(), sl.data_ptr(),
        sin.data_ptr(), cos.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        0 if cache_ks is None else cache_ks.data_ptr(),
        0 if cache_vs is None else cache_vs.data_ptr(),
        cuda_build.pool_code(pool_k.dtype), out.data_ptr(),
        tables.data_ptr(), offsets.data_ptr(), kv_layer, p1, kvn, ps,
        tables.shape[1], b, h, n, d, float(eps),
        cuda_build.dtype_code(x.dtype), vec, kv_rows_p, stream)
    cuda_build.check(lib, rc, f"{what} (fma)")
    QKV_REGIME_LAUNCHES["fma"] += 1
    D256_LAUNCHES["fma"] += int(d == 256)
    return out


def fused_qkv_available(lw, cfg, b: int, s: int, cache_k,
                        n_heads: int | None = None,
                        kv_heads: int | None = None) -> bool:
    """The gates of simplellminference_tpu/ops/qkv_fused.py:414 without its
    TPU VMEM tiling (``qkv_tiles``): decode (S == 1), B <= 64, a stacked
    per-channel 8-bit ``wqkv`` with no bias, stacked 5-d pools or dense
    arena and a head split that makes the qkv columns."""
    w = lw.get("wqkv")
    if "wqkv_bias" in lw or s != 1 or b > MAX_ROWS:
        return False
    if not (isinstance(w, QuantizedWeight) and w.q.ndim == 3
            and w.scales.shape[-2] == 1 and w.bits == 8):
        return False
    if cache_k is None or cache_k.ndim != 5:
        return False
    n = n_heads if n_heads is not None else cfg.num_heads
    kv = kv_heads if kv_heads is not None else cfg.num_kv_heads
    return (n + 2 * kv) * cfg.head_dim == w.q.shape[-1]
