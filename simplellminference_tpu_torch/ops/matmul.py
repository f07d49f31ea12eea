"""Quantized-weight products: weight-only INT8 and INT4, and W8A8.

Counterparts of simplellminference_tpu/ops/matmul.py, one layer of a
stacked [L, K, N] weight or a plain [K, N] one, for any M and N:

* :func:`quantized_matmul` (:522, kernel ``_qmm_kernel`` :69), 8-bit
  weights with per-output-channel ([.., 1, N]) or per-group ([.., K/G,
  N]) f32 scales, any K; with ``bits=4`` it routes to
* :func:`quantized_matmul_int4` (``_quantized_matmul_int4`` :354, kernel
  ``_qmm4_kernel``): split-half packed 4-bit weights [.., K/2, N] (row i
  in the low nibble, row i + K/2 in the high one), and its zero-point
  form :func:`quantized_matmul_int4_zs` (AWQ/GPTQ: w = q * s - zs), four
  kernels chosen by :func:`int4_regime` and counted in
  :data:`INT4_REGIME_LAUNCHES`;
* :func:`quantized_matmul_w8a8` (:232, kernel ``_qmm_w8a8_kernel``):
  activations quantized per token to int8 by
  :func:`quantize_activations_int8` (:219; torch ops, outside the kernel
  as in the reference), int32 dots against int8 weights; two kernels
  chosen by :func:`w8a8_regime` and counted in
  :data:`W8A8_REGIME_LAUNCHES`.

For CUDA tensors each wrapper launches its hand-written kernel
(``csrc/quantized_matmul.cu``, ``csrc/quantized_matmul_int4*.cu``,
``csrc/quantized_matmul_w8a8*.cu``) and counts the launch; for CPU tensors
it runs its plain version (``*_ref``), which is also what the kernels are
held against on the card. The 8-bit product has four kernels, one per
regime, chosen before the launch by :func:`tiled_regime` and each with
its own count in :data:`REGIME_LAUNCHES` (``quantized_matmul.launches``
counts every call): ``rmma`` (M <= 8 with bf16 activations, per-channel
scales, K and N multiples of 64: mma.sync on bf16 tensor cores, all rows
in one weight pass, ``csrc/quantized_matmul_rows_mma.cu``), ``rows`` (the
other M <= 8 products, bytes-bound: f32 FMAs streaming the weight),
``mma`` (M > 8 with bf16 activations: bf16 tensor cores by wgmma,
``csrc/quantized_matmul_mma.cu``) and ``fma`` (the rest: f32 activations,
scale groups off a multiple of 64 rows, K off a multiple of 8 or N of 16:
a shared-memory tiled f32 FMA kernel). The INT4 product has four, by
:func:`int4_regime` in :data:`INT4_REGIME_LAUNCHES`: ``mma`` (M <= 8,
bf16 activations: mma.sync on bf16 tensor cores,
``csrc/quantized_matmul_int4_mma.cu``), ``wgmma`` (M > 8, bf16
activations: ``csrc/quantized_matmul_int4_wgmma.cu``), and the f32 FMA
kernels ``rows`` and ``tiled`` (``csrc/quantized_matmul_int4.cu``) for the
rest. The W8A8 product has two, by :func:`w8a8_regime` in
:data:`W8A8_REGIME_LAUNCHES`: ``wgmma`` (the int8 tensor cores,
``csrc/quantized_matmul_w8a8_wgmma.cu``) and ``dp4a`` (the rest,
``csrc/quantized_matmul_w8a8.cu``).

Rounding: the TPU kernels round x to bf16 whatever its dtype
(matmul.py:565). Here x is used in its own dtype (the activation dtype)
and the products and sums stay f32 until the one rounding to
``out_dtype``: with bf16 activations that is the TPU kernel's math, with
f32 ones the JAX package's CPU math. Every K is exact: the TPU wrapper's K
tile drops a K % 128 remainder (matmul.py:583-584) and its INT4 wrapper
sends K/2 or N off a multiple of 128 to the jnp reference (:382-398);
nothing here does either.

Not ported: ``n_start``/``n_size`` (the ring collective matmul), which
raise.
"""

from __future__ import annotations

import math

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops

SM_COUNT = 132            # H100 SXM: K splits aim at two blocks per SM
ROWS_MAX_M = 8            # up to this many rows: the few-rows kernel
ROWS_COLS = 256           # output columns per block of that kernel
ROWS_MIN_K = 256          # smallest K range a block of it takes
MMA_BN = 128              # output columns per block of the mma kernel
MMA_BK = 64               # its K slab: K splits fall on slab edges
MMA_MIN_K = 256           # smallest K range a block of it takes
ROWS_MMA_KT = 64          # K rows a stage of the few-rows tensor-core kernel
ROWS_MMA_COLS = 128       # its output columns a block
ROWS_MMA_RES = 4          # its blocks an SM holds (launch bounds)
ROWS_MMA_MAX_SPLIT = 8    # most K ranges it splits a product into
ROWS_MMA_MIN_K = 256      # fewest K rows a block of it takes
ROWS_MMA_MAX_TILES = 4096  # most column tiles (its arrival counters)
# launches of each 8-bit regime's kernel (quantized_matmul counts them all)
REGIME_LAUNCHES = {"rows": 0, "rmma": 0, "mma": 0, "fma": 0}
INT4_KP = 64              # packed rows a stage of the INT4 tensor-core kernels
INT4_MIN_KP = 256         # fewest packed rows a block of them takes
INT4_MMA_COLS = 128       # output columns a block of the few-rows one
# launches of each INT4 regime's kernel, both forms together (the wrappers
# quantized_matmul_int4 and quantized_matmul_int4_zs count each form's)
INT4_REGIME_LAUNCHES = {"mma": 0, "wgmma": 0, "rows": 0, "tiled": 0}
W8A8_BK = 128             # K slab of the W8A8 tensor-core kernel (bytes)
W8A8_MIN_K = 512          # smallest K range a block of it takes
# launches of each W8A8 regime's kernel (quantized_matmul_w8a8 counts all)
W8A8_REGIME_LAUNCHES = {"wgmma": 0, "dp4a": 0}


def tiled_regime(m: int, k: int, n: int, group: int, dtype) -> str:
    """The kernel of an 8-bit product of ``m`` rows x [k, n] weights with
    scale groups of ``group`` rows (``k``: per output channel), from dtype
    and shape alone. For m <= 8: "rmma" (mma.sync on bf16 tensor cores) for
    bf16 activations, per-channel scales and K and N multiples of 64 (its
    64-row stages and 64-column groups), else "rows" (f32 FMAs): f32
    activations, which the port never rounds, and grouped scales, which
    would need a scale flush a stage inside the header's k loop. Above 8
    rows: "mma" (bf16 tensor cores, wgmma) for bf16 activations with K a
    multiple of 8, N of 16 and groups per channel or of a multiple of its
    64-row K slab; "fma" otherwise."""
    if m <= ROWS_MAX_M:
        if (dtype == torch.bfloat16 and group >= k and k % ROWS_MMA_KT == 0
                and n % 64 == 0
                and -(-n // ROWS_MMA_COLS) <= ROWS_MMA_MAX_TILES):
            return "rmma"
        return "rows"
    if (dtype == torch.bfloat16 and k % 8 == 0 and n % 16 == 0
            and (group >= k or group % MMA_BK == 0)):
        return "mma"
    return "fma"


def int4_regime(m: int, kp: int, n: int, group: int, dtype) -> str:
    """The kernel of an INT4 product of ``m`` rows x split-half packed
    [kp, n] weights with scale groups of ``group`` logical rows (``2 *
    kp``: per output channel), from dtype and shape alone.

    The tensor-core kernels take bf16 activations (the port never rounds
    activations: f32 ones keep the f32 FMA kernels, as the f32 forms of
    kernels 3 and 8 do), N a multiple of 16 (their 16-byte copies of the
    packed rows), K/2 a multiple of their 64-row stage, and per-channel
    scales or groups of a multiple of 64 rows (a k-step must lie in one
    group: groups of 32, or 30 and 200 off a multiple of 64, do not). Of
    those, "mma" (mma.sync) takes m <= 8, "wgmma" the rest; every other
    product takes the FMA kernels, "rows" for m <= 8, else "tiled"."""
    few = m <= ROWS_MAX_M
    if (dtype == torch.bfloat16 and n % 16 == 0 and kp % INT4_KP == 0
            and (group >= 2 * kp or group % INT4_KP == 0)):
        return "mma" if few else "wgmma"
    return "rows" if few else "tiled"


def w8a8_regime(m: int, k: int, n: int, group: int) -> str:
    """The kernel of a W8A8 product of ``m`` rows x [k, n] int8 weights
    with scale groups of ``group`` rows (``k``: per output channel), from
    shape alone (x is quantized to int8 whatever its dtype, so f32
    activations take the tensor cores too): "wgmma" (the int8 tensor
    cores) for K and N multiples of 16 (its 16-byte copies) and
    per-channel scales or groups of a multiple of its 128-row K slab;
    "dp4a" (the integer pipes) otherwise."""
    del m                     # every row count: rows past M are zero-filled
    if k % 16 == 0 and n % 16 == 0 and (group >= k or group % W8A8_BK == 0):
        return "wgmma"
    return "dp4a"


def w8a8_split(m: int, k: int, n: int, group: int) -> tuple[int, int]:
    """(warpgroups along M, K rows per block) of the W8A8 tensor-core
    kernel: 256-row tiles from m = 256 with per-channel scales (four
    warpgroups: a weight slab's copies and transpose serve more rows),
    128-row tiles from m = 128, else 64-row tiles, one block an SM (its
    ring takes up to 225 KB); K is split on slab (and, grouped, group)
    edges while the tiles leave whole SMs idle, each block taking at least
    512 rows. The 7B wqkv at M 128 (96 column tiles) stays whole: a split
    into two would run 192 half blocks in 1.45 waves, no sooner."""
    wm = 4 if m >= 256 and group >= k else 2 if m >= 128 else 1
    tiles = -(-n // MMA_BN) * -(-m // (64 * wm))
    chunks = max(1, min(SM_COUNT // tiles, k // W8A8_MIN_K))
    unit = W8A8_BK if group >= k else math.lcm(W8A8_BK, group)
    per = -(-k // chunks)
    return wm, -(-per // unit) * unit


def int4_mma_split(kp: int, n: int) -> int:
    """Packed rows a block of the INT4 few-rows tensor-core kernel takes:
    K/2 is split on 64-row stages until the grid of 128-column blocks holds
    about three blocks an SM (its copies keep ~30 KB a block in flight),
    each block taking at least 256 rows."""
    tiles = -(-n // INT4_MMA_COLS)
    want = -(-3 * SM_COUNT // tiles)
    chunks = max(1, min(want, kp // INT4_MIN_KP))
    per = -(-kp // chunks)
    return -(-per // INT4_KP) * INT4_KP


def int4_wgmma_split(m: int, kp: int, n: int, group: int,
                     zeros: bool) -> tuple[int, int]:
    """(activation rows a block, packed rows a block) of the INT4 wgmma
    kernel: blocks of 256 columns x 128 rows with per-channel scales and no
    zero points (64 rows when m <= 64), x 64 rows with grouped scales or
    zero points (an f32 total beside the accumulators); K/2 is split on
    64-row stages while the tiles (one block an SM) leave SMs idle, each
    block taking at least 256 rows."""
    grouped = zeros or group < 2 * kp
    bm = 64 if grouped or m <= 64 else 128
    tiles = -(-n // 256) * -(-m // bm)
    chunks = max(1, min(SM_COUNT // tiles, kp // INT4_MIN_KP))
    per = -(-kp // chunks)
    return bm, -(-per // INT4_KP) * INT4_KP


def mma_split(m: int, k: int, n: int, group: int) -> tuple[int, int]:
    """(warpgroups along M, K rows per block) of the mma kernel: 128-row
    tiles from m = 128 (two warpgroups, one block an SM), else 64-row tiles
    (one warpgroup, two blocks an SM); K is split on slab (and, grouped,
    group) edges while the grid still fits one wave of those blocks, each
    block taking at least 256 rows."""
    wm = 2 if m >= 128 else 1
    tiles = -(-n // MMA_BN) * -(-m // (64 * wm))
    want = (SM_COUNT if wm == 2 else 2 * SM_COUNT) // tiles
    chunks = max(1, min(want, k // MMA_MIN_K))
    unit = MMA_BK if group >= k else math.lcm(MMA_BK, group)
    per = -(-k // chunks)
    return wm, -(-per // unit) * unit


def rows_mma_split(m: int, k: int, n: int) -> int:
    """K rows a block of the few-rows tensor-core kernel takes: K is split
    on 64-row stages while the grid of 128-column tiles still fits the
    blocks the card holds at once (4 an SM), into at most
    ``ROWS_MMA_MAX_SPLIT`` ranges, each block taking at least 256 rows. The
    7B wo (32 tiles) takes 8 ranges of 512 rows, the LM head (250 tiles)
    2. The cap is measured (H100, the 7B wo at m 8, chip_smoke.py phase 3):
    8 ranges ran 0.0113 ms, 4 0.0141 and 16 0.0125 (the last block adds
    twice the partials over blocks of half the stages). From shapes
    alone, so CUDA-graph capture holds."""
    del m                     # one n8 tile of rows whatever m <= 8
    tiles = -(-n // ROWS_MMA_COLS)
    chunks = max(1, min(ROWS_MMA_RES * SM_COUNT // tiles,
                        k // ROWS_MMA_MIN_K, ROWS_MMA_MAX_SPLIT))
    per = -(-k // chunks)
    return -(-per // ROWS_MMA_KT) * ROWS_MMA_KT


def rows_split(m: int, k: int, n: int) -> int:
    """K rows per block of the few-rows kernel (csrc/int8_rows.cuh):
    K is split until the grid holds about two blocks per SM. The blocks
    write ceil(k / kch) f32 partial sums of [m, n] each."""
    col_tiles = -(-n // ROWS_COLS) * -(-m // 8)
    want = -(-2 * SM_COUNT // col_tiles)
    chunks = max(1, min(want, -(-k // ROWS_MIN_K)))
    return -(-k // chunks)


def _layer(q, scales, layer, zs=None):
    if q.ndim == 3:
        if layer is None:
            raise ValueError("stacked weights need a layer index")
        return q[layer], scales[layer], None if zs is None else zs[layer]
    return q, scales, zs


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x as [M, K] rows with unit stride along K."""
    x2 = x.reshape(-1, k)
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def quantize_activations_int8(x: torch.Tensor):
    """Per-token (last axis) symmetric int8: (xi int8 [..., K], xs f32
    [..., 1]) with x ~= xi * xs. xs = max(absmax / 127, 1e-10); xi =
    round(x / xs) (ties to even) clipped to [-127, 127]. Both divisions
    divide by a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by the reciprocal, which is not jnp's IEEE quotient."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-10)
    xi = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xi, xs


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                         scales: torch.Tensor, out_dtype=torch.bfloat16,
                         layer: int | None = None) -> torch.Tensor:
    """Plain version of :func:`quantized_matmul`: ``ref_ops.
    quantized_matmul_ref`` on the layer's weight."""
    if x.is_cuda:
        quantized_matmul_ref.cuda_calls += 1
    q, scales, _ = _layer(q, scales, layer)
    return ref_ops.quantized_matmul_ref(x, q, scales, out_dtype=out_dtype)


quantized_matmul_ref.cuda_calls = 0


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                     out_dtype=torch.bfloat16, layer: int | None = None,
                     n_start=None, n_size: int | None = None,
                     bits: int = 8, zs=None) -> torch.Tensor:
    """y = x @ dequant(q, scales) (of stacked layer ``layer``).

    x: [..., K] f32 or bf16; q: [K, N] int8 or [L, K, N] with ``layer``;
    scales: [K // G, N] f32 (or [L, K // G, N]). Returns [..., N] in
    ``out_dtype`` (f32 or bf16). ``bits=4``: q is split-half packed
    [.., K/2, N] (:func:`quantized_matmul_int4`), ``zs`` its zero points
    (:func:`quantized_matmul_int4_zs`)."""
    if n_start is not None or n_size is not None:
        raise NotImplementedError("column-chunked matmul (n_start/n_size: "
                                  "the ring collective matmul)")
    if bits == 4:
        if zs is None:
            return quantized_matmul_int4(x, q, scales, out_dtype, layer)
        return quantized_matmul_int4_zs(x, q, scales, zs, out_dtype, layer)
    if bits != 8:
        raise NotImplementedError(f"{bits}-bit weights (the port serves "
                                  f"INT8 and INT4)")
    if zs is not None:
        raise ValueError("zero points (zs) come only with INT4 weights, as "
                         "in the JAX package")
    if not x.is_cuda:
        return quantized_matmul_ref(x, q, scales, out_dtype, layer)
    ql, sl, _ = _layer(q, scales, layer)
    k, n = ql.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the weight K={k}")
    g = sl.shape[0]
    if sl.shape != (g, n) or k % g:
        raise ValueError(f"scales {tuple(sl.shape)} do not group K={k}, "
                         f"N={n}")
    if ql.dtype != torch.int8 or sl.dtype != torch.float32:
        raise TypeError("quantized_matmul takes int8 weights and f32 scales")
    if not (ql.is_cuda and sl.is_cuda):
        raise ValueError("x, q and scales must share a device")
    ql = ql.contiguous()
    sl = sl.contiguous()
    x2 = _rows(x, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    regime = tiled_regime(m, k, n, k // g, x2.dtype)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if regime in ("mma", "rmma"):
        # the 16-byte copies need aligned rows (a contiguous copy of an
        # odd view; K % 8 == 0 keeps its rows aligned)
        if x2.data_ptr() % 16 or x2.stride(0) % 8:
            x2 = x2.clone(memory_format=torch.contiguous_format)
        if ql.data_ptr() % 16:
            ql = ql.clone()
    if regime == "rmma":
        if sl.data_ptr() % 16:
            sl = sl.clone()
        kch = rows_mma_split(m, k, n)
        chunks = -(-k // kch)
        work = torch.empty((chunks * m * n if chunks > 1 else 0,),
                           dtype=torch.float32, device=x.device)
        rc = lib.sli_quantized_matmul_rows_mma(
            x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(),
            out.data_ptr(), work.data_ptr() if chunks > 1 else 0, m, k, n,
            kch, cuda_build.dtype_code(out_dtype), stream)
    elif regime == "mma":
        wm, kch = mma_split(m, k, n, k // g)
        chunks = -(-k // kch)
        work = torch.empty((chunks * m * n if chunks > 1 else 0,),
                           dtype=torch.float32, device=x.device)
        rc = lib.sli_quantized_matmul_mma(
            x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(),
            out.data_ptr(), work.data_ptr() if chunks > 1 else 0, m, k, n,
            k // g, kch, wm, cuda_build.dtype_code(out_dtype), stream)
    else:
        kch = rows_split(m, k, n) if regime == "rows" else 0
        chunks = -(-k // kch) if kch else 0
        work = torch.empty((chunks * m * n,), dtype=torch.float32,
                           device=x.device)
        vec = int(n % 16 == 0 and ql.data_ptr() % 16 == 0)
        rc = lib.sli_quantized_matmul(
            x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(),
            out.data_ptr(), work.data_ptr(), m, k, n, k // g, kch,
            cuda_build.dtype_code(x2.dtype),
            cuda_build.dtype_code(out_dtype), vec, stream)
    cuda_build.check(lib, rc, f"quantized_matmul ({regime})")
    quantized_matmul.launches += 1
    REGIME_LAUNCHES[regime] += 1
    return out.reshape(*x.shape[:-1], n)


quantized_matmul.launches = 0


# ------------------------------------------------------------------ INT4

def quantized_matmul_int4_ref(x: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, out_dtype=torch.bfloat16,
                              layer: int | None = None,
                              zs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`quantized_matmul_int4` and of its
    zero-point form: ``ref_ops.quantized_matmul_int4_ref`` on the layer's
    weight, the TPU kernel's order (f32 sums of x against the codes, each
    group's times its scale, minus rowsum_g(x) * zs per group; a
    per-channel scale once at the end). The kernels differ from it only in
    f32 summation order."""
    if x.is_cuda:
        quantized_matmul_int4_ref.cuda_calls += 1
    q, scales, zs = _layer(q, scales, layer, zs)
    return ref_ops.quantized_matmul_int4_ref(x, q, scales,
                                             out_dtype=out_dtype, zs=zs)


quantized_matmul_int4_ref.cuda_calls = 0


def _int4_launch(x, q, scales, zs, out_dtype, layer) -> torch.Tensor:
    """Checks and launches the INT4 kernel :func:`int4_regime` picks."""
    ql, sl, zl = _layer(q, scales, layer, zs)
    kp, n = ql.shape
    k = 2 * kp
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the packed weight "
                         f"K/2={kp}")
    g = sl.shape[0]
    if sl.shape != (g, n) or k % g:
        raise ValueError(f"scales {tuple(sl.shape)} do not group K={k}, "
                         f"N={n}")
    gs = k // g
    if gs != k and kp % gs:
        raise ValueError(f"group {gs} does not divide K/2={kp} (split-half "
                         f"packing)")
    if zl is not None and (tuple(zl.shape) != (g, n)
                           or zl.dtype != torch.float32 or not zl.is_cuda):
        raise ValueError(f"zs {tuple(zl.shape)} {zl.dtype} must be f32 "
                         f"[{g}, {n}] on the card")
    if ql.dtype != torch.int8 or sl.dtype != torch.float32:
        raise TypeError("INT4 weights are int8 bytes with f32 scales")
    if not (ql.is_cuda and sl.is_cuda):
        raise ValueError("x, q and scales must share a device")
    ql, sl = ql.contiguous(), sl.contiguous()
    zl = None if zl is None else zl.contiguous()
    x2 = _rows(x, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    regime = int4_regime(m, kp, n, gs, x2.dtype)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    zp = 0 if zl is None else zl.data_ptr()
    if regime in ("mma", "wgmma"):
        # the 16-byte copies need aligned rows (a contiguous copy of an
        # odd view; K/2 % 64 == 0 keeps its rows aligned)
        if x2.data_ptr() % 16 or x2.stride(0) % 8:
            x2 = x2.clone(memory_format=torch.contiguous_format)
        if ql.data_ptr() % 16:
            ql = ql.clone()
        if sl.data_ptr() % 16:      # float4 scale (and zero point) reads
            sl = sl.clone()
        if zl is not None and zl.data_ptr() % 16:
            zl = zl.clone()
        zp = 0 if zl is None else zl.data_ptr()
        if regime == "mma":
            bm, kch = 0, int4_mma_split(kp, n)
        else:
            bm, kch = int4_wgmma_split(m, kp, n, gs, zl is not None)
        chunks = -(-kp // kch)
        work = torch.empty((chunks * m * n if chunks > 1 else 0,),
                           dtype=torch.float32, device=x.device)
        wp = work.data_ptr() if chunks > 1 else 0
        if regime == "mma":
            rc = lib.sli_quantized_matmul_int4_mma(
                x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(),
                zp, out.data_ptr(), wp, m, kp, n, gs, kch,
                cuda_build.dtype_code(out_dtype), stream)
        else:
            rc = lib.sli_quantized_matmul_int4_wgmma(
                x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(),
                zp, out.data_ptr(), wp, m, kp, n, gs, kch, bm,
                cuda_build.dtype_code(out_dtype), stream)
    else:
        kch = rows_split(m, kp, n) if regime == "rows" else 0
        chunks = -(-kp // kch) if kch else 0
        work = torch.empty((chunks * m * n,), dtype=torch.float32,
                           device=x.device)
        vec = int(n % 8 == 0 and ql.data_ptr() % 8 == 0)
        rc = lib.sli_quantized_matmul_int4(
            x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(), zp,
            out.data_ptr(), work.data_ptr(), m, kp, n, gs, kch,
            cuda_build.dtype_code(x2.dtype),
            cuda_build.dtype_code(out_dtype), vec, stream)
    cuda_build.check(lib, rc, f"quantized_matmul_int4 ({regime})")
    INT4_REGIME_LAUNCHES[regime] += 1
    return out.reshape(*x.shape[:-1], n)


def quantized_matmul_int4(x: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, out_dtype=torch.bfloat16,
                          layer: int | None = None) -> torch.Tensor:
    """y = x @ dequant(q, scales) for split-half INT4 weights (kernel 14).

    x: [..., K] f32 or bf16; q: [K/2, N] int8 (two codes a byte) or
    [L, K/2, N] with ``layer``; scales: [K // G, N] f32 (or stacked), G
    dividing K/2 or equal to K. Returns [..., N] in ``out_dtype``."""
    if not x.is_cuda:
        return quantized_matmul_int4_ref(x, q, scales, out_dtype, layer)
    out = _int4_launch(x, q, scales, None, out_dtype, layer)
    quantized_matmul_int4.launches += 1
    return out


quantized_matmul_int4.launches = 0


def quantized_matmul_int4_zs(x: torch.Tensor, q: torch.Tensor,
                             scales: torch.Tensor, zs: torch.Tensor,
                             out_dtype=torch.bfloat16,
                             layer: int | None = None) -> torch.Tensor:
    """:func:`quantized_matmul_int4` with zero points (the AWQ/GPTQ form,
    kernel 14 with ``has_zeros``): w = q * s - zs, zs [K // G, N] f32 (or
    stacked) the per-group zero times scale."""
    if not x.is_cuda:
        return quantized_matmul_int4_ref(x, q, scales, out_dtype, layer, zs)
    out = _int4_launch(x, q, scales, zs, out_dtype, layer)
    quantized_matmul_int4_zs.launches += 1
    return out


quantized_matmul_int4_zs.launches = 0


# ------------------------------------------------------------------ W8A8

def quantized_matmul_w8a8_ref(x: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, out_dtype=torch.bfloat16,
                              layer: int | None = None) -> torch.Tensor:
    """Plain version of :func:`quantized_matmul_w8a8`:
    ``ref_ops.quantized_matmul_w8a8_ref`` on the layer's weight."""
    if x.is_cuda:
        quantized_matmul_w8a8_ref.cuda_calls += 1
    q, scales, _ = _layer(q, scales, layer)
    return ref_ops.quantized_matmul_w8a8_ref(x, q, scales,
                                             out_dtype=out_dtype)


quantized_matmul_w8a8_ref.cuda_calls = 0


def quantized_matmul_w8a8(x: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, out_dtype=torch.bfloat16,
                          layer: int | None = None) -> torch.Tensor:
    """y = quant8(x) @ dequant(q, scales): per-token int8 activations
    against int8 weights (kernel 15), the prefill form of
    :func:`quantized_matmul`.

    x: [..., K] f32 or bf16; q: [K, N] int8 or [L, K, N] with ``layer``;
    scales: [K // G, N] f32 (or stacked), G = K (per output channel) or a
    multiple of 4 rows. Returns [..., N] in ``out_dtype``."""
    if not x.is_cuda:
        return quantized_matmul_w8a8_ref(x, q, scales, out_dtype, layer)
    ql, sl, _ = _layer(q, scales, layer)
    k, n = ql.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the weight K={k}")
    g = sl.shape[0]
    if sl.shape != (g, n) or k % g:
        raise ValueError(f"scales {tuple(sl.shape)} do not group K={k}, "
                         f"N={n}")
    gs = k // g
    if gs != k and gs % 4:
        raise NotImplementedError(f"W8A8 with scale groups of {gs} rows "
                                  f"(the kernel takes multiples of 4)")
    if ql.dtype != torch.int8 or sl.dtype != torch.float32:
        raise TypeError("quantized_matmul_w8a8 takes int8 weights and f32 "
                        "scales")
    if not (ql.is_cuda and sl.is_cuda):
        raise ValueError("x, q and scales must share a device")
    ql, sl = ql.contiguous(), sl.contiguous()
    xi, xs = quantize_activations_int8(_rows(x, k))
    out = w8a8_codes_launch(xi, xs, ql, sl, out_dtype)
    return out.reshape(*x.shape[:-1], n)


def w8a8_codes_launch(xi: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
                      scales: torch.Tensor, out_dtype) -> torch.Tensor:
    """Kernel 15 on activation codes already made: xi [M, K] int8 and xs
    [M, 1] f32 from :func:`quantize_activations_int8`, q [K, N] int8 and
    scales [K // G, N] f32 contiguous on the card. Launches the kernel
    :func:`w8a8_regime` picks and counts it (in
    ``quantized_matmul_w8a8.launches`` and :data:`W8A8_REGIME_LAUNCHES`);
    :func:`quantized_matmul_w8a8` is the quantize ops and this."""
    m, k = xi.shape
    n = q.shape[1]
    gs = k // scales.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=xi.device)
    if m == 0:
        return out
    regime = w8a8_regime(m, k, n, gs)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(xi.device).cuda_stream
    if regime == "wgmma":
        if q.data_ptr() % 16:     # the 16-byte copies
            q = q.clone()
        wm, kch = w8a8_split(m, k, n, gs)
        chunks = -(-k // kch)
        work = torch.empty((chunks * m * n if chunks > 1 else 0,),
                           dtype=torch.int32, device=xi.device)
        rc = lib.sli_quantized_matmul_w8a8_wgmma(
            xi.data_ptr(), xs.data_ptr(), q.data_ptr(), scales.data_ptr(),
            out.data_ptr(), work.data_ptr() if chunks > 1 else 0, m, k, n,
            gs, kch, wm, cuda_build.dtype_code(out_dtype), stream)
    else:
        rc = lib.sli_quantized_matmul_w8a8(
            xi.data_ptr(), xs.data_ptr(), q.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, k, n, gs, cuda_build.dtype_code(out_dtype),
            int(n % 4 == 0 and q.data_ptr() % 4 == 0),
            int(k % 16 == 0 and xi.data_ptr() % 16 == 0), stream)
    cuda_build.check(lib, rc, f"quantized_matmul_w8a8 ({regime})")
    quantized_matmul_w8a8.launches += 1
    W8A8_REGIME_LAUNCHES[regime] += 1
    return out


quantized_matmul_w8a8.launches = 0
