"""Weight-only INT8 dequant + matmul: y = sum_g (x_g @ q_g) * s_g.

Counterpart of simplellminference_tpu/ops/matmul.py:522
(``quantized_matmul``, kernel ``_qmm_kernel`` :69) for 8-bit weights, one
layer of a stacked [L, K, N] weight or a plain [K, N] one, with
per-output-channel ([.., 1, N]) or per-group ([.., K/G, N]) f32 scales,
for any M, K and N. For CUDA tensors :func:`quantized_matmul` launches
the hand-written kernels of ``csrc/quantized_matmul.cu``; for CPU tensors
it runs :func:`quantized_matmul_ref`, which is also what the kernels are
held against on the card.

Rounding: the TPU kernel rounds x to bf16 whatever its dtype
(matmul.py:565). Here x is used in its own dtype (the activation dtype)
and the products and sums stay f32 until the one rounding to
``out_dtype``: with bf16 activations that is the TPU kernel's math, with
f32 ones the JAX package's CPU math (``quantized_matmul_ref``). Every K is
exact: the TPU wrapper's K tile drops a K % 128 remainder
(matmul.py:583-584); nothing here does.

Not ported: ``n_start``/``n_size`` (the ring collective matmul) and
``bits=4`` (INT4), which raise.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops

SM_COUNT = 132            # H100 SXM: K splits aim at two blocks per SM
ROWS_MAX_M = 8            # up to this many rows: the few-rows kernel
ROWS_COLS = 256           # output columns per block of that kernel
ROWS_MIN_K = 256          # smallest K range a block of it takes


def rows_split(m: int, k: int, n: int) -> int:
    """K rows per block of the few-rows kernel (csrc/int8_rows.cuh):
    K is split until the grid holds about two blocks per SM. The blocks
    write ceil(k / kch) f32 partial sums of [m, n] each."""
    col_tiles = -(-n // ROWS_COLS) * -(-m // 8)
    want = -(-2 * SM_COUNT // col_tiles)
    chunks = max(1, min(want, -(-k // ROWS_MIN_K)))
    return -(-k // chunks)


def _layer(q, scales, layer):
    if q.ndim == 3:
        if layer is None:
            raise ValueError("stacked weights need a layer index")
        return q[layer], scales[layer]
    return q, scales


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                         scales: torch.Tensor, out_dtype=torch.bfloat16,
                         layer: int | None = None) -> torch.Tensor:
    """Plain version of :func:`quantized_matmul`: ``ref_ops.
    quantized_matmul_ref`` on the layer's weight."""
    if x.is_cuda:
        quantized_matmul_ref.cuda_calls += 1
    q, scales = _layer(q, scales, layer)
    return ref_ops.quantized_matmul_ref(x, q, scales, out_dtype=out_dtype)


quantized_matmul_ref.cuda_calls = 0


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                     out_dtype=torch.bfloat16, layer: int | None = None,
                     n_start=None, n_size: int | None = None,
                     bits: int = 8, zs=None) -> torch.Tensor:
    """y = x @ dequant(q, scales) (of stacked layer ``layer``).

    x: [..., K] f32 or bf16; q: [K, N] int8 or [L, K, N] with ``layer``;
    scales: [K // G, N] f32 (or [L, K // G, N]). Returns [..., N] in
    ``out_dtype`` (f32 or bf16)."""
    if bits != 8:
        raise NotImplementedError("INT4 weights (bits=4)")
    if zs is not None:
        raise NotImplementedError("asymmetric zero points (zs)")
    if n_start is not None or n_size is not None:
        raise NotImplementedError("column-chunked matmul (n_start/n_size: "
                                  "the ring collective matmul)")
    if not x.is_cuda:
        return quantized_matmul_ref(x, q, scales, out_dtype, layer)
    ql, sl = _layer(q, scales, layer)
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
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    kch = rows_split(m, k, n) if m <= ROWS_MAX_M else 0
    chunks = -(-k // kch) if kch else 0
    work = torch.empty((chunks * m * n,), dtype=torch.float32,
                       device=x.device)
    vec = int(n % 16 == 0 and ql.data_ptr() % 16 == 0)
    lib = cuda_build.load()
    rc = lib.sli_quantized_matmul(
        x2.data_ptr(), x2.stride(0), ql.data_ptr(), sl.data_ptr(),
        out.data_ptr(), work.data_ptr(), m, k, n, k // g, kch,
        cuda_build.dtype_code(x2.dtype), cuda_build.dtype_code(out_dtype),
        vec, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "quantized_matmul")
    quantized_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


quantized_matmul.launches = 0
