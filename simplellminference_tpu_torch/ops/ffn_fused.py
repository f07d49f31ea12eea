"""Fused FFN for a few rows: rmsnorm -> int8 gate_up x per-channel scale
-> SwiGLU -> int8 down x per-channel scale -> + residual.

Counterpart of simplellminference_tpu/ops/ffn_fused.py:138 (``fused_ffn``,
kernel ``_kernel`` :42) and of ``fused_ffn_available`` (:424). For CUDA
tensors :func:`fused_ffn` launches the hand-written kernels of
``csrc/ffn_fused.cu`` (gate_up + SwiGLU, then down + residual: one
wrapper call, one count); for CPU tensors it runs :func:`fused_ffn_ref`,
which is also what the kernels are held against on the card.

Rounding: the TPU kernel rounds x, the normalized rows and the SwiGLU
output to bf16 whatever the activation dtype (ffn_fused.py:151, :54-55,
:85). Here both versions round the normalized rows and the SwiGLU output
to the activation dtype (x's) and keep the products, scales and the
residual add in f32: with bf16 activations that is the TPU kernel's
math, with f32 ones the JAX package's CPU path.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.ops.matmul import rows_split

MAX_ROWS = 64


def fused_ffn_ref(x, norm_w, q1, s1, q2, s2, layer: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`fused_ffn`."""
    if x.is_cuda:
        fused_ffn_ref.cuda_calls += 1
    inter = q2.shape[1]
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn = (xf * inv * norm_w[layer].reshape(-1).float()).to(x.dtype)
    gu = ref_ops.quantized_matmul_ref(xn, q1[layer],
                                      s1[layer].reshape(1, -1),
                                      out_dtype=torch.float32)
    g, u = gu[:, :inter], gu[:, inter:]
    h = (g * torch.sigmoid(g) * u).to(x.dtype)
    dn = ref_ops.quantized_matmul_ref(h, q2[layer], s2[layer].reshape(1, -1),
                                      out_dtype=torch.float32)
    return (dn + xf).to(x.dtype)


fused_ffn_ref.cuda_calls = 0


def fused_ffn(x, norm_w, q1, s1, q2, s2, layer: int,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [m, H] (m <= 64); norm_w: [L, H] (or [L, 1, H]); q1: [L, H, 2I]
    int8, s1: [L, 1, 2I] f32; q2: [L, I, H] int8, s2: [L, 1, H] f32;
    layer: int. Returns x + down(swiglu(gate_up(rmsnorm(x)))) in x's
    dtype."""
    if not x.is_cuda:
        return fused_ffn_ref(x, norm_w, q1, s1, q2, s2, layer, eps)
    if x.ndim != 2:
        raise ValueError(f"x must be [m, H], got {tuple(x.shape)}")
    m, h = x.shape
    n_layers, _, n1 = q1.shape
    inter = q2.shape[1]
    if m > MAX_ROWS:
        raise ValueError(f"fused_ffn takes at most {MAX_ROWS} rows")
    if (q1.dtype != torch.int8 or q2.dtype != torch.int8
            or q1.shape != (n_layers, h, 2 * inter)
            or q2.shape != (n_layers, inter, h)
            or s1.numel() != n_layers * n1 or s2.numel() != n_layers * h):
        raise ValueError("fused_ffn takes [L, H, 2I] / [L, I, H] int8 "
                         "weights with per-channel f32 scales")
    if not (q1.is_contiguous() and q2.is_contiguous()):
        raise ValueError("weights must be contiguous")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    out = torch.empty_like(x)
    if m == 0:
        return out
    xc = x.contiguous()
    nw = norm_w[layer].reshape(-1).contiguous()
    if nw.dtype not in (torch.float32, torch.bfloat16) or nw.numel() != h:
        raise ValueError("norm weight must be [L, H] f32 or bf16")
    w1, w2 = q1[layer], q2[layer]
    sc1 = s1[layer].reshape(-1).to(torch.float32).contiguous()
    sc2 = s2[layer].reshape(-1).to(torch.float32).contiguous()
    hbuf = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    kch = rows_split(m, inter, h)
    work = torch.empty((-(-inter // kch) * m * h,), dtype=torch.float32,
                       device=x.device)
    vec1 = int(inter % 16 == 0 and w1.data_ptr() % 16 == 0)
    vec2 = int(h % 16 == 0 and w2.data_ptr() % 16 == 0)
    lib = cuda_build.load()
    rc = lib.sli_ffn_fused(
        xc.data_ptr(), nw.data_ptr(), int(nw.dtype == torch.bfloat16),
        w1.data_ptr(), sc1.data_ptr(), w2.data_ptr(), sc2.data_ptr(),
        hbuf.data_ptr(), work.data_ptr(), out.data_ptr(), m, h, inter, kch,
        float(eps), cuda_build.dtype_code(x.dtype), vec1, vec2,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "fused_ffn")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


def fused_ffn_available(lw, h: int, inter: int, m: int) -> bool:
    """The gates of simplellminference_tpu/ops/ffn_fused.py:424 without its
    TPU VMEM tiling (``ffn_tiles``): stacked 8-bit ``w_gate_up`` and
    ``w_down`` with per-output-channel scales, and m <= 64 rows (prefill
    included)."""
    gu, dn = lw.get("w_gate_up"), lw.get("w_down")
    if not (isinstance(gu, QuantizedWeight)
            and isinstance(dn, QuantizedWeight)):
        return False
    if gu.bits != 8 or dn.bits != 8:
        return False
    if gu.q.ndim != 3 or dn.q.ndim != 3:
        return False
    if gu.scales.shape[-2] != 1 or dn.scales.shape[-2] != 1:
        return False
    return m <= MAX_ROWS
