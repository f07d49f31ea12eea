"""Fused FFN for a few rows: rmsnorm -> int8 gate_up x per-channel scale
-> SwiGLU -> int8 down x per-channel scale -> + residual.

Counterpart of simplellminference_tpu/ops/ffn_fused.py:138 (``fused_ffn``,
kernel ``_kernel`` :42) and of ``fused_ffn_available`` (:424). For CUDA
tensors :func:`fused_ffn` launches the hand-written kernels of one of two
regimes, chosen before the launch by :func:`ffn_regime` and each counted in
:data:`FFN_REGIME_LAUNCHES` (one wrapper call, one count in
``fused_ffn.launches``): ``mma`` (bf16 activations, H and I multiples of
64: ``csrc/ffn_fused_mma.cu``, the rmsnorm once, then gate_up + SwiGLU and
down + residual on the bf16 tensor cores, all rows in one pass over the
weights) and ``fma`` (the rest, f32 activations among them:
``csrc/ffn_fused.cu``, f32 FMAs, 8 rows at a time). For CPU tensors it
runs :func:`fused_ffn_ref`, which is also what the kernels are held
against on the card.

Rounding: the TPU kernel rounds x, the normalized rows and the SwiGLU
output to bf16 whatever the activation dtype (ffn_fused.py:151, :54-55,
:85). Here both versions round the normalized rows and the SwiGLU output
to the activation dtype (x's) and keep the products, scales and the
residual add in f32: with bf16 activations that is the TPU kernel's
math, with f32 ones the JAX package's CPU path.

:func:`fused_wo_ffn` (ffn_fused.py:302, kernel ``_wo_kernel`` :222) puts
the wo product in front of that FFN as one weight stream: one
cooperative launch of ``csrc/wo_ffn.cu``. The JAX package dispatches it
from no path (ffn_fused.py:313-316), and the port neither; its gate
:func:`fused_wo_ffn_available` is ported beside it.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops import cuda_build, ref_ops
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.ops.matmul import SM_COUNT, rows_split

MAX_ROWS = 64
MMA_KT = 64               # K rows a stage of the tensor-core kernels
MMA_MIN_K = 256           # fewest K rows a block of them takes
MMA_MAX_SPLIT = 8         # most K ranges a product is split into
# launches of each regime's kernels (fused_ffn.launches counts every call)
FFN_REGIME_LAUNCHES = {"mma": 0, "fma": 0}


def ffn_regime(m: int, h: int, inter: int, dtype) -> str:
    """The kernels of a fused FFN of ``m`` rows (m <= 64) at hidden size
    ``h`` and intermediate size ``inter``, from dtype and shape alone:
    "mma" (the bf16 tensor cores) for bf16 activations with H and I
    multiples of the 64-row stage (which keeps every 16-byte copy aligned);
    "fma" (f32 FMAs) otherwise: the port never rounds f32 activations to
    bf16, as the f32 forms of kernels 3, 8 and 14 do not."""
    if (dtype == torch.bfloat16 and m <= MAX_ROWS and h % MMA_KT == 0
            and inter % MMA_KT == 0):
        return "mma"
    return "fma"


def ffn_resident(m: int) -> int:
    """Blocks of the tensor-core FFN kernels an SM holds for m rows (their
    launch bounds in csrc/ffn_fused_mma.cu: registers grow with the n8
    row tiles)."""
    nt = -(-m // 8)
    return 4 if nt == 1 else 3 if nt <= 5 else 2


def ffn_split(m: int, k: int, tiles: int) -> int:
    """K rows a block of a tensor-core FFN product takes, over ``tiles``
    column tiles: K is split on 64-row stages while the grid still fits the
    blocks the card holds at once (:func:`ffn_resident` an SM), into at
    most 8 ranges (the last block at a column tile adds every range's
    partials, so more ranges lengthen the tail), each block taking at
    least 256 rows. From shapes alone, so CUDA-graph capture holds."""
    chunks = max(1, min(ffn_resident(m) * SM_COUNT // tiles,
                        k // MMA_MIN_K, MMA_MAX_SPLIT))
    per = -(-k // chunks)
    return -(-per // MMA_KT) * MMA_KT


def fused_ffn_ref(x, norm_w, q1, s1, q2, s2, layer: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`fused_ffn`."""
    if x.is_cuda:
        fused_ffn_ref.cuda_calls += 1
    return _ffn_plain(x, norm_w, q1, s1, q2, s2, layer, eps)


fused_ffn_ref.cuda_calls = 0


def _ffn_plain(x, norm_w, q1, s1, q2, s2, layer: int, eps: float):
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
    regime = ffn_regime(m, h, inter, x.dtype)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hbuf = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    if regime == "mma":
        # the 16-byte copies and the epilogue's vector accesses
        w1, w2, xc, sc1, sc2 = (t if t.data_ptr() % 16 == 0 else t.clone()
                                for t in (w1, w2, xc, sc1, sc2))
        kch1 = ffn_split(m, h, inter // MMA_KT)
        kch2 = ffn_split(m, inter, -(-h // 128))
        c1, c2 = -(-h // kch1), -(-inter // kch2)
        # the partials of a split product (gate_up's are read before down
        # starts, so both use one buffer)
        size = max(c1 * m * 2 * inter if c1 > 1 else 0,
                   c2 * m * h if c2 > 1 else 0)
        work = torch.empty((size,), dtype=torch.float32, device=x.device)
        xn = torch.empty_like(xc)
        rc = lib.sli_ffn_fused_mma(
            xc.data_ptr(), nw.data_ptr(), int(nw.dtype == torch.bfloat16),
            w1.data_ptr(), sc1.data_ptr(), w2.data_ptr(), sc2.data_ptr(),
            xn.data_ptr(), hbuf.data_ptr(), work.data_ptr() if size else 0,
            out.data_ptr(), m, h, inter, kch1, kch2, float(eps), stream)
    else:
        kch = rows_split(m, inter, h)
        work = torch.empty((-(-inter // kch) * m * h,), dtype=torch.float32,
                           device=x.device)
        vec1 = int(inter % 16 == 0 and w1.data_ptr() % 16 == 0)
        vec2 = int(h % 16 == 0 and w2.data_ptr() % 16 == 0)
        rc = lib.sli_ffn_fused(
            xc.data_ptr(), nw.data_ptr(), int(nw.dtype == torch.bfloat16),
            w1.data_ptr(), sc1.data_ptr(), w2.data_ptr(), sc2.data_ptr(),
            hbuf.data_ptr(), work.data_ptr(), out.data_ptr(), m, h, inter,
            kch, float(eps), cuda_build.dtype_code(x.dtype), vec1, vec2,
            stream)
    cuda_build.check(lib, rc, f"fused_ffn ({regime})")
    fused_ffn.launches += 1
    FFN_REGIME_LAUNCHES[regime] += 1
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


def fused_wo_ffn_ref(attn, x, wo_q, wo_s, norm_w, q1, s1, q2, s2,
                     layer: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`fused_wo_ffn`: the wo product rounded to
    x's dtype, the residual add in x's dtype, then the plain FFN of
    :func:`fused_ffn_ref`."""
    if x.is_cuda:
        fused_wo_ffn_ref.cuda_calls += 1
    wo_out = ref_ops.quantized_matmul_ref(attn, wo_q[layer],
                                          wo_s[layer].reshape(1, -1),
                                          out_dtype=x.dtype)
    return _ffn_plain(x + wo_out, norm_w, q1, s1, q2, s2, layer, eps)


fused_wo_ffn_ref.cuda_calls = 0


def fused_wo_ffn(attn, x, wo_q, wo_s, norm_w, q1, s1, q2, s2, layer: int,
                 eps: float = 1e-5) -> torch.Tensor:
    """x + down(swiglu(gate_up(rms(x + attn @ wo)))): the post-attention
    half of a decoder layer (ffn_fused.py:302). attn: [m, N*D], x: [m, H]
    (m <= 64, one dtype); wo_q: [L, N*D, H] int8 with per-channel wo_s
    [L, 1, H] f32; norm_w, q1, s1, q2, s2 as :func:`fused_ffn`. Returns
    [m, H] in x's dtype.

    Rounding follows ffn_fused.py:249-258 in x's dtype: wo_out is rounded,
    added to x and rounded, and carried in f32; the normalized rows and
    the SwiGLU output are rounded. For CUDA tensors one cooperative launch
    of ``csrc/wo_ffn.cu`` over every block the card holds at once; for CPU
    tensors :func:`fused_wo_ffn_ref`. Like the JAX package, no model path
    calls it."""
    if not x.is_cuda:
        return fused_wo_ffn_ref(attn, x, wo_q, wo_s, norm_w, q1, s1, q2, s2,
                                layer, eps)
    return _fused_wo_ffn_launch(attn, x, wo_q, wo_s, norm_w, q1, s1, q2, s2,
                                layer, eps, wo_ffn_max_grid(x.dtype))


fused_wo_ffn.launches = 0


def _fused_wo_ffn_launch(attn, x, wo_q, wo_s, norm_w, q1, s1, q2, s2,
                         layer: int, eps: float, grid: int) -> torch.Tensor:
    """:func:`fused_wo_ffn` on CUDA tensors over a cooperative grid of
    ``grid`` blocks; past what the card holds at once (it would deadlock)
    the launcher refuses and this raises."""
    if x.ndim != 2 or attn.ndim != 2 or attn.shape[0] != x.shape[0]:
        raise ValueError(f"attn [m, N*D] and x [m, H], got "
                         f"{tuple(attn.shape)} and {tuple(x.shape)}")
    m, h = x.shape
    nd = attn.shape[1]
    n_layers, _, n1 = q1.shape
    inter = q2.shape[1]
    if m > MAX_ROWS:
        raise ValueError(f"fused_wo_ffn takes at most {MAX_ROWS} rows")
    if attn.dtype != x.dtype or attn.device != x.device:
        raise ValueError("attn and x must share dtype and device")
    if (wo_q.dtype != torch.int8 or wo_q.shape != (n_layers, nd, h)
            or wo_s.numel() != n_layers * h):
        raise ValueError("wo must be [L, N*D, H] int8 with per-channel f32 "
                         "scales")
    if (q1.dtype != torch.int8 or q2.dtype != torch.int8
            or q1.shape != (n_layers, h, 2 * inter)
            or q2.shape != (n_layers, inter, h)
            or s1.numel() != n_layers * n1 or s2.numel() != n_layers * h):
        raise ValueError("fused_wo_ffn takes [L, H, 2I] / [L, I, H] int8 "
                         "weights with per-channel f32 scales")
    if not (wo_q.is_contiguous() and q1.is_contiguous()
            and q2.is_contiguous()):
        raise ValueError("weights must be contiguous")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} out of range")
    code = cuda_build.dtype_code(x.dtype)
    out = torch.empty_like(x)
    if m == 0:
        return out
    nw = norm_w[layer].reshape(-1).contiguous()
    if nw.dtype not in (torch.float32, torch.bfloat16) or nw.numel() != h:
        raise ValueError("norm weight must be [L, H] f32 or bf16")
    w0, w1, w2 = wo_q[layer], q1[layer], q2[layer]
    sc0, sc1, sc2 = (s[layer].reshape(-1).to(torch.float32).contiguous()
                     for s in (wo_s, s1, s2))
    kch0, kch2 = rows_split(m, nd, h), rows_split(m, inter, h)
    chunks = max(-(-nd // kch0), -(-inter // kch2))
    part = torch.empty((chunks * m * h,), dtype=torch.float32,
                       device=x.device)
    xres = torch.empty((m, h), dtype=torch.float32, device=x.device)
    hbuf = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    lib = cuda_build.load()
    ac, xc = attn.contiguous(), x.contiguous()
    rc = lib.sli_wo_ffn(
        ac.data_ptr(), xc.data_ptr(), w0.data_ptr(), sc0.data_ptr(), nw.data_ptr(),
        int(nw.dtype == torch.bfloat16), w1.data_ptr(), sc1.data_ptr(),
        w2.data_ptr(), sc2.data_ptr(), part.data_ptr(), xres.data_ptr(),
        hbuf.data_ptr(), out.data_ptr(), m, nd, h, inter, kch0, kch2,
        float(eps), int(h % 16 == 0 and w0.data_ptr() % 16 == 0),
        int(inter % 16 == 0 and w1.data_ptr() % 16 == 0),
        int(h % 16 == 0 and w2.data_ptr() % 16 == 0), int(grid), code,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "fused_wo_ffn")
    fused_wo_ffn.launches += 1
    return out


def wo_ffn_max_grid(dtype) -> int:
    """The most blocks of :func:`fused_wo_ffn`'s cooperative grid that the
    current card holds at once (occupancy x SM count)."""
    import ctypes

    lib = cuda_build.load()
    most = ctypes.c_int(0)
    rc = lib.sli_wo_ffn_max_grid(cuda_build.dtype_code(dtype),
                                 ctypes.byref(most))
    cuda_build.check(lib, rc, "fused_wo_ffn (occupancy)")
    return most.value


def fused_wo_ffn_available(lw, nd: int, h: int, inter: int, m: int) -> bool:
    """The gates of simplellminference_tpu/ops/ffn_fused.py:411 without its
    TPU tiling: a stacked per-channel 8-bit ``wo`` on top of
    :func:`fused_ffn_available`. (The TPU gate's nd % 128 is a tiling
    rule; the kernel takes any nd.)"""
    wo = lw.get("wo")
    if not (isinstance(wo, QuantizedWeight) and wo.q.ndim == 3
            and wo.scales.shape[-2] == 1 and wo.bits == 8):
        return False
    return fused_ffn_available(lw, h, inter, m)
