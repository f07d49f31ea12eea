"""Linear layer: plain matmul, or a quantized-weight kernel.

Counterpart of simplellminference_tpu/ops/linear.py:20-148. A weight is a
plain [K, N] tensor or a :class:`QuantizedWeight`, either one stacked
[L, K, N] with a layer index. A plain product is one PyTorch call with
an f32 accumulator, as the JAX package leaves it to XLA
(``jnp.dot(..., preferred_element_type=float32)``). A QuantizedWeight goes
to :func:`~simplellminference_tpu_torch.ops.matmul.quantized_matmul`
(8-bit, or 4-bit split-half packed with optional zero points), or, with
``act_quant="int8"`` over enough rows, to the W8A8 kernel
:func:`~simplellminference_tpu_torch.ops.matmul.quantized_matmul_w8a8`:
the CUDA kernels on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from simplellminference_tpu_torch.ops import ref_ops
from simplellminference_tpu_torch.ops.matmul import (quantized_matmul,
                                                     quantized_matmul_w8a8)


@dataclasses.dataclass
class QuantizedWeight:
    """Group-quantized weight, as in the JAX package.

    bits=8: q [.., K, N] int8, scales [.., K // G, N] f32 (G = K: one
    scale per output column).
    bits=4: q [.., K/2, N] int8, two codes a byte, split-half packed (row
    i in the low nibble, row i + K/2 in the high one:
    ``ref_ops.quantize_int4_groupwise``), scales [.., K // G, N].
    ``zs`` (bits=4 only; AWQ/GPTQ imports): per-group zero * scale
    [.., K // G, N] f32, w = (q - z) * s = q * s - zs."""

    q: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    zs: torch.Tensor | None = None

    @property
    def shape(self):
        """The logical [.., K, N] (for bits=4 twice q's packed rows)."""
        s = tuple(self.q.shape)
        if self.bits == 4:
            return (*s[:-2], 2 * s[-2], s[-1])
        return s

    @property
    def group_size(self) -> int:
        return self.shape[-2] // self.scales.shape[-2]

    @classmethod
    def quantize(cls, w: torch.Tensor, group_size: int = 128,
                 scale_dtype=torch.float32, bits: int = 8
                 ) -> "QuantizedWeight":
        if bits == 4:
            q, s = ref_ops.quantize_int4_groupwise(w, group_size,
                                                   scale_dtype)
        elif bits == 8:
            q, s = ref_ops.quantize_int8_groupwise(w, group_size,
                                                   scale_dtype)
        else:
            raise ValueError(f"bits={bits} (8 or 4)")
        return cls(q=q, scales=s, bits=bits)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.bits == 4:
            return ref_ops.dequantize_int4_groupwise(self.q, self.scales,
                                                     dtype, zs=self.zs)
        return ref_ops.dequantize_int8_groupwise(self.q, self.scales, dtype)


def check_servable(w: QuantizedWeight) -> None:
    """Raise for a QuantizedWeight the port cannot serve: another width
    than 8 or 4 bits (NotImplementedError), zero points on 8-bit weights
    or scales and zero points that do not fit the weight (ValueError, where
    the JAX package asserts)."""
    if w.bits not in (4, 8):
        raise NotImplementedError(f"{w.bits}-bit weights (the port serves "
                                  f"INT8 and INT4)")
    *lead, k, n = w.shape
    g = w.scales.shape[-2]
    if tuple(w.scales.shape) != (*lead, g, n) or k % g:
        raise ValueError(f"scales {tuple(w.scales.shape)} do not group the "
                         f"weight {tuple(w.shape)}")
    if w.bits == 4 and k // g != k and (k // 2) % (k // g):
        raise ValueError(f"INT4 group {k // g} does not divide K/2={k // 2} "
                         f"(split-half packing)")
    if w.zs is not None:
        if w.bits != 4:
            raise ValueError("zero points (zs) come only with INT4 weights, "
                             "as in the JAX package")
        if tuple(w.zs.shape) != tuple(w.scales.shape):
            raise ValueError(f"zs {tuple(w.zs.shape)} and scales "
                             f"{tuple(w.scales.shape)} differ in shape")


# Row count from which activation quantization applies (the JAX package's
# ACT_QUANT_MIN_ROWS, linear.py:80): below it the product is bound by the
# weight bytes (decode bursts, the LM head's last rows) and W8A8 buys
# nothing.
ACT_QUANT_MIN_ROWS = 128


def _act_quant_applies(x: torch.Tensor, w: QuantizedWeight,
                       act_quant: str | None) -> bool:
    """The JAX gate (linear.py:83-91): ``act_quant="int8"``, 8-bit weights
    without zero points, and at least ACT_QUANT_MIN_ROWS rows counted as
    the product of x's leading dims (padding rows included)."""
    if act_quant is None:
        return False
    if act_quant != "int8":
        raise ValueError(f"act_quant={act_quant!r} (only 'int8')")
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return w.bits == 8 and w.zs is None and m >= ACT_QUANT_MIN_ROWS


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result, both operands in x's dtype: the exact
    products summed in f32, never a bf16 product cast up. x: [..., K];
    w: [K, N]."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    # f32 copies hold the same values, so the products are the same
    return torch.matmul(x.float(), w.float())


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched x @ w with an f32 result, as :func:`dot_f32`: x [G, M, K],
    w [G, K, N], both in x's dtype."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def linear(x: torch.Tensor, w, out_dtype=None, layer: int | None = None,
           act_quant: str | None = None) -> torch.Tensor:
    """y = x @ w. x: [..., K]; w: [K, N] or stacked [L, K, N] + ``layer``,
    plain or a QuantizedWeight. Returns ``out_dtype`` (default x's).

    ``act_quant="int8"`` (ModelConfig.act_quant): per-token int8
    activations through the W8A8 kernel where :func:`_act_quant_applies`
    (prefill products over 8-bit weights)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedWeight):
        stacked = w.q.ndim == 3
        if stacked and layer is None:
            raise ValueError("stacked weight needs a layer index")
        li = layer if stacked else None
        if _act_quant_applies(x, w, act_quant):
            return quantized_matmul_w8a8(x, w.q, w.scales,
                                         out_dtype=out_dtype, layer=li)
        return quantized_matmul(x, w.q, w.scales, out_dtype=out_dtype,
                                layer=li, bits=w.bits, zs=w.zs)
    if w.ndim == 3:
        if layer is None:
            raise ValueError("stacked weight needs a layer index")
        w = w[layer]
    if out_dtype == x.dtype:
        return torch.matmul(x, w.to(x.dtype))
    return dot_f32(x, w).to(out_dtype)
