"""Linear layer: plain matmul, or the INT8 dequant + matmul kernel.

Counterpart of simplellminference_tpu/ops/linear.py:20-148. A weight is a
plain [K, N] tensor or a :class:`QuantizedWeight`, either one stacked
[L, K, N] with a layer index. A plain product is one PyTorch call with
an f32 accumulator, as the JAX package leaves it to XLA
(``jnp.dot(..., preferred_element_type=float32)``); an 8-bit
QuantizedWeight goes to :func:`~simplellminference_tpu_torch.ops.matmul.
quantized_matmul` (the CUDA kernel on the card, its plain version on the
CPU). INT4, asymmetric zero points and W8A8 activation quantization are
not ported and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from simplellminference_tpu_torch.ops import ref_ops
from simplellminference_tpu_torch.ops.matmul import quantized_matmul


@dataclasses.dataclass
class QuantizedWeight:
    """Group-quantized weight, as in the JAX package.

    bits=8: q [.., K, N] int8, scales [.., K // G, N] f32 (G = K: one
    scale per output column). ``zs`` (asymmetric zero points) and bits=4
    are carried by the JAX package but not served here."""

    q: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    zs: torch.Tensor | None = None

    @property
    def shape(self):
        """[.., K, N] (8-bit weights: the shape of q)."""
        return tuple(self.q.shape)

    @property
    def group_size(self) -> int:
        return self.shape[-2] // self.scales.shape[-2]

    @classmethod
    def quantize(cls, w: torch.Tensor, group_size: int = 128,
                 scale_dtype=torch.float32, bits: int = 8
                 ) -> "QuantizedWeight":
        if bits != 8:
            raise NotImplementedError("INT4 weights")
        q, s = ref_ops.quantize_int8_groupwise(w, group_size, scale_dtype)
        return cls(q=q, scales=s, bits=bits)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.bits != 8:
            raise NotImplementedError("INT4 weights")
        return ref_ops.dequantize_int8_groupwise(self.q, self.scales, dtype)


def check_servable(w: QuantizedWeight) -> None:
    """Raise NotImplementedError for a QuantizedWeight the port cannot
    serve (INT4, asymmetric zero points)."""
    if w.bits != 8:
        raise NotImplementedError("INT4 weights")
    if w.zs is not None:
        raise NotImplementedError("asymmetric zero points (zs)")


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


def linear(x: torch.Tensor, w, out_dtype=None, layer: int | None = None,
           act_quant: str | None = None) -> torch.Tensor:
    """y = x @ w. x: [..., K]; w: [K, N] or stacked [L, K, N] + ``layer``,
    plain or a QuantizedWeight. Returns ``out_dtype`` (default x's)."""
    out_dtype = out_dtype or x.dtype
    if act_quant is not None:
        raise NotImplementedError(f"W8A8 activation quantization "
                                  f"(act_quant={act_quant!r})")
    if isinstance(w, QuantizedWeight):
        check_servable(w)
        stacked = w.q.ndim == 3
        if stacked and layer is None:
            raise ValueError("stacked weight needs a layer index")
        return quantized_matmul(x, w.q, w.scales, out_dtype=out_dtype,
                                layer=layer if stacked else None)
    if w.ndim == 3:
        if layer is None:
            raise ValueError("stacked weight needs a layer index")
        w = w[layer]
    if out_dtype == x.dtype:
        return torch.matmul(x, w.to(x.dtype))
    return dot_f32(x, w).to(out_dtype)
