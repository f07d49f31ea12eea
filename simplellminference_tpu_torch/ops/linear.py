"""Linear layer over plain (bf16/f32) weights.

Counterpart of simplellminference_tpu/ops/linear.py:94-148 for plain
weights: a weight is [K, N], or stacked [L, K, N] with a layer index. The
JAX package leaves this product to XLA (``jnp.dot``); the port leaves it
to ``torch.matmul``. INT8/INT4 weights (``QuantizedWeight`` with the
``quantized_matmul`` kernel) come with the INT8-weight slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantizedWeight:
    """Group-quantized weight (q, scales, bits, zs), as in the JAX
    package. Not served yet: :func:`linear` raises for it."""

    q: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    zs: torch.Tensor | None = None


def linear(x: torch.Tensor, w, out_dtype=None,
           layer: int | None = None) -> torch.Tensor:
    """y = x @ w. x: [..., K]; w: [K, N] or stacked [L, K, N] + ``layer``."""
    if isinstance(w, QuantizedWeight):
        raise NotImplementedError("INT8/INT4 weights (QuantizedWeight)")
    out_dtype = out_dtype or x.dtype
    if w.ndim == 3:
        if layer is None:
            raise ValueError("stacked weight needs a layer index")
        w = w[layer]
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)
