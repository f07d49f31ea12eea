"""Post-hoc weight-only INT8 quantization of a params dict.

Counterpart of simplellminference_tpu/runtime/weights.py:375
(``quantize_params``) with ``_maybe_quantize`` (:235) and
``_QUANTIZABLE`` (:58). The checkpoint loaders of that module are not
ported yet. ``canonicalize_layouts`` (:353) has no counterpart: it pins
XLA's device layouts to row-major for the Pallas calls, and the port's
tensors are row-major already.
"""

from __future__ import annotations

import math

from simplellminference_tpu_torch.core.config import QuantConfig
from simplellminference_tpu_torch.ops.linear import QuantizedWeight

# Paths eligible for weight-only quantization (the JAX package's set).
# Embedding, norms and (unless QuantConfig.quantize_lm_head) the LM head
# stay high-precision.
_QUANTIZABLE = {"layers/wqkv", "layers/wo", "layers/w_gate_up",
                "layers/w_down", "layers/shared_gate_up",
                "layers/shared_down",
                "layers/q_proj", "layers/q_b", "layers/kv_b"}


def _maybe_quantize(path: str, w, quant: QuantConfig):
    eligible = path in _QUANTIZABLE or (path == "lm_head"
                                        and quant.quantize_lm_head)
    if quant.enabled and eligible and not isinstance(w, QuantizedWeight):
        if quant.mode != "int8":
            raise NotImplementedError(f"{quant.mode} weights")
        k = w.shape[-2]
        gs = quant.group_size or k          # 0 = per-output-channel
        if k % gs != 0:
            gs = math.gcd(k, gs) or k
        return QuantizedWeight.quantize(w, gs)
    return w


def quantize_params(params: dict, quant: QuantConfig) -> dict:
    """Post-hoc quantization of an already-loaded float params dict: the
    eligible stacked weights become :class:`QuantizedWeight` (int8 q, f32
    scales, on the weights' device); everything else is passed through."""
    out = dict(params)
    out["layers"] = {
        name: _maybe_quantize(f"layers/{name}", w, quant)
        for name, w in params["layers"].items()
    }
    if "lm_head" in params:
        out["lm_head"] = _maybe_quantize("lm_head", params["lm_head"], quant)
    return out
