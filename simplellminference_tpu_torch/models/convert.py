"""Carry a JAX-package params tree over to the port.

``params_from_jax(jax.tree.map(np.asarray, params))`` turns the JAX
package's params pytree — already moved to host numpy arrays by the
caller, so this module needs no JAX — into the port's dict of torch
tensors, name for name, on a given device and dtype. Weights made once
(from one seed, with numpy or with JAX) can then drive both packages.
``QuantizedWeight`` leaves become the port's ``QuantizedWeight``: the
int8 ``q`` byte for byte (8-bit codes, or INT4's split-half packed
bytes), the scales and the zero points ``zs`` as f32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from simplellminference_tpu_torch.core.device import (resolve_device,
                                                      torch_dtype)
from simplellminference_tpu_torch.ops.linear import (QuantizedWeight,
                                                     check_servable)


def _tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (what np.asarray gives for a bf16 jax.Array)
        arr = arr.astype(np.float32)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                       dtype=dtype)


def params_from_jax(tree, device=None, dtype="float32") -> dict:
    """Nested dict of numpy arrays (the JAX params pytree after
    ``jax.tree.map(np.asarray, ...)``) -> the same dict of torch tensors.

    Floating leaves become ``dtype`` on ``device`` (CUDA unless
    ``device="cpu"``), but for the attention sinks, which stay f32;
    integer leaves keep their type. Quantized weights
    (objects carrying ``q``/``scales``/``bits``/``zs``) become
    :class:`QuantizedWeight`; one the port cannot serve raises
    (:func:`~simplellminference_tpu_torch.ops.linear.check_servable`)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def conv(x):
        if isinstance(x, dict):
            # GPT-OSS's sinks stay f32, as the attention kernels take them
            return {k: _tensor(v, dev, torch.float32) if k == "sinks"
                    else conv(v) for k, v in x.items()}
        if hasattr(x, "q") and hasattr(x, "scales"):
            zs = getattr(x, "zs", None)
            w = QuantizedWeight(q=_tensor(x.q, dev, None),
                                scales=_tensor(x.scales, dev, torch.float32),
                                bits=int(getattr(x, "bits", 8)),
                                zs=None if zs is None else _tensor(
                                    zs, dev, torch.float32))
            check_servable(w)
            return w
        return _tensor(x, dev, dt)

    return conv(tree)
