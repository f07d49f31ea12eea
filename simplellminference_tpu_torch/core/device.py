"""Device and dtype selection for the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device when CUDA is unavailable raises:
    only an explicit ``device="cpu"`` selects the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    return dev


def torch_dtype(name) -> torch.dtype:
    """ModelConfig.dtype name (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise NotImplementedError(f"dtype {name!r}")
    return _DTYPES[name]
