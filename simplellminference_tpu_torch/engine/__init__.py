"""Serving engine: continuous batching over the paged KV cache."""

from simplellminference_tpu_torch.engine.engine import Engine  # noqa: F401
from simplellminference_tpu_torch.engine.request import (  # noqa: F401
    Request,
    RequestState,
)
