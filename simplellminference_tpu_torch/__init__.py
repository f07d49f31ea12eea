"""simplellminference_tpu_torch — the PyTorch/CUDA port of simplellminference_tpu.

The JAX package ``simplellminference_tpu`` is the reference; this package
mirrors its layout and names so each module's counterpart is easy to find,
and holds each port module against it on the same inputs (tests/test_torch_*).
Every TPU (Pallas) kernel on a ported path is a CUDA C++ kernel written for
Hopper (``csrc/``), with a plain PyTorch version beside it that serves CPU
tensors and is the check the kernel is held against on the card.

    core/      — configs (a copy of the reference's), device selection
    memory/    — paged KV pools, page allocator
    ops/       — plain ops, linear, INT8 matmul, fused qkv / FFN, paged
                 writes, sampling, CUDA build
    ops/attention/ — flash prefill, paged flash decode, dispatch
    models/    — the Llama decoder over paged KV, JAX-params converter
    runtime/   — post-hoc INT8 weight quantization (quantize_params)
    engine/    — continuous-batching serving engine
    tokenizer/ — tokenizer protocol, streaming detokenizer

Entry points (``Engine``, ``init_params``, ``PagedKVCache.create``) run on
CUDA by default and raise when CUDA is unavailable; pass ``device="cpu"``
for the plain PyTorch path.
"""

__version__ = "0.1.0"

from simplellminference_tpu_torch.core.config import (  # noqa: F401
    EngineConfig,
    KVCacheConfig,
    ModelConfig,
    QuantConfig,
    SamplingParams,
)
