"""Tokenizer protocol and streaming detokenizer (the engine's only
tokenizer dependency; the concrete tokenizers are not ported yet)."""

from simplellminference_tpu_torch.tokenizer.base import (  # noqa: F401
    StreamingDetokenizer,
    Tokenizer,
)
