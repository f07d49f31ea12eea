"""Tokenizer protocol, streaming detokenizer and the byte tokenizer (the
file-backed tokenizers are not ported yet)."""

from simplellminference_tpu_torch.tokenizer.base import (  # noqa: F401
    StreamingDetokenizer,
    Tokenizer,
)
from simplellminference_tpu_torch.tokenizer.bytes import (  # noqa: F401
    ByteTokenizer,
)
