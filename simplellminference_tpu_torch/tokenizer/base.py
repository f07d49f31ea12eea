"""Tokenizer protocol and streaming detokenizer."""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    """Encode/decode round trip (reference: encode.h:16-40)."""

    def encode(self, text: str, add_bos: bool = True) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    @property
    def vocab_size(self) -> int: ...
    @property
    def bos_id(self) -> int: ...
    @property
    def eos_id(self) -> int: ...


class StreamingDetokenizer:
    """Incremental decode for token streaming.

    The reference decodes each generated id in isolation
    (model.cpp:172-182, one ``Decode({id})`` per token) which breaks
    multi-token UTF-8 sequences and drops SentencePiece word boundaries.
    This holds back undecodable suffixes (e.g. partial UTF-8 from byte
    fallback) until they complete.
    """

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._emitted = 0  # chars of decoded text already returned
        #: True while a trailing partial UTF-8 sequence is held back —
        #: the stream's visible text currently lags the true text.
        self.has_pending = False

    def push(self, token_id: int) -> str:
        """Add one token; return newly-safe text (possibly empty)."""
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        # Hold back a trailing replacement char — it usually means a
        # partial UTF-8 sequence from byte-fallback tokens.
        safe_end = len(text)
        while safe_end > self._emitted and text[safe_end - 1] == "�":
            safe_end -= 1
        new = text[self._emitted:safe_end]
        self._emitted = safe_end
        self.has_pending = safe_end < len(text)
        return new

    def flush(self) -> str:
        """Return any held-back text (end of stream)."""
        text = self._tok.decode(self._ids)
        new = text[self._emitted:]
        self._emitted = len(text)
        self.has_pending = False
        return new

    def reset(self):
        self._ids.clear()
        self._emitted = 0
        self.has_pending = False
