"""Trivial byte-level tokenizer (tests, benches, file-less runs).

The port's own copy of simplellminference_tpu/tokenizer/bytes.py."""

from __future__ import annotations

from typing import Sequence


class ByteTokenizer:
    """ids 0..255 are raw bytes; 256=bos, 257=eos."""

    def __init__(self):
        self._bos = 256
        self._eos = 257

    @property
    def vocab_size(self) -> int:
        return 258

    @property
    def bos_id(self) -> int:
        return self._bos

    @property
    def eos_id(self) -> int:
        return self._eos

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self._bos] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")
