"""Paged KV block allocator, pure Python.

Counterpart of simplellminference_tpu/memory/allocator.py:139-342 and
:358: ``PyPageAllocator`` is a copy of the JAX package's executable
specification of the allocator (LIFO free stack, refcounted pages,
full-page prefix sharing, detached prefix handles, CoW), and
``PageAllocator`` is the factory the engine calls. The native C++
allocator is not ported yet, so the factory always returns the Python
one.

The API signals OOM by False/-1 returns: the engine preempts.
"""

from __future__ import annotations

import threading

import numpy as np


class _PyPrefix:
    __slots__ = ("pages", "tokens", "live")

    def __init__(self):
        self.pages: list = []
        self.tokens = 0
        self.live = False


class PyPageAllocator:
    """Pure-Python paged allocator — byte-for-byte the native allocator's
    semantics (LIFO free stack, refcounted pages, full-page prefix
    sharing, detached prefix handles, CoW). tests/test_torch_allocator.py
    runs it in lockstep with the JAX package's allocator."""

    def __init__(self, num_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages_per_seq = max_pages_per_seq
        self._free = list(range(num_pages - 1, -1, -1))  # LIFO, pop()
        self._ref = [0] * num_pages
        self._table = np.full((max_seqs, max_pages_per_seq), -1, np.int32)
        self._len = [-1] * max_seqs
        self._prefixes: list = []
        self._mu = threading.Lock()

    @property
    def num_free(self) -> int:
        with self._mu:
            return len(self._free)

    def seq_len(self, slot: int) -> int:
        with self._mu:
            if not (0 <= slot < self.max_seqs):
                return -1
            return self._len[slot]

    def alloc_seq(self, slot: int, tokens: int) -> bool:
        with self._mu:
            if not (0 <= slot < self.max_seqs) or self._len[slot] != -1 \
                    or tokens < 0:
                return False
            need = self.pages_for(tokens)
            if need > self.max_pages_per_seq or need > len(self._free):
                return False
            for i in range(need):
                p = self._free.pop()
                self._ref[p] = 1
                self._table[slot, i] = p
            self._len[slot] = tokens
            return True

    def extend(self, slot: int, new_len: int) -> bool:
        with self._mu:
            if not (0 <= slot < self.max_seqs) or self._len[slot] < 0 \
                    or new_len < self._len[slot]:
                return False
            have = self.pages_for(self._len[slot])
            need = self.pages_for(new_len)
            if need > self.max_pages_per_seq \
                    or need - have > len(self._free):
                return False
            for i in range(have, need):
                p = self._free.pop()
                self._ref[p] = 1
                self._table[slot, i] = p
            self._len[slot] = new_len
            return True

    def free_seq(self, slot: int) -> int:
        with self._mu:
            if not (0 <= slot < self.max_seqs) or self._len[slot] < 0:
                return -1
            have = self.pages_for(self._len[slot])
            freed = 0
            for i in range(have):
                p = int(self._table[slot, i])
                if p >= 0:
                    self._ref[p] -= 1
                    if self._ref[p] == 0:
                        self._free.append(p)
                        freed += 1
                self._table[slot, i] = -1
            self._len[slot] = -1
            return freed

    def share_prefix(self, src: int, dst: int, n_tokens: int) -> int:
        with self._mu:
            if not (0 <= src < self.max_seqs) or self._len[src] < 0:
                return -1
            if not (0 <= dst < self.max_seqs) or self._len[dst] != -1:
                return -1
            if n_tokens < 0:
                return -1
            tok = min(n_tokens, self._len[src])
            pages = tok // self.page_size
            if pages <= 0:
                return 0
            for i in range(pages):
                p = int(self._table[src, i])
                self._table[dst, i] = p
                self._ref[p] += 1
            self._len[dst] = pages * self.page_size
            return pages * self.page_size

    def prefix_detach(self, slot: int, n_tokens: int) -> int:
        with self._mu:
            if not (0 <= slot < self.max_seqs) or self._len[slot] < 0:
                return -1
            tok = min(n_tokens, self._len[slot])
            pages = tok // self.page_size
            if pages <= 0:
                return -1
            hid = next((i for i, e in enumerate(self._prefixes)
                        if not e.live), len(self._prefixes))
            if hid == len(self._prefixes):
                self._prefixes.append(_PyPrefix())
            e = self._prefixes[hid]
            e.pages = [int(p) for p in self._table[slot, :pages]]
            e.tokens = pages * self.page_size
            e.live = True
            for p in e.pages:
                self._ref[p] += 1
            return hid

    def prefix_tokens(self, handle: int) -> int:
        with self._mu:
            if not (0 <= handle < len(self._prefixes)) \
                    or not self._prefixes[handle].live:
                return -1
            return self._prefixes[handle].tokens

    def prefix_attach(self, handle: int, dst: int, max_tokens: int) -> int:
        with self._mu:
            if not (0 <= handle < len(self._prefixes)) \
                    or not self._prefixes[handle].live:
                return -1
            if not (0 <= dst < self.max_seqs) or self._len[dst] != -1 \
                    or max_tokens < 0:
                return -1
            e = self._prefixes[handle]
            pages = min(max_tokens, e.tokens) // self.page_size
            if pages <= 0:
                return 0
            if pages > self.max_pages_per_seq:
                return -1
            for i in range(pages):
                self._table[dst, i] = e.pages[i]
                self._ref[e.pages[i]] += 1
            self._len[dst] = pages * self.page_size
            return pages * self.page_size

    def prefix_release(self, handle: int) -> int:
        with self._mu:
            if not (0 <= handle < len(self._prefixes)) \
                    or not self._prefixes[handle].live:
                return -1
            e = self._prefixes[handle]
            freed = 0
            for p in e.pages:
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
                    freed += 1
            e.pages, e.tokens, e.live = [], 0, False
            return freed

    def cow_last_page(self, slot: int) -> int:
        with self._mu:
            if not (0 <= slot < self.max_seqs) or self._len[slot] <= 0:
                return -1
            last = self.pages_for(self._len[slot]) - 1
            p = int(self._table[slot, last])
            if self._ref[p] == 1:
                return p
            if not self._free:
                return -1
            np_ = self._free.pop()
            self._ref[np_] = 1
            self._ref[p] -= 1
            self._table[slot, last] = np_
            return np_

    def row(self, slot: int) -> np.ndarray:
        with self._mu:
            if not (0 <= slot < self.max_seqs):
                return np.full(self.max_pages_per_seq, -1, np.int32)
            return self._table[slot].copy()

    def table(self) -> np.ndarray:
        with self._mu:
            return self._table.copy()

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)


def PageAllocator(num_pages: int, page_size: int, max_seqs: int,
                  max_pages_per_seq: int) -> PyPageAllocator:
    """Factory the engine calls (the native allocator comes later)."""
    return PyPageAllocator(num_pages, page_size, max_seqs,
                           max_pages_per_seq)
