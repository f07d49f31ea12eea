"""The port's page allocator in lockstep with the JAX package's.

The same seeded random sequence of allocator calls goes to both
``PyPageAllocator``s; every return value and the whole block table must
agree after every call.
"""

import numpy as np
import pytest

from simplellminference_tpu.memory.allocator import (
    PyPageAllocator as JaxAllocator)
from simplellminference_tpu_torch.memory.allocator import (PageAllocator,
                                                           PyPageAllocator)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_lockstep(seed):
    rng = np.random.default_rng(seed)
    args = (24, 8, 4, 6)       # pages, page size, slots, pages per seq
    a, b = JaxAllocator(*args), PyPageAllocator(*args)
    handles = []
    for _ in range(400):
        op = rng.integers(0, 8)
        slot = int(rng.integers(0, 4))
        n = int(rng.integers(0, 50))
        if op == 0:
            call = ("alloc_seq", slot, n)
        elif op == 1:
            call = ("extend", slot, n)
        elif op == 2:
            call = ("free_seq", slot)
        elif op == 3:
            call = ("share_prefix", slot, int(rng.integers(0, 4)), n)
        elif op == 4:
            call = ("prefix_detach", slot, n)
        elif op == 5 and handles:
            call = ("prefix_attach", int(rng.choice(handles)), slot, n)
        elif op == 6 and handles:
            call = ("prefix_release", int(rng.choice(handles)))
        else:
            call = ("cow_last_page", slot)
        ra = getattr(a, call[0])(*call[1:])
        rb = getattr(b, call[0])(*call[1:])
        assert ra == rb, call
        if call[0] == "prefix_detach" and ra >= 0:
            handles.append(ra)
        assert a.num_free == b.num_free
        np.testing.assert_array_equal(a.table(), b.table())
        for s in range(4):
            assert a.seq_len(s) == b.seq_len(s)
            np.testing.assert_array_equal(a.row(s), b.row(s))


def test_factory_returns_python_allocator():
    alloc = PageAllocator(8, 16, 2, 4)
    assert isinstance(alloc, PyPageAllocator)
    assert alloc.alloc_seq(0, 33) and alloc.num_free == 5
    assert alloc.pages_for(33) == 3
