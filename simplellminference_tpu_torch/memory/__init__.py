"""Memory layer: paged KV page pools and the page allocator."""

from simplellminference_tpu_torch.memory.allocator import PageAllocator  # noqa: F401
from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache  # noqa: F401
