"""The serving tier of the port: paged KV cache and continuous batching
(the counterpart of the reference's ``serve/``). ``Engine`` is the scheduler
loop; ``KVCacheManager`` and ``PagedKVCacheManager`` own slots, pages and
positions (their ``Expandable*`` kinds grow on demand); the paged step runs
the paged-attention kernel on the pool."""
from repro_torch.serve.cache import (ExpandableKVCacheManager,
                                     ExpandablePagedKVCacheManager,
                                     HostPagePool, KVCacheManager,
                                     PageAllocator, PagedKVCacheManager)
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import SlotWork, TickPlan, compose
from repro_torch.serve.step import make_decode_step, make_prefill_step, sample

__all__ = ["Engine", "Request", "KVCacheManager", "PagedKVCacheManager",
           "ExpandableKVCacheManager", "ExpandablePagedKVCacheManager",
           "PageAllocator", "HostPagePool", "SlotWork", "TickPlan",
           "compose", "sample", "make_prefill_step", "make_decode_step"]
