"""Continuous-batching serving (port of `accelerate_tpu.serving`):
`Engine` multiplexes concurrent generation requests through a paged KV
pool (`PagedKVCache`, with prompt-prefix reuse via the `PrefixIndex`
radix tree) and a `Scheduler` that admits, sheds and retires requests and
interleaves chunked prefill with batched decode."""

from .cache import (
    PagedAllocator,
    PagedKVCache,
    PageAllocation,
    PagePool,
    PrefixIndex,
)
from .engine import Engine, EngineConfig
from .metrics import ServingMetrics
from .scheduler import (
    Request,
    RequestStatus,
    Scheduler,
    Slot,
    SlotState,
    TenantSpec,
)

# unambiguous name for the top-level package namespace
ServingEngine = Engine

__all__ = [
    "Engine",
    "ServingEngine",
    "EngineConfig",
    "PagedKVCache",
    "PagedAllocator",
    "PageAllocation",
    "PagePool",
    "PrefixIndex",
    "ServingMetrics",
    "Scheduler",
    "Request",
    "RequestStatus",
    "Slot",
    "SlotState",
    "TenantSpec",
]
