"""Continuous-batching serving (port of `accelerate_tpu.serving`):
`Engine` multiplexes concurrent generation requests through a paged KV
pool (`PagedKVCache`, with prompt-prefix reuse via the `PrefixIndex`
radix tree and an optional host-memory tier) and a `Scheduler` that
admits, sheds and retires requests and interleaves chunked prefill with
batched decode, optionally speculative. On a CUDA engine every device
step is one captured CUDA graph (`GraphRunner`). `SlotKVCache` is the
dense slot layout (the speculative draft model's cache);
`SanitizerViolation` is what `EngineConfig(sanitize=True)` raises."""

from .cache import (
    PagedAllocator,
    PagedKVCache,
    PageAllocation,
    PagePool,
    PrefixIndex,
    SlotKVCache,
)
from .engine import Engine, EngineConfig
from .graphs import GraphRunner
from .metrics import ServingMetrics
from .sanitizer import SanitizerViolation
from .scheduler import (
    Request,
    RequestStatus,
    Scheduler,
    Slot,
    SlotState,
    TenantSpec,
)
from .transfer import PageTransport

# unambiguous name for the top-level package namespace
ServingEngine = Engine

__all__ = [
    "Engine",
    "ServingEngine",
    "EngineConfig",
    "GraphRunner",
    "SlotKVCache",
    "PagedKVCache",
    "PagedAllocator",
    "PageAllocation",
    "PagePool",
    "PageTransport",
    "PrefixIndex",
    "SanitizerViolation",
    "ServingMetrics",
    "Scheduler",
    "Request",
    "RequestStatus",
    "Slot",
    "SlotState",
    "TenantSpec",
]
