"""Pod-scale serving (port of `accelerate_tpu/serving/pod`): disaggregated
prefill/decode workers.

- **Layer 1 (SPMD, `pod.mesh`)**: one engine tensor-parallel over a
  process mesh (one process per device, every rank running the engine
  on its shards): params sharded by the repo's path-pattern rules, the
  paged KV pool sharded over heads (or pages), the ranks kept in
  lockstep by one clock. `sharded_engine(...)` is the factory;
  `EngineConfig(mesh=...)` is the knob it turns, and
  `PodConfig(tensor_parallel=N)` puts layer 1 under layer 2. Families
  with a tensor-parallel forward: llama and gpt2.

- **Layer 2 (MPMD, `pod.router` / `pod.transfer`)**: prefill and decode
  split into dedicated worker engines shipping KV pages: `PodRouter`
  (alias `PodEngine`) exposes the ordinary `ServingEngine` API over the
  workers, with role assignment, page-transfer bookkeeping and
  decode-side backpressure handled host-side.

- **Layer 3 (multi-process, `pod.distributed`)**: the same dataflow over
  OS processes: a socket wire format for shipments, worker heartbeats,
  re-prefill-from-prompt failure recovery and elastic role rebalancing.
  `DistributedPodRouter` is the front; `PodRouter` stays the in-process
  form. Loaded on first touch.
"""

from .mesh import (
    cache_state_shardings,
    shard_params,
    sharded_engine,
    tensor_mesh,
)
from .router import PodConfig, PodEngine, PodRouter
from .transfer import KVPageShipment, PageTransport, place_shipment

__all__ = [
    "tensor_mesh",
    "shard_params",
    "cache_state_shardings",
    "sharded_engine",
    "PodConfig",
    "PodRouter",
    "PodEngine",
    "KVPageShipment",
    "PageTransport",
    "place_shipment",
]


def __getattr__(name):
    # layer 3 is import-heavy (sockets, threads) and optional for layer
    # 1/2 users: load it lazily on first touch
    if name in ("DistributedPodConfig", "DistributedPodRouter",
                "WorkerHandle", "build_local_distributed_pod"):
        from . import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
