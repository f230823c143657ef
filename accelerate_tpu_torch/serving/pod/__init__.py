"""Pod-scale serving (port of `accelerate_tpu/serving/pod`): disaggregated
prefill/decode workers.

- **Layer 1 (SPMD, `pod.mesh`)**: one engine tensor-parallel over a
  device mesh. Not ported: `tensor_mesh`, `shard_params`,
  `cache_state_shardings` and `sharded_engine` raise
  NotImplementedError naming queue 1 item 6b, as do
  `PodConfig(tensor_parallel > 1)` and `EngineConfig(mesh=...)`.

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


def _layer1(name: str):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"serving.pod.{name} is layer 1 of the pod (tensor-parallel "
            "serving over a device mesh), which the PyTorch port brings "
            "with queue 1 item 6b (sharded placement)")

    unported.__name__ = unported.__qualname__ = name
    return unported


tensor_mesh = _layer1("tensor_mesh")
shard_params = _layer1("shard_params")
cache_state_shardings = _layer1("cache_state_shardings")
sharded_engine = _layer1("sharded_engine")


def __getattr__(name):
    # layer 3 is import-heavy (sockets, threads) and optional for layer 2
    # users: load it lazily on first touch
    if name in ("DistributedPodConfig", "DistributedPodRouter",
                "WorkerHandle", "build_local_distributed_pod"):
        from . import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
