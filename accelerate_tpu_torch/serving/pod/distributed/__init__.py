"""Layer 3: the pod across OS processes — wire transport, worker
heartbeats + failure recovery, elastic prefill/decode rebalancing (port
of `accelerate_tpu/serving/pod/distributed`).

The in-process `PodRouter` stays the `local` form; this package is the
same dataflow over real process boundaries:

- `wire` — length-prefixed frames (JSON header + raw numpy buffers, no
  pickle) carrying `KVPageShipment`'s codes+scales format (bf16 as raw
  16-bit words under the reference's "bfloat16" tag) and all control
  traffic.
- `transport` — `LocalChannel` (in-process, still through the codec),
  `SocketChannel` (bounded send queue = backpressure stalls the router,
  never a prefill worker), `FlakyTransport` (deterministic fault
  injection: drop/dup/delay/reorder, kill/hang).
- `worker` — `WorkerServer`: one role-agnostic Engine behind a channel;
  heartbeats carry stats + the registry snapshot; SIGTERM drains.
- `droute` — `DistributedPodRouter`: the `ServingEngine`-API front that
  holds no device state, recovers every failure by
  re-prefill-from-prompt (byte-exact via position-folded sampling
  keys), and converts idle workers between roles from live load.

`python -m accelerate_tpu_torch.commands.pod pod-router` runs it as
processes.
"""

from .droute import (
    DistributedPodConfig,
    DistributedPodRouter,
    WorkerHandle,
    build_local_distributed_pod,
)
from .transport import (
    Channel,
    ChannelListener,
    FlakyTransport,
    LocalChannel,
    SocketChannel,
)
from .wire import (
    Message,
    decode_message,
    encode_message,
    shipment_from_message,
    shipment_to_message,
)
from .worker import WorkerServer, build_worker_engine

__all__ = [
    "DistributedPodConfig",
    "DistributedPodRouter",
    "WorkerHandle",
    "build_local_distributed_pod",
    "Channel",
    "ChannelListener",
    "FlakyTransport",
    "LocalChannel",
    "SocketChannel",
    "Message",
    "encode_message",
    "decode_message",
    "shipment_to_message",
    "shipment_from_message",
    "WorkerServer",
    "build_worker_engine",
]
