"""Multi-device inference (`accelerate_tpu/inference.py`): pipeline stages
and sharded inference over a device mesh. Both need the mesh and the
sharding planner, which arrive with the port's sharded-parallelism slice
(ROADMAP.md, queue 1 item 6b); until then they raise. One card runs big
models through `big_modeling` (device maps, offload, streamed decode)."""

from __future__ import annotations


def _unported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} needs a device mesh, which arrives with the port's "
        "sharded-parallelism slice (ROADMAP.md, queue 1 item 6b); on one card use "
        "big_modeling.load_checkpoint_and_dispatch and streamed_generate")


def prepare_pipeline(*args, **kwargs):
    raise _unported("prepare_pipeline")


def prepare_sharded_inference(*args, **kwargs):
    raise _unported("prepare_sharded_inference")
