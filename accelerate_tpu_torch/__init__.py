"""PyTorch + CUDA port of accelerate_tpu, for NVIDIA Hopper.

The JAX package `accelerate_tpu` is the reference; this package keeps its
module layout and names so each piece has an obvious counterpart, and uses
PyTorch's idiom inside: plain functions on tensors, params as a nested
dict with the JAX tree's keys and stacked `[L, ...]` shapes, an explicit
`device` and explicit generators.

It imports `torch` and never `jax`, and nothing of `accelerate_tpu` (any
module there runs that package's `__init__`, which imports jax). Entry
points run on CUDA unless the caller passes `device="cpu"`; with no GPU
and no `device="cpu"` they raise.

Ported so far:
- the serving engine's path (`serving.Engine` over `models.llama`), with
  the paged-decode attention kernel written in CUDA
  (`csrc/paged_decode.cu`, wrapped by `ops.paged_attention`);
- the training step (`accelerator.Accelerator`, `training.TrainState`,
  `optimizers.adamw`, `models.llama.causal_lm_loss`), with the flash
  attention forward and backward kernels written in CUDA
  (`csrc/flash_attention.cu`, wrapped by `ops.flash_attention`);
- the OpenAI-compatible HTTP front door over the engine (`server`,
  `python -m accelerate_tpu_torch.commands.serve`), with request tracing
  (`telemetry.trace`) and the Prometheus exposition (`telemetry.export`);
- checkpointing (`checkpointing`: sync and async saves committed by
  manifest, resume, retention, safetensors export) and the resilient
  training loop (`training.run_resilient`, `profiler.StepTimer`,
  `telemetry.StragglerMonitor`);
- big-model inference (`big_modeling`: meta init, device maps, host and
  disk offload, int8/int4 weight loading, streamed decode), with the
  memory helpers (`utils.memory`) and the estimator
  (`python -m accelerate_tpu_torch.commands.estimate`).
"""

from .device import resolve_device

__version__ = "0.1.0"

# the reference's top-level names that the port has; each module loads
# when its name is first read
_LAZY = {
    "Accelerator": ".accelerator",
    "TrainState": ".training",
    "DynamicLossScale": ".training",
    "run_resilient": ".training",
    "ResilienceReport": ".training",
    "resume_latest": ".checkpointing",
    "latest_complete_checkpoint": ".checkpointing",
    "prune_checkpoints": ".checkpointing",
    "wait_for_checkpoints": ".checkpointing",
    "skip_first_batches": ".data",
    "DataLoaderShard": ".data",
    "ProjectConfiguration": ".utils.dataclasses",
    "GradientAccumulationPlugin": ".utils.dataclasses",
    "profile": ".profiler",
    "StepTimer": ".profiler",
    "device_memory_stats": ".profiler",
    "MetricsRegistry": ".telemetry",
    "get_registry": ".telemetry",
    "span": ".telemetry",
    "configure_tracing": ".telemetry",
    "export_chrome_trace": ".telemetry",
    "render_prometheus": ".telemetry",
    "aggregate_snapshot": ".telemetry",
    "StragglerMonitor": ".telemetry",
    "find_executable_batch_size": ".utils.memory",
    "release_memory": ".utils.memory",
    "init_empty_weights": ".big_modeling",
    "infer_auto_device_map": ".big_modeling",
    "get_balanced_memory": ".big_modeling",
    "get_max_memory": ".big_modeling",
    "load_checkpoint_and_dispatch": ".big_modeling",
    "dispatch_model": ".big_modeling",
    "prepare_pipeline": ".inference",
    "prepare_sharded_inference": ".inference",
}

__all__ = ["resolve_device", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name], __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
