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
  (`telemetry.trace`) and the Prometheus exposition (`telemetry.export`).
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
