"""Configuration records (the part of `accelerate_tpu/utils/dataclasses.py`
that the training step, fp8, checkpointing and quantized loading need),
copied without its jax imports."""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any


class PrecisionType(str, enum.Enum):
    """Mixed-precision policy names, as in the reference."""

    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8 = "fp8"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def list(cls) -> list[str]:
        return [v.value for v in cls]


def resolve_mixed_precision(value) -> PrecisionType:
    """None means "no": the port reads no environment variable for it."""
    return PrecisionType(str("no" if value is None else value).lower())


@dataclass
class GradientAccumulationPlugin:
    """`num_steps` micro-batches per optimizer step; the other fields keep
    the reference's names and defaults."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class ProjectConfiguration:
    """Checkpoint directory layout and retention, as in the reference:
    `automatic_checkpoint_naming` saves into
    `<project_dir>/checkpoints/checkpoint_<n>`, and `total_limit` prunes
    the oldest of them beyond that many."""

    project_dir: str | None = None
    logging_dir: str | None = None
    automatic_checkpoint_naming: bool = False
    total_limit: int | None = None
    iteration: int = 0
    save_on_each_node: bool = False

    def __post_init__(self) -> None:
        if self.logging_dir is None:
            self.logging_dir = self.project_dir

    def set_directories(self, project_dir: str | None = None) -> None:
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir


class KwargsHandler:
    """Base marker of `Accelerator(kwargs_handlers=[...])`'s records."""

    def to_kwargs(self) -> dict[str, Any]:
        """The fields that differ from the defaults."""
        default = self.__class__()
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)  # type: ignore[arg-type]
            if getattr(self, f.name) != getattr(default, f.name)
        }


@dataclass
class AutocastKwargs(KwargsHandler):
    """`enabled=False` pins the train step's compute to f32 whatever the
    mixed-precision policy; `cache_enabled` is kept for the signature."""

    enabled: bool = True
    cache_enabled: bool = True


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """The process group's backend, address and timeout. One process has
    no group: a timeout raises until the parallelism slice."""

    backend: str | None = "jax"
    init_method: str | None = None
    timeout: timedelta = field(default_factory=lambda: timedelta(seconds=1800))


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """The delayed-scaling recipe of `ops/fp8.py`. `amax_history_len=None`
    resolves to a 16-step window (`ops.fp8.resolve_history_len`); pass a
    value for longer windows."""

    backend: str = "native"
    margin: int = 0
    fp8_format: str = "E4M3"
    amax_history_len: int | None = None
    amax_compute_algo: str = "max_along_history"


@dataclass
class QuantizationConfig(KwargsHandler):
    """Block-wise int8/int4 weight-only quantization for big-model
    inference (`ops/quant.py`, `big_modeling.load_and_quantize_params`).
    Weights whose path holds one of `skip_modules` stay unquantized."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    block_size: int = 128
    skip_modules: tuple[str, ...] = ("lm_head",)
    compute_dtype: str = "bfloat16"

    @property
    def bits(self) -> int:
        if self.load_in_4bit:
            return 4
        if self.load_in_8bit:
            return 8
        return 16
