"""Configuration records (the part of `accelerate_tpu/utils/dataclasses.py`
that the training step and checkpointing need), copied without its jax
imports."""

from __future__ import annotations

import enum
from dataclasses import dataclass


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
