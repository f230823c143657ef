"""Configuration records (the part of `accelerate_tpu/utils/dataclasses.py`
that the training step needs), copied without its jax imports."""

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
