"""Parallel schedules of the port: pipeline parallelism over a mesh's
`stage` axis (`pipeline.py`) and the MoE sort dispatch (`moe.py`; its
expert-parallel entry points raise, queue 1 item 6b). Ring and Ulysses
attention (the reference's `context_attention`) arrive with that item
too."""

from .moe import expert_parallel_moe, expert_parallel_moe_a2a
from .pipeline import (
    ScheduleStats,
    pipeline_apply,
    pipeline_value_and_grad,
    stack_layers_into_stages,
    stack_layers_into_virtual_stages,
    stage_block,
)

__all__ = [
    "ScheduleStats",
    "expert_parallel_moe",
    "expert_parallel_moe_a2a",
    "pipeline_apply",
    "pipeline_value_and_grad",
    "stack_layers_into_stages",
    "stack_layers_into_virtual_stages",
    "stage_block",
]
