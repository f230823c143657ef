"""Parallel schedules of the port: ring and Ulysses attention over a
mesh's `seq` axis (`ring_attention.py`, `ulysses.py`, dispatched by
`context_attention`), pipeline parallelism over its `stage` axis
(`pipeline.py`), and the MoE sort dispatch with its expert-parallel
forms over the `expert` axis (`moe.py`)."""

from .moe import (
    MoEFallbackWarning,
    expert_parallel_moe,
    expert_parallel_moe_a2a,
)
from .pipeline import (
    ScheduleStats,
    pipeline_apply,
    pipeline_value_and_grad,
    stack_layers_into_stages,
    stack_layers_into_virtual_stages,
    stage_block,
)
from .ring_attention import ring_attention
from .ulysses import ulysses_attention

__all__ = [
    "MoEFallbackWarning",
    "ScheduleStats",
    "context_attention",
    "expert_parallel_moe",
    "expert_parallel_moe_a2a",
    "pipeline_apply",
    "pipeline_value_and_grad",
    "ring_attention",
    "stack_layers_into_stages",
    "stack_layers_into_virtual_stages",
    "stage_block",
    "ulysses_attention",
]


def context_attention(q, k, v, causal: bool = True, mode: str | None = None,
                      mesh=None, axis_name: str = "seq",
                      window: int | None = None):
    """Sequence-parallel attention dispatched by
    `ContextParallelPlugin.mode` ("ring" rotates K/V chunks; "ulysses"
    scatters heads by all-to-all). With no mode given it reads the
    plugin of the live `AcceleratorState`, and defaults to ring.
    `window` applies Mistral's sliding-window band in either mode."""
    if mode is None:
        from ..state import AcceleratorState

        mode = "ring"
        if AcceleratorState._shared_state:
            plugin = AcceleratorState._shared_state.get(
                "context_parallel_plugin")
            if plugin is not None:
                mode = plugin.mode
    if mode == "ulysses":
        return ulysses_attention(q, k, v, causal=causal, mesh=mesh,
                                 axis_name=axis_name, window=window)
    return ring_attention(q, k, v, causal=causal, mesh=mesh,
                          axis_name=axis_name, window=window)
