"""Distributed inference (port of `accelerate_tpu/inference.py`):
pipeline-parallel and sharded serving of a model across processes.

- `prepare_pipeline` keeps this rank's stage of layer-stacked params
  (the mesh's `stage` axis) and runs the GPipe schedule of
  `parallel/pipeline.py` on every call: micro-batches handed stage to
  stage (`utils.operations.axis_ppermute`), the last stage's output
  broadcast to every rank (the reference's `gather_output=True`).
- `prepare_sharded_inference` places the params with the planner's
  rules (`sharding.plan_sharding`, `shard_pytree`). The reference jits
  the forward and lets GSPMD insert the collectives; the port has no
  GSPMD, so the forward it returns takes one of two declared routes (see
  its docstring): the family's tensor-parallel forward on the shards,
  or a gather of every sharded leaf at the call.

Both run on every rank of the world (SPMD), with the same inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Any, Callable

import numpy as np
import torch

from .device import resolve_device
from .models.common import unstack_layers
from .models.tensor_parallel import ShardedParams
from .parallel.pipeline import (
    ScheduleStats,
    _default_mesh,
    pipeline_apply,
    stack_layers_into_stages,
    stage_block,
)
from .sharding.planner import NamedSharding, _map_with_path, _path_str, \
    leaves_with_path, plan_sharding, shard_pytree
from .sharding.rules import ShardingRules
from .utils.constants import AXIS_MODEL, AXIS_STAGE

__all__ = [
    "make_stage_fn",
    "prepare_pipeline",
    "prepare_sharded_inference",
    "PipelinedModel",
    "ShardedForward",
]


def make_stage_fn(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor]
                  ) -> Callable:
    """Lift a per-layer body into a per-stage body: `layer_fn(
    layer_params, x) -> x` is one block; the stage body applies it over
    the stage's `[L/S, ...]`-stacked slice, layer by layer (PiPPy's
    equal-layer split, as a reshape)."""

    def stage_fn(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        first = stage_params
        while isinstance(first, (dict, list, tuple)):
            first = next(iter(first.values())) if isinstance(first, dict) \
                else first[0]
        for layer in unstack_layers(stage_params, first.shape[0]):
            x = layer_fn(layer, x)
        return x

    return stage_fn


@dataclasses.dataclass
class PipelinedModel:
    """Callable handle returned by `prepare_pipeline`: call it with the
    global batch on every rank; every rank gets the full output (the
    reference's `gather_output=True`). `stage_params` is this rank's
    block only ([1, L/S, ...] leaves); `stats` is what the last call did
    on this rank (`parallel.ScheduleStats`)."""

    stage_params: Any
    num_stages: int
    num_chunks: int
    device: torch.device
    _run: Callable
    stats: ScheduleStats | None = None

    def __call__(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        self.stats = ScheduleStats()
        return self._run(self.stage_params, x.to(self.device), self.stats)


def prepare_pipeline(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    layer_params: Any,
    *,
    num_chunks: int | None = None,
    mesh=None,
    axis_name: str = AXIS_STAGE,
    pre_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    post_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    device=None,
) -> PipelinedModel:
    """Pipeline-parallel inference over the mesh's `stage` axis (the
    reference's `prepare_pippy`).

    Args:
      layer_fn: one decoder block, `layer_fn(layer_params_slice, x) -> x`.
      layer_params: a tree whose leaves lead with the layer dim L (the
        stacked layout of every `models/` family), the same on every
        rank; this rank keeps a copy of its stage's L/S layers.
      num_chunks: micro-batches a call; defaults to the number of stages.
      pre_fn / post_fn: embedding / head, run outside the pipelined body
        on every rank (replicated).
      device: where the stage lives and runs (CUDA unless "cpu").
    """
    mesh = _default_mesh(mesh)
    num_stages = mesh.shape.get(axis_name, 1)
    if num_stages <= 1:
        raise ValueError(
            f"mesh has no '{axis_name}' axis; use prepare_sharded_inference "
            "for single-stage (sharded) serving")
    dev = resolve_device(device)
    if num_chunks is None:
        num_chunks = num_stages
    block = stage_block(stack_layers_into_stages(layer_params, num_stages),
                        mesh, axis_name, device=dev)
    stage_fn = make_stage_fn(layer_fn)

    def run(stage_params, x, stats):
        if pre_fn is not None:
            x = pre_fn(x)
        y = pipeline_apply(stage_fn, stage_params, x, num_chunks, mesh=mesh,
                           axis_name=axis_name, stats=stats)
        if post_fn is not None:
            y = post_fn(y)
        return y

    return PipelinedModel(stage_params=block, num_stages=num_stages,
                          num_chunks=num_chunks, device=dev, _run=run)


def _family_module(fn):
    """The model module a forward belongs to (through partials)."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return sys.modules.get(getattr(fn, "__module__", "") or "")


def _gather_whole(params: ShardedParams) -> Any:
    """The whole tree of `params`: every sharded leaf all-gathered over
    the axes its spec names (minor axis first), on its device."""
    from .utils.operations import axis_all_gather

    mesh = params.mesh
    specs = dict(leaves_with_path(
        params.plan, is_leaf=lambda x: isinstance(x, NamedSharding)))

    def whole(path, leaf):
        spec = specs[path].spec
        for dim, entry in enumerate(spec):
            axes = () if entry is None else entry \
                if isinstance(entry, tuple) else (entry,)
            for axis in reversed(axes):
                leaf = axis_all_gather(leaf, dim, mesh.group(axis))
        return leaf

    return _map_with_path(lambda p, leaf: whole(_path_str(p), leaf),
                          dict(params))


class ShardedForward:
    """The forward `prepare_sharded_inference` returns; `route` says how
    it runs: "tensor_parallel" (the family's forward on the shards) or
    "gather" (each `ShardedParams` argument gathered whole at the call,
    then the function on whole tensors). Called with the same arguments
    as the function, the sharded params in the params' place."""

    def __init__(self, forward_fn: Callable, route: str):
        self.forward_fn = forward_fn
        self.route = route

    def __call__(self, *args, **kwargs):
        if self.route == "gather":
            args = tuple(_gather_whole(a) if isinstance(a, ShardedParams)
                         else a for a in args)
            kwargs = {k: _gather_whole(v) if isinstance(v, ShardedParams)
                      else v for k, v in kwargs.items()}
        return self.forward_fn(*args, **kwargs)


def prepare_sharded_inference(
    forward_fn: Callable[..., Any],
    params: Any,
    *,
    mesh=None,
    rules: ShardingRules | None = None,
    device=None,
) -> tuple[ShardedForward, ShardedParams]:
    """Sharded inference: `params` planned on the mesh with the
    planner's rules (tensor-parallel `model` axis, `fsdp` gather-on-use)
    and this rank's shards kept on `device` (CUDA unless "cpu"); returns
    `(fn, sharded_params)`, called as `forward_fn` is, with
    `sharded_params` in the params' place, on every rank.

    Routes (`fn.route`): a family forward with a tensor-parallel path
    (`llama.forward`, `gpt2.forward`, or a partial of one) over a plan
    that shards only on the `model` axis runs that path on the shards,
    its collectives over the axis ("tensor_parallel"). Any other
    function, or a plan over other axes, gathers each sharded leaf over
    its axes at every call, as the reference's `fsdp` gather-on-use
    does, then runs on whole tensors ("gather"): the call moves the
    sharded bytes, the placement keeps only the shards."""
    mesh = _default_mesh(mesh)
    dev = resolve_device(device)
    plan = plan_sharding(params, mesh, rules=rules)
    module = _family_module(forward_fn)
    axes = {a for _, s in leaves_with_path(
        plan, is_leaf=lambda x: isinstance(x, NamedSharding))
        for a in s.spec.axes()}
    tp = getattr(module, "TENSOR_PARALLEL", False) and axes <= {AXIS_MODEL}
    placed = shard_pytree(params, plan, device=dev)
    sharded = ShardedParams(placed, mesh, plan, tensor_parallel=tp)
    return ShardedForward(forward_fn, "tensor_parallel" if tp else "gather"), \
        sharded
