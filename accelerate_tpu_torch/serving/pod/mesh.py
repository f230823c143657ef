"""Pod layer 1 (SPMD): tensor-parallel serving over a process mesh (port of
`accelerate_tpu/serving/pod/mesh.py`).

One engine, many devices: the family forward and the paged KV pool run
sharded over a mesh with a single `"model"` axis, so admit/prefill/decode
execute tensor-parallel while the engine's host-side machinery
(scheduler, paged allocator, prefix radix tree, page tables) is
untouched: page indices are data, and data doesn't care how the arrays
holding it are laid out.

The port runs one process per device, so the mesh is over processes
(`state.ProcessMesh`) and every rank runs the same engine on its shards,
SPMD: each rank makes the same calls (`submit`, `step`, `stream`,
`cancel`) in the same order, as a `debug_launcher` or launcher script
does. The engine keeps the ranks in lockstep (see `Engine`): its clock
is rank 0's, so every host decision is the same on every rank.

Division of labor:

- params: `shard_params` plans each leaf with the repo's path-pattern
  rules (`sharding/rules.py`, the Megatron column/row layout) and keeps
  this rank's shard (`sharding.shard_pytree`); the family's forward reads
  the specs and does the collectives (`models/tensor_parallel.py`);
- KV pool: sharded over the KV-heads dim when the head count divides the
  mesh axis (each rank holds its heads' pages; attention is
  head-parallel, so the pool never moves), else over the page dim when
  the page count (+1 trash page) divides it, else replicated
  (`cache_state_shardings` is the one place that policy lives);
- per-slot state (tokens/keys/temps/lengths): replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ...models.common import count_params
from ...models.tensor_parallel import ShardedParams
from ...sharding.planner import (
    NamedSharding,
    PartitionSpec,
    plan_sharding,
    shard_pytree,
)
from ...sharding.rules import ShardingRules, transformer_rules
from ...state import PartialState, ProcessMesh
from ...utils.constants import AXIS_MODEL

__all__ = [
    "tensor_mesh",
    "shard_params",
    "cache_state_shardings",
    "sharded_engine",
]


def tensor_mesh(num_devices: int | None = None, device=None) -> ProcessMesh:
    """A 1-D `("model",)` mesh over the first `num_devices` processes of
    the world (None = all; each process owns one device), whose shards
    live on `device` (CUDA unless "cpu"). The single axis is deliberate:
    serving decode is latency-bound, and tensor parallelism is the axis
    that cuts per-token latency; data/fsdp axes belong to training."""
    from ...device import resolve_device

    world = PartialState.num_processes
    n = world if num_devices is None else int(num_devices)
    if n < 1 or n > world:
        raise ValueError(
            f"num_devices={n} out of range (1..{world} processes)")
    return ProcessMesh({AXIS_MODEL: n}, device=resolve_device(device))


def shard_params(params: Any, mesh: ProcessMesh,
                 rules: ShardingRules | None = None) -> ShardedParams:
    """This rank's shard of a family's params under the transformer rule
    set (column-parallel qkv/up projections, row-parallel out/down, vocab
    on the model axis), on the mesh's device, with the placement the
    forward reads. Axes absent from the mesh prune away."""
    rules = rules if rules is not None else transformer_rules()
    plan = plan_sharding(params, mesh, rules)
    placed = ShardedParams(shard_pytree(params, plan), mesh, plan)
    placed.global_numel = count_params(params)
    return placed


def cache_state_shardings(cache, mesh: ProcessMesh):
    """(cache_shardings, replicated) for an engine's pool + slot state.

    The pool shards over the KV-heads dim (axis 3 of
    [L, pages+1, page_size, H, D]) when H divides the model axis: each
    rank owns its heads' pages outright and page gathers/scatters stay
    local. When H doesn't divide, the pool shards over the PAGE dim
    (axis 1) when the page count (+1 trash page) divides the axis: each
    rank owns a stripe of whole pages, so pool memory still scales 1/N,
    and each read sums the owned pages over the axis. Only when NEITHER
    dim divides does the pool replicate. int8 pools shard their scale
    arrays identically (same leading dims).

    The specs omit trailing None entries (`PartitionSpec(None, None,
    None, "model")`), as the reference's do."""
    n = mesh.shape[AXIS_MODEL]
    rep = NamedSharding(mesh, PartitionSpec())
    num_heads = cache.k.shape[3]
    # one spec serves pool and scales in every branch: the sharded dim
    # (heads = axis 3, pages = axis 1) sits at the same index in the 5-D
    # pool and the 4-D scale array
    if num_heads % n == 0:
        kv = NamedSharding(mesh, PartitionSpec(None, None, None, AXIS_MODEL))
    elif cache.k.shape[1] % n == 0:
        kv = NamedSharding(mesh, PartitionSpec(None, AXIS_MODEL))
    else:
        kv = rep
    cache_sh = dataclasses.replace(
        cache, k=kv, v=kv, lengths=rep,
        k_scale=kv if cache.quantized else None,
        v_scale=kv if cache.quantized else None)
    return cache_sh, rep


def sharded_engine(family, config, params, engine_config=None,
                   mesh: ProcessMesh | None = None,
                   tensor_parallel: int | None = None,
                   rules: ShardingRules | None = None, device=None,
                   **engine_kwargs):
    """The layer-1 factory: params sharded by rule, engine built with
    `EngineConfig(mesh=...)` so its pool and state are placed per rank.
    `tensor_parallel=N` builds the mesh over the first N processes, on
    `device` (CUDA unless "cpu"); pass `mesh` to control placement.
    Returns the ordinary `Engine`: submit/stream/cancel, the scheduler,
    prefix reuse and telemetry all work unchanged. A mesh of one is
    single-device serving (`EngineConfig.mesh` normalises to None)."""
    from ..engine import Engine, EngineConfig

    if mesh is None:
        mesh = tensor_mesh(tensor_parallel, device=device)
    ec = engine_config or EngineConfig()
    ec = dataclasses.replace(ec, mesh=mesh)
    placed = shard_params(params, mesh, rules)
    return Engine(family, config, placed, ec, device=device, **engine_kwargs)


class LockstepClock:
    """A clock that reads alike on every rank of a mesh's model axis:
    each call reads the local clock (so a rank's own clock sees the same
    calls) and returns rank 0's reading, broadcast over the axis.

    A meshed engine's host decisions read its clock: the TTFT estimate
    and the doomed-request shed of the scheduler, the deadline shed and
    the admissions of `_admit_pending`, the step-time average. Ranks that
    read their own clocks could decide differently, and one would then
    enter a collective the other never reaches. With this clock every
    decision is a function of the same calls and the same readings on
    every rank."""

    lockstep = True

    def __init__(self, clock, mesh: ProcessMesh):
        self._clock = clock
        self._mesh = mesh

    def __call__(self) -> float:
        from ...utils.operations import axis_broadcast_float

        return axis_broadcast_float(float(self._clock()),
                                    self._mesh.group(AXIS_MODEL))


def lockstep_clock(clock, mesh: ProcessMesh):
    """`clock` made a `LockstepClock` on `mesh` (once)."""
    if getattr(clock, "lockstep", False):
        return clock
    return LockstepClock(clock, mesh)


def place_pool(make, mesh: ProcessMesh, device):
    """(this rank's shard of a paged pool, (cache_shardings,
    replicated)). `make()` builds the whole pool; it runs on the meta
    device, so the whole pool is never allocated: each buffer is made at
    its shard's shape (a page shard with one dump page past its stripe,
    `cache.PoolShard`). Per-slot lengths replicate."""
    import torch

    from ...device import meta_init
    from ..cache import PoolShard

    with meta_init():
        whole = make()
    cache_sh, rep = cache_state_shardings(whole, mesh)
    spec = tuple(cache_sh.k.spec)
    dim = ("heads" if len(spec) == 4 else "pages" if len(spec) == 2
           else None)

    def local(name):
        t = getattr(whole, name)
        if t is None:
            return None
        shape = getattr(cache_sh, name).shard_shape(tuple(t.shape))
        if dim == "pages":
            shape = (shape[0], shape[1] + 1) + shape[2:]
        return torch.zeros(shape, dtype=t.dtype, device=device)

    shard = None
    if dim is not None:
        shard = PoolShard(dim, mesh.shape[AXIS_MODEL],
                          mesh.axis_index(AXIS_MODEL), whole.k.shape[1],
                          lambda: mesh.group(AXIS_MODEL))
    cache = dataclasses.replace(
        whole, k=local("k"), v=local("v"), k_scale=local("k_scale"),
        v_scale=local("v_scale"),
        lengths=torch.zeros(tuple(whole.lengths.shape),
                            dtype=whole.lengths.dtype, device=device),
        shard=shard)
    return cache, (cache_sh, rep)
