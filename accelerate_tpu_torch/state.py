"""Process and precision singletons (port of `accelerate_tpu/state.py`:
`PartialState`, `AcceleratorState`, `GradientState`), one process per
device as in torch's idiom, where the reference runs one JAX process
over every local chip.

`PartialState()` joins a `torch.distributed` world when torchrun's
variables (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
`MASTER_ADDR`, `MASTER_PORT`) describe more than one process, as the
port's launcher (`python -m accelerate_tpu_torch.commands.launch`) and
torchrun set them; a world of one joins no group. A group the caller
already initialised is adopted as it is. The rank's device is
`cuda:{LOCAL_RANK}`, or the CPU with `cpu=True` (or the launcher's
`--cpu`).

The backend rule, decided before the group is joined and never after a
failure: `backend=None` is NCCL on a card and gloo on the CPU. Ranks
may outnumber the cards only under an explicit gloo
(`InitProcessGroupKwargs(backend="gloo")`): each rank then takes card
`LOCAL_RANK % device_count`, and NCCL with two ranks on one card raises.

The topology (`num_processes`, `process_index`, `is_main_process`, ...)
is kept on the class and follows the live group, so it reads the same
from the class or an instance, and survives `_reset_state` while the
group lives (as the reference's `jax.process_count()` does).

As in the reference, every instance of a class aliases one shared dict,
and `_reset_state` clears them all (for tests).
"""

from __future__ import annotations

import atexit
import dataclasses
import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .device import resolve_device
from .utils.constants import (
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    AXIS_STAGE,
    BATCH_AXES,
    ENV_CPU,
    ENV_DEBUG_MODE,
    ENV_LOCAL_RANK,
    ENV_LOCAL_WORLD_SIZE,
    ENV_RANK,
    ENV_WORLD_SIZE,
)
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MeshConfig,
    PrecisionType,
    resolve_mixed_precision,
)
from .utils.environment import get_int_from_env, parse_flag_from_env


def _dist_live() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def _resolve_backend(backend: str | None, device: torch.device,
                     local_world: int) -> str:
    """The backend for `device`: gloo on the CPU, NCCL on a card unless
    gloo is asked for. NCCL puts one rank on a card: more local ranks
    than cards raises here, before any group is joined."""
    if backend is not None:
        backend = backend.lower()
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{backend!r}")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; the CPU "
                             "runs on gloo")
        return "gloo"
    backend = backend or "nccl"
    count = torch.cuda.device_count()
    if backend == "nccl" and local_world > count:
        raise ValueError(
            f"{local_world} local ranks on {count} CUDA device(s): NCCL "
            "puts one rank on a device. To share a device between ranks, "
            "ask for gloo explicitly: Accelerator(kwargs_handlers="
            "[InitProcessGroupKwargs(backend=\"gloo\")]) or "
            "PartialState(backend=\"gloo\")")
    return backend


class PartialState:
    """This process's rank and device: CUDA unless `cpu=True`, raising
    with no GPU and no `cpu=True`. Keyword arguments `backend`,
    `init_method` and `timeout` reach the process group (see the module
    docstring)."""

    _shared_state: dict[str, Any] = {}

    # topology, kept on the class (see `_sync_topology`)
    num_processes = 1
    process_index = 0
    local_process_index = 0
    is_main_process = True
    is_local_main_process = True
    is_last_process = True
    use_distributed = False
    device_count = 1
    local_device_count = 1

    def __init__(self, cpu: bool = False, *, backend: str | None = None,
                 init_method: str | None = None,
                 timeout: timedelta | None = None) -> None:
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        cpu = cpu or parse_flag_from_env(ENV_CPU)
        if _dist_live():
            world = torch.distributed.get_world_size()
            rank = torch.distributed.get_rank()
        else:
            world = get_int_from_env((ENV_WORLD_SIZE,), 1)
            rank = get_int_from_env((ENV_RANK,), 0)
        local_rank = get_int_from_env((ENV_LOCAL_RANK,), rank) \
            if world > 1 else 0
        local_world = get_int_from_env((ENV_LOCAL_WORLD_SIZE,), world)
        device = resolve_device("cpu" if cpu else None)
        if world > 1:
            live = _dist_live()
            chosen = torch.distributed.get_backend() if live else \
                _resolve_backend(backend, device, local_world)
            if device.type == "cuda":
                device = torch.device(
                    "cuda", local_rank % torch.cuda.device_count())
                torch.cuda.set_device(device)
            if not live:
                kwargs: dict[str, Any] = {}
                if timeout is not None:
                    kwargs["timeout"] = timeout
                torch.distributed.init_process_group(
                    chosen, init_method=init_method or "env://",
                    world_size=world, rank=rank, **kwargs)
                # leave the group at exit, before its threads are torn
                # down under it
                atexit.register(_leave_group)
            self.backend = chosen
            self.distributed_type = (DistributedType.MULTI_GPU
                                     if device.type == "cuda"
                                     else DistributedType.MULTI_CPU)
        else:
            self.backend = device.type
            self.distributed_type = DistributedType.NO
        self.device = device
        self.debug = parse_flag_from_env(ENV_DEBUG_MODE)
        self._mesh = None
        _sync_topology()

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @classmethod
    def _reset_state(cls) -> None:
        """Clear all singleton state (test use). A live process group
        stays joined, and the topology with it."""
        cls._shared_state.clear()
        AcceleratorState._shared_state.clear()
        GradientState._shared_state.clear()
        _sync_topology()

    @property
    def devices(self) -> list[torch.device]:
        """This process's devices: the one it owns."""
        return [self.device]

    @property
    def mesh(self) -> "ProcessMesh":
        """The data-parallel mesh over every process, unless
        `AcceleratorState` resolved another."""
        if self._mesh is None:
            self._mesh = ProcessMesh(MeshConfig.data_parallel()
                                     .resolved_axes(self.num_processes))
        return self._mesh

    def set_mesh(self, mesh: "ProcessMesh") -> None:
        self._mesh = mesh

    # -- process control -----------------------------------------------------
    def wait_for_everyone(self) -> None:
        """A barrier across the world's processes."""
        if type(self).num_processes > 1:
            torch.distributed.barrier()

    @contextmanager
    def main_process_first(self) -> Iterator[None]:
        """The main process runs the body first; the others wait for it,
        then run theirs."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self) -> Iterator[None]:
        """The local main process of each host first (one host: the main
        process)."""
        if not self.is_local_main_process:
            self.wait_for_everyone()
        yield
        if self.is_local_main_process:
            self.wait_for_everyone()

    @contextmanager
    def split_between_processes(self, inputs,
                                apply_padding: bool = False) -> Iterator[Any]:
        """This process's contiguous share of a list, tuple, dict of
        equal-length values or tensor: the first `len % n` processes take
        one more. With `apply_padding` every share is padded to the
        longest (a sequence repeats its last element, an array gains zero
        rows), so a `gather` is legal. One process gets all of it,
        unpadded."""
        world = self.num_processes
        if world == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            lengths = {k: len(v) for k, v in inputs.items()}
            if len(set(lengths.values())) != 1:
                raise ValueError("All dict values must share a length to be "
                                 f"split, got {lengths}")
            length = next(iter(lengths.values()))
        else:
            length = len(inputs)
        per, remainder = divmod(length, world)
        rank = self.process_index
        start = rank * per + min(rank, remainder)
        end = start + per + (1 if rank < remainder else 0)
        if isinstance(inputs, dict):
            result = {k: v[start:end] for k, v in inputs.items()}
        else:
            result = inputs[start:end]
        if apply_padding and per * world != length:
            if isinstance(result, dict):
                result = {k: _pad_slice(v, per + 1)
                          for k, v in result.items()}
            else:
                result = _pad_slice(result, per + 1)
        yield result

    def on_main_process(self, function: Callable) -> Callable:
        """`function`, run only on global rank 0 (None elsewhere)."""
        def wrapper(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_local_main_process(self, function: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if self.is_local_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_last_process(self, function: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if self.is_last_process:
                return function(*args, **kwargs)

        return wrapper

    def on_process(self, function: Callable,
                   process_index: int = 0) -> Callable:
        """`function`, run only on `process_index` (None elsewhere)."""
        def wrapper(*args, **kwargs):
            if self.process_index == process_index:
                return function(*args, **kwargs)

        return wrapper

    def print(self, *args: Any, **kwargs: Any) -> None:
        """Print on the main process only."""
        if self.is_main_process:
            print(*args, **kwargs)

    def destroy_process_group(self) -> None:
        """Leave the process group, if one was joined."""
        if _dist_live():
            torch.distributed.destroy_process_group()
        _sync_topology()

    def __repr__(self) -> str:
        return (f"PartialState(distributed_type="
                f"{self.__dict__.get('distributed_type')}, "
                f"num_processes={self.num_processes}, "
                f"process_index={self.process_index}, "
                f"device={self.__dict__.get('device')})")


def _leave_group() -> None:
    if _dist_live():
        torch.distributed.destroy_process_group()


def _sync_topology() -> None:
    """Set the class's topology from the live process group (a world of
    one without it)."""
    if _dist_live():
        world = torch.distributed.get_world_size()
        rank = torch.distributed.get_rank()
    else:
        world, rank = 1, 0
    local = get_int_from_env((ENV_LOCAL_RANK,), rank) if world > 1 else 0
    cls = PartialState
    cls.num_processes = world
    cls.process_index = rank
    cls.local_process_index = local
    cls.is_main_process = rank == 0
    cls.is_local_main_process = local == 0
    cls.is_last_process = rank == world - 1
    cls.use_distributed = world > 1
    cls.device_count = world


def _pad_slice(seq, pad_to: int):
    """`seq` grown to `pad_to` entries: an array or tensor by zero rows,
    a sequence by repeating its last element."""
    n = len(seq)
    if n >= pad_to:
        return seq
    if isinstance(seq, torch.Tensor):
        pad = seq.new_zeros((pad_to - n,) + tuple(seq.shape[1:]))
        return torch.cat([seq, pad])
    if isinstance(seq, np.ndarray):
        width = [(0, pad_to - n)] + [(0, 0)] * (seq.ndim - 1)
        return np.pad(seq, width)
    return seq + seq[-1:] * (pad_to - n) if n else seq


STEP_2B = ("the port's sharded-parallelism slice (ROADMAP.md, queue 1 "
           "item 6b, step 2b: FSDP/ZeRO-3 parameter sharding)")
STEP_2C = ("the port's sharded-parallelism slice (ROADMAP.md, queue 1 "
           "item 6b, step 2c: the `model` axis with Megatron)")


def _refuse_sharded(axes: dict[str, int], params_whole: bool = False) -> None:
    """Raise for a mesh the Accelerator does not train on: a `model` axis
    above 1 (step 2c), and an `fsdp` axis above 1 unless the plan keeps
    params whole (`params_whole`: ZeRO-1/2, `SHARD_GRAD_OP`, stage 0 or
    `NO_SHARD`); a bare `fsdp` mesh shards params, as the reference
    plans it (step 2b). ZeRO's `fsdp` axis beside a `stage`, `seq` or
    `expert` axis above 1 raises too (step 2b). Sizes of -1 (fill) are
    taken here: call it again on the resolved axes."""
    if axes.get(AXIS_MODEL, 1) > 1:
        raise NotImplementedError(
            f"a mesh axis 'model' of size {axes[AXIS_MODEL]} (tensor-"
            f"parallel training) arrives with {STEP_2C}; the port trains "
            "over `data`, ZeRO-1/2 over `fsdp`, pipeline stages over "
            "`stage`, ring and Ulysses attention over `seq` and expert "
            "parallelism over `expert`")
    fsdp = axes.get(AXIS_FSDP, 1)
    if fsdp <= 1:
        return
    if not params_whole:
        raise NotImplementedError(
            f"a mesh axis 'fsdp' of size {fsdp} without a plugin that "
            "keeps params whole shards params (the reference's plan), "
            f"which arrives with {STEP_2B}; ZeRO-1/2 trains on it: "
            "DeepSpeedPlugin(zero_stage=1 or 2) or FullyShardedDataParallel"
            "Plugin(sharding_strategy=\"SHARD_GRAD_OP\")")
    beside = {a: s for a, s in axes.items()
              if a in (AXIS_STAGE, AXIS_SEQ, AXIS_EXPERT) and s > 1}
    if beside:
        raise NotImplementedError(
            f"ZeRO on an 'fsdp' axis of size {fsdp} beside {beside} "
            f"arrives with {STEP_2B}; ZeRO-1/2 trains on `data` x `fsdp`")


@dataclasses.dataclass(frozen=True)
class DataLine:
    """This rank's batch line (`ProcessMesh.data_line`): the ranks that
    split a global batch between them. `size` ranks and this rank's
    `index` on the line, over `axes` of `mesh` (None: the world)."""

    size: int
    index: int
    mesh: "ProcessMesh | None" = None
    axes: tuple = ()

    @property
    def group(self):
        """The line's group: None for a line of one, the world's where
        the line is the world, else the mesh's subgroup, made on first
        access by every rank (`ProcessMesh.group_over`). Read it where
        every rank does (a step's collectives), never on a loader's
        prefetch thread."""
        if self.size == 1:
            return None
        if self.mesh is None:
            return torch.distributed.group.WORLD
        return self.mesh.group_over(self.axes)


class ProcessMesh:
    """The port's device mesh: each process owns one device, so the mesh
    is over processes, ranks 0..size-1 laid out row-major over the axes
    (the last axis fastest), as the reference lays devices out over its
    mesh. `shape` is the reference's `dict(mesh.shape)` ({axis: size})
    and `axis_names` its names; `groups[axis]` is the `torch.distributed`
    group of this rank's line along that axis: the world where the line
    is the whole world, a subgroup (`new_group`, made on first access
    by every rank, for every line of the axis) where it is part of it,
    None for an axis of size 1 or in a world of one. `device` is where
    `sharding.shard_pytree` puts this rank's shards (None: where each
    leaf already is).

    The Accelerator and the launcher take the `data`, `stage`, `seq`
    and `expert` axes, and `fsdp` under ZeRO-1/2 (`_refuse_sharded`);
    the serving mesh
    (`serving.pod.tensor_mesh`) is one `model` axis; `MeshConfig.build()`
    makes any mesh."""

    def __init__(self, axes: dict[str, int], device=None):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.device = None if device is None else torch.device(device)

    @property
    def rank(self) -> int:
        """This process's rank in the mesh (0 in a world of one)."""
        r = PartialState.process_index if _dist_live() else 0
        if r >= self.size:
            raise ValueError(f"rank {r} is outside {self!r}")
        return r

    def coords(self, rank: int) -> dict[str, int]:
        """{axis: index} of `rank` on the mesh."""
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def line_ranks(self, axes, rank: int | None = None) -> list[int]:
        """The ranks that share `rank`'s coordinates on every axis but
        `axes`, row-major over `axes` in the mesh's axis order: `rank`'s
        line along those axes."""
        c = self.coords(self.rank if rank is None else rank)
        axes = [a for a in self.axis_names if a in axes]
        dims = tuple(self.shape.values())
        out = []
        for idx in np.ndindex(*(self.shape[a] for a in axes)):
            c.update(zip(axes, idx))
            out.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], dims)))
        return out

    def axis_ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The ranks on `rank`'s line along `axis`, in axis order."""
        return self.line_ranks((axis,), rank)

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.coords(self.rank)[axis]

    @property
    def groups(self) -> dict:
        # looked up at each access: a mesh that held a group would keep
        # it, and gloo's threads, alive past `destroy_process_group`, and
        # a process that exits with those threads running can abort
        return {a: self.group(a) for a in self.axis_names}

    def group(self, axis: str):
        return self.group_over((axis,))

    def group_over(self, axes):
        """The group of this rank's line along `axes` (`line_ranks`):
        None where the line is one rank or no world is live, the world's
        group where it is the whole world, else a subgroup (`new_group`,
        made on first access by every rank, for every line along those
        axes, and held weakly)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        live = PartialState.num_processes > 1 and _dist_live()
        if not live or int(np.prod([self.shape[a] for a in axes])) == 1:
            return None
        world = torch.distributed.get_world_size()
        line = self.line_ranks(axes)
        if line == list(range(world)):
            return torch.distributed.group.WORLD
        return _subgroup(self, axes, tuple(line))

    def data_line(self) -> DataLine:
        """This rank's batch line: the ranks that share its `stage`,
        `seq`, `expert` (and `model`) coordinates, over the batch axes
        (`data`, `fsdp`). They split each global batch between them, as
        the reference shards a batch over those axes only, so the ranks
        of one `stage`, `seq` or `expert` line see the same rows, and
        the gradients average over this line alone. On a mesh of `data`
        alone the line is the world. No group is made here (see
        `DataLine.group`)."""
        axes = tuple(a for a in self.axis_names if a in BATCH_AXES)
        size = int(np.prod([self.shape[a] for a in axes]))
        if size == 1:
            return DataLine(1, 0)
        coords = self.coords(self.rank)
        index = int(np.ravel_multi_index(
            [coords[a] for a in axes], [self.shape[a] for a in axes]))
        return DataLine(size, index, self, axes)

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape})"


def mesh_or_state(mesh: "ProcessMesh | None") -> "ProcessMesh | None":
    """`mesh`, else the process state's mesh, else None (no state yet:
    the schedules of `parallel/` then run as off a mesh)."""
    if mesh is None and PartialState._shared_state:
        mesh = PartialState().mesh
    return mesh


def data_line(mesh: "ProcessMesh | None" = None,
              state: "PartialState | None" = None) -> DataLine:
    """The batch line (`ProcessMesh.data_line`) of `mesh`, else of the
    process state's mesh; the world of `state`'s processes (default: the
    process state's), where no mesh lays out its processes (one process:
    a line of one)."""
    state = PartialState if state is None else state
    world = state.num_processes
    if world == 1:
        return DataLine(1, 0)
    mesh = mesh_or_state(mesh)
    if mesh is None or mesh.size != world:
        return DataLine(world, state.process_index)
    return mesh.data_line()


def line_group(mesh: ProcessMesh, axis: str, what: str):
    """The group of this rank's line along `axis` (above size 1), or a
    ValueError naming `what` when no world of that size is live."""
    group = mesh.group(axis)
    if group is None:
        raise ValueError(
            f"{what}: the mesh's {axis!r} axis has {mesh.shape[axis]} "
            "ranks, but no process group of that size is live (run one "
            "process a rank: the launcher or launchers.debug_launcher)")
    return group


# (mesh shape, axes, ranks) -> weak reference to the subgroup: the world
# owns its groups, and `destroy_process_group` ends them and these
_SUBGROUPS: dict = {}


def _subgroup(mesh: ProcessMesh, axes: tuple, line: tuple):
    import weakref

    key = (tuple(mesh.shape.items()), axes, line)
    ref = _SUBGROUPS.get(key)
    group = ref() if ref is not None else None
    if group is not None:
        return group
    # every rank makes every line's group, in one order, as new_group
    # requires; this rank keeps its own
    world = torch.distributed.get_world_size()
    seen, mine = set(), None
    for r in range(min(world, mesh.size)):
        ranks = tuple(mesh.line_ranks(axes, r))
        if ranks in seen:
            continue
        seen.add(ranks)
        g = torch.distributed.new_group(list(ranks))
        if ranks == line:
            mine = g
    _SUBGROUPS[key] = weakref.ref(mine)
    return mine


class AcceleratorState:
    """PartialState plus the mixed-precision policy and the fp8 recipe
    (`fp8_recipe_handler`, set by the Accelerator from its
    `FP8RecipeKwargs`, read by `ops.fp8.resolve_history_len`)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: str | None = None, cpu: bool = False,
                 mesh_config: MeshConfig | None = None,
                 params_whole: bool = False, **kwargs: Any) -> None:
        self.__dict__ = self._shared_state
        if self.initialized:
            asked = mixed_precision
            if asked is not None and \
                    PrecisionType(asked) != self.mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with "
                    f"mixed_precision={self.mixed_precision}; cannot switch "
                    f"to {mixed_precision}. Call Accelerator() once, or "
                    "PartialState._reset_state() in tests.")
            return
        self.partial_state = PartialState(cpu=cpu, **kwargs)
        self.mixed_precision = resolve_mixed_precision(mixed_precision)
        self.fp8_recipe_handler = None
        mesh_config = mesh_config or MeshConfig.from_env() or \
            MeshConfig.data_parallel()
        if not isinstance(mesh_config, MeshConfig):
            raise TypeError(f"mesh_config must be a MeshConfig, got "
                            f"{type(mesh_config).__name__}")
        _refuse_sharded(mesh_config.axes, params_whole)
        axes = mesh_config.resolved_axes(self.partial_state.num_processes)
        _refuse_sharded(axes, params_whole)
        self.mesh_config = mesh_config
        self.mesh = ProcessMesh(axes)
        self.partial_state.set_mesh(self.mesh)

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @classmethod
    def _reset_state(cls) -> None:
        PartialState._reset_state()

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)

    @property
    def dp_size(self) -> int:
        """The batch-sharding degree: the product of the `data` and
        `fsdp` axes (the processes, under data parallelism)."""
        size = 1
        for axis in ("data", "fsdp"):
            size *= self.axis_size(axis)
        return size

    def __getattr__(self, name: str):
        # topology and process control come from PartialState
        if name in ("partial_state", "_shared_state"):
            raise AttributeError(name)
        partial = self.__dict__.get("partial_state")
        if partial is None:
            raise AttributeError(
                f"AcceleratorState has no attribute {name!r} "
                "(not initialized?)")
        return getattr(partial, name)

    def __repr__(self) -> str:
        return (f"AcceleratorState(mixed_precision={self.mixed_precision}, "
                f"mesh={self.mesh.shape}, {self.partial_state!r})")


class GradientState:
    """Gradient-accumulation bookkeeping: the plugin, whether this step
    is a sync boundary, and the active dataloader (with its `remainder`
    and `tail_layout`, where it has them)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self,
                 plugin: GradientAccumulationPlugin | None = None) -> None:
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references: list[Any] = [None]
            self.plugin = plugin or GradientAccumulationPlugin()
        if plugin is not None:
            self.plugin = plugin

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @property
    def num_steps(self) -> int:
        return self.plugin.num_steps

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin.adjust_scheduler

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin.sync_with_dataloader

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        if not self.in_dataloader:
            return False
        return getattr(self.active_dataloader, "end_of_dataloader", False)

    @property
    def remainder(self) -> int:
        """Real samples in the final uneven batch, or -1."""
        if not self.in_dataloader:
            return -1
        return getattr(self.active_dataloader, "remainder", -1)

    @property
    def tail_layout(self):
        """(processes, padded rows, real rows) of the final uneven batch,
        or None."""
        if not self.in_dataloader:
            return None
        return getattr(self.active_dataloader, "tail_layout", None)

    def _set_sync_gradients(self, sync: bool) -> None:
        self.sync_gradients = sync

    def _add_dataloader(self, dataloader) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        refs = self.__dict__.get("dataloader_references")
        if refs is None:
            return
        if dataloader in refs:
            refs.remove(dataloader)
        self.active_dataloader = refs[-1] if refs else None

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()

    def __repr__(self) -> str:
        return (f"GradientState(num_steps={self.num_steps}, "
                f"sync_gradients={self.sync_gradients}, "
                f"in_dataloader={self.in_dataloader})")


def is_initialized() -> bool:
    return AcceleratorState._shared_state != {}
