"""Configuration records (the part of `accelerate_tpu/utils/dataclasses.py`
that the training step, fp8, checkpointing, quantized loading, the data
pipeline, the trackers, the process group, the mesh and the
Accelerator's arguments need), copied without its jax imports."""

from __future__ import annotations

import dataclasses
import enum
import os
import warnings
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any

from .constants import AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_SEQ, \
    ENV_MESH_SHAPE, ENV_MIXED_PRECISION, MESH_AXES
from .environment import parse_mesh_shape


class DistributedType(str, enum.Enum):
    """How many processes take part, and on what: one process (NO), or a
    `torch.distributed` world of processes each on one card (MULTI_GPU)
    or on the CPU (MULTI_CPU). The reference's JAX and MULTI_HOST name
    one process over several chips and a world of hosts; in the port each
    process owns one device."""

    NO = "NO"
    MULTI_GPU = "MULTI_GPU"
    MULTI_CPU = "MULTI_CPU"

    def __str__(self) -> str:
        return self.value


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


class RNGType(str, enum.Enum):
    """Host RNG streams a loader may synchronise at each epoch
    (`rng_types`). "jax" is kept for the reference's names: it stands for
    explicit keys, which hold no global state and never need it."""

    JAX = "jax"
    NUMPY = "numpy"
    PYTHON = "python"
    TORCH = "torch"
    GENERATOR = "generator"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def list(cls) -> list[str]:
        return [v.value for v in cls]


class LoggerType(str, enum.Enum):
    """Tracker names of `Accelerator(log_with=...)`; "jsonl" is the
    dependency-free local tracker, "all" every available one."""

    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    COMETML = "comet_ml"
    AIM = "aim"
    MLFLOW = "mlflow"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    JSONL = "jsonl"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def list(cls) -> list[str]:
        return [v.value for v in cls]


def resolve_mixed_precision(value) -> PrecisionType:
    """None takes the launcher's `--mixed_precision` (its
    `ACCELERATE_TORCH_MIXED_PRECISION` variable), else "no"."""
    if value is None:
        value = os.environ.get(ENV_MIXED_PRECISION, "no")
    return PrecisionType(str(value).lower())


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
    """The process group's backend ("nccl" or "gloo"), rendezvous
    (`init_method`, default "env://": MASTER_ADDR and MASTER_PORT) and
    timeout (None: torch's default). `backend=None` picks by device:
    NCCL on a card, gloo on the CPU. Ranks may share a card only under
    an explicit "gloo". A world of one process joins no group."""

    backend: str | None = None
    init_method: str | None = None
    timeout: timedelta | None = field(
        default_factory=lambda: timedelta(seconds=1800))


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
class JitConfig(KwargsHandler):
    """The reference's record of how its train step is compiled. The
    reference's Accelerator stores it (`accelerator.jit_config`) and reads
    none of its fields; the port does the same."""

    donate_params: bool = True
    remat_policy: str | None = None
    scan_layers: bool = True
    static_argnames: tuple[str, ...] = ()


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """How `prepare_data_loader` wraps a loader. `prefetch_size` batches
    are prepared ahead on the host thread; `device_prefetch_depth`
    batches' host-to-device copies stay in flight ahead of the step on a
    side stream (`data.DevicePrefetchIterator`), and 0 issues each copy
    when its batch is handed out. Both knobs apply to the sharded path;
    the dispatcher (`dispatch_batches=True`) ignores them."""

    split_batches: bool = False
    dispatch_batches: bool | None = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    non_blocking: bool = True
    prefetch_size: int = 2
    device_prefetch_depth: int = 2


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


@dataclass
class ContextParallelPlugin(KwargsHandler):
    """Sequence (context) parallelism over the mesh's `seq` axis, the
    reference's record: `seq_degree` is the axis's size (-1: fill with
    the processes the other axes leave), `mode` the schedule that
    `parallel.context_attention` runs ("ring" rotates K/V chunks,
    "ulysses" scatters heads by all-to-all). `chunk_size` is kept for
    the reference's signature; nothing reads it there or here, so a
    value set warns: the ring's chunk is always S over the axis."""

    seq_degree: int = -1
    mode: str = "ring"
    chunk_size: int | None = None

    def __post_init__(self) -> None:
        if self.mode not in ("ring", "ulysses"):
            raise ValueError(
                f"ContextParallelPlugin.mode must be 'ring' or 'ulysses', "
                f"got {self.mode!r}")
        if self.chunk_size is not None:
            warnings.warn(
                f"ContextParallelPlugin.chunk_size={self.chunk_size} is "
                "ignored: the ring's chunk is the sequence over the `seq` "
                "axis", UserWarning, stacklevel=3)

    def to_mesh_axes(self) -> dict[str, int]:
        return {AXIS_SEQ: self.seq_degree}


# the reference's `DCN_FILL`: a `data` axis that fills the slow-link
# domains (HYBRID_SHARD's replicas); the port builds no mesh with it, as
# HYBRID_SHARD shards params (queue 1 item 6b, step 2b)
DCN_FILL = -2


@dataclass
class FullyShardedDataParallelPlugin(KwargsHandler):
    """The reference's FSDP record, lowered to the `fsdp` mesh axis.
    `SHARD_GRAD_OP` keeps params whole and cuts the optimizer moments
    (ZeRO-1/2), `NO_SHARD` is data parallelism; `FULL_SHARD` and
    `HYBRID_SHARD` shard params, which the Accelerator refuses until
    queue 1 item 6b, step 2b (so does `cpu_offload`). Constructing any
    of them works."""

    sharding_strategy: str = "FULL_SHARD"  # FULL_SHARD|SHARD_GRAD_OP|NO_SHARD|HYBRID_SHARD
    min_num_params: int = 0
    activation_checkpointing: bool = False
    cpu_offload: bool = False
    state_dict_type: str = "SHARDED_STATE_DICT"
    use_orig_params: bool = True
    sync_module_states: bool = True

    def to_mesh_axes(self) -> dict[str, int]:
        if self.sharding_strategy == "NO_SHARD":
            return {AXIS_DATA: -1}
        if self.sharding_strategy == "HYBRID_SHARD":
            return {AXIS_DATA: DCN_FILL, AXIS_FSDP: -1}
        return {AXIS_FSDP: -1}

    @property
    def shard_params(self) -> bool:
        return self.sharding_strategy in ("FULL_SHARD", "HYBRID_SHARD")

    @property
    def shard_optimizer_state(self) -> bool:
        """True for every strategy, as the reference's plan takes it: the
        moments follow the `fsdp` plan, and `NO_SHARD`'s mesh has no
        `fsdp` axis to cut them on."""
        return True


@dataclass
class DeepSpeedPlugin(KwargsHandler):
    """The reference's DeepSpeed record, lowered to the mesh: stage 0 is
    data parallelism over `data`; stages 1 and 2 keep params whole and
    cut the optimizer moments (and the accumulation buffer) on `fsdp`;
    stage 3 shards params, which the Accelerator refuses until queue 1
    item 6b, step 2b (so do `offload_optimizer_device` and
    `offload_param_device`). `gradient_clipping` is the Accelerator's
    clip where it sets none. Constructing any of them works."""

    zero_stage: int = 2
    gradient_accumulation_steps: int | None = None
    gradient_clipping: float | None = None
    offload_optimizer_device: str | None = None
    offload_param_device: str | None = None
    zero3_init_flag: bool = False
    moe_expert_parallel_size: int = 1

    def to_mesh_axes(self) -> dict[str, int]:
        axes: dict[str, int] = {}
        if self.moe_expert_parallel_size > 1:
            axes[AXIS_EXPERT] = self.moe_expert_parallel_size
        axes[AXIS_FSDP if self.zero_stage > 0 else AXIS_DATA] = -1
        return axes

    @property
    def shard_params(self) -> bool:
        return self.zero_stage >= 3

    @property
    def shard_optimizer_state(self) -> bool:
        return self.zero_stage >= 1


@dataclass
class MeshConfig:
    """A mesh request: {axis: size} over the world's processes (each owns
    one device), at most one size -1 ("fill with the remaining
    processes"). `build()` lays the world's processes out on it
    (`state.ProcessMesh`). The Accelerator takes the `data`, `stage`,
    `seq` and `expert` axes, and `fsdp` where its plugins keep params
    whole (ZeRO-1/2); a `model` axis above 1, or an `fsdp` axis that
    would shard params, raises there (queue 1 item 6b, steps 2c and
    2b)."""

    axes: dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        unknown = [a for a in self.axes if a not in MESH_AXES]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; valid: {MESH_AXES}")
        wild = [a for a, s in self.axes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        bad = [(a, s) for a, s in self.axes.items() if s < -1]
        if bad:
            raise ValueError(f"invalid axis sizes {bad}; use positive ints "
                             "or -1 (fill)")

    @classmethod
    def data_parallel(cls) -> "MeshConfig":
        return cls(axes={AXIS_DATA: -1})

    @classmethod
    def from_env(cls) -> "MeshConfig | None":
        """The launcher's `--mesh_shape` (`ACCELERATE_TORCH_MESH_SHAPE`),
        or None."""
        spec = os.environ.get(ENV_MESH_SHAPE)
        if not spec:
            return None
        return cls(axes=parse_mesh_shape(spec))

    def resolved_axes(self, num_devices: int) -> dict[str, int]:
        """Concrete {axis: size} in `MESH_AXES` order, -1 filled in;
        raises unless the sizes cover `num_devices` exactly."""
        axes = {a: s for a, s in self.axes.items() if s != 0}
        if not axes:
            axes = {AXIS_DATA: -1}
        known, wildcard = 1, None
        for a, s in axes.items():
            if s == -1:
                wildcard = a
            else:
                known *= s
        if wildcard is not None:
            if num_devices % known != 0:
                raise ValueError(f"{num_devices} devices not divisible by "
                                 f"fixed axes product {known}")
            axes[wildcard] = num_devices // known
        sizes = 1
        for s in axes.values():
            sizes *= s
        if sizes != num_devices:
            raise ValueError(f"mesh {axes} covers {sizes} devices but "
                             f"{num_devices} are present")
        return {a: axes[a] for a in MESH_AXES if a in axes}

    def build(self, num_processes: int | None = None, device=None):
        """A `state.ProcessMesh` over the world's processes (the
        reference's `build()` over devices: each process owns one),
        `num_processes` defaulting to the live world's. `device` is where
        `sharding.shard_pytree` puts this rank's shards (None: where each
        leaf already is)."""
        from ..state import PartialState, ProcessMesh

        n = PartialState.num_processes if num_processes is None \
            else int(num_processes)
        return ProcessMesh(self.resolved_axes(n), device=device)
