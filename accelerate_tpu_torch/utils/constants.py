"""Constants of the port (the checkpoint names of
`accelerate_tpu/utils/constants.py`, copied: importing that module runs
the JAX package's `__init__`), so a directory written by either package
names its files the same way."""

# --- checkpoint file naming -------------------------------------------------
MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
WEIGHTS_NAME = "pytorch_model.bin"
WEIGHTS_INDEX_NAME = "pytorch_model.bin.index.json"
CHECKPOINT_DIR_PREFIX = "checkpoint"

# --- peaks per GPU part: (dense bf16 FLOP/s, device-memory bytes/s) -------
# NVIDIA H100 Tensor Core GPU data sheet, without sparsity: the SXM5 part
# ("NVIDIA H100 80GB HBM3") 989.4 TFLOP/s bf16 and 3.35 TB/s HBM3; the
# PCIe part ("NVIDIA H100 PCIe") 756 TFLOP/s and 2.0 TB/s HBM2e. Keyed on
# the lower-cased `torch.cuda.get_device_name` text, so one part is never
# read with another's peaks; a name the table lacks has no entry.
GPU_PEAKS = {
    "nvidia h100 80gb hbm3": (989e12, 3.35e12),
    "nvidia h100 pcie": (756e12, 2.0e12),
}


def gpu_peaks(name: str) -> tuple[float, float] | None:
    """(FLOP/s, bytes/s) of the GPU named `name`, or None."""
    return GPU_PEAKS.get(name.strip().lower())


# --- the mesh axes a batch's leading dim shards over (the reference's
# `BATCH_AXES`); one process on one card has no mesh, so the loaders
# store it for the reference's signature
BATCH_AXES = ("data", "fsdp")

# --- mesh axis names (the reference's)
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"
MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_STAGE, AXIS_EXPERT, AXIS_SEQ,
             AXIS_MODEL)

# --- the launch protocol ---------------------------------------------------
# Topology travels in torchrun's variables, which PartialState reads and
# `python -m accelerate_tpu_torch.commands.launch` sets.
ENV_RANK = "RANK"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
# The launcher's config flags reach the children under one prefix of the
# port's own, read where the reference reads its `ACCELERATE_TPU_*` ones
# (the port reads none of those).
ENV_PREFIX = "ACCELERATE_TORCH_"
ENV_MIXED_PRECISION = ENV_PREFIX + "MIXED_PRECISION"
ENV_GRAD_ACCUM_STEPS = ENV_PREFIX + "GRADIENT_ACCUMULATION_STEPS"
ENV_MESH_SHAPE = ENV_PREFIX + "MESH_SHAPE"
ENV_DEBUG_MODE = ENV_PREFIX + "DEBUG"
ENV_CPU = ENV_PREFIX + "USE_CPU"
# the launcher's --context_parallel_{mode,degree} (the reference's
# ENV_CP_MODE/ENV_CP_DEGREE), read by the Accelerator
ENV_CP_MODE = ENV_PREFIX + "CONTEXT_PARALLEL_MODE"      # none|ring|ulysses
ENV_CP_DEGREE = ENV_PREFIX + "CONTEXT_PARALLEL_DEGREE"  # seq-axis size
# the launcher's --zero_stage and --fsdp_sharding_strategy (the
# reference's ENV_ZERO_STAGE/ENV_FSDP_STRATEGY), read by the Accelerator
ENV_ZERO_STAGE = ENV_PREFIX + "ZERO_STAGE"                 # 0-3
ENV_FSDP_STRATEGY = ENV_PREFIX + "FSDP_SHARDING_STRATEGY"  # NO_SHARD|...
