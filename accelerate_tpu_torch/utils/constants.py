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
