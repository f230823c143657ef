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
CHECKPOINT_DIR_PREFIX = "checkpoint"

# --- peak dense bf16 FLOP/s per GPU, by a substring of the device name ------
# (NVIDIA's data sheet, SXM part, without sparsity; the reference keeps a
# table of TPU generations in its place)
GPU_PEAK_FLOPS = {
    "h100": 989e12,
}
