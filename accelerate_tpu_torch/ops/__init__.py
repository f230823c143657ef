"""Device ops of the port: the paged-decode and flash-attention kernel
wrappers, KV quantization, and fp8 (`ops/fp8.py`)."""

from .fp8 import Fp8Meta, fp8_dot, init_fp8_state

__all__ = ["Fp8Meta", "fp8_dot", "init_fp8_state"]
