"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import contextlib
import contextvars

import torch

# set by `meta_init` (big_modeling.init_empty_weights): every device an
# entry point resolves is then the meta device, so an `init_params` builds
# shapes and dtypes and allocates nothing
_META = contextvars.ContextVar("accelerate_tpu_torch_meta_init", default=False)


@contextlib.contextmanager
def meta_init():
    """Inside: `resolve_device` answers "meta" whatever it is asked, and
    torch's factory functions default to the meta device too."""
    token = _META.set(True)
    try:
        with torch.device("meta"):
            yield
    finally:
        _META.reset(token)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. `None` means `cuda`; a CUDA device with no GPU present raises
    instead of quietly running on the CPU. Under `meta_init` every device
    is the meta device."""
    if _META.get():
        return torch.device("meta")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
