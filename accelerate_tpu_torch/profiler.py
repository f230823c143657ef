"""Profiling helpers (port of part of `accelerate_tpu/profiler.py`).

Only `profile` is ported so far: the capture behind the HTTP front
door's `/debug/profile` route. The rest of the reference module (step
timers, memory reports) arrives with a later slice.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

__all__ = ["profile"]


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the block (host ops, and
    device kernels when a CUDA device is present) and write it to
    `<logdir>/trace.json` as Chrome/Perfetto JSON when the block ends.
    The reference records a jax.profiler trace into `logdir` the same
    way."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = _torch_profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
