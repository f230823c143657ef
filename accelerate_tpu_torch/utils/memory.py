"""Out-of-memory retry and device-memory helpers (port of
`accelerate_tpu/utils/memory.py`).

Where the reference clears JAX's caches (`jax.clear_caches()`), the port
collects garbage and hands the caching allocator's free blocks back to
the card (`torch.cuda.empty_cache()`). An out-of-memory error is
`torch.cuda.OutOfMemoryError`, a `MemoryError`, or an error whose message
carries one of the reference's markers.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable

import torch

_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "Attempting to reserve",
    "exceeds the memory available",
    "OOM",
)


def _clear_device_caches() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references and return the card's cached free memory;
    use as `a, b = release_memory(a, b)`."""
    objects = [None for _ in objects]
    _clear_device_caches()
    return objects


def should_reduce_batch_size(exception: Exception) -> bool:
    """Whether `exception` is an out-of-memory error."""
    if isinstance(exception, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    msg = str(exception)
    return any(m in msg for m in _OOM_MARKERS)


def find_executable_batch_size(function: Callable | None = None,
                               starting_batch_size: int = 128):
    """Decorator: call `function(batch_size, ...)`, halving the batch
    size after each out-of-memory error until it fits; the caches are
    cleared between attempts."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)

    batch_size = starting_batch_size

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        nonlocal batch_size
        _clear_device_caches()
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < (len(args) + 1):
            arg_str = ", ".join(f"{arg}={value}"
                                for arg, value in zip(params[1:], args[1:]))
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the "
                "first argument when called.\nRemove this as the decorator "
                f"already does so: `{function.__name__}({arg_str})`")
        while True:
            if batch_size == 0:
                raise RuntimeError(
                    "No executable batch size found, reached zero.")
            try:
                return function(batch_size, *args, **kwargs)
            except Exception as e:
                if not should_reduce_batch_size(e):
                    raise
                # the traceback holds the failed attempt's tensors
                del e
                _clear_device_caches()
                batch_size //= 2

    return wrapper


def get_device_memory_stats(device=None) -> dict:
    """The card's live and peak bytes and its capacity, under the
    reference's keys; {} with no card."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda" if device is None else device)
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
