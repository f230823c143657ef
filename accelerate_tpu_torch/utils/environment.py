"""Environment parsing helpers (the host-only half of
`accelerate_tpu/utils/environment.py`, copied: importing that module
runs the JAX package's `__init__`).

Kept: `str_to_bool`, `parse_flag_from_env`, `parse_int_from_env`,
`get_int_from_env`, `patch_environment`, `parse_mesh_shape` and
`format_mesh_shape`. Left out, as JAX-only: `set_virtual_host_devices`
and `force_cpu_platform` (XLA's fake host devices; a torch process owns
one device) and the XLA compilation cache.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator

_TRUE = {"1", "true", "yes", "on", "y", "t"}
_FALSE = {"0", "false", "no", "off", "n", "f", ""}


def str_to_bool(value: str) -> bool:
    """A boolean from its text ("1", "true", "yes", ...; "0", "false",
    ""...); anything else raises."""
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key)
    if value is None:
        return default
    return str_to_bool(value)


def parse_int_from_env(key: str, default: int | None = None) -> int | None:
    value = os.environ.get(key)
    if value is None:
        return default
    return int(value)


def get_int_from_env(keys, default: int | None = None) -> int | None:
    """The first int found among `keys`."""
    for key in keys:
        value = os.environ.get(key)
        if value is not None:
            return int(value)
    return default


@contextlib.contextmanager
def patch_environment(**kwargs: Any) -> Iterator[None]:
    """Set environment variables (upper-cased names; None unsets) for the
    block, and restore their previous values after it."""
    saved: dict[str, str | None] = {}
    for key, value in kwargs.items():
        key = key.upper()
        saved[key] = os.environ.get(key)
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """`"data=8,model=4"` or `"8x4"` (sizes in `MESH_AXES` order) as an
    ordered {axis: size}; -1 means "fill with the remaining devices"."""
    spec = spec.strip()
    if not spec:
        return {}
    axes: dict[str, int] = {}
    if "=" in spec:
        for part in spec.split(","):
            name, _, size = part.partition("=")
            axes[name.strip()] = int(size)
    else:
        from .constants import MESH_AXES

        sizes = [int(s) for s in spec.replace("x", ",").split(",")]
        for name, size in zip(MESH_AXES, sizes):
            axes[name] = size
    return axes


def format_mesh_shape(axes: dict[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in axes.items())
