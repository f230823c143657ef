"""Host RNG seeding and keys (port of `accelerate_tpu/utils/random.py`).

`set_seed` seeds Python's `random`, numpy's global generator and torch
as the reference does, so both packages' `set_seed(s)` give the same
Python, numpy and torch draws. `synchronize_rng_state(s)` align a host
stream across processes: with one process there is nothing to align and
they return, as the reference's do; across processes they raise until
the parallelism slice (queue 1 item 6).

The reference's keys are JAX's threefry keys, which torch cannot
reproduce. The port's keys are pairs of 32-bit words on the counter hash
its sampling already draws from (`models/decode.py`): `rng_key(seed)`
is the seed's two words, and `fold_in_step`/`fold_in_process` derive an
unrelated key for a step or a process, deterministically, so a resume
from (seed, step) draws what the first run drew. A key feeds
`models.decode.sample_token` and the other draws of that module.
"""

from __future__ import annotations

import random as _py_random
from typing import Iterable

import numpy as np
import torch

from ..models.decode import _mix32_int, stream_key
from ..state import PartialState, _one_process
from .dataclasses import RNGType


def set_seed(seed: int, device_specific: bool = False) -> int:
    """Seed Python, numpy and torch (every device's generator with it)
    and return the seed; `device_specific=True` offsets it by the process
    index first."""
    if device_specific:
        seed += PartialState.process_index
    _py_random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def rng_key(seed: int) -> tuple[int, int]:
    """The root key of `seed`: its low and high 32-bit words."""
    return stream_key(int(seed))


def _fold_in(key, data: int) -> tuple[int, int]:
    k0, k1 = stream_key(key)
    return (_mix32_int(k0 ^ _mix32_int(data)),
            _mix32_int(k1 ^ _mix32_int(data ^ 0x9E3779B9)))


def fold_in_step(key, step: int) -> tuple[int, int]:
    """The key of one step under `key` (a resume from the seed and the
    step draws the same)."""
    return _fold_in(key, int(step))


def fold_in_process(key, process_index: int | None = None
                    ) -> tuple[int, int]:
    """The key of one process under `key` (default: this process)."""
    if process_index is None:
        process_index = PartialState.process_index
    return _fold_in(key, int(process_index))


def synchronize_rng_state(rng_type: RNGType | str, generator=None) -> None:
    """Align one host stream with process 0's: with one process, and for
    explicit keys ("jax"), there is nothing to align."""
    if RNGType(rng_type) == RNGType.JAX:
        return
    _one_process(f"synchronize_rng_state({RNGType(rng_type)})")


def synchronize_rng_states(rng_types: Iterable[RNGType | str],
                           generator=None) -> None:
    for rng_type in rng_types:
        synchronize_rng_state(rng_type, generator=generator)
