"""Local SGD: train without averaging gradients across processes, and
average the parameters every k steps (port of
`accelerate_tpu/local_sgd.py`).

    with LocalSGD(accelerator, local_sgd_steps=8) as local_sgd:
        for batch in loader:
            params, ... = <an update of this process's replica>
            params = local_sgd.step(params)
        params = local_sgd.flush(params)

`step` counts one optimizer step and, at every `local_sgd_steps`-th,
replaces every parameter by its mean across processes, in place (the
bucketed all-reduce of `utils.operations.all_reduce_mean_`). It takes
and returns the params tree or a `TrainState`, as the reference's does;
`flush` averages once more when steps are left unsynced, and leaving the
block with such steps warns. A world of one process passes everything
through untouched.

The gradients of such a loop must not be averaged per step: use the
eager chain with `compute_gradients` on a world of one, or this
process's own step; the Accelerator's fused step and `compute_gradients`
average gradients across processes by design.
"""

from __future__ import annotations

import warnings
from typing import Any

from .optimizers import tree_leaves
from .state import PartialState
from .utils.operations import all_reduce_mean_


class LocalSGD:
    """Average the parameters across processes every `local_sgd_steps`
    calls of `step` (see the module docstring)."""

    def __init__(self, accelerator=None, model: Any = None,
                 local_sgd_steps: int = 8, enabled: bool = True) -> None:
        if local_sgd_steps <= 0:
            raise ValueError("local_sgd_steps must be positive, got "
                             f"{local_sgd_steps}")
        self.num_processes = PartialState.num_processes
        self.enabled = enabled and self.num_processes > 1
        self.local_sgd_steps = local_sgd_steps
        self.local_step = 0
        self._dirty = False

    def __enter__(self) -> "LocalSGD":
        self.local_step = 0
        self._dirty = False
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        if exc_type is None and self.enabled and self._dirty:
            warnings.warn(
                "LocalSGD context exited with unsynced local steps; call "
                "`params = local_sgd.flush(params)` before leaving the block "
                "so every process ends with the same parameters.",
                stacklevel=2)

    def step(self, state: Any) -> Any:
        """Count one optimizer step; average at every k-th."""
        self.local_step += 1
        if not self.enabled:
            return state
        self._dirty = True
        if self.local_step % self.local_sgd_steps == 0:
            return self._sync(state)
        return state

    def flush(self, state: Any) -> Any:
        """Average once more if steps were taken since the last average."""
        if self.enabled and self._dirty:
            return self._sync(state)
        return state

    def _sync(self, state: Any) -> Any:
        self._dirty = False
        params = state.params if hasattr(state, "params") and \
            hasattr(state, "opt_state") else state
        all_reduce_mean_(tree_leaves(params))
        return state
