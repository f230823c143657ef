"""The eager learning-rate scheduler facade (port of
`accelerate_tpu/scheduler.py`).

The port's optimizers take a schedule inside the transformation (a
callable learning rate, stepped by the update count), as optax does.
`AcceleratedScheduler` is for reference-style loops that step an
explicit schedule object:

- it ticks only when the optimizer really stepped: not off a sync
  boundary, not after an fp16 overflow skip;
- it ticks by the batch-sharding degree (`AcceleratorState.dp_size`, 1
  on one device) unless `split_batches`, so a per-sample schedule sees
  the global progress;
- with `step_with_optimizer=False` it ticks on every call.
"""

from __future__ import annotations

from typing import Callable

from .optimizer import AcceleratedOptimizer
from .state import AcceleratorState, GradientState


class AcceleratedScheduler:
    def __init__(self, schedule: Callable[[int], float],
                 optimizers: list[AcceleratedOptimizer] | AcceleratedOptimizer,
                 step_with_optimizer: bool = True,
                 split_batches: bool = False):
        self.schedule = schedule
        self.optimizers = (optimizers if isinstance(optimizers, (list, tuple))
                           else [optimizers])
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = GradientState()
        self.count = 0
        self._last_lr = float(schedule(0))

    def step(self) -> None:
        if not self.step_with_optimizer:
            self.count += 1
            self._last_lr = float(self.schedule(self.count))
            return
        if not self.gradient_state.sync_gradients:
            return
        if any(opt.step_was_skipped for opt in self.optimizers):
            return
        if self.split_batches:
            increment = 1
        else:
            state = AcceleratorState() if AcceleratorState._shared_state \
                else None
            increment = state.dp_size if state is not None else 1
        self.count += increment
        self._last_lr = float(self.schedule(self.count))

    def get_last_lr(self) -> list[float]:
        return [self._last_lr]

    @property
    def last_lr(self) -> float:
        return self._last_lr

    def state_dict(self) -> dict:
        return {"count": self.count, "last_lr": self._last_lr}

    def load_state_dict(self, state_dict: dict) -> None:
        self.count = int(state_dict["count"])
        self._last_lr = float(state_dict["last_lr"])
