"""The eager optimizer facade (port of `accelerate_tpu/optimizer.py`).

`AcceleratedOptimizer` wraps one of the port's optax-shaped
transformations (`optimizers.adamw`, ...) for reference-style loops:

    opt = accelerator.prepare_optimizer(adamw(3e-4), params=params)
    with accelerator.accumulate():
        loss, grads = accelerator.compute_gradients(loss_fn, opt.params, batch)
        accelerator.backward(grads)     # adds grads / k into the buffer
        opt.step()                      # a no-op off a sync boundary
        opt.zero_grad()

It owns the params it updates, the optimizer state and the gradient
buffer (the counterpart of torch's `.grad`). The update runs in place on
`params` and `opt_state`, as the fused `Accelerator.train_step` does, so
the caller's params dict sees every step. Under fp16 a step whose
gradients are not finite is skipped (`step_was_skipped`), as the
reference skips it.

Under ZeRO-1/2 (`zero`, the Accelerator's `sharding.zero.ZeroLayout`)
the params stay whole and the optimizer state holds this rank's blocks
on `fsdp`: the buffer holds the whole gradients the Accelerator has
already averaged over the batch line (as the reference's eager
gradients are global arrays), and `step` takes this rank's block of
them, updates its slice of the params and all-gathers the params whole
(`ZeroLayout.update_`), with no second reduce.
"""

from __future__ import annotations

from typing import Any

import torch

from .optimizers import GradientTransformation, apply_updates, tree_map
from .state import AcceleratorState, GradientState
from .training import global_norm
from .utils.dataclasses import PrecisionType
from .utils.other import flatten_dict


class AcceleratedOptimizer:
    """Stateful facade over a `GradientTransformation`; see the module
    docstring."""

    def __init__(self, tx: GradientTransformation, params: Any = None,
                 opt_state: Any = None, zero=None):
        self.tx = tx
        self.zero = zero
        self.gradient_state = GradientState()
        self.params = params
        if opt_state is None and params is not None:
            opt_state = tx.init(params)
        self.opt_state = opt_state
        self._grad_buffer = None
        self._accum_count = 0
        self._overflow = False

    # -- the gradient buffer (torch's `.grad`) -------------------------------
    @torch.no_grad()
    def accumulate_grads(self, grads: Any, scale: float = 1.0) -> None:
        """Add `grads * scale` into the buffer in place; the buffer starts
        from zeros after `zero_grad`, as in the reference."""
        if self._grad_buffer is None:
            self._grad_buffer = tree_map(torch.zeros_like, grads)
        tree_map(lambda b, g: b.add_(g, alpha=scale), self._grad_buffer,
                 grads)
        self._accum_count += 1

    @property
    def gradients(self) -> Any:
        return self._grad_buffer

    @gradients.setter
    def gradients(self, value: Any) -> None:
        self._grad_buffer = value

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drop the buffer and the count of micro-steps in it."""
        self._grad_buffer = None
        self._accum_count = 0

    # -- the update -------------------------------------------------------------
    @torch.no_grad()
    def step(self, grads: Any = None) -> None:
        """Apply the update from `grads` (default: the buffer), unless
        this is not a sync boundary (accumulating) or, under fp16, the
        gradients are not finite."""
        if not self.gradient_state.sync_gradients:
            return
        if grads is None:
            grads = self._grad_buffer
        if grads is None:
            raise ValueError(
                "No gradients: call accelerator.backward(grads) first or "
                "pass grads to step().")
        self._overflow = self._check_overflow(grads)
        if self._overflow:
            return
        if self.zero is not None:
            self.opt_state = self.zero.update_(
                self.tx, self.zero.blocks(grads), self.opt_state,
                self.params)
            return
        updates, self.opt_state = self.tx.update(grads, self.opt_state,
                                                 self.params)
        apply_updates(self.params, updates)

    def _check_overflow(self, grads) -> bool:
        state = AcceleratorState() if AcceleratorState._shared_state else None
        if state is None or state.mixed_precision != PrecisionType.FP16:
            return False
        return not bool(torch.isfinite(global_norm(grads)))

    @property
    def step_was_skipped(self) -> bool:
        """Whether the last step was skipped for non-finite fp16 grads."""
        return self._overflow

    # -- state_dict ---------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"opt_state": self.opt_state}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Copy a saved optimizer state into the live one in place (its
        tensors keep their identity); without a live state, adopt it."""
        opt_state = state_dict["opt_state"]
        if self.opt_state is None:
            self.opt_state = opt_state
            return
        live = {k: v for k, v in flatten_dict(self.opt_state).items()
                if v is not None}
        saved = {k: v for k, v in flatten_dict(opt_state).items()
                 if v is not None}
        if set(live) != set(saved):
            raise ValueError(
                "the saved optimizer state does not match the live one: "
                f"missing {sorted(set(live) - set(saved))}, unexpected "
                f"{sorted(set(saved) - set(live))}")
        for key, t in live.items():
            t.copy_(torch.as_tensor(saved[key]))
