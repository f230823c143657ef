"""TrainState and the pieces of the training step around it (port of
`accelerate_tpu/training.py`: the state, the loss scale, the bf16 cast
and the clip). `run_resilient` and checkpointing come with a later slice.

The reference's state is an immutable pytree that a compiled step
replaces whole. Here the state owns its tensors and the step updates
them in place (params by `apply_updates`, optimizer moments by the
optimizer's `update`, the accumulation buffer by the step); the methods
still return a state object, so the reference's
`state, metrics = step(state, batch)` loop reads the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .optimizers import GradientTransformation, apply_updates, tree_leaves, \
    tree_map


@dataclasses.dataclass
class DynamicLossScale:
    """fp16 dynamic loss scaling: grow by `growth_factor` after
    `growth_interval` finite steps in a row, back off on a non-finite
    one."""

    scale: torch.Tensor
    growth_tracker: torch.Tensor
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5

    @classmethod
    def create(cls, init_scale: float = 2.0**16,
               device=None) -> "DynamicLossScale":
        return cls(
            scale=torch.tensor(init_scale, dtype=torch.float32,
                               device=device),
            growth_tracker=torch.tensor(0, dtype=torch.int32, device=device))

    def update(self, grads_finite) -> "DynamicLossScale":
        finite = torch.as_tensor(grads_finite, device=self.scale.device)
        tracker = torch.where(finite, self.growth_tracker + 1,
                              torch.zeros_like(self.growth_tracker))
        grow = tracker >= self.growth_interval
        scale = torch.where(
            finite,
            torch.where(grow, self.scale * self.growth_factor, self.scale),
            self.scale * self.backoff_factor)
        return dataclasses.replace(
            self, scale=scale,
            growth_tracker=torch.where(grow, torch.zeros_like(tracker),
                                       tracker))

    def to(self, device) -> "DynamicLossScale":
        return dataclasses.replace(self, scale=self.scale.to(device),
                                   growth_tracker=self.growth_tracker.to(
                                       device))


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state, micro-step counter, accumulation buffer
    and loss scale. `step` is a plain int: the port's step is eager, so
    the counter lives on the host."""

    step: int
    params: Any
    opt_state: Any
    grad_accum: Any
    loss_scale: DynamicLossScale | None
    apply_fn: Callable
    tx: GradientTransformation
    fp8_state: Any = None

    @classmethod
    def create(cls, *, apply_fn: Callable, params: Any,
               tx: GradientTransformation,
               use_grad_accum_buffer: bool = False,
               use_loss_scale: bool = False,
               fp8_state: Any = None) -> "TrainState":
        if fp8_state is not None:
            raise NotImplementedError(
                "fp8_state arrives with the port's fp8 slice")
        device = tree_leaves(params)[0].device
        return cls(
            step=0, params=params, opt_state=tx.init(params),
            grad_accum=(tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
                if use_grad_accum_buffer else None),
            loss_scale=(DynamicLossScale.create(device=device)
                        if use_loss_scale else None),
            apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, grads: Any) -> "TrainState":
        """One optimizer update: params and moments change in place."""
        updates, new_opt_state = self.tx.update(grads, self.opt_state,
                                                self.params)
        apply_updates(self.params, updates)
        return dataclasses.replace(self, step=self.step + 1,
                                   opt_state=new_opt_state)


def cast_floating(tree: Any, dtype) -> Any:
    """Floating leaves cast to `dtype` (the bf16 compute policy: f32
    master params cast inside the step, differentiably, so grads reach
    the masters in f32); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (optax's)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, Any]:
    """(clipped, pre-clip norm), scaling by min(1, max_norm / (norm +
    1e-6)) as the reference and torch's clip_grad_norm_ do."""
    norm = global_norm(tree)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: g * factor, tree), norm
