"""Optimizers with optax's semantics, for the port.

The reference builds its optimizers from optax. Here each one is an
optax-shaped transformation over a nested dict of tensors:
`init(params) -> state` and `update(grads, state, params) -> (updates,
new_state)`, with `apply_updates(params, updates)`. The arithmetic is
optax's, in f32, in its order (moments, bias correction with the
incremented count, `eps` outside the square root, decoupled weight decay
on every leaf, then the learning rate).

`update` writes the new moments into the state's tensors in place and
returns that same state object: the port keeps one copy of the moments
(two param-sized f32 trees) instead of building a new one every step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, *trees):
    """Map over the leaves of nested dicts (the param trees' shape)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar, optax's `count`
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    trace: Any


def _lr(learning_rate, count):
    """A float, or a schedule called with the step count before this
    update (optax's scale_by_schedule)."""
    return learning_rate(count) if callable(learning_rate) else learning_rate


def constant_schedule(value: float) -> Callable[[Any], float]:
    """optax.constant_schedule: `value` at every step count."""
    return lambda count: value


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax.adamw: Adam moments, update mu_hat / (sqrt(nu_hat) + eps),
    plus `weight_decay * param` on every leaf (optax's `mask=None`), times
    -learning_rate. The decay default is optax's 1e-4, not torch's 1e-2."""

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=tree_leaves(params)[0].device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update(grads, state, params=None):
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
        lr = _lr(learning_rate, state.count)

        def one(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)              # (1-b1) g + b1 m
            v.mul_(b2).addcmul_(g, g, value=1 - b2)       # (1-b2) g^2 + b2 v
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return -lr * u

        if weight_decay and params is None:
            raise ValueError("adamw's weight decay needs the params")
        updates = tree_map(one, grads, state.mu, state.nu,
                           params if params is not None else grads)
        return updates, ScaleByAdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: adamw without the weight decay."""
    return adamw(learning_rate, b1, b2, eps, weight_decay=0.0)


def sgd(learning_rate, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax.sgd: optional momentum trace (g + momentum * trace; nesterov
    adds momentum * new trace to g), times -learning_rate."""

    def init(params):
        if momentum is None:
            return TraceState(None)
        return TraceState(tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(grads, state, params=None):
        lr = learning_rate
        if momentum is None:
            return tree_map(lambda g: -lr * g.float(), grads), state

        def one(g, t):
            g = g.float()
            t.mul_(momentum).add_(g)
            d = g + momentum * t if nesterov else t
            return -lr * d

        return tree_map(one, grads, state.trace), state

    if callable(learning_rate):
        raise NotImplementedError("sgd takes a float learning rate here")
    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """params + updates, in each param's dtype, written into the params in
    place (the port's TrainState owns its tensors); returns params."""
    def one(p, u):
        p.add_(u.to(p.dtype))
        return p

    return tree_map(one, params, updates)
