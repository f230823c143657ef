"""The Accelerator facade for one process on one device (port of the
training path of `accelerate_tpu/accelerator.py`).

Kept from the reference: `Accelerator(mixed_precision=...,
gradient_accumulation_steps=..., gradient_clipping=..., cpu=...)`,
`prepare` for a `TrainState`, a params dict or an iterable of batches,
and `train_step(loss_fn)`, which returns `step(state, *batch) -> (state,
{"loss": ...})` with the reference's semantics:

- the bf16 policy is an explicit cast of the f32 master params and of
  the float batch leaves inside the step (not `torch.autocast`), so
  grads arrive at the masters in f32;
- gradient accumulation adds grads / k into `state.grad_accum` and
  applies the optimizer every k-th call;
- the global-norm clip, then the optimizer update;
- fp16 scales the loss by a dynamic loss scale and skips the update of a
  step whose grads are not finite.

The step is eager and updates the state's tensors in place (see
`training.py`). It runs on CUDA unless `cpu=True`; with no GPU and no
`cpu=True` it raises. Arguments of the reference that the port does not
carry yet raise `NotImplementedError` when set, naming their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .data import DataLoaderShard, to_device
from .optimizers import tree_leaves, tree_map
from .state import AcceleratorState, GradientState
from .training import DynamicLossScale, TrainState, cast_floating, \
    global_norm
from .utils.dataclasses import GradientAccumulationPlugin, PrecisionType

# reference arguments the port does not carry yet: the value that means
# "unused", and the slice that brings them
_UNPORTED = {
    "split_batches": (False, "parallelism"),
    "dataloader_config": (None, "data-pipeline"),
    "deepspeed_plugin": (None, "parallelism"),
    "fsdp_plugin": (None, "parallelism"),
    "megatron_lm_plugin": (None, "parallelism"),
    "context_parallel_plugin": (None, "parallelism"),
    "mesh_config": (None, "parallelism"),
    "sharding_rules": (None, "parallelism"),
    "rng_types": (None, "data-pipeline"),
    "log_with": (None, "tracking"),
    "project_dir": (None, "checkpointing"),
    "project_config": (None, "checkpointing"),
    "step_scheduler_with_optimizer": (True, "scheduler"),
    "jit_config": (None, "CUDA-graph"),
    "kwargs_handlers": (None, "fp8 and mixed-precision handlers"),
    "metrics_port": (None, "telemetry"),
    "stall_timeout_s": (None, "telemetry"),
    "cost_sample_every": (None, "telemetry"),
    "strict": (None, "analysis"),
    "device_placement": (True, "big-model"),
}


def _unported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the port's {slice_name} "
        "slice")


def _is_params(obj: Any) -> bool:
    return isinstance(obj, dict) and bool(obj) and all(
        isinstance(leaf, torch.Tensor) for leaf in tree_leaves(obj))


class Accelerator:
    """One process, one device; see the module docstring."""

    def __init__(self, *, mixed_precision: str | PrecisionType | None = None,
                 gradient_accumulation_steps: int = 1, cpu: bool = False,
                 gradient_accumulation_plugin:
                 GradientAccumulationPlugin | None = None,
                 gradient_clipping: float | None = None, **unported: Any):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"Accelerator() got an unexpected argument {name!r}")
            default, slice_name = _UNPORTED[name]
            if value != default:
                raise _unported(f"Accelerator({name}=...)", slice_name)
        if PrecisionType(str(mixed_precision or "no").lower()) == \
                PrecisionType.FP8:
            raise _unported("mixed_precision='fp8'", "fp8")
        self.state = AcceleratorState(mixed_precision=mixed_precision,
                                      cpu=cpu)
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.gradient_clipping = gradient_clipping

    # ------------------------------------------------------------------ state
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return str(self.state.mixed_precision)

    @property
    def compute_dtype(self) -> torch.dtype:
        mp = self.state.mixed_precision
        if mp == PrecisionType.BF16:
            return torch.bfloat16
        if mp == PrecisionType.FP16:
            return torch.float16
        return torch.float32

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    # -------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Place each object on the device, by type: a `TrainState` (its
        params, optimizer state, accumulation buffer and loss scale; fp16
        gets a loss scale if it has none), a params dict, or an iterable
        of batches (-> `DataLoaderShard`)."""
        out = []
        for obj in args:
            if isinstance(obj, TrainState):
                out.append(self.prepare_train_state(obj))
            elif _is_params(obj):
                out.append(to_device(obj, self.device, non_blocking=False))
            elif hasattr(obj, "__iter__") and not isinstance(
                    obj, (dict, str, bytes)):
                out.append(DataLoaderShard(obj, self.device))
            else:
                raise _unported(f"prepare() of a {type(obj).__name__}",
                                "optimizer/scheduler wrapper")
        return out[0] if len(out) == 1 else tuple(out)

    def prepare_train_state(self, ts: TrainState) -> TrainState:
        dev = self.device
        loss_scale = ts.loss_scale
        if loss_scale is None and \
                self.state.mixed_precision == PrecisionType.FP16:
            loss_scale = DynamicLossScale.create(device=dev)
        def place(tree):
            return to_device(tree, dev, non_blocking=False)

        return dataclasses.replace(
            ts, params=place(ts.params), opt_state=place(ts.opt_state),
            grad_accum=place(ts.grad_accum),
            loss_scale=None if loss_scale is None else loss_scale.to(dev))

    # ------------------------------------------------------------- hot loop
    def train_step(self, loss_fn: Callable, has_aux: bool = False,
                   max_grad_norm: float | None = None, donate: bool = True,
                   contract=None,
                   replication_threshold: int = 1 << 26) -> Callable:
        """`step(state, *batch) -> (state, metrics)`: forward, backward,
        1/k accumulation, clip, optimizer update and loss scale, as the
        reference's compiled step, run eagerly. The state's tensors are
        updated in place (the counterpart of the reference's donation)."""
        if not donate:
            raise _unported("train_step(donate=False)", "checkpointing")
        if contract is not None or replication_threshold != 1 << 26:
            raise _unported("train_step(contract=...)", "analysis")
        return _TrainStep(self, loss_fn, has_aux,
                          max_grad_norm if max_grad_norm is not None
                          else self.gradient_clipping)


class _TrainStep:
    def __init__(self, acc: Accelerator, loss_fn: Callable, has_aux: bool,
                 max_grad_norm: float | None):
        self.acc = acc
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.max_grad_norm = max_grad_norm

    def __call__(self, state: TrainState, *batch):
        acc = self.acc
        k = acc.gradient_accumulation_steps
        dtype = acc.compute_dtype
        use_scale = acc.state.mixed_precision == PrecisionType.FP16
        if use_scale and state.loss_scale is None:
            raise ValueError(
                "fp16 mixed precision needs a loss scale: create the state "
                "with TrainState.create(use_loss_scale=True) or run it "
                "through accelerator.prepare().")
        if k > 1 and state.grad_accum is None:
            raise ValueError("gradient_accumulation_steps>1 needs "
                             "TrainState.create(use_grad_accum_buffer=True)")
        batch = to_device(batch, acc.device)
        leaves = tree_leaves(state.params)
        masters = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(masters)
        params = tree_map(lambda _: next(it), state.params)
        # bf16 casts float batch leaves too; fp16 keeps them f32, as the
        # reference does (targets may overflow fp16)
        if dtype == torch.bfloat16:
            batch = cast_floating(batch, dtype)
        with torch.enable_grad():
            out = self.loss_fn(cast_floating(params, dtype), *batch)
            loss = out[0] if self.has_aux else out
            aux = out[1] if self.has_aux else None
            scaled = loss * state.loss_scale.scale if use_scale else loss
            grads = torch.autograd.grad(scaled, masters, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(masters, grads)]
        del masters, params, out, scaled
        if use_scale:
            inv = 1.0 / state.loss_scale.scale
            for g in grads:
                g.mul_(inv)
            finite = torch.isfinite(global_norm(grads))
        else:
            finite = torch.ones((), dtype=torch.bool, device=acc.device)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), state.params)

        if k > 1:
            # a non-finite micro-batch adds nothing to the buffer
            tree_map(lambda a, g: a.add_(torch.where(finite, g, 0.0) / k),
                     state.grad_accum, grads)
            del grads
            sync = (state.step + 1) % k == 0
            if sync:
                g = self._clipped(state.grad_accum)
                new_state = state.apply_gradients(g)
                tree_map(lambda a: a.zero_(), state.grad_accum)
            else:
                new_state = dataclasses.replace(state, step=state.step + 1)
        else:
            sync = True
            g = self._clipped(grads)
            if not use_scale or bool(finite):
                new_state = state.apply_gradients(g)
            else:
                new_state = dataclasses.replace(state, step=state.step + 1)
        acc.gradient_state.sync_gradients = sync
        if use_scale:
            new_state = dataclasses.replace(
                new_state, loss_scale=state.loss_scale.update(finite))
        metrics = {"loss": loss.detach()}
        if self.has_aux:
            metrics["aux"] = aux
        return new_state, metrics

    def _clipped(self, grads):
        """Grads scaled in place by min(1, max_norm / (norm + 1e-6)). They
        are the step's own: fresh grads, or the accumulation buffer, which
        is zeroed right after the update."""
        if self.max_grad_norm is not None:
            factor = torch.clamp(
                self.max_grad_norm / (global_norm(grads) + 1e-6), max=1.0)
            tree_map(lambda g: g.mul_(factor), grads)
        return grads
