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
  step whose grads are not finite;
- fp8 (`mixed_precision="fp8"`) computes in bf16 with the layer
  projections in fp8 (`ops/fp8.py`): the loss function takes an
  `fp8_state` keyword and returns `(loss, new_fp8_state)`, and the step
  copies the new metas into `state.fp8_state` on every micro-step.

`kwargs_handlers` takes the reference's records: `AutocastKwargs`
(`enabled=False` pins the compute to f32), `FP8RecipeKwargs` (its
`amax_history_len` reaches every `init_fp8_state`) and
`InitProcessGroupKwargs` without a timeout (one process has no group).

The step is eager and updates the state's tensors in place (see
`training.py`); `train_step(donate=False)` instead writes the update into
new tensors and leaves its input state as it was. It runs on CUDA unless
`cpu=True`; with no GPU and no `cpu=True` it raises.

The checkpoint surface is the reference's (`checkpointing.py`):
`save_state` (sync or async), `wait_for_checkpoints`, `load_state`,
`resume_latest`, versioned directories under `project_dir` with
`ProjectConfiguration`, `register_for_checkpointing` and the save/load
pre-hooks, `save_model`, `get_state_dict`, `skip_first_batches`, and
`end_training`'s drain.

Arguments of the reference that the port does not carry yet raise
`NotImplementedError` when set, naming their slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import shutil
from typing import Any, Callable

import torch

from . import checkpointing
from .data import DataLoaderShard, skip_first_batches, to_device
from .hooks_registry import RemovableHandle
from .optimizers import tree_leaves, tree_map
from .state import AcceleratorState, GradientState
from .training import DynamicLossScale, TrainState, cast_floating, \
    clone_tree, global_norm
from .utils.constants import CHECKPOINT_DIR_PREFIX
from .utils.dataclasses import (
    AutocastKwargs,
    FP8RecipeKwargs,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    KwargsHandler,
    PrecisionType,
    ProjectConfiguration,
)
from .utils.memory import release_memory
from .utils.other import flatten_dict

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
    "step_scheduler_with_optimizer": (True, "scheduler"),
    "jit_config": (None, "CUDA-graph"),
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
                 gradient_clipping: float | None = None,
                 project_dir: str | None = None,
                 project_config: ProjectConfiguration | None = None,
                 kwargs_handlers: list | None = None,
                 **unported: Any):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"Accelerator() got an unexpected argument {name!r}")
            default, slice_name = _UNPORTED[name]
            if value != default:
                raise _unported(f"Accelerator({name}=...)", slice_name)
        self.autocast_handler: AutocastKwargs | None = None
        self.init_handler: InitProcessGroupKwargs | None = None
        self.fp8_recipe_handler: FP8RecipeKwargs | None = None
        for handler in kwargs_handlers or []:
            if not isinstance(handler, KwargsHandler):
                raise ValueError(
                    f"Unsupported kwargs handler {handler!r}: expected a "
                    "KwargsHandler instance (AutocastKwargs, "
                    "InitProcessGroupKwargs, FP8RecipeKwargs).")
            for attr, cls in (("autocast_handler", AutocastKwargs),
                              ("init_handler", InitProcessGroupKwargs),
                              ("fp8_recipe_handler", FP8RecipeKwargs)):
                if isinstance(handler, cls):
                    if getattr(self, attr) is not None:
                        raise ValueError(f"You can only pass one "
                                         f"{cls.__name__} in kwargs_handlers.")
                    setattr(self, attr, handler)
                    break
            else:
                raise ValueError(
                    f"Unsupported kwargs handler type "
                    f"{type(handler).__name__}: GradScaler/DDP handlers are "
                    "not part of the reference.")
        if self.init_handler is not None and \
                self.init_handler.timeout is not None:
            raise _unported("InitProcessGroupKwargs(timeout=...)",
                            "parallelism")
        self.state = AcceleratorState(mixed_precision=mixed_precision,
                                      cpu=cpu)
        # read by ops.fp8.resolve_history_len (the models' init_fp8_state)
        self.state.fp8_recipe_handler = self.fp8_recipe_handler
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.gradient_clipping = gradient_clipping
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and \
                self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        # what save_state writes beside a TrainState (the port prepares no
        # eager model, optimizer or scheduler yet: the hooks get no models)
        self._dataloaders: list = []
        self._custom_objects: list = []
        self._save_model_state_pre_hook: dict = {}
        self._load_model_state_pre_hook: dict = {}
        self.step = 0

    # ------------------------------------------------------------------ state
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return str(self.state.mixed_precision)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the step computes in: f32 with autocast disabled;
        bf16 for bf16 and fp8 (fp8 is a product-level format inside the
        model's projections); f16 for fp16; else f32."""
        if self.autocast_handler is not None and \
                not self.autocast_handler.enabled:
            return torch.float32
        mp = self.state.mixed_precision
        if mp in (PrecisionType.BF16, PrecisionType.FP8):
            return torch.bfloat16
        if mp == PrecisionType.FP16:
            return torch.float16
        return torch.float32

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A no-op context, as in the reference: the precision policy is
        the step's explicit casts."""
        yield

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
                loader = DataLoaderShard(obj, self.device)
                self._dataloaders.append(loader)
                out.append(loader)
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
            loss_scale=None if loss_scale is None else loss_scale.to(dev),
            fp8_state=place(ts.fp8_state))

    # ------------------------------------------------------------- hot loop
    def train_step(self, loss_fn: Callable, has_aux: bool = False,
                   max_grad_norm: float | None = None, donate: bool = True,
                   contract=None,
                   replication_threshold: int = 1 << 26) -> Callable:
        """`step(state, *batch) -> (state, metrics)`: forward, backward,
        1/k accumulation, clip, optimizer update and loss scale, as the
        reference's compiled step, run eagerly. With `donate=True` the
        state's tensors are updated in place (the counterpart of the
        reference's donation); with `donate=False` the step writes into
        copies and the input state keeps its values.

        Under mixed_precision="fp8" the loss function must take an
        `fp8_state` keyword (or `**kwargs`) and return `(loss,
        new_fp8_state)`; fp8 never degrades to full precision silently."""
        if contract is not None or replication_threshold != 1 << 26:
            raise _unported("train_step(contract=...)", "analysis")
        if self.state.mixed_precision == PrecisionType.FP8:
            try:
                params = inspect.signature(loss_fn).parameters
            except (TypeError, ValueError):
                params = {}
            if "fp8_state" not in params and not any(
                    p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in params.values()):
                raise ValueError(
                    "mixed_precision='fp8' needs a loss_fn that accepts an "
                    "fp8_state kwarg and returns (loss, new_fp8_state) — "
                    "e.g. models.llama.causal_lm_loss. fp8 never silently "
                    "degrades to full precision.")
        return _TrainStep(self, loss_fn, has_aux,
                          max_grad_norm if max_grad_norm is not None
                          else self.gradient_clipping, donate)

    # ------------------------------------------------------------- data
    def free_memory(self, *objects):
        """Drop the prepared loaders' references, reset the step count and
        return the card's cached free memory (`utils.memory.
        release_memory`); use as `a, b = acc.free_memory(a, b)`."""
        self._dataloaders = []
        self.step = 0
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """The loader with its first `num_batches` skipped (a resume in
        the middle of a pass)."""
        return skip_first_batches(dataloader, num_batches)

    def end_training(self) -> None:
        """Drain the async checkpoint writes (a failed one re-raises)."""
        checkpointing.wait_for_checkpoints()

    # --------------------------------------------------------- checkpoints
    def register_for_checkpointing(self, *objects) -> None:
        """Save and load `objects` with every checkpoint; each needs
        `state_dict` and `load_state_dict`."""
        invalid = [o for o in objects if not (
            hasattr(o, "state_dict") and hasattr(o, "load_state_dict")
        )]
        if invalid:
            raise ValueError(
                f"Objects {invalid} lack state_dict/load_state_dict and cannot be "
                "registered for checkpointing"
            )
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable):
        """`hook(models, weights, output_dir)` runs before each save."""
        handle = RemovableHandle(self._save_model_state_pre_hook)
        self._save_model_state_pre_hook[handle.id] = hook
        return handle

    def register_load_state_pre_hook(self, hook: Callable):
        """`hook(models, input_dir)` runs before each load."""
        handle = RemovableHandle(self._load_model_state_pre_hook)
        self._load_model_state_pre_hook[handle.id] = hook
        return handle

    def save_state(self, output_dir: str | None = None,
                   state: TrainState | None = None,
                   async_save: bool = False) -> str:
        """Checkpoint `state` and the registered objects into `output_dir`
        (default: the next versioned directory under `project_dir`).
        `async_save=True` overlaps the file writes with later steps (drain
        with `wait_for_checkpoints()`; `load_state`/`end_training` drain
        too)."""
        if output_dir is None:
            output_dir = self._checkpoint_dir(new=True)
        for hook in self._save_model_state_pre_hook.values():
            hook([], None, output_dir)
        return checkpointing.save_accelerator_state(
            output_dir,
            train_states=[state] if state is not None else [],
            dataloaders=self._dataloaders,
            custom_objects=self._custom_objects,
            step=self.step,
            async_save=async_save,
        )

    def wait_for_checkpoints(self) -> int:
        """Drain in-flight async checkpoint saves."""
        return checkpointing.wait_for_checkpoints()

    def load_state(self, input_dir: str | None = None,
                   state: TrainState | None = None):
        """Restore a checkpoint into `state` in place (default: the newest
        versioned directory under `project_dir`)."""
        if input_dir is None:
            input_dir = self._checkpoint_dir(new=False)
        for hook in self._load_model_state_pre_hook.values():
            hook([], input_dir)
        result = checkpointing.load_accelerator_state(
            input_dir,
            train_states=[state] if state is not None else [],
            dataloaders=self._dataloaders,
            custom_objects=self._custom_objects,
        )
        # resume the micro-step counter so accumulation boundaries line up
        self.step = int(result.get("step", 0))
        return result

    def resume_latest(self, input_dir: str | None = None,
                      state: TrainState | None = None, **kwargs):
        """Restore from the newest COMPLETE checkpoint under `input_dir`
        (default: `<project_dir>/checkpoints`); torn saves are skipped.
        Returns the `load_state` result plus `checkpoint_dir` and
        `manifest`, or None when nothing committed exists."""
        if input_dir is None:
            input_dir = os.path.join(
                self.project_configuration.project_dir or ".", "checkpoints")
        for hook in self._load_model_state_pre_hook.values():
            hook([], input_dir)
        result = checkpointing.resume_latest(
            input_dir,
            train_states=[state] if state is not None else [],
            dataloaders=self._dataloaders,
            custom_objects=self._custom_objects,
            **kwargs,
        )
        if result is not None:
            self.step = int(result.get("step", 0))
        return result

    def _checkpoint_dir(self, new: bool) -> str:
        """`<project_dir>/checkpoints`, or with automatic naming its
        `checkpoint_<n>`: the next index (pruning the oldest beyond
        `total_limit`, after draining the async saves that are still
        writing one of them) or the newest. One process decides alone;
        the reference's broadcast of the decision to every process
        arrives with the parallelism slice."""
        base = os.path.join(self.project_configuration.project_dir or ".",
                            "checkpoints")
        if not self.project_configuration.automatic_checkpoint_naming:
            return base
        os.makedirs(base, exist_ok=True)
        existing = sorted(
            int(d.rsplit("_", 1)[1])
            for d in os.listdir(base)
            if d.startswith(CHECKPOINT_DIR_PREFIX + "_")
            and d.rsplit("_", 1)[1].isdigit()
        )
        if not new:
            if not existing:
                raise FileNotFoundError(f"no checkpoints under {base}")
            return os.path.join(base, f"{CHECKPOINT_DIR_PREFIX}_{existing[-1]}")
        idx = (existing[-1] + 1) if existing else 0
        limit = self.project_configuration.total_limit
        if limit is not None and len(existing) + 1 > limit:
            victims = [os.path.abspath(os.path.join(
                base, f"{CHECKPOINT_DIR_PREFIX}_{old}"))
                for old in existing[: len(existing) + 1 - limit]]
            # an async save still writing (or sealing) a victim commits
            # first: with total_limit=1 the victim is the newest directory,
            # which the reference always drains for; with larger limits the
            # oldest can still be sealing when saves come close together
            if set(victims) & set(checkpointing.sealing_checkpoint_dirs()):
                self.wait_for_checkpoints()
            for path in victims:
                shutil.rmtree(path, ignore_errors=True)
        self.project_configuration.iteration = idx
        return os.path.join(base, f"{CHECKPOINT_DIR_PREFIX}_{idx}")

    def save_model(self, params: Any, save_directory: str,
                   max_shard_size: str | int = "10GB",
                   safe_serialization: bool = True):
        """Export the params alone as (index-sharded) safetensors."""
        return checkpointing.save_model(params, save_directory,
                                        max_shard_size, safe_serialization)

    def get_state_dict(self, model, unwrap: bool = True):
        """The params (of a TrainState, or a params dict) as host
        tensors, keys kept."""
        if isinstance(model, TrainState):
            model = model.params
        return tree_map(lambda t: t.detach().to("cpu"), model)


def _copy_metas(dst, src) -> None:
    """The loss function's new fp8 metas copied into the state's tensors
    in place; the two trees must have the same keys."""
    live = {k: v for k, v in flatten_dict(dst).items() if v is not None}
    new = {k: v for k, v in flatten_dict(src).items() if v is not None}
    if set(live) != set(new):
        raise ValueError(
            "the loss function's new fp8 state does not match "
            f"state.fp8_state: missing {sorted(set(live) - set(new))}, "
            f"unexpected {sorted(set(new) - set(live))}")
    with torch.no_grad():
        for key, t in live.items():
            t.copy_(new[key])


class _TrainStep:
    def __init__(self, acc: Accelerator, loss_fn: Callable, has_aux: bool,
                 max_grad_norm: float | None, donate: bool):
        self.acc = acc
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.max_grad_norm = max_grad_norm
        self.donate = donate

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
        use_fp8 = acc.state.mixed_precision == PrecisionType.FP8
        if use_fp8 and state.fp8_state is None:
            raise ValueError(
                "mixed_precision='fp8' needs delayed-scaling state: create "
                "it with TrainState.create(fp8_state=model.init_fp8_state("
                "config)) — e.g. models.llama.init_fp8_state. fp8 never "
                "silently degrades to full precision.")
        if not self.donate:
            # the update goes into copies: the caller's state keeps its
            # tensors and their values
            state = dataclasses.replace(
                state, params=clone_tree(state.params),
                opt_state=clone_tree(state.opt_state),
                grad_accum=clone_tree(state.grad_accum),
                fp8_state=clone_tree(state.fp8_state))
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
            if use_fp8:
                # the fp8 casts happen inside the model's fp8_dense calls
                out = self.loss_fn(cast_floating(params, dtype), *batch,
                                   fp8_state=state.fp8_state)
                loss, aux, new_fp8 = (out if self.has_aux
                                      else (out[0], None, out[1]))
            else:
                out = self.loss_fn(cast_floating(params, dtype), *batch)
                loss = out[0] if self.has_aux else out
                aux = out[1] if self.has_aux else None
            scaled = loss * state.loss_scale.scale if use_scale else loss
            grads = torch.autograd.grad(scaled, masters, allow_unused=True)
        if use_fp8:
            # every micro-step, accumulating or not (the amax window is a
            # per-step statistic); after the backward, which under remat
            # reruns the forward with this step's scales
            _copy_metas(state.fp8_state, new_fp8)
        # contiguous: autograd may hand back an expanded view (the grad
        # of a sum), which the in-place unscale and clip cannot write
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
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
