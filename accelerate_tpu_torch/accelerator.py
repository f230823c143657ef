"""The Accelerator facade for one process on one device (port of
`accelerate_tpu/accelerator.py`).

Kept from the reference: `Accelerator(mixed_precision=...,
gradient_accumulation_steps=..., gradient_clipping=..., cpu=...,
device_placement=..., step_scheduler_with_optimizer=..., jit_config=...)`
and its two training paths.

The fused path: `train_step(loss_fn)` returns `step(state, *batch) ->
(state, {"loss": ...})` over a prepared `TrainState`, with the
reference's semantics:

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

The eager path, the reference's headline loop:

    params = acc.prepare(params)
    opt = acc.prepare_optimizer(adamw(3e-4), params=params)
    sched = acc.prepare(schedule)            # a callable of the count
    for batch in loader:
        with acc.accumulate():
            loss, grads = acc.compute_gradients(loss_fn, opt.params, batch)
            acc.backward(grads)              # grads / k into the buffer
            acc.clip_grad_norm_(max_norm=1.0)
            opt.step(); sched.step(); opt.zero_grad()

`compute_gradients` and the fused step share one gradient function
(`_value_and_grad`), and `clip_grad_norm_` the fused step's clip, so the
two paths give the same tensors on the same inputs. As in the
reference, `backward` takes gradients, not a loss: the eager API has no
backward tape. The collectives (`gather`, `gather_for_metrics`,
`reduce`, `broadcast`, ...) and the process surface are the reference's
(`utils/operations.py`, `state.py`).

Data parallelism: launched as N processes (`python -m
accelerate_tpu_torch.commands.launch --num_processes N script.py`, or
torchrun), each process owns one device and a replica of the params,
its loaders take its share of each global batch, and the gradients are
averaged across processes inside `compute_gradients` and the fused step,
before the clip, the fp16 finite check and the optimizer: as under the
reference's GSPMD, both return the gradient of the global batch mean,
and the step's loss (and numeric aux) is the global mean. Every process
then makes the same update, so the replicas stay bit-identical. Under
fp8 every amax is the global batch's too (`ops.fp8`), so every process
holds the same delayed-scaling metas. The
average runs in flat buckets (`utils.operations.all_reduce_mean_`), one
`all_reduce` a bucket. `Accelerator.mesh` is the data-parallel mesh
over the processes (`state.ProcessMesh`): `mesh_config`, else the
launcher's `--mesh_shape`, else every process on `data`.

`kwargs_handlers` takes the reference's records: `AutocastKwargs`
(`enabled=False` pins the compute to f32), `FP8RecipeKwargs` (its
`amax_history_len` reaches every `init_fp8_state`) and
`InitProcessGroupKwargs` (the process group's backend, rendezvous and
timeout; a world of one joins no group).

Both paths run eagerly and update the params and optimizer state in
place (see `training.py`); `train_step(donate=False)` instead writes the
update into new tensors and leaves its input state as it was. Work runs
on CUDA unless `cpu=True`; with no GPU and no `cpu=True` it raises.

The data pipeline and the trackers are the reference's at one process:
`prepare` of an iterable of batches goes through
`data.prepare_data_loader` with the Accelerator's `dataloader_config`
and `rng_types` (host prep on a thread, copies to the card on a side
stream, `prefetch_size`/`device_prefetch_depth` ahead), and
`Accelerator(log_with=...)` with `init_trackers`, `log`, `get_tracker`,
`log_telemetry` and `end_training` drive `tracking.py`'s trackers.

The checkpoint surface is the reference's (`checkpointing.py`):
`save_state` (sync or async; a `TrainState` and every prepared eager
optimizer and scheduler), `wait_for_checkpoints`, `load_state`,
`resume_latest`, versioned directories under `project_dir` with
`ProjectConfiguration`, `register_for_checkpointing` and the save/load
pre-hooks, `save_model`, `get_state_dict`, `skip_first_batches`, and
`end_training`'s drain.

Telemetry is the reference's at one process: `metrics_port` serves the
process registry over HTTP (127.0.0.1, 0 = ephemeral), `stall_timeout_s`
arms a stall watchdog that every train step and `log` tick, and
`cost_table` holds each built train step's analytic cost (`train_step`,
`train_step_2`, ...) with its device time sampled at call 2 and every
`cost_sample_every`-th call after (16 by default). None turns the
exporter and the watchdog off; the port reads no environment variable.
The reference's watchdog writes a bundle only into the directory of its
`ACCELERATE_TPU_INCIDENT_DIR` variable, so the port's writes none.

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

import numpy as np
import torch

from . import checkpointing
from .data import DataLoaderDispatcher, DataLoaderShard, \
    prepare_data_loader, skip_first_batches, to_device
from .hooks_registry import RemovableHandle
from .ops import fp8
from .optimizer import AcceleratedOptimizer
from .optimizers import GradientTransformation, tree_leaves, tree_map
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .telemetry.cost import CostTable, device_peaks, fence, \
    resolve_sample_every
from .telemetry.export import start_metrics_server
from .telemetry.registry import get_registry
from .telemetry.watchdog import StallWatchdog, resolve_stall_timeout
from .training import DynamicLossScale, TrainState, cast_floating, \
    clone_tree, global_norm
from .utils import operations as ops
from .utils.constants import CHECKPOINT_DIR_PREFIX, ENV_GRAD_ACCUM_STEPS
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    FP8RecipeKwargs,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    JitConfig,
    KwargsHandler,
    MeshConfig,
    PrecisionType,
    ProjectConfiguration,
)
from .utils.memory import release_memory
from .utils.other import flatten_dict

_ITEM_6B = "sharded-parallelism slice (ROADMAP.md, queue 1 item 6b)"

# reference arguments the port does not carry yet: the value that means
# "unused", and the slice that brings them
_UNPORTED = {
    "deepspeed_plugin": (None, _ITEM_6B),
    "fsdp_plugin": (None, _ITEM_6B),
    "megatron_lm_plugin": (None, _ITEM_6B),
    "context_parallel_plugin": (None, _ITEM_6B),
    "sharding_rules": (None, _ITEM_6B),
    "strict": (None, "analysis slice"),
}


def _unported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the port's {slice_name}")


def _all_reduce_metric(value):
    """A step's loss or aux leaf averaged across processes: floating
    tensors are, other leaves stay as they are (one process: as is)."""
    if ops._world() == 1:
        return value

    def mean(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return ops.reduce(x.detach(), "mean")
        return x

    return ops._map(mean, value)


def _is_params(obj: Any) -> bool:
    return isinstance(obj, dict) and bool(obj) and all(
        isinstance(leaf, torch.Tensor) for leaf in tree_leaves(obj))


def _is_optimizer(obj: Any) -> bool:
    return isinstance(obj, GradientTransformation) or (
        hasattr(obj, "init") and hasattr(obj, "update")
        and not isinstance(obj, TrainState))


def _is_dataloader(obj: Any) -> bool:
    return hasattr(obj, "__iter__") and not isinstance(obj, (dict, str, bytes))


def _refuse_torch_object(obj: Any) -> None:
    """The reference prepares params dicts, optax-shaped transformations,
    schedules and batch iterables; torch's stateful modules, optimizers
    and LR schedulers are not among them, and the port adds no wrapper
    of its own for them."""
    if isinstance(obj, (torch.nn.Module, torch.optim.Optimizer,
                        torch.optim.lr_scheduler.LRScheduler)):
        raise TypeError(
            f"prepare() does not take a {type(obj).__name__}: the "
            "Accelerator prepares a params dict (the model), a TrainState, "
            "a GradientTransformation from accelerate_tpu_torch.optimizers "
            "(e.g. adamw), a schedule (a callable of the step count) or an "
            "iterable of batches, as the reference does")


def _value_and_grad(loss_fn: Callable, params, batch, dtype, *,
                    tuple_out: bool, scale=None, **kwargs):
    """The one gradient function of the fused step and
    `compute_gradients`: the f32 masters (detached leaves of `params`
    that require grad) cast to `dtype`, `loss_fn(cast, *batch,
    **kwargs)`, and `autograd.grad` of its loss (`out[0]` with
    `tuple_out`; times `scale` if given) at the masters. Each grad comes
    back contiguous, since autograd may hand back an expanded view (the
    grad of a sum) that the in-place passes after it cannot write, and a
    param with no grad gets zeros. Returns (out, grads as a tree like
    `params`)."""
    masters = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(masters)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        out = loss_fn(cast_floating(live, dtype), *batch, **kwargs)
        loss = out[0] if tuple_out else out
        grads = torch.autograd.grad(loss if scale is None else loss * scale,
                                    masters, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g.contiguous()
               for p, g in zip(masters, grads)])
    return out, tree_map(lambda _: next(it), params)


def _clip_by_global_norm_(trees: list, max_norm: float) -> torch.Tensor:
    """Scale every leaf of `trees` in place by min(1, max_norm / (norm +
    1e-6)), the norm taken over all of them as one group; returns the
    pre-clip norm."""
    norm = global_norm(trees)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for leaf in tree_leaves(trees):
        leaf.mul_(factor)
    return norm


class Accelerator:
    """One process, one device; see the module docstring."""

    def __init__(self, *, device_placement: bool = True,
                 mixed_precision: str | PrecisionType | None = None,
                 gradient_accumulation_steps: int = 1, cpu: bool = False,
                 gradient_accumulation_plugin:
                 GradientAccumulationPlugin | None = None,
                 step_scheduler_with_optimizer: bool = True,
                 jit_config: JitConfig | None = None,
                 gradient_clipping: float | None = None,
                 project_dir: str | None = None,
                 project_config: ProjectConfiguration | None = None,
                 kwargs_handlers: list | None = None,
                 dataloader_config: DataLoaderConfiguration | None = None,
                 rng_types: list | None = None,
                 log_with=None,
                 metrics_port: int | None = None,
                 stall_timeout_s: float | None = None,
                 cost_sample_every: int | None = None,
                 split_batches: bool = False,
                 mesh_config: MeshConfig | None = None,
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
        group_kwargs: dict[str, Any] = {}
        if self.init_handler is not None:
            group_kwargs = {k: v for k, v in (
                ("backend", self.init_handler.backend),
                ("init_method", self.init_handler.init_method),
                ("timeout", self.init_handler.timeout)) if v is not None}
        # mesh: explicit, then the launcher's --mesh_shape, then every
        # process on `data` (AcceleratorState)
        self.state = AcceleratorState(mixed_precision=mixed_precision,
                                      cpu=cpu, mesh_config=mesh_config,
                                      **group_kwargs)
        # read by ops.fp8.resolve_history_len (the models' init_fp8_state)
        self.state.fp8_recipe_handler = self.fp8_recipe_handler
        if gradient_accumulation_plugin is None:
            # the launcher's --gradient_accumulation_steps, as the
            # reference reads its own variable
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=int(os.environ.get(ENV_GRAD_ACCUM_STEPS,
                                             gradient_accumulation_steps)))
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.dataloader_config = dataloader_config or \
            DataLoaderConfiguration(split_batches=split_batches)
        self.rng_types = rng_types
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        # stored as the reference stores it: nothing reads its fields
        self.jit_config = jit_config or JitConfig()
        self.gradient_clipping = gradient_clipping
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and \
                self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list = []
        self._models: list = []
        self._custom_objects: list = []
        self._save_model_state_pre_hook: dict = {}
        self._load_model_state_pre_hook: dict = {}
        self.flag_tensor: torch.Tensor | None = None
        self.step = 0
        self.log_with = log_with if isinstance(log_with, (list, tuple)) else (
            [log_with] if log_with is not None else [])
        self.trackers: list = []
        # the process-wide registry: StepTimer and checkpointing record into
        # it, and log_telemetry snapshots it
        self.telemetry = get_registry()
        # opt-in exporter and stall watchdog (off unless asked for)
        self.metrics_server = start_metrics_server(
            metrics_port, registry=self.telemetry)
        self.stall_watchdog: StallWatchdog | None = None
        wd_timeout = resolve_stall_timeout(stall_timeout_s)
        if wd_timeout is not None:
            self.stall_watchdog = StallWatchdog(
                wd_timeout, name=f"accelerator-rank{self.process_index}"
            ).start()
        self._c_train_steps = self.telemetry.counter(
            "accelerator_train_steps_total")
        self._c_logs = self.telemetry.counter("accelerator_log_calls_total")
        # each built train step's analytic cost and sampled device time
        self.cost_table = CostTable(
            registry=self.telemetry,
            sample_every=resolve_sample_every(cost_sample_every),
            peaks=device_peaks(self.device), num_chips=1)
        self._cost_names_built = 0

    # ------------------------------------------------------------------ state
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        """The processes' mesh (`state.ProcessMesh`): `.shape` is
        {axis: size}, `.axis_names` its names, `.groups` each axis's
        process group."""
        return self.state.mesh

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

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

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int) -> None:
        self.gradient_state.plugin.num_steps = value

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A no-op context, as in the reference: the precision policy is
        the step's explicit casts."""
        yield

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    # ---------------------------------------------------------- process ctl
    def wait_for_everyone(self) -> None:
        self.state.wait_for_everyone()

    def print(self, *args, **kwargs) -> None:
        self.state.print(*args, **kwargs)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.split_between_processes(inputs, apply_padding)

    def on_main_process(self, function):
        return self.state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.on_local_main_process(function)

    def on_process(self, function, process_index: int = 0):
        return self.state.on_process(function, process_index)

    def main_process_first(self):
        return self.state.main_process_first()

    def local_main_process_first(self):
        return self.state.local_main_process_first()

    # -------------------------------------------------------------- prepare
    def prepare(self, *args, device_placement: list | None = None):
        """Prepare each object by kind, in the reference's two passes:
        first params dicts and `TrainState`s, then optimizers (bound to
        the params prepared in the same call), schedules (callables) and
        iterables of batches (-> `DataLoaderShard`). An object of no
        known kind comes back unchanged. `device_placement`, one entry per
        object, is checked for its length, as the reference checks it;
        as there, placement follows the Accelerator's `device_placement`
        (`prepare_data_loader` takes a flag of its own)."""
        if device_placement is not None and \
                len(device_placement) != len(args):
            raise ValueError(
                f"device_placement has {len(device_placement)} entries for "
                f"{len(args)} objects")
        results: list[Any] = list(args)
        prepared_params = None
        for i, obj in enumerate(args):
            _refuse_torch_object(obj)
            if isinstance(obj, TrainState):
                results[i] = self.prepare_train_state(obj)
                prepared_params = results[i].params
            elif _is_params(obj):
                results[i] = self.prepare_params(obj)
                prepared_params = results[i]
        for i, obj in enumerate(results):
            if isinstance(obj, TrainState) or obj is prepared_params:
                continue
            if _is_optimizer(obj):
                results[i] = self.prepare_optimizer(obj,
                                                    params=prepared_params)
            elif isinstance(obj, (AcceleratedOptimizer, AcceleratedScheduler,
                                  DataLoaderShard, DataLoaderDispatcher)):
                pass
            elif callable(obj) and not _is_dataloader(obj):
                results[i] = self.prepare_scheduler(obj)
            elif _is_dataloader(obj):
                results[i] = self.prepare_data_loader(obj)
        return results[0] if len(results) == 1 else tuple(results)

    def prepare_params(self, params: Any) -> Any:
        """The params on the device; with the Accelerator's
        `device_placement=False`, the params as they were given."""
        if not self.device_placement:
            return params
        return to_device(params, self.device, non_blocking=False)

    def prepare_model(self, model: Any,
                      device_placement: bool | None = None) -> Any:
        """A params dict (the model here) or a `TrainState`, prepared;
        anything else is recorded in `_models` (the checkpoint hooks get
        it) and returned as it is. `device_placement` is taken for the
        reference's signature and, as there, not read."""
        _refuse_torch_object(model)
        if _is_params(model):
            return self.prepare_params(model)
        if isinstance(model, TrainState):
            return self.prepare_train_state(model)
        self._models.append(model)
        return model

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

    def prepare_optimizer(self, tx: GradientTransformation, params: Any = None,
                          device_placement: bool | None = None
                          ) -> AcceleratedOptimizer:
        """An `AcceleratedOptimizer` over `tx`, bound to `params` (its
        state initialised from them, on their device), recorded for
        `backward`, the clips and checkpoints. `device_placement` is
        taken for the reference's signature: the optimizer places
        nothing itself."""
        _refuse_torch_object(tx)
        opt = AcceleratedOptimizer(tx, params=params)
        self._optimizers.append(opt)
        return opt

    def prepare_scheduler(self, schedule: Callable) -> AcceleratedScheduler:
        """An `AcceleratedScheduler` over `schedule` (a callable of the
        step count), ticking with the prepared optimizers unless
        `step_scheduler_with_optimizer=False`."""
        sched = AcceleratedScheduler(
            schedule, self._optimizers,
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.dataloader_config.split_batches)
        self._schedulers.append(sched)
        return sched

    def prepare_data_loader(self, data_loader,
                            device_placement: bool | None = None,
                            slice_fn_for_dispatch=None):
        """`data.prepare_data_loader` over the iterable with the
        Accelerator's `dataloader_config` and `rng_types`: a
        `DataLoaderShard` (or, with `dispatch_batches`, a
        `DataLoaderDispatcher`) whose batches land on the device, unless
        `device_placement` (here, else the Accelerator's) is False.
        `slice_fn_for_dispatch` is taken for the reference's signature,
        which reads it nowhere either."""
        put_on_device = (device_placement if device_placement is not None
                         else self.device_placement)
        prepared = prepare_data_loader(
            data_loader, device=self.device, put_on_device=put_on_device,
            rng_types=self.rng_types, config=self.dataloader_config)
        self._dataloaders.append(prepared)
        return prepared

    # ------------------------------------------------------------- eager loop
    @contextlib.contextmanager
    def accumulate(self, *models):
        """Count the micro-step and set `sync_gradients`: at every k-th
        step, at the end of the loader (`sync_with_dataloader`), or on
        every step (`sync_each_batch`)."""
        self.step += 1
        end = (self.gradient_state.sync_with_dataloader
               and self.gradient_state.end_of_dataloader)
        sync = (self.step % self.gradient_state.num_steps == 0 or end
                or self.gradient_state.plugin.sync_each_batch)
        self.gradient_state._set_sync_gradients(sync)
        yield

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Accumulate without an optimizer step inside the block."""
        prev = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(prev)

    def compute_gradients(self, loss_fn: Callable, params: Any, *batch,
                          has_aux: bool = False):
        """`(loss, grads)`, or `((loss, aux), grads)` with `has_aux`: the
        grads of `loss_fn(params cast to the compute dtype, *batch)` at
        the f32 params, by the fused step's gradient function. The batch
        goes to the device and is not cast, as in the reference."""
        if self.state.mixed_precision == PrecisionType.FP8:
            raise NotImplementedError(
                "mixed_precision='fp8' requires the fused "
                "accelerator.train_step() path (it threads Fp8Meta state "
                "through TrainState); the eager compute_gradients/backward "
                "chain does not support fp8.")
        batch = to_device(batch, self.device)
        out, grads = _value_and_grad(loss_fn, params, batch,
                                     self.compute_dtype, tuple_out=has_aux)
        # the global batch's gradient and loss, as under the reference's
        # GSPMD: averaged across processes here, not at the boundary
        ops.all_reduce_mean_(tree_leaves(grads))
        if has_aux:
            return (_all_reduce_metric(out[0].detach()),
                    _all_reduce_metric(out[1])), grads
        return _all_reduce_metric(out.detach()), grads

    def backward(self, loss_or_grads: Any = None, *, grads: Any = None,
                 **kwargs) -> None:
        """Add `grads / gradient_accumulation_steps` into every prepared
        optimizer's buffer. It takes the gradients `compute_gradients`
        returned; a loss raises, as in the reference."""
        if grads is None:
            grads = loss_or_grads
        if grads is None or not tree_leaves(grads):
            raise ValueError(
                "accelerator.backward needs gradients: "
                "loss, grads = accelerator.compute_gradients(loss_fn, "
                "params, batch); accelerator.backward(grads)")
        if isinstance(grads, (torch.Tensor, np.ndarray)) and \
                np.ndim(grads) == 0:
            raise ValueError(
                "Got a scalar loss. The eager API has no backward tape: "
                "compute grads with accelerator.compute_gradients(...) and "
                "pass them here, or use the fused accelerator.train_step(...).")
        scale = 1.0 / self.gradient_state.num_steps
        for opt in self._optimizers:
            opt.accumulate_grads(grads, scale)

    @torch.no_grad()
    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0,
                        norm_type: int = 2):
        """Clip every prepared optimizer's buffer as one group, in place,
        by min(1, max_norm / (norm + 1e-6)) (the fused step's clip), and
        return the pre-clip global norm; None off a sync boundary or with
        no buffer. `parameters` is taken for the signature: the grads
        live on the optimizers."""
        if norm_type != 2:
            raise NotImplementedError(
                "only L2 global-norm clipping is supported")
        if not self.sync_gradients:
            return None
        buffers = [o.gradients for o in self._optimizers
                   if o.gradients is not None]
        if not buffers:
            return None
        return _clip_by_global_norm_(buffers, max_norm)

    @torch.no_grad()
    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0):
        """Clamp every prepared optimizer's buffer to [-clip_value,
        clip_value] in place, at a sync boundary."""
        if not self.sync_gradients:
            return
        for opt in self._optimizers:
            if opt.gradients is not None:
                for g in tree_leaves(opt.gradients):
                    g.clamp_(-clip_value, clip_value)

    def eval_step(self, eval_fn: Callable) -> Callable:
        """`fn(params, *batch)`: `eval_fn` on the params (and, under
        bf16, the float batch leaves) cast to the compute dtype, under
        `torch.no_grad()`."""
        dtype = self.compute_dtype

        @torch.no_grad()
        def step_fn(params, *batch):
            batch = to_device(batch, self.device)
            if dtype == torch.bfloat16:
                batch = cast_floating(batch, dtype)
            return eval_fn(cast_floating(params, dtype), *batch)

        return step_fn

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
            raise _unported("train_step(contract=...)", "analysis slice")
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
        # each built step gets its own cost-table name: two steps sharing
        # one would overwrite each other's FLOPs and merge their samples
        self._cost_names_built += 1
        n = self._cost_names_built
        return _TrainStep(self, loss_fn, has_aux,
                          max_grad_norm if max_grad_norm is not None
                          else self.gradient_clipping, donate,
                          cost_name="train_step" if n == 1
                          else f"train_step_{n}")

    def _note_train_dispatch(self) -> None:
        """Per-step heartbeat: counts the step and ticks the stall
        watchdog."""
        self._c_train_steps.inc()
        if self.stall_watchdog is not None:
            self.stall_watchdog.tick()

    # --------------------------------------------------------- collectives
    def gather(self, tensor):
        return ops.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """`gather` (objects through `gather_object`, flattened), then, in
        the final batch of a loader whose tail was padded, the pad rows
        dropped: with the loader's `tail_layout` (processes, padded, real)
        each process's block keeps its `real` rows, else the first
        `remainder` rows are kept."""
        leaves = ops._leaves(input_data)
        recursively = bool(leaves) and all(ops.is_tensor(x) for x in leaves)
        if use_gather_object or not recursively:
            data = ops.gather_object(input_data)
            data = [x for sub in data
                    for x in (sub if isinstance(sub, list) else [sub])]
        else:
            data = self.gather(input_data)
        remainder = self.gradient_state.remainder
        if not (self.gradient_state.end_of_dataloader
                and remainder is not None and remainder > 0):
            return data
        layout = self.gradient_state.tail_layout

        def truncate(x):
            if layout is not None and getattr(x, "ndim", 0):
                hosts, padded, real = layout
                if x.shape[0] == hosts * padded:
                    blocks = x.reshape((hosts, padded) + tuple(x.shape[1:]))
                    return blocks[:, :real].reshape(
                        (hosts * real,) + tuple(x.shape[1:]))
            return x[:remainder]

        return ops._map(truncate, data) if recursively else data[:remainder]

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return ops.reduce(tensor, reduction, scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return ops.pad_across_processes(tensor, dim, pad_index, pad_first)

    def broadcast(self, tensor, from_process: int = 0):
        return ops.broadcast(tensor, from_process)

    # --------------------------------------------- early stop coordination
    def set_trigger(self) -> None:
        """Raise the early-stop flag on this process."""
        self.flag_tensor = torch.ones(1, device=self.device)

    def check_trigger(self) -> bool:
        """True, and the flag cleared, if any process raised it."""
        local = (self.flag_tensor if self.flag_tensor is not None
                 else torch.zeros(1, device=self.device))
        if float(ops.reduce(local, "sum")[0]) >= 1:
            self.flag_tensor = None
            return True
        return False

    def context_attention(self, q, k, v, causal: bool = True,
                          window: int | None = None):
        """The reference's sequence-parallel attention (ring or Ulysses
        over the mesh) arrives with sharded parallelism."""
        raise NotImplementedError(
            f"context_attention (ring/Ulysses over a mesh) arrives with the "
            f"port's {_ITEM_6B}")

    # --------------------------------------------------------- profiling
    def profile(self, logdir: str):
        """`profiler.profile(logdir)`: a torch.profiler trace of the block
        written to `<logdir>/trace.json`."""
        from .profiler import profile as _profile

        return _profile(logdir)

    def step_timer(self, flops_per_step: float = 0.0,
                   tokens_per_step: int = 0, fresh: bool = True, **kwargs):
        """A `profiler.StepTimer` on the shared telemetry registry; with
        `fresh=True` its series start empty."""
        from .profiler import StepTimer
        from .telemetry.registry import get_registry

        kwargs.setdefault("registry", get_registry())
        timer = StepTimer(flops_per_step=flops_per_step,
                          tokens_per_step=tokens_per_step, **kwargs)
        if fresh:
            timer.reset()
        return timer

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: bool | None = None):
        """Inside, every prepared loader (and the loaders and samplers it
        wraps) that has an `even_batches` flag takes the given value."""
        if even_batches is None:
            yield
            return
        overridden = []
        seen: set[int] = set()

        def walk(obj, depth=0):
            if obj is None or depth > 4 or id(obj) in seen:
                return
            seen.add(id(obj))
            if hasattr(obj, "even_batches"):
                overridden.append((obj, obj.even_batches))
                obj.even_batches = even_batches
            for attr in ("loader", "batch_sampler", "sampler"):
                walk(getattr(obj, attr, None), depth + 1)

        for dl in self._dataloaders:
            walk(dl)
        try:
            yield
        finally:
            for obj, old in overridden:
                obj.even_batches = old

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """No wrappers exist: the model as it is."""
        return model

    # ------------------------------------------------------------- data
    def free_memory(self, *objects):
        """Drop the references to the prepared optimizers, schedulers,
        loaders and models, reset the step count and return the card's
        cached free memory (`utils.memory.release_memory`); use as `a, b =
        acc.free_memory(a, b)`."""
        self._optimizers = []
        self._schedulers = []
        self._dataloaders = []
        self._models = []
        self.step = 0
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """The loader with its first `num_batches` skipped (a resume in
        the middle of a pass)."""
        return skip_first_batches(dataloader, num_batches)

    # ------------------------------------------------------------- trackers
    def init_trackers(self, project_name: str, config: dict | None = None,
                      init_kwargs: dict | None = None) -> None:
        """Start the `log_with` trackers for `project_name` (under
        `ProjectConfiguration.logging_dir` where a backend writes files)
        and store `config` with each."""
        from .tracking import filter_trackers

        self.trackers = filter_trackers(
            self.log_with, self.project_configuration.logging_dir,
            project_name, init_kwargs or {})
        if config is not None:
            for tracker in self.trackers:
                tracker.store_init_configuration(config)

    def log(self, values: dict, step: int | None = None,
            log_kwargs: dict | None = None) -> None:
        """Log `values` to every tracker (on the main process);
        `log_kwargs[name]` goes to that tracker's `log`."""
        self._c_logs.inc()
        if self.stall_watchdog is not None:
            # log boundaries are heartbeats too: eager loops that never
            # call the fused step still feed the watchdog
            self.stall_watchdog.tick()
        self._record_hbm_high_water()
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log(values, step=step,
                            **((log_kwargs or {}).get(tracker.name, {})))

    def _record_hbm_high_water(self) -> None:
        """The card's allocation high-water mark into a gauge (at log
        boundaries only, not per step); nothing on the CPU."""
        if self.device.type == "cuda":
            self.telemetry.gauge("device_hbm_bytes_in_use_peak").set_max(
                float(torch.cuda.max_memory_allocated(self.device)))

    def log_telemetry(self, step: int | None = None,
                      aggregate: bool = True) -> dict[str, float]:
        """A snapshot of the telemetry registry (`telemetry/...` keys:
        counters, gauges, each histogram's count, mean and quantiles)
        logged through the trackers, and returned. With one process the
        snapshot is this process's, as the reference's is; `aggregate` is
        taken for its signature."""
        from .telemetry.export import snapshot_for_tracking

        self._record_hbm_high_water()
        flat = snapshot_for_tracking(self.telemetry)
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log(flat, step=step)
        return flat

    def get_tracker(self, name: str, unwrap: bool = False):
        """The started tracker named `name` (its backend object with
        `unwrap=True`); raises if none is."""
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(
            f"tracker {name} not initialized; call init_trackers first")

    def end_training(self) -> None:
        """Drain the async checkpoint writes (a failed one re-raises),
        then, whatever the drain did, finish every tracker and stop the
        exporter and the watchdog."""
        try:
            checkpointing.wait_for_checkpoints()
        finally:
            for tracker in self.trackers:
                tracker.finish()
            if self.metrics_server is not None:
                self.metrics_server.stop()
                self.metrics_server = None
            if self.stall_watchdog is not None:
                self.stall_watchdog.stop()
                self.stall_watchdog = None

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
        """Checkpoint `state`, the prepared eager optimizers and schedulers
        and the registered objects into `output_dir` (default: the next
        versioned directory under `project_dir`).
        `async_save=True` overlaps the file writes with later steps (drain
        with `wait_for_checkpoints()`; `load_state`/`end_training` drain
        too)."""
        if output_dir is None:
            output_dir = self._checkpoint_dir(new=True)
        for hook in self._save_model_state_pre_hook.values():
            hook(self._models, None, output_dir)
        return checkpointing.save_accelerator_state(
            output_dir,
            train_states=[state] if state is not None else [],
            optimizers=self._optimizers,
            schedulers=self._schedulers,
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
        """Restore a checkpoint into `state` and the prepared eager
        optimizers and schedulers, in place (default: the newest versioned
        directory under `project_dir`)."""
        if input_dir is None:
            input_dir = self._checkpoint_dir(new=False)
        for hook in self._load_model_state_pre_hook.values():
            hook(self._models, input_dir)
        result = checkpointing.load_accelerator_state(
            input_dir,
            train_states=[state] if state is not None else [],
            optimizers=self._optimizers,
            schedulers=self._schedulers,
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
            hook(self._models, input_dir)
        result = checkpointing.resume_latest(
            input_dir,
            train_states=[state] if state is not None else [],
            optimizers=self._optimizers,
            schedulers=self._schedulers,
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
        writing one of them) or the newest. The main process lists and
        prunes, and broadcasts its decision (or its error) to the others,
        so every process writes into one directory."""
        base = os.path.join(self.project_configuration.project_dir or ".",
                            "checkpoints")
        if not self.project_configuration.automatic_checkpoint_naming:
            return base
        decision = None
        if self.is_main_process:
            # an error here must still reach the broadcast, or every other
            # process waits in it for rank 0
            try:
                decision = self._decide_checkpoint_dir(base, new)
            except Exception as e:
                decision = e
        if self.num_processes > 1:
            (decision,) = ops.broadcast_object_list([decision])
        if isinstance(decision, Exception):
            raise decision
        if new:
            self.project_configuration.iteration = int(
                decision.rsplit("_", 1)[1])
        return decision

    def _decide_checkpoint_dir(self, base: str, new: bool) -> str:
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


def _token_ids(batch):
    """A causal-LM batch's token ids (a tensor or a numpy array): the
    `input_ids` of its first dict argument, else its first 2-D integer
    array."""
    for arg in batch:
        if isinstance(arg, dict) and np.ndim(arg.get("input_ids")) == 2:
            return arg["input_ids"]
    for leaf in tree_leaves(list(batch)):
        if np.ndim(leaf) == 2 and (
                leaf.dtype.kind in "iu" if isinstance(leaf, np.ndarray)
                else isinstance(leaf, torch.Tensor)
                and not leaf.is_floating_point()):
            return leaf
    return None


def _train_step_cost(params, ids_shape, accum_steps: int,
                     elt: int) -> tuple[float, float]:
    """Analytic (flops, bytes) of one train-step call on a causal-LM
    batch of token ids of shape [B, T] (T - 1 predicted tokens a row).

    FLOPs: `causal_lm_train_flops(N, B*(T-1), L, h, T-1)`, bench.py's
    reckoning, 6N + 12*L*h*(T-1) a token, with L and h read off the
    first leaf of a stacked `params["layers"]` (its first norm's scale,
    [L, h]; the attention term is left out without one).

    Bytes, a floor: per optimizer update AdamW's f32 traffic of 28 B a
    parameter (read the master, its gradient and both moments; write the
    master and both moments), spread over the `accum_steps` calls an
    update takes, plus three reads a call of the weights in the compute
    dtype (`elt` bytes each: the forward, its recompute and the
    backward)."""
    from .models.common import count_params
    from .profiler import causal_lm_train_flops

    n = count_params(params)
    rows, seq = ids_shape[0], ids_shape[1] - 1
    layers, hidden = 0, 0
    stacked = params.get("layers") if isinstance(params, dict) else None
    first = tree_leaves(stacked)[:1] if isinstance(stacked, dict) else []
    if first and first[0].dim() == 2:
        layers, hidden = first[0].shape
    flops = causal_lm_train_flops(n, rows * seq, layers, hidden, seq)
    nbytes = n * (28.0 / accum_steps + 3 * elt)
    return flops, nbytes


class _TrainStep:
    def __init__(self, acc: Accelerator, loss_fn: Callable, has_aux: bool,
                 max_grad_norm: float | None, donate: bool,
                 cost_name: str = "train_step"):
        self.acc = acc
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.max_grad_norm = max_grad_norm
        self.donate = donate
        self._cost_name = cost_name
        self._cost_key = None

    def __call__(self, state: TrainState, *batch):
        """One step; its device time is fence-sampled at the cost table's
        cadence (a synchronize before and after the call, outside it)."""
        acc = self.acc
        table = acc.cost_table
        self._register_cost(state, batch)
        sampling = table.sample_due(self._cost_name)
        if sampling:
            fence(state)
            t0 = table.clock()
        out = self._step(state, *batch)
        if sampling:
            fence(out)
            table.record_device_time(self._cost_name, table.clock() - t0)
        acc._note_train_dispatch()
        return out

    def _register_cost(self, state: TrainState, batch) -> None:
        """The analytic cost, registered at the first call and again when
        the batch's shape or the accumulation count changes; a batch
        without token ids registers nothing."""
        ids = _token_ids(batch)
        key = (None if ids is None else tuple(ids.shape),
               self.acc.gradient_accumulation_steps)
        if key == self._cost_key:
            return
        self._cost_key = key
        if ids is None:
            return
        elt = torch.finfo(self.acc.compute_dtype).bits // 8
        self.acc.cost_table.register(
            self._cost_name, replace=True,
            fallback=lambda: _train_step_cost(state.params, key[0], key[1],
                                              elt))

    def _step(self, state: TrainState, *batch):
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
        # bf16 casts float batch leaves too; fp16 keeps them f32, as the
        # reference does (targets may overflow fp16)
        if dtype == torch.bfloat16:
            batch = cast_floating(batch, dtype)
        # the fp8 casts happen inside the model's fp8_dense calls
        out, grads = _value_and_grad(
            self.loss_fn, state.params, batch, dtype,
            tuple_out=self.has_aux or use_fp8,
            scale=state.loss_scale.scale if use_scale else None,
            **({"fp8_state": state.fp8_state} if use_fp8 else {}))
        if use_fp8:
            loss, aux, new_fp8 = out if self.has_aux else (out[0], None,
                                                           out[1])
            # every micro-step, accumulating or not (the amax window is a
            # per-step statistic); after the backward, which under remat
            # reruns the forward with this step's scales; across
            # processes the new windows become the global batch's
            _copy_metas(state.fp8_state, new_fp8)
            fp8.all_reduce_metas_(state.fp8_state)
        else:
            loss = out[0] if self.has_aux else out
            aux = out[1] if self.has_aux else None
        del out
        # the global batch's gradient, before the clip, the finite check
        # and the update, so every process decides and updates alike
        ops.all_reduce_mean_(tree_leaves(grads))
        if use_scale:
            inv = 1.0 / state.loss_scale.scale
            for g in tree_leaves(grads):
                g.mul_(inv)
            finite = torch.isfinite(global_norm(grads))
        else:
            finite = torch.ones((), dtype=torch.bool, device=acc.device)

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
        metrics = {"loss": _all_reduce_metric(loss.detach())}
        if self.has_aux:
            metrics["aux"] = _all_reduce_metric(aux)
        return new_state, metrics

    def _clipped(self, grads):
        """Grads clipped in place (`_clip_by_global_norm_`). They are the
        step's own: fresh grads, or the accumulation buffer, which is
        zeroed right after the update."""
        if self.max_grad_norm is not None:
            _clip_by_global_norm_([grads], self.max_grad_norm)
        return grads
