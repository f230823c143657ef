"""TrainState and the pieces of the training step around it (port of
`accelerate_tpu/training.py`: the state, the loss scale, the bf16 cast,
the clip, and `run_resilient`, the preemption-tolerant training loop).

The reference's state is an immutable pytree that a compiled step
replaces whole. Here the state owns its tensors and the step updates
them in place (params by `apply_updates`, optimizer moments by the
optimizer's `update`, the accumulation buffer by the step); the methods
still return a state object, so the reference's
`state, metrics = step(state, batch)` loop reads the same.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import Any, Callable

import torch

from .checkpointing import latest_complete_checkpoint, prune_checkpoints
from .optimizers import GradientTransformation, apply_updates, tree_leaves, \
    tree_map
from .profiler import StepTimer


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


# ---------------------------------------------------------------------------
# goodput-grade resilient training loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResilienceReport:
    """What `run_resilient` lived through and what it cost."""

    state: Any                      # the final TrainState
    steps_completed: int            # global step index reached
    start_step: int                 # where this invocation (re)started
    resumes: int                    # in-process crash recoveries
    saves: int                      # checkpoints written
    preempted: bool                 # True when a drain signal ended the run
    goodput: float                  # StepTimer.goodput over the run
    taxonomy: dict                  # StepTimer.stall_taxonomy()
    checkpoint_dir: str
    last_commit_dir: str | None     # newest complete checkpoint at exit
    incidents: list                 # straggler reports raised during the run


def run_resilient(
    accelerator,
    state: "TrainState",
    step_fn: Callable,
    batch_fn: Callable,
    num_steps: int,
    checkpoint_dir: str,
    *,
    save_every: int = 0,
    keep_last_n: int = 2,
    timer: Any = None,
    max_resumes: int = 3,
    blocking_saves: bool = False,
    install_signal_handlers: bool = True,
    drain_signals: tuple = (signal.SIGTERM,),
    straggler_monitor: Any = None,
    poll_every: int = 0,
    restart_on_straggler: bool = False,
    on_step: Callable | None = None,
) -> ResilienceReport:
    """Preemption-tolerant training loop: step-overlapped checkpoints,
    SIGTERM drain-then-save, step-crash auto-resume from the last
    committed manifest, and the straggler closed loop — the goodput
    number stays honest because every save/stall is marked on `timer`.

    - `step_fn(state, batch) -> (state, metrics)` — the train step
      (`Accelerator.train_step`), which updates the state's tensors in
      place; a resume copies the checkpoint back into them.
    - `batch_fn(step_index) -> batch` must be deterministic in the step
      index — that is what makes the data position resumable (the host
      RNG streams restore too, for stochastic pipelines keyed on them).
    - `save_every > 0` checkpoints every N steps into
      `checkpoint_dir/step_<N>`, async by default (the device->host
      snapshot is the only in-loop cost; the write overlaps later
      steps), committed via manifest, pruned to `keep_last_n` (the
      newest complete commit is never deleted). `blocking_saves=True`
      is the measurement baseline: the full write blocks in-loop.
    - A drain signal (SIGTERM by default — the preemption notice) ends
      the loop at the next step boundary AFTER saving; crashes inside a
      step restore from the newest complete manifest and continue, at
      most `max_resumes` times (incident bundles arrive with the
      port's telemetry slice).
    - `straggler_monitor` (telemetry.StragglerMonitor) is polled every
      `poll_every` steps; `restart_on_straggler=True` wires its incident
      to the drain path — the single-job form of elastic restart.

    Returns a :class:`ResilienceReport`; `state` inside it is the final
    train state (a resume restores into the given state's tensors in
    place)."""
    if timer is None:
        timer = StepTimer(warmup_steps=1, name="resilient_step")
    checkpoint_dir = os.path.abspath(os.path.expanduser(checkpoint_dir))
    os.makedirs(checkpoint_dir, exist_ok=True)

    resumed = accelerator.resume_latest(checkpoint_dir, state=state)
    start = int(resumed["step"]) if resumed is not None else 0
    last_commit = resumed["checkpoint_dir"] if resumed is not None else None

    drain = {"requested": False, "signum": None}

    def _request_drain(signum=None, frame=None):
        drain["requested"] = True
        drain["signum"] = signum

    if straggler_monitor is not None and restart_on_straggler \
            and straggler_monitor.on_straggler is None:
        straggler_monitor.on_straggler = lambda report: _request_drain()
    if straggler_monitor is not None and straggler_monitor.timer is None:
        straggler_monitor.timer = timer

    prev_handlers: dict = {}
    if install_signal_handlers \
            and threading.current_thread() is threading.main_thread():
        for sig in drain_signals:
            prev_handlers[sig] = signal.signal(sig, _request_drain)

    def _save(step_index: int, marked: bool) -> str:
        # accelerator.step is what save_accelerator_state persists as the
        # resume point — pin it to the loop's global step index
        accelerator.step = step_index
        target = os.path.join(checkpoint_dir, f"step_{step_index:08d}")
        if marked:
            kind = "checkpoint" if blocking_saves else "checkpoint_stage"
            with timer.overhead(kind):
                accelerator.save_state(target, state=state,
                                       async_save=not blocking_saves)
        else:
            accelerator.save_state(target, state=state,
                                   async_save=not blocking_saves)
        prune_checkpoints(checkpoint_dir, keep_last_n)
        return target

    resumes = saves = 0
    preempted = False
    incidents: list = []
    i = start
    try:
        while i < num_steps:
            if drain["requested"]:
                # drain-then-save: commit a resume point, then hand the
                # machine back — the relaunch continues from here
                _save(i, marked=False)
                accelerator.wait_for_checkpoints()
                saves += 1
                preempted = True
                break
            try:
                with timer.input_stall():
                    batch = batch_fn(i)
                with timer.dispatch():
                    state, metrics = step_fn(state, batch)
                timer.tick(state)
                if on_step is not None:
                    on_step(i, state, metrics)
            except Exception as exc:
                resumes += 1
                if resumes > max_resumes:
                    raise
                _write_crash_bundle(exc, accelerator)
                try:
                    # drain in-flight async saves so everything already
                    # enqueued publishes its manifest before we look for
                    # the newest complete commit
                    accelerator.wait_for_checkpoints()
                except Exception:
                    pass  # writer failure: sealed manifests were dropped
                restored = accelerator.resume_latest(checkpoint_dir,
                                                     state=state)
                if restored is None:
                    raise       # nothing committed yet: nothing to resume
                last_commit = restored["checkpoint_dir"]
                i = int(restored.get("step", 0))
                continue
            i += 1
            if save_every and i % save_every == 0 and i < num_steps:
                _save(i, marked=True)
                saves += 1
            if straggler_monitor is not None and poll_every \
                    and i % poll_every == 0:
                report = straggler_monitor.poll()
                if report is not None:
                    incidents.append(report)
        if not preempted and save_every and i > start:
            # final commit: un-marked on the timer — the goodput window
            # closed at the last tick, so marking post-window work would
            # subtract it without its wall time
            _save(i, marked=False)
            saves += 1
        accelerator.wait_for_checkpoints()
        if saves:
            # the periodic prunes ran before the async manifests published
            # (a not-yet-committed save is invisible to retention), so one
            # post-drain prune brings the directory down to keep_last_n
            prune_checkpoints(checkpoint_dir, keep_last_n=keep_last_n)
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)

    if saves:
        last_commit = latest_complete_checkpoint(checkpoint_dir) or last_commit
    goodput = timer.goodput
    return ResilienceReport(
        state=state,
        steps_completed=i,
        start_step=start,
        resumes=resumes,
        saves=saves,
        preempted=preempted,
        goodput=goodput if goodput == goodput else 0.0,
        taxonomy=timer.stall_taxonomy(),
        checkpoint_dir=checkpoint_dir,
        last_commit_dir=last_commit,
        incidents=incidents,
    )


def _write_crash_bundle(exc: BaseException, accelerator) -> str | None:
    """The reference writes an incident bundle for a step-time crash when
    its incident directory is set. The port has no bundle writer yet (it
    arrives with the telemetry slice, the stall watchdog's), and reads no
    environment variable for the directory: no bundle, None."""
    return None


def clone_tree(tree: Any) -> Any:
    """The tree with every tensor copied (dicts, lists, tuples and
    NamedTuples kept): the new tensors of a step that must leave its
    input state as it was (`train_step(donate=False)`)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


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
