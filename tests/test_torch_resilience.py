"""Resilient training in the port (`training.run_resilient` over
`checkpointing`): the reference's cases (`tests/test_resilience.py`) run
on the port, plus parity with the JAX package.

The port's cases: a plain loop, a step-time crash auto-resumed
loss-curve-exact, a crash with nothing committed, exhausted resumes, the
SIGTERM drain and relaunch, goodput with async against blocking saves,
`resume_latest` on an empty directory and past a torn save, the async
commit, retention, the stall taxonomy, and the straggler monitor's loop
and restart.

Parity: the reference's toy loop (`_W = 64`, adam 1e-2) and
`LlamaConfig.tiny()` through `Accelerator.train_step` (mixed precision
"no", clip 1.0, adamw 3e-3), the same weights in both packages (carried
by `models/convert.py`), each faulted by a crash at step 5 or by SIGTERM
at step 4 and a relaunch. The port's faulted curve equals its own
unfaulted curve exactly, and agrees with the JAX package's curve within
1e-6 (toy) and 1e-5 (tiny llama: two f32 summation orders over a small
model, as `test_torch_training.py`). The JAX curve is its unfaulted run,
computed once per model: the JAX package's faulted runs record exactly
its unfaulted losses (its own `test_resilience.py`, and the toy case
here), and a faulted JAX run costs seconds of orbax set-up and
recompiles."""

from __future__ import annotations

import functools
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu as at
from accelerate_tpu import training as jt
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import checkpointing as ckpt
from accelerate_tpu_torch import optimizers as to
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.profiler import StepTimer
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.telemetry.registry import MetricsRegistry
from accelerate_tpu_torch.telemetry.straggler import StragglerMonitor
from accelerate_tpu_torch.training import ResilienceReport, TrainState, \
    run_resilient
from accelerate_tpu_torch.utils import safetensors as st

_W = 64


@pytest.fixture(autouse=True)
def _fresh_state():
    PartialState._reset_state()
    yield
    ckpt.wait_for_checkpoints()
    PartialState._reset_state()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_state():
    return TrainState.create(apply_fn=None,
                             params={"w": torch.eye(_W) * 0.5},
                             tx=to.adam(1e-2))


def _loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _step_fn(state, batch):
    return Accelerator(cpu=True).train_step(_loss)(state, batch)


_X = np.random.RandomState(0).randn(8, _W).astype("float32")
_Y = np.random.RandomState(1).randn(8, _W).astype("float32")


def _batch_fn(i):
    return {"x": torch.tensor(_X), "y": torch.tensor(_Y)}


def _losses(num_steps):
    """The unfaulted reference trajectory."""
    state = _make_state()
    out = []
    for i in range(num_steps):
        state, m = _step_fn(state, _batch_fn(i))
        out.append(float(m["loss"]))
    return out


def test_run_resilient_plain_loop(tmp_path):
    acc = Accelerator(cpu=True)
    rep = run_resilient(acc, _make_state(), _step_fn, _batch_fn, 6,
                        str(tmp_path), save_every=3)
    assert isinstance(rep, ResilienceReport)
    assert rep.steps_completed == 6 and rep.resumes == 0
    assert rep.saves == 2  # one periodic + the final commit
    assert rep.last_commit_dir and ckpt.is_complete_checkpoint(
        rep.last_commit_dir)
    assert "step" in rep.taxonomy


def test_crash_auto_resume_loss_curve_exact(tmp_path):
    """A step-time crash rolls back to the last commit and the trajectory
    re-converges EXACTLY with the unfaulted run."""
    reference = _losses(8)
    acc = Accelerator(cpu=True)
    seen: dict[int, float] = {}
    fault = {"armed": True}

    def on_step(i, state, metrics):
        if fault["armed"] and i == 5:
            fault["armed"] = False
            raise RuntimeError("injected step-time fault")
        seen[i] = float(metrics["loss"])

    rep = run_resilient(acc, _make_state(), _step_fn, _batch_fn, 8,
                        str(tmp_path), save_every=2, on_step=on_step)
    assert rep.resumes == 1 and rep.steps_completed == 8
    assert sorted(seen) == list(range(8))
    for i, loss in seen.items():
        assert loss == reference[i], i


def test_crash_with_nothing_committed_reraises(tmp_path):
    acc = Accelerator(cpu=True)

    def on_step(i, state, metrics):
        raise RuntimeError("crash before any save")

    with pytest.raises(RuntimeError, match="crash before any save"):
        run_resilient(acc, _make_state(), _step_fn, _batch_fn, 4,
                      str(tmp_path), save_every=2, on_step=on_step)


def test_max_resumes_exhausted_reraises(tmp_path):
    acc = Accelerator(cpu=True)

    def on_step(i, state, metrics):
        raise RuntimeError("persistent fault")

    # seed one commit so every retry has somewhere to resume from
    acc.step = 0
    acc.save_state(os.path.join(str(tmp_path), "step_00000000"),
                   state=_make_state())
    with pytest.raises(RuntimeError, match="persistent fault"):
        run_resilient(acc, _make_state(), _step_fn, _batch_fn, 4,
                      str(tmp_path), save_every=2, max_resumes=2,
                      on_step=on_step)


def test_sigterm_drains_then_saves(tmp_path):
    """SIGTERM mid-run: finish the in-flight step, commit a resume point,
    hand the machine back; the relaunch continues to completion on the
    exact reference trajectory."""
    reference = _losses(10)
    acc = Accelerator(cpu=True)
    prev_handler = signal.getsignal(signal.SIGTERM)

    def send_sigterm(i, state, metrics):
        if i == 4:
            os.kill(os.getpid(), signal.SIGTERM)

    rep = run_resilient(acc, _make_state(), _step_fn, _batch_fn, 10,
                        str(tmp_path), save_every=100, on_step=send_sigterm)
    assert rep.preempted and rep.saves == 1
    assert rep.steps_completed == 5  # step 4 finished, then drained
    assert signal.getsignal(signal.SIGTERM) is prev_handler  # restored

    seen: dict[int, float] = {}
    rep2 = run_resilient(
        acc, _make_state(), _step_fn, _batch_fn, 10, str(tmp_path),
        save_every=100,
        on_step=lambda i, s, m: seen.__setitem__(i, float(m["loss"])))
    assert rep2.start_step == 5 and not rep2.preempted
    assert sorted(seen) == list(range(5, 10))
    for i, loss in seen.items():
        assert loss == reference[i], i


# The port writes the toy's 16 KB in about a millisecond, where the
# reference's orbax write of the same state takes hundreds. A fixed write
# time per file (a slow store, the same in both arms) keeps what the A/B
# is for: whether the write lands inside the goodput window or overlaps
# the steps that follow it.
_WRITE_S = 0.1


def _timed_run(tmp_path, blocking: bool, label: str) -> ResilienceReport:
    acc = Accelerator(cpu=True)
    timer = StepTimer(warmup_steps=1, name=f"goodput_{label}")

    def slow_step(state, batch):
        out = _step_fn(state, batch)
        time.sleep(0.06)  # a 60ms device step the host can't observe
        return out

    return run_resilient(
        acc, _make_state(), slow_step, _batch_fn, 10,
        os.path.join(str(tmp_path), label), save_every=3, timer=timer,
        blocking_saves=blocking)


def test_goodput_async_vs_blocking(tmp_path, monkeypatch):
    """On the same save schedule, step-overlapped saves keep goodput
    >= 0.9 while blocking saves sit measurably lower (the full write
    lands inside the step window)."""
    real = st.save_file

    def slow_store(*args, **kwargs):
        time.sleep(_WRITE_S)
        return real(*args, **kwargs)

    monkeypatch.setattr(st, "save_file", slow_store)
    ckpt.warm_async_checkpointer()  # one-time writer setup, outside the A/B
    rep_async = _timed_run(tmp_path, blocking=False, label="overlapped")
    if rep_async.goodput < 0.9:  # one retry: absorb a transient load spike
        rep_async = _timed_run(tmp_path, blocking=False, label="overlapped2")
    rep_block = _timed_run(tmp_path, blocking=True, label="blocking")
    assert rep_async.goodput >= 0.9, rep_async.taxonomy
    assert rep_block.goodput < rep_async.goodput - 0.05, (
        rep_async.goodput, rep_block.goodput, rep_block.taxonomy)
    # the taxonomy attributes where the blocking run's time went
    assert rep_block.taxonomy.get("checkpoint", 0.0) > \
        rep_async.taxonomy.get("checkpoint_stage", 0.0)


def test_resume_latest_empty_dir_is_fresh_start(tmp_path):
    acc = Accelerator(cpu=True)
    assert acc.resume_latest(str(tmp_path)) is None


def test_resume_latest_skips_torn_save(tmp_path):
    """A later save whose manifest never committed is invisible: resume
    picks the older COMPLETE checkpoint."""
    acc = Accelerator(cpu=True)
    state = _make_state()
    good = os.path.join(str(tmp_path), "step_00000002")
    acc.step = 2
    acc.save_state(good, state=state)
    torn = os.path.join(str(tmp_path), "step_00000004")
    acc.step = 4
    acc.save_state(torn, state=state)
    os.remove(os.path.join(torn, ckpt.MANIFEST_NAME))  # crash before commit
    restored = acc.resume_latest(str(tmp_path), state=state)
    assert restored is not None
    assert restored["checkpoint_dir"] == os.path.abspath(good)
    assert restored["step"] == 2 and acc.step == 2


def test_async_save_commits_only_after_drain(tmp_path):
    acc = Accelerator(cpu=True)
    target = os.path.join(str(tmp_path), "step_00000001")
    acc.step = 1
    acc.save_state(target, state=_make_state(), async_save=True)
    acc.wait_for_checkpoints()
    assert ckpt.is_complete_checkpoint(target)
    restored = acc.resume_latest(str(tmp_path), state=_make_state())
    assert restored is not None and restored["step"] == 1


def test_prune_checkpoints_never_deletes_newest(tmp_path):
    acc = Accelerator(cpu=True)
    state = _make_state()
    for s in (1, 2, 3):
        acc.step = s
        acc.save_state(os.path.join(str(tmp_path), f"step_{s:08d}"),
                       state=state)
    removed = ckpt.prune_checkpoints(str(tmp_path), keep_last_n=1)
    assert len(removed) == 2
    assert ckpt.latest_complete_checkpoint(
        str(tmp_path)).endswith("step_00000003")


def test_stall_taxonomy_buckets():
    timer = StepTimer(warmup_steps=0, name="taxonomy")
    timer.tick()
    with timer.input_stall():
        time.sleep(0.01)
    with timer.overhead("checkpoint_stage"):
        time.sleep(0.01)
    timer.tick()
    timer.note_lost("straggler", 0.5)
    tax = timer.stall_taxonomy()
    assert tax["input"] >= 0.01
    assert tax["checkpoint_stage"] >= 0.01
    assert tax["straggler"] == pytest.approx(0.5)
    assert tax["step"] >= 0.0


def test_straggler_monitor_closed_loop():
    """The reference's loop; without an `incident_dir` a report's
    `bundle_path` is None."""
    reg = MetricsRegistry()
    fired = []
    timer = StepTimer(warmup_steps=0, name="straggler_timer")
    mon = StragglerMonitor("step_time_seconds", ratio_threshold=1.5,
                           patience=2, registry=reg,
                           on_straggler=fired.append, timer=timer)

    def agg(slowest, mean=0.010):
        return {"num_hosts": 4, "histograms": {"step_time_seconds": {
            "count": 64.0, "mean": mean, "slowest_host_mean": slowest}}}

    timer.tick()
    timer.tick()  # taxonomy is empty until a step interval records

    assert mon.observe(agg(0.011)) is None          # healthy
    assert mon.observe(agg(0.020)) is None          # strike 1
    report = mon.observe(agg(0.020))                # strike 2: fires once
    assert report is not None and fired == [report]
    assert report["kind"] == "straggler"
    assert report["ratio"] == pytest.approx(2.0)
    assert report["bundle_path"] is None
    assert mon.observe(agg(0.020)) is None          # same episode: silent
    # the lost time was attributed into the goodput taxonomy
    assert timer.stall_taxonomy().get("straggler", 0.0) > 0.0
    assert mon.observe(agg(0.010)) is None          # recovers: re-arms
    assert mon.observe(agg(0.030)) is None
    assert mon.observe(agg(0.030)) is not None      # fresh episode fires
    assert reg.counter("straggler_incidents_total").value == 2.0
    # one process: the aggregate of its own registry never straggles
    reg.histogram("step_time_seconds").record(0.01)
    assert mon.poll() is None
    assert reg.gauge("straggler_ratio",
                     histogram="step_time_seconds").value == 1.0


def test_straggler_monitor_rejects_bad_threshold_and_incident_dir(tmp_path):
    """A threshold at or below 1 raises; an `incident_dir` is taken, and
    a fired straggler writes the reference's `straggler` bundle there,
    which the JAX package's loader reads."""
    from accelerate_tpu.telemetry.watchdog import load_incident_bundle

    with pytest.raises(ValueError):
        StragglerMonitor(ratio_threshold=1.0)
    reg = MetricsRegistry()
    mon = StragglerMonitor("step_time_seconds", ratio_threshold=1.5,
                           patience=1, registry=reg,
                           incident_dir=str(tmp_path))
    report = mon.observe({"num_hosts": 2, "histograms": {
        "step_time_seconds": {"count": 8.0, "mean": 0.01,
                              "slowest_host_mean": 0.03}}})
    assert report["bundle_path"].startswith(str(tmp_path))
    bundle = load_incident_bundle(report["bundle_path"])
    assert bundle["manifest"]["kind"] == "straggler"
    assert bundle["files"]["report.json"]["ratio"] == pytest.approx(3.0)
    assert "metrics.json" in bundle["files"]


def test_run_resilient_restart_on_straggler(tmp_path):
    """A persistent straggler past threshold requests an elastic drain:
    the loop commits a resume point and reports preempted."""
    reg = MetricsRegistry()
    mon = StragglerMonitor("step_time_seconds", ratio_threshold=1.5,
                           patience=1, registry=reg)
    # a single-host poll can never see slowest_host > fleet mean, so feed
    # the monitor a 4-host aggregate where one host runs 3x slow
    mon.poll = lambda: mon.observe({
        "num_hosts": 4,
        "histograms": {"step_time_seconds": {
            "count": 64.0, "mean": 0.01, "slowest_host_mean": 0.03}}})
    acc = Accelerator(cpu=True)
    rep = run_resilient(acc, _make_state(), _step_fn, _batch_fn, 12,
                        os.path.join(str(tmp_path), "ck"), save_every=100,
                        straggler_monitor=mon, poll_every=2,
                        restart_on_straggler=True)
    assert rep.preempted and rep.incidents
    assert rep.incidents[0]["kind"] == "straggler"
    assert ckpt.latest_complete_checkpoint(
        os.path.join(str(tmp_path), "ck")) is not None


# --- parity with the JAX package ---------------------------------------------


def _jax_toy():
    def make_state():
        return jt.TrainState.create(apply_fn=None,
                                    params={"w": jnp.eye(_W) * 0.5},
                                    tx=optax.adam(1e-2))

    @jax.jit
    def _jit_step(state, batch):
        def loss(p):
            return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

        value, grads = jax.value_and_grad(loss)(state.params)
        return state.apply_gradients(grads), {"loss": value}

    def batch_fn(i):
        return {"x": jnp.asarray(_X), "y": jnp.asarray(_Y)}

    return make_state, _jit_step, batch_fn, at.Accelerator


def _port_toy():
    return _make_state, _step_fn, _batch_fn, \
        lambda: Accelerator(cpu=True)


_LR = 3e-3


def _tiny_batches():
    rng = np.random.default_rng(0)
    # batch 8: the JAX Accelerator shards it over the suite's 8 CPU devices
    return [rng.integers(0, 256, (8, 17)).astype(np.int32)
            for _ in range(10)]


def _tiny_init():
    pj = jl.init_params(jl.LlamaConfig.tiny(), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, pj)


def _jax_tiny():
    pn, batches = _tiny_init(), _tiny_batches()
    cfg = jl.LlamaConfig.tiny()
    made = {}

    def acc_fn():
        made["acc"] = at.Accelerator(mixed_precision="no",
                                     gradient_clipping=1.0)
        made["step"] = made["acc"].train_step(
            lambda p, b: jl.causal_lm_loss(cfg, p, b))
        return made["acc"]

    def make_state():
        return made["acc"].prepare(at.TrainState.create(
            apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, pn),
            tx=optax.adamw(_LR)))

    def step_fn(state, batch):
        return made["step"](state, batch)

    def batch_fn(i):
        return {"input_ids": jnp.asarray(batches[i])}

    return make_state, step_fn, batch_fn, acc_fn


def _port_tiny():
    pn, batches = _tiny_init(), _tiny_batches()
    cfg = tl.LlamaConfig.tiny()
    made = {}

    def acc_fn():
        made["acc"] = Accelerator(mixed_precision="no",
                                  gradient_clipping=1.0, cpu=True)
        made["step"] = made["acc"].train_step(
            lambda p, b: tl.causal_lm_loss(cfg, p, b))
        return made["acc"]

    def make_state():
        return made["acc"].prepare(TrainState.create(
            apply_fn=None, params=params_from_numpy(pn, device="cpu"),
            tx=to.adamw(_LR)))

    def step_fn(state, batch):
        return made["step"](state, batch)

    def batch_fn(i):
        return {"input_ids": torch.tensor(batches[i])}

    return make_state, step_fn, batch_fn, acc_fn


def _unfaulted(kit, n, fresh):
    make_state, step_fn, batch_fn, acc_fn = kit
    fresh()
    acc_fn()
    state, out = make_state(), []
    for i in range(n):
        state, m = step_fn(state, batch_fn(i))
        out.append(float(m["loss"]))
    return out


def _faulted(kit, run, n, fault, base, fresh):
    """The losses a faulted run records, by step: a crash at step 5
    (save every 2), or SIGTERM after step 4 then a relaunch."""
    make_state, step_fn, batch_fn, acc_fn = kit
    seen: dict[int, float] = {}
    armed = {"on": True}

    def on_step(i, state, metrics):
        if armed["on"] and fault == "crash" and i == 5:
            armed["on"] = False
            raise RuntimeError("injected step-time fault")
        if armed["on"] and fault == "sigterm" and i == 4:
            armed["on"] = False
            os.kill(os.getpid(), signal.SIGTERM)
        seen[i] = float(metrics["loss"])

    fresh()
    acc = acc_fn()
    rep = run(acc, make_state(), step_fn, batch_fn, n, base, save_every=2,
              on_step=on_step)
    if fault == "crash":
        assert rep.resumes == 1 and not rep.preempted
    else:
        assert rep.preempted and rep.steps_completed == 5
        fresh()
        acc = acc_fn()
        rep = run(acc, make_state(), step_fn, batch_fn, n, base,
                  save_every=2, on_step=on_step)
        assert rep.start_step == 5 and not rep.preempted
    assert rep.steps_completed == n
    return seen


@functools.lru_cache(maxsize=None)
def _jax_unfaulted(model: str, n: int) -> tuple:
    kit = _jax_toy() if model == "toy" else _jax_tiny()
    out = _unfaulted(kit, n, at.PartialState._reset_state)
    at.PartialState._reset_state()
    return tuple(out)


@pytest.mark.parametrize("fault", ["crash", "sigterm"])
@pytest.mark.parametrize("model,atol", [("toy", 1e-6), ("tiny_llama", 1e-5)])
def test_faulted_runs_match_unfaulted_and_jax(model, atol, fault, tmp_path):
    port = _port_toy() if model == "toy" else _port_tiny()
    n = 8
    fresh = PartialState._reset_state
    unfaulted = _unfaulted(port, n, fresh)
    seen = _faulted(port, run_resilient, n, fault, str(tmp_path), fresh)
    assert sorted(seen) == list(range(n))
    for i, loss in seen.items():
        assert loss == unfaulted[i], i          # bit for bit
    np.testing.assert_allclose([seen[i] for i in range(n)],
                               _jax_unfaulted(model, n), atol=atol, rtol=0)


def test_jax_faulted_toy_run_equals_its_unfaulted_run(tmp_path):
    """What the comparison above rests on: the JAX package's own faulted
    run (the same crash at step 5, through its `run_resilient`) records
    the losses of its unfaulted run."""
    seen = _faulted(_jax_toy(), jt.run_resilient, 8, "crash",
                    str(tmp_path), at.PartialState._reset_state)
    at.PartialState._reset_state()
    assert [seen[i] for i in range(8)] == list(_jax_unfaulted("toy", 8))


def test_aggregate_is_one_process_and_refuses_a_larger_world(monkeypatch):
    """The port's aggregate is this process's registry as a one-host
    world, reduced as the JAX package reduces the same snapshot; a
    torch.distributed world of more than one process raises."""
    from accelerate_tpu.telemetry.aggregate import aggregate_snapshot as jagg
    from accelerate_tpu_torch.telemetry.aggregate import aggregate_snapshot

    reg = MetricsRegistry()
    for v in (0.01, 0.02, 0.04):
        reg.histogram("step_time_seconds").record(v)
    reg.counter("steps_total").inc(3)
    reg.gauge("hbm_bytes").set(7.0)
    got = aggregate_snapshot(reg)
    assert got["num_hosts"] == 1
    assert got == jagg(snapshots=[reg.snapshot(include_sketch=True)])
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="parallelism slice"):
        aggregate_snapshot(reg)
    assert aggregate_snapshot(snapshots=[reg.snapshot(include_sketch=True)]
                              )["num_hosts"] == 1
