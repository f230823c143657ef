"""Profiling helpers (port of `accelerate_tpu/profiler.py`).

- `profile(...)`: a `torch.profiler` trace of the block, written as
  Chrome/Perfetto JSON (the HTTP front door's `/debug/profile`);
- `StepTimer`: wall-clock per-step timing with warmup skipping, the
  host-overhead breakdown, goodput and its stall taxonomy, tokens/s and
  MFU against the GPU's peak;
- `causal_lm_train_flops`, `causal_lm_infer_flops`, `peak_flops_per_chip`
  (a table of GPU parts in place of the reference's TPU generations) and
  `device_memory_stats` (on `torch.cuda.memory_stats`).

MFU math: a causal-LM training step costs ~6 FLOPs per parameter per token
(fwd 2 + bwd 4), plus attention ~12*L*H*S per token when `attention=True`;
decoding costs ~2 per parameter per token plus ~4*L*H*kv_len.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

import torch

from .telemetry.registry import StreamingHistogram
from .utils.constants import gpu_peaks

__all__ = ["profile", "StepTimer", "causal_lm_train_flops",
           "causal_lm_infer_flops", "peak_flops_per_chip",
           "device_memory_stats"]


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the block (host ops, and
    device kernels when a CUDA device is present) and write it to
    `<logdir>/trace.json` as Chrome/Perfetto JSON when the block ends.
    The reference records a jax.profiler trace into `logdir` the same
    way."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = _torch_profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> dict[str, int]:
    """The CUDA caching allocator's statistics for `device` (bytes and
    counts, `torch.cuda.memory_stats`); an empty dict without a GPU, as
    the reference returns on a backend without stats."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def peak_flops_per_chip(device=None) -> float:
    """Peak dense bf16 FLOP/s of this GPU (`utils.constants.GPU_PEAKS`,
    by the device's name); 0.0 for a GPU the table lacks, or without
    one."""
    if not torch.cuda.is_available():
        return 0.0
    peaks = gpu_peaks(torch.cuda.get_device_name(device))
    return peaks[0] if peaks is not None else 0.0


def _num_gpus() -> int:
    return max(1, torch.cuda.device_count())


def _cuda_devices(obj, found: set) -> None:
    """Collect the CUDA devices of every tensor in `obj`: a tensor, a
    dataclass such as a TrainState, or nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)


def _block_until_ready(obj) -> None:
    found: set = set()
    _cuda_devices(obj, found)
    for dev in found:
        torch.cuda.synchronize(dev)


def causal_lm_train_flops(n_params: int, tokens: int,
                          num_layers: int = 0, hidden_size: int = 0,
                          seq_len: int = 0, attention: bool = True) -> float:
    """FLOPs for one training step over `tokens` tokens (6ND + attention)."""
    flops = 6.0 * n_params * tokens
    if attention and num_layers and seq_len:
        # 12 * L * h * S per token (fwd+bwd of QK^T and AV)
        flops += 12.0 * num_layers * hidden_size * seq_len * tokens
    return flops


def causal_lm_infer_flops(n_params: int, tokens: int,
                          num_layers: int = 0, hidden_size: int = 0,
                          kv_len: int = 0, attention: bool = True) -> float:
    """FLOPs to decode `tokens` tokens (forward only): ~2 per parameter
    per token for the weight products, plus ~4 * L * h * kv_len per token
    for attention over `kv_len` cached positions (QK^T and AV, 2 each;
    GQA shrinks the cache read, not the query-side FLOPs, so
    `hidden_size` stays the full width). The serving cost table's
    analytic costs use it."""
    flops = 2.0 * n_params * tokens
    if attention and num_layers and kv_len:
        flops += 4.0 * num_layers * hidden_size * kv_len * tokens
    return flops


@dataclass
class StepTimer:
    """Per-step timing + throughput/MFU meter, with host-overhead breakdown.

    Usage::

        timer = StepTimer(flops_per_step=..., tokens_per_step=...)
        it = iter(loader)
        while True:
            with timer.input_stall():      # time blocked on the pipeline
                batch = next(it, None)
            if batch is None:
                break
            with timer.dispatch():         # host-side cost of the step call
                state, metrics = step(state, batch)
            timer.tick(state)          # blocks on `state` to time honestly
        print(timer.summary())

    The two context managers isolate the overheads the device never sees:
    `dispatch()` wraps the python `step(...)` call — on CUDA the call
    returns as soon as the step's kernels are enqueued, so its
    wall time IS the per-step host dispatch cost (pytree flatten, sharding
    checks, argument processing), and a cached dispatch path shows up as
    microsecond readings. On the CPU execution is synchronous
    inside the call, so the reading absorbs device compute and
    only upper-bounds the host share. `input_stall()` wraps the
    `next(loader)` call — nonzero readings mean the device finished before
    its next batch was ready (input-bound step). Both respect
    `warmup_steps`.

    Samples land in bounded-memory streaming histograms
    (`telemetry.StreamingHistogram`) rather than raw lists: means stay
    exact (tracked sum/count) for a run of ANY length, and `summary()`
    reports tail latency (`step_time_p50_s`/`step_time_p99_s`) from the
    sketch. Pass a `telemetry.MetricsRegistry` as `registry` to publish
    the series (`<name>_time_seconds`, `<name>_dispatch_seconds`,
    `<name>_input_stall_seconds`) through the shared export surface
    (Prometheus endpoint, JSONL snapshots, multi-host aggregation).
    """

    flops_per_step: float = 0.0
    tokens_per_step: int = 0
    warmup_steps: int = 2          # compile + first dispatch excluded
    peak_flops: float | None = None
    num_chips: int | None = None
    registry: Any = None           # telemetry.MetricsRegistry | None
    name: str = "step"             # series prefix when registry-backed
    _last: float | None = None
    _seen: int = 0
    _dispatch_seen: int = 0
    _stall_seen: int = 0
    # wall window spanning exactly the recorded (post-warmup) steps:
    # goodput = useful step-time / wall-time over this window
    _window_start: float | None = None
    _window_end: float | None = None
    # the very first tick: window_start - first_tick is the warmup
    # (compile + first dispatch) wall time, the "compile" taxonomy bucket
    _first_tick: float | None = None
    # stall taxonomy: seconds per overhead kind (tagged overhead()
    # windows) and per externally attributed cause (note_lost)
    _overhead_kinds: dict = field(default_factory=dict, repr=False)
    _attributed: dict = field(default_factory=dict, repr=False)
    _step_hist: StreamingHistogram = field(default=None, repr=False)  # type: ignore[assignment]
    _dispatch_hist: StreamingHistogram = field(default=None, repr=False)  # type: ignore[assignment]
    _stall_hist: StreamingHistogram = field(default=None, repr=False)  # type: ignore[assignment]
    _overhead_hist: StreamingHistogram = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        make = (self.registry.histogram if self.registry is not None
                else StreamingHistogram)
        if self._step_hist is None:
            self._step_hist = make(f"{self.name}_time_seconds")
        if self._dispatch_hist is None:
            self._dispatch_hist = make(f"{self.name}_dispatch_seconds")
        if self._stall_hist is None:
            self._stall_hist = make(f"{self.name}_input_stall_seconds")
        if self._overhead_hist is None:
            self._overhead_hist = make(f"{self.name}_overhead_seconds")

    def reset(self) -> None:
        """Zero the recorded samples (and warmup progress) in place. With
        a registry, the series OBJECTS are shared by name — a second timer
        with the same (registry, name) continues the same series unless
        reset; the exporter keeps serving the zeroed series either way."""
        for hist in (self._step_hist, self._dispatch_hist, self._stall_hist,
                     self._overhead_hist):
            hist.reset()
        self._last = None
        self._seen = self._dispatch_seen = self._stall_seen = 0
        self._window_start = self._window_end = None
        self._first_tick = None
        self._overhead_kinds.clear()
        self._attributed.clear()

    def tick(self, block_on: Any = None) -> float | None:
        """Record one step boundary; returns this step's seconds (or None
        during warmup). Pass the step's output (a state, a tree of tensors)
        so timing waits for the device to finish: when it holds a CUDA
        tensor, `torch.cuda.synchronize()`. A tick that did not wait would
        report the host's dispatch time as the step's."""
        if block_on is not None:
            _block_until_ready(block_on)
        now = time.perf_counter()
        if self._first_tick is None:
            self._first_tick = now
        elapsed = None
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup_steps:
                elapsed = now - self._last
                self._step_hist.record(elapsed)
                self._window_end = now
        if self._seen <= self.warmup_steps:
            # this tick starts the first post-warmup interval: the
            # goodput window opens here, so warmup/compile never counts
            # as lost wall time
            self._window_start = now
        self._last = now
        return elapsed

    @contextlib.contextmanager
    def dispatch(self) -> Iterator[None]:
        """Time the host-side dispatch of one step (wrap the `step(...)`
        call). The first `warmup_steps` readings are excluded (compile +
        first dispatch), mirroring `tick`."""
        t0 = time.perf_counter()
        yield
        self._dispatch_seen += 1
        if self._dispatch_seen > self.warmup_steps:
            self._dispatch_hist.record(time.perf_counter() - t0)

    @contextlib.contextmanager
    def input_stall(self) -> Iterator[None]:
        """Time spent blocked waiting on the input pipeline (wrap the
        `next(loader)` call)."""
        t0 = time.perf_counter()
        yield
        self._stall_seen += 1
        if self._stall_seen > self.warmup_steps:
            self._stall_hist.record(time.perf_counter() - t0)

    @contextlib.contextmanager
    def overhead(self, kind: str | None = None) -> Iterator[None]:
        """Mark non-step wall time the loop KNOWS about (a checkpoint
        save, an eval pass, a log flush) so `goodput` can subtract it.
        Tick-to-tick intervals tile the wall clock, so unmarked work
        between ticks is indistinguishable from step time — this marker
        is how a training loop makes its goodput honest::

            with timer.overhead("checkpoint_stage"):
                accelerator.save_state(path, async_save=True)

        `kind` tags the window for `stall_taxonomy()` ("checkpoint_stage",
        "checkpoint_drain", "eval", ...); untagged windows bucket under
        "other".
        """
        t0 = time.perf_counter()
        yield
        elapsed = time.perf_counter() - t0
        self._overhead_hist.record(elapsed)
        key = kind or "other"
        self._overhead_kinds[key] = self._overhead_kinds.get(key, 0.0) + elapsed

    def note_lost(self, kind: str, seconds: float) -> None:
        """Attribute externally-diagnosed lost time (e.g. the straggler
        monitor's slowest-host excess) into the taxonomy WITHOUT touching
        goodput: that time already sits inside measured step intervals —
        this labels its cause, it does not subtract it twice."""
        self._attributed[kind] = (
            self._attributed.get(kind, 0.0) + float(seconds))

    def stall_taxonomy(self) -> dict[str, float]:
        """Where the wall clock went, in seconds over the goodput window:
        `step` (useful), `input` (pipeline stalls), one entry per tagged
        overhead kind (`checkpoint_stage`, `checkpoint_drain`, `other`,
        ...), `compile` (warmup wall time BEFORE the window opened —
        attribution only, the goodput window already excludes it), plus
        externally attributed causes (`straggler`, via `note_lost`).
        Empty before any step records."""
        if not self._step_hist.count or self._window_start is None:
            return {}
        stall = self._stall_hist.sum if self._stall_hist.count else 0.0
        overhead = self._overhead_hist.sum if self._overhead_hist.count else 0.0
        out = {
            "step": max(0.0, self._step_hist.sum - stall - overhead),
            "input": stall,
        }
        for kind, sec in self._overhead_kinds.items():
            out[kind] = out.get(kind, 0.0) + sec
        if self._first_tick is not None \
                and self._window_start > self._first_tick:
            out["compile"] = self._window_start - self._first_tick
        for kind, sec in self._attributed.items():
            out[kind] = out.get(kind, 0.0) + sec
        return out

    @property
    def host_dispatch_us(self) -> float:
        """Mean host-dispatch microseconds per (post-warmup) step."""
        if not self._dispatch_hist.count:
            return float("nan")
        return 1e6 * self._dispatch_hist.mean

    @property
    def input_stall_us(self) -> float:
        """Mean microseconds per (post-warmup) step spent waiting on input."""
        if not self._stall_hist.count:
            return float("nan")
        return 1e6 * self._stall_hist.mean

    @property
    def steps_recorded(self) -> int:
        return self._step_hist.count

    @property
    def mean_step_time(self) -> float:
        if not self._step_hist.count:
            return float("nan")
        return self._step_hist.mean

    @property
    def steps_per_sec(self) -> float:
        mean = self.mean_step_time
        return 1.0 / mean if mean and mean == mean else float("nan")

    @property
    def tokens_per_sec(self) -> float:
        return self.steps_per_sec * self.tokens_per_step

    @property
    def goodput(self) -> float:
        """Useful step-time / wall-time over the recorded window, in
        [0, 1]. Tick-to-tick intervals TILE the window, so the only
        non-useful time this meter can subtract is what the loop
        measured: `input_stall()` readings and `overhead()` markers
        (checkpoint saves, eval passes). Unmarked between-tick work is
        counted as step time — wrap it in `overhead()` or the reading
        is an upper bound. NaN before any step records."""
        if (not self._step_hist.count or self._window_start is None
                or self._window_end is None):
            return float("nan")
        wall = self._window_end - self._window_start
        if wall <= 0:
            return float("nan")
        lost = (self._stall_hist.sum if self._stall_hist.count else 0.0) \
            + (self._overhead_hist.sum if self._overhead_hist.count else 0.0)
        useful = max(0.0, self._step_hist.sum - lost)
        return min(1.0, useful / wall)

    def mfu(self) -> float:
        """Model FLOPs utilization in [0,1] against chip peak * num_chips."""
        peak = self.peak_flops if self.peak_flops is not None else peak_flops_per_chip()
        chips = self.num_chips if self.num_chips is not None else _num_gpus()
        if not peak or not self.flops_per_step or not self._step_hist.count:
            return 0.0
        achieved = self.flops_per_step / self.mean_step_time
        return achieved / (peak * chips)

    def summary(self) -> dict[str, float]:
        out = {
            "steps_recorded": float(self.steps_recorded),
            "mean_step_time_s": self.mean_step_time,
            "steps_per_sec": self.steps_per_sec,
        }
        if self._step_hist.count:
            # tail latency, not just means: the sketch keeps p50/p99 at
            # bounded memory for a run of any length
            out["step_time_p50_s"] = self._step_hist.quantile(0.5)
            out["step_time_p99_s"] = self._step_hist.quantile(0.99)
            g = self.goodput
            if g == g:
                out["goodput"] = g
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_sec
            chips = self.num_chips if self.num_chips is not None else _num_gpus()
            out["tokens_per_sec_per_chip"] = self.tokens_per_sec / max(1, chips)
        if self.flops_per_step:
            out["mfu"] = self.mfu()
        if self._dispatch_hist.count:
            out["host_dispatch_us_mean"] = self.host_dispatch_us
        if self._stall_hist.count:
            out["input_stall_us_mean"] = self.input_stall_us
        return out
