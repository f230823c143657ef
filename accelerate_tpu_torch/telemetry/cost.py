"""Per-program device cost: static FLOPs and bytes, sampled device time,
rooflines and goodput (port of `accelerate_tpu/telemetry/cost.py`).

- a **static cost table**: FLOPs and bytes accessed per call of each
  program. The reference reads them from XLA's `cost_analysis()` of the
  lowered program; the port has no lowering, so every cost it registers
  is explicit or analytic (the serving engine's `_analytic_cost`, the
  train step's `_train_step_cost`). `extract_cost_analysis` keeps the
  reference's dict shapes so a caller holding such a dict can still
  register it. Entries export as registry gauges
  (`program_flops{program=...}` and the rest).
- **sampled device time**: every Kth call of a program pays a fence pair
  (`torch.cuda.synchronize` of the devices its tensors live on) around
  the call, and the wall time between the fences lands in the
  `program_device_time_seconds{program=...}` streaming histogram. Other
  calls pay one integer increment. The fences sit outside the programs,
  so a captured CUDA graph never sees them; a graph replay costs
  microseconds of host time, so the reading is the device's.
- **rooflines**: cost x measured time -> MFU, HBM-bandwidth utilization,
  arithmetic intensity and `mxu_idle_fraction` (1 - MFU). The series keep
  the reference's names so scrapes and incident bundles read the same;
  on the card "mxu" is the tensor cores.

Peaks come from `utils.constants.GPU_PEAKS` by the device's name; any
other device (the CPU, a GPU part the table lacks) gets the reference's
nominal placeholders and `peaks_nominal=True`: the numbers flow, but
they are not a hardware claim.

The port reads none of the reference's environment variables:
`resolve_sample_every(None)` is the reference's default of 16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable

from .registry import MetricsRegistry, StreamingHistogram

__all__ = [
    "ProgramCost",
    "CostTable",
    "device_peaks",
    "extract_cost_analysis",
    "fence",
    "resolve_sample_every",
    "NOMINAL_PEAK_FLOPS",
    "NOMINAL_PEAK_HBM_BYTES",
]

# the reference's placeholders for a device without a spec entry:
# roofline numbers stay non-null and comparable run over run, and
# `peaks_nominal` marks them as such
NOMINAL_PEAK_FLOPS = 1e12
NOMINAL_PEAK_HBM_BYTES = 100e9


def resolve_sample_every(explicit: int | None = None,
                         default: int = 16) -> int:
    """Sampling cadence: the explicit value, else the default. 0 turns
    device-time sampling off (static costs are still registered)."""
    if explicit is not None:
        return int(explicit)
    return default


def device_peaks(device=None) -> tuple[float, float, bool]:
    """(peak FLOP/s, peak bytes/s, nominal) for `device` (the current
    CUDA device when None): the GPU part's data-sheet peaks, or the
    nominal placeholders with nominal=True for a CPU device, no GPU, or
    a part the table lacks."""
    import torch

    from ..utils.constants import gpu_peaks

    if device is not None and torch.device(device).type != "cuda":
        return NOMINAL_PEAK_FLOPS, NOMINAL_PEAK_HBM_BYTES, True
    if not torch.cuda.is_available():
        return NOMINAL_PEAK_FLOPS, NOMINAL_PEAK_HBM_BYTES, True
    peaks = gpu_peaks(torch.cuda.get_device_name(device))
    if peaks is None:
        return NOMINAL_PEAK_FLOPS, NOMINAL_PEAK_HBM_BYTES, True
    return peaks[0], peaks[1], False


def fence(tree: Any) -> None:
    """Wait until the work queued on every CUDA device that holds a
    tensor of `tree` is done (the sampling fence). A tree without a CUDA
    tensor is a no-op: on the CPU an op has finished when its call
    returns. A CUDA error raises: a sample never hides the device."""
    from ..profiler import _block_until_ready

    _block_until_ready(tree)


def extract_cost_analysis(obj: Any) -> tuple[float, float] | None:
    """(flops, bytes_accessed) from an object with a `cost_analysis()`
    method, or the dict (or list of dicts) such a method returns. None
    when nothing usable is there; callers then fall back to an analytic
    estimate."""
    ca = obj
    if hasattr(obj, "cost_analysis"):
        try:
            ca = obj.cost_analysis()
        except Exception:
            return None
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not isinstance(ca, dict):
        return None
    try:
        flops = float(ca.get("flops") or 0.0)
        nbytes = float(ca.get("bytes accessed") or 0.0)
    except (TypeError, ValueError):
        return None
    if flops <= 0.0 and nbytes <= 0.0:
        return None
    return flops, nbytes


@dataclasses.dataclass
class ProgramCost:
    """Static per-program cost: FLOPs and bytes accessed per call.
    `source` records where the numbers came from ("explicit",
    "cost_analysis" or "analytic")."""

    name: str
    flops: float
    bytes_accessed: float
    source: str = "cost_analysis"

    @property
    def arith_intensity(self) -> float:
        """FLOPs per byte accessed: which side of the roofline the
        program sits on."""
        if self.bytes_accessed <= 0:
            return math.nan
        return self.flops / self.bytes_accessed


class CostTable:
    """Static program costs, sampled device-time sketches and rooflines.

    One table per engine (on the engine's registry) or per Accelerator
    (on the process registry). Every series is labelled
    `{program="<name>"}`:

    - gauges `program_flops` / `program_bytes_accessed` /
      `program_arith_intensity` (static, set at registration),
    - histogram `program_device_time_seconds` (sampled),
    - gauges `program_mfu` / `program_hbm_bw_util` /
      `program_mxu_idle_fraction` (refreshed per sample).

    Cadence, per program: call 1 is never sampled (on the card it is the
    warm-up and the CUDA-graph capture, or the kernels' first build);
    call 2 and every `sample_every`-th call after are.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 sample_every: int = 16,
                 peaks: tuple[float, float, bool] | None = None,
                 num_chips: int | Callable[[], int] | None = None,
                 clock: Callable[[], float] | None = None):
        self.registry = registry or MetricsRegistry()
        self.sample_every = max(0, int(sample_every))
        self._peaks = peaks
        # the utilization denominator is peak x num_chips; None = 1, a
        # callable resolves at first use
        self._num_chips = num_chips
        self._lock = threading.Lock()
        self._entries: dict[str, ProgramCost] = {}
        self._calls: dict[str, int] = {}
        if clock is None:
            import time

            clock = time.perf_counter
        self.clock = clock

    # -- static costs --------------------------------------------------------

    @property
    def entries(self) -> dict[str, ProgramCost]:
        return dict(self._entries)

    def has(self, name: str) -> bool:
        return name in self._entries

    @property
    def peaks(self) -> tuple[float, float, bool]:
        if self._peaks is None:
            self._peaks = device_peaks()
        return self._peaks

    @property
    def num_chips(self) -> int:
        if callable(self._num_chips):
            self._num_chips = max(1, int(self._num_chips()))
        return self._num_chips or 1

    def register(self, name: str, cost_source: Any = None, *,
                 flops: float | None = None,
                 bytes_accessed: float | None = None,
                 fallback: Callable[[], tuple[float, float]] | None = None,
                 replace: bool = False) -> ProgramCost | None:
        """Record one program's static cost. Resolution order: explicit
        flops/bytes, then `cost_source` (see `extract_cost_analysis`),
        then the zero-argument `fallback` returning an analytic (flops,
        bytes). Registering a known name again is a no-op unless
        `replace=True`. Returns the entry, or None when nothing
        resolved."""
        if not replace and name in self._entries:
            return self._entries[name]
        source = "explicit"
        resolved: tuple[float, float] | None = None
        if flops is not None or bytes_accessed is not None:
            resolved = (float(flops or 0.0), float(bytes_accessed or 0.0))
        if resolved is None and cost_source is not None:
            resolved = extract_cost_analysis(cost_source)
            source = "cost_analysis"
        if resolved is None and fallback is not None:
            try:
                fb = fallback()
            except Exception:
                fb = None
            if fb is not None:
                resolved = (float(fb[0]), float(fb[1]))
                source = "analytic"
        if resolved is None:
            return None
        entry = ProgramCost(name, resolved[0], resolved[1], source)
        with self._lock:
            self._entries[name] = entry
        self._publish_entry(entry)
        return entry

    def _publish_entry(self, entry: ProgramCost) -> None:
        r = self.registry
        r.gauge("program_flops", program=entry.name).set(entry.flops)
        r.gauge("program_bytes_accessed",
                program=entry.name).set(entry.bytes_accessed)
        ai = entry.arith_intensity
        if ai == ai:
            r.gauge("program_arith_intensity", program=entry.name).set(ai)

    def republish(self) -> None:
        """Set the static gauges again after a registry reset (a reset
        zeroes series in place; a program's cost did not change)."""
        for entry in list(self._entries.values()):
            self._publish_entry(entry)

    # -- sampled device time -------------------------------------------------

    def sample_due(self, name: str) -> bool:
        """Count one call of `name`; True when this call is to be timed
        (call 2, then every `sample_every`-th call)."""
        if self.sample_every <= 0:
            return False
        with self._lock:
            n = self._calls.get(name, 0) + 1
            self._calls[name] = n
        if n < 2:
            return False
        return (n - 2) % self.sample_every == 0

    def calls(self, name: str) -> int:
        return self._calls.get(name, 0)

    @contextlib.contextmanager
    def maybe_sample(self, name: str, fence_in: Any = None):
        """Fence-pair timing of one call when a sample is due::

            with table.maybe_sample("decode", fence_in=cache) as sample:
                out = program()
                sample(out)   # a no-op when this call is not sampled

        Entering waits for `fence_in` (earlier work must not fall into
        this program's window); calling the yielded function waits for
        the outputs and records the time. The window includes the host's
        launch of the one call."""
        if not self.sample_due(name):
            yield lambda out: None
            return
        if fence_in is not None:
            fence(fence_in)
        t0 = self.clock()
        done = {"recorded": False}

        def sample(out: Any) -> None:
            if done["recorded"]:
                return
            done["recorded"] = True
            fence(out)
            self.record_device_time(name, self.clock() - t0)

        yield sample

    def device_time(self, name: str) -> StreamingHistogram:
        return self.registry.histogram("program_device_time_seconds",
                                       program=name)

    def mean_device_time(self, name: str) -> float | None:
        hist = self.device_time(name)
        if not hist.count:
            return None
        return hist.mean

    def record_device_time(self, name: str, seconds: float) -> None:
        """One measured duration; refreshes the derived gauges from this
        sample (`roofline()` uses the running mean instead)."""
        seconds = float(seconds)
        self.device_time(name).record(seconds)
        entry = self._entries.get(name)
        if entry is None or seconds <= 0:
            return
        peak_f, peak_b, _nominal = self.peaks
        chips = self.num_chips
        r = self.registry
        mfu = entry.flops / seconds / (peak_f * chips)
        r.gauge("program_mfu", program=name).set(mfu)
        r.gauge("program_mxu_idle_fraction",
                program=name).set(min(1.0, max(0.0, 1.0 - mfu)))
        r.gauge("program_hbm_bw_util", program=name).set(
            entry.bytes_accessed / seconds / (peak_b * chips))

    # -- rooflines -----------------------------------------------------------

    def roofline(self, name: str) -> dict[str, float] | None:
        """The program's sheet: static costs, measured device time
        (mean/p50/p99 over the samples) and the derived MFU, HBM
        bandwidth utilization and idle fraction against the peaks. None
        when nothing is known about `name`."""
        entry = self._entries.get(name)
        hist = self.device_time(name)
        if entry is None and not hist.count:
            return None
        out: dict[str, float] = {}
        if entry is not None:
            out["flops"] = entry.flops
            out["bytes_accessed"] = entry.bytes_accessed
            ai = entry.arith_intensity
            if ai == ai:
                out["arith_intensity"] = ai
            out["cost_source"] = entry.source  # type: ignore[assignment]
        if hist.count:
            mean = hist.mean
            out["device_time_mean_s"] = mean
            out["device_time_p50_s"] = hist.quantile(0.5)
            out["device_time_p99_s"] = hist.quantile(0.99)
            out["device_time_samples"] = float(hist.count)
            if entry is not None and mean > 0:
                peak_f, peak_b, nominal = self.peaks
                chips = self.num_chips
                mfu = entry.flops / mean / (peak_f * chips)
                out["mfu"] = mfu
                out["mxu_idle_fraction"] = min(1.0, max(0.0, 1.0 - mfu))
                out["hbm_bw_util"] = (
                    entry.bytes_accessed / mean / (peak_b * chips))
                out["peaks_nominal"] = float(nominal)
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        """name -> roofline() for every known program."""
        names = set(self._entries) | set(self._calls)
        out = {}
        for name in sorted(names):
            sheet = self.roofline(name)
            if sheet:
                out[name] = sheet
        return out

    def snapshot(self) -> dict:
        """JSON-safe dump for incident bundles: the static table, per
        program call counts, and the rooflines at the incident."""
        peaks: dict[str, Any] = {}
        if self._peaks is not None:  # never probe a device here
            peaks = {"peak_flops": self._peaks[0],
                     "peak_hbm_bytes_per_s": self._peaks[1],
                     "nominal": self._peaks[2]}
            if isinstance(self._num_chips, int):
                peaks["num_chips"] = self._num_chips
        return {
            "sample_every": self.sample_every,
            "peaks": peaks,
            "programs": {
                name: dict(dataclasses.asdict(entry),
                           calls=self._calls.get(name, 0))
                for name, entry in sorted(self._entries.items())
            },
            "rooflines": self.summary(),
        }
