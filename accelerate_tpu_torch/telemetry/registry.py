"""Process-wide metrics registry: counters, gauges, streaming histograms.

A copy of `accelerate_tpu/telemetry/registry.py` (which imports no jax,
but importing it runs the JAX package's `__init__`). The one change: the
registry's own lock is a plain `threading.Lock` — the lock-order
sanitizer hook arrives with the telemetry slice of the port.

The registry is the one place a metric lives: named series with optional
labels, get-or-create semantics so instrumentation sites and exporters
meet on the same objects, and an atomic `snapshot()` every exporter
renders from.

Histograms are *streaming*: a DDSketch-style log-bucketed quantile sketch
with bounded memory — p50/p90/p99 within a fixed relative accuracy without
keeping O(steps) raw samples, exact count/sum/min/max (so means stay
exact), and mergeable across hosts for the global straggler view.

No jax imports here — the registry must be importable (and testable)
without touching any accelerator backend.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Iterator

__all__ = [
    "Counter",
    "Gauge",
    "StreamingHistogram",
    "MetricsRegistry",
    "get_registry",
    "flatten_snapshot",
]


def _series_key(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing value (requests served, tokens emitted)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-set value (queue depth, slot occupancy, HBM in use)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self._value = float(v)

    def set_max(self, v: float) -> None:
        """High-water update (e.g. peak HBM): keeps the max ever set."""
        v = float(v)
        with self._lock:
            if v > self._value:
                self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


class StreamingHistogram:
    """Bounded-memory quantile sketch (DDSketch-style log buckets).

    Values map to geometric buckets `gamma^i` with
    `gamma = (1 + a) / (1 - a)`; reporting a bucket's midpoint guarantees
    every quantile is within relative error `a` of the true order
    statistic. count/sum/min/max are tracked exactly, so `mean` is exact
    regardless of sketch accuracy. When the bucket table outgrows
    `max_buckets`, the LOWEST buckets collapse together — tail quantiles
    (the ones that matter for latency) keep full accuracy.

    Mergeable (`merge`) and serializable (`to_dict`/`from_dict`) so
    per-host sketches can be combined into a global distribution.

    Exemplars: `record(value, exemplar="<trace-id>")` keeps the
    most recent exemplar PER LOG BUCKET (bounded by `_MAX_EXEMPLARS`,
    highest buckets kept — the tail is where an exemplar earns its keep:
    a bad p99 bucket links straight to the trace that landed in it). The
    OpenMetrics exposition renders them on `_bucket` lines.
    """

    _MAX_EXEMPLARS = 64

    __slots__ = ("name", "labels", "relative_accuracy", "max_buckets",
                 "_gamma_ln", "_buckets", "_zero_count", "_count", "_sum",
                 "_min", "_max", "_lock", "_exemplars")

    def __init__(self, name: str = "", labels: tuple = (),
                 relative_accuracy: float = 0.01, max_buckets: int = 2048):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1)")
        self.name = name
        self.labels = labels
        self.relative_accuracy = relative_accuracy
        self.max_buckets = max_buckets
        gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._gamma_ln = math.log(gamma)
        self._buckets: dict[int, int] = {}
        self._zero_count = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()
        self._exemplars: dict[int, tuple[float, str, float]] = {}

    # -- recording -----------------------------------------------------------

    def record(self, value: float, exemplar: str | None = None) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if value <= 0.0:
                # durations/sizes are nonnegative; the rare negative (clock
                # skew) folds into the zero bucket rather than poisoning the
                # log-bucket math
                self._zero_count += 1
                return
            idx = math.ceil(math.log(value) / self._gamma_ln)
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            if exemplar is not None:
                self._exemplars[idx] = (value, str(exemplar), time.time())
                if len(self._exemplars) > self._MAX_EXEMPLARS:
                    # keep the TAIL: low buckets are the boring fast ones
                    del self._exemplars[min(self._exemplars)]
            if len(self._buckets) > self.max_buckets:
                self._collapse_lowest()

    def _collapse_lowest(self) -> None:
        keys = sorted(self._buckets)
        lo, nxt = keys[0], keys[1]
        self._buckets[nxt] += self._buckets.pop(lo)
        # an exemplar must stay <= its bucket's upper bound: a collapsed
        # bucket's exemplar would violate that in the wider bucket — drop
        self._exemplars.pop(lo, None)

    # -- stats ---------------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else math.nan

    @property
    def max(self) -> float:
        return self._max if self._count else math.nan

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def _bucket_value(self, idx: int) -> float:
        # midpoint of (gamma^(i-1), gamma^i] — the DDSketch estimator with
        # relative error <= relative_accuracy
        gamma = math.exp(self._gamma_ln)
        return 2.0 * math.exp(idx * self._gamma_ln) / (gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]); NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return math.nan
            # nearest-rank: the smallest bucket whose cumulative count
            # reaches ceil(q * n) — never *under*-reports a tail quantile
            rank = max(1, math.ceil(q * self._count))
            seen = self._zero_count
            if seen >= rank:
                return 0.0 if self._min >= 0.0 else self._min
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if seen >= rank:
                    # clamp into the exactly-tracked range so p0/p100 are
                    # exact and sketch edges never overshoot the data
                    return min(max(self._bucket_value(idx), self._min),
                               self._max)
            return self._max

    def bucket_upper_bound(self, idx: int) -> float:
        """Upper bound (`le`) of log bucket `idx` — gamma^idx."""
        return math.exp(idx * self._gamma_ln)

    def bucket_counts(self) -> list[tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, Prometheus-histogram
        shaped: ascending `le`, counts cumulative, zero/negative samples
        folded into a leading `le=0` bucket. The +Inf bucket is implied
        (== count)."""
        with self._lock:
            buckets = sorted(self._buckets.items())
            zero = self._zero_count
        out: list[tuple[float, int]] = []
        seen = zero
        if zero:
            out.append((0.0, zero))
        for idx, n in buckets:
            seen += n
            out.append((self.bucket_upper_bound(idx), seen))
        return out

    def exemplars(self) -> dict[int, tuple[float, str, float]]:
        """bucket idx -> (value, exemplar label, unix ts), newest per
        bucket."""
        with self._lock:
            return dict(self._exemplars)

    def summary(self, quantiles: tuple[float, ...] = (0.5, 0.9, 0.99)) -> dict:
        out = {"count": float(self._count), "sum": self._sum}
        if self._count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.mean
            for q in quantiles:
                out[f"p{int(q * 100)}"] = self.quantile(q)
        return out

    # -- merge / transport ---------------------------------------------------

    def merge(self, other: "StreamingHistogram") -> None:
        """Fold another sketch into this one (same relative accuracy)."""
        if abs(other.relative_accuracy - self.relative_accuracy) > 1e-12:
            raise ValueError("cannot merge sketches of different accuracy")
        # snapshot the source under ITS lock first (a live sketch may be
        # recording concurrently); locks are never held together, so two
        # threads cross-merging cannot deadlock
        with other._lock:
            o_count, o_sum = other._count, other._sum
            o_zero, o_min, o_max = other._zero_count, other._min, other._max
            o_buckets = dict(other._buckets)
        with self._lock:
            self._count += o_count
            self._sum += o_sum
            self._zero_count += o_zero
            self._min = min(self._min, o_min)
            self._max = max(self._max, o_max)
            for idx, n in o_buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + n
            while len(self._buckets) > self.max_buckets:
                self._collapse_lowest()

    def to_dict(self) -> dict:
        return {
            "relative_accuracy": self.relative_accuracy,
            "count": self._count,
            "sum": self._sum,
            "zero_count": self._zero_count,
            "min": self._min if self._count else None,
            "max": self._max if self._count else None,
            "buckets": {str(k): v for k, v in self._buckets.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StreamingHistogram":
        h = cls(relative_accuracy=d["relative_accuracy"])
        h._count = int(d["count"])
        h._sum = float(d["sum"])
        h._zero_count = int(d["zero_count"])
        h._min = math.inf if d["min"] is None else float(d["min"])
        h._max = -math.inf if d["max"] is None else float(d["max"])
        h._buckets = {int(k): int(v) for k, v in d["buckets"].items()}
        return h

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._exemplars.clear()
            self._zero_count = 0
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf


class MetricsRegistry:
    """Named metric series with get-or-create semantics and an atomic
    snapshot. Instrumentation sites call `counter/gauge/histogram` freely —
    the same (name, labels) always resolves to the same object, so hot
    paths can also cache the returned metric and skip the lookup."""

    def __init__(self):
        # taken only on series creation (_get_or_create's fast path is
        # lock-free), so it stays off the metrics hot path
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, str, tuple], Any] = {}

    @staticmethod
    def _labels_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _get_or_create(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, self._labels_key(labels))
        metric = self._metrics.get(key)
        if metric is None:
            with self._lock:
                metric = self._metrics.get(key)
                if metric is None:
                    metric = factory(name, key[2])
                    self._metrics[key] = metric
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create("gauge", name, labels, Gauge)

    def histogram(self, name: str, relative_accuracy: float = 0.01,
                  **labels) -> StreamingHistogram:
        return self._get_or_create(
            "histogram", name, labels,
            lambda n, lk: StreamingHistogram(
                n, lk, relative_accuracy=relative_accuracy),
        )

    def items(self) -> Iterator[tuple[str, str, tuple, Any]]:
        """(kind, name, labels, metric) for every registered series."""
        with self._lock:
            entries = list(self._metrics.items())
        for (kind, name, labels), metric in entries:
            yield kind, name, labels, metric

    def snapshot(self, include_sketch: bool = False) -> dict:
        """Point-in-time view of every series::

            {"counters": {key: value},
             "gauges": {key: value},
             "histograms": {key: {count, sum, min, max, mean, p50, p90,
                                  p99[, sketch]}}}

        `include_sketch=True` embeds the serialized bucket sketch per
        histogram so snapshots can be merged across hosts
        (telemetry.aggregate)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for kind, name, labels, metric in self.items():
            key = _series_key(name, labels)
            if kind == "counter":
                out["counters"][key] = metric.value
            elif kind == "gauge":
                out["gauges"][key] = metric.value
            else:
                entry = metric.summary()
                if include_sketch:
                    entry["sketch"] = metric.to_dict()
                out["histograms"][key] = entry
        return out

    def reset(self) -> None:
        """Zero every series in place (objects stay registered, so cached
        references and the HTTP exporter keep working)."""
        for _, _, _, metric in self.items():
            metric.reset()


def flatten_snapshot(snapshot: dict, prefix: str = "") -> dict[str, float]:
    """Flatten a snapshot into the flat str -> float dict the tracking
    layer logs (`GeneralTracker.log`): histograms expand to
    `<key>_count/_mean/_p50/_p99`."""
    flat: dict[str, float] = {}
    for key, v in snapshot.get("counters", {}).items():
        flat[prefix + key] = v
    for key, v in snapshot.get("gauges", {}).items():
        flat[prefix + key] = v
    for key, entry in snapshot.get("histograms", {}).items():
        for stat in ("count", "mean", "p50", "p90", "p99"):
            if stat in entry:
                flat[f"{prefix}{key}_{stat}"] = entry[stat]
    return flat


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (training-side instrumentation
    and the Accelerator exporter share it; serving engines keep their own
    per-engine registry so concurrent engines don't collide)."""
    return _default_registry
