"""Straggler closed loop: act on the `__slowest_host_mean` signal.

`aggregate.aggregate_snapshot` exposes the straggler VIEW — every
histogram's worst per-host mean, the number a merged global
distribution averages away. This module closes the loop:
:class:`StragglerMonitor` watches the ratio of `slowest_host_mean`
to the fleet mean for one histogram (the step-time series by default)
and, when a host stays slow past a patience window, escalates instead of
just observing:

- writes a ``straggler`` incident bundle (the stall watchdog's format
  and location) when an ``incident_dir`` is given,
- attributes the excess seconds into the caller's `StepTimer` taxonomy
  (``note_lost("straggler", ...)``) when a timer is wired,
- invokes ``on_straggler(report)`` — the hook a pod deployment points at
  its elastic-restart path (`serving.pod` rebalance, a scheduler call, a
  `run_resilient` drain request).

A transient blip (one slow GC, one checkpoint landing on one host) resets
the strike counter; only a PERSISTENT straggler past `ratio_threshold`
for `patience` consecutive observations fires, and it fires once per
episode (the ratio must recover below threshold to re-arm).

A copy of `accelerate_tpu/telemetry/straggler.py`; the port reads no
environment variable for the incident directory, so without
`incident_dir` a report's `bundle_path` is None.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .registry import MetricsRegistry, get_registry

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    """Watch one histogram's slowest-host mean vs the fleet mean and
    escalate persistent stragglers. Call :meth:`observe` with
    `aggregate_snapshot()` output at log boundaries (or :meth:`poll` to
    snapshot a local registry — single-host form, useful in tests and in
    `run_resilient`)."""

    def __init__(
        self,
        histogram: str = "step_time_seconds",
        *,
        ratio_threshold: float = 1.5,
        patience: int = 3,
        registry: MetricsRegistry | None = None,
        incident_dir: str | None = None,
        on_straggler: Callable[[dict], Any] | None = None,
        timer: Any = None,
    ):
        if ratio_threshold <= 1.0:
            raise ValueError("ratio_threshold must be > 1.0 "
                             f"(got {ratio_threshold})")
        self.histogram = histogram
        self.ratio_threshold = float(ratio_threshold)
        self.patience = max(1, int(patience))
        self.incident_dir = incident_dir
        self.on_straggler = on_straggler
        self.timer = timer
        self._registry = registry
        self._strikes = 0
        self._fired = False
        self.incidents: list[dict] = []

    def _reg(self) -> MetricsRegistry:
        if self._registry is None:
            self._registry = get_registry()
        return self._registry

    def poll(self) -> dict | None:
        """Single-process convenience: observe this process's own
        registry as a one-host aggregate. The ratio is 1.0 by
        construction on one host — this keeps the loop wired (and the
        gauge exported) so multi-host deployments only swap the input."""
        from .aggregate import aggregate_snapshot

        snap = self._reg().snapshot(include_sketch=True)
        return self.observe(aggregate_snapshot(snapshots=[snap]))

    def observe(self, aggregate: dict) -> dict | None:
        """Feed one `aggregate_snapshot()` result. Returns the incident
        report when this observation fires the closed loop, else None."""
        hists = aggregate.get("histograms") if isinstance(aggregate, dict) \
            else None
        entry = hists.get(self.histogram) if isinstance(hists, dict) else None
        if not isinstance(entry, dict):
            return None
        slowest = entry.get("slowest_host_mean")
        mean = entry.get("mean")
        count = entry.get("count") or 0.0
        if not isinstance(slowest, (int, float)) \
                or not isinstance(mean, (int, float)) or mean <= 0:
            return None
        ratio = float(slowest) / float(mean)
        self._reg().gauge("straggler_ratio",
                          histogram=self.histogram).set(ratio)
        if ratio < self.ratio_threshold:
            self._strikes = 0
            self._fired = False     # episode over: re-arm
            return None
        self._strikes += 1
        if self._strikes < self.patience or self._fired:
            return None
        self._fired = True
        # excess wall time the slowest host cost the fleet over the
        # observed window: (slowest mean - fleet mean) per recorded step
        lost_seconds = max(0.0, (float(slowest) - float(mean)) * count
                           / max(1, aggregate.get("num_hosts", 1)))
        report = {
            "kind": "straggler",
            "watchdog": "straggler-monitor",
            "histogram": self.histogram,
            "ratio": ratio,
            "ratio_threshold": self.ratio_threshold,
            "patience": self.patience,
            "slowest_host_mean": float(slowest),
            "fleet_mean": float(mean),
            "num_hosts": aggregate.get("num_hosts"),
            "lost_seconds_estimate": lost_seconds,
            "observed_at": time.time(),
        }
        self._reg().counter("straggler_incidents_total").inc()
        if self.timer is not None and lost_seconds > 0:
            # label the cause inside the goodput window; the seconds are
            # already counted as step time, so goodput is untouched
            self.timer.note_lost("straggler", lost_seconds)
        report["bundle_path"] = self._write_bundle(report)
        self.incidents.append(report)
        if self.on_straggler is not None:
            # the elastic-restart hook: a pod deployment points this at
            # its rebalance/relaunch path; run_resilient's drain request
            # is the single-job form
            self.on_straggler(report)
        return report

    def _write_bundle(self, report: dict) -> str | None:
        from .watchdog import resolve_incident_dir, write_incident_bundle

        base = resolve_incident_dir(self.incident_dir)
        if base is None:
            return None
        try:
            return write_incident_bundle(base, dict(report),
                                         registry=self._registry,
                                         name="straggler")
        except Exception:
            return None     # escalation must never crash the train loop
