"""Reduction of metrics snapshots across hosts — the straggler view
(port of `aggregate_snapshot` and its reducers in
`accelerate_tpu/telemetry/aggregate.py`).

The reference all-gathers every host's snapshot and reduces it:

- counters  -> global sum,
- gauges    -> min / mean / max / sum across hosts,
- histograms -> the serialized sketches MERGE, so the aggregate reports
  true global p50/p99 — and `slowest_host_mean` exposes the worst
  per-host mean (the straggler signal a merged distribution hides).

With no `snapshots` given, every process's registry snapshot is
all-gathered (`utils.operations.gather_object`: a collective, call it on
every process) and every process gets the aggregate; a world of one
aggregates its own registry (`snapshots=[local]`). `StragglerMonitor.poll`
reads it.
"""

from __future__ import annotations

import math

from .registry import MetricsRegistry, StreamingHistogram, get_registry

__all__ = ["aggregate_snapshot"]


def _section(snapshot, name: str) -> dict:
    """A snapshot section as a dict, whatever the peer sent. Snapshots
    cross process (and version) boundaries — a newer worker's schema may
    rename or reshape a section; aggregation must skip what it does not
    understand, never crash the scrape."""
    if not isinstance(snapshot, dict):
        return {}
    sec = snapshot.get(name)
    return sec if isinstance(sec, dict) else {}


def _reduce_scalar(values: list[float]) -> dict[str, float]:
    vals = [v for v in values
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and v == v]  # drop non-numeric (foreign schema) and NaN
    if not vals:
        return {"min": math.nan, "mean": math.nan, "max": math.nan,
                "sum": math.nan}
    return {
        "min": min(vals),
        "mean": sum(vals) / len(vals),
        "max": max(vals),
        "sum": sum(vals),
    }


def aggregate_snapshot(registry: MetricsRegistry | None = None,
                       snapshots: list[dict] | None = None) -> dict:
    """Reduce per-host snapshots: `snapshots` when given (offline use),
    else every process's registry, all-gathered (a collective).

    Returns::

        {"num_hosts": P,
         "counters": {key: {"sum": ..., "min": ..., "max": ...}},
         "gauges": {key: {"min": ..., "mean": ..., "max": ...}},
         "histograms": {key: {count, sum, mean, p50, p90, p99,
                              "slowest_host_mean": ...}}}
    """
    if snapshots is None:
        from ..utils.operations import gather_object

        snapshots = gather_object((registry or get_registry()).snapshot(
            include_sketch=True))
    out: dict = {"num_hosts": len(snapshots), "counters": {}, "gauges": {},
                 "histograms": {}}

    keys = {k for s in snapshots for k in _section(s, "counters")}
    for key in sorted(keys):
        vals = [_section(s, "counters")[key] for s in snapshots
                if key in _section(s, "counters")]
        red = _reduce_scalar(vals)
        out["counters"][key] = {"sum": red["sum"], "min": red["min"],
                                "max": red["max"]}

    keys = {k for s in snapshots for k in _section(s, "gauges")}
    for key in sorted(keys):
        vals = [_section(s, "gauges")[key] for s in snapshots
                if key in _section(s, "gauges")]
        red = _reduce_scalar(vals)
        out["gauges"][key] = {"min": red["min"], "mean": red["mean"],
                              "max": red["max"], "sum": red["sum"]}

    keys = {k for s in snapshots for k in _section(s, "histograms")}
    for key in sorted(keys):
        entries = [_section(s, "histograms")[key] for s in snapshots
                   if key in _section(s, "histograms")]
        entries = [e for e in entries if isinstance(e, dict)]
        merged: StreamingHistogram | None = None
        per_host_means = []
        for e in entries:
            count = e.get("count")
            # an older peer's entry may lack "sum" entirely: no mean
            # contribution from it, but its sketch still merges
            if (isinstance(count, (int, float)) and count
                    and isinstance(e.get("sum"), (int, float))):
                per_host_means.append(e["sum"] / count)
            sketch = e.get("sketch")
            if sketch is not None:
                try:
                    h = StreamingHistogram.from_dict(sketch)
                except (TypeError, KeyError, ValueError):
                    continue   # foreign sketch encoding: skip this host
                if merged is None:
                    merged = h
                else:
                    merged.merge(h)
        entry: dict = {}
        if merged is not None and merged.count:
            entry = {
                "count": float(merged.count),
                "sum": merged.sum,
                "mean": merged.mean,
                "min": merged.min,
                "max": merged.max,
                "p50": merged.quantile(0.5),
                "p90": merged.quantile(0.9),
                "p99": merged.quantile(0.99),
            }
        else:  # sketchless snapshots still reduce their scalar stats
            entry = {
                "count": sum(e.get("count", 0.0) for e in entries
                             if isinstance(e.get("count", 0.0), (int, float))),
                "sum": sum(e.get("sum", 0.0) for e in entries
                           if isinstance(e.get("sum", 0.0), (int, float))),
            }
            if entry["count"]:
                entry["mean"] = entry["sum"] / entry["count"]
        if per_host_means:
            # the straggler signal: the worst single host's mean (a merged
            # global distribution averages it away)
            entry["slowest_host_mean"] = max(per_host_means)
        out["histograms"][key] = entry
    return out
