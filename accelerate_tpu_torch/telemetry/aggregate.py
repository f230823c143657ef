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
reads it. `merged_registry` folds snapshots that arrived some other way
(a pod's worker heartbeats) into live series for one exposition.
"""

from __future__ import annotations

import math

from .registry import MetricsRegistry, StreamingHistogram, get_registry

__all__ = ["aggregate_snapshot", "merged_registry"]


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


def _parse_series_key(key: str) -> tuple[str, dict[str, str]]:
    """Inverse of registry._series_key for this codebase's label
    vocabulary (role/program/tenant names — no embedded commas or
    quotes): `name{k="v",k2="v2"}` -> (name, {k: v, k2: v2})."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        k, _, v = part.partition("=")
        labels[k] = v.strip('"')
    return name, labels


def merged_registry(snapshots: list[dict],
                    registry: MetricsRegistry | None = None,
                    **extra_labels) -> "MetricsRegistry":
    """Transport-backed merge: per-worker registry snapshots (as carried
    by pod heartbeats — plain JSON dicts, no process group) folded
    into a fresh `MetricsRegistry` the router can hand straight to the
    Prometheus renderer.

    The reduction semantics are `aggregate_snapshot`'s, re-materialized
    as live series: counters become the cross-worker SUM under their
    original name, gauges expand to `name__min/__mean/__max`, histogram
    sketches MERGE into one distribution per series (true global
    p50/p99) with the straggler signal exposed as
    `name__slowest_host_mean`. `extra_labels` (e.g. ``origin="workers"``)
    tag every merged series so a router can expose its own series and
    the worker aggregate in one scrape without collisions."""
    agg = aggregate_snapshot(snapshots=snapshots)
    reg = registry if registry is not None else MetricsRegistry()
    for key, red in agg["counters"].items():
        name, labels = _parse_series_key(key)
        total = red["sum"]
        if total == total and total >= 0:  # NaN-empty or clock-skew junk
            reg.counter(name, **{**labels, **extra_labels}).inc(total)
    for key, red in agg["gauges"].items():
        name, labels = _parse_series_key(key)
        for stat in ("min", "mean", "max"):
            if red[stat] == red[stat]:
                reg.gauge(f"{name}__{stat}",
                          **{**labels, **extra_labels}).set(red[stat])
    for key, entry in agg["histograms"].items():
        name, labels = _parse_series_key(key)
        hist = reg.histogram(name, **{**labels, **extra_labels})
        for snap in snapshots:
            e = _section(snap, "histograms").get(key)
            sketch = e.get("sketch") if isinstance(e, dict) else None
            if sketch is not None:
                try:
                    hist.merge(StreamingHistogram.from_dict(sketch))
                except (TypeError, KeyError, ValueError):
                    pass   # foreign sketch encoding: skip this host
        if "slowest_host_mean" in entry:
            reg.gauge(f"{name}__slowest_host_mean",
                      **{**labels, **extra_labels}).set(
                          entry["slowest_host_mean"])
    return reg
