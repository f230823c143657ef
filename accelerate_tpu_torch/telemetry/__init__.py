"""Telemetry of the port: the metrics registry, host-span request
tracing with its flight recorder, the Prometheus exposition, the
one-host snapshot aggregate and the straggler monitor."""

from .aggregate import aggregate_snapshot
from .export import negotiate_exposition, render_prometheus
from .registry import MetricsRegistry, get_registry
from .straggler import StragglerMonitor
from .trace import (
    clear_flight_recorder,
    configure_tracing,
    drain_spans,
    export_chrome_trace,
    flight_recorder,
    format_traceparent,
    head_sample,
    ingest_spans,
    new_trace_id,
    parse_traceparent,
    record_span,
    span,
    trace_events,
    tracing_enabled,
)

__all__ = [
    "aggregate_snapshot",
    "StragglerMonitor",
    "MetricsRegistry",
    "get_registry",
    "render_prometheus",
    "negotiate_exposition",
    "span",
    "record_span",
    "configure_tracing",
    "tracing_enabled",
    "head_sample",
    "new_trace_id",
    "parse_traceparent",
    "format_traceparent",
    "flight_recorder",
    "trace_events",
    "clear_flight_recorder",
    "export_chrome_trace",
    "drain_spans",
    "ingest_spans",
]
