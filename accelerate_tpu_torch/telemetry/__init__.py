"""Telemetry of the port: the metrics registry, host-span request
tracing with its flight recorder, the Prometheus exposition and its
exporter thread, the one-host snapshot aggregate, the straggler monitor,
the device-cost table (rooflines and goodput), the stall watchdog with
its incident bundles, and lockwatch.

Nothing here starts a thread or binds a port unless asked, and nothing
reads the reference's environment variables."""

from .aggregate import aggregate_snapshot
from .cost import (
    CostTable,
    ProgramCost,
    device_peaks,
    extract_cost_analysis,
    resolve_sample_every,
)
from .export import (
    MetricsServer,
    negotiate_exposition,
    render_prometheus,
    resolve_metrics_port,
    snapshot_for_tracking,
    start_metrics_server,
    write_snapshot,
)
from .lockwatch import (
    LockOrderViolation,
    TrackedLock,
    lockwatch_enabled,
    lockwatch_state,
    maybe_tracked,
    reset_lockwatch,
)
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
from .watchdog import (
    StallError,
    StallWatchdog,
    build_exception_report,
    list_incident_bundles,
    load_incident_bundle,
    resolve_incident_dir,
    resolve_stall_timeout,
    write_incident_bundle,
)

__all__ = [
    "aggregate_snapshot",
    "StragglerMonitor",
    "MetricsRegistry",
    "get_registry",
    "render_prometheus",
    "negotiate_exposition",
    "MetricsServer",
    "resolve_metrics_port",
    "start_metrics_server",
    "snapshot_for_tracking",
    "write_snapshot",
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
    "CostTable",
    "ProgramCost",
    "device_peaks",
    "extract_cost_analysis",
    "resolve_sample_every",
    "StallWatchdog",
    "StallError",
    "resolve_stall_timeout",
    "resolve_incident_dir",
    "write_incident_bundle",
    "build_exception_report",
    "list_incident_bundles",
    "load_incident_bundle",
    "LockOrderViolation",
    "TrackedLock",
    "lockwatch_enabled",
    "lockwatch_state",
    "maybe_tracked",
    "reset_lockwatch",
]
