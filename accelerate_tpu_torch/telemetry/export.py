"""Prometheus text exposition, the metrics exporter thread, and JSONL
snapshots of a metrics registry (a copy of
`accelerate_tpu/telemetry/export.py`).

- `render_prometheus` (text format 0.0.4, or OpenMetrics with trace-id
  exemplars on the latency histograms) and `negotiate_exposition`, the
  Accept-header negotiation that both the exporter and the HTTP front
  door's `/metrics` route serve;
- `MetricsServer` / `start_metrics_server`: `/metrics` (GET and HEAD) on
  a background thread, bound to 127.0.0.1 unless a host is given; port
  0 binds an ephemeral port, and an explicit port that cannot bind
  raises. The port reads no environment variable: no port, no exporter;
- `snapshot_for_tracking` (what `Accelerator.log_telemetry` logs through
  the trackers) and `write_snapshot`.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import MetricsRegistry, flatten_snapshot, get_registry

__all__ = [
    "render_prometheus",
    "PROMETHEUS_CONTENT_TYPE",
    "OPENMETRICS_CONTENT_TYPE",
    "negotiate_exposition",
    "MetricsServer",
    "resolve_metrics_port",
    "start_metrics_server",
    "snapshot_for_tracking",
    "write_snapshot",
]

_QUANTILES = (0.5, 0.9, 0.99)


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = ['%s="%s"' % (_sanitize(k), _escape(str(v))) for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    return repr(float(v))


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def render_prometheus(registry: MetricsRegistry | None = None,
                      openmetrics: bool = False) -> str:
    """Text exposition of every series in the registry.

    Default: Prometheus text format 0.0.4 (histogram sketches rendered
    as `summary` quantile series + `_sum`/`_count`). `openmetrics=True`
    switches to the OpenMetrics flavor: sketches that carry exemplars
    (TTFT, per-token latency — see `StreamingHistogram.record(...,
    exemplar=)`) render as real `histogram` families with cumulative
    `_bucket{le=...}` lines, each bucket's newest exemplar attached as
    `# {trace_id="..."} value ts` — a bad p99 bucket links straight to
    the trace that landed in it — and the document ends with `# EOF`.
    Exemplar-less series render identically in both modes, so scrape
    configs can negotiate per request (Accept header) without the two
    views disagreeing on values."""
    registry = registry or get_registry()
    lines: list[str] = []
    seen_types: set[str] = set()

    def type_line(name: str, kind: str) -> None:
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for kind, name, labels, metric in registry.items():
        pname = _sanitize(name)
        if kind == "counter":
            # OpenMetrics 1.0: a counter FAMILY is named without the
            # _total suffix while its sample keeps it — a strict OM
            # parser (Prometheus with exemplar scraping on) rejects the
            # whole scrape otherwise. The 0.0.4 flavor keeps the
            # long-standing family==sample naming.
            family = (pname[:-len("_total")]
                      if openmetrics and pname.endswith("_total")
                      else pname)
            type_line(family, "counter")
            lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_value(metric.value)}")
        elif kind == "gauge":
            type_line(pname, "gauge")
            lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_value(metric.value)}")
        else:
            exemplars = metric.exemplars() if openmetrics else {}
            if exemplars:  # histogram with bucket exemplars
                type_line(pname, "histogram")
                by_bound = {
                    round(metric.bucket_upper_bound(idx), 12): ex
                    for idx, ex in exemplars.items()}
                for bound, cum in metric.bucket_counts():
                    le = f'le="{_fmt_value(bound)}"'
                    line = f"{pname}_bucket{_fmt_labels(labels, le)} {cum}"
                    ex = by_bound.get(round(bound, 12))
                    if ex is not None:
                        val, label, ts = ex
                        line += (f' # {{trace_id="{_escape(label)}"}} '
                                 f"{_fmt_value(val)} {ts:.3f}")
                    lines.append(line)
                inf_le = 'le="+Inf"'
                lines.append(
                    f"{pname}_bucket{_fmt_labels(labels, inf_le)}"
                    f" {metric.count}")
                lines.append(f"{pname}_sum{_fmt_labels(labels)} {_fmt_value(metric.sum)}")
                lines.append(f"{pname}_count{_fmt_labels(labels)} {_fmt_value(metric.count)}")
                continue
            # histogram -> summary (quantiles come from the sketch)
            type_line(pname, "summary")
            for q in _QUANTILES:
                val = metric.quantile(q) if metric.count else float("nan")
                qlabel = 'quantile="%s"' % q
                lines.append(
                    f"{pname}{_fmt_labels(labels, qlabel)} {_fmt_value(val)}"
                )
            lines.append(f"{pname}_sum{_fmt_labels(labels)} {_fmt_value(metric.sum)}")
            lines.append(f"{pname}_count{_fmt_labels(labels)} {_fmt_value(metric.count)}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def negotiate_exposition(accept: str | None,
                         registry: MetricsRegistry | None = None,
                         ) -> tuple[str, str]:
    """(body, content_type) for one scrape, negotiated from the Accept
    header: an OpenMetrics-capable scraper (Prometheus sends this Accept
    when exemplar scraping is on) gets the exemplar-carrying flavor,
    everyone else the 0.0.4 text format. The ONE negotiation shared by
    the standalone exporter and the serving front door's /metrics route
    — they must never diverge."""
    om = "application/openmetrics-text" in (accept or "")
    body = render_prometheus(registry, openmetrics=om)
    return body, (OPENMETRICS_CONTENT_TYPE if om
                  else PROMETHEUS_CONTENT_TYPE)


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry | None = None  # set per server subclass

    def _respond(self, include_body: bool) -> None:
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        text, ctype = negotiate_exposition(self.headers.get("Accept"),
                                           self.registry)
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if include_body:
            self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        self._respond(include_body=True)

    def do_HEAD(self):  # noqa: N802 — health probes HEAD before scraping
        self._respond(include_body=False)

    def log_message(self, *args):  # scrapes are not log lines
        pass


class MetricsServer:
    """Prometheus endpoint on a background daemon thread.

    `port=0` binds an ephemeral port; read the bound one from `.port`.
    Binds loopback by default: telemetry carries workload details, so
    serving it beyond the host is an explicit `host=`."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry or get_registry()
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="accelerate-tpu-metrics", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()


def resolve_metrics_port(explicit: int | None = None) -> int | None:
    """The port to serve on: the explicit value; None means the exporter
    stays off. 0 binds an ephemeral port."""
    if explicit is not None:
        return int(explicit)
    return None


def start_metrics_server(port: int | None = None,
                         registry: MetricsRegistry | None = None,
                         host: str | None = None) -> MetricsServer | None:
    """Start the exporter when a port is given; returns the running
    server, or None when none is asked for. A port that cannot bind
    raises (the caller asked for it). `host` defaults to 127.0.0.1."""
    resolved = resolve_metrics_port(port)
    if resolved is None:
        return None
    return MetricsServer(registry=registry, port=resolved,
                         host=host or "127.0.0.1").start()


def snapshot_for_tracking(registry: MetricsRegistry | None = None,
                          prefix: str = "telemetry/") -> dict[str, float]:
    """A flat str -> float snapshot shaped for `GeneralTracker.log` (the
    JSONL tracker writes it as one line)."""
    registry = registry or get_registry()
    return flatten_snapshot(registry.snapshot(), prefix=prefix)


def write_snapshot(path: str,
                   registry: MetricsRegistry | None = None) -> dict:
    """Append one JSON line of the current snapshot to `path`, for callers
    outside the tracker fan-out."""
    registry = registry or get_registry()
    record = {"ts": time.time(), **flatten_snapshot(registry.snapshot())}
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return record
