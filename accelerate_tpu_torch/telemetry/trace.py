"""Host-side span tracing with a ring-buffer flight recorder.

A copy of `accelerate_tpu/telemetry/trace.py` (which imports no jax at
module level, but importing it runs the JAX package's `__init__`). Two
changes: a span's name is mirrored onto the PyTorch profiler's timeline
through `torch.profiler.record_function` (the reference enters
`jax.profiler.TraceAnnotation`), and the port reads no environment
variable: tracing is on only after `configure_tracing(enabled=True)`.

`span("name", **attrs)` wraps a region of host code; when tracing is
enabled each span records (trace id, span id, parent id, thread, start,
duration, attrs) into a bounded ring buffer — the *flight recorder* — and
optionally enters `torch.profiler.record_function` so the same names
appear on the device traces `torch.profiler` captures. The recorder tail
is what an incident dump freezes, and `export_chrome_trace()` writes the
whole ring as Perfetto-compatible `chrome://tracing` JSON.

Request-scoped tracing builds on three additions:

- *explicit trace context*: `span(..., trace=, parent=, links=)` joins a
  span to an externally minted trace (the HTTP front door mints one per
  request, or honors an inbound W3C `traceparent` via
  `parse_traceparent`), and `record_span()` appends a span whose
  start/end are only known in retrospect (queue wait, decode lifetime);
  `links` attaches other trace ids to a span — the shared decode step
  links every live request's trace without belonging to any one of them.
- *per-tenant head sampling*: `configure_tracing(sample_rates=...,
  default_sample_rate=...)` + `head_sample(tenant)` decide once, at
  request arrival, whether a request records spans at all — a rate-0
  tenant costs zero ring entries while still getting a request id.
- *a per-request span index*: the ring keeps a `trace_id -> events` side
  index (pruned as the ring evicts) so `trace_events(trace_id)` and the
  `/debug` endpoints answer "what happened to THIS request" without
  scanning the whole recorder.

Disabled (the default) a span is a shared no-op context manager: one
function call, one attribute load, no allocation — cheap enough to leave
in dispatch-path code permanently. Enable with
`configure_tracing(enabled=True)`.

torch is imported lazily and only while tracing is enabled, so this
module never initializes a device on import.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any

__all__ = [
    "span",
    "record_span",
    "next_span_id",
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


class _NullSpan:
    """Shared do-nothing span: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _State:
    __slots__ = ("enabled", "annotate", "ring", "ring_size", "index",
                 "lock", "span_ids", "trace_ids", "tls", "sample_rates",
                 "default_sample_rate", "appended")

    def __init__(self):
        self.enabled = False
        self.annotate = True
        self.ring_size = 4096
        self.ring: deque = deque()
        # monotone count of every event ever appended — the cursor space
        # for `drain_spans` (a pod worker's heartbeat exporter)
        self.appended = 0
        # trace_id -> [event, ...] side index over the SAME event dicts
        # the ring holds; pruned in lockstep with ring eviction, so it is
        # bounded by the ring and never outlives it
        self.index: dict[Any, list[dict]] = {}
        self.lock = threading.Lock()
        self.span_ids = itertools.count(1)
        self.trace_ids = itertools.count(1)
        self.tls = threading.local()
        self.sample_rates: dict[str, float] = {}
        self.default_sample_rate = 1.0


_STATE = _State()
_annotation_cls: Any = None  # resolved lazily; False = unavailable


def configure_tracing(enabled: bool = True, ring_size: int | None = None,
                      annotate: bool | None = None,
                      sample_rates: dict[str, float] | None = None,
                      default_sample_rate: float | None = None) -> None:
    """Turn host-span recording on/off. `ring_size` bounds the flight
    recorder (events, not spans — one per completed span); `annotate`
    controls forwarding span names to `torch.profiler.record_function`.
    `sample_rates` ({tenant: rate in [0, 1]}) and `default_sample_rate`
    drive per-tenant head sampling of request traces (`head_sample`)."""
    _STATE.enabled = bool(enabled)
    if ring_size is not None:
        with _STATE.lock:
            _STATE.ring_size = int(ring_size)
            while len(_STATE.ring) > _STATE.ring_size:
                _prune_index(_STATE.ring.popleft())
    if annotate is not None:
        _STATE.annotate = bool(annotate)
    if sample_rates is not None:
        _STATE.sample_rates = {str(k): float(v)
                               for k, v in sample_rates.items()}
    if default_sample_rate is not None:
        _STATE.default_sample_rate = float(default_sample_rate)


def tracing_enabled() -> bool:
    return _STATE.enabled


def head_sample(tenant: str = "default") -> bool:
    """Head-sampling decision for one request: made ONCE at arrival so a
    request's spans are all-or-nothing (a half-sampled trace is noise).
    False whenever tracing is disabled; per-tenant rates override the
    default, so a chatty bronze tier can run at 1% while gold keeps
    every trace."""
    if not _STATE.enabled:
        return False
    rate = _STATE.sample_rates.get(tenant, _STATE.default_sample_rate)
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate


# -- W3C trace context -------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    """A fresh 128-bit trace id as 32 lowercase hex chars (the W3C
    `traceparent` wire shape, and what `x-request-id` returns)."""
    return os.urandom(16).hex()


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """Parse an inbound W3C `traceparent` header into (trace_id,
    parent_span_id). Returns None on ANYTHING malformed — wrong field
    count, bad lengths, non-hex, all-zero ids, reserved version `ff` —
    so the caller mints a fresh id instead of propagating garbage."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, parent_id, _flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id, parent_id


def format_traceparent(trace_id: str, span_id: int | str = 0,
                       sampled: bool = True) -> str:
    """Render a W3C `traceparent` for propagation to a downstream hop."""
    if isinstance(span_id, int):
        span_hex = format(span_id & (2 ** 64 - 1), "016x")
    else:
        span_hex = str(span_id)[-16:].rjust(16, "0")
    if span_hex == "0" * 16:
        span_hex = "0" * 15 + "1"
    return f"00-{trace_id}-{span_hex}-{'01' if sampled else '00'}"


# -- recording ---------------------------------------------------------------


def _resolve_annotation_cls():
    global _annotation_cls
    if _annotation_cls is None:
        try:
            from torch.profiler import record_function

            _annotation_cls = record_function
        except ImportError:
            _annotation_cls = False
    return _annotation_cls


def _stack() -> list:
    stack = getattr(_STATE.tls, "stack", None)
    if stack is None:
        stack = _STATE.tls.stack = []
    return stack


def _prune_index(event: dict) -> None:
    """Drop one evicted ring event from the trace index (lock held)."""
    tid = event.get("trace_id")
    bucket = _STATE.index.get(tid)
    if bucket is None:
        return
    try:
        bucket.remove(event)
    except ValueError:
        pass
    if not bucket:
        del _STATE.index[tid]


def _append_event(event: dict) -> None:
    with _STATE.lock:
        if len(_STATE.ring) >= _STATE.ring_size:
            _prune_index(_STATE.ring.popleft())
        _STATE.ring.append(event)
        _STATE.appended += 1
        tid = event.get("trace_id")
        if tid:
            _STATE.index.setdefault(tid, []).append(event)


def next_span_id() -> int:
    """Pre-allocate a span id — how a request's root span can be the
    parent of children recorded BEFORE the root itself is (the root's
    end time is only known when the request goes terminal)."""
    return next(_STATE.span_ids)


class _Span:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "links", "_start_ns", "_annotation")

    def __init__(self, name: str, attrs: dict, trace=None, parent=None,
                 links=None):
        self.name = name
        self.attrs = attrs
        self.trace_id = trace
        self.parent_id = parent
        self.links = links

    def __enter__(self):
        stack = _stack()
        if self.trace_id is None:
            if stack:
                parent = stack[-1]
                self.trace_id = parent.trace_id
                if self.parent_id is None:
                    self.parent_id = parent.span_id
            else:
                self.trace_id = next(_STATE.trace_ids)
        if self.parent_id is None:
            self.parent_id = 0
        self.span_id = next(_STATE.span_ids)
        stack.append(self)
        self._annotation = None
        if _STATE.annotate:
            cls = _resolve_annotation_cls()
            if cls:
                self._annotation = cls(self.name)
                self._annotation.__enter__()
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        event = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": threading.get_ident(),
            "start_ns": self._start_ns,
            "dur_ns": end_ns - self._start_ns,
        }
        if self.attrs:
            event["attrs"] = self.attrs
        if self.links:
            event["links"] = list(self.links)
        if exc_type is not None:
            event["error"] = exc_type.__name__
        _append_event(event)
        return False


def span(name: str, trace=None, parent=None, links=None, **attrs):
    """Context manager around a host-side region. No-op when tracing is
    disabled; otherwise records to the flight recorder and mirrors the
    name onto the PyTorch profiler's timeline. `trace`/`parent` join the span to
    an explicit trace (request tracing) instead of the thread-local
    stack; `links` attaches other trace ids (a span serving many
    requests at once — e.g. one batched decode step — links them all)."""
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs, trace=trace, parent=parent, links=links)


def record_span(name: str, start_s: float, end_s: float, trace=None,
                parent=0, span_id: int | None = None, links=None,
                **attrs) -> int:
    """Append a RETROSPECTIVE span — one whose boundaries were only known
    after the fact (queue wait: measured at admission; a request's root
    span: closed at its terminal state). Times are seconds in the
    `time.monotonic`/`perf_counter` timebase. Returns the span id (0
    when tracing is disabled and nothing was recorded)."""
    if not _STATE.enabled:
        return 0
    sid = next(_STATE.span_ids) if span_id is None else span_id
    event = {
        "name": name,
        "trace_id": trace if trace is not None else next(_STATE.trace_ids),
        "span_id": sid,
        "parent_id": parent,
        "thread": threading.get_ident(),
        "start_ns": int(start_s * 1e9),
        "dur_ns": max(0, int((end_s - start_s) * 1e9)),
    }
    if attrs:
        event["attrs"] = attrs
    if links:
        event["links"] = list(links)
    _append_event(event)
    return sid


# -- reading back ------------------------------------------------------------


def flight_recorder(last: int | None = None) -> list[dict]:
    """Most recent completed spans, oldest first (an incident dump
    freezes the tail of this)."""
    with _STATE.lock:
        events = list(_STATE.ring)
    if last is not None:
        events = events[-last:]
    return events


def trace_events(trace_id) -> list[dict]:
    """Every still-buffered span of one trace, oldest first — the
    per-request view behind `/debug` introspection and incident
    forensics. O(spans-of-this-trace) via the side index, not a ring
    scan."""
    with _STATE.lock:
        events = list(_STATE.index.get(trace_id, ()))
    events.sort(key=lambda e: e["start_ns"])
    return events


def clear_flight_recorder() -> None:
    # `appended` deliberately survives: it is the cursor space for
    # `drain_spans`, and a cursor must never move backwards
    with _STATE.lock:
        _STATE.ring.clear()
        _STATE.index.clear()


# -- cross-process span export (pod workers -> router) -----------------------


def drain_spans(cursor: int, limit: int = 256) -> tuple[list[dict], int]:
    """Ring events appended after `cursor` (a value previously returned
    by this function; start at 0), NEWEST FIRST and bounded by `limit` —
    the same shape as the pod's heartbeat metric snapshots: when a
    burst overflows the bound, the newest spans survive. Only
    request-scoped events (string trace ids — the W3C shape the wire
    propagates) and link-carrying events (the shared decode step) are
    exported; thread-local int-trace chatter stays home. Returns
    ``(events, new_cursor)``; events are the live ring dicts — callers
    serialize, they must not mutate."""
    with _STATE.lock:
        total = _STATE.appended
        fresh = total - cursor
        if fresh <= 0:
            return [], total
        events = list(_STATE.ring)[-min(fresh, len(_STATE.ring)):]
    out = [e for e in reversed(events)
           if isinstance(e.get("trace_id"), str) or e.get("links")]
    return out[:limit], total


def ingest_spans(events: list[dict], offset_s: float = 0.0,
                 pid: int | None = None,
                 worker: int | str | None = None) -> int:
    """Append pre-formed span events exported by ANOTHER process into
    this process's flight recorder, rebasing each `start_ns` by
    `offset_s` (that process's clock -> ours; the router passes its
    NTP-style per-worker estimate). Process-local int trace ids are
    namespaced (`w<worker>:<id>`) so they cannot collide with ours;
    string (request-scoped) trace ids merge verbatim — that is the
    point. Malformed entries are skipped, never raised. Returns the
    number ingested; 0 when tracing is disabled."""
    if not _STATE.enabled or not events:
        return 0
    shift = int(offset_s * 1e9)
    scope = f"w{worker}" if worker is not None else "remote"
    n = 0
    for e in events:
        if not isinstance(e, dict):
            continue
        try:
            tid = e.get("trace_id")
            if not isinstance(tid, str):
                tid = f"{scope}:{tid}"
            ev = {
                "name": str(e["name"]),
                "trace_id": tid,
                "span_id": int(e.get("span_id", 0)),
                "parent_id": int(e.get("parent_id", 0)),
                "thread": int(e.get("thread", 0)),
                "start_ns": int(e["start_ns"]) + shift,
                "dur_ns": max(0, int(e.get("dur_ns", 0))),
            }
        except (KeyError, TypeError, ValueError):
            continue
        attrs = e.get("attrs")
        attrs = dict(attrs) if isinstance(attrs, dict) else {}
        if worker is not None:
            attrs.setdefault("worker", worker)
        if attrs:
            ev["attrs"] = attrs
        links = e.get("links")
        if isinstance(links, (list, tuple)) and links:
            ev["links"] = list(links)
        if pid is not None:
            ev["pid"] = int(pid)
        _append_event(ev)
        n += 1
    return n


def export_chrome_trace(path: str | None = None, trace_id=None) -> dict:
    """Render the flight recorder as `chrome://tracing` / Perfetto JSON
    (complete 'X' events; microsecond timestamps). Returns the document;
    writes it to `path` when given — load alongside a
    `torch.profiler` capture to line host spans up with device kernels. `trace_id` filters to one request's spans. Events ingested
    from pod workers (`ingest_spans`) keep their origin pid, so a
    cross-process request renders as one timeline with one row-group
    per process."""
    source = flight_recorder() if trace_id is None else trace_events(trace_id)
    events = []
    for e in source:
        args = {
            "trace_id": e["trace_id"],
            "span_id": e["span_id"],
            "parent_id": e["parent_id"],
            **e.get("attrs", {}),
        }
        if "links" in e:
            args["links"] = e["links"]
        ev = {
            "name": e["name"],
            "cat": "host",
            "ph": "X",
            "ts": e["start_ns"] / 1e3,
            "dur": e["dur_ns"] / 1e3,
            "pid": e.get("pid", os.getpid()),
            "tid": e["thread"],
            "args": args,
        }
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
    return doc
