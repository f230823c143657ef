"""Stall watchdog and incident bundles (port of
`accelerate_tpu/telemetry/watchdog.py`): turn silent hangs into reports.

A job wedged on the card (a kernel that never returns, a host thread
waiting on an event nothing will record) looks like a slow one from the
outside: no exception, no progress, no logs. The watchdog is a heartbeat
armed by step/serving-loop ticks; when the configured silence elapses it
dumps, once per stall:

- every thread's Python stack (where the hang actually is),
- `profiler.device_memory_stats()` (the CUDA caching allocator's
  statistics: is device memory exhausted, still moving),
- the tail of the span flight recorder (what the process last did),

to the logger (and an optional callback), then optionally raises
`StallError`. A later tick re-arms it. With an incident directory it
also writes a bundle (below), file for file the reference's, so either
package's `load_incident_bundle` reads the other's.

Off unless a timeout is given: the port reads none of the reference's
environment variables (`resolve_stall_timeout(None)` and
`resolve_incident_dir(None)` are None). The clock is injectable, which
is how the tests drive it without sleeping.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable

from .trace import export_chrome_trace, flight_recorder

__all__ = ["StallWatchdog", "StallError", "resolve_stall_timeout",
           "resolve_incident_dir", "write_incident_bundle",
           "build_exception_report", "list_incident_bundles",
           "load_incident_bundle"]


class StallError(RuntimeError):
    """Raised (when `raise_on_stall=True`) after a stall report is dumped."""


def resolve_stall_timeout(explicit: float | None = None) -> float | None:
    """The explicit timeout; None means the watchdog is off."""
    if explicit is not None:
        return float(explicit)
    return None


def resolve_incident_dir(explicit: str | None = None) -> str | None:
    """Where incident bundles land: the explicit directory; None means
    bundles are off (the stall report still goes to the log — a bundle
    is the on-disk superset)."""
    if explicit is not None:
        return str(explicit)
    return None


def _all_thread_stacks() -> dict[str, list[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks: dict[str, list[str]] = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        stacks[label] = traceback.format_stack(frame)
    return stacks


# -- incident bundles --------------------------------------------------------
#
# A stall report in the log answers "what was the process doing"; a bundle
# answers it from recorded state after the process is gone. One
# self-contained directory per incident:
#
#     incident-<utc-stamp>-<name>/
#       manifest.json        what/when/why + the file list (read this first)
#       report.json          the full machine-readable report
#       stacks.txt           every thread's Python stack, human-formatted
#       trace.json           flight-recorder chrome://tracing export
#       metrics.json         registry snapshot (when a registry was wired)
#       metrics.prom         the same, Prometheus text exposition
#       device_memory.json   the CUDA allocator's statistics (best effort)
#       <extra>.json         caller dumps (scheduler state, slot table, ...)
#
# `python -m accelerate_tpu_torch.commands.incident list/show` renders these.

BUNDLE_VERSION = 1


def write_incident_bundle(base_dir: str, report: dict, *,
                          registry=None, dumps: dict[str, Any] | None = None,
                          name: str = "stall") -> str:
    """Write one self-contained incident bundle directory under
    `base_dir`; returns its path. Everything is best-effort per file — a
    bundle with a missing metrics snapshot still carries the stacks."""
    safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in name)
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
    path = os.path.join(base_dir, f"incident-{stamp}-{safe}")
    n = 1
    while os.path.exists(path):  # same-second incidents get a suffix
        n += 1
        path = os.path.join(base_dir, f"incident-{stamp}-{safe}-{n}")
    os.makedirs(path)
    files: list[str] = []

    def _write(fname: str, text: str) -> None:
        with open(os.path.join(path, fname), "w") as f:
            f.write(text)
        files.append(fname)

    def _write_json(fname: str, obj: Any) -> None:
        _write(fname, json.dumps(obj, indent=2, default=str))

    def _best_effort(fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    errors: list[str] = []
    _best_effort(lambda: _write_json("report.json", report))
    stacks = report.get("stacks") or {}
    if stacks:
        text = "\n".join(
            f"--- thread {label} ---\n" + "".join(stack).rstrip()
            for label, stack in stacks.items())
        _best_effort(lambda: _write("stacks.txt", text + "\n"))
    _best_effort(lambda: _write_json("trace.json", export_chrome_trace()))
    if registry is not None:
        _best_effort(lambda: _write_json(
            "metrics.json", registry.snapshot(include_sketch=True)))

        def _prom():
            from .export import render_prometheus

            _write("metrics.prom", render_prometheus(registry))

        _best_effort(_prom)
    if "device_memory_stats" in report:
        _best_effort(lambda: _write_json(
            "device_memory.json", report["device_memory_stats"]))
    for key, obj in (dumps or {}).items():
        safe_key = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in str(key))
        _best_effort(lambda k=safe_key, o=obj: _write_json(f"{k}.json", o))
    manifest = {
        "version": BUNDLE_VERSION,
        "kind": safe,
        "created_at": time.time(),
        "created_at_utc": stamp,
        "silence_s": report.get("silence_s"),
        "error": report.get("error"),
        "files": files,
    }
    if errors:
        manifest["write_errors"] = errors
    _write_json("manifest.json", manifest)
    return path


def build_exception_report(exc: BaseException, name: str = "crash") -> dict:
    """A stall-report-shaped dict for a DIED loop (vs a silent one): the
    exception + its traceback next to the same thread stacks / flight
    recorder / device memory stats the watchdog captures, so one bundle
    format covers both failure modes."""
    report: dict[str, Any] = {
        "watchdog": name,
        "error": f"{type(exc).__name__}: {exc}",
        "traceback": traceback.format_exception(type(exc), exc,
                                                exc.__traceback__),
        "stacks": _all_thread_stacks(),
        "flight_recorder": flight_recorder(64),
    }
    try:
        from ..profiler import device_memory_stats

        report["device_memory_stats"] = device_memory_stats()
    except Exception as e:
        report["device_memory_stats"] = {"error": f"{type(e).__name__}: {e}"}
    return report


def list_incident_bundles(base_dir: str) -> list[dict]:
    """Manifest summaries of every bundle under `base_dir`, newest first.
    Each entry carries `path` plus the manifest fields; unreadable
    bundles appear with an `error` so forensics never silently skips."""
    out: list[dict] = []
    if not os.path.isdir(base_dir):
        return out
    for entry in sorted(os.listdir(base_dir)):
        if not entry.startswith("incident-"):
            continue
        path = os.path.join(base_dir, entry)
        if not os.path.isdir(path):
            continue
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except Exception as e:
            manifest = {"error": f"unreadable manifest: {e}"}
        manifest["path"] = path
        out.append(manifest)
    out.sort(key=lambda m: m.get("created_at", 0), reverse=True)
    return out


def load_incident_bundle(path: str) -> dict:
    """Load a bundle directory into {manifest, report, files}; JSON files
    parsed, text files raw."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    contents: dict[str, Any] = {}
    for fname in manifest.get("files", []):
        fpath = os.path.join(path, fname)
        try:
            with open(fpath) as f:
                contents[fname] = (json.load(f) if fname.endswith(".json")
                                   else f.read())
        except Exception as e:
            contents[fname] = {"error": f"{type(e).__name__}: {e}"}
    return {"path": path, "manifest": manifest, "files": contents}


class StallWatchdog:
    """Heartbeat monitor. `tick()` from the loop being watched; `start()`
    spawns the background checker (or call `check()` yourself — that is
    the deterministic path the tests use)."""

    def __init__(
        self,
        timeout_s: float,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_stall: Callable[[dict], Any] | None = None,
        raise_on_stall: bool = False,
        poll_interval_s: float | None = None,
        flight_recorder_tail: int = 64,
        logger=None,
        name: str = "accelerate-tpu",
        incident_dir: str | None = None,
        registry=None,
        dumps: Callable[[], dict] | None = None,
    ):
        if timeout_s <= 0:
            raise ValueError("timeout_s must be positive")
        self.timeout_s = float(timeout_s)
        self.clock = clock
        self.on_stall = on_stall
        self.raise_on_stall = raise_on_stall
        self.poll_interval_s = (
            poll_interval_s if poll_interval_s is not None
            else max(0.25, min(self.timeout_s / 4.0, 5.0))
        )
        self.flight_recorder_tail = flight_recorder_tail
        self.name = name
        # incident bundles: the explicit dir; None = off.
        # `registry` adds a metrics snapshot to the bundle, `dumps` is a
        # zero-arg callable returning extra {name: obj} dumps (the serving
        # engine passes its scheduler/slot/page introspection here).
        self.incident_dir = resolve_incident_dir(incident_dir)
        self.registry = registry
        self.dumps = dumps
        if logger is None:
            from ..logging import get_logger

            logger = get_logger(__name__)
        self.logger = logger
        self.stall_count = 0
        self._lock = threading.Lock()
        self._last_tick = self.clock()
        self._fired = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- heartbeat -----------------------------------------------------------

    def tick(self) -> None:
        """Progress happened: reset the silence window and re-arm."""
        with self._lock:
            self._last_tick = self.clock()
            self._fired = False

    @property
    def stalled(self) -> bool:
        """True while a stall report has fired and no tick has re-armed —
        the readiness signal health endpoints degrade on."""
        return self._fired

    def check(self, now: float | None = None) -> dict | None:
        """Fire if the silence exceeded `timeout_s` and we haven't fired
        for this silence yet. Returns the stall report when it fires,
        else None. Exactly-once per stall: re-arms only on `tick()`."""
        now = self.clock() if now is None else now
        with self._lock:
            silence = now - self._last_tick
            if self._fired or silence <= self.timeout_s:
                return None
            self._fired = True
            self.stall_count += 1
        report = self.build_report(silence)
        if self.incident_dir is not None:
            # resolve the caller dumps SEPARATELY from the bundle write:
            # dumps() walks live engine state that may be mutating under a
            # slow-but-not-dead stall, and its failure must cost the dump
            # files only — never the stacks/trace/metrics of the bundle
            dumps = None
            if self.dumps is not None:
                try:
                    dumps = self.dumps()
                except Exception as e:
                    dumps = {"dumps_error":
                             {"error": f"{type(e).__name__}: {e}"}}
            try:
                report["bundle_path"] = write_incident_bundle(
                    self.incident_dir, report, registry=self.registry,
                    dumps=dumps, name=self.name)
            except Exception as e:
                # the bundle is best-effort; the log report must land
                report["bundle_error"] = f"{type(e).__name__}: {e}"
        self._emit(report)
        if self.raise_on_stall:
            raise StallError(
                f"[{self.name}] no heartbeat for {silence:.1f}s "
                f"(timeout {self.timeout_s}s); stall report dumped"
            )
        return report

    # -- the report ----------------------------------------------------------

    def build_report(self, silence_s: float) -> dict:
        report: dict[str, Any] = {
            "watchdog": self.name,
            "silence_s": silence_s,
            "timeout_s": self.timeout_s,
            "stall_count": self.stall_count,
            "stacks": _all_thread_stacks(),
            "flight_recorder": flight_recorder(self.flight_recorder_tail),
        }
        try:
            from ..profiler import device_memory_stats

            report["device_memory_stats"] = device_memory_stats()
        except Exception as e:
            # a wedged device must not keep the report from landing
            report["device_memory_stats"] = {
                "error": f"{type(e).__name__}: {e}"}
        return report

    def _emit(self, report: dict) -> None:
        lines = [
            f"[{self.name}] STALL: no heartbeat for "
            f"{report['silence_s']:.1f}s (timeout {self.timeout_s}s). "
            f"Thread stacks follow.",
        ]
        for label, stack in report["stacks"].items():
            lines.append(f"--- thread {label} ---")
            lines.append("".join(stack).rstrip())
        mem = report.get("device_memory_stats") or {}
        if mem:
            lines.append(f"device_memory_stats: {mem}")
        tail = report.get("flight_recorder") or []
        if tail:
            lines.append(f"flight recorder (last {len(tail)} spans):")
            for e in tail[-16:]:
                lines.append(
                    f"  {e['name']} dur={e['dur_ns'] / 1e6:.3f}ms "
                    f"trace={e['trace_id']} span={e['span_id']}"
                )
        if "bundle_path" in report:
            lines.append(f"incident bundle written: {report['bundle_path']} "
                         "(python -m accelerate_tpu_torch.commands.incident "
                         "show)")
        elif "bundle_error" in report:
            lines.append(f"incident bundle FAILED: {report['bundle_error']}")
        try:
            self.logger.error("\n".join(lines))
        except Exception:
            pass
        if self.on_stall is not None:
            try:
                self.on_stall(report)
            except StallError:
                raise
            except Exception:
                pass

    # -- background thread ---------------------------------------------------

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"{self.name}-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.check()
            except StallError:
                # raise_on_stall in thread mode: the report is already
                # dumped; the raise ends the checker so a supervisor
                # watching the log (or on_stall) takes over
                raise

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
