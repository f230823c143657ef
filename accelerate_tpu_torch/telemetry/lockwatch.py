"""Runtime lock-order sanitizer (port of
`accelerate_tpu/telemetry/lockwatch.py`).

Every :class:`TrackedLock` records, per thread, which locks were already
held when it was acquired, into ONE process-wide acquisition-order graph
keyed by lock *name* (a lock class, not an instance: every host-tier
entry shares ``"host-tier-entry"``).

Acquiring B while holding A adds the edge ``A -> B``. If the graph
already shows a path ``B -> ... -> A``, then some thread has taken the
opposite order — the two-thread deadlock is one unlucky scheduling
away. Lockwatch refuses to close the cycle: the acquire raises
:class:`LockOrderViolation` naming the full cycle path *before*
blocking, and, when the lock was given an ``incident_dir``, writes an
incident bundle (the stall watchdog's format).

Tracked locks also feed the metrics registry:

- ``lock_contention_total{lock=}`` — acquires that found the lock held
- ``lock_held_seconds{lock=}`` — held-duration streaming histogram
- ``lock_order_violations_total{lock=}`` — refused cycle-closing acquires

The switch is explicit: :func:`maybe_tracked` returns a plain
``threading.Lock`` unless the call says ``setting=True``. The reference
also switches on its ``ACCELERATE_TPU_LOCKWATCH`` environment variable
and writes its bundles to ``ACCELERATE_TPU_INCIDENT_DIR``; the port reads
neither, so its wired sites (``checkpoint-commit``, ``host-tier-entry``)
are plain locks and write no bundle. Reentrancy through the registry is
cut by a thread-local hook guard: while a lockwatch hook is running (or
writing a bundle), tracked locks degrade to plain locks.
"""

from __future__ import annotations

import threading
import time
from typing import Any

__all__ = [
    "LockOrderViolation",
    "TrackedLock",
    "lockwatch_enabled",
    "lockwatch_state",
    "maybe_tracked",
    "reset_lockwatch",
]

def lockwatch_enabled(setting: Any = None) -> bool:
    """The explicit setting; None means off."""
    return bool(setting)


class LockOrderViolation(RuntimeError):
    """A would-deadlock acquisition, refused. ``cycle`` is the full lock
    path (first element repeated at the end); ``held`` is what the
    acquiring thread held at the moment of refusal; ``bundle_path`` is
    the incident bundle written for it (None when bundles are off)."""

    def __init__(self, cycle: list, thread: str, held: list):
        self.cycle = list(cycle)
        self.thread = thread
        self.held = list(held)
        self.bundle_path: str | None = None
        super().__init__(
            "lock-order cycle: " + " -> ".join(self.cycle)
            + f" (thread {thread!r} holds {self.held}, acquiring "
            f"{self.cycle[1]!r} would close the cycle)")


class _LockGraph:
    """The process-wide acquisition graph. All access under ONE plain
    (never tracked) internal lock; operations are dict hops over lock
    *names*, so the critical section is tiny."""

    def __init__(self):
        self._mu = threading.Lock()
        self.edges: dict = {}        # name -> {succ: {"count", "thread"}}
        self.violations: list = []

    def check_and_record(self, held: tuple, new: str,
                         thread: str) -> list | None:
        """Add edges held->new. If any edge would close a cycle, add
        NOTHING, remember the violation, and return the cycle path
        [h, new, ..., h]."""
        with self._mu:
            for h in held:
                if h == new:
                    continue
                path = self._path(new, h)
                if path is not None:
                    cycle = [h] + path
                    self.violations.append({
                        "cycle": cycle, "thread": thread,
                        "held": list(held), "acquiring": new,
                    })
                    return cycle
            for h in held:
                if h != new:
                    e = self.edges.setdefault(h, {}).setdefault(
                        new, {"count": 0, "thread": thread})
                    e["count"] += 1
            return None

    def _path(self, src: str, dst: str) -> list | None:
        """Shortest src..dst path (inclusive) via BFS, else None."""
        prev: dict = {src: None}
        queue = [src]
        while queue:
            cur = queue.pop(0)
            if cur == dst:
                out = []
                while cur is not None:
                    out.append(cur)
                    cur = prev[cur]
                return out[::-1]
            for nxt in self.edges.get(cur, ()):
                if nxt not in prev:
                    prev[nxt] = cur
                    queue.append(nxt)
        return None

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "edges": {a: {b: dict(m) for b, m in succ.items()}
                          for a, succ in self.edges.items()},
                "violations": [dict(v) for v in self.violations],
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.violations.clear()


_GRAPH = _LockGraph()
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def lockwatch_state() -> dict:
    """Snapshot of the process-wide graph: {"edges", "violations"}."""
    return _GRAPH.snapshot()


def reset_lockwatch() -> None:
    """Clear the process-wide graph and violation log (tests)."""
    _GRAPH.reset()


class TrackedLock:
    """A named, instrumented mutual-exclusion lock (duck-types
    ``threading.Lock``: acquire/release/locked/context manager).

    ``name`` is the lock CLASS for ordering purposes — give every
    instance guarding the same kind of state the same name. ``registry``
    defaults to the process registry at first use; a violation writes a
    bundle under ``incident_dir`` when one is given."""

    def __init__(self, name: str, *, registry=None,
                 incident_dir: str | None = None, metrics: bool = True):
        self.name = name
        self._inner = threading.Lock()
        self._registry = registry
        self._metrics = metrics
        self._incident_dir = incident_dir
        self._t0 = 0.0              # write-guarded by holding the lock
        self._c_contention = None   # lazy metric handles
        self._c_violations = None
        self._h_held = None

    # -- metrics (best-effort, reentrancy-safe) ------------------------------

    def _reg(self):
        if self._registry is None:
            from .registry import get_registry

            self._registry = get_registry()
        return self._registry

    def _note_contention(self) -> None:
        if not self._metrics:
            return
        try:
            if self._c_contention is None:
                self._c_contention = self._reg().counter(
                    "lock_contention_total", lock=self.name)
            self._c_contention.inc()
        except Exception:
            pass

    def _note_violation(self) -> None:
        if not self._metrics:
            return
        try:
            if self._c_violations is None:
                self._c_violations = self._reg().counter(
                    "lock_order_violations_total", lock=self.name)
            self._c_violations.inc()
        except Exception:
            pass

    def _note_held(self, seconds: float) -> None:
        if not self._metrics:
            return
        try:
            if self._h_held is None:
                self._h_held = self._reg().histogram(
                    "lock_held_seconds", lock=self.name)
            self._h_held.record(seconds)
        except Exception:
            pass

    # -- the lock protocol ---------------------------------------------------

    def _plain_acquire(self, blocking: bool, timeout: float) -> bool:
        if timeout is not None and timeout >= 0:
            return self._inner.acquire(blocking, timeout)
        return self._inner.acquire(blocking)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if getattr(_tls, "in_hook", False):
            # already inside a lockwatch hook (metrics / bundle write):
            # degrade to a plain lock — no recording, no recursion
            return self._plain_acquire(blocking, timeout)
        _tls.in_hook = True
        try:
            held = _stack()
            if held:
                cycle = _GRAPH.check_and_record(
                    tuple(held), self.name, threading.current_thread().name)
                if cycle is not None:
                    self._violate(cycle, list(held))    # raises
            got = self._inner.acquire(False)
            if not got:
                self._note_contention()
        finally:
            _tls.in_hook = False
        if not got:
            if not blocking:
                return False
            got = self._plain_acquire(True, timeout)
        if got:
            _stack().append(self.name)
            self._t0 = time.perf_counter()
        return got

    def release(self) -> None:
        held_for = time.perf_counter() - self._t0
        self._inner.release()
        if getattr(_tls, "in_hook", False):
            return      # plain-mode acquire never pushed
        _tls.in_hook = True
        try:
            stack = _stack()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.name:
                    del stack[i]
                    break
            self._note_held(held_for)
        finally:
            _tls.in_hook = False

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "locked" if self._inner.locked() else "unlocked"
        return f"<TrackedLock {self.name!r} {state}>"

    # -- violation path ------------------------------------------------------

    def _violate(self, cycle: list, held: list) -> None:
        """Refuse a would-deadlock acquire: count it, bundle it, raise.
        Runs with the hook guard set, so the bundle write (which touches
        the registry and its tracked lock) cannot recurse."""
        self._note_violation()
        exc = LockOrderViolation(cycle, threading.current_thread().name,
                                 held)
        try:
            from .watchdog import (_all_thread_stacks, resolve_incident_dir,
                                   write_incident_bundle)

            base = resolve_incident_dir(self._incident_dir)
            if base is not None:
                report = {
                    "kind": "lock_order_violation",
                    "watchdog": "lockwatch",
                    "error": str(exc),
                    "cycle": cycle,
                    "thread": exc.thread,
                    "held": held,
                    "acquiring": self.name,
                    "stacks": _all_thread_stacks(),
                    "lock_graph": _GRAPH.snapshot()["edges"],
                }
                exc.bundle_path = write_incident_bundle(
                    base, report, registry=self._registry,
                    name="lockwatch")
        except Exception:
            pass        # the raise below is the signal; bundles are extra
        raise exc


def maybe_tracked(name: str, *, setting: Any = None, registry=None,
                  incident_dir: str | None = None, metrics: bool = True):
    """A :class:`TrackedLock` when lockwatch is enabled, else a plain
    ``threading.Lock`` — the gate is construction-time, so a disabled
    process pays literally nothing on the lock hot path.

    ``metrics=False`` keeps the lock in the ordering graph but off the
    registry — for locks *inside* the metrics plumbing, whose
    self-instrumentation would pollute every registry snapshot."""
    if lockwatch_enabled(setting):
        return TrackedLock(name, registry=registry,
                           incident_dir=incident_dir, metrics=metrics)
    return threading.Lock()
