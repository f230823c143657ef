"""The port's lockwatch against the JAX package's: the reference's
`tests/test_lockwatch.py` cases, with the switch given explicitly
(`setting=True`, or a `TrackedLock` built directly). The port reads no
environment variable: with `ACCELERATE_TPU_LOCKWATCH` set, its
`maybe_tracked` still returns a plain lock, and the wired sites
(`checkpoint-commit`, `host-tier-entry`) are plain locks.

Each case runs on both packages, and the cycle reports (the cycle, the
held locks, the recorded violation, the graph's edges) are compared
equal: they are host data. Each package's graph is reset before and
after every test.
"""

from __future__ import annotations

import threading
import time

import pytest

from accelerate_tpu.telemetry import lockwatch as jlw
from accelerate_tpu.telemetry import watchdog as jwd
from accelerate_tpu.telemetry.registry import MetricsRegistry as JRegistry
from accelerate_tpu_torch.telemetry import lockwatch as tlw
from accelerate_tpu_torch.telemetry import watchdog as twd
from accelerate_tpu_torch.telemetry.registry import \
    MetricsRegistry as TRegistry

PKGS = {"jax": (jlw, jwd, JRegistry), "torch": (tlw, twd, TRegistry)}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))


@pytest.fixture(autouse=True)
def _clean_graph():
    for lw, _, _ in PKGS.values():
        lw.reset_lockwatch()
    yield
    for lw, _, _ in PKGS.values():
        lw.reset_lockwatch()


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()


def _invert(lw, a_name, b_name, **kw):
    """a -> b in another thread, then b -> a here: the violation."""
    a, b = lw.TrackedLock(a_name, **kw), lw.TrackedLock(b_name, **kw)

    def first():
        with a:
            with b:
                pass

    _in_thread(first)
    with pytest.raises(lw.LockOrderViolation) as exc:
        with b:
            with a:
                pass
    assert not a.locked() and not b.locked()
    return exc.value


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


@BOTH
def test_setting_gates_tracking(pkg):
    lw = PKGS[pkg][0]
    plain = lw.maybe_tracked("x", setting=False)
    assert not isinstance(plain, lw.TrackedLock)
    with plain:
        assert plain.locked()
    tracked = lw.maybe_tracked("x", setting=True)
    assert isinstance(tracked, lw.TrackedLock) and tracked.name == "x"
    assert lw.lockwatch_enabled(True) and not lw.lockwatch_enabled(False)


def test_the_port_reads_no_lockwatch_variable(monkeypatch):
    from accelerate_tpu_torch.checkpointing import _SnapshotStager
    from accelerate_tpu_torch.serving.host_tier import _HostEntry

    monkeypatch.setenv("ACCELERATE_TPU_LOCKWATCH", "1")
    assert jlw.lockwatch_enabled() and not tlw.lockwatch_enabled()
    assert isinstance(jlw.maybe_tracked("x"), jlw.TrackedLock)
    assert not isinstance(tlw.maybe_tracked("x"), tlw.TrackedLock)
    assert not isinstance(_SnapshotStager()._lock, tlw.TrackedLock)
    assert not isinstance(_HostEntry(None, None).lock, tlw.TrackedLock)


# ---------------------------------------------------------------------------
# TrackedLock
# ---------------------------------------------------------------------------


@BOTH
def test_duck_types_threading_lock(pkg):
    lock = PKGS[pkg][0].TrackedLock("t-lock")
    assert not lock.locked()
    with lock:
        assert lock.locked()
    assert not lock.locked()
    assert lock.acquire(timeout=0.5)
    lock.release()
    assert lock.acquire(blocking=False)
    lock.release()
    assert "t-lock" in repr(lock)


@BOTH
def test_nonblocking_acquire_of_held_lock_fails_fast(pkg):
    lock = PKGS[pkg][0].TrackedLock("t-held")
    lock.acquire()
    got = []
    _in_thread(lambda: got.append(lock.acquire(blocking=False)))
    assert got == [False]
    lock.release()


def test_consistent_order_records_the_same_edges():
    def run(pkg):
        lw = PKGS[pkg][0]
        a, b = lw.TrackedLock("order-a"), lw.TrackedLock("order-b")
        for _ in range(3):
            with a:
                with b:
                    pass
        state = lw.lockwatch_state()
        return state["edges"], state["violations"]

    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    edges, violations = got["torch"]
    assert edges["order-a"]["order-b"]["count"] == 3 and violations == []


def test_inversion_reports_equal_the_reference():
    def run(pkg):
        lw = PKGS[pkg][0]
        err = _invert(lw, "inv-a", "inv-b")
        (v,) = lw.lockwatch_state()["violations"]
        return err.cycle, err.held, str(err), v, err.bundle_path

    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    cycle, held, text, v, bundle = got["torch"]
    assert cycle == ["inv-b", "inv-a", "inv-b"] and held == ["inv-b"]
    assert "lock-order cycle" in text
    assert v["acquiring"] == "inv-a" and bundle is None


def test_three_lock_cycle_through_the_graph():
    def run(pkg):
        lw = PKGS[pkg][0]
        a, b, c = (lw.TrackedLock("tri-a"), lw.TrackedLock("tri-b"),
                   lw.TrackedLock("tri-c"))

        def nest(outer, inner):
            with outer:
                with inner:
                    pass

        for outer, inner in ((a, b), (b, c)):
            _in_thread(lambda o=outer, i=inner: nest(o, i))
        with pytest.raises(lw.LockOrderViolation) as exc:
            nest(c, a)
        return exc.value.cycle

    assert run("torch") == run("jax") == ["tri-c", "tri-a", "tri-b",
                                          "tri-c"]


@BOTH
def test_same_name_reacquire_is_not_a_cycle(pkg):
    lw = PKGS[pkg][0]
    a, b = lw.TrackedLock("same-name"), lw.TrackedLock("same-name")
    with a:
        with b:
            pass
    assert lw.lockwatch_state()["violations"] == []


@BOTH
def test_contention_and_held_metrics(pkg):
    lw, _, registry = PKGS[pkg]
    reg = registry()
    lock = lw.TrackedLock("metered", registry=reg)
    lock.acquire()
    started = threading.Event()

    def contender():
        started.set()
        assert lock.acquire(timeout=5)
        lock.release()

    t = threading.Thread(target=contender)
    t.start()
    started.wait(5)
    while not lock._c_contention:      # the contender found it held
        time.sleep(0.001)
    lock.release()
    t.join(timeout=5)
    snap = reg.snapshot()
    assert 'lock_contention_total{lock="metered"}' in snap["counters"]
    assert 'lock_held_seconds{lock="metered"}' in snap["histograms"]


def test_violation_writes_loadable_bundle(tmp_path):
    """The bundle's directory is the lock's `incident_dir` (the reference
    also reads its environment variable; the port does not). Each
    package's bundle is read by both loaders, with the same report."""
    reports = {}
    for pkg, (lw, wd, _) in PKGS.items():
        base = tmp_path / pkg
        base.mkdir()
        err = _invert(lw, "bndl-a", "bndl-b", incident_dir=str(base))
        (manifest,) = wd.list_incident_bundles(str(base))
        assert manifest["kind"] == "lockwatch"
        assert err.bundle_path == manifest["path"]
        for reader in (jwd, twd):
            loaded = reader.load_incident_bundle(manifest["path"])
            assert "stacks.txt" in loaded["files"]
        report = loaded["files"]["report.json"]
        reports[pkg] = {k: report[k] for k in ("kind", "watchdog", "error",
                                               "cycle", "held", "acquiring",
                                               "lock_graph")}
        reports[pkg]["lock_graph"] = {
            a: {b: e["count"] for b, e in succ.items()}
            for a, succ in reports[pkg]["lock_graph"].items()}
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["kind"] == "lock_order_violation"
    assert reports["torch"]["cycle"] == ["bndl-b", "bndl-a", "bndl-b"]


def test_registry_lock_tracked_without_recursion():
    """A tracked lock inside the metrics plumbing (the registry's own,
    `metrics=False`) sits in the ordering graph without recursing and
    without adding series to the registry it guards. The reference's
    registry takes it under its environment variable; here it is put in
    place explicitly."""
    for pkg, (lw, _, registry) in PKGS.items():
        reg = registry()
        reg._lock = lw.TrackedLock("metrics-registry", registry=reg,
                                   metrics=False)
        outer = lw.TrackedLock("outer-of-registry", registry=reg)
        with outer:
            reg.counter("some_series").inc()
        assert "metrics-registry" in lw.lockwatch_state()["edges"].get(
            "outer-of-registry", {}), pkg
        own = [k for bucket in reg.snapshot().values()
               for k in bucket if 'lock="metrics-registry"' in k]
        assert own == [], pkg


@BOTH
def test_overhead_is_bounded(pkg):
    lock = PKGS[pkg][0].TrackedLock("bench")
    t0 = time.perf_counter()
    for _ in range(10_000):
        with lock:
            pass
    assert time.perf_counter() - t0 < 2.0


def test_wired_sites_track_under_the_explicit_switch():
    """The port's wired sites name their lock classes as the
    reference's do; tracked explicitly, a forced inversion between them
    is refused and named."""
    a = tlw.maybe_tracked("checkpoint-commit", setting=True)
    b = tlw.maybe_tracked("host-tier-entry", setting=True)

    def first():
        with a:
            with b:
                pass

    _in_thread(first)
    with pytest.raises(tlw.LockOrderViolation) as exc:
        with b:
            with a:
                pass
    assert exc.value.cycle == ["host-tier-entry", "checkpoint-commit",
                               "host-tier-entry"]
