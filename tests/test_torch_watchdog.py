"""The port's stall watchdog, incident bundles and incident CLI against
the JAX package's.

- The reference's `TestStallWatchdog` and `TestIncidentBundles` cases
  (`tests/test_telemetry.py`) on both packages, on injected clocks and
  the deterministic `check()` path: the same reports, the same bundle
  files and manifests. A bundle written by either package is read by
  the other's `load_incident_bundle` and listed by its
  `list_incident_bundles`.
- The port reads no environment variable: `ACCELERATE_TPU_INCIDENT_DIR`
  arms nothing.
- `python -m accelerate_tpu_torch.commands.incident list/show` renders a
  bundle the JAX package wrote as the reference's CLI does (text equal
  once the "N s ago" age is masked), with its exit codes.
- The port's front door: `/healthz` degrades to 503 on a fired watchdog
  and an idle server with an armed watchdog stays healthy.

Every value compared here is host data: equal exactly.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from accelerate_tpu.telemetry import trace as jtrace
from accelerate_tpu.telemetry import watchdog as jwd
from accelerate_tpu.telemetry.registry import MetricsRegistry as JRegistry
from accelerate_tpu_torch.telemetry import trace as ttrace
from accelerate_tpu_torch.telemetry import watchdog as twd
from accelerate_tpu_torch.telemetry.registry import \
    MetricsRegistry as TRegistry

PKGS = {"jax": (jwd, jtrace, JRegistry), "torch": (twd, ttrace, TRegistry)}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))


class _SilentLogger:
    def error(self, *a, **k):
        pass


@pytest.fixture(autouse=True)
def _tracing_off(monkeypatch):
    monkeypatch.delenv("ACCELERATE_TPU_INCIDENT_DIR", raising=False)
    for _, trace, _ in PKGS.values():
        trace.configure_tracing(enabled=False)
        trace.clear_flight_recorder()
    yield
    for _, trace, _ in PKGS.values():
        trace.configure_tracing(enabled=False)
        trace.clear_flight_recorder()


def _watchdog(pkg, timeout=5.0, **kw):
    now = [0.0]
    kw.setdefault("logger", _SilentLogger())
    return PKGS[pkg][0].StallWatchdog(timeout, clock=lambda: now[0],
                                      **kw), now


# ---------------------------------------------------------------------------
# the stall watchdog
# ---------------------------------------------------------------------------


@BOTH
def test_missed_heartbeat_fires_exactly_once_with_payload(pkg):
    _, trace, _ = PKGS[pkg]
    trace.configure_tracing(enabled=True, annotate=False)
    with trace.span("last-thing-before-hang"):
        pass
    reports = []
    wd, now = _watchdog(pkg, 10.0, on_stall=reports.append)
    wd.tick()
    now[0] = 9.0
    assert wd.check() is None
    now[0] = 11.0
    report = wd.check()
    assert report is not None and reports == [report]
    assert wd.check() is None
    now[0] = 500.0
    assert wd.check() is None
    assert any("test_torch_watchdog" in "".join(stack)
               for stack in report["stacks"].values())
    assert isinstance(report["device_memory_stats"], dict)
    assert [e["name"] for e in report["flight_recorder"]] == [
        "last-thing-before-hang"]
    assert report["silence_s"] == pytest.approx(11.0)


def test_reports_have_the_same_shape():
    """The same silence gives the same report keys and scalars."""
    def run(pkg):
        wd, now = _watchdog(pkg, 5.0, name="unit")
        now[0] = 6.0
        r = wd.check()
        return sorted(r), {k: r[k] for k in ("watchdog", "silence_s",
                                             "timeout_s", "stall_count")}

    assert run("torch") == run("jax")


@BOTH
def test_tick_rearms_for_the_next_stall(pkg):
    wd, now = _watchdog(pkg)
    now[0] = 6.0
    assert wd.check() is not None and wd.stalled
    wd.tick()
    assert not wd.stalled
    now[0] = 8.0
    assert wd.check() is None
    now[0] = 12.0
    assert wd.check() is not None
    assert wd.stall_count == 2


@BOTH
def test_raise_on_stall(pkg):
    wd, now = _watchdog(pkg, 1.0, raise_on_stall=True)
    now[0] = 2.0
    with pytest.raises(PKGS[pkg][0].StallError):
        wd.check()


@BOTH
def test_background_thread_fires_on_silence(pkg):
    """The checker thread on an injected clock: silent while ticked, it
    fires once the clock passes the timeout; stop() joins it."""
    fired = threading.Event()
    wd, now = _watchdog(pkg, 5.0, poll_interval_s=0.01,
                        on_stall=lambda r: fired.set())
    with wd:
        wd.tick()
        assert not fired.wait(timeout=0.05)
        now[0] = 6.0
        assert fired.wait(timeout=5.0)
    assert wd._thread is None


@BOTH
def test_rejects_nonpositive_timeout(pkg):
    with pytest.raises(ValueError):
        PKGS[pkg][0].StallWatchdog(0.0)


# ---------------------------------------------------------------------------
# incident bundles
# ---------------------------------------------------------------------------


def _fire(pkg, base, dumps=None, registry=None):
    wd, now = _watchdog(pkg, incident_dir=str(base), registry=registry,
                        dumps=dumps, name="unit")
    now[0] = 6.0
    return wd.check()


@BOTH
def test_stall_writes_complete_bundle(pkg, tmp_path):
    mod, trace, registry = PKGS[pkg]
    trace.configure_tracing(enabled=True, annotate=False)
    with trace.span("last-act"):
        pass
    r = registry()
    r.counter("serving_tokens_out_total").inc(7)
    report = _fire(pkg, tmp_path, registry=r,
                   dumps=lambda: {"scheduler": {"queue_depth": 2}})
    path = report["bundle_path"]
    files = sorted(os.listdir(path))
    assert files == ["device_memory.json", "manifest.json", "metrics.json",
                     "metrics.prom", "report.json", "scheduler.json",
                     "stacks.txt", "trace.json"]
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["version"] == 1 and manifest["kind"] == "unit"
    assert manifest["silence_s"] == pytest.approx(6.0)
    assert set(manifest["files"]) == set(files) - {"manifest.json"}
    trace_doc = json.load(open(os.path.join(path, "trace.json")))
    assert any(e["name"] == "last-act" for e in trace_doc["traceEvents"])
    assert json.load(open(os.path.join(path, "scheduler.json"))) == {
        "queue_depth": 2}
    prom = open(os.path.join(path, "metrics.prom")).read()
    assert "serving_tokens_out_total 7.0" in prom
    assert os.path.basename(path).startswith("incident-")


def test_bundles_cross_read(tmp_path):
    """Each package's bundle, loaded by the other package: the same
    manifest fields and the same file list; both list both."""
    paths = {}
    for pkg in PKGS:
        r = PKGS[pkg][2]()
        r.counter("alive_total").inc()
        paths[pkg] = _fire(pkg, tmp_path, registry=r,
                           dumps=lambda: {"pages": {"free": 3}})[
                               "bundle_path"]
    for writer, path in paths.items():
        mine = PKGS[writer][0].load_incident_bundle(path)
        for reader in PKGS:
            got = PKGS[reader][0].load_incident_bundle(path)
            assert got["manifest"] == mine["manifest"]
            assert sorted(got["files"]) == sorted(mine["files"])
            assert got["files"]["pages.json"] == {"free": 3}
    assert sorted(m["path"] for m in twd.list_incident_bundles(
        str(tmp_path))) == sorted(m["path"] for m in jwd.list_incident_bundles(
            str(tmp_path))) == sorted(paths.values())
    m = {pkg: PKGS[pkg][0].load_incident_bundle(p)["manifest"]
         for pkg, p in paths.items()}
    assert sorted(m["torch"]) == sorted(m["jax"])
    assert m["torch"]["files"] == m["jax"]["files"]


@BOTH
def test_no_incident_dir_means_no_bundle(pkg, tmp_path):
    wd, now = _watchdog(pkg)
    now[0] = 6.0
    assert "bundle_path" not in wd.check()
    assert os.listdir(tmp_path) == []


def test_the_port_reads_no_incident_dir_variable(tmp_path, monkeypatch):
    """The reference arms bundles from ACCELERATE_TPU_INCIDENT_DIR; the
    port takes the directory only as an argument."""
    monkeypatch.setenv("ACCELERATE_TPU_INCIDENT_DIR", str(tmp_path))
    jw, jnow = _watchdog("jax")
    tw, tnow = _watchdog("torch")
    assert jw.incident_dir == str(tmp_path) and tw.incident_dir is None
    tnow[0] = 6.0
    assert "bundle_path" not in tw.check()
    assert os.listdir(tmp_path) == []
    assert twd.resolve_incident_dir(None) is None
    assert twd.resolve_stall_timeout(None) is None


@BOTH
def test_dumps_failure_costs_only_the_dump_files(pkg, tmp_path):
    r = PKGS[pkg][2]()
    r.counter("alive_total").inc()

    def exploding_dumps():
        raise RuntimeError("deque mutated during iteration")

    report = _fire(pkg, tmp_path, registry=r, dumps=exploding_dumps)
    files = set(os.listdir(report["bundle_path"]))
    assert {"manifest.json", "report.json", "stacks.txt", "trace.json",
            "metrics.json", "dumps_error.json"} <= files
    err = json.load(open(os.path.join(report["bundle_path"],
                                      "dumps_error.json")))
    assert "deque mutated" in err["error"]


@BOTH
def test_bundle_failure_does_not_mask_the_report(pkg, tmp_path):
    bad = tmp_path / "file-not-dir"
    bad.write_text("x")
    report = _fire(pkg, bad)
    assert report is not None and "bundle_error" in report


@BOTH
def test_exception_report_shape(pkg, tmp_path):
    mod = PKGS[pkg][0]
    try:
        raise RuntimeError("drive loop died")
    except RuntimeError as e:
        report = mod.build_exception_report(e, name="drive-loop")
    assert "drive loop died" in report["error"]
    assert any("drive loop died" in ln for ln in report["traceback"])
    assert report["stacks"]
    path = mod.write_incident_bundle(str(tmp_path), report,
                                     name="drive-loop")
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["kind"] == "drive-loop"
    assert "drive loop died" in manifest["error"]


@BOTH
def test_same_second_bundles_get_distinct_dirs(pkg, tmp_path):
    mod = PKGS[pkg][0]
    p1 = mod.write_incident_bundle(str(tmp_path), {"stacks": {}}, name="x")
    p2 = mod.write_incident_bundle(str(tmp_path), {"stacks": {}}, name="x")
    assert p1 != p2 and os.path.isdir(p1) and os.path.isdir(p2)


# ---------------------------------------------------------------------------
# the incident CLI
# ---------------------------------------------------------------------------

_AGE = re.compile(r"\(?\d+(\.\d+)?[smh] ago\)?")


def _cli(pkg, args, capsys):
    if pkg == "jax":
        from accelerate_tpu.commands.accelerate_cli import main

        rc = main(["incident", *args])
    else:
        from accelerate_tpu_torch.commands.incident import main

        rc = main(args)
    out = capsys.readouterr()
    return rc, _AGE.sub("AGE", out.out)


@pytest.fixture
def jax_bundle(tmp_path):
    """A stall bundle the JAX package wrote, with a flight-recorder tail
    and a cost table."""
    report = {"silence_s": 7.5, "stacks": {"MainThread-1": ["  fake\n"]},
              "flight_recorder": [
                  {"name": "serving.decode", "dur_ns": 1000,
                   "trace_id": "ab" * 16, "span_id": 1, "parent_id": 0}]}
    table = {"programs": {"decode": {"name": "decode", "flops": 2e9,
                                     "bytes_accessed": 1e9,
                                     "source": "analytic", "calls": 9}},
             "rooflines": {"decode": {"device_time_mean_s": 0.01,
                                      "mfu": 0.2,
                                      "mxu_idle_fraction": 0.8}}}
    path = jwd.write_incident_bundle(str(tmp_path), report, name="stall",
                                     dumps={"cost_table": table})
    return tmp_path, path


@pytest.mark.parametrize("args", [
    ["list"], ["list", "--format", "json"], ["show", "0"],
    ["show", "NAME"], ["show", "PATH"], ["show", "0", "--format", "json"],
    ["show", "nope"]],
    ids=["list", "list_json", "show_index", "show_name", "show_path",
         "show_json", "show_missing"])
def test_incident_cli_renders_a_jax_bundle_as_the_reference(
        jax_bundle, args, capsys):
    base, path = jax_bundle
    args = [{"NAME": os.path.basename(path), "PATH": path}.get(a, a)
            for a in args] + ["--dir", str(base)]
    got = _cli("torch", args, capsys)
    assert got == _cli("jax", args, capsys)
    if args[0] == "show" and args[1] != "nope":
        assert got[0] == 0
        if "json" not in args:
            assert "silence  7.5s" in got[1]
            assert "serving.decode" in got[1]
            assert "device cost (per call):" in got[1]


def test_incident_cli_exit_codes(tmp_path, capsys):
    from accelerate_tpu_torch.commands.incident import main

    assert main(["list", "--dir", str(tmp_path)]) == 1
    assert main(["list"]) == 2
    assert main([]) == 2
    assert main(["show", "0", "--dir", str(tmp_path)]) == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the front door's health on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_engine_parts():
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    return llama, cfg, llama.init_params(cfg, 0, device="cpu")


def _door(parts, **ec):
    from accelerate_tpu_torch.server import (
        HttpFrontDoor, InferenceService, ServerConfig, get_tokenizer)
    from accelerate_tpu_torch.serving import Engine, EngineConfig

    llama, cfg, params = parts
    eng = Engine(llama, cfg, params, EngineConfig(
        cache_dtype=torch.float32, num_slots=2, max_len=64,
        prefill_chunk=8, **ec), device="cpu")
    door = HttpFrontDoor(InferenceService(
        eng, get_tokenizer("auto", cfg.vocab_size), ServerConfig(port=0)))
    return door, eng


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n"
                 "Content-Length: 0\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body


def _serve(door, scenario):
    async def run():
        await door.start()
        try:
            return await scenario(door.port)
        finally:
            await door.stop()

    return asyncio.run(run())


def test_healthz_degrades_when_watchdog_fires(tiny_engine_parts):
    door, eng = _door(tiny_engine_parts)
    wd, now = _watchdog("torch")

    async def scenario(port):
        eng.watchdog = wd
        st, _ = await _get(port, "/healthz")
        assert st == 200
        now[0] = 100.0
        wd.check()
        st, body = await _get(port, "/healthz")
        assert st == 503 and b"watchdog" in body
        wd.tick()
        st, _ = await _get(port, "/healthz")
        assert st == 200

    _serve(door, scenario)


def test_idle_server_with_armed_watchdog_stays_healthy(tiny_engine_parts):
    """The drive loop ticks the watchdog while it waits for work, so an
    idle server never reads as stalled; a request still streams."""
    door, eng = _door(tiny_engine_parts, watchdog_timeout_s=0.2)
    assert eng.watchdog is not None

    async def scenario(port):
        st, _ = await _get(port, "/healthz")
        assert st == 200
        await asyncio.sleep(0.6)  # three timeouts, zero traffic
        st, body = await _get(port, "/healthz")
        assert st == 200, body
        return eng.watchdog.stall_count

    assert _serve(door, scenario) == 0
    assert eng.watchdog is None  # door.stop() closed the engine


def test_drive_loop_death_writes_a_drive_loop_bundle(tiny_engine_parts,
                                                     tmp_path):
    """A step that raises ends the drive loop; with an incident_dir the
    service writes the reference's `drive-loop` bundle, engine dumps and
    cost table included."""
    door, eng = _door(tiny_engine_parts, incident_dir=str(tmp_path))

    def broken_step():
        raise RuntimeError("device lost")

    async def scenario(port):
        eng.step = broken_step
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
        door.service._wake.set()
        for _ in range(200):
            if door.service._drive_error is not None:
                break
            await asyncio.sleep(0)
        st, _ = await _get(port, "/healthz")
        return st

    assert _serve(door, scenario) == 503
    (manifest,) = twd.list_incident_bundles(str(tmp_path))
    assert manifest["kind"] == "drive-loop"
    loaded = jwd.load_incident_bundle(manifest["path"])
    assert "device lost" in loaded["manifest"]["error"]
    assert {"cost_table.json", "scheduler.json", "metrics.prom"} <= set(
        loaded["files"])


def test_sanitizer_violation_writes_a_sanitizer_bundle(tiny_engine_parts,
                                                       tmp_path):
    """With an incident_dir, a sanitizer violation first writes the
    reference's `sanitizer` bundle (the check, the engine's dumps and
    its cost table), then raises."""
    from accelerate_tpu_torch.serving import SanitizerViolation

    _, eng = _door(tiny_engine_parts, sanitize=True,
                   incident_dir=str(tmp_path))
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    eng.run_until_idle()
    eng._table[0, 0] = 0             # a retired lane's row names page 0
    with pytest.raises(SanitizerViolation) as err:
        eng.step()
    (manifest,) = twd.list_incident_bundles(str(tmp_path))
    assert manifest["kind"] == "sanitizer"
    loaded = jwd.load_incident_bundle(manifest["path"])
    assert loaded["files"]["report.json"]["check"] == err.value.check
    assert {"cost_table.json", "pages.json", "stacks.txt"} <= set(
        loaded["files"])
    eng.close()
