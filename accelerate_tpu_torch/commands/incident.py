"""`python -m accelerate_tpu_torch.commands.incident` — list and inspect
incident bundles (port of `accelerate_tpu/commands/incident.py`).

The stall watchdog, the server's drive loop on death, the sanitizer and
the straggler monitor write one self-contained bundle directory per
incident under the component's `incident_dir`: manifest, full report,
all-thread stacks, flight-recorder chrome trace, metrics snapshot, the
CUDA allocator's statistics, and the serving engine's scheduler/slot/
page dumps and device-cost table. The bundle format is the reference's,
so either package's bundles render here.

    python -m accelerate_tpu_torch.commands.incident list --dir D [--format json]
    python -m accelerate_tpu_torch.commands.incident show BUNDLE --dir D [--format json]

`show` accepts a bundle directory path, a bundle name under --dir, or an
index from `list` (0 = newest). Exit codes: 0 ok, 1 nothing to show,
2 bad arguments / missing bundle. The port reads no environment
variable: without `--dir` the command exits 2. It touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..telemetry.watchdog import (
    list_incident_bundles,
    load_incident_bundle,
    resolve_incident_dir,
)

__all__ = ["build_parser", "main", "run_incident"]


def build_parser() -> argparse.ArgumentParser:
    """The reference's `incident` subcommand, as its own program."""
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.incident",
        description="Inspect the self-contained incident bundles the "
                    "stall watchdog and the serve drive loop write.")
    sub = parser.add_subparsers(dest="incident_cmd")
    common = dict(default=None, metavar="DIR",
                  help="bundle directory root")
    lp = sub.add_parser("list", help="summarize every bundle, newest first")
    lp.add_argument("--dir", **common)
    lp.add_argument("--format", choices=("text", "json"), default="text")
    sp = sub.add_parser("show", help="render one bundle")
    sp.add_argument("bundle",
                    help="bundle path, name under --dir, or list index "
                         "(0 = newest)")
    sp.add_argument("--dir", **common)
    sp.add_argument("--format", choices=("text", "json"), default="text")
    return parser


def _age(created_at: float | None) -> str:
    if not created_at:
        return "?"
    dt = max(0.0, time.time() - created_at)
    if dt < 120:
        return f"{dt:.0f}s ago"
    if dt < 7200:
        return f"{dt / 60:.0f}m ago"
    return f"{dt / 3600:.1f}h ago"


def run_incident(args: argparse.Namespace) -> int:
    if getattr(args, "incident_cmd", None) is None:
        print("incident: specify 'list' or 'show' (--help)",
              file=sys.stderr)
        return 2
    base = resolve_incident_dir(args.dir)
    if base is None:
        print("incident: no bundle directory — pass --dir",
              file=sys.stderr)
        return 2
    if args.incident_cmd == "list":
        return _run_list(base, args.format)
    return _run_show(base, args.bundle, args.format)


def _run_list(base: str, fmt: str) -> int:
    bundles = list_incident_bundles(base)
    if fmt == "json":
        print(json.dumps(bundles, indent=2, default=str))
        return 0 if bundles else 1
    if not bundles:
        print(f"no incident bundles under {base}")
        return 1
    for i, m in enumerate(bundles):
        silence = m.get("silence_s")
        what = (f"silence {silence:.1f}s" if isinstance(silence, (int, float))
                else (m.get("error") or m.get("kind", "?")))
        print(f"[{i}] {os.path.basename(m['path'])}  "
              f"{_age(m.get('created_at'))}  kind={m.get('kind', '?')}  "
              f"{what}  files={len(m.get('files', []))}")
    return 0


def _resolve_bundle(base: str, ref: str) -> str | None:
    if os.path.isdir(ref) and os.path.isfile(
            os.path.join(ref, "manifest.json")):
        return ref
    named = os.path.join(base, ref)
    if os.path.isdir(named) and os.path.isfile(
            os.path.join(named, "manifest.json")):
        return named
    if ref.isdigit():
        bundles = list_incident_bundles(base)
        idx = int(ref)
        if idx < len(bundles):
            return bundles[idx]["path"]
    return None


def _run_show(base: str, ref: str, fmt: str) -> int:
    path = _resolve_bundle(base, ref)
    if path is None:
        print(f"incident: no bundle {ref!r} under {base} "
              "(try `list`)", file=sys.stderr)
        return 2
    bundle = load_incident_bundle(path)
    if fmt == "json":
        print(json.dumps(bundle, indent=2, default=str))
        return 0
    m = bundle["manifest"]
    files = bundle["files"]
    print(f"bundle   {path}")
    print(f"kind     {m.get('kind', '?')}")
    print(f"created  {m.get('created_at_utc', '?')} UTC "
          f"({_age(m.get('created_at'))})")
    if m.get("silence_s") is not None:
        print(f"silence  {m['silence_s']:.1f}s")
    report = files.get("report.json") or {}
    if report.get("error"):
        print(f"error    {report['error']}")
    stacks = report.get("stacks") or {}
    if stacks:
        print(f"threads  {len(stacks)}: {', '.join(sorted(stacks))}")
    tail = report.get("flight_recorder") or []
    if tail:
        print(f"flight recorder (last {min(len(tail), 8)} of "
              f"{len(tail)} spans):")
        for e in tail[-8:]:
            print(f"  {e.get('name')} dur={e.get('dur_ns', 0) / 1e6:.3f}ms"
                  f" trace={e.get('trace_id')}")
    cost = files.get("cost_table.json") or {}
    programs = cost.get("programs") or {}
    if programs:
        # what the device was DOING with its time, frozen at the
        # incident: per-program FLOPs/bytes + measured device time
        print("device cost (per call):")
        rooflines = cost.get("rooflines") or {}
        for name in sorted(programs):
            p = programs[name]
            sheet = rooflines.get(name) or {}
            line = (f"  {name}: {p.get('flops', 0) / 1e6:.2f} MFLOP, "
                    f"{p.get('bytes_accessed', 0) / 1e6:.2f} MB "
                    f"[{p.get('source', '?')}], calls={p.get('calls', 0)}")
            mean = sheet.get("device_time_mean_s")
            if isinstance(mean, (int, float)):
                line += f", device {mean * 1e3:.3f} ms"
            mfu = sheet.get("mfu")
            if isinstance(mfu, (int, float)):
                line += (f", mfu {mfu:.4f} "
                         f"(idle {sheet.get('mxu_idle_fraction', 0):.3f})")
            print(line)
    _render_fleet(path, files)
    metrics = files.get("metrics.json") or {}
    counters = metrics.get("counters") or {}
    if counters:
        print("counters:")
        for k in sorted(counters)[:12]:
            print(f"  {k} = {counters[k]:g}")
        if len(counters) > 12:
            print(f"  ... {len(counters) - 12} more (see metrics.json)")
    for extra in ("scheduler.json", "requests.json", "pages.json"):
        if extra in files:
            print(f"{extra[:-5]}: see {os.path.join(path, extra)}")
    print(f"files    {', '.join(m.get('files', []))}")
    if m.get("write_errors"):
        print(f"warnings {m['write_errors']}")
    return 0


def _render_fleet(path: str, files: dict) -> None:
    """The fleet half of a pod incident bundle: per-worker clock offsets,
    each worker's own dumps (or the honest hole where an unreachable
    worker should be), and the merged per-request chrome traces."""
    offsets = files.get("clock_offsets.json") or {}
    if offsets:
        print("fleet clock offsets (router - worker, +-rtt/2):")
        for wid in sorted(offsets, key=str):
            o = offsets[wid] if isinstance(offsets[wid], dict) else {}
            off, rtt = o.get("offset_s"), o.get("rtt_s")
            state = ("lost" if o.get("lost")
                     else "alive" if o.get("alive") else "joining")
            line = f"  worker {wid} [{o.get('role', '?')}/{state}]"
            if isinstance(off, (int, float)):
                line += f" offset {off * 1e3:+.3f}ms"
            if isinstance(rtt, (int, float)):
                line += f" rtt {rtt * 1e3:.3f}ms"
            hb = o.get("heartbeat_age_s")
            if isinstance(hb, (int, float)):
                line += f" heartbeat {hb:.2f}s ago"
            print(line)
    workers = sorted(f for f in files
                     if f.startswith("worker_") and f.endswith(".json"))
    for fname in workers:
        wd = files[fname] if isinstance(files[fname], dict) else {}
        label = fname[len("worker_"):-len(".json")]
        if "worker_error" in wd:
            print(f"worker {label}: UNREACHABLE — {wd['worker_error']}")
            continue
        jobs = wd.get("jobs")
        line = (f"worker {label} [{wd.get('role', '?')}"
                f"{' draining' if wd.get('draining') else ''}]"
                f" pid={wd.get('pid', '?')}")
        if isinstance(jobs, list):
            line += f" jobs={len(jobs)}"
        engine = wd.get("engine")
        if isinstance(engine, dict):
            line += f" engine_dumps={','.join(sorted(engine))}"
        print(line + f"  (see {os.path.join(path, fname)})")
    traces = files.get("flights_trace.json") or {}
    if traces:
        print(f"in-flight traces ({len(traces)} merged, worker spans "
              "rebased to router time):")
        for tid in sorted(traces, key=str):
            doc = traces[tid] if isinstance(traces[tid], dict) else {}
            events = doc.get("traceEvents") or []
            pids = sorted({e.get("pid") for e in events
                           if isinstance(e, dict)}, key=str)
            print(f"  {tid}: {len(events)} spans across "
                  f"{len(pids)} process(es) — load flights_trace.json "
                  "in Perfetto")


def main(argv=None) -> int:
    return run_incident(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
