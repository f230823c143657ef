"""`python -m accelerate_tpu_torch.commands.pod pod-router|pod-worker`:
the multi-process pod as real OS processes (port of
`accelerate_tpu/commands/pod.py`, `accelerate-tpu pod-router` /
`pod-worker`).

`pod-worker` builds one role-agnostic engine from a JSON spec, dials the
router's channel listener over TCP and pumps `WorkerServer.run()`;
SIGTERM drains (finish in-flight jobs, say `bye`, exit 0), as `serve`
does. `pod-router` binds the worker listener plus the ordinary HTTP
front door, spawns the requested workers as subprocesses of this same
module (or waits for externally launched ones with `--no-spawn`), and
serves the OpenAI routes over `DistributedPodRouter`. SIGTERM drains the
front door and the workers, reaps them, prints their exit codes and
exits 0.

Both processes build their model through `build_worker_engine`'s spec
dict, so family and seed pin identical params across the pod. The
reference's flags, plus one, `--device`: workers run their engines on
the CUDA device unless `--device cpu` is given (the router passes it on
to the workers it spawns; it holds no model itself).

`--dry-run` validates the configuration and prints the reference's JSON
line without binding or spawning anything.

Importing this module parses nothing and starts nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["build_parser", "main", "spawn_socket_workers"]

_ROLES = ("prefill", "decode")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.pod",
        description="A disaggregated serving pod as OS processes.")
    subparsers = parser.add_subparsers(dest="command", required=True)
    worker = subparsers.add_parser(
        "pod-worker",
        help="one prefill/decode engine process of a distributed pod",
        description=(
            "Connect to a pod-router channel listener, build the engine "
            "described by --engine-json and serve prefill/decode jobs "
            "until drained. SIGTERM drains gracefully."
        ),
    )
    worker.add_argument("--connect", required=True, metavar="HOST:PORT",
                        help="pod-router listener to dial")
    worker.add_argument("--worker-id", type=int, required=True)
    worker.add_argument("--role", default="decode", choices=_ROLES,
                        help="starting role; the router may convert it")
    worker.add_argument(
        "--engine-json", default="{}", metavar="JSON",
        help="engine spec dict (keys: family, seed, num_slots, max_len, "
             "prefill_chunk, page_size, max_queue, cache_dtype, "
             "kv_dtype, prefix_cache); MUST match the router's")
    worker.add_argument("--heartbeat-interval-s", type=float, default=0.25)
    worker.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the engine runs (default: the CUDA device)")
    worker.set_defaults(func=run_pod_worker)

    router = subparsers.add_parser(
        "pod-router",
        help="HTTP front door over a multi-process disaggregated pod",
        description=(
            "Bind the worker channel listener and the OpenAI-compatible "
            "HTTP server, spawn (or await) pod workers, route prefill->"
            "decode via KV page shipments with failure recovery and "
            "elastic rebalancing."
        ),
    )
    router.add_argument("--host", default="127.0.0.1")
    router.add_argument("--port", type=int, default=8000,
                        help="HTTP port; 0 binds an ephemeral port")
    router.add_argument("--listen", default="127.0.0.1:0",
                        metavar="HOST:PORT",
                        help="worker channel listener bind (port 0 = "
                             "ephemeral, printed on start)")
    router.add_argument("--family", default="gpt2",
                        choices=("llama", "gpt2"))
    router.add_argument("--model-id", default=None)
    router.add_argument("--tokenizer", default="auto",
                        choices=("auto", "byte", "numeric"))
    router.add_argument("--slots", type=int, default=4,
                        help="slots PER WORKER")
    router.add_argument("--max-len", type=int, default=512)
    router.add_argument("--prefill-chunk", type=int, default=32)
    router.add_argument("--max-queue", type=int, default=64)
    router.add_argument("--page-size", type=int, default=16)
    router.add_argument("--cache-dtype", default="float32",
                        choices=("float32", "bfloat16"))
    router.add_argument("--kv-dtype", default=None,
                        choices=("int8",),
                        help="quantize shipped KV pages")
    router.add_argument("--no-prefix-cache", action="store_true")
    router.add_argument("--seed", type=int, default=0)
    router.add_argument("--prefill-workers", type=int, default=1)
    router.add_argument("--decode-workers", type=int, default=1)
    router.add_argument("--heartbeat-interval-s", type=float, default=0.25)
    # a worker announces `busy` before a program's first run and long
    # device blocks, and a busy worker gets the long silence budget, so
    # this one can stay tight (dropped connections are caught at once)
    router.add_argument("--heartbeat-timeout-s", type=float, default=10.0)
    router.add_argument("--flight-timeout-s", type=float, default=60.0)
    router.add_argument("--no-rebalance", action="store_true",
                        help="disable elastic role conversion")
    router.add_argument(
        "--no-spawn", action="store_true",
        help="do not spawn worker subprocesses; wait for externally "
             "launched `pod-worker`s to dial --listen instead")
    router.add_argument("--worker-wait-s", type=float, default=120.0,
                        help="how long to wait for all workers' hellos "
                             "before giving up")
    router.add_argument("--default-max-tokens", type=int, default=16)
    router.add_argument("--drain-timeout-s", type=float, default=30.0)
    router.add_argument("--debug-endpoints", action="store_true")
    router.add_argument(
        "--dry-run", action="store_true",
        help="validate the full configuration, print it as one JSON "
             "line, exit without binding or spawning anything")
    router.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the spawned workers run (default: the CUDA device)")
    router.set_defaults(func=run_pod_router)
    return parser


def _hostport(value: str) -> tuple[str, int]:
    host, _, port = value.rpartition(":")
    if not host or not port:
        raise ValueError(f"expected HOST:PORT, got {value!r}")
    return host, int(port)


def _engine_spec(args: argparse.Namespace) -> dict:
    """The JSON-safe spec shared verbatim with every spawned worker."""
    return {
        "family": args.family,
        "seed": args.seed,
        "num_slots": args.slots,
        "max_len": args.max_len,
        "prefill_chunk": args.prefill_chunk,
        "page_size": args.page_size,
        "max_queue": args.max_queue,
        "cache_dtype": args.cache_dtype,
        "kv_dtype": args.kv_dtype,
        "prefix_cache": not args.no_prefix_cache,
    }


# ---------------------------------------------------------------------------
# pod-worker
# ---------------------------------------------------------------------------


def run_pod_worker(args: argparse.Namespace) -> int:
    try:
        host, port = _hostport(args.connect)
        spec = json.loads(args.engine_json)
        if not isinstance(spec, dict):
            raise ValueError("--engine-json must be a JSON object")
    except ValueError as e:
        print(f"pod-worker: {e}", file=sys.stderr)
        return 2

    import torch

    from ..serving.pod.distributed.transport import SocketChannel
    from ..serving.pod.distributed.worker import (
        WorkerServer,
        build_worker_engine,
    )

    torch.set_grad_enabled(False)
    device = None if args.device == "cuda" else "cpu"
    _family, _cfg, _params, engine = build_worker_engine(spec, device=device)
    channel = SocketChannel.connect(host, port)
    server = WorkerServer(
        engine, channel, worker_id=args.worker_id, role=args.role,
        heartbeat_interval_s=args.heartbeat_interval_s)

    import signal

    def _request_drain(signum, frame):
        # as `serve`: orchestrators say "drain" with SIGTERM — finish
        # in-flight jobs, send `bye`, exit 0
        server.draining = True

    try:
        signal.signal(signal.SIGTERM, _request_drain)
        signal.signal(signal.SIGINT, _request_drain)
    except ValueError:
        pass  # not the main thread
    print(f"pod-worker {args.worker_id} ({args.role}) connected to "
          f"{host}:{port}", file=sys.stderr, flush=True)
    server.run()
    channel.close()
    print(f"pod-worker {args.worker_id}: drained and stopped",
          file=sys.stderr, flush=True)
    return 0


def spawn_socket_workers(port: int, spec: dict, roles: list[str], *,
                         host: str = "127.0.0.1",
                         heartbeat_interval_s: float = 0.25,
                         device: str = "cuda",
                         env: dict | None = None, stderr=None) -> list:
    """Popen one `pod-worker` process of this module per role, dialing
    host:port, with the package's parent directory on its path. The
    caller owns the returned Popen handles."""
    import subprocess

    env = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = []
    for wid, role in enumerate(roles):
        cmd = [
            sys.executable, "-m", "accelerate_tpu_torch.commands.pod",
            "pod-worker",
            "--connect", f"{host}:{port}",
            "--worker-id", str(wid),
            "--role", role,
            "--engine-json", json.dumps(spec),
            "--heartbeat-interval-s", str(heartbeat_interval_s),
            "--device", device,
        ]
        procs.append(subprocess.Popen(cmd, env=env, stderr=stderr))
    return procs


# ---------------------------------------------------------------------------
# pod-router
# ---------------------------------------------------------------------------


def run_pod_router(args: argparse.Namespace) -> int:
    try:
        listen_host, listen_port = _hostport(args.listen)
        if args.prefill_workers < 1 or args.decode_workers < 1:
            raise ValueError("need at least 1 prefill and 1 decode worker")
        if args.heartbeat_timeout_s <= args.heartbeat_interval_s:
            raise ValueError("heartbeat timeout must exceed the interval")
    except ValueError as e:
        print(f"pod-router: {e}", file=sys.stderr)
        return 2
    spec = _engine_spec(args)
    roles = (["prefill"] * args.prefill_workers
             + ["decode"] * args.decode_workers)
    if args.dry_run:
        print(json.dumps({
            "dry_run": True,
            "family": args.family,
            "model_id": args.model_id or args.family,
            "bind": f"{args.host}:{args.port}",
            "listen": f"{listen_host}:{listen_port}",
            "transport": "socket",
            "workers": roles,
            "spawn": not args.no_spawn,
            "engine": spec,
            "pod": {
                "heartbeat_interval_s": args.heartbeat_interval_s,
                "heartbeat_timeout_s": args.heartbeat_timeout_s,
                "flight_timeout_s": args.flight_timeout_s,
                "rebalance": not args.no_rebalance,
            },
            "routes": ["/v1/completions", "/v1/chat/completions",
                       "/v1/models", "/healthz", "/metrics"],
        }))
        return 0
    return _pod_router_blocking(args, spec, roles, listen_host, listen_port)


def _pod_router_blocking(args, spec, roles, listen_host,
                         listen_port) -> int:
    import asyncio

    from ..server.config import ServerConfig
    from ..server.http import HttpFrontDoor
    from ..server.service import InferenceService
    from ..server.tokenizer import get_tokenizer
    from ..serving.pod.distributed import (
        ChannelListener,
        DistributedPodConfig,
        DistributedPodRouter,
    )
    from ..serving.pod.distributed.worker import engine_config_from_spec

    if args.family == "llama":
        from ..models import llama as family

        cfg = family.LlamaConfig.tiny()
    else:
        from ..models import gpt2 as family

        cfg = family.GPT2Config.tiny()

    listener = ChannelListener(listen_host, listen_port)
    print(f"pod-router: worker listener on {listen_host}:{listener.port}",
          file=sys.stderr, flush=True)
    procs = []
    if not args.no_spawn:
        procs = spawn_socket_workers(
            listener.port, spec, roles, host=listen_host,
            heartbeat_interval_s=args.heartbeat_interval_s,
            device=args.device)
    router = DistributedPodRouter(
        engine_config=engine_config_from_spec(spec),
        pod_config=DistributedPodConfig(
            prefill_workers=args.prefill_workers,
            decode_workers=args.decode_workers,
            heartbeat_interval_s=args.heartbeat_interval_s,
            heartbeat_timeout_s=args.heartbeat_timeout_s,
            flight_timeout_s=args.flight_timeout_s,
            rebalance=not args.no_rebalance),
        listener=listener)
    try:
        _await_workers(router, len(roles), args.worker_wait_s, procs)
    except TimeoutError as e:
        print(f"pod-router: {e}", file=sys.stderr, flush=True)
        router.close()
        _reap(procs)
        return 1

    server_cfg = ServerConfig(
        host=args.host, port=args.port,
        model_id=args.model_id or args.family,
        tokenizer=args.tokenizer,
        default_max_tokens=args.default_max_tokens,
        drain_timeout_s=args.drain_timeout_s,
        debug_endpoints=args.debug_endpoints,
    )
    tokenizer = get_tokenizer(server_cfg.tokenizer, cfg.vocab_size)
    service = InferenceService(router, tokenizer, server_cfg)
    door = HttpFrontDoor(service, server_cfg)

    async def _run() -> None:
        import signal

        await door.start()
        print(f"pod-router: serving {server_cfg.model_id} on "
              f"{server_cfg.host}:{door.port} "
              f"({len(router.workers)} workers)", file=sys.stderr,
              flush=True)
        stop_requested = asyncio.Event()
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, stop_requested.set)
            loop.add_signal_handler(signal.SIGINT, stop_requested.set)
        except (NotImplementedError, RuntimeError):
            pass

        async def _pump() -> None:
            # the service drive loop only steps while the scheduler has
            # work; heartbeats, failure detection and rebalance need the
            # router pumped on an idle pod too
            period = max(0.01, args.heartbeat_interval_s / 2.0)
            while True:
                router.step()
                await asyncio.sleep(period)

        serve_task = loop.create_task(door.serve_forever())
        pump_task = loop.create_task(_pump())
        stop_task = loop.create_task(stop_requested.wait())
        try:
            await asyncio.wait({serve_task, stop_task},
                               return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            pass
        finally:
            for t in (serve_task, pump_task, stop_task):
                t.cancel()
            print("pod-router: draining...", file=sys.stderr, flush=True)
            await door.stop()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    finally:
        router.close()   # drains workers, closes channels + listener
        rcs = _reap(procs)
    print(f"pod-router: worker exit codes {rcs}", file=sys.stderr)
    print("pod-router: drained and stopped", file=sys.stderr, flush=True)
    return 0


def _await_workers(router, expected: int, wait_s: float, procs) -> None:
    """Pump the router until every worker said hello (or died)."""
    import time

    deadline = time.monotonic() + wait_s
    while True:
        router.step()
        alive = sum(1 for w in router.workers.values() if w.alive)
        if alive >= expected:
            return
        dead = [p for p in procs if p.poll() is not None]
        if dead:
            raise TimeoutError(
                f"{len(dead)} worker process(es) exited before hello "
                f"(rc={[p.returncode for p in dead]})")
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"only {alive}/{expected} workers joined within {wait_s}s")
        time.sleep(0.05)


def _reap(procs, timeout_s: float = 30.0) -> list:
    """Wait for the workers (told to drain) to exit; SIGTERM one that
    lingers, SIGKILL one that ignores that. Returns their exit codes."""
    import subprocess

    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode for p in procs]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
