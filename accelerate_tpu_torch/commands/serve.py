"""`python -m accelerate_tpu_torch.commands.serve` — run the
OpenAI-compatible HTTP front door on the port's serving engine.

The port of `accelerate_tpu/commands/serve.py` (`accelerate-tpu
serve`): the same flags, the same `--dry-run` JSON line, and the same
engine (`--family llama` serves `LlamaConfig.tiny()`, `--family gpt2`
`GPT2Config.tiny()`, with random weights from `--seed`, a bf16 KV pool,
the engine knobs from the flags), plus one flag, `--device`: the engine
runs on the CUDA device unless `--device cpu` is given.
`--watchdog-timeout-s` arms the engine's stall watchdog (`/healthz`
degrades to 503 while it has fired) and `--incident-dir` is where a
stall or a dead drive loop writes its bundle (the port reads no
environment variable for it). Not ported yet, and refused with a
message naming what brings it: `--strict` (through
`serving.engine._UNPORTED`).

`--dry-run` builds the whole configuration — engine config, tenant
specs, tokenizer, server config — prints one JSON line describing it and
exits 0 without binding a port or building a model. A real run serves
until SIGTERM or SIGINT, then drains: the listener closes, in-flight
requests finish, and the process exits 0.

Importing this module parses nothing and starts nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    """The reference's `serve` flags, plus `--device`."""
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.serve",
        description=(
            "Serve /v1/completions, /v1/chat/completions, /v1/models, "
            "/healthz and /metrics over a continuous-batching engine with "
            "SLO-aware multi-tenant scheduling."
        ),
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="0 binds an ephemeral port (printed on start)")
    parser.add_argument("--family", default="llama",
                        choices=("llama", "gpt2"),
                        help="model-zoo family (tiny research config)")
    parser.add_argument("--model-id", default=None,
                        help="model name reported by /v1/models "
                             "(default: the family name)")
    parser.add_argument("--tokenizer", default="auto",
                        choices=("auto", "byte", "numeric"))
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-len", type=int, default=512)
    parser.add_argument("--prefill-chunk", type=int, default=32)
    parser.add_argument("--max-queue", type=int, default=64)
    parser.add_argument("--page-size", type=int, default=16)
    parser.add_argument("--no-prefix-cache", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--tenants", default=None, metavar="SPEC",
        help="semicolon-separated tenant specs, e.g. "
             "'gold:priority=0,weight=4,slo=0.25;bronze:weight=1' "
             "(slo = TTFT objective in seconds)")
    parser.add_argument(
        "--reject-unknown-tenants", action="store_true",
        help="401 requests from tenants not in --tenants (default: serve "
             "them under the default contract)")
    parser.add_argument("--default-max-tokens", type=int, default=16)
    parser.add_argument("--drain-timeout-s", type=float, default=30.0)
    parser.add_argument(
        "--watchdog-timeout-s", type=float, default=None,
        help="arm the engine stall watchdog; /healthz degrades to 503 "
             "while it has fired")
    parser.add_argument(
        "--incident-dir", default=None, metavar="DIR",
        help="write a self-contained incident bundle (metrics, trace, "
             "stacks, scheduler dump) here when the watchdog fires or "
             "the drive loop dies; inspect with `python -m "
             "accelerate_tpu_torch.commands.incident`")
    parser.add_argument(
        "--debug-endpoints", action="store_true",
        help="enable the read-only /debug/{requests,slots,pages,"
             "scheduler} introspection routes and the on-demand "
             "/debug/profile torch.profiler capture (off by default: "
             "they expose workload shape)")
    parser.add_argument(
        "--trace", action="store_true",
        help="enable host-span request tracing; every request's "
             "x-request-id then resolves to linked spans in the flight "
             "recorder")
    parser.add_argument(
        "--strict", default=None, choices=("warn", "error"),
        help="audit the engine programs (not ported yet: refused)")
    parser.add_argument(
        "--dry-run", action="store_true",
        help="validate the full configuration, print it as one JSON "
             "line, exit without binding or loading a model")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the engine runs (default: the CUDA device)")
    return parser


def _configs(args):
    """Both config objects from flags; raises ValueError on bad specs and
    NotImplementedError on what the port has not reached."""
    from ..serving.engine import EngineConfig, _check_ported
    from ..server.config import ServerConfig, parse_tenants_arg

    tenants = parse_tenants_arg(args.tenants)
    server_cfg = ServerConfig(
        host=args.host, port=args.port,
        model_id=args.model_id or args.family,
        tokenizer=args.tokenizer, tenants=tenants,
        unknown_tenants="reject" if args.reject_unknown_tenants
        else "default",
        default_max_tokens=args.default_max_tokens,
        drain_timeout_s=args.drain_timeout_s,
        debug_endpoints=args.debug_endpoints,
    )
    engine_kwargs = dict(
        num_slots=args.slots, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk, max_queue=args.max_queue,
        page_size=args.page_size, prefix_cache=not args.no_prefix_cache,
        seed=args.seed, tenants=tenants,
        watchdog_timeout_s=args.watchdog_timeout_s, strict=args.strict,
        incident_dir=args.incident_dir,
    )
    _check_ported(EngineConfig(**engine_kwargs))
    return server_cfg, engine_kwargs


def run_serve(args: argparse.Namespace) -> int:
    from ..server.config import format_tenants

    try:
        server_cfg, engine_kwargs = _configs(args)
    except (ValueError, NotImplementedError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    if args.dry_run:
        # validate the scheduler-side tenant contract too (weights etc.)
        # without building a model
        from ..serving.scheduler import Scheduler

        try:
            Scheduler(engine_kwargs["num_slots"], engine_kwargs["max_len"],
                      max_queue=engine_kwargs["max_queue"],
                      tenants=server_cfg.tenants,
                      prefill_chunk=engine_kwargs["prefill_chunk"])
        except ValueError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 2
        print(json.dumps({
            "dry_run": True,
            "family": args.family,
            "model_id": server_cfg.model_id,
            "bind": f"{server_cfg.host}:{server_cfg.port}",
            "tokenizer": server_cfg.tokenizer,
            "tenants": format_tenants(server_cfg.tenants),
            "unknown_tenants": server_cfg.unknown_tenants,
            "engine": {k: v for k, v in engine_kwargs.items()
                       if k != "tenants"},
            "routes": ["/v1/completions", "/v1/chat/completions",
                       "/v1/models", "/healthz", "/metrics"]
            + (["/debug/requests", "/debug/slots", "/debug/pages",
                "/debug/scheduler", "/debug/profile"]
               if args.debug_endpoints else []),
            "trace": bool(args.trace),
        }))
        return 0
    return _serve_blocking(args, server_cfg, engine_kwargs)


def _serve_blocking(args, server_cfg, engine_kwargs) -> int:
    import asyncio

    import torch

    if args.trace:
        from ..telemetry.trace import configure_tracing

        configure_tracing(enabled=True)

    from ..serving import Engine, EngineConfig
    from ..server.http import HttpFrontDoor
    from ..server.service import InferenceService
    from ..server.tokenizer import get_tokenizer

    if args.family == "llama":
        from ..models import llama as family

        cfg = family.LlamaConfig.tiny()
    else:
        from ..models import gpt2 as family

        cfg = family.GPT2Config.tiny()
    device = None if args.device == "cuda" else "cpu"
    params = family.init_params(cfg, args.seed, device=device)
    engine = Engine(family, cfg, params,
                    EngineConfig(cache_dtype=torch.bfloat16, **engine_kwargs),
                    device=device)
    tokenizer = get_tokenizer(server_cfg.tokenizer, cfg.vocab_size)
    service = InferenceService(engine, tokenizer, server_cfg)
    door = HttpFrontDoor(service, server_cfg)

    async def _run() -> None:
        import signal

        await door.start()
        print(f"serving {server_cfg.model_id} on "
              f"{server_cfg.host}:{door.port} "
              f"(tenants: {len(server_cfg.tenants) or 'default only'})",
              file=sys.stderr, flush=True)
        stop_requested = asyncio.Event()
        loop = asyncio.get_running_loop()
        # SIGTERM is how orchestrators say "drain": close the listener,
        # finish in-flight streams, then exit 0
        try:
            loop.add_signal_handler(signal.SIGTERM, stop_requested.set)
            loop.add_signal_handler(signal.SIGINT, stop_requested.set)
        except (NotImplementedError, RuntimeError):
            pass  # non-main thread / platform without signal support
        serve_task = loop.create_task(door.serve_forever())
        stop_task = loop.create_task(stop_requested.wait())
        try:
            await asyncio.wait({serve_task, stop_task},
                               return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            pass
        finally:
            for t in (serve_task, stop_task):
                t.cancel()
            print("serve: draining...", file=sys.stderr, flush=True)
            await door.stop()
            print("serve: drained and stopped", file=sys.stderr, flush=True)

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        print("serve: drained and stopped", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    return run_serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
