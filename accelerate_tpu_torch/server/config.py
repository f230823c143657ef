"""Server configuration shared by the CLI, the tests, and the harness.

A copy of `accelerate_tpu/server/config.py`; `TenantSpec` comes from the
port's scheduler (itself a copy of the reference's).

`ServerConfig` is the front-door half of the knobs (bind address, model
id, tokenizer, tenancy, drain); engine capacity lives in
`serving.EngineConfig` — the CLI builds both. Tenant specs parse from
the compact flag grammar used everywhere a human types them::

    gold:priority=0,weight=4,slo=0.25;bronze:priority=1,weight=1

(semicolon-separated tenants, each `name:key=value,...`; `slo` is the
TTFT objective in seconds, `max_queue` the per-tenant queue cap).
"""

from __future__ import annotations

import dataclasses

from ..serving.scheduler import TenantSpec

__all__ = ["ServerConfig", "parse_tenants_arg", "format_tenants"]


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8000
    model_id: str = "accelerate-tpu"
    tokenizer: str = "auto"          # byte | numeric | auto
    tenants: tuple[TenantSpec, ...] = ()
    # tenants the scheduler has no spec for: "default" serves them under
    # a default-shaped contract, "reject" turns them into 401s at the
    # door (multi-tenant deployments want reject — a typo'd tenant name
    # silently riding the default tier is an SLO accounting leak)
    unknown_tenants: str = "default"
    default_max_tokens: int = 16
    max_body_bytes: int = 2 * 1024 * 1024
    drain_timeout_s: float = 30.0
    request_timeout_s: float = 300.0
    # read-only live-introspection routes (/debug/requests, /debug/slots,
    # /debug/pages, /debug/scheduler, and /debug/pod on a pod-backed
    # engine). Off by default: they expose
    # workload shape (tenants, queue depths, prompt lengths) and belong
    # behind the same trust boundary as /metrics, which an operator must
    # opt into explicitly.
    debug_endpoints: bool = False

    def __post_init__(self):
        if self.unknown_tenants not in ("default", "reject"):
            raise ValueError(
                "unknown_tenants must be 'default' or 'reject', got "
                f"{self.unknown_tenants!r}")


_KEYS = {"priority": int, "weight": float, "slo": float, "max_queue": int}


def parse_tenants_arg(arg: str | None, extra_keys: dict | None = None):
    """`gold:priority=0,weight=4,slo=0.25;bronze:weight=1` -> TenantSpecs.
    Empty/None -> () (single default tenant, FIFO).

    `extra_keys` ({name: type}) admits caller-owned fields on top of the
    TenantSpec ones (the load harness adds `rate`/`concurrency`); the
    call then returns `(specs, {tenant: {extra...}})` instead of specs
    alone."""
    if not arg:
        return ((), {}) if extra_keys else ()
    keys = dict(_KEYS, **(extra_keys or {}))
    specs, extras = [], {}
    for chunk in arg.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, _, rest = chunk.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant spec {chunk!r}: empty name")
        kwargs: dict = {}
        extra: dict = {}
        for pair in filter(None, (p.strip() for p in rest.split(","))):
            key, eq, val = pair.partition("=")
            key = key.strip()
            if not eq or key not in keys:
                raise ValueError(
                    f"tenant spec {name!r}: bad field {pair!r} "
                    f"(known: {', '.join(keys)})")
            try:
                parsed = keys[key](val.strip())
            except ValueError:
                raise ValueError(
                    f"tenant spec {name!r}: {key}={val!r} is not a "
                    f"{keys[key].__name__}")
            if extra_keys and key in extra_keys:
                extra[key] = parsed
            else:
                kwargs[key] = parsed
        if "slo" in kwargs:
            kwargs["ttft_slo_s"] = kwargs.pop("slo")
        specs.append(TenantSpec(name, **kwargs))
        extras[name] = extra
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in {arg!r}")
    if extra_keys:
        return tuple(specs), extras
    return tuple(specs)


def format_tenants(specs) -> str:
    """Inverse of parse_tenants_arg (round-trips for logs/--dry-run)."""
    parts = []
    for s in specs:
        fields = [f"priority={s.priority}", f"weight={s.weight:g}"]
        if s.ttft_slo_s is not None:
            fields.append(f"slo={s.ttft_slo_s:g}")
        if s.max_queue is not None:
            fields.append(f"max_queue={s.max_queue}")
        parts.append(f"{s.name}:" + ",".join(fields))
    return ";".join(parts)
