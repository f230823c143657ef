"""Pod worker: one Engine behind a channel, role assigned by the router
(port of `accelerate_tpu/serving/pod/distributed/worker.py`).

A worker is deliberately role-AGNOSTIC: it owns a single `Engine` plus
its `PageTransport` and executes whatever the router sends — `submit`
messages (prefill a prompt, ship its pages back) or `shipment` messages
(land the pages, decode to completion, stream token state back). "Role"
is a *label* the router uses for placement preference and elastic
rebalancing; converting a worker between prefill and decode is a
router-side bookkeeping flip plus a `set_role` notice, never a process
restart. That is also what makes single-survivor recovery possible: if
every decode worker dies, the remaining prefill worker simply starts
receiving shipments.

Token delivery is FULL-STATE sync, not deltas: every `tokens` message
carries the internal request's complete token/logprob lists. Resending
the whole (small — bounded by max_new_tokens) list makes delivery
idempotent and monotone, so dropped, duplicated, or reordered messages
need no acks and no sequence recovery — the router just keeps the
longest prefix it has seen for the flight's current attempt. A
production transport would delta-encode with acks; the exactness and
recovery semantics are identical.

Every job-bearing message carries ``(flight_id, attempt)`` and every
reply echoes it. The router bumps `attempt` on each replay, so a
duplicate or late message from an earlier attempt is recognizably stale
and dropped on both sides — this is what makes at-least-once delivery
safe under re-prefill recovery (no token delivered twice).

`run_once()` is one deterministic pump (poll, dispatch, step, harvest,
sync, heartbeat) — the in-process tests drive it directly under a fake
clock. `run()` wraps it in the real loop with SIGTERM drain mirroring
`serve`: finish in-flight work, say `bye`, exit.

Observability crosses the boundary in both directions:

- inbound `traceparent` meta (submits AND shipments) joins this
  worker's engine spans to the router-minted request trace, so a
  prefill on worker A and the decode on worker B belong to ONE trace;
- heartbeats export the worker's recent ring-buffer span events
  (bounded, newest-first — `telemetry.trace.drain_spans`) plus the
  NTP-style echo (`ack`) the router needs to estimate this worker's
  clock offset and rebase those spans into router time;
- a `busy` heartbeat announces "entering a device block that may
  outlast the heartbeat interval" (a program's first run and capture,
  long steps) BEFORE going silent, so the router can defer a phantom
  `heartbeat_timeout` verdict;
- an `incident_request` message answers with this worker's
  `incident_dumps()` so the router's fleet incident bundle freezes
  every process's state, not just its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np

from ....telemetry.trace import (
    drain_spans,
    parse_traceparent,
    record_span,
    tracing_enabled,
)
from ...scheduler import RequestStatus
from ..transfer import PageTransport, place_shipment
from .transport import Channel
from .wire import Message, shipment_from_message, shipment_to_message

__all__ = ["WorkerServer", "build_worker_engine", "engine_config_from_spec",
           "ENGINE_SPEC_KEYS"]

# the engine-spec dict shared by CLI workers and tests so separate
# processes build byte-identical engines (family + seed pin the params;
# the rest pins the programs' shapes)
ENGINE_SPEC_KEYS = ("family", "seed", "num_slots", "max_len",
                    "prefill_chunk", "page_size", "max_queue",
                    "cache_dtype", "kv_dtype", "prefix_cache")


def build_worker_engine(spec: dict[str, Any], device=None):
    """(family, config, params, Engine) from a JSON-safe spec dict, on
    `device` (CUDA unless "cpu").

    Every process that must agree on model bytes (router-side reference
    engines, CLI pod workers) builds through this one function: the
    port's `init_params(cfg, seed)` is seeded, so identical specs give
    identical params in different processes on the same device."""
    from ...engine import Engine

    family_name = spec.get("family", "gpt2")
    if family_name == "llama":
        from ....models import llama as family

        cfg = family.LlamaConfig.tiny()
    elif family_name == "gpt2":
        from ....models import gpt2 as family

        cfg = family.GPT2Config.tiny()
    else:
        raise ValueError(f"unknown family {family_name!r}")
    params = family.init_params(cfg, int(spec.get("seed", 0)), device=device)
    engine = Engine(family, cfg, params, engine_config_from_spec(spec),
                    device=device)
    engine.close()  # a pod worker exports via heartbeats, not side-cars
    return family, cfg, params, engine


def engine_config_from_spec(spec: dict[str, Any], **overrides):
    """`EngineConfig` from the JSON-safe spec — shared with the router
    CLI, which needs the matching config without paying for an engine."""
    import torch

    from ...engine import EngineConfig

    cache_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        spec.get("cache_dtype", "float32")]
    kwargs = dict(
        num_slots=int(spec.get("num_slots", 4)),
        max_len=int(spec.get("max_len", 64)),
        prefill_chunk=int(spec.get("prefill_chunk", 8)),
        max_queue=int(spec.get("max_queue", 64)),
        page_size=int(spec.get("page_size", 8)),
        cache_dtype=cache_dtype,
        kv_dtype=spec.get("kv_dtype"),
        prefix_cache=bool(spec.get("prefix_cache", True)),
        seed=int(spec.get("seed", 0)),
    )
    kwargs.update(overrides)
    return EngineConfig(**kwargs)


@dataclasses.dataclass
class _Job:
    """One flight's worker-side state."""

    flight_id: int
    attempt: int
    mode: str                 # "prefill" | "decode"
    internal: Any
    sent_tokens: int = 0      # decode: tokens already synced at least once
    sent_done: bool = False
    started_at: float = 0.0   # worker clock; bounds this job's spans


class WorkerServer:
    """One engine + one channel to the router. See module docstring."""

    def __init__(self, engine, channel: Channel, worker_id: int,
                 role: str = "decode", heartbeat_interval_s: float = 0.5,
                 clock=time.monotonic, export_spans: bool = True,
                 span_export_limit: int = 256):
        self.engine = engine
        self.channel = channel
        self.worker_id = int(worker_id)
        self.role = role
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._clock = clock
        self.transport = PageTransport(engine)
        self.draining = False
        self.done = False
        self._last_heartbeat = -float("inf")
        self._jobs: dict[int, _Job] = {}
        self._admit_pages: dict[int, list] = {}
        self.stale_messages = 0
        # span export: off for in-process workers (they share the
        # router's flight recorder — exporting would double every span),
        # on for real worker processes
        self.export_spans = bool(export_spans)
        self.span_export_limit = int(span_export_limit)
        self._span_cursor = 0
        # the router's last hb_ack, echoed on the next heartbeat — the
        # two middle timestamps of the NTP exchange the router completes
        self._last_ack: dict | None = None
        self._last_step_s = 0.0
        # the admit hook mirrors PodRouter._record_admit: a short prompt
        # can admit, prefill and retire inside ONE engine.step(), and the
        # alloc dies with the slot — snapshot pages the moment they exist
        engine.on_admit = self._record_admit
        self._send(Message("hello", {
            "worker_id": self.worker_id, "role": self.role,
            "slots": len(engine.scheduler.slots),
            "pages_free": engine.allocator.pages_free,
        }))

    # -- plumbing ------------------------------------------------------------

    def _record_admit(self, slot, req) -> None:
        self._admit_pages[id(req)] = list(slot.alloc.pages)

    def _send(self, msg: Message) -> None:
        try:
            self.channel.send(msg)
        except ConnectionError:
            self.done = True  # router gone: nothing left to serve

    @staticmethod
    def _trace_context(meta: dict) -> tuple[str | None, int, bool]:
        """(trace_id, parent_span_id, sampled) from a job-bearing
        message's optional `traceparent` meta. Malformed or absent ->
        (None, 0, False): tracing can degrade, never break dataflow."""
        parsed = parse_traceparent(meta.get("traceparent"))
        if parsed is None:
            return None, 0, False
        trace_id, parent_hex = parsed
        try:
            parent = int(parent_hex, 16)
        except ValueError:
            parent = 0
        return trace_id, parent, bool(meta.get("sampled", False))

    def _stale(self, meta: dict) -> bool:
        """True when a job-bearing message is from a superseded attempt
        (dup/reorder of a replayed flight) — dropped, counted."""
        job = self._jobs.get(int(meta["flight_id"]))
        if job is not None and int(meta["attempt"]) <= job.attempt \
                and job.mode is not None:
            self.stale_messages += 1
            return True
        return False

    # -- message handlers ----------------------------------------------------

    def _handle(self, msg: Message) -> None:
        meta = msg.meta
        if msg.kind == "submit":
            if self._stale(meta):
                return
            self._evict(int(meta["flight_id"]))
            prompt, key_raw = msg.buffers
            trace_id, parent, sampled = self._trace_context(meta)
            internal = self.engine.submit(
                np.asarray(prompt, np.int32),
                max_new_tokens=int(meta["budget"]),
                temperature=float(meta["temperature"]),
                key=np.asarray(key_raw, np.uint32),
                trace_id=trace_id, trace_parent=parent,
                trace_sampled=sampled)
            self._jobs[int(meta["flight_id"])] = _Job(
                flight_id=int(meta["flight_id"]),
                attempt=int(meta["attempt"]), mode="prefill",
                internal=internal, started_at=self._clock())
        elif msg.kind == "shipment":
            if self._stale(meta):
                return
            self._evict(int(meta["flight_id"]))
            shipment = shipment_from_message(msg)
            t0 = self._clock()
            placed = place_shipment(self.engine, self.transport, shipment,
                                    t0)
            if placed is None:
                # no slot/pages here right now — the router re-routes or
                # replays; refusing is cheaper than deadlocking a slot
                self._send(Message("install_failed", {
                    "flight_id": int(meta["flight_id"]),
                    "attempt": int(meta["attempt"]),
                    "worker_id": self.worker_id}))
                return
            internal, _slot, _alloc = placed
            # join the router's trace AFTER placement: the internal is
            # built by place_shipment, not engine.submit
            trace_id, parent, sampled = self._trace_context(meta)
            if trace_id is not None:
                from ...engine import prepare_request_tracing

                prepare_request_tracing(internal, trace_id, parent, sampled)
                if internal.trace_sampled:
                    # decode start on THIS worker: pages landed, slot
                    # adopted — the third leg of the cross-process
                    # timeline (prefill -> page_transfer -> install)
                    record_span(
                        "serving.pod.install", t0, self._clock(),
                        trace=internal.trace_id, parent=parent,
                        worker=self.worker_id,
                        flight_id=int(meta["flight_id"]),
                        attempt=int(meta["attempt"]),
                        pages=shipment.n_prompt_pages)
            self._jobs[int(meta["flight_id"])] = _Job(
                flight_id=int(meta["flight_id"]),
                attempt=int(meta["attempt"]), mode="decode",
                internal=internal, sent_tokens=1, started_at=t0)
        elif msg.kind == "hb_ack":
            # router's receipt stamp for one of our heartbeats; echo it
            # (plus OUR receipt time of this ack) on the next heartbeat —
            # the router then holds all four NTP timestamps
            self._last_ack = {
                "router_t": float(meta.get("router_t", 0.0)),
                "worker_recv_t": self._clock(),
            }
        elif msg.kind == "incident_request":
            self._send(Message("incident_dumps", {
                "req_id": meta.get("req_id"),
                "worker_id": self.worker_id,
                "dumps": self.incident_dumps(),
            }))
        elif msg.kind == "cancel":
            job = self._jobs.pop(int(meta["flight_id"]), None)
            if job is not None:
                self._admit_pages.pop(id(job.internal), None)
                self.engine.cancel(job.internal)
        elif msg.kind == "finish":
            job = self._jobs.pop(int(meta["flight_id"]), None)
            if job is not None:
                self._admit_pages.pop(id(job.internal), None)
                self.engine.finish(job.internal)
        elif msg.kind == "set_role":
            self.role = str(meta["role"])
        elif msg.kind == "reset":
            # rejoin after a partition the router already recovered from:
            # every local flight was replayed elsewhere — drop them all
            for job in list(self._jobs.values()):
                self._admit_pages.pop(id(job.internal), None)
                if not job.internal.done:
                    self.engine.cancel(job.internal)
            self._jobs.clear()
        elif msg.kind == "drain":
            self.draining = True

    def _evict(self, flight_id: int) -> None:
        """A NEWER attempt for a flight we already hold: the old
        internal is dead weight — cancel it before starting over."""
        job = self._jobs.pop(flight_id, None)
        if job is not None:
            self._admit_pages.pop(id(job.internal), None)
            if not job.internal.done:
                self.engine.cancel(job.internal)

    # -- outbound ------------------------------------------------------------

    def _harvest_prefill(self) -> None:
        """Ship every prefill job whose first token exists (mirror of
        PodRouter._harvest, result crossing the channel instead of a
        deque). Extraction happens HERE, before the engine steps again —
        a retired slot's pages are only reallocatable at the next
        admission, which cannot happen before the next step."""
        now = self._clock()
        for job in list(self._jobs.values()):
            if job.mode != "prefill":
                continue
            internal = job.internal
            if not internal.tokens and not internal.done:
                continue
            del self._jobs[job.flight_id]
            if internal.done and internal.status is not RequestStatus.FINISHED:
                self._admit_pages.pop(id(internal), None)
                self._send(Message("prefill_failed", {
                    "flight_id": job.flight_id, "attempt": job.attempt,
                    "worker_id": self.worker_id,
                    "status": internal.status.value}))
                continue
            pages = self._admit_pages.pop(id(internal), None)
            shipment = self.transport.extract_shipment(
                pages, internal, src_worker=self.worker_id, extracted_at=now)
            if internal.trace_sampled:
                # prefill on THIS worker, submit->extract: the first leg
                # of the cross-process timeline (ends where the router's
                # page_transfer span begins)
                record_span(
                    "serving.pod.prefill", job.started_at, now,
                    trace=internal.trace_id, parent=internal.trace_parent,
                    worker=self.worker_id, flight_id=job.flight_id,
                    attempt=job.attempt)
            if not internal.done:
                # retire as FINISHED so the prompt enters this worker's
                # prefix tree: shared prefixes prefill once per worker
                self.engine.finish(internal)
            self._send(shipment_to_message(
                shipment, flight_id=job.flight_id, attempt=job.attempt,
                worker_id=self.worker_id))

    def _sync_decode(self) -> None:
        """Full-state token sync for every decode job with news."""
        for job in list(self._jobs.values()):
            if job.mode != "decode":
                continue
            internal = job.internal
            if len(internal.tokens) == job.sent_tokens and not internal.done:
                continue
            self._send(Message("tokens", {
                "flight_id": job.flight_id, "attempt": job.attempt,
                "worker_id": self.worker_id,
                "tokens": [int(t) for t in internal.tokens],
                "logprobs": [float(lp) for lp in internal.logprobs],
                "done": bool(internal.done),
                "status": internal.status.value,
            }))
            job.sent_tokens = len(internal.tokens)
            if internal.done:
                job.sent_done = True
                del self._jobs[job.flight_id]

    def _busy_hint(self) -> bool:
        """True when the NEXT engine.step() may outlast the heartbeat
        interval: a program this worker's pending work needs has never
        run (its first run builds and captures it), or the previous step already ran long. Announced BEFORE stepping
        so the router defers its `heartbeat_timeout` verdict while this
        worker is provably busy-not-dead."""
        if not self.engine.scheduler.has_work():
            return False
        if self._last_step_s > max(self.heartbeat_interval_s, 0.05):
            return True
        compiles = self.engine.compile_stats()
        modes = {j.mode for j in self._jobs.values()}
        if "decode" not in modes or not modes:
            # queued/prefill work ahead: needs admit + prefill programs
            if not compiles.get("admit") or not compiles.get("prefill"):
                return True
        if "decode" in modes and not compiles.get("decode"):
            return True
        return False

    def incident_dumps(self) -> dict:
        """This worker's contribution to a fleet incident bundle: its
        channel-facing job table plus the engine's own dumps, forced
        JSON-safe (the reply crosses the wire codec — one unserializable
        value must not cost the router the whole stanza)."""
        out: dict[str, Any] = {
            "worker_id": self.worker_id,
            "role": self.role,
            "pid": os.getpid(),
            "draining": self.draining,
            "stale_messages": self.stale_messages,
            "jobs": [{
                "flight_id": j.flight_id, "attempt": j.attempt,
                "mode": j.mode, "tokens": len(j.internal.tokens),
                "done": bool(j.internal.done),
            } for j in self._jobs.values()],
        }
        try:
            out["engine"] = self.engine.incident_dumps()
        except Exception as e:
            out["engine"] = {"error": f"{type(e).__name__}: {e}"}
        return json.loads(json.dumps(out, default=str))

    def _maybe_heartbeat(self, force: bool = False,
                         busy: bool = False, lean: bool = False) -> None:
        now = self._clock()
        if not force and now - self._last_heartbeat < self.heartbeat_interval_s:
            return
        self._last_heartbeat = now
        if lean:
            # the busy pre-announce is latency-critical (it must be in
            # flight before the device block) — ship only liveness + the
            # NTP stamps, not the registry snapshot
            meta = {"worker_id": self.worker_id, "role": self.role,
                    "t": now, "pid": os.getpid(),
                    "draining": self.draining, "busy": bool(busy)}
            if self._last_ack is not None:
                meta["ack"] = self._last_ack
            self._send(Message("heartbeat", meta))
            return
        eng = self.engine
        meta = {
            "worker_id": self.worker_id, "role": self.role, "t": now,
            "pid": os.getpid(),
            "draining": self.draining,
            "busy": bool(busy or self._busy_hint()),
            "stats": {
                "slots": len(eng.scheduler.slots),
                "live_slots": eng.scheduler.live_slots,
                "queue_depth": eng.scheduler.queue_depth,
                "pages_free": eng.allocator.pages_free,
                "pages_in_use": eng.allocator.pages_in_use,
            },
            "compiles": {**eng.compile_stats(),
                         **self.transport.compile_stats()},
            # the registry snapshot IS the telemetry merge payload:
            # counters/gauges/sketches aggregate router-side without a
            # process group (telemetry/aggregate.py merged_registry)
            "snapshot": eng.registry.snapshot(include_sketch=True),
        }
        if self._last_ack is not None:
            # the NTP echo: (router send, our receipt) of the last ack;
            # together with this heartbeat's ("t", router receipt) the
            # router holds all four timestamps of one round trip
            meta["ack"] = self._last_ack
        if self.export_spans and tracing_enabled():
            spans, cursor = drain_spans(self._span_cursor,
                                        limit=self.span_export_limit)
            if cursor != self._span_cursor:
                self._span_cursor = cursor
                if spans:
                    meta["spans"] = spans
                # the high-water mark dedups ingestion under heartbeat
                # dup/reorder (FlakyTransport can deliver one twice)
                meta["span_seq"] = cursor
        self._send(Message("heartbeat", meta))

    # -- drive ---------------------------------------------------------------

    def run_once(self) -> bool:
        """One deterministic pump. Returns True when anything moved."""
        if self.done:
            return False
        if self.channel.closed:
            self.done = True
            return False
        msgs = self.channel.poll()
        for msg in msgs:
            self._handle(msg)
        # hb_acks are clock-sync plumbing, not progress: counting them
        # would ping-pong with our own heartbeats and keep an idle pod's
        # step() returning True forever
        worked = any(m.kind != "hb_ack" for m in msgs)
        if self.engine.scheduler.has_work():
            if self._busy_hint():
                # announce the device block BEFORE entering it: the
                # heartbeat must be in flight while we cannot send
                self._maybe_heartbeat(force=True, busy=True, lean=True)
            t0 = self._clock()
            self.engine.step()
            self._last_step_s = self._clock() - t0
            worked = True
        self._harvest_prefill()
        self._sync_decode()
        self._maybe_heartbeat()
        if self.draining and not self._jobs \
                and not self.engine.scheduler.has_work():
            self._send(Message("bye", {"worker_id": self.worker_id}))
            self.done = True
        return worked

    def run(self, poll_interval_s: float = 0.002) -> None:
        """Blocking loop for real worker processes; returns when drained
        or the router goes away. SIGTERM -> drain is wired by the CLI."""
        while not self.done:
            if not self.run_once() and not self.done:
                time.sleep(poll_interval_s)
