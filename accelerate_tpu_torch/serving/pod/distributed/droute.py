"""DistributedPodRouter: the multi-process pod front, behind the same API
(port of `accelerate_tpu/serving/pod/distributed/droute.py`).

`PodRouter` runs the disaggregated dataflow (prefill workers produce KV
page shipments, decode workers own slots) inside one process.
This router runs the SAME dataflow over channels: workers are separate
OS processes reached through `SocketChannel`s (or in-process
`WorkerServer`s over `LocalChannel`s — the deterministic test form), and
the router holds no model, no params, no device state — it is pure
bookkeeping plus the user-facing scheduler, which is exactly what lets
it survive any worker dying.

Exactness is inherited, not engineered: a token's draw hashes the
request key with its ABSOLUTE position (`models/decode.py`), so token
`i` of a request is a pure function of (params, prompt, key, position) — the same
schedule-independence that made the in-process pod byte-identical to the
single engine makes the process boundary invisible, and makes recovery a
replay: re-prefilling `prompt + delivered_tokens` with the original key
samples its "first token" at position `prompt_len + d`, which IS token
`d` of the original stream. Delivered tokens stand; the continuation is
byte-identical; nothing is lost or duplicated.

Failure model (every path funnels into `_replay_flight`):

- dropped connection  -> worker lost immediately (`channel_drop`)
- missed heartbeats   -> worker lost after `heartbeat_timeout_s`
  (`heartbeat_timeout` — the hung-but-connected case)
- stalled flight      -> no progress for `flight_timeout_s` while the
  worker looks alive (`stalled` — a dropped submit/shipment/tokens
  message on a lossy transport); the old attempt is cancelled
- worker refuses an install -> `install_refused`; worker kills an
  internal -> `worker_drop`; each replay bumps `attempt`, so stale
  messages from superseded attempts are recognized and dropped
- a flight that exhausts `max_attempts` is shed with the engine's shed
  vocabulary (`SHED_WORKER_DROP` + retry_after) instead of looping

Every recovery appends a `recovery_log` entry with its shed-code-style
`recovery_reason` and bumps `serving_pod_worker_{lost,recovered}_total`
/ `serving_pod_requests_replayed_total`; recovery latency (loss detected
-> replayed stream's next token delivered) lands in the
`serving_pod_recovery_latency_seconds` sketch.

Elastic rebalancing replaces the config-time role ratio: roles are SOFT
labels the router flips on idle workers from live queue-depth/occupancy
signals, hysteresis-banded (`occupancy_low` .. `occupancy_high` is a
dead zone, so it cannot flap) and bounded to one conversion per
`rebalance_window_s`. Soft roles are also the last line of recovery: if
a role has NO alive workers, any alive worker takes its work — a pod
reduced to one surviving worker keeps serving.

Backpressure is `PodRouter`'s: the router's pending-shipment
buffer is bounded (`_assign_prefill` stops feeding when full) and
`SocketChannel.send` blocks on a full send queue — the decode side
stalls the ROUTER, never a prefill worker.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, AsyncIterator, Iterator

import numpy as np

from ....telemetry.aggregate import merged_registry
from ....telemetry.export import start_metrics_server
from ....telemetry.registry import MetricsRegistry
from ....telemetry.trace import export_chrome_trace, ingest_spans, record_span
from ....telemetry.watchdog import (
    StallWatchdog,
    resolve_incident_dir,
    resolve_stall_timeout,
    write_incident_bundle,
)
from ....models.decode import derive_key, stream_key
from ...engine import (
    EngineConfig,
    close_request_trace,
    prepare_request_tracing,
)
from ...metrics import ServingMetrics
from ...sanitizer import check_distributed_router, resolve_sanitize
from ...scheduler import Request, RequestStatus, SHED_WORKER_DROP
from ..router import _FrontScheduler
from ..transfer import KVPageShipment
from .transport import Channel, ChannelListener
from .wire import (
    Message,
    shipment_from_message,
    shipment_to_message,
    trace_meta,
)
from .worker import WorkerServer

__all__ = ["DistributedPodConfig", "DistributedPodRouter", "WorkerHandle",
           "build_local_distributed_pod"]

# recovery_reason vocabulary (shed-code style: machine-readable, stable)
RECOVER_CHANNEL_DROP = "channel_drop"
RECOVER_HEARTBEAT_TIMEOUT = "heartbeat_timeout"
RECOVER_STALLED = "stalled"
RECOVER_INSTALL_REFUSED = "install_refused"
RECOVER_WORKER_DROP = "worker_drop"
RECOVER_WORKER_DRAINED = "worker_drained"
RECOVER_GAVE_UP = "gave_up"


@dataclasses.dataclass(frozen=True)
class DistributedPodConfig:
    """Knobs for the multi-process pod front (`PodConfig`'s distributed
    sibling). Timeouts are generous by default — CPU-test prefills are
    slow; production tightens them."""

    prefill_workers: int = 1
    decode_workers: int = 1
    max_pending_shipments: int | None = None
    heartbeat_interval_s: float = 0.25
    heartbeat_timeout_s: float = 5.0
    # a flight with no progress for this long while its worker still
    # heartbeats -> the message (not the worker) was lost: replay
    flight_timeout_s: float = 60.0
    max_attempts: int = 5
    rebalance: bool = True
    rebalance_window_s: float = 10.0
    occupancy_high: float = 0.85
    occupancy_low: float = 0.25
    # a worker whose last heartbeat said `busy` (first-compile, long
    # device block) gets THIS silence budget instead of
    # heartbeat_timeout_s — busy-not-dead must not be a phantom loss,
    # which is what lets heartbeat_timeout_s itself stay tight
    busy_heartbeat_timeout_s: float = 300.0
    # fleet incident bundles: per-worker incident_dumps RPC wall-clock
    # budget, and the write rate limit (a flake storm must not turn the
    # incident dir into a DoS on its own disk)
    incident_rpc_timeout_s: float = 2.0
    fleet_bundle_min_interval_s: float = 30.0
    # lost workers' metric snapshots are served labeled stale="true";
    # set a horizon (seconds since last heartbeat) to drop them entirely
    snapshot_stale_after_s: float | None = None

    def __post_init__(self):
        if self.prefill_workers < 1 or self.decode_workers < 1:
            raise ValueError("a pod needs at least one worker per role")
        if not (0.0 <= self.occupancy_low < self.occupancy_high <= 1.0):
            raise ValueError(
                "rebalance bands must satisfy 0 <= low < high <= 1 (got "
                f"low={self.occupancy_low}, high={self.occupancy_high})")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")


@dataclasses.dataclass
class WorkerHandle:
    """Router-side view of one worker process."""

    worker_id: int
    channel: Channel
    role: str                         # SOFT label; router-authoritative
    slots: int
    alive: bool = False               # True after hello/first heartbeat
    lost: bool = False
    draining: bool = False
    busy: bool = False                # last heartbeat announced a long block
    last_heartbeat: float = 0.0
    stats: dict = dataclasses.field(default_factory=dict)
    compiles: dict = dataclasses.field(default_factory=dict)
    snapshot: dict | None = None      # last heartbeat's registry snapshot
    snapshot_at: float = 0.0          # router clock at snapshot receipt
    pid: int | None = None
    # NTP-style clock estimate (router clock MINUS worker clock) from
    # heartbeat round trips, EWMA-smoothed; error is bounded by +-RTT/2
    clock_offset_s: float | None = None
    clock_rtt_s: float | None = None
    span_seq: int = 0                 # span-export high-water (dedup)
    last_span_at: float | None = None  # router clock of last span ingest
    local: Any = None                 # in-process WorkerServer to pump


@dataclasses.dataclass
class _DFlight:
    """One user request's journey, replay-aware. Phases:
    replay -> prefill -> pending -> decode (replay re-enters at replay)."""

    user: Request
    flight_id: int
    key_raw: np.ndarray
    attempt: int = 1
    phase: str = "replay"
    worker: int = -1                  # worker_id, -1 while router-held
    shipment: KVPageShipment | None = None
    copied: int = 0                   # internal tokens mirrored (decode)
    base: int = 0                     # user tokens delivered before attempt
    progress_at: float = 0.0
    replay_started_at: float | None = None
    dispatch_span: int = 0            # span id of this attempt's dispatch
    #                                   (a replay span links its original)


class DistributedPodRouter:
    """Multi-host pod front behind the `ServingEngine` API."""

    def __init__(
        self,
        engine_config: EngineConfig | None = None,
        pod_config: DistributedPodConfig | None = None,
        clock=time.monotonic,
        listener: ChannelListener | None = None,
    ):
        self.engine_config = ec = engine_config or EngineConfig()
        self.pod_config = pc = pod_config or DistributedPodConfig()
        self._clock = clock
        self.listener = listener
        self._unclaimed: list[Channel] = []

        self._sanitize = resolve_sanitize(ec.sanitize)
        self.workers: dict[int, WorkerHandle] = {}
        self._flights: dict[int, _DFlight] = {}        # flight_id -> flight
        self._by_user: dict[int, _DFlight] = {}        # id(user) -> flight
        self._pending: deque[int] = deque()            # flight_ids
        self._replay: deque[int] = deque()             # flight_ids
        self._next_flight_id = 1
        self._max_pending = pc.max_pending_shipments
        if self._max_pending is None:
            self._max_pending = max(2, ec.num_slots)
        # start the rebalance window NOW: converting on the first step
        # (queue pressure exists before decode occupancy can) would
        # reshape the pod before it ever ran its configured shape
        self._last_rebalance = self._clock()
        self.last_step_worked = False
        self.recovery_log: deque[dict] = deque(maxlen=256)

        self.scheduler = _FrontScheduler(
            self, max_len=ec.max_len, max_queue=ec.max_queue, clock=clock,
            tenants=ec.tenants, prefill_chunk=ec.prefill_chunk)
        self.registry = MetricsRegistry()
        self.metrics = ServingMetrics(registry=self.registry)
        reg = self.registry
        self._c_shipments = reg.counter("serving_pod_shipments_total")
        self._c_pages_shipped = reg.counter("serving_pod_pages_shipped_total")
        self._c_stalls = reg.counter("serving_pod_backpressure_stalls_total")
        self._c_lost = reg.counter("serving_pod_worker_lost_total")
        self._c_recovered = reg.counter("serving_pod_worker_recovered_total")
        self._c_replayed = reg.counter("serving_pod_requests_replayed_total")
        self._c_stale = reg.counter("serving_pod_stale_messages_total")
        self._c_conversions = {
            d: reg.counter("serving_pod_role_conversions_total", direction=d)
            for d in ("prefill_to_decode", "decode_to_prefill")}
        self._h_recovery = reg.histogram(
            "serving_pod_recovery_latency_seconds")
        self._c_spans = reg.counter("serving_pod_worker_spans_ingested_total")
        self._g_pending = reg.gauge("serving_pod_pending_shipments")
        self._g_alive = reg.gauge("serving_pod_workers_alive")
        self._g_clock_offset: dict[int, Any] = {}  # worker_id -> gauge
        self._g_occupancy = {
            role: reg.gauge("serving_pod_role_occupancy", role=role)
            for role in ("prefill", "decode")}
        self.metrics_server = start_metrics_server(
            ec.metrics_port, registry=self.registry)
        # fleet incident bundles: triggered by loss/recovery/sanitizer
        # events, written at the END of the triggering step (never from
        # inside dispatch — the RPC fan-out re-enters the poll loop)
        self._incident_dir = resolve_incident_dir(ec.incident_dir)
        self._pending_incident: tuple[str, str] | None = None
        self._last_fleet_bundle: float | None = None
        self._incident_seq = 0
        self._incident_replies: dict[tuple[int, int], dict] = {}
        self.watchdog: StallWatchdog | None = None
        wd_timeout = resolve_stall_timeout(ec.watchdog_timeout_s)
        if wd_timeout is not None:
            self.watchdog = StallWatchdog(
                wd_timeout, name="serving-pod-droute",
                incident_dir=ec.incident_dir, registry=self.registry,
                dumps=self.incident_dumps).start()

    # -- worker registration -------------------------------------------------

    def register_worker(self, channel: Channel, worker_id: int, role: str,
                        slots: int | None = None,
                        local: "WorkerServer | None" = None) -> WorkerHandle:
        """Attach a worker the router already knows the identity of
        (in-process factories, pre-spawned CLI workers). Socket workers
        that dial the listener instead self-identify via `hello`."""
        handle = WorkerHandle(
            worker_id=int(worker_id), channel=channel, role=role,
            slots=slots if slots is not None else self.engine_config.num_slots,
            last_heartbeat=self._clock(), local=local)
        self.workers[handle.worker_id] = handle
        return handle

    # -- request API (the ServingEngine surface) -----------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        key=None,
        eos_token_id: int | None = None,
        deadline_s: float | None = None,
        tenant: str = "default",
        slo_ttft_s: float | None = None,
        trace_id=None,
        trace_parent=0,
        trace_sampled: bool | None = None,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), key=key,
            eos_token_id=eos_token_id, deadline_s=deadline_s,
            tenant=tenant, slo_ttft_s=slo_ttft_s,
        )
        prepare_request_tracing(req, trace_id, trace_parent, trace_sampled)
        self.scheduler.shed_expired(self._clock())
        for victim in self.scheduler.drain_shed():
            self._finalize(victim)
        self._assign_prefill()
        self.scheduler.submit(req)
        for victim in self.scheduler.drain_shed():
            self._finalize(victim)
        if req.done:
            self._finalize(req)
        else:
            self._assign_prefill()
        return req

    def cancel(self, request: Request) -> bool:
        if request.done:
            return False
        if self.scheduler.cancel(request):
            self._finalize(request)
            return True
        flight = self._by_user.get(id(request))
        if flight is None:
            return False
        self._retire_flight(flight, notify="cancel")
        request.status = RequestStatus.CANCELLED
        request.finished_at = self._clock()
        self._finalize(request)
        return True

    def finish(self, request: Request) -> bool:
        if request.done:
            return False
        flight = self._by_user.get(id(request))
        if flight is None:
            return False
        self._retire_flight(flight, notify="finish")
        request.status = RequestStatus.FINISHED
        request.finished_at = self._clock()
        self._finalize(request)
        return True

    def _retire_flight(self, flight: _DFlight, notify: str) -> None:
        """Drop a flight from every router structure and (best-effort)
        tell its worker to free the slot."""
        if flight.phase == "pending":
            try:
                self._pending.remove(flight.flight_id)
            except ValueError:
                pass
        elif flight.phase == "replay":
            try:
                self._replay.remove(flight.flight_id)
            except ValueError:
                pass
        elif flight.worker in self.workers:
            handle = self.workers[flight.worker]
            if handle.alive:
                try:
                    handle.channel.send(Message(notify, {
                        "flight_id": flight.flight_id,
                        "attempt": flight.attempt}))
                except ConnectionError:
                    pass  # failure detection will reap the worker
        self._flights.pop(flight.flight_id, None)
        self._by_user.pop(id(flight.user), None)

    def stream(self, request: Request) -> Iterator[int]:
        sent = 0
        while True:
            while sent < len(request.tokens):
                yield request.tokens[sent]
                sent += 1
            if request.done or not self.step():
                break
        yield from request.tokens[sent:]

    async def astream(self, request: Request) -> AsyncIterator[int]:
        import asyncio

        sent = 0
        while True:
            while sent < len(request.tokens):
                yield request.tokens[sent]
                sent += 1
            if request.done or not self.step():
                break
            # idle-but-outstanding on a pure-remote pod: yield a real
            # tick so the reader threads can land replies; otherwise
            # just yield the loop
            await asyncio.sleep(
                0 if self.last_step_worked or self._has_local_workers()
                else 0.001)
        for tok in request.tokens[sent:]:
            yield tok

    # -- the drive loop ------------------------------------------------------

    def step(self) -> bool:
        """One router round: accept joiners, dispatch worker messages,
        detect failures, replay, assign, forward, rebalance, pump local
        workers. Returns False only when the whole pod is idle — while
        flights are outstanding on remote workers it returns True even
        if nothing moved this instant (the work is elsewhere)."""
        if self.metrics.started_at is None:
            self.metrics.started_at = self._clock()
        if self.watchdog is not None:
            self.watchdog.tick()
        t0 = self._clock()
        self.scheduler.shed_expired(t0)
        for victim in self.scheduler.drain_shed():
            self._finalize(victim)
        self._accept_joiners()
        worked = self._dispatch_inbound()
        self._detect_failures()
        self._watch_flights()
        worked = self._assign_prefill() or worked
        worked = self._forward_pending() or worked
        self._rebalance()
        for handle in self.workers.values():
            if handle.local is not None and not handle.lost:
                worked = handle.local.run_once() or worked
        self._update_gauges()
        self.metrics.stopped_at = self._clock()
        if worked:
            self.scheduler.note_step_time(self.metrics.stopped_at - t0)
            live = len([f for f in self._flights.values()
                        if f.phase == "decode"])
            cap = sum(h.slots for h in self.workers.values()
                      if h.alive and h.role == "decode") or 1
            self.metrics.observe_step(live, cap, self.scheduler.queue_depth)
        # fleet bundles write at the END of the step: the RPC fan-out
        # re-enters the poll loop, which must not happen inside dispatch
        self._maybe_write_fleet_bundle()
        if self._sanitize:
            try:
                check_distributed_router(self)
            except Exception:
                self._note_incident("sanitizer_violation")
                self._maybe_write_fleet_bundle()
                raise
        outstanding = bool(self._flights) or self.scheduler.queue_depth > 0
        # pacing is the CALLER's job: step() runs inline on the asyncio
        # drive loop (astream), and a sleep here would park every task on
        # the loop. Sync callers read `last_step_worked` and sleep.
        self.last_step_worked = worked
        return worked or outstanding

    def run_until_idle(self) -> None:
        while self.step():
            if not self.last_step_worked and not self._has_local_workers():
                time.sleep(0.001)   # remote work in flight: don't spin hot

    def _has_local_workers(self) -> bool:
        return any(h.local is not None for h in self.workers.values())

    # -- inbound -------------------------------------------------------------

    def _accept_joiners(self) -> None:
        if self.listener is not None:
            self._unclaimed.extend(self.listener.accept_all())
        still: list[Channel] = []
        for ch in self._unclaimed:
            claimed = False
            for msg in ch.poll():
                if msg.kind == "hello":
                    self._claim(ch, msg.meta)
                    claimed = True
                # pre-hello chatter from an unclaimed channel is dropped
            if not claimed and not ch.closed:
                still.append(ch)
        self._unclaimed = still

    def _claim(self, channel: Channel, meta: dict) -> None:
        wid = int(meta["worker_id"])
        handle = self.workers.get(wid)
        if handle is None:
            self.workers[wid] = handle = WorkerHandle(
                worker_id=wid, channel=channel,
                role=str(meta.get("role", "decode")),
                slots=int(meta.get("slots", self.engine_config.num_slots)))
        else:
            # rejoin on a fresh connection: the router already replayed
            # everything this worker held — wipe its local state and
            # re-impose the router-authoritative role label
            handle.channel = channel
            try:
                channel.send(Message("reset", {}))
                channel.send(Message("set_role", {"role": handle.role}))
            except ConnectionError:
                return
        handle.slots = int(meta.get("slots", handle.slots))
        self._mark_alive(handle)

    def _mark_alive(self, handle: WorkerHandle) -> None:
        handle.last_heartbeat = self._clock()
        if handle.lost:
            handle.lost = False
            self._c_recovered.inc()
        handle.alive = True

    def _dispatch_inbound(self) -> bool:
        worked = False
        for handle in list(self.workers.values()):
            if handle.channel.closed:
                continue
            for msg in handle.channel.poll():
                kind = msg.kind
                # heartbeats are liveness, not progress: counting them as
                # work would keep an idle pod's step() returning True
                worked = worked or kind not in ("heartbeat", "hello")
                if kind == "heartbeat":
                    self._on_heartbeat(handle, msg.meta)
                elif kind == "shipment":
                    self._on_shipment(handle, msg)
                elif kind == "tokens":
                    self._on_tokens(handle, msg.meta)
                elif kind == "install_failed":
                    self._on_flight_refusal(msg.meta, RECOVER_INSTALL_REFUSED,
                                            want_phase="decode")
                elif kind == "prefill_failed":
                    self._on_flight_refusal(msg.meta, RECOVER_WORKER_DROP,
                                            want_phase="prefill")
                elif kind == "hello":
                    handle.slots = int(msg.meta.get("slots", handle.slots))
                    self._mark_alive(handle)
                elif kind == "incident_dumps":
                    self._incident_replies[
                        (int(msg.meta.get("req_id") or 0),
                         handle.worker_id)] = msg.meta.get("dumps") or {}
                elif kind == "bye":
                    self._on_bye(handle)
        return worked

    def _on_heartbeat(self, handle: WorkerHandle, meta: dict) -> None:
        # heartbeat recency uses the ROUTER's receipt clock: worker
        # clocks are not comparable across hosts — which is exactly why
        # the same receipt stamp doubles as T4 of the NTP exchange below
        now = self._clock()
        was_lost = handle.lost
        self._mark_alive(handle)
        # lean busy announces omit stats/compiles/snapshot: only update
        # what this heartbeat actually carries
        if meta.get("stats") is not None:
            handle.stats = meta["stats"]
        if meta.get("compiles") is not None:
            handle.compiles = meta["compiles"]
        handle.busy = bool(meta.get("busy", False))
        if meta.get("pid") is not None:
            handle.pid = int(meta["pid"])
        if meta.get("snapshot") is not None:
            handle.snapshot = meta.get("snapshot")
            handle.snapshot_at = now
        handle.slots = int(handle.stats.get("slots", handle.slots))
        self._sync_worker_clock(handle, meta, now)
        self._ingest_worker_spans(handle, meta, now)
        try:
            # receipt stamp back to the worker; its echo on the NEXT
            # heartbeat closes the NTP round trip
            handle.channel.send(Message("hb_ack", {
                "worker_t": meta.get("t"), "router_t": now}))
        except ConnectionError:
            pass  # failure detection will reap the worker
        if was_lost:
            # rejoined after a partition the router recovered around:
            # its flights were replayed elsewhere — clear its state
            try:
                handle.channel.send(Message("reset", {}))
                handle.channel.send(
                    Message("set_role", {"role": handle.role}))
            except ConnectionError:
                pass

    def _sync_worker_clock(self, handle: WorkerHandle, meta: dict,
                           now: float) -> None:
        """NTP-style offset estimate from the heartbeat round trip. The
        worker echoes the router's last `hb_ack` (T1 = router send, T2 =
        worker receipt) alongside its own send stamp (T3); `now` is the
        router receipt (T4):

            offset(router - worker) = ((T1 - T2) + (T4 - T3)) / 2
            rtt = (T4 - T1) - (T3 - T2)

        Error is bounded by +-rtt/2; EWMA smoothing (alpha 0.25) rides
        out scheduling jitter. First contact has no echo yet — fall back
        to the one-way T4 - T3 (biased by the network delay; the first
        completed round trip corrects it). In-process workers short-
        circuit to offset 0 — they share the router's clock, and the
        estimator's "delay" would be whole engine steps."""
        if handle.local is not None:
            # in-process workers share this very clock: the estimator's
            # "network delay" would be whole engine steps (large, one-
            # sided), injecting error where the true offset is exactly 0
            handle.clock_offset_s = 0.0
            handle.clock_rtt_s = 0.0
        t3 = meta.get("t")
        if t3 is None:
            return
        t3 = float(t3)
        if handle.local is not None:
            self._set_clock_offset_gauge(handle)
            return
        ack = meta.get("ack") or {}
        t1, t2 = ack.get("router_t"), ack.get("worker_recv_t")
        if t1 is not None and t2 is not None:
            t1, t2 = float(t1), float(t2)
            rtt = (now - t1) - (t3 - t2)
            if rtt < 0:
                return   # a clock stepped mid-round: discard the sample
            handle.clock_rtt_s = (
                rtt if handle.clock_rtt_s is None
                else 0.75 * handle.clock_rtt_s + 0.25 * rtt)
            sample = ((t1 - t2) + (now - t3)) / 2.0
        elif handle.clock_offset_s is None:
            sample = now - t3
        else:
            return       # have a round-trip estimate; don't regress to one-way
        handle.clock_offset_s = (
            sample if handle.clock_offset_s is None
            else 0.75 * handle.clock_offset_s + 0.25 * sample)
        self._set_clock_offset_gauge(handle)

    def _set_clock_offset_gauge(self, handle: WorkerHandle) -> None:
        gauge = self._g_clock_offset.get(handle.worker_id)
        if gauge is None:
            gauge = self._g_clock_offset[handle.worker_id] = \
                self.registry.gauge(
                    "serving_pod_worker_clock_offset_seconds",
                    worker=str(handle.worker_id))
        gauge.set(handle.clock_offset_s)

    def _ingest_worker_spans(self, handle: WorkerHandle, meta: dict,
                             now: float) -> None:
        """Rebase a heartbeat's span batch into router time and index it.
        `span_seq` is the worker's export high-water mark — a duplicated
        heartbeat (at-least-once transports resend) must not double its
        spans."""
        spans = meta.get("spans")
        seq = int(meta.get("span_seq") or 0)
        if seq > handle.span_seq:
            handle.span_seq = seq
        elif spans:
            return
        if not spans:
            return
        n = ingest_spans(spans, offset_s=handle.clock_offset_s or 0.0,
                         pid=handle.pid, worker=handle.worker_id)
        if n:
            self._c_spans.inc(n)
            handle.last_span_at = now

    def _stale_msg(self, meta: dict, want_phase: str) -> "_DFlight | None":
        """Resolve a job-bearing message to its flight, or count it
        stale (unknown flight / superseded attempt / wrong phase)."""
        flight = self._flights.get(int(meta["flight_id"]))
        if (flight is None or int(meta["attempt"]) != flight.attempt
                or flight.phase != want_phase):
            self._c_stale.inc()
            return None
        return flight

    def _on_shipment(self, handle: WorkerHandle, msg: Message) -> None:
        flight = self._stale_msg(msg.meta, want_phase="prefill")
        if flight is None:
            return
        shipment = shipment_from_message(msg)
        now = self._clock()
        user = flight.user
        first = int(shipment.first_token)
        user.tokens.append(first)
        if shipment.first_logprob is not None:
            user.logprobs.append(float(shipment.first_logprob))
        user.token_times.append(now)
        if user.first_token_at is None:
            # replays keep the ORIGINAL TTFT — the user saw their first
            # token when they saw it; recovery shows up in recovery
            # latency, not a rewritten TTFT
            user.first_token_at = now
        if flight.replay_started_at is not None:
            self._h_recovery.record(now - flight.replay_started_at)
            flight.replay_started_at = None
        flight.progress_at = now
        done = (len(user.tokens) >= user.max_new_tokens
                or (user.eos_token_id is not None
                    and first == user.eos_token_id))
        if done:
            self._flights.pop(flight.flight_id, None)
            self._by_user.pop(id(user), None)
            user.status = RequestStatus.FINISHED
            user.finished_at = now
            self._finalize(user)
            return
        # the decode internal seeds the shipped first token via
        # note_token, so its budget counts from that token: remaining
        # stream = max_new minus tokens delivered BEFORE it
        flight.base = len(user.tokens) - 1
        shipment.max_new_tokens = user.max_new_tokens - flight.base
        shipment.eos_token_id = user.eos_token_id
        flight.phase = "pending"
        flight.worker = -1
        flight.shipment = shipment
        self._pending.append(flight.flight_id)

    def _on_tokens(self, handle: WorkerHandle, meta: dict) -> None:
        flight = self._stale_msg(meta, want_phase="decode")
        if flight is None:
            return
        user = flight.user
        toks, lps = meta["tokens"], meta["logprobs"]
        now = self._clock()
        # full-state sync: keep the longest prefix seen for this attempt
        # (idempotent under dup/reorder — a shorter late message is a
        # no-op, never a rewind)
        while flight.copied < len(toks):
            i = flight.copied
            user.tokens.append(int(toks[i]))
            if i < len(lps):
                user.logprobs.append(float(lps[i]))
            user.token_times.append(now)
            flight.copied += 1
        flight.progress_at = now
        if meta.get("done"):
            if meta.get("status") == RequestStatus.FINISHED.value:
                self._flights.pop(flight.flight_id, None)
                self._by_user.pop(id(user), None)
                user.status = RequestStatus.FINISHED
                user.finished_at = now
                self._finalize(user)
            else:
                # the worker's internal died under it — treat like a
                # worker drop of this one flight
                self._replay_flight(flight, RECOVER_WORKER_DROP)

    def _on_flight_refusal(self, meta: dict, reason: str,
                           want_phase: str) -> None:
        flight = self._stale_msg(meta, want_phase=want_phase)
        if flight is not None:
            self._replay_flight(flight, reason)

    def _on_bye(self, handle: WorkerHandle) -> None:
        handle.draining = True
        handle.alive = False
        for flight in [f for f in self._flights.values()
                       if f.worker == handle.worker_id
                       and f.phase in ("prefill", "decode")]:
            self._replay_flight(flight, RECOVER_WORKER_DRAINED)

    # -- failure detection & recovery ----------------------------------------

    def _detect_failures(self) -> None:
        now = self._clock()
        for handle in self.workers.values():
            if not handle.alive or handle.lost:
                continue
            if handle.channel.closed:
                self._lose_worker(handle, RECOVER_CHANNEL_DROP)
                continue
            timeout = self.pod_config.heartbeat_timeout_s
            if handle.busy:
                # the worker ANNOUNCED a long block (first compile, big
                # device step) before going quiet: busy-not-dead gets the
                # long rope, which is what lets the plain timeout stay
                # tight without phantom losses
                timeout = max(timeout,
                              self.pod_config.busy_heartbeat_timeout_s)
            if now - handle.last_heartbeat > timeout:
                self._lose_worker(handle, RECOVER_HEARTBEAT_TIMEOUT)

    def _lose_worker(self, handle: WorkerHandle, reason: str) -> None:
        handle.alive = False
        handle.lost = True
        self._c_lost.inc()
        self._note_incident(reason, f"fleet-loss-w{handle.worker_id}")
        for flight in [f for f in self._flights.values()
                       if f.worker == handle.worker_id
                       and f.phase in ("prefill", "decode")]:
            self._replay_flight(flight, reason)

    def _watch_flights(self) -> None:
        """A flight with no progress while its worker still heartbeats:
        the MESSAGE was lost, not the worker. Cancel the old attempt on
        the worker (frees its slot) and replay."""
        timeout = self.pod_config.flight_timeout_s
        if timeout is None or timeout <= 0:
            return
        now = self._clock()
        for flight in list(self._flights.values()):
            if flight.phase not in ("prefill", "decode"):
                continue
            if now - flight.progress_at <= timeout:
                continue
            handle = self.workers.get(flight.worker)
            if handle is not None and handle.alive:
                try:
                    handle.channel.send(Message("cancel", {
                        "flight_id": flight.flight_id,
                        "attempt": flight.attempt}))
                except ConnectionError:
                    pass
            self._replay_flight(flight, RECOVER_STALLED)

    def _replay_flight(self, flight: _DFlight, reason: str) -> None:
        """Recovery's one funnel: re-prefill-from-prompt. The replay
        prompt is `prompt + delivered_tokens` with the ORIGINAL sampling
        key — position-folded keys make the continuation byte-identical
        (see module docstring). Attempt bumps so stragglers of the old
        attempt are stale; attempt exhaustion sheds instead of looping."""
        now = self._clock()
        user = flight.user
        old_worker = flight.worker
        if user.trace_sampled:
            # the replay decision as a span: linked (not parented) to the
            # failed attempt's dispatch, tagged with the machine-readable
            # reason — the trace shows WHY the timeline restarts
            record_span(
                "serving.replay", flight.progress_at, now,
                trace=user.trace_id, parent=user.span_id,
                links=([flight.dispatch_span] if flight.dispatch_span
                       else None),
                recovery_reason=reason, attempt=flight.attempt,
                worker=old_worker)
        if reason in (RECOVER_STALLED, RECOVER_INSTALL_REFUSED,
                      RECOVER_WORKER_DROP):
            # loss reasons already noted in _lose_worker
            self._note_incident(reason, f"fleet-{reason}")
        self.recovery_log.append({
            "request_id": user.request_id,
            "flight_id": flight.flight_id,
            "attempt": flight.attempt,
            "recovery_reason": reason,
            "worker": old_worker,
        })
        if flight.phase == "pending":
            try:
                self._pending.remove(flight.flight_id)
            except ValueError:
                pass
        if flight.attempt >= self.pod_config.max_attempts:
            self._flights.pop(flight.flight_id, None)
            self._by_user.pop(id(user), None)
            user.status = RequestStatus.EXPIRED
            user.reject_reason = (
                f"gave up after {flight.attempt} attempts "
                f"(last: {reason} on worker {old_worker})")
            user.shed_code = SHED_WORKER_DROP
            user.retry_after_s = self.scheduler.retry_after_estimate()
            user.finished_at = now
            self.recovery_log.append({
                "request_id": user.request_id,
                "flight_id": flight.flight_id,
                "attempt": flight.attempt,
                "recovery_reason": RECOVER_GAVE_UP,
                "worker": old_worker,
            })
            self._finalize(user)
            return
        flight.attempt += 1
        flight.phase = "replay"
        flight.worker = -1
        flight.shipment = None
        flight.copied = 0
        flight.progress_at = now
        if flight.replay_started_at is None:
            flight.replay_started_at = now
        self._replay.append(flight.flight_id)
        self._c_replayed.inc()

    # -- assignment ----------------------------------------------------------

    def _role_pool(self, role: str) -> list[WorkerHandle]:
        """Alive, non-draining workers for a role. SOFT: if the role has
        no alive workers at all, every alive worker qualifies — a pod
        reduced to one survivor keeps serving both phases."""
        alive = [h for h in self.workers.values()
                 if h.alive and not h.draining]
        preferred = [h for h in alive if h.role == role]
        return preferred if preferred else alive

    def _worker_load(self, wid: int) -> int:
        return sum(1 for f in self._flights.values() if f.worker == wid)

    def _pick_worker(self, role: str) -> WorkerHandle | None:
        best, best_cap = None, 0
        for h in self._role_pool(role):
            cap = h.slots - self._worker_load(h.worker_id)
            if cap > best_cap:
                best, best_cap = h, cap
        return best

    def _assign_prefill(self) -> bool:
        """Replay queue first (recovery outranks fresh admissions — the
        user already has a live stream), then the front queue in policy
        order. Stops at the pending-shipment bound: `PodRouter`'s
        backpressure valve."""
        worked = False
        now = self._clock()
        while True:
            if len(self._pending) >= self._max_pending:
                break
            handle = self._pick_worker("prefill")
            if handle is None:
                break
            flight: _DFlight | None = None
            if self._replay:
                flight = self._flights.get(self._replay[0])
                if flight is None:        # cancelled while queued
                    self._replay.popleft()
                    continue
            if flight is None:
                name = self.scheduler._select_tenant()
                if name is None:
                    break
                user = self.scheduler._pop_selected(name)
                user.status = RequestStatus.RUNNING
                user.admitted_at = now
                if user.trace_sampled:
                    record_span("serving.queue_wait", user.submitted_at,
                                now, trace=user.trace_id,
                                parent=user.span_id, tenant=user.tenant)
                # the single engine's derivation, verbatim — and derived
                # ONCE, router-side, so every replay of this request
                # reuses the same key (exactness under recovery depends
                # on it)
                key_raw = (derive_key(self.engine_config.seed,
                                      user.request_id)
                           if user.key is None else stream_key(user.key))
                flight = _DFlight(
                    user=user, flight_id=self._next_flight_id,
                    key_raw=np.asarray(key_raw, np.uint32),
                    progress_at=now)
                self._next_flight_id += 1
                self._flights[flight.flight_id] = flight
                self._by_user[id(user)] = flight
            else:
                self._replay.popleft()
            user = flight.user
            # replay prompt = original prompt + every delivered token:
            # its "first token" samples at position prompt_len + d,
            # which IS token d of the original stream
            if user.tokens:
                prompt = np.concatenate(
                    [user.prompt, np.asarray(user.tokens, np.int32)])
            else:
                prompt = user.prompt
            # budget 2 keeps the worker's internal RUNNING past its first
            # token so pages are still mapped at extract — unless the
            # prompt is one short of max_len (`PodRouter`'s rule, re-applied
            # to the REPLAY length)
            budget = 2 if len(prompt) + 2 <= self.engine_config.max_len \
                else 1
            try:
                handle.channel.send(Message(
                    "submit",
                    {"flight_id": flight.flight_id,
                     "attempt": flight.attempt,
                     "budget": budget,
                     "temperature": user.temperature,
                     **trace_meta(user.trace_id, user.span_id or 0,
                                  user.trace_sampled)},
                    buffers=[np.asarray(prompt, np.int32), flight.key_raw]))
            except ConnectionError:
                self._lose_worker(handle, RECOVER_CHANNEL_DROP)
                # _lose_worker did NOT see this flight (worker still -1);
                # park it for the next pick
                flight.phase = "replay"
                self._replay.appendleft(flight.flight_id)
                continue
            flight.phase = "prefill"
            flight.worker = handle.worker_id
            flight.progress_at = now
            if user.trace_sampled:
                # instant marker; a later replay links back to it to say
                # WHICH attempt it supersedes
                flight.dispatch_span = record_span(
                    "serving.pod.dispatch", now, now,
                    trace=user.trace_id, parent=user.span_id,
                    flight_id=flight.flight_id, attempt=flight.attempt,
                    worker=handle.worker_id)
            worked = True
        return worked

    def _forward_pending(self) -> bool:
        """Land pending shipments on decode workers, strictly FIFO (no
        skip-ahead, `PodRouter`'s rule). The bounded channel send queue is the
        transport half of backpressure; this loop's stall counter is the
        router half — at most one increment per step."""
        worked = False
        while self._pending:
            flight = self._flights.get(self._pending[0])
            if flight is None or flight.user.done:
                self._pending.popleft()
                continue
            handle = self._pick_worker("decode")
            if handle is None:
                self._c_stalls.inc()
                break
            shipment = flight.shipment
            try:
                handle.channel.send(shipment_to_message(
                    shipment, flight_id=flight.flight_id,
                    attempt=flight.attempt,
                    **trace_meta(flight.user.trace_id,
                                 flight.user.span_id or 0,
                                 flight.user.trace_sampled)))
            except ConnectionError:
                self._lose_worker(handle, RECOVER_CHANNEL_DROP)
                continue       # head flight intact: try another worker
            self._pending.popleft()
            flight.phase = "decode"
            flight.worker = handle.worker_id
            flight.copied = 1          # the first token is already out
            flight.progress_at = self._clock()
            flight.shipment = None     # freed at send: router memory is
            #                            bounded; a lost shipment replays
            self._c_shipments.inc()
            self._c_pages_shipped.inc(shipment.n_prompt_pages)
            if flight.user.trace_sampled:
                # extracted_at was stamped on the PREFILL worker's clock:
                # rebase it into router time so the transfer span doesn't
                # float against the rest of the timeline
                src = self.workers.get(shipment.src_worker)
                offset = (src.clock_offset_s or 0.0) if src else 0.0
                start = shipment.extracted_at + offset
                record_span(
                    "serving.page_transfer", min(start, flight.progress_at),
                    flight.progress_at, trace=flight.user.trace_id,
                    parent=flight.user.span_id,
                    attempt=flight.attempt,
                    pages=shipment.n_prompt_pages,
                    bytes=shipment.page_bytes,
                    src_worker=shipment.src_worker,
                    dst_worker=handle.worker_id)
            worked = True
        return worked

    # -- elastic rebalancing -------------------------------------------------

    def _rebalance(self) -> None:
        """Convert ONE idle worker between roles per window, from live
        signals. Hysteresis: decode occupancy must cross `occupancy_high`
        to pull a prefill worker over, drop under `occupancy_low` to give
        one back — the band between is a dead zone, so the pod cannot
        flap. Never drops a role below one worker, never converts a
        worker that holds flights."""
        pc = self.pod_config
        if not pc.rebalance:
            return
        now = self._clock()
        if now - self._last_rebalance < pc.rebalance_window_s:
            return
        alive = [h for h in self.workers.values()
                 if h.alive and not h.draining]
        pref = [h for h in alive if h.role == "prefill"]
        dec = [h for h in alive if h.role == "decode"]
        if not pref or not dec:
            return      # soft-role survival mode; nothing to convert
        prefill_demand = self.scheduler.queue_depth + len(self._replay)
        decode_live = sum(1 for f in self._flights.values()
                          if f.phase == "decode")
        decode_occ = decode_live / max(1, sum(h.slots for h in dec))
        idle = [h for h in alive if self._worker_load(h.worker_id) == 0]
        target = None
        if ((decode_occ >= pc.occupancy_high
             or len(self._pending) >= self._max_pending)
                and prefill_demand == 0 and len(pref) > 1):
            cands = [h for h in idle if h.role == "prefill"]
            if cands:
                target, new_role = cands[0], "decode"
        elif (prefill_demand > 0 and decode_occ <= pc.occupancy_low
                and len(dec) > 1):
            cands = [h for h in idle if h.role == "decode"]
            if cands:
                target, new_role = cands[0], "prefill"
        if target is None:
            return
        direction = f"{target.role}_to_{new_role}"
        target.role = new_role
        self._c_conversions[direction].inc()
        self._last_rebalance = now
        try:
            target.channel.send(Message("set_role", {"role": new_role}))
        except ConnectionError:
            pass

    # -- terminal ------------------------------------------------------------

    def _finalize(self, req: Request) -> None:
        end = req.finished_at
        if end is None:
            end = self._clock()
        close_request_trace(req, end)
        self.metrics.observe_request(req)

    # -- metrics / observability ---------------------------------------------

    def _update_gauges(self) -> None:
        self._g_pending.set(len(self._pending))
        self._g_alive.set(sum(1 for h in self.workers.values() if h.alive))
        for role in ("prefill", "decode"):
            workers = [h for h in self.workers.values()
                       if h.alive and h.role == role]
            cap = sum(h.slots for h in workers)
            live = sum(self._worker_load(h.worker_id) for h in workers)
            self._g_occupancy[role].set(live / max(1, cap))

    def compile_stats(self) -> dict[str, int]:
        """Per-program compile counts as reported by worker heartbeats,
        aggregated as the MAX per program across workers — flat per
        program is still the pod's recompile guard."""
        out = {"admit": 0, "prefill": 0, "decode": 0, "extract": 0,
               "install": 0}
        for h in self.workers.values():
            for k, v in (h.compiles or {}).items():
                out[k] = max(out.get(k, 0), int(v))
        return out

    def metrics_summary(self) -> dict[str, float]:
        out = self.metrics.summary()
        out.update({f"compiles_{k}": float(v)
                    for k, v in self.compile_stats().items()})
        out["pod_shipments"] = float(self._c_shipments.value)
        out["pod_pages_shipped"] = float(self._c_pages_shipped.value)
        out["pod_backpressure_stalls"] = float(self._c_stalls.value)
        out["pod_workers_lost"] = float(self._c_lost.value)
        out["pod_workers_recovered"] = float(self._c_recovered.value)
        out["pod_requests_replayed"] = float(self._c_replayed.value)
        out["pod_stale_messages"] = float(self._c_stale.value)
        out["pod_role_conversions"] = float(sum(
            c.value for c in self._c_conversions.values()))
        if self._h_recovery.count:
            out["pod_recovery_latency_p50_ms"] = \
                self._h_recovery.quantile(0.5) * 1e3
            out["pod_recovery_latency_p99_ms"] = \
                self._h_recovery.quantile(0.99) * 1e3
            out["pod_recovery_latency_mean_ms"] = self._h_recovery.mean * 1e3
        out["pod_spans_ingested"] = float(self._c_spans.value)
        now = self._clock()
        lags = [now - h.last_span_at for h in self.workers.values()
                if h.last_span_at is not None]
        if lags:
            # the SLOWEST exporter bounds how fresh a merged trace is
            out["pod_span_export_lag_s"] = max(lags)
        return out

    def exposition_registry(self) -> MetricsRegistry:
        """The router's `/metrics` view: its own series verbatim, plus
        every worker's last-heartbeat registry snapshot merged with the
        `aggregate_snapshot` semantics (counter sums, gauge min/mean/max,
        sketch-merged histograms incl. `__slowest_host_mean`) under
        `origin="workers"` — one scrape shows the whole pod, no process
        group involved.

        Staleness-honest: every contributing snapshot also exposes its
        age (`serving_pod_worker_snapshot_age_seconds{worker=}`), and a
        LOST worker's numbers merge under an extra `stale="true"` label —
        frozen counters from a dead process must not impersonate live
        ones. Past `snapshot_stale_after_s` (when set) they drop
        entirely."""
        reg = MetricsRegistry()
        for kind, name, labels, metric in self.registry.items():
            if kind == "counter":
                reg.counter(name, **dict(labels)).inc(metric.value)
            elif kind == "gauge":
                reg.gauge(name, **dict(labels)).set(metric.value)
            else:
                reg.histogram(name, **dict(labels)).merge(metric)
        now = self._clock()
        horizon = self.pod_config.snapshot_stale_after_s
        live, stale = [], []
        for h in self.workers.values():
            if h.snapshot is None:
                continue
            reg.gauge("serving_pod_worker_snapshot_age_seconds",
                      worker=str(h.worker_id)).set(
                          max(0.0, now - h.snapshot_at))
            if h.alive and not h.lost:
                live.append(h.snapshot)
            elif horizon is None or now - h.last_heartbeat <= horizon:
                stale.append(h.snapshot)
        if live:
            merged_registry(live, registry=reg, origin="workers")
        if stale:
            merged_registry(stale, registry=reg, origin="workers",
                            stale="true")
        return reg

    def reset_metrics(self) -> None:
        self.registry.reset()
        self.metrics = ServingMetrics(registry=self.registry)
        self.scheduler.step_time_ema = 0.0

    def close(self) -> None:
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        for handle in self.workers.values():
            try:
                handle.channel.send(Message("drain", {}))
            except ConnectionError:
                pass
            handle.channel.close()
        if self.listener is not None:
            self.listener.close()

    # -- introspection -------------------------------------------------------

    def debug_requests(self) -> dict:
        from ...engine import Engine

        now = self._clock()
        return {
            "queued": [Engine._request_info(r, now)
                       for r in self.scheduler.queue],
            "running": [dict(Engine._request_info(f.user, now),
                             phase=f.phase, attempt=f.attempt,
                             worker=f.worker)
                        for f in self._flights.values()],
        }

    def debug_pod(self) -> dict:
        phases: dict[str, int] = {}
        for f in self._flights.values():
            phases[f.phase] = phases.get(f.phase, 0) + 1
        now = self._clock()
        return {
            "workers": [{
                "worker_id": h.worker_id, "role": h.role,
                "alive": h.alive, "lost": h.lost, "draining": h.draining,
                "busy": h.busy, "pid": h.pid,
                "slots": h.slots,
                "load": self._worker_load(h.worker_id),
                "heartbeat_age_s": (now - h.last_heartbeat
                                    if h.last_heartbeat else None),
                "snapshot_age_s": (now - h.snapshot_at
                                   if h.snapshot is not None else None),
                "clock_offset_s": h.clock_offset_s,
                "clock_rtt_s": h.clock_rtt_s,
                "span_export_lag_s": (now - h.last_span_at
                                      if h.last_span_at is not None
                                      else None),
                "stats": h.stats, "compiles": h.compiles,
            } for h in self.workers.values()],
            "in_flight": phases,
            "queued": self.scheduler.queue_depth,
            "pending_shipments": len(self._pending),
            "replay_queue": len(self._replay),
            "max_pending_shipments": self._max_pending,
            "workers_lost_total": int(self._c_lost.value),
            "workers_recovered_total": int(self._c_recovered.value),
            "requests_replayed_total": int(self._c_replayed.value),
            "recovery_log": list(self.recovery_log)[-16:],
        }

    def debug_slots(self) -> list[dict]:
        # the router holds no slots; the /debug/slots route gets the
        # heartbeat-reported occupancy of every worker instead
        return [{
            "worker": h.worker_id, "role": h.role, "alive": h.alive,
            "slots": h.slots,
            "live_slots": (h.stats or {}).get("live_slots"),
            "flights": self._worker_load(h.worker_id),
        } for h in self.workers.values()]

    def debug_pages(self) -> dict:
        return {str(h.worker_id): {
            "role": h.role, "alive": h.alive,
            "pages_free": (h.stats or {}).get("pages_free"),
            "pages_in_use": (h.stats or {}).get("pages_in_use"),
        } for h in self.workers.values()}

    def debug_scheduler(self) -> dict:
        out = self.scheduler.debug_state()
        out["pod"] = {
            "in_flight": len(self._flights),
            "pending_shipments": len(self._pending),
            "replay_queue": len(self._replay),
        }
        return out

    def incident_dumps(self) -> dict:
        out: dict[str, Any] = {}
        for name, build in (
            ("pod", self.debug_pod),
            ("requests", self.debug_requests),
            ("scheduler", self.debug_scheduler),
            ("compile_stats", self.compile_stats),
            ("clock_offsets", self._clock_offsets),
            ("flights_trace", self._flights_trace),
        ):
            try:
                out[name] = build()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- fleet incident bundles ----------------------------------------------

    def _clock_offsets(self) -> dict:
        now = self._clock()
        return {str(h.worker_id): {
            "role": h.role, "alive": h.alive, "lost": h.lost,
            "offset_s": h.clock_offset_s, "rtt_s": h.clock_rtt_s,
            "heartbeat_age_s": (now - h.last_heartbeat
                                if h.last_heartbeat else None),
        } for h in self.workers.values()}

    def _flights_trace(self) -> dict:
        """Merged chrome traces of every in-flight sampled request —
        worker spans are already rebased into router time at ingest, so
        each document is ONE aligned Perfetto timeline."""
        out: dict[str, Any] = {}
        for f in self._flights.values():
            tid = f.user.trace_id
            if tid is None or not f.user.trace_sampled:
                continue
            try:
                out[str(tid)] = export_chrome_trace(trace_id=tid)
            except Exception as e:
                out[str(tid)] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def _note_incident(self, reason: str, name: str | None = None) -> None:
        """Arm a fleet bundle for the END of this step. First trigger
        wins — a cascade (loss -> replays -> sanitizer) is one incident,
        not four bundles."""
        if self._incident_dir is None:
            return
        if self._pending_incident is None:
            self._pending_incident = (reason, name or f"fleet-{reason}")

    def _maybe_write_fleet_bundle(self) -> None:
        if self._pending_incident is None:
            return
        reason, name = self._pending_incident
        self._pending_incident = None
        # wall clock on purpose: rate-limits real disk writes even under
        # a fake injected clock, so a flake storm cannot DoS the disk
        now = time.monotonic()
        if (self._last_fleet_bundle is not None
                and now - self._last_fleet_bundle
                < self.pod_config.fleet_bundle_min_interval_s):
            return
        self._last_fleet_bundle = now
        try:
            self.write_fleet_incident_bundle(reason, name=name)
        except Exception:
            pass   # incident capture must never take down serving

    def fetch_worker_dumps(self, timeout_s: float | None = None) \
            -> dict[int, dict]:
        """`incident_dumps` from every reachable worker over a bounded
        RPC: fan out `incident_request`, pump replies off the normal
        dispatch path, give up per-worker at the deadline. Unreachable
        workers yield a `worker_error` stanza — a fleet bundle is always
        complete, just honest about holes."""
        budget = (self.pod_config.incident_rpc_timeout_s
                  if timeout_s is None else timeout_s)
        self._incident_seq += 1
        rid = self._incident_seq
        out: dict[int, dict] = {}
        asked: list[WorkerHandle] = []
        for handle in self.workers.values():
            if not handle.alive or handle.channel.closed:
                out[handle.worker_id] = {
                    "worker_error": "unreachable (lost)"}
                continue
            try:
                handle.channel.send(
                    Message("incident_request", {"req_id": rid}))
            except ConnectionError:
                out[handle.worker_id] = {
                    "worker_error": "unreachable (send failed)"}
                continue
            asked.append(handle)
        # wall-clock deadline: an injected fake clock doesn't tick while
        # we block here, and a dead worker must not hang the bundle
        deadline = time.monotonic() + budget
        while asked and time.monotonic() < deadline:
            for handle in asked:
                if handle.local is not None and not handle.lost:
                    handle.local.run_once()
            self._dispatch_inbound()
            for handle in list(asked):
                dumps = self._incident_replies.pop(
                    (rid, handle.worker_id), None)
                if dumps is not None:
                    out[handle.worker_id] = dumps
                    asked.remove(handle)
            if asked and not self._has_local_workers():
                # deliberate: incident capture is synchronous by design —
                # the pod is already broken, and the wait is bounded by
                # `budget` above
                time.sleep(0.005)
        for handle in asked:
            out[handle.worker_id] = {
                "worker_error": f"no reply within {budget}s"}
        return out

    def write_fleet_incident_bundle(self, reason: str,
                                    name: str | None = None) -> str | None:
        """ONE bundle for a pod-wide event: the router's own dumps, every
        reachable worker's `incident_dumps` (`worker_<id>` sections),
        clock offsets, and the merged chrome trace of each in-flight
        request. Returns the bundle path (None when no incident dir)."""
        if self._incident_dir is None:
            return None
        worker_dumps = self.fetch_worker_dumps()
        dumps: dict[str, Any] = self.incident_dumps()
        for wid, wd in sorted(worker_dumps.items()):
            dumps[f"worker_{wid}"] = wd
        report = {
            "kind": "fleet_incident",
            "reason": reason,
            "workers": sorted(self.workers),
            "clock_offsets": dumps.get("clock_offsets"),
            "recovery_log": list(self.recovery_log)[-32:],
        }
        return write_incident_bundle(
            self._incident_dir, report,
            registry=self.exposition_registry(), dumps=dumps,
            name=name or f"fleet-{reason}")


# ---------------------------------------------------------------------------
# in-process factory (the deterministic `local` distributed form)
# ---------------------------------------------------------------------------


def build_local_distributed_pod(
    family, config, params,
    engine_config: EngineConfig | None = None,
    pod_config: DistributedPodConfig | None = None,
    clock=time.monotonic,
    channel_wrap=None,
    device=None,
):
    """Router + in-process `WorkerServer`s over `LocalChannel` pairs —
    every message still crosses the wire codec, the clock can be fake,
    and the router pumps the workers itself, so the whole distributed
    protocol (heartbeats, recovery, rebalancing) runs deterministically
    in one interpreter. `channel_wrap(worker_id, role, channel)` may
    wrap the ROUTER-side endpoint (e.g. with `FlakyTransport`). The
    worker engines share `params` and run on `device` (CUDA unless
    "cpu").

    Returns (router, workers)."""
    from ...engine import Engine
    from .transport import LocalChannel

    ec = engine_config or EngineConfig()
    pc = pod_config or DistributedPodConfig()
    worker_ec = dataclasses.replace(
        ec, tenants=None, metrics_port=None, watchdog_timeout_s=None,
        incident_dir=None, speculative=None)
    router = DistributedPodRouter(
        engine_config=ec, pod_config=pc, clock=clock)
    workers = []
    wid = 0
    for role, count in (("prefill", pc.prefill_workers),
                        ("decode", pc.decode_workers)):
        for _ in range(count):
            router_side, worker_side = LocalChannel.pair()
            if channel_wrap is not None:
                router_side = channel_wrap(wid, role, router_side)
            engine = Engine(family, config, params, worker_ec, device=device,
                            clock=clock)
            engine.close()   # heartbeats are the worker's only exporter
            server = WorkerServer(
                engine, worker_side, worker_id=wid, role=role,
                heartbeat_interval_s=pc.heartbeat_interval_s, clock=clock,
                # in-process workers share the router's span ring —
                # exporting over the wire would double every span
                export_spans=False)
            router.register_worker(router_side, wid, role,
                                   slots=len(engine.scheduler.slots),
                                   local=server)
            workers.append(server)
            wid += 1
    return router, workers
