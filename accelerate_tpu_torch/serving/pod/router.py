"""Pod layer 2: disaggregated prefill/decode workers and the router
(port of `accelerate_tpu/serving/pod/router.py`).

Prefill and decode are different programs with different economics:
prefill is compute-bound (one long matmul burst per prompt, then done),
decode is latency- and memory-bound (one small step per token). Sharing
one engine means every arriving prompt steals a step from every running
stream; the chunked-prefill interleave bounds the theft at one chunk but
never removes it. Splitting the roles does: dedicated PREFILL workers
turn prompts into KV pages and a first token, dedicated DECODE workers
own slots and stream tokens, and the pages ship between them
(serving/pod/transfer.py).

`PodRouter` is the host-side control plane gluing the roles together
behind the ordinary `ServingEngine` API (submit/stream/astream/cancel/
finish/step/run_until_idle, scheduler introspection, metrics, debug
views), so the HTTP front door, tenant tiers, SLO shedding and request
tracing of the server layer run unchanged on top:

- admission: a zero-slot `Scheduler` subclass keeps the full tenant/
  tier/DRR/SLO policy surface as THE front queue; the router drains it
  in policy order onto the least-loaded prefill worker;
- page-transfer bookkeeping: each prompt's flight is tracked
  prefill -> (shipment) -> decode; completed shipments wait in a
  bounded buffer until a decode worker has a free slot AND pages;
- backpressure: a decode side with no capacity stalls the ROUTER (the
  shipment buffer fills, new prefill assignment pauses), never the
  prefill worker: in-flight prefills finish and park, and decode
  workers drain at their own pace. Counted in
  `serving_pod_backpressure_stalls_total`.

Workers are ordinary `Engine` instances on one device sharing one copy
of the params, driven synchronously by `step()`: the router IS the
schedule, so worker state never races and the whole pod is
deterministic on a seeded trace. Each request keeps the key the single
engine would give it (its own key, else the engine seed hashed with the
front queue's request id), and a token's draw depends only on (key,
position), so the pod's streams equal the single engine's on the same
trace, sampled ones included. Decode workers run the engine's decode
program, with the paged-decode kernel when `paged_attention` selects it.
In-process workers stand in for per-host processes; the shipment
dataclass is the wire format the multi-process pod serializes
(serving/pod/distributed).

Layer 1 under layer 2 (`PodConfig.tensor_parallel > 1`, or
`EngineConfig.mesh`): one mesh and one placed copy of the params, shared
by every worker, so each worker is a tensor-parallel engine
(serving/pod/mesh.py). Every rank of the mesh then runs the whole router
SPMD, each over its shards; the router's clock is the mesh's lockstep
clock, so its decisions, and its workers', are the same on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, AsyncIterator, Iterator

import numpy as np

from ...models.decode import derive_key, stream_key
from ...telemetry.export import start_metrics_server
from ...telemetry.registry import MetricsRegistry
from ...telemetry.trace import record_span
from ...telemetry.watchdog import StallWatchdog, resolve_stall_timeout
from ..engine import (
    Engine,
    EngineConfig,
    _check_ported,
    close_request_trace,
    prepare_request_tracing,
)
from ..metrics import ServingMetrics
from ..sanitizer import check_router, resolve_sanitize
from ..scheduler import (
    Request,
    RequestStatus,
    Scheduler,
    SHED_WORKER_DROP,
    SlotState,
)
from .mesh import lockstep_clock, shard_params, tensor_mesh
from .transfer import PageTransport, place_shipment

__all__ = ["PodConfig", "PodRouter", "PodEngine"]


@dataclasses.dataclass(frozen=True)
class PodConfig:
    """Role split + transfer knobs for a disaggregated pod.

    `prefill_workers`/`decode_workers` are worker counts per role;
    `prefill_slots` sizes the prefill workers' slot tables (None = the
    engine config's num_slots — decode workers always use it).
    `tensor_parallel` > 1 mesh-shards every worker over the first N
    processes (layer 1 under layer 2).
    `max_pending_shipments` bounds the prefill->decode buffer: when full
    the router stops assigning new prompts to prefill workers — the
    backpressure valve (None = one full decode worker's worth of
    slots, floor 2)."""

    prefill_workers: int = 1
    decode_workers: int = 1
    prefill_slots: int | None = None
    tensor_parallel: int = 1
    max_pending_shipments: int | None = None

    def __post_init__(self):
        if self.prefill_workers < 1 or self.decode_workers < 1:
            raise ValueError(
                "a pod needs at least one worker per role (got "
                f"prefill={self.prefill_workers}, "
                f"decode={self.decode_workers})")
        if self.tensor_parallel < 1:
            raise ValueError(
                f"tensor_parallel must be >= 1, got {self.tensor_parallel}")


class _FrontScheduler(Scheduler):
    """The pod's user-facing admission queue: the whole tenant/tier/DRR/
    SLO policy of the base scheduler with ZERO slots of its own — the
    router pops requests in policy order and places them on workers, so
    `live_slots`/`running` report the router's in-flight set (the server
    drive loop and drain path read these)."""

    def __init__(self, router: "PodRouter", **kwargs):
        super().__init__(num_slots=0, **kwargs)
        self._router = router

    @property
    def live_slots(self) -> int:  # type: ignore[override]
        return len(self._router._flights)

    def running(self):
        return [f.user for f in self._router._flights.values()]


@dataclasses.dataclass
class _Flight:
    """One user request's journey through the pod."""

    user: Request
    phase: str                    # "prefill" | "pending" | "decode"
    internal: Request | None = None
    worker: int = -1
    pages: list | None = None     # prefill-side allocation, recorded at admit
    shipment: Any = None
    copied: int = 0               # internal tokens mirrored to user so far


class PodRouter:
    """Disaggregated serving pod behind the `ServingEngine` API (see the
    module docstring for the architecture). Construct it exactly like an
    `Engine`: family, config, params, `EngineConfig`, `device` (CUDA
    unless "cpu"; `params` must live there), plus a `PodConfig` for the
    role split."""

    def __init__(
        self,
        family,
        config,
        params,
        engine_config: EngineConfig | None = None,
        pod_config: PodConfig | None = None,
        clock=time.monotonic,
        device=None,
    ):
        self.config = config
        self.engine_config = ec = engine_config or EngineConfig()
        self.pod_config = pc = pod_config or PodConfig()
        _check_ported(ec)

        # layer 1 under layer 2: one shared mesh + ONE placed params copy
        # (in-process workers alias the same tensors)
        mesh = None
        if pc.tensor_parallel > 1 or ec.mesh is not None:
            mesh = ec.mesh if ec.mesh is not None \
                else tensor_mesh(pc.tensor_parallel, device=device)
            if mesh.size > 1:
                params = shard_params(params, mesh)
                clock = lockstep_clock(clock, mesh)
        self._clock = clock
        # in-process workers share one copy of the params (on the
        # engine's device); workers own no observability side-cars: the pod facade is the
        # one exporter/watchdog surface (close() below stops the threads
        # the Engine constructor may have started from env config).
        # speculative is stripped: a spec worker's five-program surface
        # doesn't match the pod's extract/install protocol (the install
        # path drives the classic admit program directly) — pod +
        # speculation is a future arc, not a silent half-configuration
        worker_ec = dataclasses.replace(
            ec, mesh=mesh, tenants=None, metrics_port=None,
            watchdog_timeout_s=None, incident_dir=None, speculative=None)
        prefill_ec = dataclasses.replace(
            worker_ec, num_slots=pc.prefill_slots or ec.num_slots)

        def _make(worker_cfg):
            eng = Engine(family, config, params, worker_cfg, device=device,
                         clock=clock)
            eng.close()  # stop any env-armed exporter/watchdog side-cars
            return eng

        self.prefill_workers = [_make(prefill_ec)
                                for _ in range(pc.prefill_workers)]
        self.decode_workers = [_make(worker_ec)
                               for _ in range(pc.decode_workers)]
        # hook every prefill worker's admission (Engine.on_admit): the
        # page allocation must be snapshotted the instant it exists — a
        # short prompt can admit, prefill, and retire inside ONE
        # engine.step(), and the alloc dies with the slot (the page
        # *content* survives until the next admission, which is the
        # window extract uses)
        for engine in self.prefill_workers:
            engine.on_admit = self._record_admit
        self._transports_p = [PageTransport(w) for w in self.prefill_workers]
        self._transports_d = [PageTransport(w) for w in self.decode_workers]

        self._sanitize = resolve_sanitize(ec.sanitize)
        self._flights: dict[int, _Flight] = {}   # id(user) -> flight
        # id(internal) -> page list, written by the admit hook the moment
        # a prefill worker maps the request (popped at harvest/cancel)
        self._admit_pages: dict[int, list] = {}
        self._pending: deque[_Flight] = deque()
        self._max_pending = pc.max_pending_shipments
        if self._max_pending is None:
            self._max_pending = max(2, ec.num_slots)

        self.scheduler = _FrontScheduler(
            self, max_len=ec.max_len, max_queue=ec.max_queue, clock=clock,
            tenants=ec.tenants, prefill_chunk=ec.prefill_chunk)
        self.registry = MetricsRegistry()
        self.metrics = ServingMetrics(registry=self.registry)
        self._c_shipments = self.registry.counter(
            "serving_pod_shipments_total")
        self._c_pages_shipped = self.registry.counter(
            "serving_pod_pages_shipped_total")
        self._c_stalls = self.registry.counter(
            "serving_pod_backpressure_stalls_total")
        self._c_affinity = self.registry.counter(
            "serving_pod_affinity_hits_total")
        self._g_pending = self.registry.gauge(
            "serving_pod_pending_shipments")
        self._g_occupancy = {
            role: self.registry.gauge("serving_pod_role_occupancy",
                                      role=role)
            for role in ("prefill", "decode")}
        self._g_pages_free = {
            role: self.registry.gauge("serving_pod_role_pages_free",
                                      role=role)
            for role in ("prefill", "decode")}
        self.metrics_server = start_metrics_server(
            ec.metrics_port, registry=self.registry)
        self.watchdog: StallWatchdog | None = None
        wd_timeout = resolve_stall_timeout(ec.watchdog_timeout_s)
        if wd_timeout is not None:
            self.watchdog = StallWatchdog(
                wd_timeout, name="serving-pod-router",
                incident_dir=ec.incident_dir, registry=self.registry,
                dumps=self.incident_dumps).start()

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
        """`Engine.submit`, pod-routed: the handle returned is the live
        request object — tokens stream into it as decode workers produce
        them, overload is reported on it (REJECTED + shed_code +
        retry_after_s), and the trace identity is identical to the
        single-engine path."""
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
        # drain first, THEN capacity-check (the single engine's rule):
        # expired entries and assignable work must free queue positions
        # before the newcomer is judged against max_queue
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
            # eager assignment (the single engine admits eagerly too):
            # a free prefill slot starts the prompt now, not next step
            self._assign_prefill()
        return req

    def cancel(self, request: Request) -> bool:
        if request.done:
            return False
        if self.scheduler.cancel(request):        # still front-queued
            self._finalize(request)
            return True
        flight = self._flights.get(id(request))
        if flight is None:
            return False
        if flight.phase == "prefill":
            self.prefill_workers[flight.worker].cancel(flight.internal)
            self._admit_pages.pop(id(flight.internal), None)
        elif flight.phase == "decode":
            self._copy_tokens(flight)
            self.decode_workers[flight.worker].cancel(flight.internal)
        elif flight.phase == "pending":
            try:
                self._pending.remove(flight)
            except ValueError:
                pass
        del self._flights[id(request)]
        request.status = RequestStatus.CANCELLED
        request.finished_at = self._clock()
        self._finalize(request)
        return True

    def finish(self, request: Request) -> bool:
        """Retire a running request as FINISHED before its budget (the
        server's stop-sequence path) — tokens delivered so far stand."""
        if request.done:
            return False
        flight = self._flights.get(id(request))
        if flight is None:
            return False
        if flight.phase == "prefill":
            self.prefill_workers[flight.worker].cancel(flight.internal)
            self._admit_pages.pop(id(flight.internal), None)
        elif flight.phase == "decode":
            self._copy_tokens(flight)
            self.decode_workers[flight.worker].finish(flight.internal)
        elif flight.phase == "pending":
            try:
                self._pending.remove(flight)
            except ValueError:
                pass
        del self._flights[id(request)]
        request.status = RequestStatus.FINISHED
        request.finished_at = self._clock()
        self._finalize(request)
        return True

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
            await asyncio.sleep(0)
        for tok in request.tokens[sent:]:
            yield tok

    # -- the drive loop ------------------------------------------------------

    def step(self) -> bool:
        """One router round: shed, assign prompts to prefill workers,
        pump prefill (harvest finished prompts into shipments), land
        shipments on decode workers, pump decode (mirror tokens out).
        Returns False when the whole pod is idle."""
        if self.metrics.started_at is None:
            self.metrics.started_at = self._clock()
        if self.watchdog is not None:
            self.watchdog.tick()
        t0 = self._clock()
        self.scheduler.shed_expired(t0)
        for victim in self.scheduler.drain_shed():
            self._finalize(victim)
        worked = self._assign_prefill()
        worked = self._pump_prefill() or worked
        worked = self._install_pending() or worked
        worked = self._pump_decode() or worked
        self._update_gauges()
        self.metrics.stopped_at = self._clock()
        if worked:
            self.scheduler.note_step_time(self.metrics.stopped_at - t0)
            live = sum(w.scheduler.live_slots for w in self.decode_workers)
            cap = sum(len(w.scheduler.slots) for w in self.decode_workers)
            self.metrics.observe_step(live, cap, self.scheduler.queue_depth)
        if self._sanitize:
            # router-level joins (flights vs pending vs admit snapshots
            # vs front queue); worker engines sanitize themselves inside
            # their own step()
            check_router(self)
        return worked

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # -- role pumps ----------------------------------------------------------

    def _worker_capacity(self, engine: Engine) -> int:
        """Free prefill intake = idle slots minus already-queued work
        (the router only hands a worker what it can start now — ordering
        stays with the front queue's policy, not a worker FIFO)."""
        sched = engine.scheduler
        return (len(sched.slots) - sched.live_slots - sched.queue_depth)

    def _assign_prefill(self) -> bool:
        """Drain the front queue in policy order onto prefill workers.
        Stops at the backpressure bound: a full shipment buffer means the
        decode side owes us capacity, and prefilling further prompts
        would only pile pages up."""
        worked = False
        now = self._clock()
        while True:
            if len(self._pending) >= self._max_pending:
                # the stall itself is COUNTED in _install_pending (once
                # per router step, at the failed head placement) — this
                # site merely stops feeding the full buffer, and
                # incrementing here too would scale the counter with
                # submit rate instead of with stalled steps
                break
            name = self.scheduler._select_tenant()
            if name is None:
                break
            capacities = [self._worker_capacity(w)
                          for w in self.prefill_workers]
            widx = int(np.argmax(capacities))
            if capacities[widx] <= 0:
                break
            user = self.scheduler._pop_selected(name)
            user.status = RequestStatus.RUNNING
            user.admitted_at = now
            if user.trace_sampled:
                record_span("serving.queue_wait", user.submitted_at, now,
                            trace=user.trace_id, parent=user.span_id,
                            tenant=user.tenant)
            # the single engine's derivation, verbatim: the request's
            # own key, else the seed hashed with the request id (the
            # front queue numbers requests as a single engine's scheduler
            # does), so the same trace samples the same streams whether
            # served by a pod or by one engine
            key_raw = np.asarray(
                derive_key(self.engine_config.seed, user.request_id)
                if user.key is None else stream_key(user.key), np.uint32)
            engine = self.prefill_workers[widx]
            # budget 2 keeps the internal request RUNNING past its first
            # token (no self-retire inside engine.step), so its pages are
            # still mapped when the router extracts; the router then
            # finish_early()s it — unless the prompt is one token short
            # of max_len, where budget 1 is forced and the harvest relies
            # on extract-before-next-step (pages freed at retire are only
            # reallocatable at the NEXT admission)
            budget = 2 if user.prompt_len + 2 <= self.engine_config.max_len \
                else 1
            internal = engine.submit(
                user.prompt, max_new_tokens=budget,
                temperature=user.temperature, key=key_raw,
                trace_sampled=False)
            flight = _Flight(user=user, phase="prefill", internal=internal,
                             worker=widx)
            self._flights[id(user)] = flight
            if internal.done:
                # defensive: the engine refused our internal (can't
                # happen under the capacity/budget math above, but a
                # silent drop must not strand the user handle)
                self._harvest(engine, widx)
            worked = True
        return worked

    def _record_admit(self, slot, req) -> None:
        """Prefill workers' `Engine.on_admit` hook: snapshot every
        admission's page list (prefill workers serve only router
        internals, so recording all admissions is recording ours — and
        it works even when the admit happens inside `engine.submit`,
        before the flight object exists)."""
        self._admit_pages[id(req)] = list(slot.alloc.pages)

    def _pump_prefill(self) -> bool:
        worked = False
        for widx, engine in enumerate(self.prefill_workers):
            if engine.scheduler.has_work():
                engine.step()
                worked = True
            self._harvest(engine, widx)
        return worked

    def _harvest(self, engine: Engine, widx: int) -> None:
        """Collect internals whose prompt finished prefilling on this
        worker: deliver the first token to the user (TTFT lands here),
        extract the prompt's pages into a shipment — or finish the user
        outright when the first token already completes the request
        (budget 1, or EOS on the first token: nothing to ship)."""
        now = self._clock()
        for flight in list(self._flights.values()):
            if flight.phase != "prefill" or flight.worker != widx:
                continue
            internal, user = flight.internal, flight.user
            if not internal.tokens and not internal.done:
                continue
            if internal.done and internal.status is not RequestStatus.FINISHED:
                # the internal died (can't happen via router policy, but
                # a worker-side wedge must not strand the user request)
                self._admit_pages.pop(id(internal), None)
                del self._flights[id(user)]
                user.status = RequestStatus.EXPIRED
                user.reject_reason = (
                    f"prefill worker {widx} dropped the request "
                    f"({internal.status.value})")
                # every shed carries the machine-readable vocabulary +
                # a backoff hint
                user.shed_code = SHED_WORKER_DROP
                user.retry_after_s = self.scheduler.retry_after_estimate()
                user.finished_at = now
                self._finalize(user)
                continue
            first = int(internal.tokens[0])
            flight.pages = self._admit_pages.pop(id(internal), None)
            user.tokens.append(first)
            if internal.logprobs:
                user.logprobs.append(internal.logprobs[0])
            user.token_times.append(now)
            user.first_token_at = now
            done = (user.max_new_tokens <= 1
                    or (user.eos_token_id is not None
                        and first == user.eos_token_id))
            if done:
                if not internal.done:
                    engine.finish(internal)
                del self._flights[id(user)]
                user.status = RequestStatus.FINISHED
                user.finished_at = now
                self._finalize(user)
                continue
            shipment = self._transports_p[widx].extract_shipment(
                flight.pages, internal, src_worker=widx, extracted_at=now)
            shipment.max_new_tokens = user.max_new_tokens
            shipment.eos_token_id = user.eos_token_id
            if not internal.done:
                # retire as FINISHED: the prompt's pages enter this
                # worker's prefix tree, so shared prefixes prefill once
                # per WORKER, not once per request
                engine.finish(internal)
            flight.phase = "pending"
            flight.internal = None
            flight.shipment = shipment
            self._pending.append(flight)

    def _install_pending(self) -> bool:
        """Land shipments on decode workers, strictly FIFO — the head
        shipment tries every worker, and if none has a slot AND pages the
        router waits (no skip-ahead: a big request must not starve behind
        luckier small ones). This is the backpressure point: the decode
        side stalls the ROUTER's buffer, never a prefill worker — and the
        ONLY place the stall counter increments (at most once per router
        step), so `serving_pod_backpressure_stalls_total` counts stalled
        steps, not client submit attempts."""
        worked = False
        while self._pending:
            flight = self._pending[0]
            if flight.user.done:           # cancelled while parked
                self._pending.popleft()
                continue
            placed = self._try_install(flight)
            if not placed:
                self._c_stalls.inc()
                break
            self._pending.popleft()
            worked = True
        return worked

    def _try_install(self, flight: _Flight) -> bool:
        user, shipment = flight.user, flight.shipment
        # prefix affinity: a worker whose radix tree already holds this
        # prompt's prefix turns the shipment's leading pages into a local
        # hit (HBM: free; host tier: one swap-in's worth of reserve, and
        # the shipment bytes overwrite the reserved pages value-exactly,
        # so the mirror is just dropped). HBM residency outranks host,
        # residency outranks emptiness; ties fall back to least-loaded.
        # residency_probe never touches LRU order — probing every worker
        # must not manufacture recency for the losers.
        scores = []
        for w in self.decode_workers:
            hbm = host = 0
            if w.allocator.index is not None:
                hbm, host = w.allocator.index.residency_probe(
                    shipment.prompt)
            scores.append(2 * hbm + host)
        order = sorted(
            range(len(self.decode_workers)),
            key=lambda i: (-scores[i],
                           -self.decode_workers[i].allocator.pages_free))
        for widx in order:
            engine = self.decode_workers[widx]
            # clock BEFORE the page reservation: placement owns the whole
            # allocate->adopt->install sequence (shared with the
            # multi-host worker's install handler — see
            # transfer.place_shipment)
            now = self._clock()
            placed = place_shipment(
                engine, self._transports_d[widx], shipment, now)
            if placed is None:
                continue
            internal, _slot, _alloc = placed
            if scores[widx] > 0:
                self._c_affinity.inc()
            flight.phase = "decode"
            flight.worker = widx
            flight.internal = internal
            flight.copied = 1
            self._c_shipments.inc()
            self._c_pages_shipped.inc(shipment.n_prompt_pages)
            if user.trace_sampled:
                record_span(
                    "serving.page_transfer", shipment.extracted_at, now,
                    trace=user.trace_id, parent=user.span_id,
                    pages=shipment.n_prompt_pages,
                    bytes=shipment.page_bytes,
                    src_worker=shipment.src_worker, dst_worker=widx)
            flight.shipment = None
            return True
        return False

    def _copy_tokens(self, flight: _Flight) -> None:
        internal, user = flight.internal, flight.user
        while flight.copied < len(internal.tokens):
            user.tokens.append(internal.tokens[flight.copied])
            if flight.copied < len(internal.logprobs):
                user.logprobs.append(internal.logprobs[flight.copied])
            user.token_times.append(internal.token_times[flight.copied])
            flight.copied += 1

    def _pump_decode(self) -> bool:
        worked = False
        for widx, engine in enumerate(self.decode_workers):
            if engine.scheduler.has_work():
                engine.step()
                worked = True
        for flight in list(self._flights.values()):
            if flight.phase != "decode":
                continue
            self._copy_tokens(flight)
            internal, user = flight.internal, flight.user
            if internal.done:
                del self._flights[id(user)]
                user.status = internal.status
                user.finished_at = internal.finished_at
                self._finalize(user)
        return worked

    def _finalize(self, req: Request) -> None:
        """The pod's one terminal path (mirror of
        Engine._finalize_request): close the request's trace, fold it
        into the pod-level metrics."""
        end = req.finished_at
        if end is None:
            end = self._clock()
        close_request_trace(req, end)
        self.metrics.observe_request(req)

    # -- metrics / observability ---------------------------------------------

    def _update_gauges(self) -> None:
        self._g_pending.set(len(self._pending))
        for role, workers in (("prefill", self.prefill_workers),
                              ("decode", self.decode_workers)):
            cap = sum(len(w.scheduler.slots) for w in workers)
            live = sum(w.scheduler.live_slots for w in workers)
            self._g_occupancy[role].set(live / max(1, cap))
            self._g_pages_free[role].set(
                sum(w.allocator.pages_free for w in workers))

    def compile_stats(self) -> dict[str, int]:
        """Per-program compile counts, aggregated as the MAX across the
        workers of each role — flat per role is the pod's recompile
        guard (a single worker creeping means its sharding layout lost
        its fixed point)."""
        out = {"admit": 0, "prefill": 0, "decode": 0, "extract": 0,
               "install": 0}
        for w in self.prefill_workers + self.decode_workers:
            for k, v in w.compile_stats().items():
                out[k] = max(out[k], v)
        for t in self._transports_p + self._transports_d:
            for k, v in t.compile_stats().items():
                out[k] = max(out[k], v)
        return out

    def metrics_summary(self) -> dict[str, float]:
        out = self.metrics.summary()
        # step/page counters live in the WORKER engines (the pod-level
        # ServingMetrics only sees request terminals): aggregate them so
        # the summary reads like a single engine's
        out["prefill_chunks"] = float(sum(
            w.metrics.prefill_chunks for w in self.prefill_workers))
        out["decode_steps"] = float(sum(
            w.metrics.decode_steps for w in self.decode_workers))
        out["pages_in_use"] = float(sum(
            w.allocator.pages_in_use
            for w in self.prefill_workers + self.decode_workers))
        out["pages_free"] = float(sum(
            w.allocator.pages_free
            for w in self.prefill_workers + self.decode_workers))
        out.update({f"compiles_{k}": float(v)
                    for k, v in self.compile_stats().items()})
        out["pod_shipments"] = float(self._c_shipments.value)
        out["pod_pages_shipped"] = float(self._c_pages_shipped.value)
        out["pod_backpressure_stalls"] = float(self._c_stalls.value)
        out["pod_affinity_hits"] = float(self._c_affinity.value)
        workers = self.prefill_workers + self.decode_workers
        swap_out = sum(w.metrics.swap_out_pages for w in workers)
        swap_in = sum(w.metrics.swap_in_pages for w in workers)
        if swap_out or swap_in:
            out["swap_out_pages"] = float(swap_out)
            out["swap_in_pages"] = float(swap_in)
            out["host_tier_pages_in_use"] = float(sum(
                w._host_tier.pages_in_use for w in workers
                if w._host_tier is not None))
        dedup = sum(w.metrics.prefix_dedup_hits for w in workers)
        if dedup:
            out["prefix_dedup_hits"] = float(dedup)
        return out

    def reset_metrics(self) -> None:
        """Drop accumulated samples; compiled programs, worker state and
        in-flight requests are untouched (same contract as the engine)."""
        self.registry.reset()
        self.metrics = ServingMetrics(registry=self.registry)
        self.scheduler.step_time_ema = 0.0
        for w in self.prefill_workers + self.decode_workers:
            w.reset_metrics()

    def close(self) -> None:
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        for w in self.prefill_workers + self.decode_workers:
            w.close()

    # -- introspection (the /debug endpoints) --------------------------------

    def debug_requests(self) -> dict:
        now = self._clock()
        return {
            "queued": [Engine._request_info(r, now)
                       for r in self.scheduler.queue],
            "running": [dict(Engine._request_info(f.user, now),
                             phase=f.phase)
                        for f in self._flights.values()],
        }

    def debug_slots(self) -> list[dict]:
        out = []
        for role, workers in (("prefill", self.prefill_workers),
                              ("decode", self.decode_workers)):
            for widx, w in enumerate(workers):
                for entry in w.debug_slots():
                    entry.update({"role": role, "worker": widx})
                    out.append(entry)
        return out

    def debug_pages(self) -> dict:
        out: dict[str, Any] = {"workers": []}
        for role, workers in (("prefill", self.prefill_workers),
                              ("decode", self.decode_workers)):
            for widx, w in enumerate(workers):
                row = w.debug_pages()
                row.update({"role": role, "worker": widx})
                out["workers"].append(row)
        out["pages_shipped"] = int(self._c_pages_shipped.value)
        out["pending_shipments"] = len(self._pending)
        return out

    def debug_scheduler(self) -> dict:
        out = self.scheduler.debug_state()
        out["pod"] = {
            "in_flight": len(self._flights),
            "pending_shipments": len(self._pending),
        }
        return out

    def debug_pod(self) -> dict:
        """Role/router state for the `/debug/pod` route: who holds what,
        how full the shipment buffer is, whether backpressure has been
        biting. Read-only, JSON-safe."""
        pc = self.pod_config
        roles: dict[str, list] = {"prefill": [], "decode": []}
        for role, workers in (("prefill", self.prefill_workers),
                              ("decode", self.decode_workers)):
            for widx, w in enumerate(workers):
                roles[role].append({
                    "worker": widx,
                    "slots": len(w.scheduler.slots),
                    "live_slots": w.scheduler.live_slots,
                    "queue_depth": w.scheduler.queue_depth,
                    "pages_free": w.allocator.pages_free,
                    "pages_in_use": w.allocator.pages_in_use,
                    "compiles": w.compile_stats(),
                })
        phases: dict[str, int] = {}
        for f in self._flights.values():
            phases[f.phase] = phases.get(f.phase, 0) + 1
        return {
            "roles": roles,
            "tensor_parallel": pc.tensor_parallel,
            "in_flight": phases,
            "queued": self.scheduler.queue_depth,
            "pending_shipments": len(self._pending),
            "max_pending_shipments": self._max_pending,
            "shipments_total": int(self._c_shipments.value),
            "pages_shipped_total": int(self._c_pages_shipped.value),
            "backpressure_stalls_total": int(self._c_stalls.value),
        }

    def incident_dumps(self) -> dict:
        out: dict[str, Any] = {}
        for name, build in (
            ("pod", self.debug_pod),
            ("requests", self.debug_requests),
            ("scheduler", self.debug_scheduler),
            ("compile_stats", self.compile_stats),
        ):
            try:
                out[name] = build()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out


# the facade name mirrors serving.ServingEngine: same API, pod-backed
PodEngine = PodRouter
