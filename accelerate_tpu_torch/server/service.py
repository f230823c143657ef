"""Asyncio glue between the HTTP layer and the serving engine.

A copy of `accelerate_tpu/server/service.py` on the port's `Engine`.
When the drive loop dies it writes the reference's `drive-loop`
incident bundle under the engine's `incident_dir` (the port reads no
environment variable for it), and `/healthz` degrades while the
engine's stall watchdog has fired.

One background *drive task* steps the engine whenever it has work — the
engine is not thread-safe and its step() is a quick host dispatch, so
stepping inline on the event loop (yielding between steps) keeps every
device interaction on one logical thread while any number of request
coroutines watch their tokens land. Watchers never call step()
themselves: they await a progress future the drive task resolves after
every engine step, which is what lets a client disconnect cancel ONE
request (freeing its slot and pages immediately) without perturbing the
others.

Fan-out (`n`/`best_of`) is ONE engine submission plus N-1 `Engine.fork`s:
siblings share the parent's prompt pages copy-on-write
through the radix tree — published as the parent's prefill completes
them, so the whole fan-out pays a single prompt prefill and each sibling
diverges at its first private page. best_of ranks finished candidates by
TRUE cumulative logprob (the engine emits per-token model logprobs),
ties to the lower candidate index. Engines without `fork` (the pod
router) fall back to independent submissions — sharing then happens
only through ordinary retirement-time prefix reuse.

Graceful drain: `drain()` flips the service to draining (healthz -> 503,
new submissions -> 503), lets in-flight requests finish inside the
timeout, then cancels the stragglers — the front door never vanishes
mid-stream.
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator

import numpy as np

from ..serving.scheduler import Request, RequestStatus
from .config import ServerConfig
from .protocol import ProtocolError

__all__ = ["InferenceService", "OverloadedError"]


class OverloadedError(ProtocolError):
    """429 + Retry-After: the scheduler shed or refused the request.
    `shed_code` is the scheduler's machine-readable reason (certain_miss,
    pressure_victim, displaced_by_tier, queue_full, ...) — it rides the
    envelope as `error.shed_reason` so a client or load balancer can
    react to WHY it was shed, not just that it was."""

    def __init__(self, message: str, retry_after_s: float | None,
                 shed_code: str | None = None):
        super().__init__(429, message, etype="overloaded_error",
                         code="rate_limit_exceeded")
        self.retry_after_s = retry_after_s
        self.shed_code = shed_code

    def body(self) -> dict:
        out = super().body()
        if self.shed_code is not None:
            out["error"]["shed_reason"] = self.shed_code
        return out


class InferenceService:
    """Owns the engine drive loop + request watching for the HTTP layer."""

    def __init__(self, engine, tokenizer, config: ServerConfig | None = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.config = config or ServerConfig()
        self._known = {t.name for t in self.config.tenants}
        self._known.add("default")
        self.draining = False
        self._wake: asyncio.Event | None = None
        self._progress_waiters: list[asyncio.Future] = []
        self._drive_task: asyncio.Task | None = None
        self._drive_error: BaseException | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._wake = asyncio.Event()
        self._drive_task = asyncio.get_running_loop().create_task(
            self._drive(), name="engine-drive")

    async def stop(self) -> None:
        await self.drain()
        if self._drive_task is not None:
            self._drive_task.cancel()
            try:
                await self._drive_task
            except asyncio.CancelledError:
                pass
            except BaseException:
                pass  # already recorded as _drive_error and surfaced
            self._drive_task = None
        # engine.close() joins the watchdog / metrics-server / host-tier
        # threads — seconds of blocking if one is mid-drain. The drive task is already dead, so no
        # engine call races this; run it off the loop so health checks
        # and other servers on this loop keep answering while we tear
        # down.
        await asyncio.get_running_loop().run_in_executor(
            None, self.engine.close)

    async def drain(self, timeout_s: float | None = None) -> None:
        """Stop admitting, let in-flight work finish, cancel stragglers."""
        self.draining = True
        timeout = (self.config.drain_timeout_s
                   if timeout_s is None else timeout_s)
        deadline = time.monotonic() + timeout
        while (self.engine.scheduler.has_work()
               and time.monotonic() < deadline):
            await asyncio.sleep(0.01)
        for req in list(self.engine.scheduler.queue):
            self.engine.cancel(req)
        for req in list(self.engine.scheduler.running()):
            self.engine.cancel(req)
        self._notify_progress()  # release any watcher still waiting

    def health(self) -> tuple[bool, str]:
        """(ok, reason). Degrades on drain and on a fired stall watchdog
        — a wedged engine must fail its readiness probe, not serve 200s
        over a queue nothing is draining."""
        if self._drive_error is not None:
            return False, ("engine drive loop failed: "
                           f"{type(self._drive_error).__name__}")
        if self.draining:
            return False, "draining"
        wd = self.engine.watchdog
        if wd is not None and wd.stalled:
            return False, (f"stall watchdog fired ({wd.stall_count} "
                           f"stall(s), last silence > {wd.timeout_s}s)")
        return True, "ok"

    def debug_state(self, section: str) -> dict | list | None:
        """Introspection snapshot for one /debug/<section> route; None
        for an unknown section (the HTTP layer 404s). Service-level
        health rides along on `requests` so one fetch answers 'is the
        loop alive AND what is it holding'."""
        if section == "requests":
            out = self.engine.debug_requests()
            ok, reason = self.health()
            out["service"] = {"healthy": ok, "reason": reason,
                              "draining": self.draining}
            return out
        if section == "slots":
            return self.engine.debug_slots()
        if section == "pages":
            return self.engine.debug_pages()
        if section == "scheduler":
            return self.engine.debug_scheduler()
        if section == "pod":
            # only a pod-backed engine (serving.pod.PodEngine) has role/
            # router state; on a single engine the route 404s like any
            # unknown section
            build = getattr(self.engine, "debug_pod", None)
            return build() if build is not None else None
        return None

    # -- the drive loop ------------------------------------------------------

    async def _drive(self) -> None:
        try:
            while True:
                if self.engine.scheduler.has_work():
                    self.engine.step()
                    self._notify_progress()
                    # yield so watchers flush tokens between steps
                    await asyncio.sleep(0)
                else:
                    self._notify_progress()
                    self._wake.clear()
                    wd = self.engine.watchdog
                    if wd is None:
                        await self._wake.wait()
                    else:
                        # idle is progress, not a stall: the watchdog is
                        # normally ticked inside Engine.step(), so an
                        # armed watchdog on a traffic-less server would
                        # fire and fail /healthz forever — keep ticking
                        # on a sub-timeout period while waiting for work
                        wd.tick()
                        try:
                            await asyncio.wait_for(
                                self._wake.wait(),
                                timeout=max(0.05, wd.timeout_s / 2.0))
                        except asyncio.TimeoutError:
                            pass
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            # a dead drive loop must FAIL every request, not hang it:
            # record the error (watchers re-raise it as a 500), refuse
            # new work, cancel everything in flight, wake all waiters —
            # and report it (the drive loop dying IS the incident the
            # stall watchdog exists for, just loud)
            self._drive_error = e
            self._write_incident(e)
            self.draining = True
            for req in list(self.engine.scheduler.queue):
                self.engine.cancel(req)
            for req in list(self.engine.scheduler.running()):
                self.engine.cancel(req)
            self._notify_progress()
            raise

    def _write_incident(self, exc: BaseException) -> None:
        """Best-effort drive-death bundle: the stall watchdog's format,
        kind 'drive-loop', with the exception traceback and the engine's
        scheduler/slot/page dumps and cost table frozen at death. Written
        when the engine has an `incident_dir`; the port reads no
        environment variable for one."""
        try:
            from ..telemetry.watchdog import (
                build_exception_report,
                resolve_incident_dir,
                write_incident_bundle,
            )

            incident_dir = resolve_incident_dir(
                getattr(self.engine.engine_config, "incident_dir", None))
            if incident_dir is None:
                return
            report = build_exception_report(exc, name="drive-loop")
            path = write_incident_bundle(
                incident_dir, report, registry=self.engine.registry,
                dumps=self.engine.incident_dumps(), name="drive-loop")
            from ..logging import get_logger

            get_logger(__name__).error(
                f"engine drive loop died ({type(exc).__name__}); incident "
                f"bundle written: {path} (python -m "
                "accelerate_tpu_torch.commands.incident show)")
        except Exception:
            pass  # forensics must never mask the original failure

    def _notify_progress(self) -> None:
        waiters, self._progress_waiters = self._progress_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    def _check_drive(self) -> None:
        if self._drive_error is not None:
            raise ProtocolError(
                500, "engine drive loop failed: "
                f"{type(self._drive_error).__name__}: {self._drive_error}",
                etype="server_error", code="engine_failure")

    async def _wait_progress(self) -> None:
        self._check_drive()
        fut = asyncio.get_running_loop().create_future()
        self._progress_waiters.append(fut)
        await fut
        self._check_drive()

    # -- tenancy -------------------------------------------------------------

    def resolve_tenant(self, header: str | None, user: str | None) -> str:
        """`X-Tenant` header wins, then the OpenAI `user` field. Unknown
        names 401 in `unknown_tenants="reject"` deployments (a typo'd
        tenant silently riding the default tier corrupts per-tier SLO
        accounting), else serve under a default-shaped contract."""
        tenant = header or user or "default"
        if (tenant not in self._known
                and self.config.unknown_tenants == "reject"):
            raise ProtocolError(401, f"unknown tenant {tenant!r}",
                                etype="authentication_error",
                                code="unknown_tenant")
        return tenant

    # -- submission ----------------------------------------------------------

    def encode_prompt(self, params) -> list[int]:
        if params.prompt_ids is not None:
            bad = [t for t in params.prompt_ids
                   if t >= self.tokenizer.vocab_size]
            if bad:
                raise ProtocolError(
                    400, f"prompt token id {bad[0]} out of range for "
                    f"vocab_size {self.tokenizer.vocab_size}")
            return list(params.prompt_ids)
        try:
            return self.tokenizer.encode(params.prompt_text)
        except ValueError as e:
            raise ProtocolError(400, str(e))

    def submit(self, params, tenant: str, trace_id=None,
               trace_parent=0) -> list[Request]:
        """Validate capacity, then fan out `max(n, best_of)` engine
        requests. Oversized prompts 4xx HERE — the scheduler never sees
        them. Overload (scheduler REJECTED) raises OverloadedError with
        the scheduler's Retry-After estimate and shed code; partial
        fan-outs roll back so a shed request never leaks half its
        siblings. All candidates of one HTTP request share one trace —
        `trace_id` is the id the front door returns as `x-request-id`."""
        if self.draining:
            raise ProtocolError(503, "server is draining",
                                etype="overloaded_error", code="draining")
        ids = self.encode_prompt(params)
        max_len = self.engine.engine_config.max_len
        if len(ids) + params.max_tokens > max_len:
            raise ProtocolError(
                400, f"prompt ({len(ids)} tokens) + max_tokens "
                f"({params.max_tokens}) exceeds the model context "
                f"({max_len})", code="context_length_exceeded")
        prompt = np.asarray(ids, np.int32)
        # ONE head-sampling decision for the whole fan-out: n/best_of
        # siblings share the trace, so they must sample together — at a
        # fractional rate, per-candidate draws would leave a random
        # subset of a request's spans missing (half a trace is noise)
        from ..telemetry.trace import head_sample

        sampled = head_sample(tenant)
        # COW fan-out: candidate 0 submits normally, siblings FORK it —
        # they share its prompt pages (published as its prefill completes
        # them), so n=8 pays one prompt prefill. The pod router has no
        # fork yet; it keeps the independent-submission path.
        fork = getattr(self.engine, "fork", None)
        reqs: list[Request] = []
        for i in range(params.fan_out):
            key = None
            if params.seed is not None:
                # distinct deterministic stream per candidate: raw
                # uint32[2] key data, same shape Engine._as_raw_key takes
                key = np.array([params.seed & 0xFFFFFFFF, i], np.uint32)
            if reqs and fork is not None:
                req = fork(
                    reqs[0], max_new_tokens=params.max_tokens,
                    temperature=params.temperature, key=key,
                    trace_id=trace_id, trace_parent=trace_parent,
                    trace_sampled=sampled,
                )
            else:
                req = self.engine.submit(
                    prompt, max_new_tokens=params.max_tokens,
                    temperature=params.temperature, key=key,
                    eos_token_id=self.tokenizer.eos_token_id, tenant=tenant,
                    trace_id=trace_id, trace_parent=trace_parent,
                    trace_sampled=sampled,
                )
            if req.status is RequestStatus.REJECTED:
                for sib in reqs:
                    self.engine.cancel(sib)
                raise OverloadedError(
                    f"request shed: {req.reject_reason}", req.retry_after_s,
                    shed_code=req.shed_code)
            reqs.append(req)
        if self._wake is not None:
            self._wake.set()
        return reqs

    def cancel(self, reqs) -> None:
        for r in reqs if isinstance(reqs, (list, tuple)) else [reqs]:
            self.engine.cancel(r)

    def finish(self, req) -> None:
        """Stop-sequence termination: the client got its full answer, so
        the request retires as FINISHED (metrics and prefix cache treat
        it exactly like a natural completion)."""
        self.engine.finish(req)

    # -- consumption ---------------------------------------------------------

    @staticmethod
    def finish_reason(req: Request) -> str:
        if req.status is RequestStatus.EXPIRED:
            return "overloaded"
        if req.status is RequestStatus.CANCELLED:
            return "cancelled"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        return "stop"

    async def wait_all(self, reqs: list[Request],
                       timeout_s: float | None = None) -> None:
        """Block until every request is terminal. An EXPIRED request
        (shed from the queue mid-wait) surfaces as OverloadedError — the
        client gets its 429 + Retry-After even after the body started
        life admitted."""
        timeout = (self.config.request_timeout_s
                   if timeout_s is None else timeout_s)
        deadline = time.monotonic() + timeout
        while not all(r.done for r in reqs):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.cancel(reqs)
                raise ProtocolError(504, "generation timed out",
                                    etype="server_error", code="timeout")
            # bounded wait: the deadline fires even if no progress
            # notification ever arrives
            try:
                await asyncio.wait_for(self._wait_progress(),
                                       timeout=min(remaining, 1.0))
            except asyncio.TimeoutError:
                pass
        shed = next((r for r in reqs
                     if r.status is RequestStatus.EXPIRED), None)
        if shed is not None:
            self.cancel(reqs)
            raise OverloadedError(f"request shed: {shed.reject_reason}",
                                  shed.retry_after_s,
                                  shed_code=shed.shed_code)

    async def await_first(self, reqs: list[Request],
                          timeout_s: float | None = None) -> None:
        """Block until every request has produced a token or gone
        terminal; a request shed before its first token surfaces as
        OverloadedError — the streaming path holds its 200 on this, so
        queue sheds answer 429 whether or not the client streams. The
        request timeout applies here exactly as on the unary path: a
        stream stuck queued past it gets a 504, never a held socket
        (overload is an answer, not a hang)."""
        timeout = (self.config.request_timeout_s
                   if timeout_s is None else timeout_s)
        deadline = time.monotonic() + timeout
        while not all(r.tokens or r.done for r in reqs):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.cancel(reqs)
                raise ProtocolError(504, "generation timed out in queue",
                                    etype="server_error", code="timeout")
            try:
                await asyncio.wait_for(self._wait_progress(),
                                       timeout=min(remaining, 1.0))
            except asyncio.TimeoutError:
                pass
        shed = next((r for r in reqs
                     if r.status is RequestStatus.EXPIRED
                     and not r.tokens), None)
        if shed is not None:
            self.cancel(reqs)
            raise OverloadedError(f"request shed: {shed.reject_reason}",
                                  shed.retry_after_s,
                                  shed_code=shed.shed_code)

    async def stream_tokens(
            self, reqs: list[Request],
    ) -> AsyncIterator[tuple[int, list[int], list[float], bool]]:
        """Merge N live requests into one (choice_index, new_token_ids,
        new_token_logprobs, finished) stream; `finished` fires exactly
        once per choice, after its last tokens. The logprob slice is
        index-aligned with the token slice (both come from the same
        engine step)."""
        sent = [0] * len(reqs)
        closed = [False] * len(reqs)
        while not all(closed):
            progressed = False
            for i, r in enumerate(reqs):
                if closed[i]:
                    continue
                if sent[i] < len(r.tokens):
                    new = list(r.tokens[sent[i]:])
                    lps = list(r.logprobs[sent[i]:sent[i] + len(new)])
                    sent[i] = len(r.tokens)
                    progressed = True
                    yield i, new, lps, False
                if r.done:
                    closed[i] = True
                    progressed = True
                    yield i, [], [], True
            if not progressed:
                await self._wait_progress()
