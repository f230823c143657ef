"""The HTTP/1.1 front door: routing, SSE streaming, overload, shutdown.

A copy of `accelerate_tpu/server/http.py` on the port's service. One
change: `/debug/profile` captures with `torch.profiler` (the port's
`profiler.profile`) and leaves a Chrome trace, `trace.json`, in the log
directory, where the reference records a jax.profiler trace.

stdlib asyncio streams only — the repo's no-new-dependencies rule covers
the server too, and an inference front door needs exactly these routes:

    POST /v1/completions         OpenAI completions (+ SSE streaming)
    POST /v1/chat/completions    OpenAI chat (+ SSE streaming)
    GET  /v1/models              the one served model
    GET  /healthz                readiness (503 on drain / fired watchdog)
    GET  /metrics                Prometheus text from the engine registry
                                 (OpenMetrics + trace-id exemplars when
                                 the scraper Accepts it)
    GET  /debug/{requests,slots,pages,scheduler}
                                 read-only live introspection, gated by
                                 ServerConfig(debug_endpoints=True)
    GET  /debug/pod              role/router state when the engine is a
                                 serving.pod.PodEngine (404 on a single
                                 engine, and — like every /debug route —
                                 for every method when the gate is off)
    GET  /debug/profile?duration_s=N[&logdir=D]
                                 on-demand torch.profiler capture:
                                 records a Chrome trace of the live engine
                                 for N seconds (engine keeps serving —
                                 the drive loop shares the event loop)
                                 and answers with the logdir; one
                                 capture at a time (409 while busy).
                                 Gated with the other /debug routes.

Request tracing: every generate request gets a trace id — minted fresh,
or joined from a valid inbound W3C `traceparent` header — returned as
`x-request-id` on EVERY response to that request (200, 4xx, 429, SSE
head), so a client report always names the exact trace to pull. Whether
spans record is the engine's per-tenant head-sampling decision; the id
exists regardless.

Contracts the tests pin:

- malformed JSON and oversized bodies/prompts return structured 4xx
  (OpenAI error envelope) without the scheduler ever seeing them;
- a scheduler shed/reject surfaces as 429 with a Retry-After header (the
  scheduler's own drain estimate) and a machine-readable
  `error.shed_reason` — overload is an answer, not a hang;
- a malformed `traceparent` is ignored (fresh id minted), never an error;
- a client disconnect mid-SSE-stream cancels the engine request at the
  next flush, freeing its slot and pages for the requests still paying;
- `stop()` is a graceful drain: the listener closes first, in-flight
  requests get `drain_timeout_s` to finish, stragglers are cancelled.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
from typing import Awaitable, Callable

from ..telemetry.export import negotiate_exposition
from ..telemetry.trace import new_trace_id, parse_traceparent
from .config import ServerConfig
from .protocol import (
    SSE_DONE,
    ProtocolError,
    chat_chunk,
    chat_response,
    completion_chunk,
    completion_response,
    error_body,
    logprobs_block,
    parse_chat_request,
    parse_completion_request,
    sse_event,
    usage_block,
)
from .service import InferenceService, OverloadedError

__all__ = ["HttpFrontDoor"]

_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
            404: "Not Found", 405: "Method Not Allowed",
            408: "Request Timeout", 409: "Conflict",
            413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}

_MAX_HEADER_BYTES = 32 * 1024


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Choice:
    """Per-candidate assembly: incremental detokenization plus stop-
    sequence holdback (the last `max_stop-1` chars stay buffered until
    the choice finishes, so a stop string split across two decode steps
    still stops — and is never half-emitted)."""

    def __init__(self, tokenizer, stops: list[str]):
        self.detok = tokenizer.incremental()
        self.stops = stops
        self.holdback = max((len(s) for s in stops), default=1) - 1
        self.text = ""          # full decoded text (pre-truncation)
        self.emitted = 0        # chars already sent to the client
        self.token_ids: list[int] = []
        self.stopped = False

    def push(self, ids: list[int]) -> str:
        """Fold new token ids in; returns the text delta now safe to
        emit ("" while held back)."""
        self.token_ids.extend(ids)
        if self.stopped:
            return ""
        self.text += self.detok.push(ids)
        for s in self.stops:
            at = self.text.find(s)
            if at != -1:
                self.text = self.text[:at]
                self.stopped = True
                break
        limit = len(self.text) if self.stopped \
            else max(self.emitted, len(self.text) - self.holdback)
        delta = self.text[self.emitted:limit]
        self.emitted = limit
        return delta

    def finish(self) -> str:
        """Flush the detokenizer tail + any held-back text."""
        if not self.stopped:
            self.text += self.detok.flush()
        delta = self.text[self.emitted:]
        self.emitted = len(self.text)
        return delta


class HttpFrontDoor:
    """The server object: `await start()`, serve, `await stop()`."""

    def __init__(self, service: InferenceService,
                 config: ServerConfig | None = None):
        self.service = service
        self.config = config or service.config
        self._server: asyncio.base_events.Server | None = None
        self._inflight: set[asyncio.Task] = set()
        self._req_ids = itertools.count(1)
        self._profiling = False  # one /debug/profile capture at a time

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int | None:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "HttpFrontDoor":
        await self.service.start()
        self._server = await asyncio.start_server(
            self._on_connection, self.config.host, self.config.port)
        return self

    async def stop(self) -> None:
        """Graceful drain: close the listener, give in-flight requests
        the drain budget, cancel the rest, then stop the engine."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.service.draining = True
        deadline = time.monotonic() + self.config.drain_timeout_s
        while self._inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        for task in list(self._inflight):
            task.cancel()
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        await self.service.stop()

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    # -- connection handling -------------------------------------------------

    def _on_connection(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.get_running_loop().create_task(
            self._handle(reader, writer))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _read_request(self, reader) -> tuple[str, str, dict, bytes]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            # the StreamReader buffer limit tripped before our own header
            # cap could: still a structured 413, not a silent close
            raise _BadRequest(413, "headers too large")
        if len(head) > _MAX_HEADER_BYTES:
            raise _BadRequest(413, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            raise _BadRequest(400, f"malformed request line {lines[0]!r}")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(400, f"malformed header {line!r}")
            headers[name.strip().lower()] = value.strip()
        length_raw = headers.get("content-length", "0")
        try:
            length = int(length_raw)
        except ValueError:
            raise _BadRequest(400, f"bad Content-Length {length_raw!r}")
        if length < 0:
            raise _BadRequest(400, "negative Content-Length")
        if length > self.config.max_body_bytes:
            # refuse WITHOUT buffering: the body is read in chunks and
            # dropped (never held in memory) so the 413 is delivered
            # cleanly — closing with the body unread would RST the
            # connection before the client sees the error envelope
            left = length
            while left > 0:
                chunk = await reader.read(min(left, 1 << 16))
                if not chunk:
                    break
                left -= len(chunk)
            raise _BadRequest(413, f"body exceeds {self.config.max_body_bytes}"
                              " bytes")
        body = await reader.readexactly(length) if length else b""
        return method, target, headers, body

    async def _handle(self, reader, writer) -> None:
        try:
            try:
                method, target, headers, body = await asyncio.wait_for(
                    self._read_request(reader), timeout=30.0)
            except _BadRequest as e:
                await self._send_json(writer, e.status,
                                      error_body(str(e)))
                return
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    ConnectionError):
                return  # the client never finished a request
            path, _, query = target.partition("?")
            await self._route(writer, method, path, query, headers, body)
        except ConnectionError:
            pass  # disconnects are handled at the streaming sites
        except Exception as e:  # a handler bug must answer 500, not hang
            try:
                await self._send_json(
                    writer, 500,
                    error_body(f"{type(e).__name__}: {e}", "server_error"))
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, writer, method: str, path: str, query: str,
                     headers: dict, body: bytes) -> None:
        handler: Callable[..., Awaitable] | None = None
        if path == "/healthz":
            handler = self._handle_health
        elif path == "/metrics":
            handler = self._handle_metrics
        elif path == "/v1/models":
            handler = self._handle_models
        elif path.startswith("/debug/") and self.config.debug_endpoints:
            # gating happens HERE, before method dispatch: disabled debug
            # routes must be indistinguishable from unknown paths (a 405
            # on POST /debug/... would fingerprint the namespace)
            handler = self._handle_debug
        elif path in ("/v1/completions", "/v1/chat/completions"):
            if method != "POST":
                await self._send_json(writer, 405, error_body(
                    f"{method} not allowed; use POST"))
                return
            await self._handle_generate(writer, path, headers, body)
            return
        if handler is None:
            await self._send_json(writer, 404,
                                  error_body(f"unknown route {path!r}"))
            return
        if method not in ("GET", "HEAD"):
            await self._send_json(writer, 405,
                                  error_body(f"{method} not allowed"))
            return
        # HEAD mirrors GET minus the body (same status/headers/length):
        # health probes HEAD /metrics and /healthz before trusting them,
        # and this route must behave like the standalone exporter's
        await handler(writer, path, query, headers, method == "HEAD")

    # -- response writing ----------------------------------------------------

    async def _send_head(self, writer, status: int, content_type: str,
                         extra: dict | None = None,
                         length: int | None = None) -> None:
        reason = _REASONS.get(status, "Unknown")
        lines = [f"HTTP/1.1 {status} {reason}",
                 f"Content-Type: {content_type}",
                 "Connection: close"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        for k, v in (extra or {}).items():
            lines.append(f"{k}: {v}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        await writer.drain()

    async def _send_raw(self, writer, status: int, body: bytes,
                        content_type: str,
                        extra: dict | None = None,
                        head_only: bool = False) -> None:
        await self._send_head(writer, status, content_type, extra,
                              length=len(body))
        if not head_only:
            writer.write(body)
            await writer.drain()

    async def _send_json(self, writer, status: int, payload: dict,
                         extra: dict | None = None,
                         head_only: bool = False) -> None:
        await self._send_raw(writer, status,
                             json.dumps(payload).encode(),
                             "application/json", extra,
                             head_only=head_only)

    # -- plumbing routes -----------------------------------------------------

    async def _handle_health(self, writer, path, query, headers,
                             head_only=False) -> None:
        ok, reason = self.service.health()
        await self._send_json(writer, 200 if ok else 503,
                              {"status": "ok" if ok else "unavailable",
                               "reason": reason}, head_only=head_only)

    async def _handle_metrics(self, writer, path, query, headers,
                              head_only=False) -> None:
        # the SAME negotiation as the standalone exporter: an OpenMetrics
        # Accept gets bucket histograms with trace-id exemplars on the
        # latency series, everyone else format 0.0.4. A distributed pod
        # front merges every worker's heartbeat-shipped snapshot into the
        # exposition (telemetry/aggregate.merged_registry) — ask for that
        # richer registry when the engine offers one.
        build = getattr(self.service.engine, "exposition_registry", None)
        registry = build() if build is not None \
            else self.service.engine.registry
        text, ctype = negotiate_exposition(headers.get("accept"), registry)
        await self._send_raw(writer, 200, text.encode(), ctype,
                             head_only=head_only)

    async def _handle_models(self, writer, path, query, headers,
                             head_only=False) -> None:
        await self._send_json(writer, 200, {
            "object": "list",
            "data": [{"id": self.config.model_id, "object": "model",
                      "created": 0, "owned_by": "accelerate-tpu"}],
        }, head_only=head_only)

    async def _handle_debug(self, writer, path, query, headers,
                            head_only=False) -> None:
        """Read-only introspection. Gated OFF by default in `_route`
        (when disabled, /debug/* — any method — 404s exactly like
        unknown paths: the namespace's existence is not advertised to
        an unauthorized prober)."""
        section = path[len("/debug/"):]
        if section == "profile":
            await self._handle_profile(writer, query, head_only)
            return
        state = self.service.debug_state(section)
        if state is None:
            await self._send_json(writer, 404,
                                  error_body(f"unknown route {path!r}"))
            return
        await self._send_json(writer, 200, {section: state}
                              if isinstance(state, list) else state,
                              head_only=head_only)

    async def _handle_profile(self, writer, query: str,
                              head_only=False) -> None:
        """On-demand `torch.profiler` capture: record a trace of
        whatever the engine is doing for `duration_s` seconds and answer
        with the logdir. The engine keeps serving — its drive loop shares
        this event loop, so the captured window IS live traffic. One
        capture at a time: the profiler is process-global, so a
        concurrent request answers 409 instead of crashing it."""
        if head_only:
            # the one debug route with a side effect: a HEAD probe must
            # not start a 1-60s capture (nor burn the one-at-a-time
            # slot, nor litter tempdirs) — 405, not GET-minus-body
            await self._send_json(writer, 405, error_body(
                "HEAD not allowed on /debug/profile; use GET"))
            return
        import urllib.parse

        params = urllib.parse.parse_qs(query)
        try:
            duration = float(params.get("duration_s", ["1.0"])[0])
        except ValueError:
            await self._send_json(writer, 400, error_body(
                f"bad duration_s {params.get('duration_s')!r}"))
            return
        if not 0.0 < duration <= 60.0:
            await self._send_json(writer, 400, error_body(
                f"duration_s must be in (0, 60], got {duration}"))
            return
        if self._profiling:
            # busy check BEFORE any side effect: a 409'd request must
            # not litter a tempdir per rejected poll
            await self._send_json(writer, 409, error_body(
                "a profiler capture is already running (the profiler is "
                "process-global)", "conflict"))
            return
        logdir = params.get("logdir", [None])[0]
        auto_dir = logdir is None
        if auto_dir:
            import tempfile

            logdir = tempfile.mkdtemp(prefix="accelerate-tpu-profile-")
        self._profiling = True
        from ..profiler import profile as _profile

        try:
            with _profile(logdir):
                await asyncio.sleep(duration)
        except Exception as e:
            if auto_dir:
                import shutil

                shutil.rmtree(logdir, ignore_errors=True)
            await self._send_json(writer, 500, error_body(
                f"profiler capture failed: {type(e).__name__}: {e}",
                "server_error"))
            return
        finally:
            self._profiling = False
        await self._send_json(writer, 200, {"profile": {
            "logdir": logdir, "duration_s": duration,
        }}, head_only=head_only)

    # -- generation ----------------------------------------------------------

    async def _handle_generate(self, writer, path: str, headers: dict,
                               body: bytes) -> None:
        chat = path.endswith("/chat/completions")
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{next(self._req_ids)}"
        created = int(time.time())
        # trace context: honor a VALID inbound W3C traceparent (the
        # request joins the caller's distributed trace), mint fresh on
        # anything else — malformed headers are ignored, never an error.
        # The id exists for every generate request, sampled or not, and
        # rides EVERY response as x-request-id.
        parsed_tp = parse_traceparent(headers.get("traceparent"))
        trace_id, trace_parent = parsed_tp or (new_trace_id(), 0)
        rid_hdr = {"x-request-id": trace_id}
        try:
            try:
                parsed = json.loads(body)
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ProtocolError(400, f"invalid JSON body: {e}")
            max_ctx = self.service.engine.engine_config.max_len
            params = (parse_chat_request if chat
                      else parse_completion_request)(
                parsed, max_ctx, self.config.default_max_tokens)
            tenant = self.service.resolve_tenant(
                headers.get("x-tenant"), params.user)
            reqs = self.service.submit(params, tenant, trace_id=trace_id,
                                       trace_parent=trace_parent)
        except OverloadedError as e:
            await self._send_json(
                writer, e.status, self._with_request_id(e.body(), trace_id),
                extra=self._retry_after(e.retry_after_s, rid_hdr))
            return
        except ProtocolError as e:
            await self._send_json(writer, e.status,
                                  self._with_request_id(e.body(), trace_id),
                                  extra=rid_hdr)
            return
        model = self.config.model_id
        try:
            if params.stream:
                await self._stream_response(writer, rid, model, created,
                                            params, reqs, chat, rid_hdr)
            else:
                await self._unary_response(writer, rid, model, created,
                                           params, reqs, chat, rid_hdr)
        except OverloadedError as e:
            await self._send_json(
                writer, e.status, self._with_request_id(e.body(), trace_id),
                extra=self._retry_after(e.retry_after_s, rid_hdr))
        except ProtocolError as e:
            await self._send_json(writer, e.status,
                                  self._with_request_id(e.body(), trace_id),
                                  extra=rid_hdr)
        except ConnectionError:
            # the client went away mid-generation: release the slots and
            # pages its requests were holding — other tenants are queued
            self.service.cancel(reqs)

    @staticmethod
    def _with_request_id(body: dict, trace_id: str) -> dict:
        """The trace id INSIDE the error envelope too: SSE error events
        and proxied responses often lose response headers, and a 429
        must stay attributable to its trace either way."""
        if "error" in body:
            body["error"]["request_id"] = trace_id
        return body

    @staticmethod
    def _retry_after(retry_after_s: float | None,
                     base: dict | None = None) -> dict:
        out = dict(base or {})
        if retry_after_s is not None:
            out["Retry-After"] = f"{max(retry_after_s, 0.05):.3f}"
        return out

    def _rank(self, params, reqs):
        """best_of ranking by TRUE cumulative logprob (the engine emits
        each token's model logprob): highest sum of emitted-
        token logprobs wins, ties to the lower candidate index. A
        candidate with no logprobs (shed before any token) ranks last."""
        if params.best_of <= params.n:
            return reqs
        order = sorted(
            range(len(reqs)),
            key=lambda i: (-(reqs[i].cumulative_logprob
                             if reqs[i].cumulative_logprob is not None
                             else float("-inf")), i))
        return [reqs[i] for i in order[:params.n]]

    async def _unary_response(self, writer, rid, model, created, params,
                              reqs, chat: bool,
                              rid_hdr: dict | None = None) -> None:
        await self.service.wait_all(reqs)
        chosen = self._rank(params, reqs)
        tokenizer = self.service.tokenizer
        choices = []
        prompt_tokens = chosen[0].prompt_len if chosen else 0
        completion_tokens = 0
        for idx, req in enumerate(chosen):
            choice = _Choice(tokenizer, params.stop)
            choice.push(list(req.tokens))
            choice.finish()
            completion_tokens += len(req.tokens)
            reason = "stop" if choice.stopped \
                else self.service.finish_reason(req)
            text = choice.text
            if params.echo and not chat:
                text = tokenizer.decode(list(req.prompt)) + text
            lp_block = None
            if params.logprobs is not None:
                lp_block = logprobs_block(req.tokens, req.logprobs)
            if chat:
                entry = {
                    "index": idx,
                    "message": {"role": "assistant", "content": text,
                                "token_ids": choice.token_ids},
                    "finish_reason": reason}
                if lp_block is not None:
                    entry["logprobs"] = lp_block
                choices.append(entry)
            else:
                choices.append({
                    "index": idx, "text": text,
                    "token_ids": choice.token_ids,
                    "logprobs": lp_block, "finish_reason": reason})
        build = chat_response if chat else completion_response
        await self._send_json(
            writer, 200,
            build(rid, model, created, choices,
                  usage_block(prompt_tokens, completion_tokens)),
            extra=rid_hdr)

    async def _stream_response(self, writer, rid, model, created, params,
                               reqs, chat: bool,
                               rid_hdr: dict | None = None) -> None:
        # hold the 200 until something real exists to stream: a request
        # shed from the queue BEFORE its first token still gets a clean
        # 429 + Retry-After (the overload contract must not depend on
        # whether the client asked to stream)
        await self.service.await_first(reqs)
        await self._send_head(writer, 200, "text/event-stream",
                              {"Cache-Control": "no-cache",
                               **(rid_hdr or {})})
        make = chat_chunk if chat else completion_chunk
        choices = [_Choice(self.service.tokenizer, params.stop)
                   for _ in reqs]
        first = [True] * len(reqs)
        try:
            async for idx, ids, lps, done in self.service.stream_tokens(reqs):
                ch = choices[idx]
                lp_block = (logprobs_block(ids, lps)
                            if params.logprobs is not None else None)
                if done:
                    delta = ch.finish()
                    reason = "stop" if ch.stopped \
                        else self.service.finish_reason(reqs[idx])
                    payload = make(rid, model, created, idx, delta, [],
                                   reason, **({"first": first[idx]}
                                              if chat else {}),
                                   **({"logprobs": logprobs_block([], [])}
                                      if params.logprobs is not None
                                      else {}))
                elif ch.stopped:
                    continue  # stop string hit earlier; suppress the tail
                else:
                    delta = ch.push(ids)
                    if ch.stopped:
                        # the answer is complete: retire as FINISHED so
                        # stream and unary stop-hits count identically
                        self.service.finish(reqs[idx])
                    payload = make(rid, model, created, idx, delta, ids,
                                   None, **({"first": first[idx]}
                                            if chat else {}),
                                   **({"logprobs": lp_block}
                                      if lp_block is not None else {}))
                first[idx] = False
                writer.write(sse_event(payload))
                # drain() is where a dead client surfaces: the
                # ConnectionError propagates to _handle_generate, which
                # cancels every request of this stream
                await writer.drain()
            writer.write(SSE_DONE)
            await writer.drain()
        except ProtocolError as e:
            # the SSE head is already on the wire, so a late failure
            # (engine drive death, mid-wait shed) becomes a terminal SSE
            # error event — never a second HTTP status line mid-stream
            self.service.cancel(reqs)
            body = e.body()
            if rid_hdr:
                body = self._with_request_id(body,
                                             rid_hdr["x-request-id"])
            writer.write(sse_event(body))
            writer.write(SSE_DONE)
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ConnectionError(str(e)) from e
