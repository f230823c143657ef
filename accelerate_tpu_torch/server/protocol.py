"""OpenAI wire protocol: request validation, response envelopes, SSE.

A copy of `accelerate_tpu/server/protocol.py`; only the package differs.

Framework-free and socket-free on purpose: everything here maps dicts to dicts
(plus SSE byte framing), so the protocol contract unit-tests without a
model, an engine, or a listening port. Validation errors raise
`ProtocolError` carrying the HTTP status and the OpenAI error envelope —
the HTTP layer turns them into structured 4xx responses WITHOUT touching
the scheduler (a malformed request must never cost the data plane
anything).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = [
    "ProtocolError",
    "CompletionParams",
    "parse_completion_request",
    "parse_chat_request",
    "completion_chunk",
    "completion_response",
    "chat_chunk",
    "chat_response",
    "error_body",
    "logprobs_block",
    "sse_event",
    "SSE_DONE",
]

# one request body is bounded (prompts are tokens, not megabytes); the
# HTTP layer enforces this before json.loads so a hostile body never
# allocates unbounded memory
MAX_BODY_BYTES_DEFAULT = 2 * 1024 * 1024


class ProtocolError(Exception):
    """Invalid request, mapped straight to an HTTP status + OpenAI error
    envelope (`{"error": {message, type, code}}`)."""

    def __init__(self, status: int, message: str, etype: str = "invalid_request_error",
                 code: str | None = None):
        super().__init__(message)
        self.status = status
        self.etype = etype
        self.code = code

    def body(self) -> dict:
        return error_body(self.args[0], self.etype, self.code)


def error_body(message: str, etype: str = "invalid_request_error",
               code: str | None = None) -> dict:
    return {"error": {"message": message, "type": etype, "code": code}}


@dataclasses.dataclass
class CompletionParams:
    """One validated generation request, engine-shaped: the prompt is
    either text (tokenizer encodes it) or already token ids."""

    prompt_text: str | None
    prompt_ids: list[int] | None
    max_tokens: int
    temperature: float
    n: int
    best_of: int
    stream: bool
    echo: bool
    stop: list[str]
    user: str | None
    seed: int | None
    chat: bool = False
    # OpenAI `logprobs`: None = off; 0/1 = include each emitted token's
    # model logprob (the engine computes exactly one logprob per token —
    # the emitted one — so top-N alternatives beyond 1 are rejected at
    # validation, not silently dropped). Chat's boolean `logprobs` maps
    # to 0. See docs/server.md for the response-block shape.
    logprobs: int | None = None

    @property
    def fan_out(self) -> int:
        """Engine requests this API request expands to."""
        return max(self.n, self.best_of)


def _require_dict(body: Any) -> dict:
    if not isinstance(body, dict):
        raise ProtocolError(400, "request body must be a JSON object")
    return body


def _int_field(body: dict, name: str, default: int, lo: int, hi: int) -> int:
    v = body.get(name, default)
    if v is None:
        v = default
    if isinstance(v, bool) or not isinstance(v, int):
        raise ProtocolError(400, f"'{name}' must be an integer")
    if not lo <= v <= hi:
        raise ProtocolError(400, f"'{name}' must be in [{lo}, {hi}], got {v}")
    return v


def _float_field(body: dict, name: str, default: float, lo: float,
                 hi: float) -> float:
    v = body.get(name, default)
    if v is None:
        v = default
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ProtocolError(400, f"'{name}' must be a number")
    if not lo <= v <= hi:
        raise ProtocolError(400, f"'{name}' must be in [{lo}, {hi}], got {v}")
    return float(v)


def _parse_prompt(raw: Any) -> tuple[str | None, list[int] | None]:
    """OpenAI accepts a string or an array of token ids (arrays of
    strings/arrays — batch prompts — are deliberately unsupported: the
    engine-side fan-out is `n`, not prompt batching)."""
    if isinstance(raw, str):
        if not raw:
            raise ProtocolError(400, "'prompt' must not be empty")
        return raw, None
    if isinstance(raw, list):
        if not raw:
            raise ProtocolError(400, "'prompt' must not be empty")
        if not all(isinstance(t, int) and not isinstance(t, bool)
                   and t >= 0 for t in raw):
            raise ProtocolError(
                400, "'prompt' array must contain nonnegative token ids")
        return None, list(raw)
    raise ProtocolError(
        400, "'prompt' must be a string or an array of token ids")


def _parse_stop(body: dict) -> list[str]:
    raw = body.get("stop")
    if raw is None:
        return []
    if isinstance(raw, str):
        return [raw]
    if (isinstance(raw, list) and len(raw) <= 4
            and all(isinstance(s, str) and s for s in raw)):
        return list(raw)
    raise ProtocolError(400, "'stop' must be a string or up to 4 strings")


def _parse_common(body: dict, max_total_tokens: int,
                  default_max_tokens: int) -> dict:
    max_tokens = _int_field(body, "max_tokens", default_max_tokens, 1,
                            max_total_tokens)
    temperature = _float_field(body, "temperature", 1.0, 0.0, 2.0)
    n = _int_field(body, "n", 1, 1, 16)
    best_of = _int_field(body, "best_of", n, 1, 16)
    if best_of < n:
        raise ProtocolError(400, f"'best_of' ({best_of}) must be >= 'n' ({n})")
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise ProtocolError(400, "'stream' must be a boolean")
    if stream and best_of > n:
        # OpenAI semantics: best_of needs all candidates complete before
        # ranking, which contradicts streaming the winner live
        raise ProtocolError(400, "'best_of' > 'n' cannot be streamed")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool)
                             or not isinstance(seed, int)):
        raise ProtocolError(400, "'seed' must be an integer")
    user = body.get("user")
    if user is not None and not isinstance(user, str):
        raise ProtocolError(400, "'user' must be a string")
    return dict(max_tokens=max_tokens, temperature=temperature, n=n,
                best_of=best_of, stream=stream, stop=_parse_stop(body),
                user=user, seed=seed)


def _parse_logprobs(body: dict, chat: bool) -> int | None:
    """Completions take an int (0/1 supported — the engine has exactly
    the emitted token's logprob, so requests for top-N alternatives are
    a 400, not silent truncation); chat takes the OpenAI boolean."""
    raw = body.get("logprobs")
    if raw is None or raw is False:
        return None
    if chat:
        if raw is True:
            return 0
        raise ProtocolError(400, "'logprobs' must be a boolean for chat")
    if isinstance(raw, bool) or not isinstance(raw, int):
        raise ProtocolError(400, "'logprobs' must be an integer")
    if not 0 <= raw <= 1:
        raise ProtocolError(
            400, f"'logprobs' must be 0 or 1, got {raw}: the server "
            "returns the emitted token's logprob only (top-N "
            "alternatives are not computed)")
    return raw


def parse_completion_request(body: Any, max_total_tokens: int,
                             default_max_tokens: int = 16) -> CompletionParams:
    """Validate a `/v1/completions` body into CompletionParams; raises
    ProtocolError(4xx) on anything malformed."""
    body = _require_dict(body)
    if "prompt" not in body:
        raise ProtocolError(400, "'prompt' is required")
    text, ids = _parse_prompt(body["prompt"])
    echo = body.get("echo", False)
    if not isinstance(echo, bool):
        raise ProtocolError(400, "'echo' must be a boolean")
    return CompletionParams(prompt_text=text, prompt_ids=ids, echo=echo,
                            chat=False,
                            logprobs=_parse_logprobs(body, chat=False),
                            **_parse_common(body, max_total_tokens,
                                            default_max_tokens))


def render_chat_prompt(messages: list[dict]) -> str:
    """Deterministic chat template: the tiny research families have no
    trained template, so the server uses a fixed readable one — what
    matters for the serving layer is that identical messages always
    yield identical token streams."""
    parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
    parts.append("<|assistant|>\n")
    return "".join(parts)


def parse_chat_request(body: Any, max_total_tokens: int,
                       default_max_tokens: int = 16) -> CompletionParams:
    """Validate a `/v1/chat/completions` body. Messages render through
    the fixed chat template into one prompt string."""
    body = _require_dict(body)
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ProtocolError(400, "'messages' must be a non-empty array")
    for m in messages:
        if (not isinstance(m, dict)
                or not isinstance(m.get("role"), str)
                or m["role"] not in ("system", "user", "assistant", "tool")
                or not isinstance(m.get("content"), str)):
            raise ProtocolError(
                400, "each message needs a role "
                "(system|user|assistant|tool) and string content")
    common = _parse_common(body, max_total_tokens, default_max_tokens)
    if common["best_of"] > common["n"]:
        raise ProtocolError(400, "'best_of' is not supported for chat")
    return CompletionParams(prompt_text=render_chat_prompt(messages),
                            prompt_ids=None, echo=False, chat=True,
                            logprobs=_parse_logprobs(body, chat=True),
                            **common)


# -- response envelopes ------------------------------------------------------


def _base(kind: str, rid: str, model: str, created: int) -> dict:
    return {"id": rid, "object": kind, "created": created, "model": model}


def completion_response(rid: str, model: str, created: int,
                        choices: list[dict], usage: dict) -> dict:
    out = _base("text_completion", rid, model, created)
    out["choices"] = choices
    out["usage"] = usage
    return out


def logprobs_block(token_ids: list[int],
                   token_logprobs: list[float]) -> dict:
    """The `logprobs` choice field: per-token model logprobs of the
    emitted tokens (log-softmax of the raw target logits — temperature-
    free). Deviation from OpenAI, documented in docs/server.md: tokens
    are identified by `token_ids`, not decoded strings (the byte-level
    tokenizer's single tokens need not be valid code points), and
    `top_logprobs` is always null (only the emitted token's logprob is
    computed)."""
    return {
        "token_ids": list(token_ids),
        "token_logprobs": [round(float(lp), 6) for lp in token_logprobs],
        "top_logprobs": None,
    }


def completion_chunk(rid: str, model: str, created: int, index: int,
                     text: str, token_ids: list[int],
                     finish_reason: str | None,
                     logprobs: dict | None = None) -> dict:
    out = _base("text_completion", rid, model, created)
    # `token_ids` is an extension field: it makes streamed output
    # byte-auditable against Engine.stream (the acceptance contract) and
    # lets id-level clients skip detokenization entirely
    out["choices"] = [{"index": index, "text": text, "token_ids": token_ids,
                       "logprobs": logprobs,
                       "finish_reason": finish_reason}]
    return out


def chat_response(rid: str, model: str, created: int,
                  choices: list[dict], usage: dict) -> dict:
    out = _base("chat.completion", rid, model, created)
    out["choices"] = choices
    out["usage"] = usage
    return out


def chat_chunk(rid: str, model: str, created: int, index: int, text: str,
               token_ids: list[int], finish_reason: str | None,
               first: bool = False, logprobs: dict | None = None) -> dict:
    out = _base("chat.completion.chunk", rid, model, created)
    delta: dict = {"content": text, "token_ids": token_ids}
    if first:
        delta["role"] = "assistant"
    choice = {"index": index, "delta": delta,
              "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    out["choices"] = [choice]
    return out


def usage_block(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


# -- SSE framing -------------------------------------------------------------

SSE_DONE = b"data: [DONE]\n\n"


def sse_event(payload: dict) -> bytes:
    """One server-sent event frame carrying a JSON payload."""
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode() \
        + b"\n\n"
