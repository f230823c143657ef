"""OpenAI-compatible HTTP front door for the serving engine.

The port of `accelerate_tpu/server/`, on the port's engine: every module
is a copy of its counterpart (see each module's note on what differs).

The engine (`accelerate_tpu_torch.serving`) speaks Python; production traffic
speaks HTTP. This package is the user-facing layer over it, stdlib-only
(asyncio streams — no web framework dependency), in five pieces:

- `protocol`:  request validation + OpenAI response/error envelopes + SSE
               framing, jax-free and server-free so it unit-tests in
               microseconds;
- `tokenizer`: prompt -> token ids in, token ids -> text deltas out
               (byte-level UTF-8 tokenizer for real text, numeric
               fallback for tiny research vocabularies, incremental
               decoding so multi-byte characters never split across SSE
               events);
- `service`:   the asyncio glue — one background drive task steps the
               engine, watchers stream tokens per request, n/best_of
               fan-out, graceful drain, health;
- `http`:      the HTTP/1.1 layer — routing (/v1/completions,
               /v1/chat/completions, /v1/models, /healthz, /metrics),
               SSE streaming, client-disconnect cancellation, 429 +
               Retry-After on shed, graceful shutdown;
- `config`:    ServerConfig + tenant-spec parsing shared by the CLI and
               the load harness.

`python -m accelerate_tpu_torch.commands.serve` is the CLI entry (the
reference's `accelerate-tpu serve`).
"""

from .config import ServerConfig, parse_tenants_arg
from .http import HttpFrontDoor
from .service import InferenceService
from .tokenizer import ByteTokenizer, NumericTokenizer, get_tokenizer

__all__ = [
    "ServerConfig",
    "parse_tenants_arg",
    "HttpFrontDoor",
    "InferenceService",
    "ByteTokenizer",
    "NumericTokenizer",
    "get_tokenizer",
]
