"""Tokenizer plumbing: prompt -> ids at the door, ids -> text deltas out.

A copy of `accelerate_tpu/server/tokenizer.py`; only the package differs.

The model zoo's research configs carry no trained tokenizer, and the
container policy forbids pulling one in — so the server ships two
self-contained codecs and a protocol any external tokenizer can slot
into (`encode`/`decode`/`eos_token_id`):

- `ByteTokenizer`: UTF-8 bytes ARE the token ids (0..255). Lossless for
  any text, needs vocab >= 256, and — the part that matters for SSE —
  decodes *incrementally*: a multi-byte character whose bytes land in
  different decode steps is held back until complete, so no stream event
  ever carries a torn code point.
- `NumericTokenizer`: for vocabularies smaller than 256 (the tiny test
  configs). Prompts must arrive as token-id arrays (the OpenAI `prompt`
  field accepts arrays); output renders each id as its decimal string
  plus a space — deterministic, reversible, and honest about the absence
  of a text mapping.

Both are pure host-side Python; nothing here touches a device.
"""

from __future__ import annotations

import codecs

__all__ = ["ByteTokenizer", "NumericTokenizer", "IncrementalDetokenizer",
           "get_tokenizer"]


class ByteTokenizer:
    """UTF-8 byte-level codec: token id == byte value."""

    name = "byte"

    def __init__(self, vocab_size: int, eos_token_id: int | None = None):
        if vocab_size < 256:
            raise ValueError(
                f"byte tokenizer needs vocab_size >= 256, got {vocab_size} "
                "(use the numeric tokenizer for tiny vocabularies)")
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i <= 255).decode(
            "utf-8", errors="replace")

    def incremental(self) -> "IncrementalDetokenizer":
        return _ByteIncremental()


class NumericTokenizer:
    """Decimal rendering for models with no text mapping at all."""

    name = "numeric"

    def __init__(self, vocab_size: int, eos_token_id: int | None = None):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id

    def encode(self, text: str) -> list[int]:
        # text prompts are parseable only if they look like our own
        # decode output ("12 7 300 "); anything else is a client error
        try:
            ids = [int(t) for t in text.split()]
        except ValueError:
            raise ValueError(
                "this model has no text tokenizer: send 'prompt' as an "
                "array of token ids (or space-separated decimal ids)")
        if not ids:
            raise ValueError("empty prompt")
        return ids

    def decode(self, ids: list[int]) -> str:
        return "".join(f"{i} " for i in ids)

    def incremental(self) -> "IncrementalDetokenizer":
        return _NumericIncremental()


class IncrementalDetokenizer:
    """Streaming ids -> text: `push(ids)` returns the text newly
    *complete* at this step (possibly ""), `flush()` drains any tail."""

    def push(self, ids: list[int]) -> str:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> str:
        return ""


class _ByteIncremental(IncrementalDetokenizer):
    def __init__(self):
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def push(self, ids: list[int]) -> str:
        return self._dec.decode(bytes(i for i in ids if 0 <= i <= 255))

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)


class _NumericIncremental(IncrementalDetokenizer):
    def push(self, ids: list[int]) -> str:
        return "".join(f"{i} " for i in ids)


def get_tokenizer(name: str, vocab_size: int,
                  eos_token_id: int | None = None):
    """Resolve a tokenizer by name; "auto" picks byte when the vocabulary
    can hold it, numeric otherwise."""
    if name == "auto":
        name = "byte" if vocab_size >= 256 else "numeric"
    if name == "byte":
        return ByteTokenizer(vocab_size, eos_token_id)
    if name == "numeric":
        return NumericTokenizer(vocab_size, eos_token_id)
    raise ValueError(f"unknown tokenizer {name!r} (byte|numeric|auto)")
