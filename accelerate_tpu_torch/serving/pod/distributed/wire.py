"""The pod's wire format: length-prefixed frames, no pickle on the hot path
(a copy of `accelerate_tpu/serving/pod/distributed/wire.py`; frames are
byte-identical to the reference's for the same messages).

A multi-host pod moves two very different kinds of traffic:

- **control** — submits, cancels, heartbeats, role changes, token
  deltas. Small, structured, JSON-shaped.
- **KV page shipments** — the hot path. A prompt's prefilled pages are
  megabytes of fixed-shape tensor data (int8 codes + scales already
  halve the bytes); serializing them through pickle would copy,
  tag, and re-validate every buffer per hop.

One frame format carries both: a JSON header (kind + JSON-safe metadata
+ buffer descriptors) followed by the raw buffer bytes back-to-back.
Numpy arrays cross the wire as their contiguous bytes plus a
(dtype, shape) descriptor in the header — decode is a zero-copy
`np.frombuffer` view per buffer. Nothing on either path executes
arbitrary code: a corrupt or malicious frame can fail to parse, never
`__reduce__` its way into the interpreter.

Frame layout (all integers big-endian)::

    [4B magic b"ATPD"] [4B header_len H] [8B body_len B]
    [H bytes: UTF-8 JSON header] [B bytes: buffer payloads]

    header = {"kind": str, "meta": {...}, "buffers": [
        {"dtype": "<f4", "shape": [2, 3]}, ...]}

`MAX_FRAME_BYTES` bounds what a reader will allocate for one frame —
a garbage length prefix must not OOM the router.

bfloat16: the reference tags a bf16 buffer with numpy's registered name
"bfloat16" (an `ml_dtypes` dtype). The port has no `ml_dtypes`: its bf16
buffers are raw 16-bit words in arrays of dtype `BF16_WORDS`
(serving/pod/transfer.py), encoded under the same tag with the same
payload bytes, and a "bfloat16" buffer decodes to `BF16_WORDS`, which
the caller views as `torch.bfloat16` (`transfer.to_tensor`).

Trace context rides the header, not the framing: any job-bearing
message's meta may carry an optional ``traceparent`` (the W3C
`00-<trace>-<span>-<flags>` string) plus a ``sampled`` verdict —
`trace_meta` builds the pair, and a missing/malformed header simply
means "unsampled" (never an error; tracing must not be able to break
the dataflow). The router stamps it on submits and shipments so a
worker's engine spans join the router-minted request trace.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any

import numpy as np

from ..transfer import BF16_WORDS

__all__ = [
    "Message",
    "encode_message",
    "decode_message",
    "read_frame",
    "write_frame",
    "shipment_to_message",
    "shipment_from_message",
    "trace_meta",
    "WireError",
]

MAGIC = b"ATPD"
_HEAD = struct.Struct(">4sIQ")  # magic, header_len, body_len
MAX_FRAME_BYTES = 1 << 31  # 2 GiB: far above any shipment, far below garbage


class WireError(ValueError):
    """A frame that cannot be (or must not be) decoded."""


@dataclasses.dataclass
class Message:
    """One decoded frame: a kind tag, JSON-safe metadata, raw buffers."""

    kind: str
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    buffers: list[np.ndarray] = dataclasses.field(default_factory=list)


def encode_message(msg: Message) -> bytes:
    """Message -> one self-delimiting frame (bytes)."""
    descs = []
    payloads = []
    for buf in msg.buffers:
        arr = np.ascontiguousarray(buf)
        # extension dtypes (bfloat16 via ml_dtypes) stringify as opaque
        # void ("<V2") — ship the registered name, which np.dtype resolves;
        # bf16 words carry that name in their dtype's metadata
        tag = arr.dtype.str
        if (arr.dtype.metadata or {}).get("dtype") == "bfloat16":
            tag = "bfloat16"
        elif np.dtype(tag) != arr.dtype:
            tag = arr.dtype.name
        descs.append({"dtype": tag, "shape": list(arr.shape)})
        payloads.append(arr.tobytes())
    header = json.dumps(
        {"kind": msg.kind, "meta": msg.meta, "buffers": descs},
        separators=(",", ":")).encode("utf-8")
    body_len = sum(len(p) for p in payloads)
    return b"".join([_HEAD.pack(MAGIC, len(header), body_len), header,
                     *payloads])


def decode_message(frame: bytes) -> Message:
    """One frame (as produced by `encode_message`) -> Message. Raises
    `WireError` on any structural problem — truncation, bad magic,
    length/descriptor disagreement."""
    if len(frame) < _HEAD.size:
        raise WireError(f"frame too short ({len(frame)} bytes)")
    magic, header_len, body_len = _HEAD.unpack_from(frame)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if len(frame) != _HEAD.size + header_len + body_len:
        raise WireError(
            f"frame length {len(frame)} != header {_HEAD.size + header_len} "
            f"+ body {body_len}")
    try:
        header = json.loads(
            frame[_HEAD.size:_HEAD.size + header_len].decode("utf-8"))
        kind, meta = header["kind"], header["meta"]
        descs = header["buffers"]
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise WireError(f"bad frame header: {e}") from None
    buffers = []
    offset = _HEAD.size + header_len
    for d in descs:
        try:
            dtype = (BF16_WORDS if d["dtype"] == "bfloat16"
                     else np.dtype(d["dtype"]))
            shape = tuple(int(s) for s in d["shape"])
        except (TypeError, KeyError, ValueError) as e:
            raise WireError(f"bad buffer descriptor {d!r}: {e}") from None
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if offset + nbytes > len(frame):
            raise WireError("buffer descriptors overrun the frame body")
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(frame, dtype=dtype, count=count, offset=offset)
        buffers.append(arr.reshape(shape))
        offset += nbytes
    if offset != len(frame):
        raise WireError("frame body longer than its buffer descriptors")
    return Message(kind=kind, meta=meta, buffers=buffers)


# ---------------------------------------------------------------------------
# socket framing
# ---------------------------------------------------------------------------


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError (EOF mid-frame is a
    dropped peer, not a short read)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock) -> bytes:
    """Read one complete frame off a blocking socket. Raises
    ConnectionError on EOF, WireError on a garbage prefix."""
    head = _recv_exact(sock, _HEAD.size)
    magic, header_len, body_len = _HEAD.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} on stream")
    total = header_len + body_len
    if total > MAX_FRAME_BYTES:
        raise WireError(f"frame claims {total} bytes (> MAX_FRAME_BYTES)")
    return head + _recv_exact(sock, total)


def write_frame(sock, frame: bytes) -> None:
    sock.sendall(frame)


# ---------------------------------------------------------------------------
# KVPageShipment <-> Message
# ---------------------------------------------------------------------------

# buffer order is part of the wire contract (header carries no names)
_SHIP_BUFFERS = ("prompt", "k_pages", "v_pages", "key_raw")


def trace_meta(trace_id, span_id: int = 0, sampled: bool = False) -> dict:
    """Meta fields that propagate one request's trace context across a
    hop: a W3C ``traceparent`` plus the router's head-sampling verdict.
    Empty dict when the request has no trace id (tracing off) — the
    caller splices it into any message meta with ``**``, so untraced
    traffic carries zero extra bytes."""
    if not trace_id:
        return {}
    from ....telemetry.trace import format_traceparent

    return {
        "traceparent": format_traceparent(str(trace_id), span_id or 0,
                                          bool(sampled)),
        "sampled": bool(sampled),
    }


def shipment_to_message(shipment, **extra_meta) -> Message:
    """The existing fixed-shape codes+scales shipment as one frame:
    scalars ride the header, tensors ride as raw buffers (int8 pools ship
    their codes + per-row scale blocks verbatim — the wire carries half a
    bf16 shipment's bytes, exactly as in-process transfer does)."""
    meta = {
        "first_token": int(shipment.first_token),
        "n_prompt_pages": int(shipment.n_prompt_pages),
        "temperature": float(shipment.temperature),
        "max_new_tokens": int(shipment.max_new_tokens),
        "eos_token_id": (None if shipment.eos_token_id is None
                         else int(shipment.eos_token_id)),
        "src_worker": int(shipment.src_worker),
        "extracted_at": float(shipment.extracted_at),
        "first_logprob": (None if shipment.first_logprob is None
                          else float(shipment.first_logprob)),
        "quantized": shipment.k_scales is not None,
    }
    meta.update(extra_meta)
    buffers = [np.asarray(getattr(shipment, name)) for name in _SHIP_BUFFERS]
    if shipment.k_scales is not None:
        buffers += [np.asarray(shipment.k_scales),
                    np.asarray(shipment.v_scales)]
    return Message(kind="shipment", meta=meta, buffers=buffers)


def shipment_from_message(msg: Message):
    """Inverse of `shipment_to_message` (byte-identical round trip —
    pinned by test). bf16 pages and scales come back as `BF16_WORDS`."""
    from ..transfer import KVPageShipment

    meta = msg.meta
    want = len(_SHIP_BUFFERS) + (2 if meta.get("quantized") else 0)
    if len(msg.buffers) != want:
        raise WireError(
            f"shipment frame has {len(msg.buffers)} buffers, wants {want}")
    prompt, k_pages, v_pages, key_raw = msg.buffers[:4]
    k_scales = v_scales = None
    if meta.get("quantized"):
        k_scales, v_scales = msg.buffers[4:6]
    return KVPageShipment(
        prompt=np.asarray(prompt, np.int32),
        first_token=int(meta["first_token"]),
        n_prompt_pages=int(meta["n_prompt_pages"]),
        k_pages=k_pages,
        v_pages=v_pages,
        key_raw=np.asarray(key_raw, np.uint32),
        temperature=float(meta["temperature"]),
        max_new_tokens=int(meta["max_new_tokens"]),
        eos_token_id=(None if meta["eos_token_id"] is None
                      else int(meta["eos_token_id"])),
        src_worker=int(meta.get("src_worker", -1)),
        extracted_at=float(meta.get("extracted_at", 0.0)),
        first_logprob=(None if meta.get("first_logprob") is None
                       else float(meta["first_logprob"])),
        k_scales=k_scales,
        v_scales=v_scales,
    )
