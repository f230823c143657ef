"""The safetensors file format, read and written with plain Python and
torch (the port depends on no `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the raw bytes of every tensor, back to back. The header maps each name to
`{"dtype", "shape", "data_offsets": [begin, end]}` (offsets into the data
that follows the header) and may hold `"__metadata__"`, a dict of strings.
As the `safetensors` package does, the writer pads the header with spaces
to a multiple of 8 bytes and lays the data out by dtype (the format's
enum, last first), then by name, so both write the same bytes; the reader
takes any valid layout and checks that the tensors tile the data
exactly.
"""

from __future__ import annotations

import json
import os
import struct

import torch

__all__ = ["save_file", "load_file", "iter_file", "read_header",
           "dtype_name", "torch_dtype"]

# in the order of the format's dtype enum, which sets the data layout
_DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_RANK = {v: i for i, v in enumerate(_DTYPES.values())}
_MAX_HEADER = 100 << 20     # the package's own bound


def dtype_name(dtype: torch.dtype) -> str:
    """The format's name of a torch dtype ("F32", "BF16", ...)."""
    return _NAMES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a format's dtype name."""
    return _DTYPES[name]


def _raw(t: torch.Tensor):
    """The tensor's bytes as a host buffer, without a copy when it is
    already a contiguous host tensor."""
    t = t.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write `tensors` to `path` and make the file durable (fsync), so a
    manifest written after it never lists a file that is not all there."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "name")
    order = sorted(tensors, key=lambda k: (-_RANK[tensors[k].dtype], k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(_raw(tensors[name]))
        f.flush()
        os.fsync(f.fileno())


def read_header(path: str) -> tuple[dict, int]:
    """(the parsed header, the file offset where the data begins). Every
    entry is checked: a known dtype, a shape of non-negative ints, and
    offsets that tile the data exactly."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        if n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{path}: header length {n} out of range")
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    spans = []
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if not isinstance(entry, dict):
            raise ValueError(f"{path}: bad entry for {name!r}: {entry}")
        dtype = _DTYPES.get(entry.get("dtype"))
        shape = entry.get("shape")
        offsets = entry.get("data_offsets")
        if dtype is None or not isinstance(shape, list) or not all(
                isinstance(d, int) and d >= 0 for d in shape) or not (
                isinstance(offsets, list) and len(offsets) == 2 and all(
                    isinstance(o, int) for o in offsets)):
            raise ValueError(f"{path}: bad entry for {name!r}: {entry}")
        begin, end = offsets
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name!r} has {end - begin} bytes for "
                             f"shape {shape} of {entry['dtype']}")
        spans.append((begin, end, name))
    pos = 0
    for begin, end, name in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: data of {name!r} starts at {begin}, "
                             f"expected {pos}")
        pos = end
    if 8 + n + pos != size:
        raise ValueError(f"{path}: {size - 8 - n} bytes of data, the header "
                         f"lists {pos}")
    return header, 8 + n


def iter_file(path: str):
    """Yield (name, host tensor) for every tensor of the file in the order
    of its data, each read into its own buffer, so a caller that copies
    each one away holds one tensor at a time."""
    header, start = read_header(path)
    names = sorted((k for k in header if k != "__metadata__"),
                   key=lambda k: header[k]["data_offsets"])
    with open(path, "rb") as f:
        f.seek(start)
        for name in names:
            entry = header[name]
            begin, end = entry["data_offsets"]
            buf = torch.empty(end - begin, dtype=torch.uint8)
            if end > begin and f.readinto(buf.numpy()) != end - begin:
                raise ValueError(f"{path}: {name!r} is cut short")
            yield name, buf.view(_DTYPES[entry["dtype"]]).reshape(
                entry["shape"])


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the file as a host tensor."""
    return dict(iter_file(path))
