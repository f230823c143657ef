"""Model memory accounting, device-map planning and checkpoint loading
(port of `accelerate_tpu/utils/modeling.py`).

- `compute_module_sizes` over a params tree of tensors, meta tensors from
  `big_modeling.init_empty_weights` included;
- `get_max_memory` from the card's free memory (`torch.cuda.mem_get_info`,
  where the reference reads the device's `bytes_limit`);
- `infer_auto_device_map`: fill device 0..N-1, then "cpu", then "disk".
  The models stack their L layers on a leading dim, so the planner splits
  a stacked module into L virtual rows `layers.{i}`, and placement
  regroups contiguous rows per tier. Given the same `max_memory` the
  port plans the reference's map, key for key;
- `load_state_dict` / `load_checkpoint_in_model`: `.safetensors` files go
  through the port's own reader (`utils/safetensors.py`: the card's
  machine has no `safetensors` package), torch `.bin` files through
  `torch.load(weights_only=True)`. `load_checkpoint_in_model` reads a
  safetensors checkpoint by byte range straight into each tier's memory
  (`FileTensor`), so the host holds the CPU tier and a bounded staging
  buffer, never the whole checkpoint.
"""

from __future__ import annotations

import json
import math
import os
import re
from collections import OrderedDict
from typing import Any, Mapping

import torch

from . import safetensors
from .constants import (
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    WEIGHTS_INDEX_NAME,
    WEIGHTS_NAME,
)
from .offload import save_offload_index
from .other import flatten_dict, unflatten_dict
from ..device import resolve_device

__all__ = [
    "dtype_byte_size", "compute_module_sizes", "find_stacked_modules",
    "get_max_memory", "named_module_tensors", "infer_auto_device_map",
    "get_balanced_memory", "check_device_map", "load_state_dict",
    "resolve_checkpoint_files", "load_checkpoint_in_model", "FileTensor",
]

_LAYER_ROW = re.compile(r"^(.*)\.(\d+)$")


def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch dtype or a dtype name ("int4" is
    0.5)."""
    if isinstance(dtype, torch.dtype):
        return float(dtype.itemsize)
    name = str(getattr(dtype, "name", dtype)).removeprefix("torch.")
    if "int4" in name:
        return 0.5
    if name == "bool":
        return 1.0
    m = re.search(r"(\d+)$", name)
    if not m:
        raise ValueError(f"dtype {dtype} is not a valid dtype")
    return int(m.group(1)) / 8


def _leaf_bytes(leaf, dtype=None) -> int:
    d = dtype if dtype is not None else leaf.dtype
    return (int(math.prod(leaf.shape) * dtype_byte_size(d)) if leaf.shape
            else int(dtype_byte_size(d)))


def compute_module_sizes(params: Any, dtype=None,
                         stacked_modules: Mapping[str, int] | None = None
                         ) -> dict[str, int]:
    """Byte size of every module prefix ("" is the whole tree); a stacked
    module (`find_stacked_modules`, or as passed) also gets per-row
    entries `module.{i}`."""
    flat = flatten_dict(params)
    if stacked_modules is None:
        stacked_modules = find_stacked_modules(params)
    sizes: dict[str, int] = {}
    for key, leaf in flat.items():
        nbytes = _leaf_bytes(leaf, dtype)
        parts = key.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            sizes[prefix] = sizes.get(prefix, 0) + nbytes
        sizes[""] = sizes.get("", 0) + nbytes
    for mod, n_rows in stacked_modules.items():
        if mod in sizes and n_rows > 0:
            per_row = sizes[mod] // n_rows
            for i in range(n_rows):
                sizes[f"{mod}.{i}"] = per_row
    return sizes


def find_stacked_modules(params: Any, min_rows: int = 2) -> dict[str, int]:
    """Stacked layer modules: a top-level subtree of at least two leaves
    that all share one leading dim (the layer count)."""
    out: dict[str, int] = {}
    if not isinstance(params, dict):
        return out
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        leaves = list(flatten_dict(sub).values())
        leading = {leaf.shape[0] for leaf in leaves
                   if tuple(getattr(leaf, "shape", ()))}
        if len(leaves) >= 2 and len(leading) == 1:
            n = leading.pop()
            if n >= min_rows:
                out[name] = int(n)
    return out


def get_max_memory(max_memory: dict | None = None,
                   device=None) -> "OrderedDict[Any, int]":
    """{device_index: usable bytes, "cpu": bytes, "disk": unbounded}.
    Given `max_memory` ("20GiB"-style strings or ints), that map; else
    90% of what each visible card has free (`torch.cuda.mem_get_info`,
    plus what the caching allocator holds unused) and 45% of host
    memory. With `device="cpu"` one "device", half of host memory, as the
    reference gives its CPU backend."""
    if max_memory is not None:
        out: "OrderedDict[Any, int]" = OrderedDict()
        for k, v in max_memory.items():
            out[k] = _parse_mem(v)
        out.setdefault("cpu", 0)
        out.setdefault("disk", 2**62)
        return out
    dev = resolve_device(device)
    out = OrderedDict()
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            free, _ = torch.cuda.mem_get_info(i)
            cached = (torch.cuda.memory_reserved(i)
                      - torch.cuda.memory_allocated(i))
            out[i] = int((free + cached) * 0.9)
    else:
        out[0] = int(_host_ram() // 2 * 0.9)
    out["cpu"] = int(_host_ram() * 0.45)
    out["disk"] = 2**62
    return out


def _host_ram() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 16 * 2**30


def _parse_mem(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    units = {"KIB": 2**10, "MIB": 2**20, "GIB": 2**30, "KB": 10**3,
             "MB": 10**6, "GB": 10**9}
    s = str(v).strip().upper()
    for suffix, mult in sorted(units.items(), key=lambda kv: -len(kv[0])):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


def named_module_tensors(params: Any, module: str) -> dict[str, Any]:
    """Flat {name: leaf} of one module prefix ("" is every leaf)."""
    flat = flatten_dict(params)
    prefix = module + "." if module else ""
    return {k: v for k, v in flat.items()
            if module == "" or k == module or k.startswith(prefix)}


def infer_auto_device_map(params: Any, max_memory: dict | None = None,
                          no_split_modules: tuple = (), dtype=None,
                          offload_buffers: bool = False,
                          verbose: bool = False,
                          device=None) -> "OrderedDict[str, Any]":
    """Greedy device map: fill device 0..N-1, then "cpu", then "disk".

    Returns {module: device_index | "cpu" | "disk"}, the top-level
    modules in sorted order (`_planning_units`). Stacked modules are
    planned per virtual row (`layers.0` ... `layers.{L-1}`), so a model
    larger than the card splits mid-stack; other top-level modules, and
    stacked ones named in `no_split_modules`, are placed whole. `device`
    ("cpu" or the card) only matters without `max_memory`."""
    if not isinstance(params, dict):
        raise TypeError("params must be a (nested) dict of tensors")
    units, sizes = _planning_units(params, no_split_modules, dtype)
    memory = get_max_memory(max_memory, device)
    devices = [k for k in memory if k not in ("cpu", "disk")] + ["cpu",
                                                                "disk"]
    free = {d: memory[d] for d in devices}

    device_map: "OrderedDict[str, Any]" = OrderedDict()
    cursor = 0
    for unit in units:
        size = sizes[unit]
        while cursor < len(devices) - 1 and free[devices[cursor]] < size:
            cursor += 1
        target = devices[cursor]
        device_map[unit] = target
        free[target] -= size
        if verbose:
            print(f"  {unit:40s} -> {target} ({size / 2**20:.1f} MiB)")
    return device_map      # "disk" is the sink: the cursor stops there


def _planning_units(params: Any, no_split_modules: tuple,
                    dtype) -> tuple[list[str], dict[str, int]]:
    """(units in tree order, sizes): the placement granularity that
    `infer_auto_device_map` and `get_balanced_memory` share. The order is
    the reference's: JAX orders a dict's keys when it rebuilds a tree
    (`jax.eval_shape`, the reference's meta init), so the top-level
    modules go in sorted order."""
    stacked = {k: v for k, v in find_stacked_modules(params).items()
               if k not in no_split_modules}
    sizes = compute_module_sizes(params, dtype=dtype,
                                 stacked_modules=stacked)
    units: list[str] = []
    for name in sorted(params):
        if name in stacked:
            units.extend(f"{name}.{i}" for i in range(stacked[name]))
        else:
            units.append(name)
    return units, sizes


def get_balanced_memory(params: Any, max_memory: dict | None = None,
                        no_split_modules: tuple = (), dtype=None,
                        low_zero: bool = False,
                        device=None) -> "OrderedDict[Any, int]":
    """Per-device caps that spread the model evenly over the devices
    instead of filling device 0 first; feed them to
    `infer_auto_device_map`. `low_zero=True` halves device 0's cap (room
    for generation buffers). The last device keeps its full capacity, the
    sink before "cpu" and "disk"."""
    memory = get_max_memory(max_memory, device)
    devices = [k for k in memory if k not in ("cpu", "disk")
               and memory[k] > 0]
    if len(devices) <= 1:
        # halving the only device's cap would spill a model that fits
        return memory
    units, sizes = _planning_units(params, no_split_modules, dtype)
    total = sizes[""]
    # the largest unit placed whole must fit in each device's slack
    buffer = max((sizes[u] for u in units), default=0)
    n_balanced = len(devices) - (1 if low_zero else 0)
    per_device = total // n_balanced + buffer
    for d in devices[:-1]:
        memory[d] = min(memory[d], per_device)
    if low_zero:
        memory[devices[0]] = min(memory[devices[0]], per_device // 2)
    return memory


def check_device_map(params: Any, device_map: Mapping[str, Any]) -> None:
    """Every leaf must be covered by a device-map entry, and a stacked
    module addressed per row must have every row covered."""
    flat = flatten_dict(params)
    stacked = find_stacked_modules(params)
    row_entries: dict[str, set[int]] = {}
    plain_entries: list[str] = []
    for m in device_map:
        rm = _LAYER_ROW.match(m)
        if rm and rm.group(1) in stacked:
            row_entries.setdefault(rm.group(1), set()).add(int(rm.group(2)))
        else:
            plain_entries.append(m)
    for mod, rows in row_entries.items():
        whole = any(mod == p or mod.startswith(p + ".") or p == ""
                    for p in plain_entries)
        missing = set(range(stacked[mod])) - rows
        if missing and not whole:
            raise ValueError(
                f"stacked module {mod!r} addressed per-row but rows "
                f"{sorted(missing)} have no device_map entry")
        bad = {r for r in rows if r >= stacked[mod]}
        if bad:
            raise ValueError(f"device_map rows {sorted(bad)} out of range "
                             f"for {mod!r} (has {stacked[mod]} rows)")
    covered = set()
    for key in flat:
        hits = [m for m in device_map
                if m == "" or key == m or key.startswith(m + ".")
                or _covers_row(m, key)]
        if not hits:
            raise ValueError(f"param {key!r} not covered by device_map")
        covered.update(hits)
    extra = set(device_map) - covered
    if extra:
        raise ValueError(f"device_map entries match no params: "
                         f"{sorted(extra)}")


def _covers_row(map_key: str, param_key: str) -> bool:
    """'layers.3' covers flat key 'layers.attn.q.kernel' (row 3)."""
    m = _LAYER_ROW.match(map_key)
    return bool(m) and param_key.startswith(m.group(1) + ".")


# ---------------------------------------------------------------------------
# checkpoint reading
# ---------------------------------------------------------------------------


def load_state_dict(checkpoint_file: str,
                    keys: list[str] | None = None) -> dict[str, torch.Tensor]:
    """A checkpoint file as {name: host tensor}, all of it or `keys`."""
    if checkpoint_file.endswith(".safetensors"):
        want = None if keys is None else set(keys)
        out = {name: t for name, t in safetensors.iter_file(checkpoint_file)
               if want is None or name in want}
        if want is not None and want - out.keys():
            raise KeyError(f"{checkpoint_file}: no tensor "
                           f"{sorted(want - out.keys())}")
        return out
    sd = torch.load(checkpoint_file, map_location="cpu", weights_only=True)
    if keys is not None:
        sd = {k: sd[k] for k in keys}
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def resolve_checkpoint_files(checkpoint: str) -> list[str]:
    """The files of a checkpoint given as one file, an index json, or a
    directory (holding an index, one weights file, or shards)."""
    if os.path.isfile(checkpoint):
        if checkpoint.endswith(".json"):
            folder = os.path.dirname(checkpoint)
            with open(checkpoint) as f:
                index = json.load(f)
            return [os.path.join(folder, v)
                    for v in sorted(set(index["weight_map"].values()))]
        return [checkpoint]
    if os.path.isdir(checkpoint):
        for name in (SAFE_WEIGHTS_INDEX_NAME, WEIGHTS_INDEX_NAME):
            p = os.path.join(checkpoint, name)
            if os.path.exists(p):
                return resolve_checkpoint_files(p)
        for name in (SAFE_WEIGHTS_NAME, WEIGHTS_NAME):
            p = os.path.join(checkpoint, name)
            if os.path.exists(p):
                return [p]
        shards = sorted(os.path.join(checkpoint, f)
                        for f in os.listdir(checkpoint)
                        if f.endswith(".safetensors"))
        if shards:
            return shards
    raise FileNotFoundError(f"no checkpoint found at {checkpoint}")


_CHUNK_BYTES = 64 << 20   # staging granularity of ranged reads


class FileTensor:
    """A tensor of a safetensors file, not read yet: `read_into` copies a
    range of its rows from the file into a destination in any memory, in
    chunks of at most 64 MiB, so reading never holds more than the
    destination and one chunk."""

    def __init__(self, path: str, offset: int, dtype: torch.dtype,
                 shape: tuple):
        self.path, self.offset = path, offset
        self.dtype, self.shape = dtype, tuple(shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def row_bytes(self) -> int:
        return (math.prod(self.shape[1:]) if self.shape else 1) * \
            self.dtype.itemsize

    def read(self) -> torch.Tensor:
        """The whole tensor as a host tensor."""
        out = torch.empty(self.shape, dtype=self.dtype)
        self.read_into(out)
        return out

    def chunks(self, start: int | None = None, end: int | None = None):
        """Host tensors (flat, this tensor's dtype) that together hold rows
        [start, end) (None: the whole tensor), in order."""
        begin, nbytes = self._span(start, end)
        item = self.dtype.itemsize
        step = max(item, _CHUNK_BYTES // item * item)
        buf = torch.empty(min(step, nbytes), dtype=torch.uint8)
        with open(self.path, "rb") as f:
            f.seek(begin)
            done = 0
            while done < nbytes:
                n = min(step, nbytes - done)
                _read_exact(f, buf[:n], self.path)
                yield buf[:n].view(self.dtype)
                done += n

    def read_into(self, dest: torch.Tensor, start: int | None = None,
                  end: int | None = None) -> None:
        """Rows [start, end) into `dest` (their shape; any device and
        dtype): a contiguous host `dest` of this dtype is read into
        directly; else chunk by chunk, cast by `copy_`."""
        flat = dest.view(-1)
        if (dest.device.type == "cpu" and dest.dtype == self.dtype
                and dest.is_contiguous()):
            begin, nbytes = self._span(start, end)
            with open(self.path, "rb") as f:
                f.seek(begin)
                _read_exact(f, flat.view(torch.uint8), self.path)
            return
        stage = None
        if dest.is_cuda:      # pinned, so the copy to the card runs at rate
            elems = max(1, _CHUNK_BYTES // self.dtype.itemsize)
            stage = torch.empty(min(elems, flat.numel()), dtype=self.dtype,
                                pin_memory=True)
        pos = 0
        for chunk in self.chunks(start, end):
            n = chunk.numel()
            src = chunk
            if stage is not None:
                src = stage[:n]
                src.copy_(chunk)
            flat[pos:pos + n].copy_(src)
            pos += n

    def _span(self, start, end) -> tuple[int, int]:
        if start is None:
            numel = math.prod(self.shape) if self.shape else 1
            return self.offset, numel * self.dtype.itemsize
        rb = self.row_bytes
        return self.offset + start * rb, (end - start) * rb


def _read_exact(f, buf: torch.Tensor, path: str) -> None:
    view = buf.numpy()
    if view.size and f.readinto(view) != view.size:
        raise ValueError(f"{path}: a tensor is cut short")


def checkpoint_tensors(files: list[str]) -> dict[str, Any]:
    """{name: FileTensor} of every tensor of safetensors files, read from
    their headers; a torch `.bin` file is loaded whole ({name: host
    tensor})."""
    out: dict[str, Any] = {}
    for file in files:
        if not file.endswith(".safetensors"):
            out.update(load_state_dict(file))
            continue
        header, start = safetensors.read_header(file)
        for name, entry in header.items():
            if name == "__metadata__":
                continue
            out[name] = FileTensor(
                file, start + entry["data_offsets"][0],
                safetensors.torch_dtype(entry["dtype"]), entry["shape"])
    return out


def load_checkpoint_in_model(params: Any, checkpoint: str,
                             device_map: Mapping[str, Any] | None = None,
                             offload_folder: str | None = None, dtype=None,
                             strict: bool = False,
                             device=None) -> tuple[Any, dict]:
    """Read a checkpoint into a params tree laid out by `device_map`.

    `params` (meta tensors from `init_empty_weights`, or real ones) gives
    the structure and the expected shapes. Returns (params, disk offload
    index). Each tensor goes by byte range from the file into its tier's
    memory; a stacked module whose rows map to several tiers becomes
    `big_modeling.RowGroups`. Without a device map every tensor comes
    back whole on the host. `device` is what the map's device indices
    mean: the card unless "cpu"."""
    from ..big_modeling import _place_flat, _placement_plan

    flat_spec = flatten_dict(params)
    found = checkpoint_tensors(resolve_checkpoint_files(checkpoint))
    loaded: dict[str, Any] = {}
    for name, src in found.items():
        if name not in flat_spec:
            if strict:
                raise KeyError(f"unexpected key {name!r} in {checkpoint}")
            continue
        expected = tuple(flat_spec[name].shape)
        if tuple(src.shape) != expected:
            raise ValueError(f"shape mismatch for {name}: checkpoint "
                             f"{tuple(src.shape)} vs model {expected}")
        loaded[name] = src
    missing = set(flat_spec) - loaded.keys()
    if missing and strict:
        raise KeyError(f"missing keys: {sorted(missing)}")
    if device_map is None:
        out = {}
        for name, src in loaded.items():
            t = src.read() if isinstance(src, FileTensor) else src
            out[name] = t if dtype is None else t.to(dtype)
        return unflatten_dict(out), {}
    plan = _placement_plan(params, device_map)
    placed, offload_index = _place_flat(loaded, plan, offload_folder,
                                        device, dtype)
    if offload_index and offload_folder:
        save_offload_index(offload_index, offload_folder)
    return unflatten_dict(placed), offload_index
