"""Big-model init, dispatch and offloaded inference (port of
`accelerate_tpu/big_modeling.py`).

- meta init: `init_empty_weights(init_fn, ...)` runs an `init_params`
  under `device.meta_init`, so every tensor is a meta tensor: shapes and
  dtypes, no bytes;
- placement: `dispatch_model` lays a params tree out by a device map.
  Stacked [L, ...] layer modules may be split by row across tiers
  (`RowGroups`): rows on the card (CUDA tensors), in host memory (pinned
  once, at dispatch) or on disk (files of `utils/offload.py`, mapped);
- loading: `load_checkpoint_and_dispatch` reads a safetensors checkpoint
  by byte range straight into each tier (`utils.modeling.FileTensor`);
  `load_and_quantize_params` quantizes it on the host, tensor by tensor,
  and moves the codes to the card;
- streaming: `streamed_forward` and `streamed_generate` run one layer at
  a time, fetching layer i+1 while layer i computes (`stream_layers`).
  On the card the copies run on a side stream: pinned rows are copied
  directly, pageable rows (disk) go through a ring of two pinned staging
  buffers of one layer each, the compute stream waits on one event per
  layer, and at most two layers are in flight.

Device-map indices mean CUDA devices unless the entry point gets
`device="cpu"`; then the "device" tier is host memory too, and nothing is
pinned. Without a GPU and without `device="cpu"` the entry points raise.
The reference's `"sharded"` dispatch lays the params over a `model`
mesh of the local devices. The port has one process a device: in a
world of several processes it plans with `transformer_rules()` over a
`model` axis of every process and keeps this rank's shards (the
families' tensor-parallel forward reads them); in a world of one, every
leaf goes on device 0, and one process that sees several cards raises.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Any, Callable, Mapping

import torch

from .device import meta_init, resolve_device
from .utils.modeling import (
    FileTensor,
    _LAYER_ROW,
    check_device_map,
    checkpoint_tensors,
    find_stacked_modules,
    get_balanced_memory,
    get_max_memory,
    infer_auto_device_map,
    load_checkpoint_in_model,
    resolve_checkpoint_files,
)
from .utils.offload import (
    dtype_name,
    load_offloaded_weight,
    save_offload_index,
    write_raw,
)
from .utils.other import flatten_dict, unflatten_dict

__all__ = [
    "init_empty_weights",
    "init_on_device",
    "infer_auto_device_map",
    "get_balanced_memory",
    "get_max_memory",
    "dispatch_model",
    "load_checkpoint_and_dispatch",
    "cpu_offload",
    "disk_offload",
    "RowGroups",
    "StreamStats",
    "streamed_forward",
    "streamed_generate",
    "load_and_quantize_params",
]


def init_empty_weights(init_fn: Callable, *args, **kwargs) -> Any:
    """`init_fn(*args, **kwargs)` with every tensor on the meta device:
    shapes and dtypes, nothing allocated. The port's `init_params`
    resolve their device to meta here (`device.meta_init`), and torch's
    factory functions default to it."""
    with meta_init():
        return init_fn(*args, **kwargs)


def init_on_device(device):
    """Context manager placing fresh tensors on `device` (meta: as
    `init_empty_weights`)."""
    if torch.device(device).type == "meta":
        return meta_init()
    return torch.device(resolve_device(device))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class RowGroups:
    """A stacked [L, ...] leaf split into contiguous row groups on
    different tiers: `groups` are (start_row, end_row, tensor) and `tiers`
    says where each lives, "device" (a CUDA tensor, or host memory under
    `device="cpu"`), "cpu" (a host tensor, pinned when the card runs) or
    "disk" (a host tensor over a mapped offload file). `row(i)` is layer
    i's slice, where it lives."""

    def __init__(self, groups: list[tuple[int, int, Any]], shape, dtype,
                 tiers: list[str] | None = None):
        tiers = tiers or ["device"] * len(groups)
        order = sorted(range(len(groups)), key=lambda j: groups[j][0])
        self.groups = [groups[j] for j in order]
        self.tiers = [tiers[j] for j in order]
        self.shape = tuple(shape)
        self.dtype = dtype

    def row(self, i: int):
        for start, end, arr in self.groups:
            if start <= i < end:
                return arr[i - start]
        raise IndexError(i)

    def __repr__(self) -> str:
        parts = [f"[{s}:{e})->{t}"
                 for (s, e, _), t in zip(self.groups, self.tiers)]
        return f"RowGroups({', '.join(parts)})"


def _resolve_target(target, dev: torch.device):
    """A device-map value -> ("device", torch.device) | ("cpu"|"disk",
    None). Indices are CUDA devices, or host memory when the entry point
    runs on the CPU."""
    if target in ("cpu", "disk"):
        return target, None
    if isinstance(target, int):
        return "device", (torch.device("cuda", target)
                          if dev.type == "cuda" else dev)
    return "device", resolve_device(target)


def _placement_plan(params: Any,
                    device_map: Mapping[str, Any]) -> dict[str, Any]:
    """flat key -> target, or for a stacked leaf with per-row map entries
    a list of (start_row, end_row, target)."""
    check_device_map(params, device_map)
    flat = flatten_dict(params)
    stacked = find_stacked_modules(params)
    row_maps: dict[str, dict[int, Any]] = {}
    plain: dict[str, Any] = {}
    for key, target in device_map.items():
        m = _LAYER_ROW.match(key)
        if m and m.group(1) in stacked:
            row_maps.setdefault(m.group(1), {})[int(m.group(2))] = target
        elif m and isinstance(params, dict) and m.group(1) in params:
            raise ValueError(
                f"device_map key {key!r} addresses module {m.group(1)!r} "
                "per-row, but it is not a stacked scan-layer module")
        else:
            plain[key] = target

    plan: dict[str, Any] = {}
    for key in flat:
        mod = key.split(".", 1)[0]
        if mod in row_maps:
            rows = row_maps[mod]
            groups: list[tuple[int, int, Any]] = []
            for i in range(stacked[mod]):
                t = rows.get(i, "cpu")
                if groups and groups[-1][2] == t:
                    groups[-1] = (groups[-1][0], i + 1, t)
                else:
                    groups.append((i, i + 1, t))
            plan[key] = groups if len(groups) > 1 else groups[0][2]
        else:
            hits = [mk for mk in plain
                    if mk == "" or key == mk or key.startswith(mk + ".")]
            plan[key] = plain[max(hits, key=len)]
    return plan


def _copy_into(dest: torch.Tensor, src, rows) -> None:
    """`src` (a tensor or a FileTensor), rows [start, end) or all of it,
    into `dest` (any device and dtype)."""
    if isinstance(src, FileTensor):
        src.read_into(dest, *(rows or (None, None)))
    else:
        dest.copy_(src if rows is None else src[rows[0]:rows[1]])


def _write_offload(src, rows, dtype, path: str) -> None:
    """`src`'s rows (or all of it) in `dtype` to an offload file, a
    bounded chunk at a time for a FileTensor."""
    with open(path, "wb") as f:
        if isinstance(src, FileTensor):
            for chunk in src.chunks(*(rows or (None, None))):
                write_raw(f, chunk.to(dtype))
        else:
            part = src if rows is None else src[rows[0]:rows[1]]
            write_raw(f, part.detach().to("cpu", dtype))


def _place(src, rows, kind: str, dest_dev, name: str, dtype, pin: bool,
           offload_folder, offload_index: dict):
    """One leaf, or rows [start, end) of it, on its tier."""
    shape = tuple(src.shape)
    if rows is not None:
        shape = (rows[1] - rows[0],) + shape[1:]
    if kind == "disk":
        if offload_folder is None:
            raise ValueError(f"{name!r} mapped to disk but no "
                             "offload_folder given")
        os.makedirs(offload_folder, exist_ok=True)
        path = os.path.join(offload_folder, f"{name}.dat")
        _write_offload(src, rows, dtype, path)
        offload_index[name] = {"dtype": dtype_name(dtype),
                               "shape": list(shape)}
        return load_offloaded_weight(path, offload_index[name])
    if (kind == "device" and rows is None and isinstance(src, torch.Tensor)
            and src.device == dest_dev and src.dtype == dtype):
        return src          # already in place
    dest = torch.empty(shape, dtype=dtype,
                       device=dest_dev if kind == "device" else "cpu",
                       pin_memory=pin and kind == "cpu")
    _copy_into(dest, src, rows)
    return dest


def _place_flat(flat: Mapping[str, Any], plan: Mapping[str, Any],
                offload_folder: str | None, device=None,
                dtype=None) -> tuple[dict[str, Any], dict]:
    """Place every leaf (a tensor, or a FileTensor read by byte range)
    by the plan, in `dtype` if given. Host memory holds at most the "cpu"
    tier and a bounded staging buffer; the "cpu" tier is pinned when the
    card runs. Returns (placed flat tree, disk offload index)."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    offload_index: dict = {}
    out: dict[str, Any] = {}
    for key, src in flat.items():
        target = plan[key]
        out_dtype = dtype or src.dtype
        if isinstance(target, list):     # row groups of a stacked leaf
            groups, tiers = [], []
            for start, end, t in target:
                kind, d = _resolve_target(t, dev)
                groups.append((start, end, _place(
                    src, (start, end), kind, d, f"{key}.rows{start}-{end}",
                    out_dtype, pin, offload_folder, offload_index)))
                tiers.append(kind)
            out[key] = RowGroups(groups, src.shape, out_dtype, tiers)
        else:
            kind, d = _resolve_target(target, dev)
            out[key] = _place(src, None, kind, d, key, out_dtype, pin,
                              offload_folder, offload_index)
    return out, offload_index


def _single_device_map(mode) -> dict:
    """The reference's "sharded" dispatch in a world of one process: every
    leaf on device 0. One process over several cards is not the port's
    layout."""
    if torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"device_map={mode!r} in one process that sees "
            f"{torch.cuda.device_count()} devices: the port puts one "
            "process on a device. Launch one a card (python -m "
            "accelerate_tpu_torch.commands.launch --num_processes N) and "
            "each keeps its shard")
    return {"": 0}


def _sharded_dispatch(params: Any, mesh_axis: str, device) -> Any:
    """This rank's shards of `params` on a `mesh_axis` mesh over every
    process, planned with `transformer_rules()`, as `ShardedParams`. Only
    the `model` axis has a forward that reads its shards (the families'
    tensor-parallel one); another axis raises."""
    from .models.tensor_parallel import ShardedParams
    from .sharding.planner import plan_sharding, shard_pytree
    from .sharding.rules import transformer_rules
    from .state import PartialState, ProcessMesh
    from .utils.constants import AXIS_MODEL

    if mesh_axis != AXIS_MODEL:
        raise NotImplementedError(
            f"dispatch over a {mesh_axis!r} axis: the port's forward reads "
            f"shards of the {AXIS_MODEL!r} axis only; other axes arrive "
            "with the port's sharded-parallelism slice (ROADMAP.md, queue "
            "1 item 6b)")

    mesh = ProcessMesh({mesh_axis: PartialState.num_processes},
                       device=resolve_device(device))
    plan = plan_sharding(params, mesh, rules=transformer_rules())
    return ShardedParams(shard_pytree(params, plan), mesh, plan)


def _world() -> int:
    from .state import PartialState

    return PartialState.num_processes


def dispatch_model(params: Any,
                   device_map: Mapping[str, Any] | str | None = "sharded",
                   offload_folder: str | None = None,
                   mesh_axis: str = "model", device=None) -> Any:
    """Lay a params tree out across tiers.

    - `device_map="sharded"` or None: in a world of several processes,
      this rank's shards on a `mesh_axis` mesh over the world, planned
      with `transformer_rules()` (`ShardedParams`, which the families'
      tensor-parallel forward reads); in a world of one, every leaf on
      device 0 (one process that sees several cards raises);
    - `"auto"`: `infer_auto_device_map(params)`;
    - an explicit {module: device | "cpu" | "disk"} map, per-row
      `layers.{i}` entries included: leaves placed per tier, split
      stacked leaves as `RowGroups` for `streamed_forward`."""
    if device_map == "sharded" or device_map is None:
        if _world() > 1:
            return _sharded_dispatch(params, mesh_axis, device)
        device_map = _single_device_map(device_map)
    elif device_map == "auto":
        device_map = infer_auto_device_map(params, device=device)
    plan = _placement_plan(params, device_map)
    placed, offload_index = _place_flat(flatten_dict(params), plan,
                                        offload_folder, device)
    if offload_index and offload_folder:
        save_offload_index(offload_index, offload_folder)
    return unflatten_dict(placed)


def cpu_offload(params: Any, keep_modules: tuple = (), device=None) -> Any:
    """Every top-level module in host memory except `keep_modules`."""
    device_map = OrderedDict((name, 0 if name in keep_modules else "cpu")
                             for name in params)
    return dispatch_model(params, device_map, device=device)


def disk_offload(params: Any, offload_folder: str, keep_modules: tuple = (),
                 device=None) -> Any:
    """Every top-level module on disk except `keep_modules`."""
    device_map = OrderedDict((name, 0 if name in keep_modules else "disk")
                             for name in params)
    return dispatch_model(params, device_map, offload_folder=offload_folder,
                          device=device)


def load_checkpoint_and_dispatch(
    params_abstract: Any,
    checkpoint: str,
    device_map: Mapping[str, Any] | str | None = "auto",
    max_memory: dict | None = None,
    no_split_modules: tuple = (),
    offload_folder: str | None = None,
    dtype=None,
    device=None,
) -> Any:
    """Read a checkpoint straight onto its planned placement.
    `params_abstract` comes from `init_empty_weights`. A safetensors
    checkpoint is read by byte range into each tier's memory: the host
    holds the "cpu" tier and a bounded staging buffer, never the whole
    checkpoint. `device_map="sharded"` in a world of several processes
    reads the whole checkpoint to the host, as the reference does, and
    keeps this rank's shards (`dispatch_model`)."""
    if device_map in ("auto", "balanced"):
        device_map = infer_auto_device_map(
            params_abstract, max_memory=max_memory,
            no_split_modules=no_split_modules, dtype=dtype, device=device)
    elif device_map == "sharded" or device_map is None:
        if _world() > 1:
            # the whole checkpoint on the host, then this rank's shards
            loaded, _ = load_checkpoint_in_model(
                params_abstract, checkpoint, dtype=dtype, device=device)
            return dispatch_model(loaded, "sharded", device=device)
        device_map = _single_device_map(device_map)
    loaded, _ = load_checkpoint_in_model(
        params_abstract, checkpoint, device_map=device_map,
        offload_folder=offload_folder, dtype=dtype, device=device)
    return loaded


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def fetch_resident(params: Any, stacked_module: str, device,
                   dtype) -> dict:
    """Every module but the stacked one on the device, once: embeddings,
    final norm and head are read every step and are small beside the
    layers."""
    dev = resolve_device(device)
    return {k: _map_tree(v, lambda leaf: _cast(leaf.to(dev), dtype))
            for k, v in params.items() if k != stacked_module}


class StreamStats:
    """What the streamed loops moved and how much of the copying the
    compute hid, recorded with CUDA events when passed to
    `streamed_forward`/`streamed_generate` on the card.

    After `summary()`: `bytes` copied host->device, `copy_ms` (the union
    of the side stream's copy intervals), `compute_ms` (the union of the
    layer steps' intervals), `hidden_ms` (their intersection), `hidden`
    (hidden_ms / copy_ms) and the H2D rate `gb_per_s` (bytes over
    copy_ms)."""

    def __init__(self):
        self.bytes = 0
        self.layers = 0
        self._base = None
        self._copies: list[tuple] = []
        self._computes: list[tuple] = []

    def _event(self, stream) -> torch.cuda.Event:
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        if self._base is None:
            self._base = e
        return e

    def summary(self) -> dict:
        torch.cuda.synchronize()

        def spans(pairs):
            return sorted((self._base.elapsed_time(a),
                           self._base.elapsed_time(b)) for a, b in pairs)

        copies, computes = _union(spans(self._copies)), _union(
            spans(self._computes))
        copy_ms = sum(b - a for a, b in copies)
        hidden = sum(max(0.0, min(b, d) - max(a, c))
                     for a, b in copies for c, d in computes)
        return {"layers": self.layers, "bytes": self.bytes,
                "copy_ms": copy_ms,
                "compute_ms": sum(b - a for a, b in computes),
                "hidden_ms": hidden,
                "hidden": hidden / copy_ms if copy_ms else 0.0,
                "gb_per_s": self.bytes / copy_ms / 1e6 if copy_ms else 0.0}


def _union(spans: list) -> list:
    out: list = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Layer:
    """One fetched layer: its params on the device and, on the card, the
    event the compute stream waits on before using them."""

    def __init__(self, params, ready=None, fetched=(), stats=None):
        self.params, self.ready = params, ready
        self.fetched, self.stats = list(fetched), stats
        self.start = self.done = None

    def wait(self):
        if self.ready is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.ready)
            if self.stats is not None:
                self.start = self.stats._event(stream)
        return self.params

    def release(self) -> None:
        """After the layer's compute was issued: the allocator may not
        reuse its copies' memory before the compute stream is done with
        them, and `done` marks that point."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream()
        for t in self.fetched:
            t.record_stream(stream)
        self.done = torch.cuda.Event(enable_timing=self.stats is not None)
        self.done.record(stream)
        if self.stats is not None:
            self.stats._computes.append((self.start, self.done))
            self.stats.layers += 1


class _CardCopier:
    """Copies layer rows to the card on a side stream: pinned rows
    directly, pageable rows (disk maps, or unpinned host memory) through
    a ring of two pinned staging buffers, each sized to one layer's
    pageable rows. `non_blocking` from pageable memory would be a
    synchronous copy; the staging memcpy runs on the host while the card
    works through what was issued before it.

    Before a fetch allocates, the host waits until the compute of the
    layer fetched two fetches before is done, so at most two fetched
    layers are on the card, across calls too (a decode step's layer 0
    follows the step before's last layer)."""

    def __init__(self, dev: torch.device, stats: StreamStats | None):
        self.dev, self.stats = dev, stats
        self.stream = torch.cuda.Stream(dev)
        self.staging: list = [None, None]
        self.slot_free: list = [None, None]   # events: H2D from the slot done
        self.turn = 0
        self.inflight: list = []

    def _stage(self, rows: list) -> tuple[list, int]:
        sizes = [-(-r.numel() * r.element_size() // 256) * 256 for r in rows]
        slot = self.turn
        self.turn ^= 1
        if self.slot_free[slot] is not None:
            self.slot_free[slot].synchronize()
        buf = self.staging[slot]
        if buf is None or buf.numel() < sum(sizes):
            buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
            self.staging[slot] = buf
        out, pos = [], 0
        for r, size in zip(rows, sizes):
            n = r.numel() * r.element_size()
            view = buf[pos:pos + n].view(r.dtype).view(r.shape)
            view.copy_(r)
            out.append(view)
            pos += size
        return out, slot

    def fetch(self, rows: dict, dtype) -> _Layer:
        while len(self.inflight) >= 2:
            old = self.inflight.pop(0)
            if old.done is not None:
                old.done.synchronize()
        host = [k for k, r in rows.items() if not r.is_cuda]
        pageable = [k for k in host if not rows[k].is_pinned()]
        slot = None
        src = dict(rows)
        if pageable:
            staged, slot = self._stage([rows[k] for k in pageable])
            src.update(zip(pageable, staged))
        fetched, out = [], {}
        with torch.cuda.stream(self.stream):
            start = self.stats._event(self.stream) if self.stats else None
            for k, r in src.items():
                if k in host:
                    t = r.to(self.dev, non_blocking=True)
                    fetched.append(t)
                    if self.stats is not None:
                        self.stats.bytes += r.numel() * r.element_size()
                else:
                    t = r
                if dtype is not None and t.dtype != dtype:
                    t = t.to(dtype)
                    fetched.append(t)
                out[k] = t
            ready = torch.cuda.Event(enable_timing=self.stats is not None)
            ready.record(self.stream)
        if self.stats is not None and host:
            self.stats._copies.append((start, ready))
        if slot is not None:
            self.slot_free[slot] = ready
        layer = _Layer(unflatten_dict(out), ready, fetched, self.stats)
        self.inflight.append(layer)
        return layer


def make_layer_slicer(stacked: Any, device, dtype,
                      stats: StreamStats | None = None):
    """(n_layers, slice_fn): slice_fn(i) fetches layer i's params from
    wherever they live (the card, host memory, a disk map:
    `RowGroups.row`). On the card the copy is issued on a side stream and
    returns at once, so fetching layer i+1 overlaps layer i's compute."""
    dev = resolve_device(device)
    flat_stacked = flatten_dict(stacked)
    n_layers = min(leaf.shape[0] for leaf in flat_stacked.values())

    def rows(i):
        return {k: leaf.row(i) if isinstance(leaf, RowGroups) else leaf[i]
                for k, leaf in flat_stacked.items()}

    if dev.type != "cuda":
        def _layer_slice(i: int):
            return _Layer(unflatten_dict(
                {k: _cast(r.to(dev), dtype) for k, r in rows(i).items()}))
        return n_layers, _layer_slice

    copier = _CardCopier(dev, stats)
    return n_layers, lambda i: copier.fetch(rows(i), dtype)


def stream_layers(layer_slice, n_layers: int, step_fn, x):
    """The double-buffered layer loop: `step_fn(layer, i, x) -> x`, with
    layer i+1 fetched while layer i computes. The one home of the
    prefetch invariant for `streamed_forward`, `streamed_generate` and
    T5's streamed encoder.

    Layer i+1's fetch is issued before layer i's compute, as in the
    reference: its copy runs on the side stream under that compute, and
    when copies are the longer, each queues behind the one before, so
    the copy engine does not idle while the host issues a layer's
    kernels. On the card a fetch first waits until the compute of the
    layer two fetches back is done (`_CardCopier`): at most two fetched
    layers are on the device at once, and the loop never queues every
    layer's copy (the whole model) ahead of the compute."""
    nxt = layer_slice(0)
    for i in range(n_layers):
        cur = nxt
        if i + 1 < n_layers:
            nxt = layer_slice(i + 1)
        x = step_fn(cur.wait(), i, x)
        cur.release()
    return x


def streamed_generate(
    params: Any,
    input_ids,
    *,
    embed_fn: Callable[[Any, Any, Any], Any],
    layer_step_fn: Callable[[Any, Any, Any, tuple], tuple],
    project_fn: Callable[[Any, Any], Any],
    init_layer_cache: Callable[[int, int], tuple],
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    key: int = 0,
    stacked_module: str = "layers",
    device=None,
    dtype=None,
    stats: StreamStats | None = None,
):
    """KV-cache greedy/temperature decode with (partly) offloaded stacked
    layers: prompt in, prompt + new tokens out.

    Every step streams the layers through `layer_step_fn(layer, x,
    positions, (k, v, cache_len)) -> (x, (k, v, cache_len))`; each layer's
    KV cache stays on the device between steps (they are small beside the
    weights). `embed_fn(resident, ids, positions)` and
    `project_fn(resident, x)` run on the resident modules. Tokens are
    picked by `models.decode.sample_token`, row b with the stream
    `derive_key(key, b)`, at the positions `generate` uses, so both
    decode the same tokens."""
    from .models.decode import derive_key, sample_token

    dev = resolve_device(device)
    resident = fetch_resident(params, stacked_module, dev, dtype)
    n_layers, layer_slice = make_layer_slicer(params[stacked_module], dev,
                                              dtype, stats)
    ids = torch.as_tensor(input_ids).to(dev)
    b, prompt_len = ids.shape
    total = prompt_len + max_new_tokens
    caches = [init_layer_cache(b, total) for _ in range(n_layers)]
    keys = torch.tensor([derive_key(key, i) for i in range(b)],
                        dtype=torch.int64, device=dev)

    def run_stack(tokens, positions, cache_len):
        def step(layer, i, x):
            x, (nk, nv, _) = layer_step_fn(
                layer, x, positions, (caches[i][0], caches[i][1], cache_len))
            caches[i] = (nk, nv)
            return x

        x = stream_layers(layer_slice, n_layers, step,
                          embed_fn(resident, tokens, positions))
        return project_fn(resident, x)

    positions = torch.arange(prompt_len, device=dev).expand(b, prompt_len)
    logits = run_stack(ids, positions, 0)
    pos = torch.full((b,), prompt_len, dtype=torch.int64, device=dev)
    last = sample_token(logits, keys, temperature, pos)
    out = [last]
    for i in range(max_new_tokens - 1):
        logits = run_stack(last[:, None], (pos + i)[:, None], prompt_len + i)
        last = sample_token(logits, keys, temperature, pos + i + 1)
        out.append(last)
    return torch.cat([ids, torch.stack(out, dim=1).to(ids.dtype)], dim=1)


def streamed_forward(params: Any, inputs: Any,
                     embed_fn: Callable[[Any, Any], Any],
                     layer_fn: Callable[[Any, Any, int], Any],
                     final_fn: Callable[[Any, Any], Any],
                     stacked_module: str = "layers", device=None,
                     dtype=None, stats: StreamStats | None = None) -> Any:
    """Run a stacked-layer model whose layers are (partly) offloaded: for
    each layer i, fetch its params from wherever they live and run
    `layer_fn(layer, x, i)`, the copy of layer i+1 overlapping layer i's
    compute. The other modules are fetched to the device once."""
    dev = resolve_device(device)
    resident = fetch_resident(params, stacked_module, dev, dtype)
    n_layers, layer_slice = make_layer_slicer(params[stacked_module], dev,
                                              dtype, stats)
    if isinstance(inputs, torch.Tensor):
        inputs = inputs.to(dev)
    x = stream_layers(layer_slice, n_layers,
                      lambda layer, i, x: layer_fn(layer, x, i),
                      embed_fn(resident, inputs))
    return final_fn(resident, x)


# ---------------------------------------------------------------------------
# quantized load
# ---------------------------------------------------------------------------


_QUANT_CHUNK_ELEMS = 1 << 26   # rows quantized together on the host


def load_and_quantize_params(params_abstract: Any, checkpoint: str,
                             quantization_config=None, dtype=None,
                             device_put: bool = True, device=None) -> Any:
    """Read a checkpoint and block-quantize its weight matrices to int8
    or int4 (`ops.quant`), returning a tree of `QuantizedTensor` and
    plain tensors.

    Each tensor is read from the file, cast to `dtype` if given and
    quantized on the host, a chunk of rows at a time (blocks run along
    the last axis, so the codes equal those of the whole tensor), and
    with `device_put` moved to the device at once: the card only ever
    holds the compressed weights, and the host one chunk. There is no
    device map here: after compression the model is meant to fit."""
    from .ops.quant import QuantizedTensor, quantize, should_quantize
    from .utils.dataclasses import QuantizationConfig

    config = quantization_config or QuantizationConfig(load_in_8bit=True)
    dev = resolve_device(device) if device_put else torch.device("cpu")
    flat_spec = flatten_dict(params_abstract)
    found = checkpoint_tensors(resolve_checkpoint_files(checkpoint))
    out: dict[str, Any] = {}
    for name, src in found.items():
        if name not in flat_spec:
            continue
        expected = tuple(flat_spec[name].shape)
        if tuple(src.shape) != expected:
            raise ValueError(f"shape mismatch for {name}: checkpoint "
                             f"{tuple(src.shape)} vs model {expected}")
        out_dtype = dtype or src.dtype
        if config.bits >= 16 or not should_quantize(
                name.replace(".", "/"), src, config):
            t = torch.empty(src.shape, dtype=out_dtype, device=dev)
            _copy_into(t, src, None)
            out[name] = t
            continue
        rows = src.shape[0]
        per_row = max(1, _QUANT_CHUNK_ELEMS // max(1, math.prod(
            src.shape[1:])))
        data = scales = None
        for start in range(0, rows, per_row):
            end = min(rows, start + per_row)
            host = torch.empty((end - start,) + tuple(src.shape[1:]),
                               dtype=src.dtype)
            _copy_into(host, src, (start, end))
            qt = quantize(_cast(host, out_dtype), bits=config.bits,
                          block_size=config.block_size)
            if data is None:
                data = torch.empty((rows,) + qt.data.shape[1:],
                                   dtype=qt.data.dtype, device=dev)
                scales = torch.empty((rows,) + qt.scales.shape[1:],
                                     dtype=qt.scales.dtype, device=dev)
            data[start:end].copy_(qt.data)
            scales[start:end].copy_(qt.scales)
        out[name] = QuantizedTensor(data, scales, config.bits, src.shape,
                                    out_dtype)
    return unflatten_dict(out)
