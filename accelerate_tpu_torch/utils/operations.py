"""Tree utilities and host-level collectives for one process (port of
`accelerate_tpu/utils/operations.py`).

Trees are nested dicts, lists, tuples and NamedTuples; their leaves are
torch tensors (numpy arrays are taken too). Tensors stay torch tensors
on their device, where the reference hands back numpy arrays.

At world size 1 every collective is the reference's one-process form:
`gather` and `broadcast` return their input, `gather_object` a list of
one, `reduce` scales by `scale`, `pad_across_processes` pads nothing.
Across processes they run on the default `torch.distributed` group.

Transport by backend, decided from the group's backend and never after
a failure: gloo reduces, gathers and broadcasts host tensors, so under
gloo a CUDA leaf goes through the host and comes back on its device;
NCCL works on the card, so a host leaf goes to this process's device
and comes back to the host. numpy leaves come back as numpy.

`all_reduce_mean_` averages a list of tensors in place in flat buckets
(one `all_reduce` a bucket of up to `_BUCKET_ELEMENTS` elements of one
dtype, a leaf split across buckets where it is larger): the train
step's gradient all-reduce. `all_reduce_max_` takes the elementwise max
of a list in one `all_reduce`: the fp8 amaxes.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..data import to_device
from ..state import PartialState


class DistributedOperationException(Exception):
    """Raised by debug-mode verification when the processes pass leaves
    of different shapes or dtypes to one collective."""


def is_tensor(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def honor_type(obj, generator):
    """`obj`'s container type rebuilt from `generator` (NamedTuples by
    position)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def _map(fn: Callable, data: Any) -> Any:
    """`fn` over the leaves of nested dicts, lists, tuples and
    NamedTuples; None stays None (an empty subtree, as in the
    reference's tree_map)."""
    if isinstance(data, dict):
        return type(data)({k: _map(fn, v) for k, v in data.items()})
    if isinstance(data, (list, tuple)):
        return honor_type(data, (_map(fn, v) for v in data))
    if data is None:
        return None
    return fn(data)


def _leaves(data: Any) -> list:
    if isinstance(data, dict):
        return [leaf for v in data.values() for leaf in _leaves(v)]
    if isinstance(data, (list, tuple)):
        return [leaf for v in data for leaf in _leaves(v)]
    return [] if data is None else [data]


def recursively_apply(func: Callable, data: Any, *args: Any,
                      test_type: Callable[[Any], bool] = is_tensor,
                      error_on_other_type: bool = False, **kwargs: Any):
    """`func(leaf, *args, **kwargs)` on every leaf that passes
    `test_type`; other leaves kept, or a TypeError with
    `error_on_other_type`."""
    def apply(x):
        if test_type(x):
            return func(x, *args, **kwargs)
        if error_on_other_type:
            raise TypeError(f"unsupported type {type(x)} in "
                            "recursively_apply")
        return x

    return _map(apply, data)


def send_to_device(tensor, device=None, non_blocking: bool = True,
                   skip_keys=None):
    """Every array leaf as a tensor on `device` (default: the process's
    device); with `skip_keys`, a dict's entries under those keys stay as
    they are."""
    if device is None:
        device = PartialState().device
    if skip_keys and isinstance(tensor, dict):
        return type(tensor)({
            k: (v if k in skip_keys else send_to_device(v, device,
                                                        non_blocking))
            for k, v in tensor.items()})
    return to_device(tensor, device, non_blocking=non_blocking)


def find_batch_size(data) -> int | None:
    """The leading size of the first array leaf with a dimension."""
    for leaf in _leaves(data):
        if is_tensor(leaf) and leaf.ndim > 0:
            return int(leaf.shape[0])
    return None


def slice_tensors(data, tensor_slice, process_index=None,
                  num_processes=None):
    """Every array leaf indexed by `tensor_slice`."""
    return recursively_apply(lambda x: x[tensor_slice], data)


def listify(data):
    """Array leaves as nested Python lists."""
    return recursively_apply(
        lambda x: (x.detach().cpu() if isinstance(x, torch.Tensor)
                   else x).tolist(), data)


def convert_to_fp32(tensor):
    """Floating leaves (f16, bf16, f64) as float32; others kept."""
    def convert(x):
        if isinstance(x, torch.Tensor):
            return x.float() if x.is_floating_point() else x
        return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) \
            else x

    return recursively_apply(convert, tensor)


convert_outputs_to_fp32 = convert_to_fp32


# ---------------------------------------------------------------------------
# collectives across processes
# ---------------------------------------------------------------------------


def _world() -> int:
    return PartialState.num_processes


def _on_host() -> bool:
    """Whether the group's backend moves host tensors (gloo)."""
    return torch.distributed.get_backend() == "gloo"


def _to_transport(x) -> tuple[torch.Tensor, Callable]:
    """`x` as a tensor where the backend moves it, and the function that
    brings a result back to where `x` was (and to numpy, for numpy)."""
    if isinstance(x, np.ndarray):
        t, back = torch.from_numpy(np.ascontiguousarray(x)), \
            (lambda r: r.cpu().numpy())
    else:
        t, back = x, (lambda r, dev=x.device: r.to(dev))
    if _on_host():
        t = t.detach().cpu()
    else:
        t = t.detach().to(PartialState().device)
    return t.contiguous(), back


def _gather_one(x):
    t, back = _to_transport(x)
    if t.dim() == 0:
        t = t.reshape(1)
    parts = [torch.empty_like(t) for _ in range(_world())]
    torch.distributed.all_gather(parts, t)
    return back(torch.cat(parts, dim=0))


def gather(tensor):
    """Each leaf concatenated along dim 0 across processes (a 0-d leaf
    becomes one row a process); every process gets the result. Leaves
    must have one shape on every process (`pad_across_processes`
    first)."""
    if PartialStateDebug.enabled():
        verify_operation(tensor, "gather")
    if _world() == 1:
        return tensor
    return recursively_apply(_gather_one, tensor)


def gather_object(obj: Any) -> list[Any]:
    """The list of every process's `obj` (picklable), in rank order."""
    if _world() == 1:
        return [obj]
    out: list[Any] = [None] * _world()
    torch.distributed.all_gather_object(out, obj)
    return out


def _broadcast_one(x, src: int):
    t, back = _to_transport(x)
    t = t.clone()
    torch.distributed.broadcast(t, src=src)
    return back(t)


def broadcast(tensor, from_process: int = 0):
    """Every leaf as `from_process` holds it (shapes must agree)."""
    if PartialStateDebug.enabled():
        verify_operation(tensor, "broadcast")
    if _world() == 1:
        return tensor
    return recursively_apply(_broadcast_one, tensor, from_process)


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """`object_list`'s entries replaced, in place, by those of
    `from_process`'s list (picklable objects); returns the list."""
    if _world() > 1:
        torch.distributed.broadcast_object_list(object_list,
                                                src=from_process)
    return object_list


def _reduce_one(x, reduction: str, scale: float):
    t, back = _to_transport(x)
    t = t.clone()
    torch.distributed.all_reduce(t)
    if reduction == "mean":
        t = t / _world()
    return back(t * scale)


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """Each leaf summed (or averaged) across processes, times `scale`;
    `reduction="none"` returns the input. With one process the sum and
    the mean are the leaf itself."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean|sum|none, got {reduction}")
    if reduction == "none":
        return tensor
    if PartialStateDebug.enabled():
        verify_operation(tensor, "reduce")
    if _world() == 1:
        return recursively_apply(lambda x: x * scale, tensor)
    return recursively_apply(_reduce_one, tensor, reduction, scale)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0,
                         pad_first: bool = False):
    """Each leaf padded with `pad_index` along `dim` to the largest size
    across processes (before the data with `pad_first`), so a `gather`
    is legal; 0-d leaves and leaves with no `dim` stay as they are."""
    def pad(x):
        if x.ndim == 0 or dim >= x.ndim:
            return x
        sizes = gather_object(int(x.shape[dim]))
        top = max(sizes)
        if top == x.shape[dim]:
            return x
        rows = top - x.shape[dim]
        if isinstance(x, np.ndarray):
            width = [(0, 0)] * x.ndim
            width[dim] = (rows, 0) if pad_first else (0, rows)
            return np.pad(x, width, constant_values=pad_index)
        shape = list(x.shape)
        shape[dim] = rows
        fill = x.new_full(shape, pad_index)
        return torch.cat([fill, x] if pad_first else [x, fill], dim=dim)

    if _world() == 1:
        return tensor
    return recursively_apply(pad, tensor)


# elements of one all_reduce: 256 MiB of f32
_BUCKET_ELEMENTS = 1 << 26

# a gloo bucket's host buffer, kept per (dtype, size): pinned where a
# card is present, so its copies run at the link's rate
_HOST_BUCKETS: dict[tuple, torch.Tensor] = {}


def _bucket_buffer(dtype: torch.dtype, numel: int,
                   device: torch.device) -> torch.Tensor:
    if not _on_host():
        return torch.empty(numel, dtype=dtype, device=device)
    key = (dtype, numel)
    buf = _HOST_BUCKETS.get(key)
    if buf is None:
        buf = torch.empty(numel, dtype=dtype,
                          pin_memory=torch.cuda.is_available())
        _HOST_BUCKETS[key] = buf
    return buf


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor (contiguous) by its mean across processes, in
    place: the leaves of one dtype are packed into flat buckets of up to
    `_BUCKET_ELEMENTS` elements, one `all_reduce` (sum) a bucket, then
    divided by the world size on their device. Every process gets the
    same bits. Under gloo the bucket lives in host memory (pinned when a
    card is present); under NCCL on this process's device. With one
    process, nothing happens."""
    world = _world()
    if world == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        total = sum(t.numel() for t in group)
        size = min(_BUCKET_ELEMENTS, total)
        if size == 0:
            continue
        buf = _bucket_buffer(dtype, size, group[0].device)
        pieces: list[tuple[torch.Tensor, int]] = []
        fill = 0

        def flush():
            nonlocal fill
            torch.distributed.all_reduce(buf[:fill])
            for view, off in pieces:
                view.copy_(buf[off:off + view.numel()], non_blocking=True)
            pieces.clear()
            fill = 0

        for t in group:
            flat = t.view(-1)
            start = 0
            while start < flat.numel():
                take = min(size - fill, flat.numel() - start)
                view = flat[start:start + take]
                buf[fill:fill + take].copy_(view)
                pieces.append((view, fill))
                fill += take
                start += take
                if fill == size:
                    flush()
        if fill:
            flush()
        for t in group:
            t.div_(world)


@torch.no_grad()
def all_reduce_max_(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its elementwise max across processes, in
    place: the tensors (one dtype) are packed into one flat tensor and
    reduced by one `all_reduce`. With one process, nothing happens."""
    if _world() == 1 or not tensors:
        return
    t, back = _to_transport(torch.cat([x.reshape(-1) for x in tensors]))
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    out = back(t)
    off = 0
    for x in tensors:
        x.copy_(out[off:off + x.numel()].view_as(x))
        off += x.numel()


def pad_input_tensors(tensor, batch_size: int, num_processes: int,
                      dim: int = 0):
    """Each leaf padded along `dim` by repeating its last slice, so that
    `batch_size` divides evenly over `num_processes`."""
    def pad(x):
        remainder = batch_size % num_processes
        if remainder == 0:
            return x
        rows = num_processes - remainder
        if isinstance(x, np.ndarray):
            width = [(0, 0)] * x.ndim
            width[dim] = (0, rows)
            return np.pad(x, width, mode="edge")
        edge = x.narrow(dim, x.shape[dim] - 1, 1)
        return torch.cat([x, edge.repeat_interleave(rows, dim=dim)], dim=dim)

    return recursively_apply(pad, tensor)


def concatenate(data: list, dim: int = 0):
    """A list of trees of one structure, leaves concatenated along
    `dim`."""
    if not data:
        return data
    first = data[0]
    if isinstance(first, dict):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim)
                            for k in first})
    if isinstance(first, (tuple, list)):
        return honor_type(first, (concatenate([d[i] for d in data], dim=dim)
                                  for i in range(len(first))))
    if all(isinstance(d, torch.Tensor) for d in data):
        return torch.cat(list(data), dim=dim)
    return np.concatenate([np.asarray(d) for d in data], axis=dim)


# ---------------------------------------------------------------------------
# debug-mode verification
# ---------------------------------------------------------------------------


class PartialStateDebug:
    """Whether the process state asks for debug verification
    (`PartialState().debug`)."""

    @staticmethod
    def enabled() -> bool:
        return PartialState._shared_state.get("debug", False)


def verify_operation(tensor, op_name: str) -> None:
    """Check that every process passes leaves of the same shapes and
    dtypes to `op_name`; raise `DistributedOperationException` with the
    table of every rank's leaves where they differ. One process always
    agrees."""
    if _world() == 1:
        return
    skeleton = _map(lambda x: (tuple(x.shape), str(x.dtype))
                    if is_tensor(x) else None, tensor)
    everyone = gather_object(skeleton)
    if any(s != everyone[0] for s in everyone[1:]):
        table = "\n".join(f"  rank {i}: {s}" for i, s in enumerate(everyone))
        raise DistributedOperationException(
            f"Mismatched operand structure for `{op_name}` across "
            f"processes:\n{table}")
