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

`axis_all_reduce`, `axis_all_gather` and `axis_broadcast_float` run on a
mesh axis's group (`state.ProcessMesh.group`): the collectives of the
tensor-parallel forward (`models/tensor_parallel.py`) and of the meshed
engine's lockstep clock. `axis_all_to_all` (the tiled `lax.all_to_all`),
`axis_scatter` and `axis_gather` are differentiable: the all-to-all of
Ulysses and of the expert-parallel MoE dispatch, and the entry and exit
of a schedule that takes and returns tensors every rank of the line
holds whole (`parallel/`). `axis_ppermute` (point to point along the
axis's line, `lax.ppermute`'s counterpart) and `axis_broadcast` are the
pipeline schedules' (`parallel/pipeline.py`); `axis_mean`, also
differentiable, is a global-batch statistic over a batch line. They take the same
transport: host copies under gloo (point to point and the broadcast
move each tensor as its bytes, so every dtype goes), the device under
NCCL (no card run has reached the NCCL
branch: one H100 holds one NCCL rank).

`all_reduce_mean_` averages a list of tensors in place in flat buckets
(one `all_reduce` a bucket of up to `_BUCKET_ELEMENTS` elements of one
dtype, a leaf split across buckets where it is larger), over the world
or a group: the train step's gradient all-reduce over the batch line
(`state.ProcessMesh.data_line`). `all_reduce_max_` takes the elementwise max
of a list in one `all_reduce`: the fp8 amaxes. `reduce_scatter_mean_`
and `all_gather_blocks_` are ZeRO-1/2's pair on the `fsdp` axis's group,
in the same kind of buckets: each rank gets the mean of its block of
every gradient, and every rank's updated block of a param is written
into the whole param on every rank. Under gloo they run as one
`reduce` and one `broadcast` a rank, which gloo moves faster than its
own reduce-scatter and all-gather; under NCCL as `reduce_scatter` and
`all_gather` (unrun: one H100 holds one NCCL rank).
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


def _on_host(group=None) -> bool:
    """Whether the group's backend moves host tensors (gloo)."""
    return torch.distributed.get_backend(group) == "gloo"


def _to_transport(x, group=None) -> tuple[torch.Tensor, Callable]:
    """`x` as a tensor where the backend moves it, and the function that
    brings a result back to where `x` was (and to numpy, for numpy)."""
    if isinstance(x, np.ndarray):
        t, back = torch.from_numpy(np.ascontiguousarray(x)), \
            (lambda r: r.cpu().numpy())
    else:
        t, back = x, (lambda r, dev=x.device: r.to(dev))
    if _on_host(group):
        t = t.detach().cpu()
    else:
        t = t.detach().to(PartialState().device)
    return t.contiguous(), back


def _gather_one(x, group=None):
    t, back = _to_transport(x, group)
    if t.dim() == 0:
        t = t.reshape(1)
    n = _world() if group is None else torch.distributed.get_world_size(
        group)
    parts = [torch.empty_like(t) for _ in range(n)]
    torch.distributed.all_gather(parts, t, group=group)
    return back(torch.cat(parts, dim=0))


def gather(tensor, group=None):
    """Each leaf concatenated along dim 0 across processes (a 0-d leaf
    becomes one row a process); every process gets the result. Leaves
    must have one shape on every process (`pad_across_processes`
    first). `group` gathers over its processes alone, in its rank order
    (default: the world)."""
    if PartialStateDebug.enabled():
        verify_operation(tensor, "gather")
    if _world() == 1:
        return tensor
    return recursively_apply(_gather_one, tensor, group)


def gather_object(obj: Any, group=None) -> list[Any]:
    """The list of every process's `obj` (picklable), in rank order
    (of `group`'s processes alone, where given)."""
    if _world() == 1:
        return [obj]
    n = _world() if group is None else torch.distributed.get_world_size(
        group)
    out: list[Any] = [None] * n
    torch.distributed.all_gather_object(out, obj, group=group)
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


def _bucket_buffer(dtype: torch.dtype, numel: int, device: torch.device,
                   group=None) -> torch.Tensor:
    if not _on_host(group):
        return torch.empty(numel, dtype=dtype, device=device)
    key = (dtype, numel)
    buf = _HOST_BUCKETS.get(key)
    if buf is None:
        buf = torch.empty(numel, dtype=dtype,
                          pin_memory=torch.cuda.is_available())
        _HOST_BUCKETS[key] = buf
    return buf


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor (contiguous) by its mean over `group`'s
    processes (default: the world), in place: the leaves of one dtype
    are packed into flat buckets of up to `_BUCKET_ELEMENTS` elements,
    one `all_reduce` (sum) a bucket, then divided by the group's size on
    their device. Every process of the group gets the same bits. Under
    gloo the bucket lives in host memory (pinned when a card is
    present); under NCCL on this process's device. With one process,
    nothing happens."""
    world = _world() if group is None else \
        torch.distributed.get_world_size(group)
    if world == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, same in by_dtype.items():
        total = sum(t.numel() for t in same)
        size = min(_BUCKET_ELEMENTS, total)
        if size == 0:
            continue
        buf = _bucket_buffer(dtype, size, same[0].device, group)
        pieces: list[tuple[torch.Tensor, int]] = []
        fill = 0

        def flush():
            nonlocal fill
            torch.distributed.all_reduce(buf[:fill], group=group)
            for view, off in pieces:
                view.copy_(buf[off:off + view.numel()], non_blocking=True)
            pieces.clear()
            fill = 0

        for t in same:
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
        for t in same:
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


def _block_buckets(tensors: list, dims: list, n: int) -> list:
    """The flat buckets of a blockwise collective over `n` ranks: for
    each dtype in first-seen order, buckets of pieces `(i, row0, rows)`
    (rows `row0:row0+rows` along the block's first dim of leaf `i`'s
    blocks, each leaf cut into `n` blocks along `dims[i]`), each bucket
    holding up to `_BUCKET_ELEMENTS // n` elements a rank (a row larger
    than that is a bucket of its own). Returns [(dtype, share, pieces)],
    `share` the elements a rank's part of the bucket holds."""
    cap = max(1, _BUCKET_ELEMENTS // n)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = []
    for dtype, idx in by_dtype.items():
        pieces, fill = [], 0
        for i in idx:
            t, d = tensors[i], dims[i]
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over {n} ranks")
            block = list(t.shape)
            block[d] //= n
            rows, row = block[0], max(1, int(np.prod(block[1:])))
            start = 0
            while start < rows:
                if fill and fill + row > cap:
                    out.append((dtype, fill, pieces))
                    pieces, fill = [], 0
                take = min(rows - start, max(1, (cap - fill) // row))
                pieces.append((i, start, take))
                fill += take * row
                start += take
        if pieces:
            out.append((dtype, fill, pieces))
    return out


def _widest(buckets: list) -> dict:
    """The largest share of each dtype's buckets: one host buffer of
    each size serves every bucket of the dtype."""
    out: dict = {}
    for dtype, share, _ in buckets:
        out[dtype] = max(out.get(dtype, 0), share)
    return out


def _block_piece(t: torch.Tensor, dim: int, n: int, rank: int, row0: int,
                 rows: int) -> torch.Tensor:
    """Rows `row0:row0+rows` of rank `rank`'s block of `t` (a view)."""
    b = t.shape[dim] // n
    return t.narrow(dim, rank * b, b).narrow(0, row0, rows)


def _finish_host_copies(tensors, group) -> None:
    """Under gloo, wait for the non-blocking copies from a bucket's
    pinned host buffer to the card, so the buffer may be written again."""
    if not _on_host(group):
        return
    devices = {t.device for t in tensors if t is not None and t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def _reduce_scatter_bucket(inp: torch.Tensor, n: int, share: int,
                           group) -> torch.Tensor:
    """The sum over `group` of this rank's share of `inp` (laid out rank
    by rank, `share` elements each): under gloo one `reduce` to each
    share's owner, in the group's order (gloo's reduce-scatter runs at
    half their rate on the host), the result in `inp`'s own slice; under
    NCCL one `reduce_scatter` into a new device buffer."""
    r = torch.distributed.get_rank(group)
    if _on_host(group):
        for q in range(n):
            torch.distributed.reduce(inp[q * share:(q + 1) * share],
                                     dst=_axis_global_rank(group, q),
                                     group=group)
        return inp[r * share:(r + 1) * share]
    out = torch.empty(share, dtype=inp.dtype, device=inp.device)
    scatter = getattr(torch.distributed, "reduce_scatter_single", None) \
        or torch.distributed.reduce_scatter_tensor
    scatter(out, inp, group=group)
    return out


def _all_gather_bucket(out: torch.Tensor, n: int, share: int,
                       group) -> None:
    """Every rank's share of `out` (laid out rank by rank, `share`
    elements each, this rank's own filled in) from its owner, in place:
    under gloo one `broadcast` of its bytes from each owner, in the
    group's order (gloo's all-gather runs at a quarter of their rate on
    the host, and broadcasts no bf16);
    under NCCL one `all_gather`."""
    r = torch.distributed.get_rank(group)
    if _on_host(group):
        for q in range(n):
            torch.distributed.broadcast(
                _bytes(out[q * share:(q + 1) * share], True),
                src=_axis_global_rank(group, q), group=group)
        return
    gather = getattr(torch.distributed, "all_gather_single", None) \
        or torch.distributed.all_gather_into_tensor
    gather(out, out[r * share:(r + 1) * share].clone(), group=group)


@torch.no_grad()
def reduce_scatter_mean_(tensors: list, blocks: list[torch.Tensor],
                         dims: list[int], group) -> None:
    """ZeRO's gradient reduce-scatter: each tensor of `tensors` (whole,
    one shape on every rank of `group`) cuts into the group's `n` blocks
    along `dims[i]`, one a rank in the group's order, and `blocks[i]`
    (this rank's block's shape) gets the mean over the group of this
    rank's block, in place. The leaves of one dtype are packed leaf by
    leaf, in the list's order, into flat buckets (`_block_buckets`, up to
    `_BUCKET_ELEMENTS` elements; a leaf larger than a bucket split along
    its block's first dim) laid out rank by rank, one reduce-scatter a
    bucket (`_reduce_scatter_bucket`). An entry of `tensors` is set to
    None once its last piece is reduced, so a caller that holds no other
    reference frees the whole gradients bucket by bucket. Under gloo the
    buckets live in host memory (pinned when a card is present), under
    NCCL on this process's device; every rank must make the call, with
    the same shapes in the same order. A None group is a line of one:
    each block is the whole tensor."""
    if group is None:
        for i, (t, b) in enumerate(zip(tensors, blocks)):
            b.copy_(t)
            tensors[i] = None
        return
    n = torch.distributed.get_world_size(group)
    last = {}
    buckets = _block_buckets(tensors, dims, n)
    for k, (_, _, pieces) in enumerate(buckets):
        for i, _, _ in pieces:
            last[i] = k
    widest = _widest(buckets)
    for k, (dtype, share, pieces) in enumerate(buckets):
        dev = tensors[pieces[0][0]].device
        inp = _bucket_buffer(dtype, n * widest[dtype], dev, group)[
            :n * share]
        for q in range(n):
            off = q * share
            for i, row0, rows in pieces:
                src = _block_piece(tensors[i], dims[i], n, q, row0, rows)
                inp[off:off + src.numel()].view(src.shape).copy_(src)
                off += src.numel()
        out = _reduce_scatter_bucket(inp, n, share, group)
        off = 0
        for i, row0, rows in pieces:
            dst = blocks[i].narrow(0, row0, rows)
            dst.copy_(out[off:off + dst.numel()].view(dst.shape),
                      non_blocking=True)
            off += dst.numel()
        _finish_host_copies([blocks[i] for i, _, _ in pieces], group)
        for i, _, _ in pieces:
            if last[i] == k:
                tensors[i] = None
    for b in blocks:
        b.div_(n)


@torch.no_grad()
def all_gather_blocks_(tensors: list[torch.Tensor], dims: list[int],
                       group) -> None:
    """ZeRO's parameter all-gather, the inverse of `reduce_scatter_mean_`:
    each tensor (whole) holds this rank's block along `dims[i]` up to
    date, and every other rank's block of it is written in place from
    that rank's, so every rank of `group` then holds the same whole
    tensors bit for bit. The same buckets as `reduce_scatter_mean_`, one
    all-gather a bucket (`_all_gather_bucket`). A None group is a line
    of one."""
    if group is None:
        return
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    buckets = _block_buckets(tensors, dims, n)
    widest = _widest(buckets)
    for dtype, share, pieces in buckets:
        dev = tensors[pieces[0][0]].device
        out = _bucket_buffer(dtype, n * widest[dtype], dev, group)[
            :n * share]
        off = r * share
        for i, row0, rows in pieces:
            src = _block_piece(tensors[i], dims[i], n, r, row0, rows)
            out[off:off + src.numel()].view(src.shape).copy_(src)
            off += src.numel()
        _all_gather_bucket(out, n, share, group)
        for q in range(n):
            if q == r:
                continue
            off = q * share
            for i, row0, rows in pieces:
                dst = _block_piece(tensors[i], dims[i], n, q, row0, rows)
                dst.copy_(out[off:off + dst.numel()].view(dst.shape),
                          non_blocking=True)
                off += dst.numel()
        _finish_host_copies([tensors[i] for i, _, _ in pieces], group)


# ---------------------------------------------------------------------------
# collectives on a mesh axis (tensor parallelism)
# ---------------------------------------------------------------------------


@torch.no_grad()
def axis_all_reduce(tensor: torch.Tensor, group,
                    op: str = "sum") -> torch.Tensor:
    """The sum (or, with `op="max"`, the elementwise max) of `tensor`
    over the ranks of `group` (a mesh axis's, see
    `state.ProcessMesh.group`), as a new tensor on `tensor`'s device;
    `tensor` itself is left as it was. Under gloo the reduction runs on a
    host copy (`_to_transport`), under NCCL on the device. A None group
    is a line of one: the result is the tensor."""
    if group is None:
        return tensor
    reduce_op = {"sum": torch.distributed.ReduceOp.SUM,
                 "max": torch.distributed.ReduceOp.MAX}[op]
    t, back = _to_transport(tensor, group)
    t = t.clone() if t.data_ptr() == tensor.data_ptr() else t
    torch.distributed.all_reduce(t, op=reduce_op, group=group)
    return back(t)


@torch.no_grad()
def axis_all_gather(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `tensor` of `group` concatenated along `dim` in the
    axis's order, on `tensor`'s device (the same shape on every rank)."""
    if group is None:
        return tensor
    t, back = _to_transport(tensor, group)
    parts = [torch.empty_like(t)
             for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, t, group=group)
    return back(torch.cat(parts, dim=dim))


def axis_broadcast_float(value: float, group) -> float:
    """`value` as the group's first rank holds it, on every rank."""
    if group is None:
        return value
    src = torch.distributed.get_global_rank(group, 0) \
        if group is not torch.distributed.group.WORLD else 0
    device = "cpu" if _on_host(group) else PartialState().device
    t = torch.tensor([value], dtype=torch.float64, device=device)
    torch.distributed.broadcast(t, src=src, group=group)
    return float(t.item())


def _axis_global_rank(group, index: int) -> int:
    """The global rank of the `index`-th rank of `group`."""
    if group is torch.distributed.group.WORLD:
        return index
    return torch.distributed.get_global_rank(group, index)


def _bytes(t: torch.Tensor, on_host: bool) -> torch.Tensor:
    """A contiguous tensor viewed as its bytes, for the host transport
    (gloo broadcasts no bf16); as it is on the device."""
    return t.reshape(-1).view(torch.uint8) if on_host else t


@torch.no_grad()
def axis_ppermute(tensor: torch.Tensor | None, group, shift: int = 1, *,
                  recv_like: torch.Tensor | None = None):
    """`lax.ppermute` along a mesh axis's line (`group`) by `shift`:
    send `tensor` to the rank `shift` places on (cyclically) and receive
    from the rank `shift` places back, into a new tensor of
    `recv_like`'s shape and dtype on its device; returns it (None when
    `recv_like` is None). `tensor=None` sends nothing, so a schedule
    leaves an idle edge out, on both of its ends. The send and the
    receive are posted together (`isend`/`irecv`) and both waited on: a
    ring of blocking sends could deadlock. A failed send or receive
    raises."""
    if group is None:
        raise ValueError("axis_ppermute needs an axis of more than one rank")
    n = torch.distributed.get_world_size(group)
    me = torch.distributed.get_rank(group)
    on_host = _on_host(group)
    work, out = [], None
    if tensor is not None:
        t, _ = _to_transport(tensor, group)
        work.append(torch.distributed.isend(
            _bytes(t, on_host), _axis_global_rank(group, (me + shift) % n),
            group=group))
    if recv_like is not None:
        dev = "cpu" if on_host else PartialState().device
        out = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          device=dev)
        work.append(torch.distributed.irecv(
            _bytes(out, on_host), _axis_global_rank(group, (me - shift) % n),
            group=group))
    for w in work:
        w.wait()
    return None if out is None else out.to(recv_like.device)


@torch.no_grad()
def axis_broadcast(tensor: torch.Tensor, group, src: int) -> torch.Tensor:
    """`tensor` as the `src`-th rank of `group` holds it, as a new tensor
    on `tensor`'s device on every rank (the others pass a tensor of the
    same shape and dtype, whose values are not read); `tensor` itself is
    left as it was. The pipelines' "psum of one-hot" from the last
    stage. A None group is a line of one."""
    if group is None:
        return tensor
    t, back = _to_transport(tensor, group)
    t = t.clone() if t.data_ptr() == tensor.data_ptr() else t
    torch.distributed.broadcast(_bytes(t, _on_host(group)),
                                src=_axis_global_rank(group, src),
                                group=group)
    return back(t)


@torch.no_grad()
def _all_to_all(tensor: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    n = torch.distributed.get_world_size(group)
    if tensor.shape[split_dim] % n:
        raise ValueError(f"axis_all_to_all: dim {split_dim} of "
                         f"{tuple(tensor.shape)} does not split over {n} "
                         "ranks")
    on_host = _on_host(group)
    # block j (for rank j) first, each block contiguous
    blocks = torch.stack(tensor.chunk(n, dim=split_dim))
    t, _ = _to_transport(blocks, group)
    out = torch.empty_like(t)
    # equal blocks along the leading dim; under gloo as their bytes
    torch.distributed.all_to_all_single(_bytes(out, on_host),
                                        _bytes(t, on_host), group=group)
    out = out.to(tensor.device)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AxisAllToAll(torch.autograd.Function):
    """Tiled all-to-all along a line; its transpose swaps the dims."""

    @staticmethod
    def forward(ctx, tensor, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(tensor, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad.contiguous(), concat_dim, split_dim,
                            ctx.group), None, None, None)


def axis_all_to_all(tensor: torch.Tensor, split_dim: int, concat_dim: int,
                    group) -> torch.Tensor:
    """The tiled `lax.all_to_all` along a mesh axis's line: `tensor` is
    cut into as many equal blocks along `split_dim` as the line has
    ranks, block j goes to the line's j-th rank, and the blocks received
    are concatenated along `concat_dim` in the line's order, on
    `tensor`'s device. One `all_to_all_single` (under gloo on host
    copies, as bytes; under NCCL on the device). Differentiable: the
    gradient runs the all-to-all back with the two dims swapped. A None
    group is a line of one: the tensor itself."""
    if group is None:
        return tensor
    return _AxisAllToAll.apply(tensor.contiguous(), split_dim, concat_dim,
                               group)


def _own_block(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = torch.distributed.get_world_size(group)
    if tensor.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                         f"split over {n} ranks")
    return tensor.chunk(n, dim=dim)[
        torch.distributed.get_rank(group)].contiguous()


class _AxisScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_block(tensor, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return (axis_all_gather(grad.contiguous(), ctx.dim, ctx.group),
                None, None)


class _AxisGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, dim, group):
        ctx.dim, ctx.group = dim, group
        return axis_all_gather(tensor.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.dim, ctx.group), None, None


def axis_scatter(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of a tensor that every rank of the line holds
    whole (the blocks cut along `dim`, one a rank in the line's order):
    the entry of a `shard_map` in-spec that shards `dim` over the axis.
    Its gradient is every rank's block gradient all-gathered, so a
    replicated input gets its full gradient on every rank, as under the
    reference's GSPMD. A None group is a line of one."""
    if group is None:
        return tensor
    return _AxisScatter.apply(tensor, dim, group)


def axis_gather(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`axis_all_gather` made differentiable for an output that every
    rank of the line then holds whole (a `shard_map` out-spec that shards
    `dim` over the axis): the gradient is this rank's block of the
    output's gradient, which is the same on every rank. The transpose of
    `axis_scatter`. A None group is a line of one."""
    if group is None:
        return tensor
    return _AxisGather.apply(tensor, dim, group)


class _AxisMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        n = torch.distributed.get_world_size(group)
        return axis_all_reduce(tensor, group) / n

    @staticmethod
    def backward(ctx, grad):
        n = torch.distributed.get_world_size(ctx.group)
        return axis_all_reduce(grad.contiguous(), ctx.group) / n, None


def axis_mean(tensor: torch.Tensor, group) -> torch.Tensor:
    """The mean of `tensor` over the ranks of `group`, differentiable: a
    statistic of the global batch that each rank of a batch line forms
    from its own rows. The gradient is the mean of the ranks'
    gradients, so the line's average of the ranks' parameter gradients
    (the train step's) is the gradient of the global statistic, as the
    reference's GSPMD gives it. A None group is a line of one."""
    if group is None:
        return tensor
    return _AxisMean.apply(tensor.contiguous(), group)


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
