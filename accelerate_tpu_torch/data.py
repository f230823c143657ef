"""Sharded data loading, prefetched onto the card (port of
`accelerate_tpu/data.py`).

The pipeline of a prepared loader, in two stages as in the reference:

    host iterable (this process's share of each global batch)
        -> `_PrefetchIterator`: a host thread converts each batch to
           numpy (collate -> numpy -> pad) into a bounded queue; it makes
           no CUDA call and pins nothing
        -> `DevicePrefetchIterator`: up to `device_prefetch_depth`
           batches' copies from pinned host memory to the card in flight
           on a side CUDA stream, one event per batch; before a batch is
           handed out the consumer's stream waits on its event, and each
           of its tensors is `record_stream`-ed onto the consumer's stream
           so the caching allocator cannot hand its memory to a later
           batch while the step still reads it
        -> `DataLoaderShard`: one-batch-ahead `end_of_dataloader`, the
           uneven tail's `remainder`/`tail_layout`, the epoch, and the
           registration with `GradientState` that `accumulate()` reads.

The host-side sharding keeps the reference's semantics whole:
`SeedableRandomSampler`, `BatchSamplerShard`, `ShardedBatchIterable` and
`IterableDatasetShard` take `num_processes` and `process_index`
explicitly, and `prepare_data_loader` re-shards a torch `DataLoader`,
an unsized iterable or a sized batch stream across the processes of the
batch line (`state.data_line`: the ranks over the `data` and `fsdp`
axes, so the ranks of one `stage`, `seq` or `expert` line see the same
rows; the world on a mesh of `data` alone). A loader takes the port's mesh
(`state.ProcessMesh`), and the dispatcher broadcasts each batch from
process 0 to the others.

A batch of `n` rows is padded only where `n` is not a multiple of the
process's share of the data-parallel devices (the reference's
`per_host` rule); each process owns one device, so that share is 1 and
the loader pads nothing: an uneven tail across processes is padded by
the sharding layer below it (`ShardedBatchIterable`,
`BatchSamplerShard`), whose `remainder` and `tail_layout` the loader
hands to `GradientState`.
"""

from __future__ import annotations

import collections
import copy
import itertools
import math
import queue
import threading
import warnings
from collections import Counter
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from .logging import get_logger
from .optimizers import tree_leaves
from .state import GradientState, PartialState, ProcessMesh, data_line
from .telemetry.trace import span
from .utils.constants import BATCH_AXES
from .utils.dataclasses import DataLoaderConfiguration
from .utils.random import synchronize_rng_states

logger = get_logger(__name__)

_SENTINEL = object()


def to_device(batch: Any, device, non_blocking: bool = True) -> Any:
    """Every array leaf of `batch` as a tensor on `device` (nested dicts,
    lists and tuples kept). For a `non_blocking` copy to a GPU, host
    leaves are pinned first, so the copy can overlap compute; other
    leaves pass through."""
    if isinstance(batch, dict):
        return {k: to_device(v, device, non_blocking)
                for k, v in batch.items()}
    if hasattr(batch, "_fields"):
        return type(batch)(*(to_device(v, device, non_blocking)
                             for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device, non_blocking) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor):
        return batch
    device = torch.device(device)
    if batch.device == device:
        return batch
    if non_blocking and device.type == "cuda" and batch.device.type == "cpu":
        batch = batch.pin_memory()
    return batch.to(device, non_blocking=non_blocking)


def _tree_map(fn: Callable, tree: Any, is_leaf: Callable | None = None):
    """`fn` on every leaf of nested dicts, lists, tuples and namedtuples,
    the structure kept (None stays None); a node for which `is_leaf` is
    true is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        out = {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
        return out if type(tree) is dict else type(tree)(out)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    if tree is None:
        return None
    return fn(tree)


# ---------------------------------------------------------------------------
# host-side leaf conversion
# ---------------------------------------------------------------------------


def _to_numpy(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, np.generic):  # numpy scalar -> 0-d array
        return np.asarray(x)
    if isinstance(x, (int, float, bool)):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], (int, float)):
        return np.asarray(x)
    return x


def batch_to_numpy(batch: Any, keep_device_arrays: bool = False) -> Any:
    """Convert a host batch (torch tensors, lists, numpy) to numpy leaves.

    `keep_device_arrays=True` passes tensors that already live on a card
    through untouched: placement keeps them there, so converting here
    would copy them to the host only to copy them back."""
    if keep_device_arrays:
        return _tree_map(
            lambda x: x if isinstance(x, torch.Tensor)
            and x.device.type != "cpu" else _to_numpy(x), batch)
    return _tree_map(_to_numpy, batch)


def _batch_size(batch: Any) -> int | None:
    """The batch's row count. Evidence in order, whatever the dict key
    order: (1) array leading dims, the majority one winning (an aux array
    whose key sorts first must not set it); (2) row containers (lists of
    strings, scalars or ragged sequences), by their length; (3) ambiguous
    lists of equal-length 1-D arrays, by their first array's length (the
    field interpretation)."""
    containers: list = []
    deferred: list = []
    dims: list[int] = []

    def walk(node) -> None:
        if _is_row_container(node):
            if len(node):
                containers.append(node)  # empty ones carry no evidence
            return
        if (
            isinstance(node, (list, tuple))
            and not hasattr(node, "_fields")
            and node
            and getattr(node[0], "ndim", None) == 1
        ):
            deferred.append(node)  # ambiguous: equal-length 1-D rows/fields
            return
        # numpy arrays and torch tensors both expose .ndim and .shape
        if getattr(node, "ndim", 0):
            dims.append(int(node.shape[0]))
            return
        if isinstance(node, dict):
            children = (v for _, v in sorted(node.items(),
                                             key=lambda kv: str(kv[0])))
        elif isinstance(node, (list, tuple)):
            children = iter(node)
        else:
            return
        for child in children:
            walk(child)

    walk(batch)
    if dims:
        counts = Counter(dims)
        best = max(counts.values())
        for d in dims:
            if counts[d] == best:
                return d
    for node in containers:
        return len(node)
    for node in deferred:
        return int(node[0].shape[0])
    return None


def _wrap_pad_rows(x: Any, target: int) -> Any:
    """Wraparound-extend the rows of a list/tuple (row container) or the
    leading dim of an array up to `target`; anything else passes through."""
    if isinstance(x, (list, tuple)):
        if len(x) == 0 or len(x) >= target:
            return x
        reps = math.ceil(target / len(x))
        return type(x)((list(x) * reps)[:target])
    if not isinstance(x, np.ndarray) or x.ndim == 0 or x.shape[0] >= target:
        return x
    reps = math.ceil(target / x.shape[0])
    return np.concatenate([x] * reps, axis=0)[:target]


def _is_row_container(x: Any, expected_rows: int | None = None) -> bool:
    """True for a list/tuple whose elements are individual rows (strings,
    scalars, ragged sequences) rather than structure. A tuple batch like
    (inputs, labels) holds arrays and is structure: each field is sliced
    and padded row-wise. A list of strings is a leaf, sliced whole."""
    if not isinstance(x, (list, tuple)) or hasattr(x, "_fields"):
        # namedtuples are structure (fixed fields), never row batches
        return False
    if len(x) == 0:
        return True
    head = x[0]
    if isinstance(x, tuple):
        # numeric tuples like (224, 224) are metadata, and a tuple of
        # arrays is a field pair; only string/bytes tuples count as rows
        return isinstance(head, (str, bytes))
    # lists: scalar-like rows, ragged token sequences (lists of lists), or
    # 0-d arrays are rows; a list of >=2-D arrays or dicts is structure
    if isinstance(
        head,
        (str, bytes, int, float, bool, complex, type(None), np.generic, list),
    ):
        return True
    head_ndim = getattr(head, "ndim", None)
    if head_ndim == 0:
        return True
    if head_ndim == 1:
        # a list of 1-D arrays: ragged token rows, or the [features,
        # labels] field list of torch's default_collate. Varying lengths
        # mean rows; for equal lengths the batch's known row count decides
        # (one entry per row is rows, a short field list is structure);
        # without it, equal lengths are structure
        lengths = {len(e) for e in x if getattr(e, "ndim", None) == 1}
        if len(lengths) > 1:
            return True
        if expected_rows is None or len(x) != expected_rows:
            return False
        # the square case (k fields of k samples against k rows of k
        # tokens) is undecidable: default to the field interpretation
        (inner,) = lengths or {0}
        return inner != expected_rows
    return False


# ---------------------------------------------------------------------------
# samplers and sharding iterables (host code; explicit process counts)
# ---------------------------------------------------------------------------


class SeedableRandomSampler:
    """A permutation of `range(data_source_len)` from (seed, epoch): every
    process computes the same one, with no broadcast."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()


class BatchSamplerShard:
    """Shard a stream of batch indices across `num_processes` processes.

    `split_batches=False`: each process takes batches round-robin
    (process i gets batch i, i+N, ...). `split_batches=True`: every batch
    is split into N equal slices. `even_batches=True` wraps around to
    duplicate initial samples so every process yields the same number of
    equally sized batches.
    """

    def __init__(
        self,
        batch_sampler: Iterable,
        num_processes: int = 1,
        process_index: int = 0,
        split_batches: bool = False,
        even_batches: bool = True,
    ):
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def __len__(self) -> int:
        length = len(self.batch_sampler)  # type: ignore[arg-type]
        if self.split_batches:
            return length
        if length % self.num_processes == 0:
            return length // self.num_processes
        return length // self.num_processes + (0 if self.drop_last else 1)

    def __iter__(self) -> Iterator[list]:
        if self.split_batches:
            yield from self._iter_split()
        else:
            yield from self._iter_stride()

    def _iter_split(self) -> Iterator[list]:
        for batch in self.batch_sampler:
            # checked here, not in __init__: a peek there would consume the
            # first batch of a one-shot iterator
            if len(batch) % self.num_processes != 0:
                raise ValueError(
                    f"split_batches=True requires batch size ({len(batch)}) "
                    f"divisible by num_processes ({self.num_processes})"
                )
            chunk = len(batch) // self.num_processes
            start = self.process_index * chunk
            yield batch[start : start + chunk]

    def _iter_stride(self) -> Iterator[list]:
        initial: list[list] = []
        cursor = 0
        mine = None
        batch_size = None
        for batch in self.batch_sampler:
            if len(initial) < self.num_processes:
                initial.append(batch)
            if batch_size is None:
                batch_size = len(batch)
            if cursor % self.num_processes == self.process_index:
                mine = batch
            cursor += 1
            if cursor % self.num_processes == 0:
                yield mine
                mine = None
        if cursor % self.num_processes == 0:
            return
        # the uneven tail
        if self.drop_last:
            return
        if not self.even_batches:
            if mine is not None:
                yield mine
            return
        # wraparound: complete the final round with recycled initial
        # batches, padding short batches to full size from the start
        pool = list(itertools.chain.from_iterable(initial))
        tail_count = cursor % self.num_processes
        if self.process_index < tail_count:
            batch = mine if mine is not None else []
        else:
            batch = []
        if batch_size is not None and len(batch) < batch_size and pool:
            need = batch_size - len(batch)
            offset = (self.process_index * batch_size) % max(len(pool), 1)
            filler = [pool[(offset + j) % len(pool)] for j in range(need)]
            batch = list(batch) + filler
        yield batch


class ShardedBatchIterable:
    """Shard a sized stream of ready-made batches across processes, the
    plain-iterable counterpart of `BatchSamplerShard`.

    - stride (default): batch i goes to process i % P. `even_batches=True`
      recycles initial batches and pads a short final batch up to the
      first batch's size, so every process yields the same number of
      equally shaped batches; a mid-stream batch of another size raises
      (its padding would corrupt `remainder`). With `even_batches=False`
      nothing pads and sizes may vary.
    - split (`split_batches=True`): every process takes its contiguous
      slice of every batch, so the global batch is the source's batch.

    After a full pass, `remainder` holds the real rows of the final global
    round (-1 if no row was duplicated), for `gather_for_metrics`.
    """

    def __init__(self, batches, num_processes: int, process_index: int,
                 even_batches: bool = True, split_batches: bool = False):
        self.batches = batches
        self.num_processes = num_processes
        self.process_index = process_index
        self.even_batches = even_batches
        self.split_batches = split_batches
        self.batch_size = getattr(batches, "batch_size", None)
        self.remainder = -1
        self.tail_layout = None

    def __len__(self) -> int:
        n = len(self.batches)  # type: ignore[arg-type]
        if self.split_batches:
            return n
        q, r = divmod(n, self.num_processes)
        if r == 0:
            return q
        if self.even_batches:
            return q + 1
        return q + (1 if self.process_index < r else 0)

    def __iter__(self):
        if self.split_batches:
            yield from self._iter_split_mode()
        else:
            yield from self._iter_stride_mode()

    def _iter_split_mode(self):
        """Each process slices rows [rank*B/P, (rank+1)*B/P) of every
        batch."""
        P, rank = self.num_processes, self.process_index
        n = len(self.batches)  # type: ignore[arg-type]
        self.remainder = -1
        self.tail_layout = None
        full_size = None
        for cursor, batch in enumerate(self.batches):
            size = _batch_size(batch)
            if full_size is None:
                if size is None or size % P != 0:
                    raise ValueError(
                        f"split_batches=True needs batch size divisible by "
                        f"{P} processes, got {size}"
                    )
                full_size = size
            if size is None:
                raise ValueError(
                    f"batch {cursor} has no measurable batch size (no array "
                    "leaves or row container); split_batches needs sized "
                    "batches"
                )
            if size > full_size:
                # slicing would silently drop rows beyond full_size
                raise ValueError(
                    f"batch {cursor} has {size} rows but the first batch had "
                    f"{full_size}; batches may not grow with split_batches"
                )
            if size < full_size:  # short tail: pad below, record true rows
                if cursor != n - 1:
                    raise ValueError(
                        "only the final batch may be short with split_batches"
                    )
                if not self.even_batches:
                    # B/P-row slices of a short batch would give processes
                    # different shapes in the same step
                    raise ValueError(
                        f"split_batches with even_batches=False cannot split "
                        f"a short final batch ({size} rows < {full_size}); "
                        "drop it or enable even_batches"
                    )
                self.remainder = size
            per = full_size // P
            true_rows = size

            # pad and slice in one pass, so every leaf is classified once,
            # against the batch's true (pre-pad) row count: a row container
            # wraparound-pads and slices whole; arrays pad and slice their
            # leading dim; structure is recursed into
            def _prepare(x):
                if _is_row_container(x, true_rows):
                    if len(x) != true_rows:
                        # a metadata container (a short label-name list):
                        # replicated untouched
                        return x
                    x = _wrap_pad_rows(x, full_size)
                    return x[rank * per : (rank + 1) * per]
                x = _to_numpy(x)
                if isinstance(x, np.ndarray) and x.ndim > 0:
                    if x.shape[0] != true_rows:
                        # an aux array (per-class weights): replicated
                        return x
                    x = _wrap_pad_rows(x, full_size)
                    return x[rank * per : (rank + 1) * per]
                return x  # strings, scalars and 0-d leaves replicate

            yield _tree_map(_prepare, batch,
                            is_leaf=lambda x: _is_row_container(x, true_rows))

    def _iter_stride_mode(self):
        P, rank = self.num_processes, self.process_index
        n = len(self.batches)  # type: ignore[arg-type]
        self.remainder = -1
        self.tail_layout = None
        tail = n % P
        # which batch (if any) this process recycles to complete the
        # final round
        recycle_idx = None
        if tail and self.even_batches and rank >= tail:
            recycle_idx = (rank - tail) % min(P, n)
        recycled = None
        full_size = None
        last_size = None
        for cursor, batch in enumerate(self.batches):
            size = _batch_size(batch)
            if full_size is None:
                full_size = size
            if cursor == n - 1:
                last_size = size
                if (
                    self.even_batches
                    and size is not None
                    and full_size is not None
                    and size > full_size
                ):
                    # padding only goes up: an oversized final batch would
                    # leave this process's final round bigger than its
                    # peers'
                    raise ValueError(
                        f"final batch has {size} rows but earlier batches had "
                        f"{full_size}; batches may not grow when "
                        "even_batches=True"
                    )
            elif (
                self.even_batches
                and size is not None
                and full_size is not None
                and size != full_size
            ):
                # the remainder bookkeeping assumes only the final batch
                # can be short: a padded mid-stream batch would leak filler
                # rows into gather_for_metrics as real samples
                raise ValueError(
                    f"batch {cursor} has {size} rows but the first batch had "
                    f"{full_size}; only the final batch may be short "
                    "when even_batches=True"
                )
            if cursor == recycle_idx:
                recycled = batch
            if cursor % P == rank:
                if self.even_batches:
                    batch = self._pad_to_full(batch, full_size)
                yield batch
        if recycled is not None:
            yield self._pad_to_full(recycled, full_size)
        # real rows of the final global round (batches n-t..n-1 land on
        # ranks 0..t-1, recycled duplicates after), so a gathered final
        # round cut to `[:remainder]` keeps exactly the real samples
        if self.even_batches and full_size is not None and last_size is not None:
            t = tail if tail else P
            if tail or last_size < full_size:
                if n >= P or tail:
                    self.remainder = (min(t, n) - 1) * full_size + last_size

    @staticmethod
    def _pad_to_full(batch, full_size):
        """A short batch padded up to the size of a full one."""
        if full_size is None:
            return batch
        size = _batch_size(batch)
        if size is not None and size < full_size:
            return pad_batch_to(batch, full_size, rows=size)
        return batch


class IterableDatasetShard:
    """Shard an iterable source of samples across processes: buffer
    `batch_size * num_processes` samples, then each process takes its
    slice."""

    def __init__(
        self,
        dataset: Iterable,
        batch_size: int = 1,
        num_processes: int = 1,
        process_index: int = 0,
        drop_last: bool = False,
        split_batches: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_processes = num_processes
        self.process_index = process_index
        self.drop_last = drop_last
        self.split_batches = split_batches

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self) -> Iterator:
        real_batch_size = (
            self.batch_size
            if self.split_batches
            else self.batch_size * self.num_processes
        )
        slice_width = real_batch_size // self.num_processes
        my_range = range(
            self.process_index * slice_width,
            (self.process_index + 1) * slice_width
        )
        buffer: list = []
        first_loop_items: list = []
        for element in self.dataset:
            buffer.append(element)
            if len(first_loop_items) < real_batch_size:
                first_loop_items.append(element)
            if len(buffer) == real_batch_size:
                for i in my_range:
                    yield buffer[i]
                buffer = []
        if not self.drop_last and buffer:
            while len(buffer) < real_batch_size:
                buffer += first_loop_items[: real_batch_size - len(buffer)]
            for i in my_range:
                yield buffer[i]


def pad_batch_to(batch: Any, target: int, rows: int | None = None) -> Any:
    """Wraparound-pad every leaf's leading dim to `target` rows. Row
    containers (see `_is_row_container`) wraparound-extend too, so a
    short tail never leaves one process with fewer rows than its peers.
    `rows` is the batch's current row count (it tells equal-length 1-D
    lists apart)."""

    def _pad(x):
        if _is_row_container(x, rows):
            if rows is None:
                # unknown row count: containers stay untouched (recursing
                # would pad ragged token rows along the token dimension)
                return x
            # only a container with one entry per row is row data; a short
            # metadata list replicates untouched
            return _wrap_pad_rows(x, target) if len(x) == rows else x
        x = _to_numpy(x)
        if (
            rows is not None
            and isinstance(x, np.ndarray)
            and x.ndim > 0
            and x.shape[0] != rows
        ):
            return x  # an aux array (per-class weights): not batch rows
        return _wrap_pad_rows(x, target)

    return _tree_map(_pad, batch, is_leaf=lambda x: _is_row_container(x, rows))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


class _PrefetchIterator:
    """A host thread that prepares a bounded number of batches ahead. It
    runs host work only: no CUDA call, no pinning."""

    def __init__(self, source_iter: Iterator, prepare: Callable, depth: int):
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error: BaseException | None = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in source_iter:
                    payload = prepare(item)
                    if not self._put(payload):
                        return      # the consumer closed mid-epoch
            except BaseException as e:  # raised on the consumer's side
                self._error = e
            finally:
                self._put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that `close()` can always unpark: an abandoned
        iterator must not leave the worker blocked on a full queue."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread and reap it. Idempotent; safe with the source
        only partly consumed."""
        self._stop.set()
        while True:     # drain, so a parked worker sees the stop promptly
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


class DevicePrefetchIterator:
    """Keep up to `depth` batches' host-to-device copies in flight ahead
    of the consumer (the device half of the input double buffer).

    `place` issues the copy (for a prepared loader: pinned host memory to
    the card, `non_blocking`). With a CUDA `device` it runs on a side
    stream and an event is recorded after it, one per batch; when the
    batch is handed out, the consumer's current stream waits on that
    event (so the step never reads a half-copied batch) and each of the
    batch's tensors is `record_stream`-ed onto the consumer's stream (so
    the caching allocator does not reuse its memory for a later batch
    while the step still reads it). Because a prepared loader looks one
    batch ahead, the consumer waits on batch i+1's copy before step i's
    work; that copy was issued `depth` batches earlier and has finished
    by then. Without a CUDA device `place` just runs.

    `depth` is floored to 1: this class is the buffer. To issue each copy
    at hand-out instead, use `DataLoaderConfiguration(
    device_prefetch_depth=0)`, which bypasses this iterator.
    """

    def __init__(self, source: Iterable, place: Callable, depth: int = 2,
                 device=None):
        self._source = iter(source)
        self._place = place
        self._depth = max(1, int(depth))
        self._buffer: collections.deque = collections.deque()
        self._exhausted = False
        device = None if device is None else torch.device(device)
        self._stream = (torch.cuda.Stream(device)
                        if device is not None and device.type == "cuda"
                        else None)

    def __iter__(self):
        return self

    def _fill(self) -> None:
        while not self._exhausted and len(self._buffer) < self._depth:
            try:
                item = next(self._source)
            except StopIteration:
                self._exhausted = True
                return
            # the span covers the copy's issue: on the trace timeline it
            # should take microseconds (no-op when tracing is off)
            with span("data.prefetch_place"):
                if self._stream is None:
                    self._buffer.append((self._place(item), None))
                    continue
                with torch.cuda.stream(self._stream):
                    placed = self._place(item)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._buffer.append((placed, event))

    def __next__(self):
        self._fill()
        if not self._buffer:
            raise StopIteration
        item, event = self._buffer.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(event)
            for t in tree_leaves(item):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(consumer)
        # issue the next copy before handing this batch out, so it is in
        # flight for the whole of the consumer's step
        self._fill()
        return item


class DataLoaderStateMixin:
    """`end_of_dataloader` / `remainder` bookkeeping hooked into
    `GradientState`."""

    def begin(self) -> None:
        self.end_of_dataloader = False
        self.remainder = -1
        self.tail_layout = None  # (processes, padded per process, real)
        self.gradient_state._add_dataloader(self)

    def end(self) -> None:
        self.gradient_state._remove_dataloader(self)


def _check_mesh(mesh, what: str) -> None:
    """A loader's mesh is the port's `ProcessMesh` (or None)."""
    if mesh is not None and not isinstance(mesh, ProcessMesh):
        raise TypeError(
            f"{what}(mesh=...) takes the port's mesh "
            "(Accelerator.mesh or AcceleratorState().mesh, a "
            f"state.ProcessMesh), got {type(mesh).__name__}")


class DataLoaderShard(DataLoaderStateMixin):
    """Iterate this process's batches on its device.

    - one-batch-ahead detection of the final batch, so
      `end_of_dataloader` is true during the last step;
    - an uneven final batch padded by wraparound (never on one card), its
      real rows in `remainder` for `gather_for_metrics`;
    - `rng_types` synchronised at each `__iter__`;
    - host prep on a background thread (`prefetch_size` batches ahead)
      and up to `device_prefetch_depth` batches' copies in flight on a
      side stream (`DevicePrefetchIterator`); with depth 0 each copy is
      issued as its batch is handed out.

    `device` is where batches land (default: the process's device);
    `put_on_device=False` hands out the host batches as numpy. `mesh` is
    the port's `ProcessMesh` (default: one device a process).
    """

    def __init__(
        self,
        loader: Iterable,
        mesh=None,
        batch_axes=BATCH_AXES,
        rng_types: list | None = None,
        put_on_device: bool = True,
        prefetch_size: int = 2,
        even_batches: bool = True,
        generator=None,
        device_prefetch_depth: int = 2,
        device=None,
    ):
        _check_mesh(mesh, "DataLoaderShard")
        self.loader = loader
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.rng_types = rng_types
        self.put_on_device = put_on_device
        self.prefetch_size = prefetch_size
        self.even_batches = even_batches
        self.generator = generator
        self.device_prefetch_depth = device_prefetch_depth
        self.device = None if device is None else torch.device(device)
        self.gradient_state = GradientState()
        self.epoch = 0

    @property
    def total_batch_size(self) -> int | None:
        bs = getattr(self.loader, "batch_size", None)
        if bs is None:
            sampler = getattr(self.loader, "batch_sampler", None)
            bs = getattr(sampler, "batch_size", None)
        return bs

    @property
    def dp_size(self) -> int:
        """Data-parallel devices: the mesh's batch axes, else one device a
        process of the batch line (`state.data_line`)."""
        if self.mesh is not None:
            size = 1
            for axis in self.batch_axes:
                size *= self.mesh.shape.get(axis, 1)
            return size
        return data_line().size

    def _device(self) -> torch.device:
        return self.device if self.device is not None else \
            PartialState().device

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for obj in (self.loader, getattr(self.loader, "sampler", None),
                    getattr(self.loader, "batch_sampler", None)):
            if obj is not None and hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)

    def _prepare_host(self, batch):
        """The host half of a batch's prep (on the prefetch thread): numpy
        conversion, tail padding and remainder bookkeeping. No device work
        happens here: the copy is issued by the consumer-side
        `DevicePrefetchIterator`, so its depth bounds the batches held on
        the card."""
        with span("data.host_prep"):
            # tensors already on a card stay there when they are about to
            # be placed anyway; pad_batch_to converts the rare uneven tail
            batch = batch_to_numpy(
                batch, keep_device_arrays=self.put_on_device)
            n = _batch_size(batch)
            # the processes that split the global batch: its batch line
            processes = data_line(self.mesh).size
            per_host = max(self.dp_size // processes, 1)
            remainder = -1
            tail_layout = None
            if (
                self.even_batches
                and self.put_on_device
                and n is not None
                and n % per_host != 0
            ):
                target = math.ceil(n / per_host) * per_host
                # every process sees the same (n, target): the real count
                # is n * processes, laid out after a gather as [proc 0: n
                # real + pad, proc 1: ...] for gather_for_metrics
                remainder = n * processes
                tail_layout = (processes, target, n)
                batch = pad_batch_to(batch, target, rows=n)
            return batch, remainder, tail_layout

    def _place(self, item, device=None):
        """The device half: issue the copy of every leaf to the card."""
        batch, remainder, tail_layout = item
        with span("data.device_put"):
            placed = to_device(
                batch, self._device() if device is None else device,
                non_blocking=True)
        return placed, remainder, tail_layout

    def __iter__(self):
        if self.rng_types is not None:
            synchronize_rng_states(self.rng_types, self.generator)
        self.begin()
        prefetch = None
        try:
            source = iter(self.loader)
            prefetch = prepared = _PrefetchIterator(
                source, self._prepare_host, self.prefetch_size
            )
            if self.put_on_device:
                device = self._device()
                place = lambda item: self._place(item, device)  # noqa: E731
                if self.device_prefetch_depth > 0:
                    prepared = DevicePrefetchIterator(
                        prepared, place, self.device_prefetch_depth, device
                    )
                else:
                    prepared = map(place, prepared)
            current = next(prepared, _SENTINEL)
            while current is not _SENTINEL:
                nxt = next(prepared, _SENTINEL)
                batch, remainder, tail_layout = current
                if nxt is _SENTINEL:
                    self.end_of_dataloader = True
                    loader_rem = getattr(self.loader, "remainder", -1)
                    if remainder == -1:
                        # a sharding iterable below may have padded or
                        # duplicated the final round itself
                        remainder = loader_rem
                        tail_layout = getattr(self.loader, "tail_layout", None)
                    elif loader_rem != -1:
                        # both layers padded: the tail metadata cannot say
                        # so, and gather_for_metrics cannot drop the
                        # process-level duplicates of this round
                        logger.warning(
                            "final batch was padded at both the "
                            "process-sharding and device-sharding layers; "
                            "gather_for_metrics cannot drop process-level "
                            "duplicates. Use a batch size divisible by the "
                            "per-process device count for exact eval counts."
                        )
                    if remainder != -1:
                        self.remainder = remainder
                        self.tail_layout = tail_layout
                yield batch
                current = nxt
            self.set_epoch(self.epoch + 1)
        finally:
            # a loop that breaks early must still reap the prefetch thread
            # and leave GradientState: a stale reference would corrupt
            # accumulate()'s sync decisions
            if prefetch is not None:
                prefetch.close()
            self.end()

    def __len__(self) -> int:
        return len(self.loader)  # type: ignore[arg-type]


class DataLoaderDispatcher(DataLoaderStateMixin):
    """Process 0 reads the iterable and broadcasts each batch; every
    process takes its slice. For streams that cannot be sharded at the
    source. With one process the broadcast is the identity."""

    def __init__(
        self,
        loader: Iterable,
        mesh=None,
        batch_axes=BATCH_AXES,
        split_batches: bool = False,
        put_on_device: bool = True,
        device=None,
    ):
        _check_mesh(mesh, "DataLoaderDispatcher")
        self.loader = loader
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.split_batches = split_batches
        self.put_on_device = put_on_device
        self.device = None if device is None else torch.device(device)
        self.gradient_state = GradientState()
        self.state = PartialState(
            cpu=self.device is not None and self.device.type == "cpu")
        self.epoch = 0

    def _fetch_and_broadcast(self, source) -> tuple[Any, bool]:
        """Process 0 takes the next batch(es); every process learns
        (batch, stop). With `split_batches=False` process 0 fetches one
        batch per process and concatenates them, so each still sees a
        full batch; with True one batch is split."""
        from .utils.operations import broadcast_object_list, concatenate

        if self.state.is_main_process:
            fetches = 1 if self.split_batches else \
                data_line(self.mesh, self.state).size
            parts = []
            for _ in range(fetches):
                batch = next(source, _SENTINEL)
                if batch is _SENTINEL:
                    break
                parts.append(batch_to_numpy(batch))
            if not parts:
                payload = [None, True]
            else:
                merged = parts[0] if len(parts) == 1 else concatenate(parts)
                payload = [merged, False]
        else:
            payload = [None, None]
        if self.state.num_processes > 1:
            payload = broadcast_object_list(payload, from_process=0)
        return payload[0], payload[1]

    def __iter__(self):
        self.begin()
        try:
            source = iter(self.loader) if self.state.is_main_process \
                else iter(())
            current, stop = self._fetch_and_broadcast(source)
            while not stop:
                nxt, stop = self._fetch_and_broadcast(source)
                n = _batch_size(current)
                # the batch line splits the global batch; the ranks of a
                # `stage`, `seq` or `expert` line take the same slice
                line = data_line(self.mesh, self.state)
                P = line.size
                remainder = -1
                if n is not None and n % P != 0:
                    # pad to divisible (wraparound) rather than drop the
                    # tail; the dispatcher pads at the global tail, so a
                    # plain [:n] cut of the gathered rows is right
                    target = math.ceil(n / P) * P
                    current = pad_batch_to(current, target, rows=n)
                    remainder = n
                    n = target
                # this process's slice of the global batch: arrays and row
                # containers with one entry per row slice; aux leaves
                # (short metadata lists, per-class weights) replicate
                per_host = n // P if n else None
                if per_host is not None and P > 1:
                    start = line.index * per_host
                    sl = slice(start, start + per_host)
                    rows_now = n

                    def _shard(x):
                        if _is_row_container(x, rows_now):
                            return x[sl] if len(x) == rows_now else x
                        if getattr(x, "ndim", 0) and x.shape[0] == rows_now:
                            return x[sl]
                        return x

                    local = _tree_map(
                        _shard, current,
                        is_leaf=lambda v: _is_row_container(v, rows_now),
                    )
                else:
                    local = current
                if stop:
                    self.end_of_dataloader = True
                    if remainder != -1:
                        self.remainder = remainder
                if self.put_on_device:
                    local = to_device(
                        local, self.state.device if self.device is None
                        else self.device, non_blocking=True)
                yield local
                current = nxt
        finally:
            self.end()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)  # type: ignore[arg-type]


class SkipDataLoader:
    """Iterate `loader`, skipping its first `skip_batches` batches."""

    def __init__(self, loader: Iterable, skip_batches: int = 0):
        self.loader = loader
        self.skip_batches = skip_batches

    def __iter__(self):
        for index, batch in enumerate(self.loader):
            if index >= self.skip_batches:
                yield batch

    def __len__(self) -> int:
        return max(len(self.loader) - self.skip_batches, 0)


def skip_first_batches(dataloader, num_batches: int = 0):
    """Resume in the middle of a pass: a prepared loader comes back as a
    copy over its source with the first `num_batches` skipped (so the
    prefetch and placement still apply); any other iterable is wrapped."""
    if isinstance(dataloader, (DataLoaderShard, DataLoaderDispatcher)):
        clone = copy.copy(dataloader)
        clone.loader = SkipDataLoader(dataloader.loader, num_batches)
        return clone
    return SkipDataLoader(dataloader, num_batches)


# ---------------------------------------------------------------------------
# prepare_data_loader
# ---------------------------------------------------------------------------


def _looks_like_torch_loader(obj) -> bool:
    return (
        hasattr(obj, "dataset")
        and hasattr(obj, "batch_sampler")
        or type(obj).__name__ == "DataLoader"
    )


def prepare_data_loader(
    dataloader,
    device=None,
    num_processes: int | None = None,
    process_index: int | None = None,
    split_batches: bool = False,
    put_on_device: bool = True,
    rng_types: list | None = None,
    dispatch_batches: bool | None = None,
    even_batches: bool = True,
    use_seedable_sampler: bool = True,
    mesh=None,
    batch_axes=BATCH_AXES,
    config: DataLoaderConfiguration | None = None,
    prefetch_size: int | None = None,
    device_prefetch_depth: int | None = None,
):
    """Shard any batch iterable across the processes of the batch line
    (`state.data_line` of `mesh`, else of the process state's mesh: the
    world on a mesh of `data` alone) and hand its batches out on
    `device` (default: the process's device).

    Takes a torch `DataLoader` (rebuilt around a `BatchSamplerShard` over
    its dataset), an unsized iterable (`IterableDatasetShard`), a sized
    stream of batches (`ShardedBatchIterable`), or a source that shards
    itself (`is_host_sharded`, e.g. `native.TokenCorpusLoader`), which
    passes through untouched. With one process every source passes
    through.

    An explicit `prefetch_size`/`device_prefetch_depth` wins over
    `config`; None takes the config's (or its defaults). The prefetch
    knobs apply to the sharded path only: the dispatcher
    (`dispatch_batches=True`) fetches in step with the loop.
    """
    explicit_prefetch = (prefetch_size, device_prefetch_depth) != (None, None)
    if config is not None:
        split_batches = config.split_batches
        dispatch_batches = config.dispatch_batches
        even_batches = config.even_batches
        use_seedable_sampler = config.use_seedable_sampler
    if prefetch_size is None:
        prefetch_size = config.prefetch_size if config is not None else 2
    if device_prefetch_depth is None:
        device_prefetch_depth = (
            config.device_prefetch_depth if config is not None else 2
        )
    # the batch line's shard: the ranks of one `stage`, `seq` or `expert`
    # line see the same rows (the reference shards over `data`/`fsdp`)
    line = data_line(mesh)
    if num_processes is None:
        num_processes = line.size
    if process_index is None:
        process_index = line.index

    if dispatch_batches:
        if explicit_prefetch:
            warnings.warn(
                "prefetch_size/device_prefetch_depth have no effect with "
                "dispatch_batches=True: the dispatcher is broadcast-driven "
                "and fetches in lockstep with the step loop.",
                stacklevel=2,
            )
        return DataLoaderDispatcher(
            dataloader,
            mesh=mesh,
            batch_axes=batch_axes,
            split_batches=split_batches,
            put_on_device=put_on_device,
            device=device,
        )

    loader = dataloader
    if num_processes > 1 and _looks_like_torch_loader(dataloader):
        loader = _reshard_torch_loader(
            dataloader, num_processes, process_index, split_batches,
            even_batches, use_seedable_sampler,
        )
    elif num_processes > 1 and hasattr(dataloader, "__iter__") and \
            not hasattr(dataloader, "__len__"):
        loader = IterableDatasetShard(
            dataloader,
            batch_size=getattr(dataloader, "batch_size", 1) or 1,
            num_processes=num_processes,
            process_index=process_index,
            split_batches=split_batches,
        )
    elif num_processes > 1 and not getattr(dataloader, "is_host_sharded",
                                           False):
        # a sized stream of ready-made batches: stride whole batches
        # across processes, or slice each batch with split_batches
        loader = ShardedBatchIterable(
            dataloader, num_processes, process_index,
            even_batches=even_batches, split_batches=split_batches,
        )

    return DataLoaderShard(
        loader,
        mesh=mesh,
        batch_axes=batch_axes,
        rng_types=rng_types,
        put_on_device=put_on_device,
        even_batches=even_batches,
        prefetch_size=prefetch_size,
        device_prefetch_depth=device_prefetch_depth,
        device=device,
    )


def _reshard_torch_loader(
    dataloader, num_processes, process_index, split_batches, even_batches,
    use_seedable_sampler,
):
    """Rebuild a torch DataLoader over a process-sharded batch sampler,
    keeping its collate_fn and num_workers."""
    import torch.utils.data as tud

    batch_sampler = dataloader.batch_sampler
    if use_seedable_sampler and isinstance(
        getattr(dataloader, "sampler", None), tud.RandomSampler
    ):
        sampler = SeedableRandomSampler(len(dataloader.dataset))
        batch_sampler = tud.BatchSampler(
            sampler, batch_sampler.batch_size, batch_sampler.drop_last
        )
    sharded = BatchSamplerShard(
        batch_sampler,
        num_processes=num_processes,
        process_index=process_index,
        split_batches=split_batches,
        even_batches=even_batches,
    )
    return tud.DataLoader(
        dataloader.dataset,
        batch_sampler=sharded,
        collate_fn=dataloader.collate_fn,
        num_workers=dataloader.num_workers,
        pin_memory=False,
    )
