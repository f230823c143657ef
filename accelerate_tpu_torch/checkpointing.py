"""Checkpoint save and load (port of `accelerate_tpu/checkpointing.py`).

What a checkpoint holds is the reference's: each train state's `step`,
`params`, `opt_state` and loss scale; each eager optimizer's
(`AcceleratedOptimizer`) `opt_state` and `params` in
`optimizer_{i}.safetensors`; the schedulers' and dataloaders' pickles (`scheduler_{i}.bin`, `sampler_{i}.bin` with the epoch);
`custom_checkpoint_{i}.pkl` for registered objects;
`accelerator_state.json`; and the host RNG streams in
`random_states_0.pkl` (keys `python`, `numpy`, `torch`). Where the
reference writes each array payload as an orbax directory (`model_0/`),
the port writes one safetensors file (`model_0.safetensors`) through its
own reader and writer (`utils/safetensors.py`), keyed by the payload's
`flatten_dict` paths (`params.embed`, `opt_state.mu.embed`, `step`).
A train state's fp8 metas ride the save as `model_0_fp8.safetensors`
(`fp8_state.layers.attn.q_proj.x.scale`, ...) beside the reference's
sidecar `model_0_fp8.json` with the amax window's length; a restore
adapts a window of another length to the live one.

The commit protocol is the reference's (`utils/manifest.py`): a directory
is a checkpoint only once `checkpoint.manifest.json` is renamed into
place, strictly after every file it lists is written and fsynced. (An
async save with no train state has nothing in flight and commits at
once: a later prune may delete it, and a sealed commit would then publish
into a deleted directory.)

Async saves. The port's train step updates the state's tensors in place,
so an async save first takes a host copy of every tensor (the *stage*,
in-loop): on CUDA a copy on the compute stream into pinned host buffers,
which the host waits for, so the copy is ordered after the step that made
the values and before any later step's writes. The buffers persist from
save to save (pinning takes time), and one staged copy is in flight at
most: a save waits out the previous write before it reuses them, and
that wait is timed as part of its stage. One writer thread then writes
the files from host memory only, in submission order; its commits
publish once their bytes are durable (after its own write, or at
`wait_for_checkpoints`). A failed write re-raises at
`wait_for_checkpoints`, drops the sealed commits and tears the writer
down; no later write publishes after it.

`save_model`/`load_model` export and import weights alone as
(index-sharded) safetensors, which the JAX package's `load_model` and
the `safetensors` package read.

Across processes the replicas are identical, so the main process
writes the replicated state (tensors, schedulers, samplers, custom
objects, `accelerator_state.json`) and commits the manifest; each
process writes its own host RNG streams (`random_states_{i}.pkl`), and
a barrier ends every save, so no process moves on before every file but
the main process's async writes exists. A load first drains this
process's async writes and meets the others at a barrier, then every
process reads the replicated files and its own RNG streams. A
checkpoint written by one process loads as before.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import pickle
import random as _py_random
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _wait_all
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .state import PartialState
from .ops.fp8 import adapt_history_len, fp8_state_history_len
from .telemetry.lockwatch import maybe_tracked
from .telemetry.registry import get_registry
from .telemetry.trace import span
from .utils import safetensors as st
from .utils.constants import (
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    SAMPLER_NAME,
    SCHEDULER_NAME,
)
from .utils.manifest import (
    MANIFEST_NAME,
    is_complete,
    latest_complete,
    prune_complete,
    read_manifest,
    write_manifest,
)
from .utils.other import flatten_dict, unflatten_dict

__all__ = [
    "MANIFEST_NAME",
    "save_accelerator_state",
    "load_accelerator_state",
    "wait_for_checkpoints",
    "warm_async_checkpointer",
    "is_complete_checkpoint",
    "latest_complete_checkpoint",
    "resume_latest",
    "prune_checkpoints",
    "sealing_checkpoint_dirs",
    "shard_checkpoint",
    "save_model",
    "load_model",
]

logger = logging.getLogger(__name__)


def _barrier() -> None:
    """Wait for every process of the world (none with one)."""
    if PartialState.num_processes > 1:
        torch.distributed.barrier()


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


# ---------------------------------------------------------------------------
# manifest commit protocol: a checkpoint directory is loadable iff its
# manifest committed — written-then-renamed strictly after the bytes it
# lists are durable, so a crash at any byte offset leaves either a complete
# checkpoint or an ignorable partial one, never a torn restore.
# ---------------------------------------------------------------------------


class _PendingCommit:
    """One staged-but-unpublished checkpoint: the handle
    `_SnapshotStager.stage` returns and `commit`/`rollback` consume.
    `add` registers files the manifest will list."""

    __slots__ = ("directory", "step", "files")

    def __init__(self, directory: str, step: int):
        self.directory = directory
        self.step = int(step)
        self.files: set[str] = set()

    def add(self, *names: str) -> None:
        self.files.update(names)


class _SnapshotStager:
    """Bookkeeping for the commit protocol. `stage` opens a pending
    commit; `commit(pending)` publishes the manifest — immediately when
    the writes were synchronous, else the pending parks on the sealed
    list until the writer proves durability (`flush_ready`); `rollback`
    abandons it, leaving an incomplete directory resume will skip. The
    sealed list is shared with the writer thread, hence the lock. A
    commit taken off it to be published stays in `_publishing` until
    its manifest is on disk, so `sealed_dirs` lists it the whole time
    and retention never deletes a directory whose manifest is being
    written."""

    def __init__(self):
        self._lock = maybe_tracked("checkpoint-commit")
        self._sealed: list[_PendingCommit] = []
        self._publishing: list[_PendingCommit] = []

    def stage(self, output_dir: str, step: int) -> _PendingCommit:
        return _PendingCommit(_abspath(output_dir), step)

    def commit(self, pending: _PendingCommit, *, deferred: bool = False) -> None:
        if not deferred:
            self._publish(pending)
            return
        with self._lock:
            self._sealed.append(pending)

    def rollback(self, pending: _PendingCommit) -> None:
        with self._lock:
            if pending in self._sealed:
                self._sealed.remove(pending)
        get_registry().counter("checkpoint_rollbacks_total").inc()

    def flush_ready(self) -> int:
        """Publish every sealed manifest. Call ONLY where the sealed
        saves' bytes are proven durable: after the writer finished every
        job, or at the end of a writer job (a save is sealed only after
        its stage, and a stage waits out every earlier write, so a sealed
        save's bytes are the ones this job just wrote, or older)."""
        with self._lock:
            ready, self._sealed = self._sealed, []
            self._publishing.extend(ready)
        try:
            for pending in ready:
                self._publish(pending)
        finally:
            with self._lock:
                for pending in ready:
                    self._publishing.remove(pending)
        return len(ready)

    def drop_sealed(self) -> int:
        """Abandon sealed-but-unpublished commits (failed drain): their
        directories stay incomplete and resume skips them."""
        with self._lock:
            dropped, self._sealed = self._sealed, []
        if dropped:
            get_registry().counter(
                "checkpoint_rollbacks_total").inc(len(dropped))
        return len(dropped)

    def sealed_dirs(self) -> list[str]:
        """Directories of the sealed commits and of those whose manifests
        are being published."""
        with self._lock:
            return [p.directory for p in self._sealed + self._publishing]

    def _publish(self, pending: _PendingCommit) -> None:
        write_manifest(pending.directory, step=pending.step,
                       files=pending.files)
        get_registry().counter("checkpoint_commits_total").inc()


_stager = _SnapshotStager()


class _AsyncWriter:
    """The one background writer (the reference's serializing orbax
    AsyncCheckpointer and its enqueue thread): a single thread, so
    submission order is write order, and the host staging buffers the
    jobs write from."""

    def __init__(self):
        self._executor: ThreadPoolExecutor | None = None
        self._futures: list = []
        self._staging: dict = {}
        self._error: BaseException | None = None

    @property
    def inflight(self) -> int:
        return len(self._futures)

    def executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        return self._executor

    def stage(self, payloads: dict[str, dict[str, Any]]) -> dict:
        """{path: {key: host copy}} of {path: {key: tensor}}, taken into
        the persistent buffers once the previous write is done with them.
        CUDA tensors go to pinned buffers by copies on the current stream,
        which the host waits for."""
        _wait_all(self._futures)
        staging, staged, streams = {}, {}, set()
        for path, flat in payloads.items():
            out = {}
            for key, t in flat.items():
                slot = (os.path.basename(path), key)
                buf = self._staging.get(slot)
                if buf is None or buf.shape != t.shape or \
                        buf.dtype != t.dtype or buf.is_pinned() != t.is_cuda:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=t.is_cuda)
                with torch.no_grad():
                    buf.copy_(t.detach(), non_blocking=t.is_cuda)
                if t.is_cuda:
                    streams.add(torch.cuda.current_stream(t.device))
                staging[slot] = out[key] = buf
            staged[path] = out
        for stream in streams:
            stream.synchronize()
        self._staging = staging
        return staged

    def submit(self, staged: dict) -> None:
        self._futures.append(self.executor().submit(self._write, staged))

    def _write(self, staged: dict) -> None:
        if self._error is not None:
            return      # an earlier write failed: nothing after it publishes
        try:
            _write_files(staged)
        except BaseException as exc:
            self._error = exc
            raise
        _stager.flush_ready()

    def drain(self) -> None:
        """Wait for every job; the first failure re-raises after the
        writer is torn down."""
        futures, self._futures = self._futures, []
        _wait_all(futures)
        for fut in futures:
            if fut.exception() is not None:
                self.close()
                raise fut.exception()

    def close(self) -> None:
        executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)
        self._futures = []
        self._staging = {}
        self._error = None


_writer = _AsyncWriter()
atexit.register(_writer.close)


def warm_async_checkpointer() -> None:
    """Start the writer thread outside any measured window. Idempotent;
    the first async save does it otherwise. (The pinned staging buffers
    take the shapes of the first save, so that save allocates them.)"""
    _writer.executor()


def wait_for_checkpoints() -> int:
    """Block until every in-flight async save has committed. Returns how
    many were drained. A failed background write re-raises here after the
    writer is torn down and the sealed commits are dropped, so resume
    falls back to the previous complete commit and later saves start from
    a clean slate."""
    drained = _writer.inflight
    if drained == 0:
        _stager.flush_ready()
        return 0
    t0 = time.perf_counter()
    with span("checkpoint.drain"):
        try:
            _writer.drain()
        except BaseException:
            _stager.drop_sealed()
            raise
    get_registry().histogram("checkpoint_drain_seconds").record(
        time.perf_counter() - t0)
    _stager.flush_ready()
    return drained


def _train_state_payload(ts) -> dict:
    payload = {"step": ts.step, "params": ts.params, "opt_state": ts.opt_state}
    if ts.loss_scale is not None:
        payload["loss_scale"] = {
            "scale": ts.loss_scale.scale,
            "growth_tracker": ts.loss_scale.growth_tracker,
        }
    return payload


def _flat_tensors(payload: dict) -> dict[str, Any]:
    """The payload's leaves by flattened key; the host int `step` as an
    int64 scalar, None leaves (an optimizer with no state) left out."""
    flat = {}
    for key, leaf in flatten_dict(payload).items():
        if leaf is None:
            continue
        if isinstance(leaf, int):
            leaf = torch.tensor(leaf, dtype=torch.int64)
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"checkpoint leaf {key!r} is a "
                            f"{type(leaf).__name__}, not a tensor")
        flat[key] = leaf
    return flat


def _write_files(staged: dict) -> None:
    """Write and fsync each staged payload's file (on the writer thread
    for an async save); `checkpoint_write_seconds` times it."""
    t0 = time.perf_counter()
    with span("checkpoint.write"):
        for path, flat in staged.items():
            st.save_file(flat, path)
    get_registry().histogram("checkpoint_write_seconds").record(
        time.perf_counter() - t0)


def _save_payloads(payloads: dict[str, dict], async_save: bool) -> None:
    flats = {path: _flat_tensors(p) for path, p in payloads.items()}
    if not async_save:
        _write_files(_writer.stage(flats))
        return
    t0 = time.perf_counter()
    with span("checkpoint.stage"):
        staged = _writer.stage(flats)
    get_registry().histogram("checkpoint_stage_seconds").record(
        time.perf_counter() - t0)
    _writer.submit(staged)


def save_accelerator_state(
    output_dir: str,
    train_states: list = (),
    optimizers: list = (),
    schedulers: list = (),
    dataloaders: list = (),
    custom_objects: list = (),
    step: int = 0,
    async_save: bool = False,
) -> str:
    """Write a checkpoint into `output_dir` and commit it. With
    `async_save=True` the file writes overlap later steps; call
    `wait_for_checkpoints()` (or `load`) before relying on the files."""
    t0 = time.perf_counter()
    with span("checkpoint.save"):
        out = _save_accelerator_state(
            output_dir, train_states, optimizers, schedulers, dataloaders,
            custom_objects, step, async_save,
        )
    reg = get_registry()
    reg.counter("checkpoint_saves_total").inc()
    # async saves time the stage and enqueue here; the commit drains in
    # wait_for_checkpoints (its own series)
    reg.histogram("checkpoint_save_seconds").record(time.perf_counter() - t0)
    return out


def _optimizer_payload(opt) -> dict:
    """An eager optimizer's live tensors: its state and the params it
    updates (the eager path's weights live on the optimizer)."""
    return {k: v for k, v in (("opt_state", opt.opt_state),
                              ("params", opt.params)) if v is not None}


def _optimizer_file(input_dir: str, i: int) -> str:
    """The path of eager optimizer `i`'s tensors, raising where the
    checkpoint holds none for it (an optimizer left at its initial state
    would train on from fresh weights)."""
    path = os.path.join(input_dir, f"{OPTIMIZER_NAME}_{i}.safetensors")
    if os.path.exists(path):
        return path
    if os.path.isdir(os.path.join(input_dir, f"{OPTIMIZER_NAME}_{i}")):
        raise ValueError(
            f"{input_dir}: optimizer {i} is saved as orbax arrays "
            f"({OPTIMIZER_NAME}_{i}/, the JAX package's layout); the port "
            "reads no orbax arrays")
    raise FileNotFoundError(
        f"{path}: the checkpoint holds no state for prepared optimizer {i}")


def _save_accelerator_state(output_dir, train_states, optimizers,
                            schedulers, dataloaders, custom_objects, step,
                            async_save) -> str:
    output_dir = _abspath(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    main = PartialState.is_main_process
    rank = PartialState.process_index
    pending = _stager.stage(output_dir, step)
    payloads, small = {}, {}
    try:
        for i, ts in enumerate(train_states if main else ()):
            name = f"{MODEL_NAME}_{i}.safetensors"
            payloads[os.path.join(output_dir, name)] = \
                _train_state_payload(ts)
            pending.add(name)
            if ts.fp8_state is not None:
                # a file of its own and the window's length beside it, so
                # a restore can read a window of another length
                name = f"{MODEL_NAME}_{i}_fp8.safetensors"
                payloads[os.path.join(output_dir, name)] = {
                    "fp8_state": ts.fp8_state}
                pending.add(name)
                small[f"{MODEL_NAME}_{i}_fp8.json"] = json.dumps({
                    "amax_history_len":
                        fp8_state_history_len(ts.fp8_state)}).encode()
        for i, opt in enumerate(optimizers if main else ()):
            payload = _optimizer_payload(opt)
            if payload:
                name = f"{OPTIMIZER_NAME}_{i}.safetensors"
                payloads[os.path.join(output_dir, name)] = payload
                pending.add(name)
        if payloads:
            _save_payloads(payloads, async_save)

        for i, sched in enumerate(schedulers if main else ()):
            small[f"{SCHEDULER_NAME}_{i}.bin"] = pickle.dumps(
                sched.state_dict())
        for i, loader in enumerate(dataloaders if main else ()):
            small[f"{SAMPLER_NAME}_{i}.bin"] = pickle.dumps(
                {"epoch": getattr(loader, "epoch", 0)})
        for i, obj in enumerate(custom_objects if main else ()):
            small[f"custom_checkpoint_{i}.pkl"] = pickle.dumps(
                obj.state_dict())
        if main:
            small["accelerator_state.json"] = json.dumps(
                {"step": step}).encode()
        # this process's host RNG streams; the model's randomness is
        # explicit (seeds and generators), as in the reference
        small[f"{RNG_STATE_NAME}_{rank}.pkl"] = pickle.dumps({
            "python": _py_random.getstate(),
            "numpy": np.random.get_state(),
            "torch": torch.get_rng_state(),
        })
        for name, data in small.items():
            with open(os.path.join(output_dir, name), "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            # the manifest lists rank 0's RNG streams, the one file every
            # resuming process can count on
            if main and not name.startswith(RNG_STATE_NAME) or \
                    name == f"{RNG_STATE_NAME}_0.pkl":
                pending.add(name)
        _barrier()
    except BaseException:
        # abandon the commit: the directory stays manifest-less and
        # resume_latest falls back to the previous complete checkpoint
        _stager.rollback(pending)
        raise
    if not main:
        # the main process commits the directory
        return output_dir
    # a save with no array payload has nothing in flight: it commits now
    _stager.commit(pending, deferred=async_save and bool(payloads))
    return output_dir


def _check_file(path: str, live: dict) -> None:
    """The file must hold exactly `live`'s keys, each with its dtype and
    shape."""
    header, _ = st.read_header(path)
    saved = {k for k in header if k != "__metadata__"}
    if saved != set(live):
        raise ValueError(
            f"{path}: keys differ from the state: missing "
            f"{sorted(set(live) - saved)}, unexpected "
            f"{sorted(saved - set(live))}")
    for key, t in live.items():
        entry = header[key]
        if entry["dtype"] != st.dtype_name(t.dtype) or \
                entry["shape"] != list(t.shape):
            raise ValueError(
                f"{path}: {key!r} is {entry['dtype']}{entry['shape']} in the "
                f"file, {st.dtype_name(t.dtype)}{list(t.shape)} in the state")


def _restore_into(path: str, payload: dict) -> dict:
    """Copy the file's tensors into the payload's live tensors in place
    (no leaf is rebound, so the optimizer and the caller keep seeing the
    same tensors); returns the host ints (the step) by key. The file must
    hold exactly the payload's keys, each with the live dtype and shape."""
    live = _flat_tensors(payload)
    _check_file(path, live)
    ints = {key for key, leaf in flatten_dict(payload).items()
            if isinstance(leaf, int)}
    out = {}
    with torch.no_grad():
        for key, host in st.iter_file(path):
            if key in ints:
                out[key] = int(host)
            else:
                live[key].copy_(host)
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """`tree` with each tensor t replaced by fn(key, t), the key being
    its `flatten_dict` path; dicts, NamedTuples, lists and tuples kept."""
    def key(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, key(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, fn, key(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, key(i)) for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    return tree


def _restore_fp8_state(path: str, live_fp8_state) -> None:
    """Restore fp8 metas into the live tensors in place. A window length
    on disk (the sidecar's) other than the live one adapts instead of
    failing the shape check: the like-tree takes the length on disk, and
    the restored windows keep their newest entries or are padded with
    zeros to the live length."""
    live_len = fp8_state_history_len(live_fp8_state)
    saved_len = live_len
    sidecar = path[:-len(".safetensors")] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            saved_len = json.load(f).get("amax_history_len", live_len)
    if saved_len is None or live_len is None or saved_len == live_len:
        _restore_into(path, {"fp8_state": live_fp8_state})
        return
    logger.warning(
        "fp8 amax_history_len mismatch: checkpoint has %d, live state "
        "wants %d; restoring the newest %d entries (%s).",
        saved_len, live_len, min(saved_len, live_len),
        "truncating" if saved_len > live_len else "zero-padding the tail")
    like = {"fp8_state": adapt_history_len(_rebuild(
        live_fp8_state, lambda _, t: torch.empty(
            t.shape, dtype=t.dtype, device="meta")), saved_len)}
    _check_file(path, _flat_tensors(like))
    host = dict(st.iter_file(path))
    restored = adapt_history_len(
        _rebuild(like, lambda k, _: host[k])["fp8_state"], live_len)
    new = _flat_tensors({"fp8_state": restored})
    with torch.no_grad():
        for key, t in _flat_tensors({"fp8_state": live_fp8_state}).items():
            t.copy_(new[key])


def load_accelerator_state(
    input_dir: str,
    train_states: list = (),
    optimizers: list = (),
    schedulers: list = (),
    dataloaders: list = (),
    custom_objects: list = (),
    load_rng: bool = True,
) -> dict:
    """Restore a checkpoint written by `save_accelerator_state`: each
    train state's and eager optimizer's tensors in place, the train
    states' `step`, and the host objects."""
    t0 = time.perf_counter()
    with span("checkpoint.restore"):
        out = _load_accelerator_state(
            input_dir, train_states, optimizers, schedulers, dataloaders,
            custom_objects, load_rng,
        )
    reg = get_registry()
    reg.counter("checkpoint_restores_total").inc()
    reg.histogram("checkpoint_restore_seconds").record(
        time.perf_counter() - t0)
    return out


def _load_accelerator_state(input_dir, train_states, optimizers, schedulers,
                            dataloaders, custom_objects, load_rng) -> dict:
    # a load must see every async save committed, on every process
    wait_for_checkpoints()
    _barrier()
    input_dir = _abspath(input_dir)
    out: dict[str, Any] = {"train_states": [], "step": 0}

    for i, ts in enumerate(train_states):
        ints = _restore_into(
            os.path.join(input_dir, f"{MODEL_NAME}_{i}.safetensors"),
            _train_state_payload(ts))
        ts.step = ints["step"]
        fp8_path = os.path.join(input_dir, f"{MODEL_NAME}_{i}_fp8.safetensors")
        if ts.fp8_state is not None and os.path.exists(fp8_path):
            _restore_fp8_state(fp8_path, ts.fp8_state)
        out["train_states"].append(ts)

    for i, opt in enumerate(optimizers):
        payload = _optimizer_payload(opt)
        if payload:
            _restore_into(_optimizer_file(input_dir, i), payload)

    for i, sched in enumerate(schedulers):
        path = os.path.join(input_dir, f"{SCHEDULER_NAME}_{i}.bin")
        if os.path.exists(path):
            with open(path, "rb") as f:
                sched.load_state_dict(pickle.load(f))

    for i, loader in enumerate(dataloaders):
        path = os.path.join(input_dir, f"{SAMPLER_NAME}_{i}.bin")
        if os.path.exists(path):
            with open(path, "rb") as f:
                meta = pickle.load(f)
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(meta.get("epoch", 0))

    for i, obj in enumerate(custom_objects):
        path = os.path.join(input_dir, f"custom_checkpoint_{i}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                obj.load_state_dict(pickle.load(f))

    meta_path = os.path.join(input_dir, "accelerator_state.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out["step"] = json.load(f).get("step", 0)

    rng_path = os.path.join(
        input_dir, f"{RNG_STATE_NAME}_{PartialState.process_index}.pkl")
    if load_rng and os.path.exists(rng_path):
        with open(rng_path, "rb") as f:
            rng_states = pickle.load(f)
        _py_random.setstate(rng_states["python"])
        np.random.set_state(rng_states["numpy"])
        if "torch" in rng_states:
            torch.set_rng_state(rng_states["torch"])
    return out


# ---------------------------------------------------------------------------
# preemption-tolerant auto-resume
# ---------------------------------------------------------------------------


def is_complete_checkpoint(directory: str) -> bool:
    """True iff `directory` carries a committed manifest whose files all
    exist — i.e. resume_latest would consider it."""
    return is_complete(directory)


def latest_complete_checkpoint(base_dir: str) -> str | None:
    """Newest complete checkpoint under `base_dir` (or `base_dir` itself
    when it carries a manifest), ordered by (manifest step, commit time);
    None when nothing committed. Torn/uncommitted directories — a crash
    mid-save at any byte offset — are skipped, never errors."""
    return latest_complete(base_dir)


def resume_latest(
    input_dir: str,
    train_states: list = (),
    optimizers: list = (),
    schedulers: list = (),
    dataloaders: list = (),
    custom_objects: list = (),
    load_rng: bool = True,
) -> dict | None:
    """Restore from the newest COMPLETE checkpoint under `input_dir`:
    step count, params/opt state, host RNG streams, dataloader epoch —
    everything `load_accelerator_state` round-trips. Returns its result
    dict plus `checkpoint_dir` and `manifest`, or None when no complete
    checkpoint exists (a fresh start, not an error)."""
    t0 = time.perf_counter()
    # drain first: an in-flight save of this run publishes before the
    # search for the newest commit
    wait_for_checkpoints()
    path = latest_complete(_abspath(input_dir))
    if path is None:
        return None
    out = load_accelerator_state(
        path,
        train_states=train_states,
        optimizers=optimizers,
        schedulers=schedulers,
        dataloaders=dataloaders,
        custom_objects=custom_objects,
        load_rng=load_rng,
    )
    out["checkpoint_dir"] = path
    out["manifest"] = read_manifest(path)
    reg = get_registry()
    reg.counter("checkpoint_resumes_total").inc()
    reg.histogram("resume_latency_seconds").record(time.perf_counter() - t0)
    return out


def sealing_checkpoint_dirs() -> list[str]:
    """Directories of async saves not yet committed (still being written,
    or written and waiting for their manifest): what retention must not
    delete."""
    return _stager.sealed_dirs()


def prune_checkpoints(base_dir: str, keep_last_n: int) -> list[str]:
    """Retention: delete all but the newest `keep_last_n` complete
    checkpoints under `base_dir` (clamped so the newest complete commit
    always survives). Directories whose async writes are still sealing
    are protected; incomplete directories are left alone (they may be
    mid-write). Returns the removed paths."""
    return prune_complete(base_dir, keep_last_n,
                          protected=sealing_checkpoint_dirs())


# ---------------------------------------------------------------------------
# portable safetensors export
# ---------------------------------------------------------------------------


def _parse_size(size: str | int) -> int:
    if isinstance(size, int):
        return size
    units = {"KB": 2**10, "MB": 2**20, "GB": 2**30, "KIB": 2**10, "MIB": 2**20, "GIB": 2**30}
    s = size.strip().upper()
    for suffix, mult in sorted(units.items(), key=lambda kv: -len(kv[0])):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)])) * mult
    return int(s)


def shard_checkpoint(
    state_dict: dict[str, torch.Tensor], max_shard_size: str | int = "10GB",
    weights_name: str = SAFE_WEIGHTS_NAME,
) -> tuple[dict[str, dict], dict | None]:
    """Split a flat state dict into size-bounded shards. Returns
    ({filename: shard}, index or None), named and indexed as the
    reference and Hugging Face do."""
    max_bytes = _parse_size(max_shard_size)
    shards: list[dict] = [{}]
    current = 0
    for key, tensor in state_dict.items():
        nbytes = tensor.nbytes
        if current + nbytes > max_bytes and shards[-1]:
            shards.append({})
            current = 0
        shards[-1][key] = tensor
        current += nbytes
    if len(shards) == 1:
        return {weights_name: shards[0]}, None
    name_root, ext = os.path.splitext(weights_name)
    files, weight_map = {}, {}
    for i, shard in enumerate(shards):
        fname = f"{name_root}-{i + 1:05d}-of-{len(shards):05d}{ext}"
        files[fname] = shard
        for key in shard:
            weight_map[key] = fname
    index = {
        "metadata": {"total_size": sum(t.nbytes for t in state_dict.values())},
        "weight_map": weight_map,
    }
    return files, index


def save_model(
    params: Any,
    save_directory: str,
    max_shard_size: str | int = "10GB",
    safe_serialization: bool = True,
) -> str:
    """Write the params (a nested dict of tensors, on any device) as
    safetensors under `save_directory`, index-sharded above
    `max_shard_size`; `safe_serialization=False` pickles the flat dict of
    host tensors to `model.pkl` instead."""
    save_directory = _abspath(save_directory)
    os.makedirs(save_directory, exist_ok=True)
    if not PartialState.is_main_process:
        # the replicas are identical: the main process writes them
        _barrier()
        return save_directory
    flat = {k: v.detach().to("cpu").contiguous()
            for k, v in flatten_dict(params).items()}
    if safe_serialization:
        files, index = shard_checkpoint(flat, max_shard_size)
        for fname, shard in files.items():
            st.save_file(shard, os.path.join(save_directory, fname),
                         metadata={"format": "pt"})
        if index is not None:
            with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
                json.dump(index, f, indent=2)
    else:
        with open(os.path.join(save_directory, "model.pkl"), "wb") as f:
            pickle.dump(flat, f)
    _barrier()
    return save_directory


def load_model(save_directory: str, device=None) -> dict:
    """Inverse of `save_model`: read (possibly index-sharded) safetensors
    into a nested dict of tensors on `device` (CUDA unless "cpu")."""
    dev = resolve_device(device)
    save_directory = _abspath(save_directory)
    index_path = os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME)
    single = os.path.join(save_directory, SAFE_WEIGHTS_NAME)
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted(set(index["weight_map"].values()))
    elif os.path.exists(single):
        files = [SAFE_WEIGHTS_NAME]
    else:
        raise FileNotFoundError(f"no {SAFE_WEIGHTS_NAME} under {save_directory}")
    flat = {}
    for fname in files:
        for key, t in st.iter_file(os.path.join(save_directory, fname)):
            flat[key] = t.to(dev)
    return unflatten_dict(flat)
