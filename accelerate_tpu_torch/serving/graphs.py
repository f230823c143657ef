"""Fixed-shape device programs, each captured once as a CUDA graph and
replayed: the port's counterpart of the reference engine's `jax.jit`
programs (`accelerate_tpu/serving/engine.py`, admit/prefill/decode and
the speculative draft_prefill/draft/verify), which compile once and run
as one executable a step.

A program is a Python function with no arguments that reads its inputs
from device buffers the runner owns (`buffer`) and from engine state
that lives at fixed addresses (the KV pool, the token register), writes
that state in place, and returns its outputs. The engine copies host
inputs into the buffers (`upload`) before it runs a program. On a CUDA
engine a program's first run is its warm-up: it runs eagerly on the
runner's side stream (this step's real work, and every lazy
initialisation: cuBLAS workspaces, kernel builds, shared-memory opt-ins,
rotary tables), then the runner captures it into a graph with a private
memory pool. Every later run replays the graph. A capture that fails
raises; nothing falls back to eager. On a CPU engine, or a CUDA engine
built with graphs off, a program is called directly, so the CPU tests
run exactly the code that a CUDA engine captures.

Kernel launches are counted by their wrappers (`launches` on the wrapper
function), which run only while Python runs: a replay launches without
them. The runner reads the counters before and after the capture, takes
their change as the graph's launches per replay, takes the capture's own
increments back (capture records launches, it does not run them), and
adds the per-replay launches at every replay. The warm-up's increments
stay: it ran on real data.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["GraphRunner"]


@dataclasses.dataclass
class _Buffer:
    device: torch.Tensor
    staging: torch.Tensor | None = None   # pinned host copy (CUDA)
    copied: Any = None                    # event after the last upload


@dataclasses.dataclass
class _Program:
    name: str
    fn: Callable
    capture: bool
    builds: int = 0
    capture_s: float = 0.0
    graph: Any = None
    outputs: Any = None
    per_replay: tuple = ()


class GraphRunner:
    """Owns an engine's static input buffers and its programs.

    `graphs=False` (or a CPU device) runs every program directly.
    `counters` names the kernel wrappers whose `.launches` count through
    replays: (module, function name) pairs, looked up at each read so a
    wrapper replaced on its module is still the one counted."""

    def __init__(self, device: torch.device, graphs: bool = True,
                 counters=()):
        self.device = device
        self.graphs = bool(graphs) and device.type == "cuda"
        self._counters = tuple(counters)
        self._buffers: dict[str, _Buffer] = {}
        self._programs: dict[str, _Program] = {}
        self._stream = None

    # -- static inputs -------------------------------------------------------

    def buffer(self, name: str, shape, dtype) -> torch.Tensor:
        """A static device buffer (zeros) that `upload` refills."""
        dev = torch.zeros(shape, dtype=dtype, device=self.device)
        staging = None
        if self.device.type == "cuda":
            staging = torch.zeros(shape, dtype=dtype, pin_memory=True)
        self._buffers[name] = _Buffer(dev, staging)
        return dev

    def upload(self, name: str, value) -> torch.Tensor:
        """Copy a host value into buffer `name`. On CUDA it goes through
        the buffer's pinned staging copy, asynchronously; the staging copy
        is rewritten only once the previous copy out of it has finished
        (a wait on that copy alone, normally long done)."""
        buf = self._buffers[name]
        src = torch.from_numpy(np.ascontiguousarray(value)).reshape(
            buf.device.shape)
        if buf.staging is None:
            buf.device.copy_(src)
            return buf.device
        if buf.copied is not None:
            buf.copied.synchronize()
        buf.staging.copy_(src)
        buf.device.copy_(buf.staging, non_blocking=True)
        buf.copied = torch.cuda.Event()
        buf.copied.record()
        return buf.device

    # -- programs ------------------------------------------------------------

    def add(self, name: str, fn: Callable, capture: bool = True) -> None:
        """Register program `name`. `capture=False` keeps it eager on
        every device (it may then take arguments): the engine's admit,
        three scalar writes, is one."""
        self._programs[name] = _Program(name, fn, capture)

    def __call__(self, name: str, *args):
        prog = self._programs[name]
        if not (self.graphs and prog.capture):
            prog.builds = 1
            return prog.fn(*args)
        if args:
            raise TypeError(f"captured program {name!r} takes no arguments:"
                            " its inputs are the runner's buffers")
        if prog.graph is None:
            return self._warm_and_capture(prog)
        prog.graph.replay()
        self._add(prog.per_replay)
        return prog.outputs

    def captures(self) -> dict[str, int]:
        """Captures (graphs) or first builds (eager) per program: 0 until
        a program first runs, then 1 for good."""
        return {name: p.builds for name, p in self._programs.items()}

    def capture_seconds(self) -> dict[str, float]:
        """Host seconds each captured program's capture took (its
        warm-up excluded)."""
        return {name: p.capture_s for name, p in self._programs.items()
                if p.graph is not None}

    def _warm_and_capture(self, prog: _Program):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = prog.fn()
        warm = self._read()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: the host tier's drain thread may wait on its
            # own events while this thread captures
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = prog.fn()
        except Exception as e:
            self._write(warm)
            raise RuntimeError(
                f"capturing engine program {prog.name!r} as a CUDA graph "
                f"failed: {e}") from e
        captured = self._read()
        self._write(warm)
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        prog.per_replay = tuple(c - w for c, w in zip(captured, warm))
        prog.graph, prog.outputs = graph, outputs
        prog.capture_s = time.perf_counter() - t0
        prog.builds += 1
        return out

    # -- launch counters -----------------------------------------------------

    def _read(self) -> list[int]:
        return [getattr(getattr(mod, fn), "launches")
                for mod, fn in self._counters]

    def _write(self, values) -> None:
        for (mod, fn), v in zip(self._counters, values):
            getattr(mod, fn).launches = v

    def _add(self, deltas) -> None:
        for (mod, fn), d in zip(self._counters, deltas):
            if d:
                getattr(mod, fn).launches += d


def _tensors(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []
