"""KV pages in and out of the pool: the extract/install pair the host KV
tier moves swapped pages with (the port's own copy of what the tier needs
from `accelerate_tpu/serving/pod/transfer.py` `PageTransport`; the pod's
prefill-to-decode shipment comes with the pod slice).

- `extract`: gather one pool page into a dense block, page-major
  ([1, L, page_size, H, D]): the host tier swaps out one eviction victim
  at a time, so one fixed shape serves every extraction. The tier then
  copies the block to pinned host memory on a side stream (`copy_out`),
  ordered after the gather by an event.
- `install`: scatter a block into the pool at a fixed [pages_per_slot]
  row, trash-padded past the real pages, so the dead lanes write only the
  trash page. Also one program.

Both are engine programs (serving/graphs.py): captured once as CUDA
graphs on a CUDA engine, counted by `Engine.compile_stats()`. An int8
pool moves its codes and per-row scales verbatim, never dequantized and
requantized, so a page is byte-identical after any number of swap
cycles: the bit-stability copy-on-write sharing relies on.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PageTransport"]


class PageTransport:
    """One engine's extract/install pair and their buffers."""

    def __init__(self, engine):
        cache = engine.cache
        runner = engine._graphs
        self._runner = runner
        self._cache = cache
        self._cuda = cache.k.device.type == "cuda"
        P = cache.pages_per_slot
        self._names = (("k", "v", "k_scale", "v_scale") if cache.quantized
                       else ("k", "v"))
        self._page = runner.buffer("extract_page", (1,), torch.int32)
        self._install_rows = runner.buffer("install_rows", (P,), torch.int32)
        # the install block lives on the device at a fixed address (the
        # graph reads it there) with a pinned host twin it is filled from
        self._block, self._staging = {}, {}
        for name in self._names:
            pool = getattr(cache, name)
            shape = (P, pool.shape[0]) + tuple(pool.shape[2:])
            self._block[name] = torch.zeros(shape, dtype=pool.dtype,
                                            device=pool.device)
            self._staging[name] = torch.zeros(shape, dtype=pool.dtype,
                                              pin_memory=self._cuda)
        self._staged = None       # event after the last install upload
        self._copied = None       # event after the last copy_out
        self._side = torch.cuda.Stream(cache.k.device) if self._cuda \
            else None
        runner.add("extract", self._extract)
        runner.add("install", self._install)

    # -- programs ------------------------------------------------------------

    def _extract(self):
        page = self._page.long()
        return tuple(
            torch.index_select(getattr(self._cache, name).transpose(0, 1),
                               0, page)
            for name in self._names)

    def _install(self):
        rows = self._install_rows.long()
        for name in self._names:
            getattr(self._cache, name).index_copy_(
                1, rows, self._block[name].transpose(0, 1))

    # -- host side -----------------------------------------------------------

    def extract(self, page: int) -> dict:
        """Pool page `page` as a [1, L, ps, H(, D)] device block per
        buffer."""
        if self._copied is not None:
            # the block may be a graph's output: the last copy out of it
            # must finish before a replay rewrites it
            torch.cuda.current_stream(self._cache.k.device).wait_event(
                self._copied)
        self._runner.upload("extract_page", np.array([page], np.int32))
        return dict(zip(self._names, self._runner("extract")))

    def copy_out(self, block: dict):
        """Start copying an extracted block to host memory: ({name:
        [1, L, ps, H(, D)] host tensor}, event), the event None on a CPU
        engine. On CUDA the copy runs on a side stream after everything
        queued so far; waiting on the event waits for this copy only."""
        host = {name: torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=self._cuda)
                for name, t in block.items()}
        if not self._cuda:
            for name, t in block.items():
                host[name].copy_(t)
            return host, None
        side = self._side
        side.wait_stream(torch.cuda.current_stream(side.device))
        with torch.cuda.stream(side):
            for name, t in block.items():
                host[name].copy_(t, non_blocking=True)
                t.record_stream(side)
            done = torch.cuda.Event()
            done.record(side)
        self._copied = done
        return host, done

    def install(self, rows: np.ndarray, pages: list) -> None:
        """Land host pages in the pool: `pages[i]` ({name: [L, ps, H(, D)]
        host tensor}) goes to pool page `rows[i]`; `rows` is the fixed
        [pages_per_slot] row, trash-padded past len(pages)."""
        n = len(pages)
        if self._staged is not None:
            self._staged.synchronize()   # the last upload left staging
        for i, data in enumerate(pages):
            for name in self._names:
                self._staging[name][i].copy_(data[name])
        for name in self._names:
            self._block[name][:n].copy_(self._staging[name][:n],
                                        non_blocking=True)
        if self._cuda:
            self._staged = torch.cuda.Event()
            self._staged.record()
        self._runner.upload("install_rows", rows)
        self._runner("install")
