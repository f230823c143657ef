"""Host-DRAM overflow tier for the paged KV cache (hierarchical KV); a
copy of `accelerate_tpu/serving/host_tier.py` on the port's transport
(`serving/transfer.py`).

HBM eviction used to be destruction: a refcount-0 prefix falling out of
the page pool re-prefilled from scratch, so the effective prefix cache
was HBM-sized. Host DRAM is an order of magnitude larger than HBM — this
module turns it into a second cache tier:

- **Swap-out** rides the existing eviction path. When `PagedAllocator`
  evicts a refcount-0 page, it offers the victim here first
  (`HostTier.offer`). Accepting a victim runs the transport's extract
  program for that page *immediately, on the engine thread and stream*
  — stream order guarantees the gather reads the page's bytes before the
  page's next owner overwrites them — then starts the device→host copy
  on a side stream, ordered after the gather by an event. A background
  drain thread waits on that event (never on the whole device) and
  keeps the host copy. The radix node stays in the tree, flagged
  host-resident (cache.py `_RadixNode`), so the prefix still matches.

- **Swap-in** rides admission. A radix match whose tail is
  host-resident makes `PagedAllocator.allocate` reserve fresh pool
  pages for those chunks (worst-case-at-admission, so running slots
  still never hit mid-flight OOM) and report them as
  `PageAllocation.swap_ins`; the engine fetches the bytes
  (`HostTier.fetch`) and lands them through the transport's install
  program *before* the slot's admit program runs. Hit/miss/swap mixes
  never change a program shape — the transport pair is captured once
  each. int8 pools swap codes + scale blocks verbatim: no
  dequant/requant round-trip, so shared pages stay bit-stable across
  however many swap cycles.

- **Backpressure** never reaches decode. The drain queue is bounded;
  when it is full and the tier still has budget, the allocator *stalls
  the admission* (request stays queued, `swap_stall`) rather than
  blocking the engine thread on the queue or destroying prefixes the
  tier has room for. When the tier's byte budget itself is exhausted,
  eviction falls back to the classic destructive path.

Sizing: `capacity_pages = host_tier_bytes // cache.page_nbytes`. An
int8 pool's pages are roughly half the bytes of bf16 (codes + bf16
scales), so the same budget caches about twice the prefix tokens — and
each swap moves half the bytes over PCIe.
"""

from __future__ import annotations

import queue
import threading

from ..telemetry.lockwatch import maybe_tracked

__all__ = ["HostTier"]


class _HostEntry:
    """One swapped-out page, in one of two states: `pending` holds the
    in-flight copy (host tensors and the event that completes them)
    until the drain thread (or a racing fetch) waits it out into `data`
    ({"k","v"[,"k_scale","v_scale"]} host tensors, one page each).
    `lock` orders drain vs. fetch — the swap-in-racing-eviction case
    where an admission wants the bytes before the drain got to them."""

    __slots__ = ("node", "pending", "data", "lock", "cancelled")

    def __init__(self, node, pending):
        self.node = node
        self.pending = pending
        self.data = None
        self.lock = maybe_tracked("host-tier-entry")
        self.cancelled = False


class HostTier:
    """Byte-budgeted host mirror of evicted KV pages.

    All bookkeeping (offer/fetch/discard, the entries dict, gauges)
    happens on the engine thread; the drain thread only waits out the
    copies' events. `entries` is keyed by the radix node object itself —
    node identity IS the chunk's identity for as long as it stays in the
    tree, and `PrefixIndex.drop_host` fires here the moment a node loses
    its naming path."""

    def __init__(self, engine, budget_bytes: int):
        self._engine = engine
        cache = engine.cache
        self.page_nbytes = cache.page_nbytes
        self.capacity_pages = max(0, int(budget_bytes) // self.page_nbytes)
        self.queue_bound = max(4, 2 * cache.pages_per_slot)
        self._entries: dict = {}
        self._queue: queue.Queue = queue.Queue(maxsize=self.queue_bound)
        self.swapped_out_pages = 0      # lifetime accepted offers
        self.swapped_in_pages = 0       # lifetime fetches
        self.rejected_pages = 0         # offers refused (budget full)
        self._closed = False
        self._drain = threading.Thread(target=self._drain_loop,
                                       name="kv-host-tier", daemon=True)
        self._drain.start()

    # -- sizing / state ------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return len(self._entries)

    @property
    def bytes_in_use(self) -> int:
        return len(self._entries) * self.page_nbytes

    @property
    def free_pages(self) -> int:
        return self.capacity_pages - len(self._entries)

    def queue_len(self) -> int:
        return self._queue.qsize()

    def stats(self) -> dict:
        return {
            "capacity_pages": self.capacity_pages,
            "pages_in_use": self.pages_in_use,
            "bytes_in_use": self.bytes_in_use,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "rejected_pages": self.rejected_pages,
            "queue_len": self.queue_len(),
        }

    # -- allocator hooks (engine thread) -------------------------------------

    def would_stall(self, need: int) -> bool:
        """True when eviction of `need` pages should wait: the tier has
        budget for at least one of them, but the bounded drain queue
        can't absorb that many offers right now. Stalling the admission
        (not the engine) lets the drain thread catch up; a budget-full
        tier never stalls — those victims evict destructively."""
        takeable = min(need, self.free_pages)
        if takeable <= 0:
            return False
        return (self.queue_bound - self._queue.qsize()) < takeable

    def offer(self, node) -> bool:
        """Accept an eviction victim into the tier, or decline (False =
        caller evicts destructively). Must run while `node.page` still
        names the bytes: the extract is queued here, in stream order,
        before the pool can hand the page to its next owner."""
        if self._closed or self.free_pages <= 0:
            self.rejected_pages += 1
            return False
        eng = self._engine
        tp = eng._swap_transport
        entry = _HostEntry(node, tp.copy_out(tp.extract(node.page)))
        try:
            self._queue.put_nowait(entry)
        except queue.Full:
            # would_stall gates the common path; a race with concurrent
            # offers in one eviction burst can still land here — decline
            # rather than block the engine thread
            self.rejected_pages += 1
            return False
        self._entries[node] = entry
        self.swapped_out_pages += 1
        eng.metrics.note_swap_out(1)
        self._sync_gauges()
        return True

    def fetch(self, node) -> dict:
        """Remove and return a node's page bytes for swap-in. If the
        drain thread hasn't got to the entry yet (swap-in racing its own
        swap-out), its copy is waited out here."""
        entry = self._entries.pop(node, None)
        if entry is None:
            raise RuntimeError(
                "host tier has no entry for a host-resident node — "
                "residency bookkeeping is corrupt")
        self._materialize(entry)
        self.swapped_in_pages += 1
        self._sync_gauges()
        return entry.data

    def discard(self, node) -> None:
        """Forget a node's mirror (adoption re-homed the chunk in HBM,
        or destructive eviction severed its path). Idempotent."""
        entry = self._entries.pop(node, None)
        if entry is not None:
            entry.cancelled = True
            self._sync_gauges()

    # -- drain thread --------------------------------------------------------

    def _materialize(self, entry: _HostEntry) -> None:
        with entry.lock:
            if entry.data is not None or entry.pending is None:
                return
            if entry.cancelled:
                entry.pending = None
                return
            host, done = entry.pending
            if done is not None:
                done.synchronize()
            entry.data = {name: t[0] for name, t in host.items()}
            entry.pending = None

    def _drain_loop(self) -> None:
        while True:
            entry = self._queue.get()
            if entry is None:
                return
            self._materialize(entry)

    def _sync_gauges(self) -> None:
        self._engine.metrics.set_host_tier_gauges(self.pages_in_use,
                                                  self.bytes_in_use)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._drain.join(timeout=5.0)
