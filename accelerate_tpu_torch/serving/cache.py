"""Paged KV cache with prefix reuse (port of `accelerate_tpu/serving/cache.py`).

The physical buffer is a pool of fixed-size pages ([L, pages, page_size,
H, D]) and each slot owns an ordered page table instead of a contiguous
stripe:

- per-request memory is sized by the request (pages allocated at
  admission), not by the engine-wide max_len;
- a page's content is position-addressed but location-free, so pages
  holding a shared prompt prefix can be mapped read-only into many slots
  at once. The host-side `PrefixIndex` (a radix tree over page-sized
  token chunks) remembers which pages encode which prompt prefixes;
  `PagedAllocator` matches the longest cached prefix at admission, maps
  those pages copy-on-write (refcounted FULL pages, never written again)
  and releases a retiring request's full prompt pages back into the tree.

Page tables are fixed-shape ([slots, pages_per_slot] int32, padded with a
reserved trash page), so the device work has the same shapes whatever the
request mix or eviction history.

The port updates the pool in place (the reference returns updated
copies); every device function here mutates `cache` and returns it.

Write-safety under sharing: only FULL prompt pages enter the tree, and
reuse is capped at `(prompt_len - 1) // page_size` pages. Writes land at
a slot's current `length`, which always lies in a private page.

Correctness invariant (why retired slots never need zeroing): a write
always lands at the slot's current `length`, and the position mask only
lets queries attend rows < length (plus the new token). Stale rows past
`length` are never attended and are overwritten as the length advances;
admission just sets `length`. Prefill chunks are padded to a fixed size,
so a slot's view covers `max_len + pad_slack` rows (`pad_slack` = the
chunk size); `lengths` only ever advances by real token counts.

On a tensor-parallel engine (`EngineConfig.mesh`) each rank holds its
shard of the pool (`serving/pod/mesh.py` `cache_state_shardings`): its
KV heads, or a stripe of whole pages (`PoolShard`). A head shard needs
nothing here: every function runs on the local heads. A page shard maps
global page indices to its stripe: reads gather the pages it owns, zero
the others and sum over the axis (every rank then holds the whole view);
writes land in owned pages only, the rest in a private dump page past
the stripe that nothing reads. Page counts and the trash page stay
global, so the host side sees one pool.

The host side (`PagePool`, `PrefixIndex`, `PageAllocation`,
`PagedAllocator`) is a copy of the reference's.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import kv_dequantize_rows, kv_quantize_rows


# ---------------------------------------------------------------------------
# dense slot cache (the speculative draft model's state)
# ---------------------------------------------------------------------------


def _slot_index(slot, device) -> torch.Tensor:
    """A slot as a [1] int64 index tensor: the engine's captured programs
    take the slot as device data (one program for every slot); a python
    int is accepted for eager callers."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).long()
    return torch.tensor([slot], dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class SlotKVCache:
    """Fixed-shape slot-indexed decode cache.

    k/v: [num_layers, num_slots, max_len + pad_slack, num_kv_heads,
    head_dim]; lengths: [num_slots] int32, the per-slot decode depth. The
    port updates k, v and lengths in place."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    max_len: int
    pad_slack: int

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_slots: int,
        max_len: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: Any = torch.bfloat16,
        pad_slack: int = 0,
        device=None,
    ) -> "SlotKVCache":
        dev = resolve_device(device)
        shape = (num_layers, num_slots, max_len + pad_slack, num_kv_heads,
                 head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
            max_len=max_len,
            pad_slack=pad_slack,
        )

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_slots(self) -> int:
        return self.k.shape[1]

    @property
    def rows(self) -> int:
        """Physical rows per slot (max_len + pad_slack)."""
        return self.k.shape[2]

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes


def slot_caches(cache: SlotKVCache, slot):
    """One slot's caches in `models/decode.py` layout: (k [L, 1, M, H, D],
    v [L, 1, M, H, D], cache_len [1]), copies, so a forward may extend
    them in place. `slot` is a [1] (or 0-dim) index tensor or an int."""
    idx = _slot_index(slot, cache.k.device)
    return (cache.k.index_select(1, idx), cache.v.index_select(1, idx),
            cache.lengths.index_select(0, idx))


def write_slot(cache: SlotKVCache, slot, new_k: torch.Tensor,
               new_v: torch.Tensor, advance) -> SlotKVCache:
    """Write one slot's updated [L, 1, M, H, D] buffers back and advance
    its length by `advance` REAL tokens (chunk padding excluded by the
    caller, per the module invariant)."""
    idx = _slot_index(slot, cache.k.device)
    cache.k.index_copy_(1, idx, new_k.to(cache.k.dtype))
    cache.v.index_copy_(1, idx, new_v.to(cache.v.dtype))
    _advance(cache.lengths, idx, advance)
    return cache


def _advance(lengths: torch.Tensor, idx: torch.Tensor, advance) -> None:
    """lengths[idx] += advance, for an int or a device tensor (which a
    captured program passes: building one from an int there would copy
    from the host)."""
    if isinstance(advance, torch.Tensor):
        lengths.index_add_(0, idx, advance.reshape(1).to(torch.int32))
    else:
        lengths[idx] += advance


def reset_slot(cache: SlotKVCache, slot) -> SlotKVCache:
    """Admit a new request into `slot`: length back to zero. The stale
    K/V rows stay in place; the position mask hides them."""
    cache.lengths[slot] = 0
    return cache


# ---------------------------------------------------------------------------
# paged pool (device side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolShard:
    """This rank's shard of a paged pool on a mesh axis of `n` ranks, at
    `index`: `dim` "heads" (local KV heads) or "pages" (global pages
    [index * stripe, (index + 1) * stripe) at local 0..stripe-1, then
    the local dump page). `pages` is the global page count, the trash
    page included. `group` returns the axis's process group."""

    dim: str
    n: int
    index: int
    pages: int
    group: Callable

    @property
    def stripe(self) -> int:
        return self.pages // self.n


def _local_pages(shard: PoolShard, idx: torch.Tensor):
    """(local page index, owned mask) of global pages `idx` on a page
    shard: pages of other ranks go to the dump page."""
    loc = idx.long() - shard.index * shard.stripe
    owned = (loc >= 0) & (loc < shard.stripe)
    return torch.where(owned, loc, shard.stripe), owned


def pool_pages(cache: "PagedKVCache", name: str,
               idx: torch.Tensor) -> torch.Tensor:
    """Buffer `name` ("k", "v", "k_scale", "v_scale") of pool pages `idx`
    (any index shape) along dim 1, as stored (codes stay codes): on a
    page shard, the owned pages summed over the axis with the others'."""
    buf = getattr(cache, name)
    shard = cache.shard
    if shard is None or shard.dim != "pages":
        return buf[:, idx.long()]
    loc, owned = _local_pages(shard, idx)
    pages = buf[:, loc]
    mask = owned.reshape((1,) + owned.shape + (1,) * (pages.dim()
                                                      - owned.dim() - 1))
    pages = torch.where(mask, pages, torch.zeros_like(pages))
    from ..utils.operations import axis_all_reduce

    return axis_all_reduce(pages, shard.group())


def pool_write(cache: "PagedKVCache", name: str, idx: torch.Tensor,
               value: torch.Tensor) -> None:
    """Write `value` (dim 1 indexed like `idx`) into buffer `name` at pool
    pages `idx`; a page shard keeps the pages it owns."""
    buf = getattr(cache, name)
    shard = cache.shard
    if shard is None or shard.dim != "pages":
        buf.index_copy_(1, idx.long(), value)
        return
    buf.index_copy_(1, _local_pages(shard, idx)[0], value)


@dataclasses.dataclass(frozen=True)
class PagedKVCache:
    """Paged KV pool with fixed-shape per-slot page tables.

    k/v: [num_layers, num_pages + 1, page_size, num_kv_heads, head_dim];
    the last page is the reserved TRASH page backing padded page-table
    entries (idle lanes read it, dead writes land in it, it is never
    allocated). lengths: [num_slots] int32, the per-slot decode depth
    (which starts at the reused prefix length on a prefix hit).

    QUANTIZED mode (`create(kv_dtype="int8")`): k/v hold int8 codes and
    `k_scale`/`v_scale` ([L, pages+1, page_size, H] bf16, one symmetric
    absmax scale per row per head, `ops/quant.py kv_quantize_rows`) ride
    alongside. All writes quantize and all dense views dequantize to
    `compute_dtype`; the paged-decode kernel dequantizes in-kernel."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    page_size: int
    pages_per_slot: int
    max_len: int
    pad_slack: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    compute_dtype: Any = torch.bfloat16
    # this rank's shard on a tensor-parallel engine (None: the whole pool)
    shard: PoolShard | None = None

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_slots: int,
        max_len: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: Any = torch.bfloat16,
        page_size: int = 16,
        pad_slack: int = 0,
        num_pages: int | None = None,
        kv_dtype: Any = None,
        device=None,
    ) -> "PagedKVCache":
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in (None, "int8", torch.int8):
            raise ValueError(
                f"kv_dtype must be None (store in `dtype`) or 'int8', "
                f"got {kv_dtype!r}")
        dev = resolve_device(device)
        quantized = kv_dtype is not None
        # a slot's view must cover max_len rows plus the chunk-padding
        # spill — round up to whole pages
        pages_per_slot = -(-(max_len + pad_slack) // page_size)
        if num_pages is None:
            num_pages = num_slots * pages_per_slot
        if num_pages < pages_per_slot:
            raise ValueError(
                f"num_pages({num_pages}) < pages_per_slot({pages_per_slot}):"
                " a max-size request could never be admitted")
        shape = (num_layers, num_pages + 1, page_size, num_kv_heads, head_dim)
        store = torch.int8 if quantized else dtype

        def scales():
            return (torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev)
                    if quantized else None)

        return cls(
            k=torch.zeros(shape, dtype=store, device=dev),
            v=torch.zeros(shape, dtype=store, device=dev),
            lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
            page_size=page_size,
            pages_per_slot=pages_per_slot,
            max_len=max_len,
            pad_slack=pad_slack,
            k_scale=scales(),
            v_scale=scales(),
            compute_dtype=dtype,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def _global_pages(self) -> int:
        if self.shard is not None and self.shard.dim == "pages":
            return self.shard.pages
        return self.k.shape[1]

    @property
    def num_pages(self) -> int:
        """Allocatable pages (the +1 trash page is excluded)."""
        return self._global_pages - 1

    @property
    def trash_page(self) -> int:
        """Reserved page index backing padded page-table entries."""
        return self._global_pages - 1

    @property
    def num_slots(self) -> int:
        return self.lengths.shape[0]

    @property
    def rows(self) -> int:
        """Rows in one slot's gathered view (pages_per_slot * page_size)."""
        return self.pages_per_slot * self.page_size

    @property
    def page_nbytes(self) -> int:
        """Device bytes one page costs across K and V (codes + scales in
        quantized mode) and all layers."""
        L, _, ps, H, D = self.k.shape
        per = L * ps * H * D * self.k.element_size()
        if self.quantized:
            per += L * ps * H * self.k_scale.element_size()
        return 2 * per

    def nbytes(self) -> int:
        total = self.k.nbytes + self.v.nbytes
        if self.quantized:
            total += self.k_scale.nbytes + self.v_scale.nbytes
        return total


def _dense_pages(cache: PagedKVCache, name: str,
                 idx: torch.Tensor) -> torch.Tensor:
    """Gather pool pages at `idx` (any index shape) of buffer `name`
    ("k" or "v") and materialize them densely: a plain gather for a float
    pool, gather + per-row dequantization for an int8 pool."""
    pages = pool_pages(cache, name, idx)
    if not cache.quantized:
        return pages
    return kv_dequantize_rows(pages, pool_pages(cache, name + "_scale", idx),
                              cache.compute_dtype)


def paged_slot_view(cache: PagedKVCache, table_row: torch.Tensor, slot):
    """One slot's pages gathered into `models/decode.py` layout:
    (k [L, 1, R, H, D], v [L, 1, R, H, D], length [1]), R =
    pages_per_slot * page_size, dequantized to `compute_dtype` on an int8
    pool. `slot` is a [1] (or 0-dim) index tensor, or an int. The views
    are copies: writing them leaves the pool alone."""
    L, _, ps, H, D = cache.k.shape
    P = cache.pages_per_slot
    ks = _dense_pages(cache, "k", table_row).reshape(L, 1, P * ps, H, D)
    vs = _dense_pages(cache, "v", table_row).reshape(L, 1, P * ps, H, D)
    idx = _slot_index(slot, cache.k.device)
    return ks, vs, cache.lengths.index_select(0, idx)


def paged_write_slot(cache: PagedKVCache, table_row: torch.Tensor,
                     slot, new_k: torch.Tensor, new_v: torch.Tensor,
                     advance, chunk: int) -> PagedKVCache:
    """Scatter the rows a prefill chunk wrote ([length, length + chunk)
    of the slot's [L, 1, R, H, D] view) back to their pages and advance
    the slot's length by `advance` REAL tokens (an int or a [1] tensor).
    Row granularity keeps the int8 mode safe: every written row is at or
    past `length`, hence in a PRIVATE page, so shared copy-on-write pages
    are never re-encoded. Reads no device value: a captured program."""
    L, _, ps, H, D = cache.k.shape
    R = cache.rows
    idx = _slot_index(slot, cache.k.device)
    length = cache.lengths.index_select(0, idx).long()
    rows = length + torch.arange(chunk, device=cache.k.device)
    pages = table_row.long()[rows // ps]
    offs = rows % ps
    win_k = new_k.reshape(L, R, H, D)[:, rows]
    win_v = new_v.reshape(L, R, H, D)[:, rows]
    _scatter_rows(cache, pages, offs, win_k, win_v)
    _advance(cache.lengths, idx, advance)
    return cache


def _scatter_rows(cache: PagedKVCache, pages: torch.Tensor,
                  offs: torch.Tensor, rows_k: torch.Tensor,
                  rows_v: torch.Tensor) -> None:
    """Scatter row payloads [L, n, H, D] at (page, offset) pairs,
    quantizing codes + per-row scales on an int8 pool. The shared tail
    of every pool write path. A page shard writes the pages it owns; the
    rest land in its dump page."""
    pages, offs = pages.long(), offs.long()
    if cache.shard is not None and cache.shard.dim == "pages":
        pages = _local_pages(cache.shard, pages)[0]
    if not cache.quantized:
        cache.k[:, pages, offs] = rows_k.to(cache.k.dtype)
        cache.v[:, pages, offs] = rows_v.to(cache.v.dtype)
        return
    ck, sk = kv_quantize_rows(rows_k)
    cv, sv = kv_quantize_rows(rows_v)
    cache.k[:, pages, offs] = ck
    cache.v[:, pages, offs] = cv
    cache.k_scale[:, pages, offs] = sk
    cache.v_scale[:, pages, offs] = sv


def paged_batch_view(cache: PagedKVCache, table: torch.Tensor):
    """All slots' pages gathered into the dense decode layout:
    (k [L, S, R, H, D], v [L, S, R, H, D]), dequantized to
    `compute_dtype` on an int8 pool. `table` is the full [S,
    pages_per_slot] page table."""
    L, _, ps, H, D = cache.k.shape
    S = cache.num_slots
    P = cache.pages_per_slot
    ks = _dense_pages(cache, "k", table).reshape(L, S, P * ps, H, D)
    vs = _dense_pages(cache, "v", table).reshape(L, S, P * ps, H, D)
    return ks, vs


def paged_append_rows(cache: PagedKVCache, table: torch.Tensor,
                      row_k: torch.Tensor, row_v: torch.Tensor,
                      live: torch.Tensor) -> PagedKVCache:
    """Write each slot's SINGLE new row ([L, S, H, D], the K/V of the
    token decode just produced, at view row `length`) to its page and
    advance live lanes' lengths by one. A live slot's current-length row
    always lies in a PRIVATE page, so no two live lanes collide; retired
    lanes' tables are all-trash, so their dead writes land in the trash
    page. The write half of both decode attention modes."""
    ps = cache.page_size
    row = cache.lengths.long()                            # [S] view row
    page_idx = (row // ps).clamp(max=cache.pages_per_slot - 1)
    page = table.long().gather(1, page_idx[:, None])[:, 0]
    _scatter_rows(cache, page, row % ps, row_k, row_v)
    cache.lengths.add_(live.to(torch.int32))
    return cache


def paged_append_batch(cache: PagedKVCache, table: torch.Tensor,
                       new_k: torch.Tensor, new_v: torch.Tensor,
                       live: torch.Tensor) -> PagedKVCache:
    """`paged_append_rows` for the dense-gather decode path, where the
    family forward returns whole updated [L, S, R, H, D] views: extract
    the one changed row per slot (view row `length`), then scatter."""
    slots = torch.arange(cache.num_slots, device=new_k.device)
    row = cache.lengths.long()
    return paged_append_rows(cache, table, new_k[:, slots, row],
                             new_v[:, slots, row], live)


def paged_append_window(cache: PagedKVCache, table: torch.Tensor,
                        win_k: torch.Tensor, win_v: torch.Tensor,
                        counts: torch.Tensor,
                        live: torch.Tensor) -> PagedKVCache:
    """Write each slot's next `counts[s]` rows from a fixed-width window
    ([L, S, W, H, D], view rows [length, length + W)) and advance live
    lanes' lengths by their count: the speculative-decoding commit. Rows
    at or past a slot's count, and every row of a dead lane, are routed
    to the trash page, so the scatter keeps one shape whatever the accept
    counts. Every written row is at or past `length`, hence in a PRIVATE
    page: shared copy-on-write pages are untouched."""
    ps = cache.page_size
    S, W = win_k.shape[1], win_k.shape[2]
    j = torch.arange(W, device=win_k.device)
    rows = cache.lengths.long()[:, None] + j                    # [S, W]
    valid = (j[None, :] < counts[:, None]) & live[:, None]
    page_idx = (rows // ps).clamp(max=cache.pages_per_slot - 1)
    pages = table.long().gather(1, page_idx)
    pages = torch.where(valid, pages, cache.trash_page)
    L, H, D = win_k.shape[0], win_k.shape[3], win_k.shape[4]
    _scatter_rows(cache, pages.reshape(S * W), (rows % ps).reshape(S * W),
                  win_k.reshape(L, S * W, H, D),
                  win_v.reshape(L, S * W, H, D))
    cache.lengths.add_(torch.where(live, counts, 0).to(torch.int32))
    return cache


def paged_admit_slot(cache: PagedKVCache, slot, reused_len) -> PagedKVCache:
    """Admit a request into `slot`: length starts at the reused prefix
    length (0 on a cold miss). Nothing is wiped — reused pages carry the
    prefix K/V, rows past `length` are masked until overwritten."""
    cache.lengths[slot] = reused_len
    return cache


# ---------------------------------------------------------------------------
# host-side page accounting: free list + prefix radix tree + allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Free list over the allocatable pages (the trash page never enters).

    Pure host bookkeeping — which physical page holds which bytes is
    entirely decided here and in `PrefixIndex`; the device only ever sees
    page indices as traced data."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Pop `n` free pages, or None (and no change) if short."""
        if n > len(self._free):
            return None
        taken = self._free[len(self._free) - n:]
        del self._free[len(self._free) - n:]
        return taken[::-1]

    def release(self, pages) -> None:
        self._free.extend(pages)


class _RadixNode:
    """One cached page: `key` is the page's token chunk (bytes of
    page_size int32 tokens), `page` its physical index. `refcount` counts
    live slots currently mapping the page; 0 means cached-but-unmapped
    (evictable once it is a leaf).

    `residency` is the hierarchical-KV state: "hbm" means `page` is a
    live pool page holding the chunk's K/V; "host" means the chunk's
    bytes were swapped out to the host tier (serving/host_tier.py) —
    `page` is -1, the node stays in the tree so the prefix still
    matches, and a later admission swaps the bytes back into a freshly
    reserved pool page. A host-resident node is always refcount-0 (a
    mapped node's page is pinned in HBM) and all of its children are
    host-resident too: eviction drains leaf-first, so residency along
    any root path is an HBM prefix followed by a host suffix."""

    __slots__ = ("key", "page", "children", "refcount", "last_used",
                 "parent", "residency")

    def __init__(self, key: bytes, page: int, parent: "_RadixNode | None"):
        self.key = key
        self.page = page
        self.children: dict[bytes, _RadixNode] = {}
        self.refcount = 0
        self.last_used = 0
        self.parent = parent
        self.residency = "hbm"


class PrefixIndex:
    """Radix tree over page-sized token chunks -> cached KV pages.

    Each edge consumes exactly `page_size` token IDs (reuse is
    page-granular: a prefix is reusable only in whole pages, which is
    also what makes the cached pages immutable — see the module
    docstring), so the tree IS the map from prompt prefixes to page
    lists. Nodes are LRU-stamped on every match/insert; eviction frees
    refcount-0 LEAVES oldest-first, which keeps every cached path
    contiguous from the root (an interior node is unevictable while any
    descendant survives, and a mapped page — refcount > 0 — is never
    evicted)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _RadixNode(b"", -1, None)
        self._tick = 0
        self.cached_pages = 0   # HBM-resident nodes (pool pages in the tree)
        self.mapped_pages = 0   # nodes with refcount > 0 (always HBM)
        self.host_pages = 0     # host-resident nodes (bytes in the host tier)
        # drop_host(node): the host tier forgets `node`'s swapped-out
        # bytes. Fired when a host-resident chunk is re-homed in HBM by a
        # fresh insert (adoption) or its naming path is destructively
        # evicted. None when no host tier is attached.
        self.drop_host: Callable[[Any], None] | None = None

    def _touch(self, node: _RadixNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    def _chunk(self, prompt: np.ndarray, i: int) -> bytes:
        ps = self.page_size
        return np.ascontiguousarray(
            prompt[i * ps:(i + 1) * ps], dtype=np.int32).tobytes()

    def match(self, prompt: np.ndarray) -> list[_RadixNode]:
        """Longest cached prefix of `prompt`, as the node path from the
        root, capped at (prompt_len - 1) // page_size pages so at least
        one prompt token always prefills (the first output token's
        logits have to come from somewhere)."""
        limit = (int(prompt.shape[0]) - 1) // self.page_size
        node, path = self.root, []
        for i in range(limit):
            child = node.children.get(self._chunk(prompt, i))
            if child is None:
                break
            path.append(child)
            node = child
        for n in path:
            self._touch(n)
        return path

    def acquire(self, nodes: list[_RadixNode]) -> None:
        for n in nodes:
            n.refcount += 1
            if n.refcount == 1:
                self.mapped_pages += 1

    def release(self, nodes: list[_RadixNode]) -> None:
        for n in nodes:
            n.refcount -= 1
            if n.refcount == 0:
                self.mapped_pages -= 1

    def insert(self, prompt: np.ndarray, pages: list[int],
               upto_pages: int) -> list[int]:
        """Cache prompt pages [0, upto_pages): walk/create the node path,
        adopting `pages[i]` for chunks not yet cached. Returns the pages
        NOT adopted (an equal chunk was cached concurrently by another
        request — the caller frees the duplicates)."""
        node, spare = self.root, []
        for i in range(upto_pages):
            key = self._chunk(prompt, i)
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, pages[i], node)
                node.children[key] = child
                self.cached_pages += 1
            elif child.residency == "host":
                # the chunk was swapped out while this request prefilled
                # its own copy — adopt the fresh HBM page (value-identical
                # bytes) and let the host tier drop the stale mirror
                self._adopt_host(child, pages[i])
            elif child.page != pages[i]:
                spare.append(pages[i])
            self._touch(child)
            node = child
        return spare

    def _adopt_host(self, node: _RadixNode, page: int) -> None:
        """Re-home a host-resident node in HBM at `page` (whose bytes
        must already hold the chunk's K/V) and drop the host mirror."""
        node.page = page
        node.residency = "hbm"
        self.host_pages -= 1
        self.cached_pages += 1
        if self.drop_host is not None:
            self.drop_host(node)

    def extend_path(self, prompt: np.ndarray, pages: list[int],
                    start: int, upto: int) -> list[_RadixNode]:
        """Walk/create nodes for chunks [start, upto) of `prompt`,
        adopting `pages[i]` for chunks not yet cached — the mid-flight
        half of `insert`, used by `PagedAllocator.publish_prompt` to
        share a RUNNING request's already-prefilled prompt pages (COW
        request forking). Stops at the first chunk already cached under
        a DIFFERENT page: past that point the caller's pages can't back
        the tree path, and the pages[:len(nodes)]-are-node-pages
        invariant of `PageAllocation` must hold for the extended node
        list. The first `start` chunks must already be the caller's
        mapped (refcount > 0, hence unevictable) path. Returned nodes
        are refcount-0 until the caller acquires them."""
        node = self.root
        for i in range(start):
            node = node.children[self._chunk(prompt, i)]
        out: list[_RadixNode] = []
        for i in range(start, upto):
            key = self._chunk(prompt, i)
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, pages[i], node)
                node.children[key] = child
                self.cached_pages += 1
            elif child.residency == "host":
                # same adoption as `insert`: the publisher's freshly
                # prefilled page re-homes the swapped-out chunk in HBM
                self._adopt_host(child, pages[i])
            elif child.page != pages[i]:
                break
            self._touch(child)
            out.append(child)
            node = child
        return out

    def evict_lru(self, n: int,
                  swap_out: "Callable[[Any], bool] | None" = None
                  ) -> list[int]:
        """Free exactly `n` pages, draining least-recently-used
        refcount-0 effective leaves (an effective leaf is an HBM node
        with no HBM descendant — host-resident children don't pin their
        parent, or a host tier would freeze eviction; draining one can
        turn its parent into the next candidate). Mapped pages
        (refcount > 0) are never touched. ALL-OR-NOTHING: if fewer than
        `n` pages are evictable the tree is left intact and [] returned
        — a failed admission must not cost the cache its reusable
        prefixes, and (key for a queue head that stays blocked for many
        engine steps) that case bails in O(1).

        `swap_out(node)` (the host tier's offer, while `node.page` still
        names the bytes) decides each victim's fate: True keeps the node
        in the tree as host-resident (page freed, bytes mirrored to host
        DRAM); False/None is the classic destructive eviction — the node
        detaches, and any host-resident subtree hanging under it loses
        its naming path, so those mirrors are dropped via `drop_host`.
        Either way exactly one HBM page per victim is freed.

        Why `cached - mapped` IS the evictable total: acquire/release
        always ref whole root-paths (`match` returns contiguous paths
        from the root), so refcounts are downward-closed — a refcount-0
        node can never have a mapped descendant, and every refcount-0
        subtree drains leaf-first (host-resident nodes are refcount-0 by
        construction and hold no HBM page, so they count in neither
        term). The sufficient case pays one DFS plus a min-heap of
        candidate leaves: O(tree + n log tree), once per actual eviction
        burst, never per blocked step."""
        if n <= 0 or self.cached_pages - self.mapped_pages < n:
            return []
        heap = []
        stack = [c for c in self.root.children.values()
                 if c.residency == "hbm"]
        while stack:
            node = stack.pop()
            hbm_children = [c for c in node.children.values()
                            if c.residency == "hbm"]
            if hbm_children:
                stack.extend(hbm_children)
            elif node.refcount == 0:
                heap.append((node.last_used, node.page, node))
        heapq.heapify(heap)
        freed: list[int] = []
        while len(freed) < n:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            freed.append(victim.page)
            self.cached_pages -= 1
            if swap_out is not None and swap_out(victim):
                victim.page = -1
                victim.residency = "host"
                self.host_pages += 1
            else:
                del parent.children[victim.key]
                victim.parent = None
                # every descendant of an effective leaf is host-resident;
                # their mirrors die with the path that named them
                drop_stack = list(victim.children.values())
                while drop_stack:
                    orphan = drop_stack.pop()
                    drop_stack.extend(orphan.children.values())
                    self.host_pages -= 1
                    if self.drop_host is not None:
                        self.drop_host(orphan)
            if parent is not self.root and parent.refcount == 0 \
                    and parent.residency == "hbm" \
                    and not any(c.residency == "hbm"
                                for c in parent.children.values()):
                heapq.heappush(heap, (parent.last_used, parent.page, parent))
        return freed

    def residency_probe(self, prompt: np.ndarray) -> tuple[int, int]:
        """(hbm_pages, host_pages) along the longest cached prefix of
        `prompt`, WITHOUT touching LRU stamps — the pod router's
        placement probe (scoring a worker must not make its cache look
        hot)."""
        limit = (int(prompt.shape[0]) - 1) // self.page_size
        node, hbm, host = self.root, 0, 0
        for i in range(limit):
            child = node.children.get(self._chunk(prompt, i))
            if child is None:
                break
            if child.residency == "hbm":
                hbm += 1
            else:
                host += 1
            node = child
        return hbm, host


@dataclasses.dataclass
class PageAllocation:
    """One admitted request's page mapping: `pages` is the ordered table
    row prefix (cached prefix pages first, then private pages); `nodes`
    are the mapped radix nodes backing pages[:len(nodes)].

    `swap_ins` lists (node, page) pairs whose chunks matched
    host-resident: the allocator already reserved `page` and re-homed
    the node, but the BYTES are still in the host tier — the engine must
    install them (jitted PageTransport install) before the slot's admit
    program runs, or the reused prefix serves garbage."""

    reused_len: int
    nodes: list
    pages: list[int]
    swap_ins: list | None = None


class PagedAllocator:
    """Admission-time page allocation with prefix reuse.

    The scheduler calls `allocate()` before admitting a queued request
    (None = not enough pages yet, the request stays queued — transient
    pressure, relieved as running slots retire) and `release()` when a
    slot retires or is cancelled. Worst-case pages are reserved at
    admission, so a running request can never hit pool pressure
    mid-flight and never needs preemption."""

    def __init__(
        self,
        page_size: int,
        num_pages: int,
        pad_slack: int = 0,
        prefix_cache: bool = True,
        on_evict: Callable[[int], None] | None = None,
        on_unmap: Callable[[int], None] | None = None,
    ):
        self.page_size = page_size
        self.pad_slack = pad_slack
        self.prefix_cache = prefix_cache
        self.pool = PagePool(num_pages)
        self.index = PrefixIndex(page_size)
        self.on_evict = on_evict
        self.on_unmap = on_unmap
        # admission-hold hook: hold_admission(request) -> True keeps the
        # request queued even when pages ARE available. The engine uses
        # it for COW forks: a fork child admitted before its parent's
        # prompt pages are published would cold-prefill the very prompt
        # it was forked to share — waiting the few steps until the
        # parent's prefill publishes them is what makes an n-way fan-out
        # cost ONE prefill. Same no-skip-ahead semantics as a pages-tight
        # head: the queue waits behind it.
        self.hold_admission: Callable[[Any], bool] | None = None
        # host-tier hooks (engine-wired when EngineConfig.host_tier_bytes
        # > 0, else None and eviction stays destructive):
        #   swap_out(node) -> bool — offer an eviction victim to the host
        #     tier while node.page still names its bytes; True = accepted
        #     (node goes host-resident), False = tier full, evict
        #     destructively.
        #   swap_stall(need) -> bool — True when the tier WOULD accept
        #     victims but its bounded swap-out queue can't absorb `need`
        #     more pages right now: the admission stalls (request stays
        #     queued, decode never blocks) instead of either blocking on
        #     the queue or destroying prefixes the tier has room for.
        self.swap_out: Callable[[Any], bool] | None = None
        self.swap_stall: Callable[[int], bool] | None = None
        # running totals for host-side (model-free) observability and
        # tests. The engine's registry counters are booked separately:
        # evictions reach it through on_evict, admission outcomes through
        # Engine._run_admit reading the same PageAllocation.
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0
        self.evictions = 0

    @property
    def pages_free(self) -> int:
        return self.pool.free_count

    @property
    def pages_in_use(self) -> int:
        """Allocated to live slots OR cached in the prefix tree."""
        return self.pool.used_count

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages for one request: every prompt+generated row
        plus the chunk-padding spill, in whole pages."""
        rows = prompt_len + max_new_tokens + self.pad_slack
        return -(-rows // self.page_size)

    def allocate(self, request) -> PageAllocation | None:
        """Match the longest cached prefix and reserve the remaining
        private pages, evicting LRU refcount-0 pages under pressure.
        None = insufficient pages even with eviction (keep queued) — and
        in that case NOTHING was evicted (evict_lru is all-or-nothing),
        so a too-big queue head can't strip the cache while it waits."""
        if self.hold_admission is not None and self.hold_admission(request):
            return None
        path = (self.index.match(request.prompt)
                if self.prefix_cache else [])
        # residency along a matched path is an HBM prefix then a host
        # suffix (leaf-first eviction — see _RadixNode); the host suffix
        # needs fresh pool pages to swap back into, reserved here with
        # the same worst-case discipline as private pages
        n_hbm = 0
        while n_hbm < len(path) and path[n_hbm].residency == "hbm":
            n_hbm += 1
        hbm_nodes, host_nodes = path[:n_hbm], path[n_hbm:]
        n_total = self.pages_needed(request.prompt_len,
                                    request.max_new_tokens)
        n_extra = n_total - n_hbm   # swap-in pages + private pages
        # acquire BEFORE evicting: matched nodes are refcount-0 until
        # mapped, and eviction must never free a page we are about to
        # use. Host nodes can't be acquired yet (mapped_pages counts HBM
        # pages) but are eviction-proof anyway: eviction only drops a
        # host subtree under a destructively evicted HBM ancestor, and
        # every HBM ancestor of `host_nodes` is in `hbm_nodes` — pinned.
        self.index.acquire(hbm_nodes)
        try:
            extra = self.pool.alloc(n_extra)
            if extra is None:
                need = n_extra - self.pool.free_count
                if self.swap_stall is not None and self.swap_stall(need):
                    self.index.release(hbm_nodes)
                    return None
                freed = self.index.evict_lru(need, swap_out=self.swap_out)
                if freed:
                    self.evictions += len(freed)
                    self.pool.release(freed)
                    if self.on_evict is not None:
                        self.on_evict(len(freed))
                extra = self.pool.alloc(n_extra)
            if extra is None:
                self.index.release(hbm_nodes)
                return None
            # re-home the host suffix: each node takes a reserved page
            # NOW (bookkeeping only — the caller installs the bytes
            # before the slot's first device program reads them)
            swap_ins = []
            for node, page in zip(host_nodes, extra):
                node.page = page
                node.residency = "hbm"
                self.index.host_pages -= 1
                self.index.cached_pages += 1
                swap_ins.append((node, page))
            self.index.acquire(host_nodes)
        except BaseException:
            # on_evict / swap_stall are caller-supplied callbacks: if
            # one raises mid-allocate the matched nodes' refcounts must
            # not leak (they would pin their whole root paths
            # unevictable forever — the ATP201 self-lint finding this
            # handler exists for)
            self.index.release(hbm_nodes)
            raise
        private = extra[len(host_nodes):]
        self.lookups += 1
        if path:
            self.hits += 1
            self.tokens_reused += len(path) * self.page_size
        # ownership of the acquired refcounts transfers to the returned
        # allocation here (hbm prefix + re-homed host suffix == path)
        return PageAllocation(
            reused_len=len(path) * self.page_size,
            nodes=hbm_nodes + host_nodes,
            pages=[n.page for n in hbm_nodes + host_nodes] + private,
            swap_ins=swap_ins or None,
        )

    def rollback(self, alloc: PageAllocation) -> None:
        """Undo an `allocate()` whose slot attachment never happened (the
        pod router's adopt race): shared nodes drop their refcount,
        private pages return to the free list, nothing is cached. The
        inverse of allocate lives HERE so the [node pages | private]
        layout of PageAllocation.pages stays a single-module invariant.
        Pending swap-ins revert to host residency — their bytes were
        never installed, so the reserved pages return to the pool and the
        host tier keeps the mirror."""
        self.index.release(alloc.nodes)
        self.pool.release(alloc.pages[len(alloc.nodes):])
        for node, page in (alloc.swap_ins or ()):
            node.page = -1
            node.residency = "host"
            self.index.host_pages += 1
            self.index.cached_pages -= 1
            self.pool.release([page])
        self.lookups -= 1
        if alloc.nodes:
            self.hits -= 1
            self.tokens_reused -= alloc.reused_len

    def publish_prompt(self, slot) -> int:
        """Insert a RUNNING slot's already-prefilled FULL prompt pages
        into the prefix tree NOW, instead of waiting for retirement —
        the mechanism behind engine-level COW request forking: a fork of
        this request admitted later maps these pages instead of
        re-prefilling the prompt. Only pages every row of which holds
        final real-token K/V are published (prefill writes always land
        at or past the slot's current length, so a full page below
        `prompt_done` is immutable from here on — the same invariant
        retirement-inserted pages rely on). The published nodes are
        acquired into the slot's own allocation, so they are mapped
        (unevictable) for as long as the slot runs, and `release()` later
        drops them exactly like an admission-time prefix hit. Returns
        the number of prompt pages now shared. Idempotent; no-op when
        the prefix cache is off."""
        if not self.prefix_cache:
            return 0
        alloc, req = slot.alloc, slot.request
        if alloc is None:
            return 0
        full = min(slot.prompt_done, req.prompt_len) // self.page_size
        n_cached = len(alloc.nodes)
        if full <= n_cached:
            return n_cached
        new_nodes = self.index.extend_path(req.prompt, alloc.pages,
                                           n_cached, full)
        self.index.acquire(new_nodes)
        alloc.nodes.extend(new_nodes)
        return len(alloc.nodes)

    def release(self, slot, finished: bool) -> None:
        """Return a retiring slot's pages: shared nodes drop a refcount
        (other sharers keep decoding untouched); on a normal finish the
        FULL prompt pages are inserted into the tree (content intact —
        this is the 'release to the tree, not wipe' half of reuse); the
        rest — generation pages, the partial last prompt page, and pages
        whose chunks a concurrent request cached first — go back to the
        free list. `finished=False` (cancel) caches nothing: a
        mid-prefill page may hold garbage.

        The insertable range is additionally capped at the slot's
        PREFILLED prompt, not the whole prompt: `finish_early` can
        retire a slot whose prefill is still mid-flight (a server-side
        stop decision), and inserting pages past `prompt_done` would
        cache never-written garbage KV that a later prefix hit serves
        as real prompt state — silent corruption, surfaced while
        building the ATP2xx/sanitizer audit and pinned model-free in
        test_paged_cache."""
        alloc, req = slot.alloc, slot.request
        self.index.release(alloc.nodes)
        n_cached = len(alloc.nodes)
        full = min(req.prompt_len, slot.prompt_done) // self.page_size \
            if (finished and self.prefix_cache) else n_cached
        spare = (self.index.insert(req.prompt, alloc.pages, full)
                 if full > n_cached else [])
        self.pool.release(spare + alloc.pages[full:])
        if self.on_unmap is not None:
            self.on_unmap(slot.index)
