"""Serving-state sanitizer (a copy of the engine half of
`accelerate_tpu/serving/sanitizer.py`; the pod router's joins come with
the pod slice).

Static analysis proves per-function acquire/release discipline; what it
CANNOT see is whether the cross-structure books still agree at runtime —
the page free list vs the radix tree vs the slot allocations vs the
device page tables vs the scheduler's tenant queues. The sanitizer
validates exactly those joins after every engine step:

- **page conservation**: every allocatable page is in exactly one place
  — the free list, the radix tree, or some slot's private allocation;
  the trash page is in none of them; nothing is double-owned; with a
  host tier on, host-resident radix nodes hold no HBM page at all but
  must each have a live mirror entry in the tier (and vice versa), host
  residency is downward-closed (a host node's children are all host),
  the tier stays inside its byte budget, and its drain queue inside its
  bound;
- **refcount correctness**: each radix node's refcount equals the number
  of live slot allocations mapping it, refcounts are downward-closed
  along root paths (a refcount-0 node never has a mapped descendant —
  the invariant `evict_lru`'s O(1) bail relies on), and the
  `cached_pages`/`mapped_pages` running counters match the tree;
- **table discipline**: a slot's device page-table row is exactly its
  allocation followed by trash padding; idle lanes are all-trash (a
  stale row is how a retired lane's masked writes corrupt a reallocated
  page);
- **length bounds**: a live slot's decode length stays within the rows
  its allocation reserved (and a speculative engine's draft lengths
  match the host-tracked draft progress for prefilling lanes);
- **scheduler books**: queued requests are QUEUED, running slots hold
  RUNNING requests, per-tenant queues/deficits/tier rings stay aligned
  with the tenant table.

All host-side: no program changes, no extra captures (the tests pin
the capture counts flat with the sanitizer on). Enabled by
`EngineConfig(sanitize=True)`; the port reads no environment variable,
so None means off. Violations raise :class:`SanitizerViolation` naming
the broken invariant with enough detail to act on. The only device
reads are the per-slot lengths (target and draft), copied to the host
once per check.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .scheduler import RequestStatus, SlotState

__all__ = ["SanitizerViolation", "resolve_sanitize", "check_engine"]


class SanitizerViolation(RuntimeError):
    """One broken cross-structure invariant. `check` is the stable
    invariant name (page-conservation, refcount, table, lengths,
    scheduler-books); `details` is a JSON-safe dict."""

    def __init__(self, check: str, message: str,
                 details: dict | None = None):
        self.check = check
        self.details = details or {}
        detail_txt = ""
        if details:
            rendered = ", ".join(f"{k}={v!r}" for k, v in details.items())
            detail_txt = f" ({rendered})"
        super().__init__(f"serving-state sanitizer: [{check}] "
                         f"{message}{detail_txt}")


def resolve_sanitize(setting: Any) -> bool:
    """EngineConfig.sanitize -> bool; None is off (the reference's None
    defers to its environment variable, which the port does not read)."""
    return bool(setting) if setting is not None else False


def _fail(check: str, message: str, **details) -> None:
    raise SanitizerViolation(check, message, details)


def _walk_tree(index) -> list:
    """[(node, parent)] over the radix tree, root excluded."""
    out = []
    stack = [(child, index.root)
             for child in index.root.children.values()]
    while stack:
        node, parent = stack.pop()
        out.append((node, parent))
        stack.extend((c, node) for c in node.children.values())
    return out


def check_engine(engine) -> None:
    """Validate one Engine's cross-structure invariants; raises
    :class:`SanitizerViolation` on the first broken one."""
    alloc = engine.allocator
    pool, index = alloc.pool, alloc.index
    num_pages = pool.num_pages
    trash = engine.cache.trash_page
    sched = engine.scheduler

    # -- page conservation ---------------------------------------------------
    free = list(pool._free)
    free_set = set(free)
    if len(free_set) != len(free):
        _fail("page-conservation", "free list holds duplicate pages",
              duplicates=sorted(p for p in free_set
                                if free.count(p) > 1))
    bad = [p for p in free_set if not (0 <= p < num_pages)]
    if bad:
        _fail("page-conservation",
              "free list holds out-of-range pages (the trash page must "
              "never be allocatable)", pages=sorted(bad), trash=trash)
    tree_nodes = _walk_tree(index)
    tree_pages: dict = {}
    host_nodes = []
    for node, parent in tree_nodes:
        if getattr(node, "residency", "hbm") == "host":
            host_nodes.append(node)
            if node.page != -1:
                _fail("page-conservation",
                      "a host-resident radix node still names an HBM page",
                      page=node.page)
            if node.refcount != 0:
                _fail("page-conservation",
                      "a host-resident radix node is mapped by a slot "
                      "(swap-in must re-home before acquire)",
                      refcount=node.refcount)
            if any(getattr(c, "residency", "hbm") == "hbm"
                   for c in node.children.values()):
                _fail("page-conservation",
                      "a host-resident radix node has an HBM child "
                      "(residency must be a suffix property — eviction "
                      "drains leaf-first)")
            continue
        if parent is not index.root and \
                getattr(parent, "residency", "hbm") == "host":
            _fail("page-conservation",
                  "an HBM radix node hangs under a host-resident parent "
                  "(residency must be a suffix property)",
                  page=node.page)
        if node.page in tree_pages:
            _fail("page-conservation",
                  "one physical page backs two radix nodes",
                  page=node.page)
        if not (0 <= node.page < num_pages):
            _fail("page-conservation", "radix node holds an out-of-range "
                  "page", page=node.page)
        tree_pages[node.page] = node
    host_tier = getattr(engine, "_host_tier", None)
    if host_nodes and host_tier is None:
        _fail("page-conservation",
              "host-resident radix nodes exist but the engine has no "
              "host tier", host_nodes=len(host_nodes))
    if host_tier is not None:
        if index.host_pages != len(host_nodes):
            _fail("page-conservation",
                  "host_pages counter disagrees with the tree",
                  counter=index.host_pages, tree=len(host_nodes))
        entry_nodes = set(map(id, host_tier._entries))
        missing = [n for n in host_nodes if id(n) not in entry_nodes]
        if missing:
            _fail("page-conservation",
                  "host-resident radix nodes lack a host-tier mirror "
                  "entry (their bytes are gone — a hit would install "
                  "garbage)", nodes=len(missing))
        if len(host_tier._entries) != len(host_nodes):
            _fail("page-conservation",
                  "host-tier mirror entries outlive their radix nodes "
                  "(the tier's budget leaks)",
                  entries=len(host_tier._entries),
                  host_nodes=len(host_nodes))
        if host_tier.pages_in_use > host_tier.capacity_pages:
            _fail("page-conservation",
                  "host tier exceeded its byte budget",
                  pages_in_use=host_tier.pages_in_use,
                  capacity_pages=host_tier.capacity_pages)
        if host_tier.queue_len() > host_tier.queue_bound:
            _fail("page-conservation",
                  "host-tier drain queue exceeded its bound "
                  "(backpressure is not reaching admission)",
                  queue_len=host_tier.queue_len(),
                  bound=host_tier.queue_bound)
    slot_allocs = [(s, s.alloc) for s in sched.slots if s.alloc is not None]
    private_owner: dict = {}
    for slot, a in slot_allocs:
        node_pages = [n.page for n in a.nodes]
        if a.pages[:len(a.nodes)] != node_pages:
            _fail("page-conservation",
                  "a slot allocation's leading pages disagree with its "
                  "mapped radix nodes", slot=slot.index,
                  pages=a.pages[:len(a.nodes)], node_pages=node_pages)
        for p in a.pages[len(a.nodes):]:
            if p in private_owner:
                _fail("page-conservation",
                      "one private page is owned by two slots (COW "
                      "isolation broken)", page=p,
                      slots=[private_owner[p], slot.index])
            if p in tree_pages:
                _fail("page-conservation",
                      "a slot's PRIVATE page is simultaneously cached in "
                      "the radix tree", page=p, slot=slot.index)
            if p in free_set:
                _fail("page-conservation",
                      "a slot's private page is also on the free list",
                      page=p, slot=slot.index)
            private_owner[p] = slot.index
    overlap = free_set & set(tree_pages)
    if overlap:
        _fail("page-conservation",
              "pages are both free and cached in the radix tree",
              pages=sorted(overlap))
    accounted = len(free_set) + len(tree_pages) + len(private_owner)
    if accounted != num_pages:
        _fail("page-conservation",
              "pages lost or double-counted: free + cached + private != "
              "pool size", free=len(free_set), cached=len(tree_pages),
              private=len(private_owner), pool=num_pages)

    # -- refcounts -----------------------------------------------------------
    refcounts: dict = {}
    for slot, a in slot_allocs:
        for n in a.nodes:
            refcounts[id(n)] = refcounts.get(id(n), 0) + 1
    mapped = 0
    for node, parent in tree_nodes:
        want = refcounts.get(id(node), 0)
        if node.refcount != want:
            _fail("refcount",
                  "a radix node's refcount disagrees with the live slot "
                  "allocations mapping it", page=node.page,
                  refcount=node.refcount, mapped_by_slots=want)
        if node.refcount > 0:
            mapped += 1
            if parent is not index.root and parent.refcount == 0:
                _fail("refcount",
                      "refcounts are not downward-closed: a mapped node "
                      "hangs under a refcount-0 parent (evict_lru's "
                      "accounting would evict a mapped page)",
                      page=node.page, parent_page=parent.page)
    if index.cached_pages != len(tree_pages):
        _fail("refcount", "cached_pages counter disagrees with the tree",
              counter=index.cached_pages, tree=len(tree_pages))
    if index.mapped_pages != mapped:
        _fail("refcount", "mapped_pages counter disagrees with the tree",
              counter=index.mapped_pages, tree=mapped)

    # -- device page tables --------------------------------------------------
    table = engine._table
    for slot in sched.slots:
        row = table[slot.index]
        if slot.alloc is not None:
            a = slot.alloc
            if list(row[:len(a.pages)]) != list(a.pages):
                _fail("table",
                      "a live slot's device table row disagrees with its "
                      "allocation", slot=slot.index,
                      row=[int(x) for x in row[:len(a.pages)]],
                      alloc=list(a.pages))
            tail = row[len(a.pages):]
        else:
            tail = row
        if not np.all(tail == trash):
            _fail("table",
                  "rows past a slot's allocation (or an idle slot's whole "
                  "row) must be trash-padded — a stale entry lets masked "
                  "ride-along writes land in someone else's page",
                  slot=slot.index,
                  row=[int(x) for x in np.asarray(row)])

    # -- length bounds -------------------------------------------------------
    lengths = engine.cache.lengths.cpu().numpy()
    ps = engine.cache.page_size
    for slot in sched.slots:
        if slot.alloc is None or slot.request is None:
            continue
        cap = len(slot.alloc.pages) * ps
        length = int(lengths[slot.index])
        if not (0 <= length <= cap):
            _fail("lengths",
                  "a live slot's decode length escaped the rows its "
                  "allocation reserved", slot=slot.index, length=length,
                  reserved_rows=cap)
    if getattr(engine, "_spec", False):
        dlengths = engine._draft_cache.lengths.cpu().numpy()
        for slot in sched.slots:
            if slot.request is None:
                continue
            if slot.state is SlotState.PREFILL:
                if int(dlengths[slot.index]) != slot.draft_done:
                    _fail("lengths",
                          "a prefilling slot's draft cache length "
                          "disagrees with its host-tracked draft progress "
                          "(the catch-up corruption class)",
                          slot=slot.index,
                          draft_len=int(dlengths[slot.index]),
                          draft_done=slot.draft_done)

    # -- scheduler books -----------------------------------------------------
    depth = 0
    for name, q in sched._queues.items():
        depth += len(q)
        for r in q:
            if r.status is not RequestStatus.QUEUED:
                _fail("scheduler-books",
                      "a queued request is not in QUEUED state",
                      tenant=name, request_id=r.request_id,
                      status=r.status.value)
            if r.tenant != name:
                _fail("scheduler-books",
                      "a request sits in another tenant's queue",
                      queue=name, tenant=r.tenant,
                      request_id=r.request_id)
    if depth != sched.queue_depth:
        _fail("scheduler-books", "queue_depth disagrees with the queues",
              computed=depth, reported=sched.queue_depth)
    for slot in sched.slots:
        if slot.request is not None:
            if slot.state is SlotState.IDLE:
                _fail("scheduler-books",
                      "an IDLE slot still holds a request",
                      slot=slot.index,
                      request_id=slot.request.request_id)
            if slot.request.status is not RequestStatus.RUNNING:
                _fail("scheduler-books",
                      "a slot's request is not RUNNING",
                      slot=slot.index,
                      request_id=slot.request.request_id,
                      status=slot.request.status.value)
            if slot.prompt_done > slot.request.prompt_len:
                _fail("scheduler-books",
                      "prefill progress exceeds the prompt",
                      slot=slot.index, prompt_done=slot.prompt_done,
                      prompt_len=slot.request.prompt_len)
        elif slot.state is not SlotState.IDLE:
            _fail("scheduler-books", "an empty slot is not IDLE",
                  slot=slot.index, state=slot.state.value)
    keys = set(sched.tenants)
    if set(sched._queues) != keys or set(sched._deficit) != keys:
        _fail("scheduler-books",
              "tenant table / queues / DRR deficits diverged",
              tenants=sorted(keys), queues=sorted(sched._queues),
              deficits=sorted(sched._deficit))
    ring_members = [t for ring in sched._rr.values() for t in ring]
    if sorted(ring_members) != sorted(keys):
        _fail("scheduler-books",
              "tier rings do not cover each tenant exactly once",
              rings=ring_members, tenants=sorted(keys))
