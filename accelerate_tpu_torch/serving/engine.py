"""Continuous-batching serving engine (port of
`accelerate_tpu/serving/engine.py`): many requests, one fixed-shape
decode step.

The engine runs three device steps whatever the request mix:

- admit:   set a slot's length to the reused prefix length (0 on a cold
           miss), install the request's sampling key and temperature;
- prefill: one fixed-size prompt chunk into one slot (prompts pad to the
           chunk; lengths advance by real tokens only);
- decode:  one token for EVERY slot in one batched forward with per-slot
           lengths and positions. Retired or prefilling slots ride along
           as masked lanes.

The KV store is the paged pool of `serving/cache.py`. Page tables are
host-side numpy ([slots, pages_per_slot] int32, trash-padded), uploaded
with each step. At admission the longest cached prompt prefix is mapped
copy-on-write from the radix tree, so prefill runs only on the uncached
suffix.

Decode attention has two modes (`EngineConfig.paged_attention`): the
paged-decode kernel (`ops/paged_attention.py`, CUDA on the card) walks
each slot's live pages in place and hands back the new K/V rows; the
dense-gather reference path gathers every slot's pages into one [L, S,
R, H, D] view first and runs the same forward with per-slot lengths.

Sampling is per slot: a request's key is installed at admit and the
token at position p is drawn with Gumbel noise hashed from (key, p)
(`models/decode.py`), so a request's stream never depends on how
prefills and decodes interleave. Temperature is per slot too (greedy and
sampled requests share the step). Each decode step ends in one read of
the [S] token vector (and its logprobs) to the host; a finished prefill
reads one token.

The port updates the pool and the per-slot state in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.decode import derive_key, sample_token, stream_key
from ..ops.paged_attention import PagedDecodeMeta, PagedKV
from ..telemetry.registry import MetricsRegistry
from .cache import (
    PagedAllocator,
    PagedKVCache,
    paged_admit_slot,
    paged_append_batch,
    paged_append_rows,
    paged_batch_view,
    paged_slot_view,
    paged_write_slot,
)
from .metrics import ServingMetrics
from .scheduler import Request, Scheduler, Slot, SlotState

__all__ = ["Engine", "EngineConfig"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs, the reference's fields. `max_len` bounds
    prompt+generated per slot (admission rejects longer requests);
    `prefill_chunk` trades prefill efficiency against how long a long
    prompt may stall decode (one chunk).

    Fields whose machinery the port has not reached yet raise
    NotImplementedError when set (see `_UNPORTED`); the port reads none
    of the reference's environment variables."""

    num_slots: int = 4
    max_len: int = 512
    prefill_chunk: int = 32
    max_queue: int = 64
    cache_dtype: Any = torch.bfloat16
    seed: int = 0
    # the reference's buffer donation; the port updates the pool in
    # place whatever the value
    donate: bool = True
    # paged KV pool: pages of `page_size` tokens allocated at admission;
    # `num_pages` sizes the pool (None = num_slots * pages_per_slot);
    # `prefix_cache=False` makes every admission a cold miss
    page_size: int = 16
    num_pages: int | None = None
    prefix_cache: bool = True
    host_tier_bytes: int = 0
    # decode attention op. True: the paged-decode kernel walks the page
    # table inside attention (on a CPU engine its plain version runs).
    # False: the dense-gather reference path. "auto": the kernel on a
    # CUDA engine, the dense path on the CPU.
    paged_attention: Any = "auto"
    # KV pool storage: None stores pages in `cache_dtype`; "int8" stores
    # int8 codes + per-row-per-head bf16 scales (half the bytes per page)
    kv_dtype: Any = None
    speculative: Any = None
    draft_k: int = 4
    # multi-tenant scheduling: scheduler.TenantSpec entries (priority
    # tiers, DRR weights, TTFT SLOs); None = one FIFO tenant
    tenants: Any = None
    metrics_port: int | None = None
    watchdog_timeout_s: float | None = None
    cost_sample_every: int | None = None
    incident_dir: str | None = None
    strict: str | None = None
    contracts: Any = None
    sanitize: Any = None
    mesh: Any = None


# field -> (is it set?, the part of the port that will bring it)
_UNPORTED = {
    "speculative": (lambda v: v is not None, "speculative decoding"),
    "host_tier_bytes": (lambda v: v > 0, "the host KV tier"),
    "mesh": (lambda v: v is not None, "sharded (pod) serving"),
    "strict": (lambda v: v is not None, "the static-analysis audits"),
    "contracts": (lambda v: v is not None, "the static-analysis audits"),
    "metrics_port": (lambda v: v is not None, "the telemetry exporters"),
    "watchdog_timeout_s": (lambda v: v is not None,
                           "the stall watchdog"),
    "cost_sample_every": (lambda v: v is not None,
                          "the device-cost table"),
    "incident_dir": (lambda v: v is not None, "incident bundles"),
    "sanitize": (lambda v: bool(v), "the serving-state sanitizer"),
}


def _check_ported(ec: EngineConfig) -> None:
    for name, (is_set, part) in _UNPORTED.items():
        if is_set(getattr(ec, name)):
            raise NotImplementedError(
                f"EngineConfig.{name} needs {part}, which a later slice of "
                "the PyTorch port brings; leave it at its default")


def _cache_spec(config) -> tuple[int, int, int]:
    """(num_layers, num_kv_heads, head_dim) from any family config."""
    kv = getattr(config, "num_key_value_heads", None)
    if kv is None:
        kv = config.num_attention_heads
    return config.num_hidden_layers, kv, config.head_dim


def _first_tensor(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class Engine:
    """Front-end: `submit()` -> request handle, `stream()` for tokens as
    they land, `cancel()`/`finish()`/`fork()`, `step()`/`run_until_idle()`
    to drive. `family` is a model module with the uniform decode contract
    (`forward(config, params, ids, positions=..., kv_caches=...) ->
    (logits, new_caches)`) or that forward callable. The engine runs on
    `device` (CUDA unless "cpu"), where `params` must already live."""

    def __init__(self, family, config, params,
                 engine_config: EngineConfig | None = None, device=None,
                 clock=time.monotonic):
        self.config = config
        self.params = params
        self.engine_config = ec = engine_config or EngineConfig()
        _check_ported(ec)
        self.device = dev = resolve_device(device)
        p_dev = _first_tensor(params).device
        if p_dev.type != dev.type:
            raise ValueError(f"params live on {p_dev}, the engine runs on "
                             f"{dev}")
        self._forward = family if callable(family) else family.forward
        self._clock = clock
        self._use_paged_kernel = (dev.type == "cuda"
                                  if ec.paged_attention == "auto"
                                  else bool(ec.paged_attention))

        num_layers, num_kv, head_dim = _cache_spec(config)
        # chunk padding can spill chunk-1 rows past max_len
        self._pad_slack = ec.prefill_chunk
        self.cache = PagedKVCache.create(
            num_layers, ec.num_slots, ec.max_len, num_kv, head_dim,
            dtype=ec.cache_dtype, page_size=ec.page_size,
            pad_slack=self._pad_slack, num_pages=ec.num_pages,
            kv_dtype=ec.kv_dtype, device=dev,
        )
        self.registry = MetricsRegistry()
        self.metrics = ServingMetrics(registry=self.registry)
        self.allocator = PagedAllocator(
            page_size=ec.page_size,
            num_pages=self.cache.num_pages,
            pad_slack=self._pad_slack,
            prefix_cache=ec.prefix_cache,
            on_evict=lambda n: self.metrics.note_page_evictions(n),
            on_unmap=self._unmap_slot,
        )
        # COW forking: parent_id -> parent handle (entries drop as
        # parents reach a terminal state)
        self._fork_parents: dict[int, Request] = {}
        # in-flight prefill dedup: requests held behind a leader's
        # prefill, so each follower counts one dedup hit
        self._dedup_held: set[int] = set()
        if ec.prefix_cache:
            self.allocator.hold_admission = self._hold_admission
        self.scheduler = Scheduler(ec.num_slots, ec.max_len,
                                   max_queue=ec.max_queue, clock=clock,
                                   allocator=self.allocator,
                                   tenants=ec.tenants,
                                   prefill_chunk=ec.prefill_chunk)
        # host-side page tables, one row per slot, padded with the trash
        # page: idle/retired lanes read (and dead-write) only trash
        self._table = np.full(
            (ec.num_slots, self.cache.pages_per_slot),
            self.cache.trash_page, np.int32)
        self._tokens = torch.zeros((ec.num_slots,), dtype=torch.int32,
                                   device=dev)
        self._slot_keys = torch.zeros((ec.num_slots, 2), dtype=torch.int64,
                                      device=dev)
        self._temps = torch.zeros((ec.num_slots,), dtype=torch.float32,
                                  device=dev)
        # admission hook: on_admit(slot, request) at the end of every
        # admission, after the slot's page table and state are installed
        self.on_admit: Any = None

    # -- device steps ------------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On CUDA it is staged in
        pinned memory and copied asynchronously: an upload never waits
        for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _sample(self, logits, keys, positions, temps):
        """Next tokens [B] int32 and their logprobs [B] from f32 logits
        [B, V]: argmax where temp == 0, else Gumbel-max over logits/temp
        keyed by (key, position). The logprob is under the UNSCALED model
        distribution (temperature-free, so greedy and sampled scores are
        comparable)."""
        greedy = torch.argmax(logits, dim=-1)
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        sampled = sample_token(scaled[:, None, :], keys, 1.0, positions)
        tok = torch.where(temps > 0.0, sampled, greedy)
        lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
        return tok.to(torch.int32), lp

    def _admit(self, slot: int, key: tuple[int, int], temp: float,
               reused_len: int) -> None:
        # a prefix hit starts the slot's length at the reused prefix
        # (those pages already hold its K/V); a miss starts at zero
        paged_admit_slot(self.cache, slot, reused_len)
        self._slot_keys[slot, 0] = key[0]
        self._slot_keys[slot, 1] = key[1]
        self._temps[slot] = temp

    def _prefill(self, slot: int, table_row: np.ndarray, ids: np.ndarray,
                 real_len: int) -> torch.Tensor:
        """One prompt chunk into `slot`; samples the token after the
        chunk into the slot's token register and returns its logprob."""
        chunk = self.engine_config.prefill_chunk
        cache = self.cache
        row = self._upload(table_row)
        ids = self._upload(ids)
        ks, vs, length = paged_slot_view(cache, row, slot)
        positions = (length + torch.arange(chunk, device=self.device))[None]
        logits, (nk, nv, _) = self._forward(
            self.config, self.params, ids[None, :], positions=positions,
            kv_caches=(ks, vs, length))
        paged_write_slot(cache, row, slot, nk, nv, real_len, chunk)
        last = logits[0, real_len - 1].float()
        tok, lp = self._sample(last[None], self._slot_keys[slot][None],
                               (length + real_len)[None],
                               self._temps[slot][None])
        self._tokens[slot] = tok[0]
        return lp[0]

    def _decode_forward(self, use_kernel: bool, table: torch.Tensor):
        """One decode forward for every slot from the current pool
        state, without touching it: (f32 logits [S, V], new K, new V).
        The kernel path's K/V are this step's rows [L, S, Hkv, D]; the
        dense path's are the whole updated views [L, S, R, Hkv, D]."""
        cache = self.cache
        ids = self._tokens[:, None]
        positions = cache.lengths[:, None]
        if use_kernel:
            kvc = (PagedKV(cache.k, cache.k_scale, cache.compute_dtype),
                   PagedKV(cache.v, cache.v_scale, cache.compute_dtype),
                   PagedDecodeMeta(table, cache.lengths, rows=cache.rows))
            logits, (rk, rv, _) = self._forward(
                self.config, self.params, ids, positions=positions,
                kv_caches=kvc)
            return logits[:, 0].float(), rk[:, :, 0], rv[:, :, 0]
        k_all, v_all = paged_batch_view(cache, table)
        logits, (nk, nv, _) = self._forward(
            self.config, self.params, ids, positions=positions,
            kv_caches=(k_all, v_all, cache.lengths))
        return logits[:, 0].float(), nk, nv

    # -- request API -------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        key: int | None = None,
        eos_token_id: int | None = None,
        deadline_s: float | None = None,
        tenant: str = "default",
        slo_ttft_s: float | None = None,
        parent_id: int | None = None,
    ) -> Request:
        """Queue one generation request; returns its handle immediately.
        Overload is reported on the handle (`status` REJECTED with
        `reject_reason`, `shed_code` and `retry_after_s`). `key` (an int)
        fixes the request's sampling stream; None derives one from the
        engine seed and the request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), key=key,
            eos_token_id=eos_token_id, deadline_s=deadline_s,
            tenant=tenant, slo_ttft_s=slo_ttft_s, parent_id=parent_id,
        )
        # drain first, THEN capacity-check: a slot freed since the last
        # step must make room before this request is judged against
        # max_queue
        self._admit_pending()
        self.scheduler.submit(req)
        for victim in self.scheduler.drain_shed():
            self._finalize_request(victim)
        if req.done:
            self._finalize_request(req)
        else:
            # eager admission: a free slot absorbs the request now
            self._admit_pending()
        return req

    def fork(
        self,
        parent: Request,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        key: int | None = None,
        eos_token_id: Any = "inherit",
        deadline_s: float | None = None,
        slo_ttft_s: float | None = None,
    ) -> Request:
        """COW-fork `parent`: a new request on the same prompt that
        SHARES the parent's prompt pages instead of re-prefilling them.
        The parent publishes its full prompt pages into the radix tree as
        prefill completes them; the fork's admission maps them and
        diverges at its first private page. Unset generation knobs
        inherit the parent's; `key` should differ per fork or siblings
        sample identical streams (None derives one from the fork's id)."""
        parent.share_prompt = True
        if not parent.done:
            self._fork_parents[parent.request_id] = parent
        for slot in self.scheduler.slots:
            if slot.request is parent:
                self.allocator.publish_prompt(slot)
                break
        return self.submit(
            parent.prompt,
            max_new_tokens=(parent.max_new_tokens if max_new_tokens is None
                            else max_new_tokens),
            temperature=(parent.temperature if temperature is None
                         else temperature),
            key=key,
            eos_token_id=(parent.eos_token_id if eos_token_id == "inherit"
                          else eos_token_id),
            deadline_s=deadline_s,
            tenant=parent.tenant,
            slo_ttft_s=slo_ttft_s,
            parent_id=parent.request_id,
        )

    def cancel(self, request: Request) -> bool:
        if self.scheduler.cancel(request):
            self._finalize_request(request)
            return True
        return False

    def finish(self, request: Request) -> bool:
        """Retire a running request as FINISHED before its budget (e.g. a
        stop sequence matched): counts as finished, prompt pages cached."""
        if self.scheduler.finish_early(request):
            self._finalize_request(request)
            return True
        return False

    def stream(self, request: Request) -> Iterator[int]:
        """Yield the request's tokens as the engine produces them,
        driving `step()` while the request is live."""
        sent = 0
        while True:
            while sent < len(request.tokens):
                yield request.tokens[sent]
                sent += 1
            if request.done or not self.step():
                break
        yield from request.tokens[sent:]

    # -- the drive loop ----------------------------------------------------

    def step(self) -> bool:
        """Run one scheduler action (admissions + one prefill chunk OR one
        batched decode step). Returns False when the engine is idle."""
        if self.metrics.started_at is None:
            self.metrics.started_at = self._clock()
        self._admit_pending()
        action = self.scheduler.next_action()
        if action is None:
            self.metrics.stopped_at = self._clock()
            return False
        t0 = self._clock()
        if action[0] == "prefill":
            self._run_prefill_chunk(action[1])
        else:
            self._run_decode(action[1])
        self.metrics.stopped_at = self._clock()
        self.scheduler.note_step_time(self.metrics.stopped_at - t0)
        self.metrics.observe_step(self.scheduler.live_slots,
                                  self.engine_config.num_slots,
                                  self.scheduler.queue_depth)
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def _admit_pending(self) -> None:
        """Shed expired/doomed queued requests, then admit from the
        queue into free slots."""
        now = self._clock()
        self.scheduler.shed_expired(now)
        for req in self.scheduler.drain_shed():
            self._finalize_request(req)
        for slot, req in self.scheduler.admissions(now):
            self._run_admit(slot, req)

    def _hold_fork_child(self, req: Request) -> bool:
        """A fork child stays QUEUED until its parent's full prompt pages
        are published (or the parent is terminal)."""
        if req.parent_id is None:
            return False
        parent = self._fork_parents.get(req.parent_id)
        if parent is None or parent.done:
            return False
        want = (req.prompt_len - 1) // self.engine_config.page_size
        if want <= 0:
            return False  # nothing shareable: sub-page prompts admit cold
        for slot in self.scheduler.slots:
            if slot.request is parent:
                have = min(slot.prompt_done, parent.prompt_len) \
                    // self.engine_config.page_size
                return have < want
        return True  # parent still queued: its prefill hasn't started

    def _hold_admission(self, req: Request) -> bool:
        """The allocator's admission-hold hook: fork children wait for
        their parent's publish, and a request whose full shareable prefix
        another request is prefilling right now waits for its pages."""
        return self._hold_fork_child(req) or self._hold_for_dedup(req)

    def _hold_for_dedup(self, req: Request) -> bool:
        """In-flight prefill dedup: if a PREFILL-state slot's prompt
        covers `req`'s full shareable prefix, have that leader publish
        its prompt pages mid-flight and hold `req` until they cover it.
        A request never waits on a lower-priority tier's leader."""
        want = (req.prompt_len - 1) // self.engine_config.page_size
        if want <= 0:
            return False
        if len(self.allocator.index.match(req.prompt)) >= want:
            self._dedup_held.discard(req.request_id)
            return False
        k = want * self.engine_config.page_size
        my_tier = self.scheduler.tenant_priority(req.tenant)
        head = req.prompt[:k]
        for slot in self.scheduler.slots:
            leader = slot.request
            if (slot.state is not SlotState.PREFILL or leader is None
                    or leader is req):
                continue
            if leader.prompt_len < k \
                    or self.scheduler.tenant_priority(leader.tenant) > my_tier:
                continue
            if not np.array_equal(np.asarray(leader.prompt[:k]), head):
                continue
            leader.share_prompt = True  # publish from the next chunk on
            if self.allocator.publish_prompt(slot) >= want:
                self._dedup_held.discard(req.request_id)
                return False
            if req.request_id not in self._dedup_held:
                self._dedup_held.add(req.request_id)
                self.metrics.note_dedup_hit()
            return True
        self._dedup_held.discard(req.request_id)
        return False

    def _unmap_slot(self, index: int) -> None:
        """Allocator callback at release: reset the slot's page table to
        all-trash BEFORE its pages can be reallocated, so the retired
        lane's masked ride-along writes never land in a page now owned by
        someone else."""
        self._table[index, :] = self.cache.trash_page
        self._set_page_gauges()

    def _set_page_gauges(self) -> None:
        self.metrics.set_page_gauges(
            self.allocator.pages_in_use, self.allocator.pages_free,
            self.allocator.pages_in_use * self.cache.page_nbytes)

    def _run_admit(self, slot: Slot, req: Request) -> None:
        key = (derive_key(self.engine_config.seed, req.request_id)
               if req.key is None else stream_key(req.key))
        alloc = slot.alloc
        row = self._table[slot.index]
        row[:] = self.cache.trash_page
        row[:len(alloc.pages)] = alloc.pages
        self.metrics.note_admission(req.prompt_len, alloc.reused_len)
        self._set_page_gauges()
        self._admit(slot.index, key, req.temperature, alloc.reused_len)
        if self.on_admit is not None:
            self.on_admit(slot, req)

    def _run_prefill_chunk(self, slot: Slot) -> None:
        chunk = self.engine_config.prefill_chunk
        req = slot.request
        start = slot.prompt_done  # includes the reused prefix on a hit
        real = min(chunk, req.prompt_len - start)
        ids = np.zeros((chunk,), np.int32)
        ids[:real] = req.prompt[start:start + real]
        lp = self._prefill(slot.index, self._table[slot.index], ids, real)
        self.metrics.note_prefill_chunk()
        done = self.scheduler.note_prefill_chunk(slot, real)
        if req.share_prompt:
            # fork parent: every full prompt page this chunk completed
            # becomes shareable now
            self.allocator.publish_prompt(slot)
        if done:
            # the chunk that completed the prompt also produced the
            # request's first token: one element crosses to the host
            tok = int(self._tokens[slot.index])
            if self.scheduler.note_token(slot, tok, logprob=float(lp)):
                self._finalize_request(req)

    def _run_decode(self, slots: list[Slot]) -> None:
        live = np.zeros((self.engine_config.num_slots,), bool)
        for s in slots:
            live[s.index] = True
        table = self._upload(self._table)
        live = self._upload(live)
        last, new_k, new_v = self._decode_forward(self._use_paged_kernel,
                                                  table)
        next_tok, lps = self._sample(last, self._slot_keys,
                                     self.cache.lengths + 1, self._temps)
        self._tokens = torch.where(live, next_tok, self._tokens)
        if self._use_paged_kernel:
            paged_append_rows(self.cache, table, new_k, new_v, live)
        else:
            paged_append_batch(self.cache, table, new_k, new_v, live)
        toks = self._tokens.cpu().numpy()  # the per-step host read
        lps = lps.cpu().numpy()
        self.metrics.note_decode_step(
            "kernel" if self._use_paged_kernel else "dense")
        for s in slots:
            req = s.request
            if self.scheduler.note_token(s, int(toks[s.index]),
                                         logprob=float(lps[s.index])):
                self._finalize_request(req)

    def _finalize_request(self, req: Request) -> None:
        """The one terminal path: fold the request into the metrics."""
        self._fork_parents.pop(req.request_id, None)
        self.metrics.observe_request(req)

    # -- metrics -----------------------------------------------------------

    def metrics_summary(self) -> dict[str, float]:
        """Flat serving metrics (TTFT/per-token percentiles, occupancy,
        queue depth, tokens/sec, prefix reuse) plus the pool capacity."""
        out = self.metrics.summary()
        out["pages_capacity"] = float(self.cache.num_pages)
        return out
