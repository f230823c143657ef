"""Continuous-batching serving engine (port of
`accelerate_tpu/serving/engine.py`): many requests, one fixed-shape
decode step.

Every device step is one fixed-shape program, whatever the request mix:

- admit:   set a slot's length to the reused prefix length (0 on a cold
           miss), install the request's sampling key and temperature;
- prefill: one fixed-size prompt chunk into one slot (prompts pad to the
           chunk; lengths advance by real tokens only);
- decode:  one token for EVERY slot in one batched forward with per-slot
           lengths and positions. Retired or prefilling slots ride along
           as masked lanes.

The reference compiles each once with `jax.jit`; the port's counterpart
is a CUDA graph (`serving/graphs.py`): on a CUDA engine each program
runs eagerly once (its warm-up), is captured once, and is replayed from
then on; `compile_stats()` counts the captures, each 1 for good. The
programs read the slot index, the chunk, the page table and the live
mask from static device buffers the host refills before a step, and
update the pool and the per-slot state in place. Admit (three scalar
writes) stays eager and counts 1. A CPU engine, or a CUDA engine built
with `_graphs=False`, runs the same program bodies directly.

The KV store is the paged pool of `serving/cache.py`. Page tables are
host-side numpy ([slots, pages_per_slot] int32, trash-padded), uploaded
with each step. At admission the longest cached prompt prefix is mapped
copy-on-write from the radix tree, so prefill runs only on the uncached
suffix; with `host_tier_bytes` set, evicted prefix pages swap out to host
memory and back in at admission (`serving/host_tier.py`, through the
extract/install programs of `serving/transfer.py`).

Decode attention has two modes (`EngineConfig.paged_attention`): the
paged-decode kernel (`ops/paged_attention.py`, CUDA on the card) walks
each slot's live pages in place and hands back the new K/V rows; the
dense-gather reference path gathers every slot's pages into one [L, S,
R, H, D] view first and runs the same forward with per-slot lengths.

Speculative decoding (`EngineConfig(speculative=(family, config,
params), draft_k=K)`) replaces the decode program with three: the draft
model's chunked prompt prefill into its own dense slot cache
(`draft_prefill`), K draft steps for every slot in one program
(`draft`), and one K-token target forward over every slot's pages with
the accept rule and the commit (`verify`): exact match for greedy
requests (output identical to the plain engine's), rejection sampling
for sampled ones (the committed tokens follow the target distribution).
The verify runs the dense-gather path: the paged kernel folds exactly
one new token.

Sampling is per slot: a request's key is installed at admit and the
token at position p is drawn with Gumbel noise hashed from (key, p)
(`models/decode.py`), so a request's stream never depends on how
prefills and decodes interleave; speculation draws three independent
tagged streams per position. Temperature is per slot too. Each decode
step ends in one read of the [S] token vector (and its logprobs) to the
host; a finished prefill reads one token.

`EngineConfig(sanitize=True)` checks the cross-structure invariants of
`serving/sanitizer.py` after every step; with `incident_dir` set, a
violation first writes an incident bundle.

Device cost (`telemetry/cost.py`): every engine keeps a cost table on its
registry with each program's analytic FLOPs and bytes (`_analytic_cost`)
and samples the device time of call 2 and every `cost_sample_every`-th
call after (16 by default): a fence pair around the program's launch or
replay, outside the captured body. `metrics_summary()` derives the decode
and prefill device times, `decode_mfu`, `decode_hbm_bw_util`,
`decode_mxu_idle_fraction`, `decode_arith_intensity` and `goodput` from
it, and a serving `StepTimer` meters each program's host dispatch.
`metrics_port` serves the registry over HTTP, and `watchdog_timeout_s`
arms a stall watchdog that `step()` ticks (with `incident_dir`, a stall
writes a bundle holding the engine's dumps and its cost table).

Tensor-parallel serving (`EngineConfig(mesh=...)`, serving/pod/mesh.py):
every rank of a process mesh runs this engine on its shard of the params
and of the pool, SPMD; the forward does its own collectives, the clock
is rank 0's on every rank, and over a gloo group the programs run
uncaptured (see `Engine`).

Request tracing is the reference's: with `telemetry.trace` enabled every
request gets a trace id at submit (or joins the caller's, as the HTTP
front door passes it), and a sampled request records a root span
`serving.request` with children `serving.queue_wait`, `serving.admit`,
`serving.swap_in`, `serving.prefill`, `serving.draft_prefill` and
`serving.decode_lifetime`; the batched steps (`serving.decode`,
`serving.draft`, `serving.verify`) link every sampled request they
serve. The spans are host-side: they wrap a program's launch or replay
from the outside, time its dispatch as the reference's do, and add no
synchronisation.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, AsyncIterator, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import count_params
from ..models.decode import derive_key, gumbel_noise, sample_token, \
    stream_key, uniform
from ..ops import paged_attention as _paged
from ..ops.paged_attention import PagedDecodeMeta, PagedKV
from ..profiler import StepTimer, causal_lm_infer_flops
from ..telemetry.cost import CostTable, device_peaks, resolve_sample_every
from ..telemetry.export import start_metrics_server
from ..telemetry.registry import MetricsRegistry
from ..telemetry.trace import (
    head_sample,
    new_trace_id,
    next_span_id,
    record_span,
    span,
    tracing_enabled,
)
from ..telemetry.watchdog import StallWatchdog, resolve_stall_timeout
from .cache import (
    PagedAllocator,
    PagedKVCache,
    SlotKVCache,
    paged_admit_slot,
    paged_append_batch,
    paged_append_rows,
    paged_append_window,
    paged_batch_view,
    paged_slot_view,
    paged_write_slot,
    reset_slot,
    slot_caches,
    write_slot,
)
from .graphs import GraphRunner
from .metrics import ServingMetrics
from .sanitizer import SanitizerViolation, check_engine, resolve_sanitize
from .scheduler import Request, Scheduler, Slot, SlotState

__all__ = ["Engine", "EngineConfig"]

# the kernel wrappers whose launch counters count through graph replays
_KERNEL_COUNTERS = ((_paged, "paged_decode_attention"),)

# speculative decoding's three draws per position (the reference's
# fold_in tags)
DRAFT_TAG, ACCEPT_TAG, RESID_TAG = 1, 2, 3


def prepare_request_tracing(req: Request, trace_id, trace_parent,
                            trace_sampled) -> None:
    """Install the request's trace identity at submit time. The id is
    minted whenever tracing is on, sampled or not (request-id plumbing
    must not depend on the sampling rate); a sampled request
    pre-allocates its root span id so children can parent onto it before
    the root closes at the terminal state."""
    req.trace_id = trace_id
    req.trace_parent = trace_parent
    if trace_sampled is None:
        req.trace_sampled = head_sample(req.tenant)
    else:
        req.trace_sampled = bool(trace_sampled) and tracing_enabled()
    if req.trace_id is None and tracing_enabled():
        req.trace_id = new_trace_id()
    if req.trace_sampled:
        req.span_id = next_span_id()


def close_request_trace(req: Request, end: float) -> None:
    """Close a terminal request's retrospective spans: the decode-lifetime
    child (first token -> terminal) and the root `serving.request` span
    carrying status/reason/shed_code. Every terminal path lands here
    exactly once — finished, cancelled, rejected, shed."""
    if not req.trace_sampled:
        return
    if req.first_token_at is not None and end > req.first_token_at:
        # decode lifetime: first token -> terminal (prefill chunks are
        # their own child spans; this is the streaming tail)
        record_span("serving.decode_lifetime", req.first_token_at, end,
                    trace=req.trace_id, parent=req.span_id,
                    tokens=len(req.tokens))
    attrs: dict[str, Any] = {
        "request_id": req.request_id,
        "tenant": req.tenant,
        "status": req.status.value,
        "prompt_len": req.prompt_len,
        "tokens": len(req.tokens),
    }
    if req.ttft_s is not None:
        attrs["ttft_s"] = req.ttft_s
    if req.reject_reason is not None:
        attrs["reason"] = req.reject_reason
    if req.shed_code is not None:
        attrs["shed_code"] = req.shed_code
    if req.parent_id is not None:
        # fork parentage rides the root span: a fan-out's siblings all
        # name the request whose prompt pages they share
        attrs["forked_from"] = req.parent_id
    record_span("serving.request", req.submitted_at, end,
                trace=req.trace_id, parent=req.trace_parent,
                span_id=req.span_id, **attrs)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs, the reference's fields. `max_len` bounds
    prompt+generated per slot (admission rejects longer requests);
    `prefill_chunk` trades prefill efficiency against how long a long
    prompt may stall decode (one chunk).

    Fields whose machinery the port has not reached yet raise
    NotImplementedError when set (see `_UNPORTED`); the port reads none
    of the reference's environment variables, so None means off for
    `metrics_port`, `watchdog_timeout_s` and `incident_dir`, and 16 for
    `cost_sample_every` (0 turns sampling off)."""

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
    # host-DRAM overflow tier for evicted prefix pages, in bytes (0 = off)
    host_tier_bytes: int = 0
    # decode attention op. True: the paged-decode kernel walks the page
    # table inside attention (on a CPU engine its plain version runs).
    # False: the dense-gather reference path. "auto": the kernel on a
    # CUDA engine without speculation, else the dense path.
    paged_attention: Any = "auto"
    # KV pool storage: None stores pages in `cache_dtype`; "int8" stores
    # int8 codes + per-row-per-head bf16 scales (half the bytes per page)
    kv_dtype: Any = None
    # speculative decoding: a (family, config, params) draft model
    # proposing `draft_k` tokens per slot and step
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
    # the serving-state sanitizer after every step (None = off)
    sanitize: Any = None
    # tensor-parallel serving (serving/pod layer 1): a process mesh
    # (`state.ProcessMesh`, `serving.pod.tensor_mesh`) with a "model"
    # axis. Every rank then runs the engine on its shard of the params
    # (placed by the caller: `serving.pod.shard_params`, or the
    # `serving.pod.sharded_engine` factory that does all of this) and of
    # the KV pool (sharded over KV heads when they divide the axis, else
    # over pages, else replicated); per-slot state replicates. A mesh of
    # one is single-device serving.
    mesh: Any = None


# field -> (is it set?, the part of the port that will bring it)
_UNPORTED = {
    "strict": (lambda v: v is not None, "the static-analysis audits"),
    "contracts": (lambda v: v is not None, "the static-analysis audits"),
}


def _check_ported(ec: EngineConfig) -> None:
    for name, (is_set, part) in _UNPORTED.items():
        if is_set(getattr(ec, name)):
            raise NotImplementedError(
                f"EngineConfig.{name} needs {part}, which a later slice of "
                "the PyTorch port brings; leave it at its default")


def _resolve_paged_attention(setting, device: torch.device,
                             speculative, mesh=None) -> bool:
    """EngineConfig.paged_attention -> use-the-kernel bool."""
    if setting == "auto":
        return (device.type == "cuda" and speculative is None
                and mesh is None)
    use = bool(setting)
    if use and mesh is not None:
        raise ValueError(
            "paged_attention=True is not supported on a meshed engine: a "
            "pallas kernel is opaque to GSPMD, which would gather the "
            "head-sharded pool around it instead of partitioning the "
            "kernel. Meshed engines keep the dense-gather decode path "
            "('auto' resolves to False there); single-device pod decode "
            "workers (tensor_parallel=1) can use the kernel.")
    if use and speculative is not None:
        raise ValueError(
            "paged_attention=True is not supported with speculative "
            "decoding: the paged kernel folds exactly ONE new token's K/V "
            "as its final online-softmax update, but the verify step is a "
            "draft_k-token forward. Leave paged_attention='auto' (the "
            "speculative verify uses the dense-gather path).")
    return use


def _check_mesh(family, params, ec: EngineConfig) -> None:
    """What a meshed engine takes, checked before anything is built."""
    from ..models.tensor_parallel import (
        require_tensor_parallel,
        tensor_parallel_of,
    )

    if ec.speculative is not None:
        raise ValueError(
            "speculative decoding is not supported on a meshed "
            "engine yet: the draft would need its own placement "
            "and the verify program its own pod contract — run "
            "speculation on single-device engines (or pod decode "
            "workers at tensor_parallel=1, speculative unset)")
    if ec.host_tier_bytes > 0:
        raise NotImplementedError(
            "the host KV tier on a meshed engine arrives with queue 1 item "
            "6b: its drain thread decides admissions by per-rank timing, "
            "and the ranks must decide alike")
    require_tensor_parallel(family)
    tp = tensor_parallel_of(params)
    if tp is None or dict(tp.mesh.shape) != dict(ec.mesh.shape):
        raise ValueError(
            "EngineConfig.mesh needs params placed on that mesh: pass them "
            "through serving.pod.shard_params(params, mesh), or build the "
            "engine with serving.pod.sharded_engine")


def _host_collectives(mesh) -> bool:
    """Whether a mesh's collectives pass through the host (gloo)."""
    if mesh is None or not torch.distributed.is_initialized():
        return False
    from ..utils.constants import AXIS_MODEL

    group = mesh.group(AXIS_MODEL)
    return group is not None and \
        torch.distributed.get_backend(group) == "gloo"


def _cache_spec(config) -> tuple[int, int, int]:
    """(num_layers, num_kv_heads, head_dim) from any family config."""
    kv = getattr(config, "num_key_value_heads", None)
    if kv is None:
        kv = config.num_attention_heads
    return config.num_hidden_layers, kv, config.head_dim


def _links(slots) -> list | None:
    """The trace ids of the sampled requests a batched step serves."""
    links = [s.request.trace_id for s in slots
             if s.request is not None and s.request.trace_sampled]
    return links or None


def _first_tensor(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class Engine:
    """Front-end: `submit()` -> request handle, `stream()`/`astream()`
    for tokens as they land, `cancel()`/`finish()`/`fork()`, `step()`/
    `run_until_idle()` to drive. `family` is a model module with the
    uniform decode contract (`forward(config, params, ids,
    positions=..., kv_caches=...) -> (logits, new_caches)`) or that
    forward callable. The engine runs on `device` (CUDA unless "cpu"),
    where `params` must already live. `_graphs=False` keeps a CUDA
    engine's programs eager (for comparing the two).

    With `EngineConfig(mesh=...)` the engine is one rank of a
    tensor-parallel engine (serving/pod/mesh.py): every rank of the mesh
    builds it with its shard of the params and makes the same calls in
    the same order. Its clock is then rank 0's (`pod.mesh.LockstepClock`,
    one broadcast a reading), so the scheduler's decisions, which read
    the clock, are the same on every rank and every rank reaches every
    collective. Over a gloo group (ranks sharing a card, or CPU ranks)
    the programs run uncaptured: a collective that passes through the
    host cannot be captured in a CUDA graph. `graphs_captured` says which,
    and `compile_stats()` then counts each program's first build (1 each,
    as captures do)."""

    def __init__(self, family, config, params,
                 engine_config: EngineConfig | None = None, device=None,
                 clock=time.monotonic, _graphs: bool = True):
        self.config = config
        self.params = params
        self.engine_config = ec = engine_config or EngineConfig()
        _check_ported(ec)
        if ec.mesh is not None and getattr(ec.mesh, "size", 1) <= 1:
            # a 1-device "mesh" IS single-device serving: no collectives,
            # no shards to hold
            self.engine_config = ec = dataclasses.replace(ec, mesh=None)
        self.device = dev = resolve_device(device)
        p_dev = _first_tensor(params).device
        if p_dev.type != dev.type:
            raise ValueError(f"params live on {p_dev}, the engine runs on "
                             f"{dev}")
        self._forward = family if callable(family) else family.forward
        if ec.mesh is not None:
            from .pod.mesh import lockstep_clock

            _check_mesh(family, params, ec)
            clock = lockstep_clock(clock, ec.mesh)
        self._clock = clock
        self._spec = ec.speculative is not None
        if self._spec:
            if ec.draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {ec.draft_k}")
            try:
                dfam, dcfg, dparams = ec.speculative
            except (TypeError, ValueError):
                raise ValueError(
                    "speculative must be a (family, config, params) triple "
                    "for the draft model") from None
            if getattr(dcfg, "vocab_size", None) != config.vocab_size:
                raise ValueError(
                    f"draft vocab_size ({getattr(dcfg, 'vocab_size', None)})"
                    f" must match the target's ({config.vocab_size}): "
                    "drafted tokens are verified by id")
            if _first_tensor(dparams).device.type != dev.type:
                raise ValueError("draft params live on "
                                 f"{_first_tensor(dparams).device}, the "
                                 f"engine runs on {dev}")
            self._draft_forward = dfam if callable(dfam) else dfam.forward
            self._draft_config = dcfg
            self._draft_params = dparams
        self._use_paged_kernel = _resolve_paged_attention(
            ec.paged_attention, dev, ec.speculative, ec.mesh)
        self._sanitize = resolve_sanitize(ec.sanitize)

        num_layers, num_kv, head_dim = _cache_spec(config)
        # pad_slack covers both overshoot sources: chunk padding can
        # spill chunk-1 rows past max_len, and a speculative verify can
        # write up to draft_k candidate rows past the last budgeted token
        self._pad_slack = max(ec.prefill_chunk,
                              ec.draft_k if self._spec else 0)

        def make_pool():
            return PagedKVCache.create(
                num_layers, ec.num_slots, ec.max_len, num_kv, head_dim,
                dtype=ec.cache_dtype, page_size=ec.page_size,
                pad_slack=self._pad_slack, num_pages=ec.num_pages,
                kv_dtype=ec.kv_dtype, device=dev,
            )

        # on a mesh: this rank's shard of the pool, and the layout
        # (`pod.mesh.cache_state_shardings`) as `cache_shardings`
        self.cache_shardings = None
        if ec.mesh is not None:
            from .pod.mesh import place_pool

            self.cache, self.cache_shardings = place_pool(make_pool,
                                                          ec.mesh, dev)
        else:
            self.cache = make_pool()
        if self._spec:
            # the draft's own state is a DENSE slot cache: cached target
            # pages hold another model's K/V, so prefix hits run
            # draft-only catch-up chunks
            dl, dkv, dhd = _cache_spec(self._draft_config)
            self._draft_cache = SlotKVCache.create(
                dl, ec.num_slots, ec.max_len, dkv, dhd,
                dtype=ec.cache_dtype, pad_slack=self._pad_slack, device=dev)
        self.registry = MetricsRegistry()
        self.metrics = ServingMetrics(registry=self.registry)
        self.timer = StepTimer(warmup_steps=1, registry=self.registry,
                               name="serving_step")
        # per-program rooflines: analytic FLOPs/bytes registered at a
        # program's first call, sampled fence-pair device time; a meshed
        # engine's utilization divides its global (whole-model) FLOPs by
        # the whole mesh's peak
        self.cost = CostTable(registry=self.registry,
                              sample_every=resolve_sample_every(
                                  ec.cost_sample_every),
                              peaks=device_peaks(dev),
                              num_chips=(ec.mesh.size
                                         if ec.mesh is not None else 1))
        # parameter counts, taken at the first registration
        self._n_params: int | None = None
        self._n_draft_params: int | None = None
        # host-side page accounting; the lambdas read self.metrics at call
        # time, so reset_metrics()'s replacement keeps receiving events
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
        self._graphs = GraphRunner(
            dev, graphs=_graphs and not _host_collectives(ec.mesh),
            counters=_KERNEL_COUNTERS)
        # hierarchical KV: the host tier and its extract/install pair
        self._host_tier = None
        self._swap_transport = None
        if ec.host_tier_bytes > 0:
            from .host_tier import HostTier
            from .transfer import PageTransport

            self._swap_transport = PageTransport(self)
            self._host_tier = HostTier(self, ec.host_tier_bytes)
            self.allocator.swap_out = self._host_tier.offer
            self.allocator.swap_stall = self._host_tier.would_stall
            self.allocator.index.drop_host = self._host_tier.discard
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
        S = ec.num_slots
        self._tokens = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._slot_keys = torch.zeros((S, 2), dtype=torch.int64, device=dev)
        self._temps = torch.zeros((S,), dtype=torch.float32, device=dev)
        self._build_programs()
        # admission hook: on_admit(slot, request) at the end of every
        # admission, after the slot's page table and state are installed
        self.on_admit: Any = None
        # opt-in observability, started last so a construction error
        # leaks no bound port and no thread; the HTTP service reads
        # `watchdog` for its health check
        self.metrics_server = start_metrics_server(
            ec.metrics_port, registry=self.registry)
        self.watchdog: StallWatchdog | None = None
        wd_timeout = resolve_stall_timeout(ec.watchdog_timeout_s)
        if wd_timeout is not None:
            self.watchdog = StallWatchdog(
                wd_timeout, name="serving-engine",
                incident_dir=ec.incident_dir, registry=self.registry,
                dumps=self.incident_dumps).start()

    # -- device programs -----------------------------------------------------

    def _build_programs(self) -> None:
        ec, g = self.engine_config, self._graphs
        S, P = ec.num_slots, self.cache.pages_per_slot
        # the programs' inputs: refilled by the host before each run
        self._in_table = g.buffer("table", (S, P), torch.int32)
        self._in_live = g.buffer("live", (S,), torch.bool)
        self._in_slot = g.buffer("slot", (1,), torch.int64)
        self._in_ids = g.buffer("ids", (ec.prefill_chunk,), torch.int32)
        self._in_real = g.buffer("real_len", (1,), torch.int64)
        g.add("admit", self._admit, capture=False)
        g.add("prefill", self._prefill)
        if self._spec:
            K = ec.draft_k
            self._in_restore = g.buffer("restore", (S,), torch.int32)
            # the draft's proposals and logits, at fixed addresses: the
            # draft program writes them, the verify program reads them
            self._d_toks = torch.zeros((S, K), dtype=torch.int32,
                                       device=self.device)
            self._d_logits = torch.zeros((S, K, self.config.vocab_size),
                                         dtype=torch.float32,
                                         device=self.device)
            g.add("draft_prefill", self._draft_prefill)
            g.add("draft", self._draft)
            g.add("verify", self._verify)
        else:
            g.add("decode", self._decode)

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
        # a prefix hit starts the TARGET slot's length at the reused
        # prefix (those pages already hold its K/V); the draft always
        # starts cold (catch-up chunks rebuild it)
        paged_admit_slot(self.cache, slot, reused_len)
        self._slot_keys[slot, 0] = key[0]
        self._slot_keys[slot, 1] = key[1]
        self._temps[slot] = temp
        if self._spec:
            reset_slot(self._draft_cache, slot)

    def _prefill(self):
        """One prompt chunk (`ids`, `real_len` real tokens) into `slot`;
        samples the token after the chunk into the slot's token register
        and returns its logprob [1]."""
        chunk = self.engine_config.prefill_chunk
        cache, slot = self.cache, self._in_slot
        row = self._in_table.index_select(0, slot)[0]
        ks, vs, length = paged_slot_view(cache, row, slot)
        positions = (length + torch.arange(chunk, device=self.device))[None]
        logits, (nk, nv, _) = self._forward(
            self.config, self.params, self._in_ids[None],
            positions=positions, kv_caches=(ks, vs, length))
        real = self._in_real
        paged_write_slot(cache, row, slot, nk, nv, real, chunk)
        last = logits[0].float().index_select(0, real - 1)
        tok, lp = self._sample(last, self._slot_keys.index_select(0, slot),
                               length + real,
                               self._temps.index_select(0, slot))
        self._tokens.index_copy_(0, slot, tok)
        return lp

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

    def _decode(self):
        """One token for every slot; live lanes keep theirs and advance.
        Returns the logprobs [S]."""
        table, live = self._in_table, self._in_live
        last, new_k, new_v = self._decode_forward(self._use_paged_kernel,
                                                  table)
        next_tok, lps = self._sample(last, self._slot_keys,
                                     self.cache.lengths + 1, self._temps)
        self._tokens.copy_(torch.where(live, next_tok, self._tokens))
        if self._use_paged_kernel:
            paged_append_rows(self.cache, table, new_k, new_v, live)
        else:
            paged_append_batch(self.cache, table, new_k, new_v, live)
        return lps

    def _draft_prefill(self):
        """One chunk of the DRAFT model's prompt into its dense slot
        cache (the draft re-reads the whole prompt, the target's reused
        prefix included)."""
        chunk = self.engine_config.prefill_chunk
        dc, slot = self._draft_cache, self._in_slot
        ks, vs, length = slot_caches(dc, slot)
        positions = (length + torch.arange(chunk, device=self.device))[None]
        _, (nk, nv, _) = self._draft_forward(
            self._draft_config, self._draft_params, self._in_ids[None],
            positions=positions, kv_caches=(ks, vs, length))
        write_slot(dc, slot, nk, nv, self._in_real)

    def _propose(self, logits, positions):
        """A draft proposal per slot from its f32 logits [S, V]: argmax
        for greedy slots, else Gumbel-max over logits/temp with the
        DRAFT-tagged draw at `positions`."""
        temps = self._temps
        greedy = torch.argmax(logits, dim=-1)
        noise = gumbel_noise(self._slot_keys, positions, logits.shape[-1],
                             tag=DRAFT_TAG)
        sampled = torch.argmax(
            logits / torch.clamp(temps, min=1e-6)[:, None] + noise, dim=-1)
        return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)

    def _draft(self):
        """K sequential one-token draft steps for every slot in one
        program: proposals into `_d_toks` [S, K], the draft's full f32
        logits into `_d_logits` [S, K, V]; every lane's draft length
        advances by K (the verify program sets the real lengths)."""
        dc, K = self._draft_cache, self.engine_config.draft_k
        tok, length = self._tokens, dc.lengths
        for j in range(K):
            logits, _ = self._draft_forward(
                self._draft_config, self._draft_params, tok[:, None],
                positions=length[:, None], kv_caches=(dc.k, dc.v, length))
            lg = logits[:, 0].float()
            tok = self._propose(lg, length + 1)
            self._d_logits[:, j].copy_(lg)
            self._d_toks[:, j].copy_(tok)
            length = length + 1
        dc.lengths.add_(K)

    def _verify(self):
        """ONE batched K-token target forward over every slot's pages,
        the accept rule, and the fixed-shape commit. Returns (committed
        [S, K] int32, counts [S], accepted [S], logprobs [S, K])."""
        cache, K = self.cache, self.engine_config.draft_k
        S = self.engine_config.num_slots
        table, live = self._in_table, self._in_live
        d_toks, d_logits = self._d_toks, self._d_logits
        temps, keys = self._temps, self._slot_keys
        dev = self.device
        # inputs per slot: [t0, d1..d_{K-1}] at positions L..L+K-1; row
        # j's logits judge proposal d_{j+1}
        ids = torch.cat([self._tokens[:, None], d_toks[:, :K - 1]], dim=1)
        j = torch.arange(K, device=dev)
        base = cache.lengths.long()
        k_all, v_all = paged_batch_view(cache, table)
        logits, (nk, nv, _) = self._forward(
            self.config, self.params, ids, positions=base[:, None] + j,
            kv_caches=(k_all, v_all, cache.lengths))
        tl = logits.float()                                    # [S, K, V]
        greedy_ok = d_toks == torch.argmax(tl, dim=-1)
        t = torch.clamp(temps, min=1e-6)[:, None, None]
        p = torch.softmax(tl / t, dim=-1)
        q = torch.softmax(d_logits / t, dim=-1)
        idx = d_toks.long()[..., None]
        p_tok = p.gather(2, idx)[..., 0]
        q_tok = q.gather(2, idx)[..., 0]
        # accept d_i with prob min(1, p(d_i)/q(d_i)), spelled u*q < p so
        # a proposal the draft could not have sampled (q=0) rejects
        u = uniform(keys, base[:, None] + 1 + j, tag=ACCEPT_TAG)
        sampled_ok = u * q_tok < p_tok
        ok = torch.where(temps[:, None] > 0.0, sampled_ok, greedy_ok)
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        counts = torch.where(n_acc == K, K, n_acc + 1)
        # correction at the first rejected position: the residual
        # max(p - q, 0)/Z, which with the accepts reproduces p exactly
        r = torch.clamp(n_acc, max=K - 1)
        lanes = torch.arange(S, device=dev)
        p_r, q_r = p[lanes, r], q[lanes, r]
        resid = torch.clamp(p_r - q_r, min=0.0)
        resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid, p_r)
        noise = gumbel_noise(keys, base + 1 + r, tl.shape[-1], tag=RESID_TAG)
        corr_sampled = torch.argmax(torch.log(resid + 1e-30) + noise, dim=-1)
        corr_greedy = torch.argmax(tl[lanes, r], dim=-1)
        corr = torch.where(temps > 0.0, corr_sampled, corr_greedy)
        committed = torch.where(j[None] < n_acc[:, None], d_toks,
                                corr[:, None].to(torch.int32))
        lps = torch.log_softmax(tl, dim=-1).gather(
            2, committed.long()[..., None])[..., 0]
        counts = torch.where(live, counts, 0)
        n_acc = torch.where(live, n_acc, 0)
        new_tok = committed[lanes, torch.clamp(counts, min=1) - 1]
        self._tokens.copy_(torch.where(live, new_tok, self._tokens))
        # keep exactly the accepted inputs' K/V rows (t0..d_{c-1});
        # rejected candidates' rows route to trash in the window scatter
        rows = base[:, None] + j
        win_k = nk[:, lanes[:, None], rows]
        win_v = nv[:, lanes[:, None], rows]
        paged_append_window(cache, table, win_k, win_v, counts, live)
        # the draft's valid rows now equal the target's for live lanes;
        # a non-live lane holding a request is mid-prefill, where the
        # draft lags the target: it keeps its host-tracked progress
        self._draft_cache.lengths.copy_(
            torch.where(live, cache.lengths, self._in_restore))
        return committed, counts, n_acc, lps

    def _ensure_cost(self, name: str) -> None:
        """Register the program's static cost once, at its first call.
        The port has no lowering to read a cost from: the cost is
        `_analytic_cost`'s."""
        if not self.cost.has(name):
            self.cost.register(name,
                               fallback=lambda: self._analytic_cost(name))

    def _analytic_cost(self, name: str) -> tuple[float, float]:
        """The reference's analytic (flops, bytes) per program call: ~2
        FLOPs/param/token plus attention over the cache
        (`profiler.causal_lm_infer_flops`); bytes = one full weight read
        plus the KV rows touched. The context length mid-stream is not
        known statically: max_len/2 stands for it."""
        cfg, ec = self.config, self.engine_config
        if name in ("draft", "draft_prefill"):
            cfg = self._draft_config
            if self._n_draft_params is None:
                self._n_draft_params = count_params(self._draft_params)
            n = self._n_draft_params
        else:
            if self._n_params is None:
                # a meshed engine's params are shards: count the model's
                self._n_params = getattr(self.params, "global_numel",
                                         None) or count_params(self.params)
            n = self._n_params
        num_layers, num_kv, head_dim = _cache_spec(cfg)
        hidden = getattr(cfg, "hidden_size", 0) or (
            getattr(cfg, "num_attention_heads", 1) * head_dim)
        avg_ctx = max(1, ec.max_len // 2)
        elt = 2  # bf16 weights/activations
        kv_row = num_kv * head_dim * elt * 2  # one K row + one V row
        if name == "decode":
            tokens = ec.num_slots
            flops = causal_lm_infer_flops(n, tokens, num_layers, hidden,
                                          kv_len=avg_ctx)
            nbytes = n * elt + tokens * num_layers * avg_ctx * kv_row
        elif name == "verify":
            # one K-token forward per slot
            tokens = ec.num_slots * ec.draft_k
            flops = causal_lm_infer_flops(n, tokens, num_layers, hidden,
                                          kv_len=avg_ctx)
            nbytes = (n * elt
                      + ec.num_slots * num_layers * avg_ctx * kv_row)
        elif name == "draft":
            # K sequential one-token draft steps over every slot
            tokens = ec.num_slots * ec.draft_k
            flops = causal_lm_infer_flops(n, tokens, num_layers, hidden,
                                          kv_len=avg_ctx)
            nbytes = ec.draft_k * n * elt \
                + tokens * num_layers * avg_ctx * kv_row
        elif name in ("prefill", "draft_prefill"):
            tokens = ec.prefill_chunk
            flops = causal_lm_infer_flops(n, tokens, num_layers, hidden,
                                          kv_len=avg_ctx)
            nbytes = (n * elt + tokens * num_layers * kv_row
                      + num_layers * avg_ctx * kv_row)
        else:  # admit: per-slot bookkeeping only, no model math
            flops, nbytes = 0.0, float(ec.num_slots * 16)
        return float(flops), float(nbytes)

    @property
    def graphs_captured(self) -> bool:
        """Whether the programs run as captured CUDA graphs (False on the
        CPU, with `_graphs=False`, and on a mesh whose collectives pass
        through the host)."""
        return self._graphs.graphs

    def compile_stats(self) -> dict[str, int]:
        """Captures per engine program (first eager builds on a CPU
        engine, or where `graphs_captured` is False): the recompile
        guard, each 1 however the request mix changes. Speculative
        engines report their five programs, classic engines
        admit/prefill/decode; with a host tier, the extract/install pair
        too."""
        stats = self._graphs.captures()
        names = ["admit", "prefill"]
        names += (["draft_prefill", "draft", "verify"] if self._spec
                  else ["decode"])
        if self._swap_transport is not None:
            names += ["extract", "install"]
        return {n: stats[n] for n in names}

    # -- request API -------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        key=None,
        eos_token_id: int | None = None,
        deadline_s: float | None = None,
        tenant: str = "default",
        slo_ttft_s: float | None = None,
        trace_id=None,
        trace_parent=0,
        trace_sampled: bool | None = None,
        parent_id: int | None = None,
    ) -> Request:
        """Queue one generation request; returns its handle immediately.
        Overload is reported on the handle (`status` REJECTED with
        `reject_reason`, `shed_code` and `retry_after_s`). `key` fixes the
        request's sampling stream: an int, or a uint32[2] pair taken as
        the stream key's two words (`models.decode.stream_key`); None
        derives one from the engine seed and the request id.
        `trace_id`/`trace_parent` join the request to an externally
        minted trace (the HTTP layer's, or an inbound W3C traceparent);
        with tracing enabled and no id supplied the engine mints one.
        Whether spans record is the per-tenant head-sampling decision,
        made here unless the caller passes `trace_sampled` (the server
        decides once per HTTP request so fan-out siblings sample
        together)."""
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
        if key is not None:
            stream_key(key)  # a malformed key fails here, not at admission
        prepare_request_tracing(req, trace_id, trace_parent, trace_sampled)
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
        key=None,
        eos_token_id: Any = "inherit",
        deadline_s: float | None = None,
        slo_ttft_s: float | None = None,
        trace_id=None,
        trace_parent=0,
        trace_sampled: bool | None = None,
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
            trace_id=trace_id,
            trace_parent=trace_parent,
            trace_sampled=trace_sampled,
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

    async def astream(self, request: Request) -> AsyncIterator[int]:
        """`stream()` for asyncio callers: yields control to the loop
        between engine steps so concurrent coroutines interleave."""
        sent = 0
        while True:
            while sent < len(request.tokens):
                yield request.tokens[sent]
                sent += 1
            if request.done or not self.step():
                break
            await asyncio.sleep(0)
        for tok in request.tokens[sent:]:
            yield tok

    # -- the drive loop ----------------------------------------------------

    def step(self) -> bool:
        """Run one scheduler action (admissions + one prefill chunk OR one
        batched decode step). Returns False when the engine is idle."""
        if self.metrics.started_at is None:
            self.metrics.started_at = self._clock()
        if self.watchdog is not None:
            self.watchdog.tick()
        self._admit_pending()
        action = self.scheduler.next_action()
        if action is None:
            self.metrics.stopped_at = self._clock()
            if self._sanitize:
                self._sanity_check()
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
        # keep the goodput gauge live for mid-run scrapes (host floats)
        self._goodput()
        if self._sanitize:
            self._sanity_check()
        return True

    def _sanity_check(self) -> None:
        """The serving-state sanitizer after a step; a violation writes
        an incident bundle (with `incident_dir` set) before it
        propagates."""
        try:
            check_engine(self)
        except SanitizerViolation as e:
            self._write_sanitizer_incident(e)
            raise

    def _write_sanitizer_incident(self, e: SanitizerViolation) -> None:
        from ..telemetry.watchdog import (
            build_exception_report,
            resolve_incident_dir,
            write_incident_bundle,
        )

        incident_dir = resolve_incident_dir(
            self.engine_config.incident_dir)
        if incident_dir is None:
            return
        try:
            report = build_exception_report(e, name="sanitizer")
            report["check"] = e.check
            report["details"] = e.details
            write_incident_bundle(
                incident_dir, report, registry=self.registry,
                dumps=self.incident_dumps(), name="sanitizer")
        except Exception:
            pass  # the violation itself must still propagate

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

    def _run_swap_in(self, slot: Slot, req: Request, alloc) -> None:
        """Install a host-resident prefix's bytes into the pages the
        allocator reserved for it, through the install program (one
        fixed [pages_per_slot] block, trash-padded, for every swap mix).
        int8 pools land codes + scales verbatim: byte-identical to what
        swap-out extracted. One install covers the whole admission: a
        matched prefix is at most pages_per_slot - 1 pages."""
        t0 = self._clock()
        rows = np.full((self.cache.pages_per_slot,), self.cache.trash_page,
                       np.int32)
        pages = []
        for i, (node, page) in enumerate(alloc.swap_ins):
            pages.append(self._host_tier.fetch(node))
            rows[i] = page
        with self._request_span("serving.swap_in", req, slot=slot.index,
                                pages=len(alloc.swap_ins)):
            self._swap_transport.install(rows, pages)
        self.metrics.note_swap_in(len(alloc.swap_ins), self._clock() - t0)

    def _run_admit(self, slot: Slot, req: Request) -> None:
        key = (derive_key(self.engine_config.seed, req.request_id)
               if req.key is None else stream_key(req.key))
        alloc = slot.alloc
        row = self._table[slot.index]
        row[:] = self.cache.trash_page
        row[:len(alloc.pages)] = alloc.pages
        if alloc.swap_ins:
            # host-resident prefix: land its bytes in the freshly reserved
            # pages BEFORE admit publishes the reused length
            self._run_swap_in(slot, req, alloc)
        self.metrics.note_admission(req.prompt_len, alloc.reused_len,
                                    host_pages=len(alloc.swap_ins or ()))
        self._set_page_gauges()
        if req.trace_sampled:
            # the queue-wait span is only known in retrospect: it closes
            # the moment admission happens
            record_span("serving.queue_wait", req.submitted_at,
                        req.admitted_at, trace=req.trace_id,
                        parent=req.span_id, tenant=req.tenant)
        if self._spec:
            slot.draft_done = 0
        self._ensure_cost("admit")
        with self.cost.maybe_sample("admit", fence_in=self.cache) as sample:
            with self._request_span("serving.admit", req, slot=slot.index,
                                    reused_len=alloc.reused_len):
                self._graphs("admit", slot.index, key, req.temperature,
                             alloc.reused_len)
            sample(self.cache)
        if self.on_admit is not None:
            self.on_admit(slot, req)

    def _upload_chunk(self, slot: Slot, start: int, real: int) -> None:
        chunk = self.engine_config.prefill_chunk
        ids = np.zeros((chunk,), np.int32)
        ids[:real] = slot.request.prompt[start:start + real]
        g = self._graphs
        g.upload("slot", np.array([slot.index], np.int64))
        g.upload("ids", ids)
        g.upload("real_len", np.array([real], np.int64))

    def _run_draft_chunk(self, slot: Slot, upto: int) -> None:
        """One draft-model prefill chunk over [draft_done, upto). Capped
        at `upto` (the target's prompt_done) so a catch-up over a reused
        prefix lands EXACTLY where the target sits."""
        start = slot.draft_done
        real = min(self.engine_config.prefill_chunk, upto - start)
        self._upload_chunk(slot, start, real)
        self._draft_prefill_call(slot, real)

    def _draft_prefill_call(self, slot: Slot, real: int) -> None:
        """Run the draft_prefill program on the chunk already in the
        input buffers (`real` tokens from `slot.draft_done`)."""
        self._ensure_cost("draft_prefill")
        with self.cost.maybe_sample(
                "draft_prefill", fence_in=self._draft_cache) as sample:
            with self._request_span("serving.draft_prefill", slot.request,
                                    slot=slot.index,
                                    chunk_start=slot.draft_done,
                                    chunk_tokens=real), \
                    self.timer.dispatch():
                self._graphs("draft_prefill")
            sample(self._draft_cache)
        slot.draft_done += real

    def _run_prefill_chunk(self, slot: Slot) -> None:
        chunk = self.engine_config.prefill_chunk
        req = slot.request
        if self._spec and slot.draft_done < slot.prompt_done:
            # the draft has no cached prefix to reuse: draft-only
            # catch-up chunks rebuild its prompt state up to the target's
            # reused length before the joint chunks begin (not counted in
            # prefill_chunks, which prices TARGET prefill work)
            self._run_draft_chunk(slot, slot.prompt_done)
            return
        start = slot.prompt_done  # includes the reused prefix on a hit
        real = min(chunk, req.prompt_len - start)
        self._upload_chunk(slot, start, real)
        self._graphs.upload("table", self._table)
        self._ensure_cost("prefill")
        with self.cost.maybe_sample(
                "prefill", fence_in=(self.cache, self._tokens)) as sample:
            with self._request_span("serving.prefill", req, slot=slot.index,
                                    chunk_start=start, chunk_tokens=real), \
                    self.timer.dispatch():
                lp = self._graphs("prefill")
            sample(self.cache)
        self.metrics.note_prefill_chunk()
        if self._spec:
            # joint chunk: the draft processes the same window (the
            # buffers still hold it), so both prompts complete together
            self._draft_prefill_call(slot, real)
        done = self.scheduler.note_prefill_chunk(slot, real)
        if req.share_prompt:
            # fork parent: every full prompt page this chunk completed
            # becomes shareable now
            self.allocator.publish_prompt(slot)
        if done:
            # the chunk that completed the prompt also produced the
            # request's first token: one element crosses to the host
            tok = int(self._tokens[slot.index])
            if self.scheduler.note_token(slot, tok, logprob=float(lp[0])):
                self._finalize_request(req)

    def _upload_step(self, slots: list[Slot]) -> np.ndarray:
        live = np.zeros((self.engine_config.num_slots,), bool)
        for s in slots:
            live[s.index] = True
        self._graphs.upload("table", self._table)
        self._graphs.upload("live", live)
        return live

    def _run_decode(self, slots: list[Slot]) -> None:
        if self._spec:
            self._run_spec_decode(slots)
            return
        self._upload_step(slots)
        # one decode step serves every live slot, so the step span
        # belongs to no single request: span links carry each sampled
        # request's trace id instead (bounded by num_slots)
        self._ensure_cost("decode")
        with self.cost.maybe_sample(
                "decode", fence_in=(self.cache, self._tokens)) as sample:
            with span("serving.decode", links=_links(slots)), \
                    self.timer.dispatch():
                lps = self._graphs("decode")
            sample(self.cache)
        toks = self._tokens.cpu().numpy()  # the per-step host read
        lps = lps.cpu().numpy()
        self.timer.tick(block_on=None)
        self.metrics.note_decode_step(
            "kernel" if self._use_paged_kernel else "dense")
        for s in slots:
            req = s.request
            if self.scheduler.note_token(s, int(toks[s.index]),
                                         logprob=float(lps[s.index])):
                self._finalize_request(req)

    def _run_spec_decode(self, slots: list[Slot]) -> None:
        """One speculative step for every decoding slot: draft K
        proposals per slot, verify them in ONE batched K-token target
        forward, commit the accepted prefix plus the correction token —
        between 1 and K tokens land per slot per step. The verify program
        hands the draft cache the committed lengths for live lanes; a
        non-live lane holding a request (mid-prefill) keeps its
        host-tracked draft progress, idle lanes restart at 0."""
        K = self.engine_config.draft_k
        live = self._upload_step(slots)
        restore = np.zeros((self.engine_config.num_slots,), np.int32)
        for s in self.scheduler.slots:
            if s.request is not None and not live[s.index]:
                restore[s.index] = s.draft_done
        self._graphs.upload("restore", restore)
        links = _links(slots)
        self._ensure_cost("draft")
        with self.cost.maybe_sample(
                "draft", fence_in=self._draft_cache) as sample:
            with span("serving.draft", links=links), self.timer.dispatch():
                self._graphs("draft")
            sample(self._draft_cache)
        self._ensure_cost("verify")
        with self.cost.maybe_sample(
                "verify", fence_in=(self.cache, self._tokens)) as sample:
            with span("serving.verify", links=links), self.timer.dispatch():
                committed, counts, n_acc, lps = self._graphs("verify")
            sample(self.cache)
        toks = committed.cpu().numpy()   # [S, K]: the per-step host read
        cnts = counts.cpu().numpy()
        accs = n_acc.cpu().numpy()
        lps = lps.cpu().numpy()
        self.timer.tick(block_on=None)
        self.metrics.note_decode_step("speculative")
        for s in slots:
            self.metrics.note_speculation(K, int(accs[s.index]))
            req = s.request
            for j in range(int(cnts[s.index])):
                if self.scheduler.note_token(
                        s, int(toks[s.index, j]),
                        logprob=float(lps[s.index, j])):
                    # retired mid-window (budget or EOS): the remaining
                    # committed tokens are discarded; their rows sit past
                    # the slot's final length and are never attended
                    self._finalize_request(req)
                    break

    # -- request tracing ---------------------------------------------------

    @staticmethod
    def _request_span(name: str, req: Request, **attrs):
        """A live span joined to the request's trace when it is sampled,
        the plain engine-wide span otherwise."""
        if req.trace_sampled:
            return span(name, trace=req.trace_id, parent=req.span_id,
                        **attrs)
        return span(name, **attrs)

    def _finalize_request(self, req: Request) -> None:
        """The one terminal path: close the request's trace, then fold it
        into the metrics (TTFT/per-token exemplars carry the trace id)."""
        self._fork_parents.pop(req.request_id, None)
        end = req.finished_at
        close_request_trace(req, self._clock() if end is None else end)
        self.metrics.observe_request(req)

    # -- live introspection ------------------------------------------------

    @staticmethod
    def _request_info(req: Request, now: float) -> dict:
        info = {
            "request_id": req.request_id,
            "trace_id": req.trace_id,
            "tenant": req.tenant,
            "status": req.status.value,
            "prompt_len": req.prompt_len,
            "max_new_tokens": req.max_new_tokens,
            "tokens": len(req.tokens),
            "age_s": round(now - req.submitted_at, 6),
        }
        if req.ttft_s is not None:
            info["ttft_s"] = round(req.ttft_s, 6)
        if req.slo_ttft_s is not None:
            info["slo_ttft_s"] = req.slo_ttft_s
        if req.deadline_s is not None:
            info["deadline_s"] = req.deadline_s
        if req.parent_id is not None:
            info["forked_from"] = req.parent_id
        if req.share_prompt:
            info["fork_parent"] = True
        return info

    def debug_requests(self) -> dict:
        """In-flight request state, queued and running. Read-only and
        JSON-safe."""
        now = self._clock()
        return {
            "queued": [self._request_info(r, now)
                       for r in self.scheduler.queue],
            "running": [self._request_info(s.request, now)
                        for s in self.scheduler.slots
                        if s.request is not None],
        }

    def debug_slots(self) -> list[dict]:
        """Slot occupancy: state, owning request, prefill progress, and
        how many pool pages each slot maps."""
        out = []
        for s in self.scheduler.slots:
            entry: dict[str, Any] = {"index": s.index,
                                     "state": s.state.value}
            if s.request is not None:
                entry.update({
                    "request_id": s.request.request_id,
                    "trace_id": s.request.trace_id,
                    "tenant": s.request.tenant,
                    "prompt_done": s.prompt_done,
                    "prompt_len": s.request.prompt_len,
                    "tokens": len(s.request.tokens),
                })
                if s.alloc is not None:
                    entry["pages"] = len(s.alloc.pages)
                    entry["reused_len"] = s.alloc.reused_len
            out.append(entry)
        return out

    def debug_pages(self) -> dict:
        """Page-pool and radix-tree state: capacity, occupancy, and the
        prefix-reuse counters (host-side totals, exact)."""
        alloc = self.allocator
        return {
            "page_size": alloc.page_size,
            "num_pages": self.cache.num_pages,
            "pages_in_use": alloc.pages_in_use,
            "pages_free": alloc.pages_free,
            "prefix_cache": alloc.prefix_cache,
            "cached_pages": alloc.index.cached_pages,
            "mapped_pages": alloc.index.mapped_pages,
            "prefix_lookups": alloc.lookups,
            "prefix_hits": alloc.hits,
            "tokens_reused": alloc.tokens_reused,
            "evictions": alloc.evictions,
            "host_pages": alloc.index.host_pages,
            **({"host_tier": self._host_tier.stats()}
               if self._host_tier is not None else {}),
        }

    def debug_scheduler(self) -> dict:
        """The scheduler's policy state (per-tenant queues, DRR deficits,
        SLO EMA, shed counters)."""
        return self.scheduler.debug_state()

    def incident_dumps(self) -> dict:
        """What an incident bundle freezes about this engine: the /debug
        snapshots, the capture counts and the device-cost table.
        Per-section best-effort: the watchdog thread calls this while the
        engine may still be mutating, and one section's failure must not
        cost the others."""
        out: dict[str, Any] = {}
        for name, build in (
            ("requests", self.debug_requests),
            ("slots", self.debug_slots),
            ("pages", self.debug_pages),
            ("scheduler", self.debug_scheduler),
            ("compile_stats", self.compile_stats),
            ("cost_table", self.cost.snapshot),
        ):
            try:
                out[name] = build()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- metrics -----------------------------------------------------------

    def _goodput(self) -> float | None:
        """Serving goodput: estimated device seconds spent producing
        tokens that were delivered, over wall-clock. Decode device time
        (sampled mean x steps) counts the fraction of slot lanes whose
        tokens reached a request; prefill counts the finished fraction of
        admissions. Queue waits, sheds and idle gaps are the gap to 1.0.
        None until a device-time sample and a wall window exist; the
        `serving_goodput` gauge tracks the latest value."""
        m = self.metrics
        if (m.started_at is None or m.stopped_at is None
                or m.stopped_at <= m.started_at):
            return None
        wall = m.stopped_at - m.started_at
        useful = 0.0
        # a speculative engine's verify step is its decode
        dec = self.cost.mean_device_time(
            "verify" if self._spec else "decode")
        steps = m.decode_steps
        lanes = self.engine_config.num_slots * (
            self.engine_config.draft_k if self._spec else 1)
        if dec is not None and steps:
            useful += dec * steps * min(1.0, m.tokens_out / (steps * lanes))
        pre = self.cost.mean_device_time("prefill")
        if pre is not None and m.prefill_chunks and m.prefix_lookups:
            useful += pre * m.prefill_chunks * min(
                1.0, m.finished / m.prefix_lookups)
        if useful <= 0.0:
            return None
        g = min(1.0, useful / wall)
        m.set_goodput(g)
        return g

    def reset_metrics(self) -> None:
        """Drop accumulated samples (e.g. after a warm-up pass). Captured
        programs, slot state and in-flight requests are untouched. The
        registry's series objects survive (zeroed in place); the static
        program costs are set again, and the device-time samples restart
        empty."""
        self.registry.reset()
        self.metrics = ServingMetrics(registry=self.registry)
        self.cost.republish()
        self.timer = StepTimer(warmup_steps=0, registry=self.registry,
                               name="serving_step")
        # page-pool gauges reflect CURRENT state, not a window: re-sync
        self._set_page_gauges()
        if self._host_tier is not None:
            self.metrics.set_host_tier_gauges(self._host_tier.pages_in_use,
                                              self._host_tier.bytes_in_use)
        # a warm-up pass's capture-heavy steps would otherwise inflate the
        # scheduler's step-time EMA (and every SLO / Retry-After estimate)
        self.scheduler.step_time_ema = 0.0

    def metrics_summary(self) -> dict[str, float]:
        """Flat serving metrics (TTFT/per-token percentiles, occupancy,
        queue depth, tokens/sec, prefix reuse), the pool capacity, the
        host dispatch meter, the decode and prefill rooflines (on a
        speculative engine the decode keys read the verify program),
        goodput and the program capture counts."""
        out = self.metrics.summary()
        out["pages_capacity"] = float(self.cache.num_pages)
        if self.timer._dispatch_hist.count:
            out["host_dispatch_us_mean"] = self.timer.host_dispatch_us
        decode_prog = "verify" if self._spec else "decode"
        for prog in (decode_prog, "prefill"):
            sheet = self.cost.roofline(prog) or {}
            name = "decode" if prog == decode_prog else prog
            if "device_time_mean_s" in sheet:
                out[f"{name}_device_time_mean_ms"] = (
                    sheet["device_time_mean_s"] * 1e3)
                out[f"{name}_device_time_p99_ms"] = (
                    sheet["device_time_p99_s"] * 1e3)
            if prog == decode_prog:
                for src, dst in (("mfu", "decode_mfu"),
                                 ("mxu_idle_fraction",
                                  "decode_mxu_idle_fraction"),
                                 ("hbm_bw_util", "decode_hbm_bw_util"),
                                 ("arith_intensity",
                                  "decode_arith_intensity")):
                    if src in sheet:
                        out[dst] = float(sheet[src])
        g = self._goodput()
        if g is not None:
            out["goodput"] = g
        out.update({f"compiles_{k}": float(v)
                    for k, v in self.compile_stats().items()})
        return out

    def close(self) -> None:
        """Stop the background threads (exporter, watchdog, the host
        tier's drain). Idempotent; the engine itself stays usable
        (evictions then destroy pages)."""
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self._host_tier is not None:
            self._host_tier.close()
