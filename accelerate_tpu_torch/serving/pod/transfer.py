"""Pod layer 2 plumbing: KV pages as the unit of prefill->decode transfer
(port of `accelerate_tpu/serving/pod/transfer.py`).

The paged cache (serving/cache.py) makes a request's KV state a list of
fixed-size, location-free pages, which is what makes disaggregation
possible: a prefill worker computes a prompt's KV into its own pool, and
the pages ship to a decode worker that owns the slot for the request's
decode lifetime. This module is the device-side half of that hand-off:

- `extract`: gather one slot's table row out of the pool into a dense
  [L, pages_per_slot, page_size, H(, D)] block per buffer. Fixed shape:
  the block always spans the full table row (trash-padded entries gather
  the trash page), so one captured program serves every extraction. The
  host then copies only the `n_prompt_pages` that carry prompt KV: the
  block is sliced on the device and only those pages cross to host
  memory, so the host bytes are the shipment's `page_bytes`.
- `install`: scatter a shipped block into the decode worker's pool at
  its freshly allocated pages (the row trash-padded past the prompt
  pages, so the dead lanes write only the trash page) and seed the
  slot's last-token register with the first token the prefill worker
  sampled. Also one program.

Both are engine programs (serving/graphs.py), captured once as CUDA
graphs on a CUDA engine. They register as `ship_extract`/`ship_install`
beside the host tier's page-at-a-time `extract`/`install`
(serving/transfer.py), and `compile_stats()` reports them under the
reference's names, `extract` and `install`.

Correctness under sharing: the decode worker's allocator may match a
prefix of the shipped prompt in its own radix tree, in which case the
leading allocated pages are mapped copy-on-write. Installing over them
is safe: both workers run identical programs over identical params, so a
shared prompt page's shipped bytes are the cached page's bytes. Rows past
`prompt_len` in the last shipped page are masked by the position
invariant and overwritten by the decode worker's own appends.

`KVPageShipment` is plain host data (numpy arrays and ints): it is the
wire format. numpy has no bfloat16, so bf16 pages and int8 scales travel
as their raw 16-bit words in arrays of dtype `BF16_WORDS` (uint16 with
the wire's "bfloat16" tag in its metadata); `to_tensor` views them back
as `torch.bfloat16`. int8 pools ship their codes and scales verbatim,
never dequantized and requantized.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ...models.decode import derive_key, stream_key

__all__ = ["KVPageShipment", "PageTransport", "place_shipment",
           "BF16_WORDS", "to_host_array", "to_tensor"]

# uint16 words of bfloat16 values; the metadata carries the wire's dtype
# tag, and numpy keeps it through views, slices and copies
BF16_WORDS = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def to_host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bf16 as `BF16_WORDS` (no copy)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def to_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of `dtype`: uint16 arrays are bf16
    words (the wire's form) and are viewed, not converted; anything else
    converts."""
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        # a decoded frame is a read-only buffer; the tensor is only read
        warnings.simplefilter("ignore", UserWarning)
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t if t.dtype == dtype else t.to(dtype)


@dataclasses.dataclass
class KVPageShipment:
    """One prompt's prefilled KV state, in transit prefill -> decode.

    `k_pages`/`v_pages` are [L, pages, page_size, H, D] host arrays whose
    first `n_prompt_pages` pages carry the prompt's KV; the port ships
    exactly those (the reference's fixed-shape block also carries the
    trash-padded rest, which install ignores). `first_token` is the first
    generated token, sampled on the prefill worker from the final prompt
    logits, so the decode worker starts from the state a single-engine
    prefill would have left."""

    prompt: np.ndarray
    first_token: int
    n_prompt_pages: int
    k_pages: np.ndarray
    v_pages: np.ndarray
    key_raw: np.ndarray          # uint32[2]: the request's sampling key
    temperature: float
    max_new_tokens: int
    eos_token_id: int | None
    src_worker: int = -1
    extracted_at: float = 0.0    # router clock; the page_transfer span start
    # the first token's model logprob, so the decode side's logprob list
    # stays aligned with its tokens
    first_logprob: float | None = None
    # int8 pools ship their codes as-is plus the per-row-per-head scale
    # blocks ([L, pages, page_size, H]); None on float pools
    k_scales: np.ndarray | None = None
    v_scales: np.ndarray | None = None

    @property
    def page_bytes(self) -> int:
        """Real payload bytes (prompt pages only), the number a transport
        puts on the wire."""
        per_page = self.k_pages[:, 0].nbytes + self.v_pages[:, 0].nbytes
        if self.k_scales is not None:
            per_page += self.k_scales[:, 0].nbytes + self.v_scales[:, 0].nbytes
        return self.n_prompt_pages * per_page


_SHIP_FIELDS = {"k": "k_pages", "v": "v_pages", "k_scale": "k_scales",
                "v_scale": "v_scales"}


class PageTransport:
    """One engine's shipment extract/install pair and their buffers.

    Shapes are fixed by the engine's pool, so each program is captured
    once per engine lifetime whatever the request mix, prompt lengths or
    hit pattern."""

    def __init__(self, engine):
        self._engine = engine
        cache = engine.cache
        runner = engine._graphs
        self._runner = runner
        self._cache = cache
        self._cuda = cache.k.device.type == "cuda"
        self._quantized = cache.quantized
        self._names = (("k", "v", "k_scale", "v_scale") if cache.quantized
                       else ("k", "v"))
        P = cache.pages_per_slot
        self._rows = runner.buffer("ship_rows", (P,), torch.int32)
        self._slot = runner.buffer("ship_slot", (1,), torch.int64)
        self._first = runner.buffer("ship_first", (1,), torch.int32)
        # the install block lives at a fixed address the graph reads;
        # made at the first install (a prefill-only worker never needs it)
        self._block: dict | None = None
        runner.add("ship_extract", self._extract)
        runner.add("ship_install", self._install)

    def compile_stats(self) -> dict[str, int]:
        stats = self._runner.captures()
        return {"extract": stats["ship_extract"],
                "install": stats["ship_install"]}

    # -- programs ------------------------------------------------------------

    def _extract(self):
        rows = self._rows.long()
        return tuple(getattr(self._cache, name).index_select(1, rows)
                     for name in self._names)

    def _install(self):
        rows = self._rows.long()
        for name in self._names:
            getattr(self._cache, name).index_copy_(1, rows,
                                                   self._block[name])
        self._engine._tokens.index_copy_(0, self._slot, self._first)

    def _row(self, pages) -> np.ndarray:
        row = np.full((self._cache.pages_per_slot,), self._cache.trash_page,
                      np.int32)
        row[:len(pages)] = pages
        return row

    # -- prefill side --------------------------------------------------------

    def extract_block(self, pages) -> dict:
        """Run the extract program over the slot's `pages`: {name: device
        block [L, pages_per_slot, ps, H(, D)]}. The block is the graph's
        output, rewritten by the next extraction."""
        self._runner.upload("ship_rows", self._row(pages))
        return dict(zip(self._names, self._runner("ship_extract")))

    def to_host(self, block: dict, n_pages: int) -> dict:
        """The first `n_pages` pages of an extracted block in host memory,
        {name: numpy [L, n_pages, ps, H(, D)]}: sliced on the device, then
        one copy each into pinned memory; returns once the copies landed."""
        out = {}
        for name, t in block.items():
            part = t[:, :n_pages]
            if self._cuda:
                host = torch.empty(part.shape, dtype=part.dtype,
                                   pin_memory=True)
                host.copy_(part.contiguous(), non_blocking=True)
                out[name] = host
            else:
                out[name] = part.clone()
        if self._cuda:
            torch.cuda.current_stream(self._cache.k.device).synchronize()
        return {name: to_host_array(t) for name, t in out.items()}

    def extract_shipment(self, pages: list[int], request,
                         src_worker: int = -1,
                         extracted_at: float = 0.0) -> KVPageShipment:
        """Pull a prefilled slot's pages off this worker into a shipment.
        `pages` is the slot's allocation (recorded at admission); the
        request must still hold them: extract before the slot's pages can
        be reallocated (the next admission)."""
        eng = self._engine
        n_prompt = -(-request.prompt_len // self._cache.page_size)
        host = self.to_host(self.extract_block(pages), n_prompt)
        key = (derive_key(eng.engine_config.seed, request.request_id)
               if request.key is None else stream_key(request.key))
        return KVPageShipment(
            prompt=request.prompt,
            first_token=int(request.tokens[0]),
            first_logprob=(float(request.logprobs[0])
                           if request.logprobs else None),
            n_prompt_pages=n_prompt,
            k_pages=host["k"],
            v_pages=host["v"],
            key_raw=np.asarray(key, np.uint32),
            temperature=request.temperature,
            max_new_tokens=request.max_new_tokens,
            eos_token_id=request.eos_token_id,
            src_worker=src_worker,
            extracted_at=extracted_at,
            k_scales=host.get("k_scale"),
            v_scales=host.get("v_scale"),
        )

    # -- decode side ---------------------------------------------------------

    def _upload_block(self, shipment: KVPageShipment) -> None:
        """Copy the shipment's prompt pages into the install block (host
        to device; on the card from pinned memory, asynchronously)."""
        if self._block is None:
            self._block = {
                name: torch.zeros(
                    (pool.shape[0], self._cache.pages_per_slot)
                    + tuple(pool.shape[2:]), dtype=pool.dtype,
                    device=pool.device)
                for name in self._names
                for pool in (getattr(self._cache, name),)}
        n = shipment.n_prompt_pages
        for name in self._names:
            dst = self._block[name]
            src = to_tensor(getattr(shipment, _SHIP_FIELDS[name])[:, :n],
                            dst.dtype)
            if self._cuda:
                src = src.pin_memory().to(dst.device, non_blocking=True)
            dst[:, :n].copy_(src)

    def install_shipment(self, shipment: KVPageShipment, slot_index: int,
                         alloc) -> None:
        """Land a shipment in this decode worker: pages scattered into the
        allocation's pages, the last-token register seeded, then the
        ordinary admit program sets the slot's length to the full prompt
        (to the pool a shipped prompt is a fully reused prefix), its key
        and its temperature. After this the slot decodes exactly as if
        the worker had prefilled the prompt itself."""
        eng = self._engine
        n = shipment.n_prompt_pages
        self._upload_block(shipment)
        self._runner.upload("ship_rows", self._row(alloc.pages[:n]))
        self._runner.upload("ship_slot", np.array([slot_index], np.int64))
        self._runner.upload("ship_first",
                            np.array([shipment.first_token], np.int32))
        self._runner("ship_install")
        eng._graphs("admit", slot_index, stream_key(shipment.key_raw),
                    float(shipment.temperature),
                    int(shipment.prompt.shape[0]))


def place_shipment(engine, transport: PageTransport, shipment: KVPageShipment,
                   now: float):
    """Land one shipment on `engine` end to end: internal Request built
    from the shipment, pages allocated (prefix-reuse aware), slot adopted
    RUNNING, table row written, pages installed, stale host mirrors
    dropped, first token and admission booked. Returns
    ``(internal, slot, alloc)`` or ``None`` when the engine has no free
    slot or pages right now (nothing mutated on None).

    The one placement path shared by the in-process
    `PodRouter._try_install` and the multi-process worker's `install`
    handler: the process boundary must not fork the landing semantics."""
    from ..scheduler import Request

    if engine.scheduler.live_slots >= len(engine.scheduler.slots):
        return None
    internal = Request(
        prompt=np.asarray(shipment.prompt, np.int32),
        max_new_tokens=shipment.max_new_tokens,
        temperature=shipment.temperature,
        key=np.asarray(shipment.key_raw, np.uint32),
        eos_token_id=shipment.eos_token_id,
    )
    # nothing that can raise may sit between allocate and the
    # adopt/rollback pair that owns its outcome
    alloc = engine.allocator.allocate(internal)
    if alloc is None:
        return None
    internal.submitted_at = now
    slot = engine.scheduler.adopt_running(internal, alloc, now=now)
    if slot is None:               # raced: give the pages back
        engine.allocator.rollback(alloc)
        return None
    engine._table[slot.index, :] = engine.cache.trash_page
    engine._table[slot.index, :len(alloc.pages)] = alloc.pages
    transport.install_shipment(shipment, slot.index, alloc)
    # host-resident prefix chunks were re-homed to fresh pages by
    # allocate(); the shipment just wrote those pages with the bytes the
    # mirror holds, so the mirror is dead: drop it instead of fetching
    if alloc.swap_ins:
        for node, _page in alloc.swap_ins:
            engine._host_tier.discard(node)
    # seed the first token so EOS/budget accounting continues where the
    # prefill worker left off; its logprob rides the shipment
    engine.scheduler.note_token(slot, shipment.first_token, now=now,
                                logprob=shipment.first_logprob)
    engine.metrics.note_admission(
        internal.prompt_len, alloc.reused_len,
        host_pages=len(alloc.swap_ins or ()))
    return internal, slot, alloc
