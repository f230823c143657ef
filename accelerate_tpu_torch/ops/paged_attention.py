"""Paged-attention decode: walk the page table inside the kernel.

Port of `accelerate_tpu/ops/paged_attention.py`. The serving engine's
decode step attends one new token per slot against that slot's pages of
the paged KV pool, in place: no dense gather of the pool, only a slot's
live pages are read, and the GQA group broadcast happens in the kernel.
On a CUDA tensor `paged_decode_attention` launches the hand-written
Hopper kernels of `csrc/paged_decode.cu` (or raises): each slot's pages
split across blocks of about 128 rows, then a combine pass over the
splits (flash-decoding); on a CPU tensor it runs `paged_decode_reference`,
the plain version with identical semantics.

Layout (per layer, as the family forward's layer loop hands it over):

- pool K/V: [num_pages + 1, page_size, Hkv, D]; the last page is the
  reserved trash page backing padded table entries;
- page table: [slots, pages_per_slot] int32; lengths: [slots] int32;
- q: one token per slot, grouped as [slots, Hkv, group, D];
- the new token's K/V (position == length) is folded into the online
  softmax as a final single-key update instead of being written first:
  the kernel never writes the pool, the engine appends the returned rows
  afterwards (`serving.cache.paged_append_rows`);
- int8 pools (`PagedKV.scales` set) are dequantized inside the kernel.

Masking matches `models.decode.cached_attention_mask`: a slot's query
attends pool rows < length plus its own new K/V; `window` keeps keys
with q - key < window. Retired slots (all-trash tables) compute garbage
that the engine discards.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

__all__ = [
    "PagedKV",
    "PagedDecodeMeta",
    "paged_decode_attention",
    "paged_decode_reference",
]

# the kernel's dtype codes (csrc/paged_decode.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_GROUP = 16
_SMEM_LIMIT = 232448      # a block's shared memory on an H100
_SPLIT_ROWS = 128         # pool rows of one split (one block)


class PagedKV:
    """One pool buffer (K or V) as it threads through a family forward.

    `data` is the [L, pages+1, page_size, Hkv, D] pool, or one layer of
    it (`pk[l]`); `scales` is the int8 mode's matching [..., Hkv] bf16
    per-row-per-head scales, None for a float pool. `compute_dtype` is
    the dtype K/V rows materialize in (and of the new-token rows handed
    back for the engine to write); None means `data.dtype` for a float
    pool and bfloat16 for an int8 pool.

    The `is_paged_kv` marker lets `models.decode.decode_attention`
    dispatch on the cache flavour."""

    is_paged_kv = True

    def __init__(self, data, scales=None, compute_dtype=None):
        self.data = data
        self.scales = scales
        self.compute_dtype = compute_dtype

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def row_dtype(self):
        """The dtype K/V rows materialize in (see class docstring)."""
        if self.compute_dtype is not None:
            return self.compute_dtype
        return torch.bfloat16 if self.quantized else self.data.dtype

    def __getitem__(self, layer: int) -> "PagedKV":
        """One layer's view of a stacked pool (no copy)."""
        return PagedKV(self.data[layer],
                       None if self.scales is None else self.scales[layer],
                       self.compute_dtype)


class PagedDecodeMeta:
    """The paged decode step's per-slot addressing, riding the family
    cache tuple's third slot (where the dense path carries `cache_len`).

    `table` [slots, pages_per_slot] int32 and `lengths` [slots] int32 are
    device data; `rows` (pages_per_slot * page_size) is what
    `rope_table_len` sizes the rotary tables by. Families advance the
    dense `cache_len` with `+ seq_len` when returning new caches;
    `__add__` absorbs that as a no-op, because the per-slot length
    advance is the engine's job (in `paged_append_rows`)."""

    is_paged_meta = True

    def __init__(self, table, lengths, rows: int):
        self.table = table
        self.lengths = lengths
        self.rows = rows

    def __add__(self, other):
        return self


def _lib():
    from ..csrc import load

    lib = load("paged_decode")
    fn = lib.paged_decode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, ci] + [vp] * 13 + [ci] * 9 + [
            ctypes.c_float, vp]
        fn.restype = ci
    return lib


def _split_plan(pages_per_slot: int, page_size: int) -> tuple[int, int]:
    """(pages per split, splits per slot): a split owns a fixed run of
    about `_SPLIT_ROWS` rows (at least one page) of the slot's table row.
    Both come from shapes, so sizing the kernel's scratch reads nothing
    from the device."""
    pps = max(1, _SPLIT_ROWS // page_size)
    return pps, -(-pages_per_slot // pps)


def _split_smem(page_size: int, D: int, elt: int, G: int,
                stages: int = 2) -> int:
    """Shared memory of a split block (`csrc/paged_decode.cu`
    `split_smem`): a ring of `stages` pages, q in f32, the split's
    scores, m and l per query head, the split's page ids, and the P.V
    sums of all but one row group of threads; the group is G rounded up
    to the kernel's width (4, 8 or 16). The kernel deepens the ring to
    four pages where that fits."""
    kg = 16 if D > 256 or G > 8 else 8 if G > 4 else 4
    groups = max(D, 256) // D
    pps, _ = _split_plan(1, page_size)
    rows = pps * page_size
    return stages * page_size * D * elt + 4 * (
        kg * D + kg * rows + 2 * kg + pps + (groups - 1) * kg * D)


def _check_kernel_inputs(q4, k_row, pk: PagedKV, pv: PagedKV,
                         meta: PagedDecodeMeta) -> None:
    S, Hkv, G, D = q4.shape
    dev = q4.device
    tensors = {"pool K": pk.data, "pool V": pv.data, "page table":
               meta.table, "lengths": meta.lengths}
    if pk.quantized:
        tensors.update({"K scales": pk.scales, "V scales": pv.scales})
    for what, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    for what in ("pool K", "pool V"):
        if tensors[what].data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q4.dtype} not supported")
    if k_row.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K/V row dtype {k_row.dtype} not supported")
    if pk.data.dtype not in _DTYPE_CODE or pv.data.dtype != pk.data.dtype:
        raise ValueError(
            f"pool dtypes {pk.data.dtype}/{pv.data.dtype} not supported")
    if pk.quantized != (pk.data.dtype == torch.int8) or \
            pv.quantized != pk.quantized:
        raise ValueError("int8 pools need scales for both K and V, float "
                         "pools none")
    if pk.data.ndim != 4 or pk.data.shape[2:] != (Hkv, D) or \
            pv.data.shape != pk.data.shape:
        raise ValueError(
            f"pool shape {tuple(pk.data.shape)} does not match "
            f"[pages+1, page_size, {Hkv}, {D}]")
    if pk.quantized and (pk.scales.dtype != torch.bfloat16
                         or pk.scales.shape != pk.data.shape[:3]
                         or pv.scales.shape != pk.scales.shape
                         or pv.scales.dtype != torch.bfloat16):
        raise ValueError("scales must be bf16 [pages+1, page_size, Hkv]")
    if meta.table.dtype != torch.int32 or meta.lengths.dtype != torch.int32:
        raise ValueError("page table and lengths must be int32")
    if meta.table.ndim != 2 or tuple(meta.lengths.shape) != (S,):
        raise ValueError("page table must be [S, P] and lengths [S]")
    if G > _MAX_GROUP or D % 32 or not 32 <= D <= 1024:
        raise ValueError(
            f"kernel takes a GQA group <= {_MAX_GROUP} and head_dim a "
            f"multiple of 32 in [32, 1024]; got group {G}, head_dim {D}")
    ps = pk.data.shape[1]
    smem = _split_smem(ps, D, pk.data.element_size(), G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"page of {ps} rows needs {smem} B of shared "
                         f"memory, over {_SMEM_LIMIT}")


def paged_decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pk: PagedKV,
    pv: PagedKV,
    meta: PagedDecodeMeta,
    window: int | None = None,
):
    """One decode step of paged attention for every slot at once.

    q: [S, 1, H, D] (S slots, one token each, H = Hkv * group);
    k_new/v_new: [S, 1, Hkv, D], this step's K/V, folded in and returned
    (cast to the pool's row dtype) for the engine to append.
    Returns (out [S, 1, H, D], (k_row, v_row) both [S, 1, Hkv, D]).

    A CUDA tensor launches `csrc/paged_decode.cu`, its split and combine
    kernels (and adds one to `paged_decode_attention.launches`); a CPU
    tensor runs `paged_decode_reference`."""
    S, sq, H, D = q.shape
    if sq != 1:
        raise ValueError(
            f"paged decode attention is one token per slot; got S_q={sq} "
            "(chunked prefill stays on the dense-gather path)")
    Hkv = k_new.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads ({H}) not a multiple of kv heads ({Hkv})")
    if meta.table.shape[0] != S:
        raise ValueError(
            f"page table covers {meta.table.shape[0]} slots, q has {S}")
    if window is not None and (window <= 0 or window >= meta.rows):
        window = None  # band wider than the cache reach: plain causal
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_new, v_new, pk, pv, meta, window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    G = H // Hkv
    row_dtype = pk.row_dtype
    # the fold must see exactly the bytes the engine will write, so a
    # later step reading the row from the pool agrees with this step
    k_row = k_new.to(row_dtype)
    v_row = v_new.to(row_dtype)
    q4 = q.reshape(S, Hkv, G, D).contiguous()
    kr = k_row.reshape(S, Hkv, D).contiguous()
    vr = v_row.reshape(S, Hkv, D).contiguous()
    _check_kernel_inputs(q4, kr, pk, pv, meta)
    if kr.device != q4.device or vr.device != q4.device:
        raise ValueError("new K/V rows must be on q's device")
    P, ps = meta.table.shape[1], pk.data.shape[1]
    pps, nsplit = _split_plan(P, ps)
    # one f32 scratch for the splits' partials: m [S, Hkv, nsplit, G],
    # then l, then the unnormalised P.V rows [S, Hkv, nsplit, G, D]
    n = S * Hkv * nsplit * G
    part = torch.empty(n * (2 + D), dtype=torch.float32, device=q4.device)
    scratch = part.data_ptr()
    out = torch.empty_like(q4)
    rc = _lib().paged_decode(
        _DTYPE_CODE[q4.dtype], _DTYPE_CODE[pk.data.dtype],
        _DTYPE_CODE[row_dtype], q4.data_ptr(), kr.data_ptr(), vr.data_ptr(),
        pk.data.data_ptr(), pv.data.data_ptr(),
        pk.scales.data_ptr() if pk.quantized else None,
        pv.scales.data_ptr() if pv.quantized else None,
        meta.table.data_ptr(), meta.lengths.data_ptr(), scratch,
        scratch + 4 * n, scratch + 8 * n, out.data_ptr(),
        S, Hkv, G, D, P, ps, pps, nsplit,
        0 if window is None else int(window), 1.0 / math.sqrt(D),
        torch._C._cuda_getCurrentRawStream(q4.device.index))
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: error {rc}")
    paged_decode_attention.launches += 1
    return out.reshape(S, 1, H, D), (k_row, v_row)


paged_decode_attention.launches = 0


def paged_decode_reference(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pk: PagedKV,
    pv: PagedKV,
    meta: PagedDecodeMeta,
    window: int | None = None,
):
    """Dense-gather reference with identical semantics (and the
    executable spec of them): gather every table page, dequantize,
    overlay the new token's row at position == length, mask rows the
    query may not see, plain f32 softmax."""
    S, _, H, D = q.shape
    Hkv = k_new.shape[2]
    G = H // Hkv
    ps = pk.data.shape[1]
    R = meta.table.shape[1] * ps
    row_dtype = pk.row_dtype
    table = meta.table.long()
    lengths = meta.lengths.long()

    def dense(p: PagedKV):
        full = p.data[table].float()                     # [S, P, ps, Hkv, D]
        if p.quantized:
            full = full * p.scales[table].float()[..., None]
        return full.reshape(S, R, Hkv, D)

    k_all, v_all = dense(pk), dense(pv)
    k_row = k_new.to(row_dtype)
    v_row = v_new.to(row_dtype)
    rows = torch.arange(R, device=q.device)
    sel = (rows[None, :] == lengths[:, None])[:, :, None, None]
    k_all = torch.where(sel, k_row.float(), k_all)
    v_all = torch.where(sel, v_row.float(), v_all)
    keep = rows[None, :] <= lengths[:, None]
    if window is not None and window < R:
        keep = keep & (rows[None, :] > lengths[:, None] - window)
    q4 = q[:, 0].reshape(S, Hkv, G, D).float()
    s = torch.einsum("shgd,srhd->shgr", q4, k_all) / math.sqrt(D)
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("shgr,srhd->shgd", p, v_all)
    return out.reshape(S, 1, H, D).to(q.dtype), (k_row, v_row)
