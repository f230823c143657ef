"""Shared KV-cache decode and `generate` (port of
`accelerate_tpu/models/decode.py`).

- caches stack on a leading layer dim ([L, B, M, H, D]) and the family
  forward loops over layers, indexing views of the stacked tensors;
- `cache_len` is a python int, a 0-dim tensor, or a [B] tensor of
  per-row lengths — the last is the port's form of the reference's
  per-slot `vmap`: every row writes and masks at its own position;
- cache writes land in place in the caller's buffers (the reference
  returns updated copies; the port saves the copy);
- sampling is a counter-based hash in torch integer ops, so token i of a
  stream is a pure function of (key, position) and the same bits come out
  on the CPU and the card (JAX's threefry cannot be reproduced in torch).
"""

from __future__ import annotations

import torch

from .common import dot_product_attention, repeat_kv
from ..device import resolve_device


def make_kv_caches(num_layers: int, batch: int, max_len: int,
                   num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                   device=None):
    """Stacked decode caches: (k [L, B, M, H, D], v [L, B, M, H, D],
    cache_len 0)."""
    dev = resolve_device(device)
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev), 0)


def rope_table_len(config_max: int, kv_caches) -> int:
    """Rotary-table length covering both the config's trained range and
    the cache reach: decoding past max_position_embeddings must extend the
    angles, not index past the table."""
    if kv_caches is None:
        return config_max
    if getattr(kv_caches[2], "is_paged_meta", False):
        # paged pool: the cache reach is one slot's view (pages_per_slot
        # * page_size), not the pool's page count
        return max(config_max, kv_caches[2].rows)
    return max(config_max, kv_caches[0].shape[2])


def extend_cache(kv_cache, k, v):
    """Write this step's K/V [B, S, H, D] at cache_len, in place.

    `cache_len` is an int or 0-dim tensor (every row at one depth) or a
    [B] tensor (row b writes at cache_len[b]). Returns (k_full, v_full,
    new_cache): the whole [B, M, H, D] buffers (attend over them with a
    position mask — see `cached_attention_mask`) and the cache with
    cache_len advanced by S."""
    ck, cv, cache_len = kv_cache
    B, S = k.shape[:2]
    if isinstance(cache_len, int):
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
    else:
        start = cache_len.long().expand(B)
        pos = start[:, None] + torch.arange(S, device=ck.device)
        rows = torch.arange(B, device=ck.device)[:, None].expand(B, S)
        ck[rows, pos] = k.to(ck.dtype)
        cv[rows, pos] = v.to(cv.dtype)
    return ck, cv, (ck, cv, cache_len + S)


def cached_attention_mask(k_len: int, positions, mask=None):
    """[B, S_q, S_k] decode mask: query at position p attends to cached
    positions <= p (causality holds within the prefill chunk too). An
    optional [B, S_k] key-padding mask over the WHOLE cache ANDs in."""
    if mask is not None and mask.shape[-1] != k_len:
        raise ValueError(
            f"attention_mask covers {mask.shape[-1]} positions but the KV "
            f"cache holds {k_len}; on the decode path the mask must span the "
            "whole cache — pad it to the cache length (1 = attend)"
        )
    kv_mask = (torch.arange(k_len, device=positions.device)[None, None, :]
               <= positions[:, :, None])
    return kv_mask if mask is None else mask[:, None, :].bool() & kv_mask


def windowed_cached_attention_mask(k_len: int, positions, mask=None,
                                   window: int | None = None):
    """`cached_attention_mask` with a sliding window: cached keys older
    than `window` positions (q - key >= window, HF Mistral convention)
    drop out, so single-token decode steps past the window match the full
    forward."""
    kv_mask = cached_attention_mask(k_len, positions, mask)
    if window is None:
        return kv_mask
    in_band = (torch.arange(k_len, device=positions.device)[None, None, :]
               > positions[:, :, None] - window)
    return kv_mask & in_band


def decode_attention(q, k, v, kv_cache, positions, mask=None,
                     window: int | None = None, n_rep: int = 1):
    """The decode-path cache-attend step every causal family shares:
    write this step's K/V into the cache, attend over it, return
    (attn_out, new_cache). Dispatches on the cache flavour:

    - dense stacked caches ((k, v, cache_len) of [B, M, Hkv, D]
      buffers): `extend_cache`, `windowed_cached_attention_mask`, GQA
      `repeat_kv`, then `dot_product_attention`;
    - the serving engine's paged pool (`ops.paged_attention.PagedKV`
      pair + `PagedDecodeMeta` in the cache_len slot): the paged decode
      op walks each slot's live pages in place, GQA broadcast inside.
      `new_cache` then carries this step's per-slot K/V ROWS ([B, 1, Hkv,
      D], in the pool's row dtype) for the engine to append."""
    if getattr(kv_cache[0], "is_paged_kv", False):
        from ..ops.paged_attention import paged_decode_attention

        if mask is not None:
            raise ValueError(
                "key-padding masks are not supported on the paged decode "
                "path (the engine's position masking is in-kernel)")
        pk, pv, meta = kv_cache
        out, (k_row, v_row) = paged_decode_attention(q, k, v, pk, pv, meta,
                                                     window=window)
        return out, (k_row, v_row, meta)
    k_full, v_full, new_cache = extend_cache(kv_cache, k, v)
    m = windowed_cached_attention_mask(k_full.shape[1], positions, mask,
                                       window)
    out = dot_product_attention(q, repeat_kv(k_full, n_rep),
                                repeat_kv(v_full, n_rep), mask=m,
                                causal=False)
    return out, new_cache


# --- sampling ---------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), with every partial
    product below 2**63 (no signed overflow on any backend)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (the "lowbias32" mixer) on int64 tensors
    holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def stream_key(key: int) -> tuple[int, int]:
    """The two 32-bit words of a sampling key (any python int)."""
    key = int(key) & 0xFFFFFFFFFFFFFFFF
    return key & _M32, key >> 32


def derive_key(seed: int, index: int) -> tuple[int, int]:
    """A stream key for item `index` (a request id, a batch row) under an
    engine-wide `seed`: distinct indices give unrelated streams."""
    k0, k1 = stream_key(seed)
    return (_mix32_int(k0 ^ _mix32_int(index)),
            _mix32_int(k1 ^ _mix32_int(index ^ 0x9E3779B9)))


def gumbel_noise(keys: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, vocab] f32 Gumbel noise, a pure function of (key, position,
    token id): `keys` [B, 2] int64 (uint32 words), `positions` [B]."""
    k = keys.long()
    row = _mix32(_mix32(_mix32(k[:, 0]) ^ k[:, 1]) ^ (positions.long() & _M32))
    ids = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    h = _mix32(row[:, None] ^ _mix32((ids + 0x9E3779B9) & _M32))
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))   # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_token(logits, keys, temperature: float, positions=None):
    """Next token from the last position's logits [B, S, V]: argmax (the
    first maximum) at temperature 0, else Gumbel-max sampling of
    softmax(logits / temperature) with noise keyed by (`keys` [B, 2],
    `positions` [B], the sampled token's position). The one sampling rule
    shared by `generate` and the serving engine."""
    last = logits[:, -1]
    if temperature == 0.0:
        return torch.argmax(last, dim=-1)
    noise = gumbel_noise(keys, positions, last.shape[-1])
    return torch.argmax(last.float() / temperature + noise, dim=-1)


def build_generate(forward, init_caches):
    """Greedy/temperature `generate` for a causal family: prompt in,
    prompt + new tokens out. `forward(config, params, input_ids,
    positions=..., kv_caches=...)` returns (logits, new_caches) on the
    cached path; `init_caches(config, batch, max_len, device=...)` builds
    the stacked caches. Row b of the batch samples with the stream
    `derive_key(key, b)`."""

    def generate(config, params, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, key: int = 0):
        b, prompt_len = input_ids.shape
        dev = input_ids.device
        total = prompt_len + max_new_tokens
        # the reference buckets the cache length to a multiple of 32;
        # rows past `total` are never written and always masked
        limit = getattr(config, "max_position_embeddings", None) or total
        caches = init_caches(config, b, min(max(-(-total // 32) * 32, total),
                                            max(limit, total)), device=dev)
        keys = torch.tensor([derive_key(key, i) for i in range(b)],
                            dtype=torch.int64, device=dev)
        logits, caches = forward(config, params, input_ids, kv_caches=caches)
        pos = torch.full((b,), prompt_len, dtype=torch.int64, device=dev)
        last = sample_token(logits, keys, temperature, pos)
        out = [last]
        for i in range(max_new_tokens - 1):
            logits, caches = forward(
                config, params, last[:, None],
                positions=(pos + i)[:, None], kv_caches=caches)
            last = sample_token(logits, keys, temperature, pos + i + 1)
            out.append(last)
        return torch.cat([input_ids, torch.stack(out, dim=1).to(
            input_ids.dtype)], dim=1)

    return generate
