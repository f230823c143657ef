"""Shared pure-function model components (port of
`accelerate_tpu/models/common.py`).

Same functions, same layouts ([B, S, H, D] activations, [d_in, d_out]
kernels), same numerics contract: matmuls accumulate in f32 and cast to
the input dtype, norms and softmax run in f32, and dtype promotion follows
JAX's (a bf16 result times an f32 scale is f32).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

NEG_INF = -1e30


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ kernel with f32 accumulation, cast back to x's dtype. For a
    bf16 product cuBLAS (and the CPU GEMM) accumulate in f32 and round the
    result once, which is the reference's `preferred_element_type=f32`
    followed by `.astype(x.dtype)`."""
    ct = torch.promote_types(x.dtype, kernel.dtype)
    out = torch.matmul(x.to(ct), kernel.to(ct)).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * scale


# --- rotary embeddings ------------------------------------------------------


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     scaling: dict | None = None, device=None) -> tuple:
    """Rotary cos/sin tables [max_len, head_dim/2] f32, optionally
    frequency-scaled (`scaling` is the HF `rope_scaling` dict: "linear" or
    "llama3"). Computed in float64 numpy and cast to f32, exactly as the
    reference does; cached per (shape, scaling, device), so callers must
    not write into the returned tensors."""
    items = tuple(sorted(scaling.items())) if scaling else None
    return _rope_tables(head_dim, max_len, float(theta), items,
                        str(torch.device("cpu" if device is None else device)))


@functools.lru_cache(maxsize=16)
def _rope_tables(head_dim: int, max_len: int, theta: float, items,
                 device: str) -> tuple:
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    if items:
        scaling = dict(items)
        rope_type = scaling.get("rope_type", scaling.get("type", "default"))
        if rope_type == "llama3":
            factor = scaling["factor"]
            low = scaling["low_freq_factor"]
            high = scaling["high_freq_factor"]
            old_len = scaling["original_max_position_embeddings"]
            wavelen = 2 * np.pi / inv_freq
            scaled = np.where(wavelen > old_len / low, inv_freq / factor,
                              inv_freq)
            smooth = (old_len / wavelen - low) / (high - low)
            smoothed = (1 - smooth) * scaled / factor + smooth * scaled
            medium = (wavelen <= old_len / low) & (wavelen >= old_len / high)
            inv_freq = np.where(medium, smoothed, scaled)
        elif rope_type == "linear":
            inv_freq = inv_freq / scaling["factor"]
        elif rope_type not in ("default", None):
            raise ValueError(f"unsupported rope_scaling type {rope_type!r}")
    freqs = np.outer(np.arange(max_len), inv_freq)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.sin(freqs), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]."""
    dtype = x.dtype
    positions = positions.long()
    c = cos[positions][:, :, None, :]  # [B, S, 1, D/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


# --- attention --------------------------------------------------------------


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat kv heads [B,S,Hkv,D] -> [B,S,Hkv*n_rep,D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """[B, S, H, D] attention with an f32 softmax. Both products take the
    inputs upcast to f32 (exact for bf16) and accumulate in f32, as the
    reference's `preferred_element_type=f32` einsums do. `window` limits
    causal reach to q - key < window (HF sliding-window convention)."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(depth)
    if causal or window is not None:
        s_q, s_k = q.shape[1], k.shape[1]
        q_pos = (torch.arange(s_q, device=q.device)[:, None]
                 + (s_k - s_q))  # bottom-aligned
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        keep = (q_pos >= k_pos if causal
                else torch.ones((s_q, s_k), dtype=torch.bool, device=q.device))
        if window is not None:
            keep = keep & (q_pos - k_pos < window)
        scores = torch.where(keep[None, None], scores, NEG_INF)
    if mask is not None:
        # mask: [B, S_k] padding, [B, S_q, S_k], or [B, H|1, S_q, S_k]
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        elif mask.ndim == 3:
            mask = mask[:, None, :, :]
        scores = torch.where(mask.bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(dtype) * scale + bias


# --- losses -----------------------------------------------------------------


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token negative log-likelihood in f32 (stable under bf16
    logits). Shared by the full and chunked loss paths."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0:
        smooth = -torch.mean(log_probs, dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def shifted_padding_masks(mask):
    """(attention_mask, label_weights) for a next-token loss over
    `input_ids` with a [B, S] padding mask (1 = real): the key mask for
    the forward over input_ids[:, :-1], and f32 label weights that count
    a label only when it AND its predicting token are real."""
    if mask is None:
        return None, None
    return mask[:, :-1], (mask[:, 1:] * mask[:, :-1]).float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32."""
    nll = token_nll(logits, labels, label_smoothing)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(params.shape))
