"""Ulysses sequence parallelism: an all-to-all head scatter (port of
`accelerate_tpu/parallel/ulysses.py`).

Where the ring rotates K/V chunks around the `seq` line, Ulysses
re-shards: one all-to-all turns each rank's [B, S/P, H, D] sequence
chunk into [B, S, H/P, D] (every position, a slice of the heads), each
rank runs ordinary full-sequence flash attention over its heads (K1a
forward; K1b and K1c in the backward), and a second all-to-all restores
the sequence chunks. GQA K/V scatter with their Hkv heads when Hkv
divides the axis (the wire carries 1/n_rep of the repeated volume) and
repeat after the collective; otherwise they repeat first. A [B, S] key
mask's chunks are all-gathered, so every rank holds the whole mask its
full-sequence attention needs; `window` rides the flash kernels
unchanged, since each rank sees the whole sequence.

Needs H and S divisible by the axis. Layout: the port's SPMD contract,
as in `ring_attention.py`: every rank of the line passes the whole
tensors and gets the whole output; the backward all-gathers each chunk
gradient. The schedule is one `torch.autograd.Function`.
"""

from __future__ import annotations

import torch

from ..models.common import repeat_kv
from ..ops.flash_attention import flash_attention, flash_backward, \
    flash_forward
from ..state import line_group, mesh_or_state
from ..utils import operations as ops
from ..utils.constants import AXIS_SEQ
from .ring_attention import _reduce_heads, _repeated

__all__ = ["ulysses_attention"]


def _scatter_heads(x, group):
    """[B, S/P, h, D] -> [B, S, h/P, D]."""
    return ops._all_to_all(x.contiguous(), 2, 1, group)


def _gather_heads(x, group):
    """[B, S, h/P, D] -> [B, S/P, h, D]."""
    return ops._all_to_all(x.contiguous(), 1, 2, group)


class _Ulysses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, n_rep, window):
        n = torch.distributed.get_world_size(group)
        my = torch.distributed.get_rank(group)
        s = q.shape[1] // n
        qc, kc, vc = (t[:, my * s:(my + 1) * s] for t in (q, k, v))
        qh = _scatter_heads(qc, group)
        kh, vh = _scatter_heads(kc, group), _scatter_heads(vc, group)
        full_mask = None
        if mask is not None:
            full_mask = ops.axis_all_gather(
                mask[:, my * s:(my + 1) * s].contiguous(), 1, group)
        kr, vr = _repeated(kh, n_rep), _repeated(vh, n_rep)
        o, lse = flash_forward(qh, kr, vr, causal, full_mask, window,
                               save_residuals=True)
        ctx.save_for_backward(qh, kh, vh, o, lse, full_mask)
        ctx.meta = (group, n, my, causal, n_rep, window)
        return ops.axis_all_gather(_gather_heads(o, group), 1, group)

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, o, lse, full_mask = ctx.saved_tensors
        group, n, my, causal, n_rep, window = ctx.meta
        s = dout.shape[1] // n
        doh = _scatter_heads(dout[:, my * s:(my + 1) * s].to(qh.dtype),
                             group)
        dq, dk, dv = flash_backward(qh, _repeated(kh, n_rep),
                                    _repeated(vh, n_rep), o, lse, doh,
                                    causal, full_mask, window)
        dk = _reduce_heads(dk, n_rep).to(kh.dtype)
        dv = _reduce_heads(dv, n_rep).to(vh.dtype)
        grads = [ops.axis_all_gather(_gather_heads(g, group), 1, group)
                 for g in (dq, dk, dv)]
        return (*grads, None, None, None, None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, mask: torch.Tensor | None = None,
                      mesh=None, axis_name: str = AXIS_SEQ,
                      window: int | None = None) -> torch.Tensor:
    """[B, S, H, D] attention with S split over the mesh's `seq` axis by
    head-scatter all-to-all (`mesh` defaults to the process state's). K/V
    may carry fewer (GQA) heads; `mask` is a [B, S] key-padding mask
    (1 = attend); `window` is Mistral's sliding window (needs
    `causal=True`). Falls back to one process's `flash_attention` (the
    kernels on the card, their plain versions on the CPU) when the mesh
    has no such axis above 1 or the shapes do not divide over it."""
    if window is not None and not causal:
        # the same check as ring_attention's, before any fallback
        raise ValueError("ulysses_attention window requires causal=True "
                         "(Mistral sliding-window semantics)")
    mesh = mesh_or_state(mesh)
    axis_size = mesh.shape.get(axis_name, 1) if mesh is not None else 1
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1 and axis_size > 1 and k.shape[2] % axis_size != 0:
        # kv heads do not divide the axis: repeat first (legal, heavier)
        k, v, n_rep = repeat_kv(k, n_rep), repeat_kv(v, n_rep), 1
    if (axis_size == 1 or q.shape[1] % axis_size != 0
            or k.shape[1] % axis_size != 0 or q.shape[2] % axis_size != 0
            or k.shape[2] % axis_size != 0):
        return flash_attention(q, _repeated(k, n_rep), _repeated(v, n_rep),
                               causal=causal, mask=mask, window=window)
    if mask is not None and tuple(mask.shape) != (q.shape[0], k.shape[1]):
        raise ValueError(
            f"ulysses_attention mask must be a [B, S_k] key-padding mask; "
            f"got {tuple(mask.shape)} for B={q.shape[0]}, S_k={k.shape[1]}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    group = line_group(mesh, axis_name, "ulysses_attention")
    if mask is not None:
        mask = (mask > 0).to(torch.uint8)
    return _Ulysses.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                          mask, group, causal, n_rep, window)
