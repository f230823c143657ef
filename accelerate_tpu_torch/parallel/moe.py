"""Sort-based MoE dispatch (port of the single-device part of
`accelerate_tpu/parallel/moe.py`).

`sort_dispatch` fills per-expert capacity buffers from a stable argsort
of the T*k expert assignments: a token's slot is its rank within its
expert's group, and assignments ranked past `capacity` drop (their
tokens ride the residual path). The H-wide data moves by gathers; the
only scatters are [A]-sized index inversions. `sort_combine` gathers the
expert outputs back to token order, gate-weighted. Mixtral's sparse
path uses both per batch row.

The reference drops over-capacity assignments with an out-of-range
scatter in `mode="drop"`; torch has no such mode, so the inversion
scatters into an `E * C + 1` buffer whose last (sentinel) row takes the
dropped assignments and is then cut off. Ties in the top-k keep the
lower expert index first, as `jax.lax.top_k` does.

The expert-parallel entry points (`expert_parallel_moe`,
`expert_parallel_moe_a2a`) need a mesh and arrive with the port's
parallelism slice: they raise.
"""

from __future__ import annotations

import torch

__all__ = ["sort_dispatch", "sort_combine", "expert_parallel_moe",
           "expert_parallel_moe_a2a"]


def sort_dispatch(x: torch.Tensor, topk_idx: torch.Tensor,
                  topk_gate: torch.Tensor, num_experts: int, capacity: int):
    """x: [T, H]; topk_idx/topk_gate: [T, k]. Returns (buffers [E, C, H],
    combine_info = (dest [T, k], valid [T, k], gate [T, k]))."""
    T, H = x.shape
    k = topk_idx.shape[-1]
    A = T * k
    dev = x.device
    flat_e = topk_idx.reshape(A).long()
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    # rank within the expert group = index - first index of that expert
    group_start = torch.searchsorted(se, se, side="left")
    slot = torch.arange(A, device=dev) - group_start
    valid = slot < capacity
    sentinel = num_experts * capacity
    dest = torch.where(valid, se * capacity + slot, sentinel)
    # invert: which token feeds buffer row p (-1 = empty slot); dropped
    # assignments all land on the sentinel row, cut off after
    src = torch.full((sentinel + 1,), -1, dtype=torch.long, device=dev)
    src[dest] = st
    src = src[:sentinel]
    buffers = torch.where((src >= 0)[:, None], x[src.clamp(min=0)],
                          torch.zeros((), dtype=x.dtype, device=dev)
                          ).reshape(num_experts, capacity, H)
    # per-original-assignment destination for the combine gather
    dest_orig = torch.empty_like(dest)
    dest_orig[order] = dest
    valid_orig = torch.empty_like(valid)
    valid_orig[order] = valid
    return buffers, (dest_orig.reshape(T, k), valid_orig.reshape(T, k),
                     topk_gate)


def sort_combine(expert_outputs: torch.Tensor, combine_info) -> torch.Tensor:
    """Expert outputs [E, C, H] back to token order [T, H]: the
    gate-weighted sum over each token's k assignments."""
    dest, valid, gate = combine_info
    y_flat = expert_outputs.reshape(-1, expert_outputs.shape[-1])
    vals = y_flat[torch.where(valid, dest, torch.zeros_like(dest))]
    w = (gate * valid).to(vals.dtype)
    return torch.sum(vals * w[..., None], dim=1)


def topk_lower_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties in
    index order, as `jax.lax.top_k` orders them (`torch.topk` leaves the
    order of ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_topk(router_logits: torch.Tensor, top_k: int):
    probs = torch.softmax(router_logits.float(), dim=-1)
    return topk_lower_index_first(probs, top_k)  # gates, idx: [T, k]


def _dropped_fraction(info) -> torch.Tensor:
    """Fraction of top-k assignments that fell past expert capacity."""
    return 1.0 - torch.mean(info[1].float())


def _unported(name: str):
    raise NotImplementedError(
        f"{name} needs a device mesh; it arrives with the port's "
        "parallelism slice (ROADMAP.md, queue 1 item 6)")


def expert_parallel_moe(*args, **kwargs):
    _unported("expert_parallel_moe")


def expert_parallel_moe_a2a(*args, **kwargs):
    _unported("expert_parallel_moe_a2a")
