"""MoE dispatch: the sort dispatch and its expert-parallel forms (port
of `accelerate_tpu/parallel/moe.py`).

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

Expert parallelism over a mesh's `expert` axis:

- `expert_parallel_moe`: routing and the [E, C, H] buffer replicated on
  every rank of the line; each rank runs its own experts' rows, and one
  all-gather reassembles the outputs;
- `expert_parallel_moe_a2a`: token-sharded. Each rank routes its
  T/P tokens, fills its [E, C_src, H] buffers at a capacity bounded per
  source (capacity_factor * k * T_local / E), one all-to-all ships every
  block to its expert's owner, the experts run over all sources' rows,
  and the reverse all-to-all brings the outputs home for the combine.

Layout: the port's SPMD contract (see `ring_attention.py`). The caller
on an `expert` line passes the whole [T, H] tokens and [T, E] router
logits, the same on every rank; a rank takes its token block
(`utils.operations.axis_scatter`) and the result is all-gathered
(`axis_gather`), so every rank returns the whole output, and a
replicated input's gradient arrives whole on every rank. Expert params
lead with the expert dim: either the whole E, of which each rank takes
its block (its gradient then all-gathered), or this rank's E/P block,
as `sharding.plan_sharding` places it (the leading E dim over
`expert`), whose gradient stays this rank's. `expert_fn(params, xs)` is
applied to one expert at a time (the reference's `vmap`). Where the
mesh's batch line (`data`, `fsdp`) is longer than one, its ranks hold
different rows: the a2a dispatch then gathers the line's tokens first
and runs on the global batch, as the reference's does.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from ..state import PartialState, data_line, line_group, mesh_or_state
from ..utils import operations as ops
from ..utils.constants import AXIS_EXPERT
from .pipeline import _tree_leaves, _tree_map, _tree_rebuild

__all__ = ["MoEFallbackWarning", "sort_dispatch", "sort_combine",
           "expert_parallel_moe", "expert_parallel_moe_a2a"]


class MoEFallbackWarning(UserWarning):
    """Warned when `expert_parallel_moe_a2a` cannot run the token-sharded
    all-to-all dispatch and falls back to the replicated-buffer one (a
    different communication pattern and memory profile), or when
    `expert_parallel_moe` replicates experts that do not divide over
    the axis."""


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


def _axis(mesh, axis_name: str) -> int:
    return mesh.shape.get(axis_name, 1) if mesh is not None else 1


def _local_experts(expert_params, num_experts: int, n_dev: int, group):
    """This rank's experts: leaves leading with the whole E give their
    block (differentiably, see `axis_scatter`); leaves already leading
    with E / n_dev are taken as they are."""
    def take(p):
        if p.shape[0] == num_experts:
            return ops.axis_scatter(p, 0, group)
        if p.shape[0] * n_dev == num_experts:
            return p
        raise ValueError(
            f"an expert param leads with {p.shape[0]}: expected the "
            f"{num_experts} experts or this rank's {num_experts // n_dev}")

    return _tree_map(take, expert_params)


def _run_experts(expert_fn: Callable, expert_params, inputs, expert_aux):
    """`expert_fn` over the leading expert dim, one expert at a time;
    with `expert_aux` the fn returns (out, aux) per expert and each aux
    leaf reduces by max over the experts run here."""
    leaves = _tree_leaves(expert_params)
    outs, auxes = [], []
    for e in range(inputs.shape[0]):
        p = _tree_rebuild(expert_params, [leaf[e] for leaf in leaves])
        if expert_aux is None:
            outs.append(expert_fn(p, inputs[e]))
        else:
            out, aux = expert_fn(p, inputs[e], expert_aux)
            outs.append(out)
            auxes.append(aux)
    if expert_aux is None:
        return torch.stack(outs), None
    per = [_tree_leaves(a) for a in auxes]
    maxed = [torch.stack([a[i] for a in per]).amax(dim=0)
             for i in range(len(per[0]))]
    return torch.stack(outs), _tree_rebuild(auxes[0], maxed)


def _axis_max(aux, group):
    return _tree_map(lambda a: ops.axis_all_reduce(a, group, op="max"), aux)


def _moe_local(x, router_logits, expert_params, topk_gate, topk_idx,
               expert_aux, *, expert_fn, group, n_dev, num_experts,
               capacity, top_k, return_stats):
    """Top-k dispatch with capacity bounding on replicated tokens x
    [T, H] and logits [T, E]; with a `group`, this rank runs its own
    experts' rows of the [E, C, H] buffer and one all-gather reassembles
    the outputs."""
    if topk_gate is None:
        topk_gate, topk_idx = _route_topk(router_logits, top_k)
    expert_inputs, info = sort_dispatch(x, topk_idx, topk_gate, num_experts,
                                        capacity)
    if group is not None:
        local_in = ops.axis_scatter(expert_inputs, 0, group)
        params = _local_experts(expert_params, num_experts, n_dev, group)
        local_out, aux = _run_experts(expert_fn, params, local_in,
                                      expert_aux)
        if aux is not None:
            aux = _axis_max(aux, group)
        expert_outputs = ops.axis_gather(local_out, 0, group)
    else:
        expert_outputs, aux = _run_experts(expert_fn, expert_params,
                                           expert_inputs, expert_aux)
    out = sort_combine(expert_outputs, info).to(x.dtype)
    extras = {}
    if return_stats:
        # routing ran replicated, so the fraction is already global
        extras["moe_dropped_fraction"] = _dropped_fraction(info)
    if expert_aux is not None:
        extras["expert_aux"] = aux
    return (out, extras) if extras else out


def _moe_local_a2a(x, router_logits, expert_params, topk_gate, topk_idx,
                   expert_aux, *, expert_fn, group, n_dev, num_experts,
                   capacity, top_k, return_stats):
    """Token-sharded dispatch on this rank's [T_local, H] tokens: local
    routing into [E, C, H] buffers, one all-to-all out (block j to the
    rank owning experts j*E/P..), the experts over every source's rows,
    one all-to-all back, the local combine."""
    e_local = num_experts // n_dev
    if topk_gate is None:
        topk_gate, topk_idx = _route_topk(router_logits, top_k)
    buffers, info = sort_dispatch(x, topk_idx, topk_gate, num_experts,
                                  capacity)
    h = buffers.shape[-1]
    recv = ops.axis_all_to_all(buffers, 0, 0, group)
    recv = recv.reshape(n_dev, e_local, capacity, h).transpose(0, 1) \
        .reshape(e_local, n_dev * capacity, h)
    out, aux = _run_experts(expert_fn, expert_params, recv, expert_aux)
    if aux is not None:
        # ranks ran disjoint experts on disjoint rows: the global
        # per-tensor amax is the max over the axis
        aux = _axis_max(aux, group)
    out = out.reshape(e_local, n_dev, capacity, h).transpose(0, 1) \
        .reshape(num_experts, capacity, h)
    back = ops.axis_all_to_all(out, 0, 0, group)
    combined = sort_combine(back, info).to(x.dtype)
    extras = {}
    if return_stats:
        # routing is per source rank here: the mean of the local fractions
        extras["moe_dropped_fraction"] = ops.axis_all_reduce(
            _dropped_fraction(info), group) / n_dev
    if expert_aux is not None:
        extras["expert_aux"] = aux
    return (combined, extras) if extras else combined


def expert_parallel_moe_a2a(x: torch.Tensor, router_logits: torch.Tensor,
                            expert_params, expert_fn: Callable, mesh=None,
                            axis_name: str = AXIS_EXPERT,
                            capacity_factor: float = 1.25, top_k: int = 1,
                            topk: tuple | None = None, strict: bool = False,
                            return_stats: bool = False, expert_aux=None):
    """Token-sharded top-k expert-parallel MoE over the mesh's `expert`
    axis (`mesh` defaults to the process state's). x [T, H] and
    router_logits [T, E] are the whole tokens (every rank of the line
    passes the same); expert_params lead with E (or this rank's E/P).
    Capacity is bounded per source rank (capacity_factor * k * T_local /
    E), the DeepSpeed-MoE convention, so drops are decided locally; at a
    generous capacity the result equals `expert_parallel_moe`'s.
    Differentiable end to end (the all-to-alls transpose to each other).

    `topk` = ([T, k] gates, [T, k] expert ids) supplies precomputed
    routing (e.g. Mixtral's renormalised gates). A size-1 axis delegates
    to `expert_parallel_moe`; an expert count or token count that does
    not divide over the axis falls back to it too, with a
    `MoEFallbackWarning`, or raises with `strict=True`.

    `return_stats=True` returns (out, {"moe_dropped_fraction": f}), f the
    mean over the ranks of the fraction of top-k assignments dropped past
    capacity. `expert_aux` (needs `topk`) threads a pytree (e.g. fp8
    delayed scales) into `expert_fn(params, xs, aux) -> (out, aux_out)`;
    the aux_out leaves (per-call scalars such as amaxes) reduce by max
    over the experts, then over the ranks, into extras["expert_aux"].

    On a mesh whose batch line (`state.data_line`: the `data` and `fsdp`
    ranks, which hold different rows) is longer than one, `x`, the
    logits and `topk` are this rank's rows: they are all-gathered over
    the line first, in the line's order (the global batch's rows), the
    dispatch runs on the global tokens as the reference's `shard_map`
    splits them over `expert` alone, and each rank keeps its own rows of
    the output. So the capacity, the drops, the dropped fraction and
    `expert_aux` are the global batch's, as the reference's; the
    backward goes through the same gathers (each rank's rows get their
    own outputs' gradient)."""
    mesh = mesh_or_state(mesh)
    line = data_line(mesh) if mesh is not None and \
        mesh.size == PartialState.num_processes else None
    if line is not None and line.size > 1 and _axis(mesh, axis_name) > 1:
        group, rows = line.group, x.shape[0]
        if topk is not None:
            topk = (ops.axis_gather(topk[0], 0, group),
                    ops.axis_all_gather(topk[1].contiguous(), 0, group))
        res = _expert_parallel_moe_a2a(
            ops.axis_gather(x, 0, group),
            ops.axis_gather(router_logits, 0, group), expert_params,
            expert_fn, mesh, axis_name, capacity_factor, top_k, topk,
            strict, return_stats, expert_aux)
        mine = (lambda y: y.narrow(0, line.index * rows, rows))
        return (mine(res[0]), res[1]) if isinstance(res, tuple) \
            else mine(res)
    return _expert_parallel_moe_a2a(
        x, router_logits, expert_params, expert_fn, mesh, axis_name,
        capacity_factor, top_k, topk, strict, return_stats, expert_aux)


def _expert_parallel_moe_a2a(x, router_logits, expert_params, expert_fn,
                             mesh, axis_name, capacity_factor, top_k, topk,
                             strict, return_stats, expert_aux):
    """`expert_parallel_moe_a2a` on tokens that every rank of the
    `expert` line holds whole."""
    num_experts = router_logits.shape[-1]
    n_dev = _axis(mesh, axis_name)
    divisible = num_experts % n_dev == 0 and x.shape[0] % n_dev == 0
    if n_dev > 1 and not divisible:
        msg = (
            f"expert_parallel_moe_a2a preconditions failed on axis "
            f"{axis_name!r} (size {n_dev}): num_experts={num_experts} "
            f"(divisible: {num_experts % n_dev == 0}), "
            f"tokens={x.shape[0]} (divisible: {x.shape[0] % n_dev == 0}); "
            "falling back to the replicated-buffer dispatch (full [E, C, H] "
            "buffer on every rank; all_gather, or fully replicated expert "
            "compute, instead of all_to_all)")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, MoEFallbackWarning, stacklevel=3)
    if expert_aux is not None and topk is None:
        raise ValueError("expert_aux requires precomputed `topk` routing")
    if n_dev == 1 or not divisible:
        return expert_parallel_moe(
            x, router_logits, expert_params, expert_fn, mesh=mesh,
            axis_name=axis_name, capacity_factor=capacity_factor,
            top_k=top_k, topk=topk, return_stats=return_stats,
            expert_aux=expert_aux)
    group = line_group(mesh, axis_name, "expert parallelism")
    t_local = x.shape[0] // n_dev
    capacity = max(int(capacity_factor * top_k * t_local / num_experts), 1)
    x_c = ops.axis_scatter(x, 0, group)
    logits_c = ops.axis_scatter(router_logits, 0, group)
    gate_c = idx_c = None
    if topk is not None:
        gate_c = ops.axis_scatter(topk[0], 0, group)
        idx_c = ops._own_block(topk[1], 0, group)
    params = _local_experts(expert_params, num_experts, n_dev, group)
    res = _moe_local_a2a(
        x_c, logits_c, params, gate_c, idx_c, expert_aux,
        expert_fn=expert_fn, group=group, n_dev=n_dev,
        num_experts=num_experts, capacity=capacity, top_k=top_k,
        return_stats=return_stats)
    if isinstance(res, tuple):
        return ops.axis_gather(res[0], 0, group), res[1]
    return ops.axis_gather(res, 0, group)


def expert_parallel_moe(x: torch.Tensor, router_logits: torch.Tensor,
                        expert_params, expert_fn: Callable, mesh=None,
                        axis_name: str = AXIS_EXPERT,
                        capacity_factor: float = 1.25, top_k: int = 1,
                        topk: tuple | None = None,
                        return_stats: bool = False, expert_aux=None):
    """Top-k expert-parallel MoE with the routing and the [E, C, H]
    buffer replicated on every rank of the `expert` line (k=1 Switch,
    k=2 Mixtral-style): x [T, H], router_logits [T, E], expert_params
    leading with E (or this rank's E/P). Gates are the raw top-k softmax
    probabilities unless `topk` = ([T, k] gates, [T, k] ids) supplies the
    caller's routing. Each rank runs its own experts' rows; one
    all-gather reassembles the outputs. Off a mesh (or on a size-1
    axis) the same math runs over every expert here; experts that do
    not divide over the axis replicate, with a `MoEFallbackWarning`.
    `return_stats` and `expert_aux` as in `expert_parallel_moe_a2a`."""
    mesh = mesh_or_state(mesh)
    num_experts = router_logits.shape[-1]
    n_dev = _axis(mesh, axis_name)
    capacity = max(int(capacity_factor * top_k * x.shape[0] / num_experts),
                   1)
    tg, ti = topk if topk is not None else (None, None)
    if expert_aux is not None and topk is None:
        raise ValueError("expert_aux requires precomputed `topk` routing")
    group = None
    if n_dev > 1 and num_experts % n_dev:
        # the same no-silent-downgrade contract as the a2a path: every
        # rank computes every expert on every token
        warnings.warn(
            f"expert_parallel_moe: num_experts={num_experts} does not "
            f"divide over axis {axis_name!r} (size {n_dev}); experts "
            "replicate on every rank instead of sharding",
            MoEFallbackWarning, stacklevel=2)
    elif n_dev > 1:
        group = line_group(mesh, axis_name, "expert parallelism")
    return _moe_local(
        x, router_logits, expert_params, tg, ti, expert_aux,
        expert_fn=expert_fn, group=group, n_dev=n_dev,
        num_experts=num_experts, capacity=capacity, top_k=top_k,
        return_stats=return_stats)
