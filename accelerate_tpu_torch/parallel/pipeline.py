"""Pipeline parallelism over a mesh's `stage` axis (port of
`accelerate_tpu/parallel/pipeline.py`).

The reference runs every stage inside one `shard_map` program: a
`lax.scan` over clock ticks in which each device applies its stage and
`lax.ppermute`s the activations one stage on. The port has one process a
device, so each rank runs its own stage's ticks of the same clocks and
hands tensors to its neighbours on the axis's line
(`utils.operations.axis_ppermute`, an `isend` and an `irecv` posted
together). A tick where a stage is idle computes nothing and moves
nothing: the reference's masked ticks and the ring's wrap-around
(last stage to first) are left out, except where the interleaved
schedule's chunk boundaries ride it.

Clocks (the reference's): with phi(m) = (m % S) + S*V*(m // S), micro m
runs forward at virtual stage j = c*S + d (chunk c on device d) at tick
phi(m) + j, and backward (1F1B) at phi(m) + 2(S*V - 1) - j. For V = 1,
phi(m) = m: GPipe's t = m + s and 1F1B's t = m + 2(S-1) - s. Each
device has at most one chunk forward and one chunk backward a tick.

- `pipeline_apply` (GPipe; interleaved with `virtual_stages=V`): every
  rank gets the full output, broadcast from the last stage (the
  reference's "psum of one-hot"). Differentiable through an autograd
  Function that keeps every micro-batch's stage input (O(M), as
  GPipe's autodiff keeps its scan's) and whose backward runs the clock
  in reverse, recomputing each stage forward from its input and sending
  the input's cotangent to the previous stage. Only the last stage's
  output cotangent is read: every rank holds the same replicated output
  and loss, so summing their cotangents would count the loss S times.
- `pipeline_value_and_grad(schedule="1f1b")`: one forward and one
  backward a tick; stage s holds at most 2(S-1-s)+1 saved stage inputs
  (V = 1) and O(S*V) with V chunks, independent of M; the backward
  recomputes the stage forward from its saved input. `"gpipe"` and
  `"interleaved"` differentiate `pipeline_apply` (O(M) inputs).

Stage params: a tree whose leaves lead with the stage dim, [S, ...]
(`stack_layers_into_stages`) or [V, S, ...]
(`stack_layers_into_virtual_stages`). Each rank reads only its own
block: [s] or [:, s]. A schedule takes the whole stacked tree or the
rank's block alone ([1, ...] or [V, 1, ...], `stage_block`, which is
what a rank keeps), and returns gradients of the block, in the block's
layout. `stats=ScheduleStats()` records what a run did on this rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..utils import operations as ops
from ..utils.constants import AXIS_STAGE

__all__ = [
    "ScheduleStats",
    "pipeline_apply",
    "pipeline_value_and_grad",
    "stack_layers_into_stages",
    "stack_layers_into_virtual_stages",
    "stage_block",
]

_SCHEDULES = ("1f1b", "gpipe", "interleaved")


# -- trees ---------------------------------------------------------------------


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return type(tree)({k: _tree_map(fn, v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_rebuild(tree, leaves):
    """`tree` with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


# -- stacking ------------------------------------------------------------------


def stack_layers_into_stages(params: Any, num_stages: int) -> Any:
    """[L, ...]-stacked layer params -> [S, L//S, ...] stage-stacked
    (views)."""

    def _split(x):
        L = x.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers not divisible by {num_stages} "
                             "stages")
        return x.reshape((num_stages, L // num_stages) + tuple(x.shape[1:]))

    return _tree_map(_split, params)


def stack_layers_into_virtual_stages(params: Any, num_stages: int,
                                     num_chunks: int) -> Any:
    """[L, ...]-stacked layer params -> [V, S, L/(V*S), ...] for the
    interleaved schedule: virtual stage j = c*S + d holds model layers
    [j*Lc, (j+1)*Lc) and runs as chunk c on device d (Megatron's
    round-robin chunk assignment)."""

    def _split(x):
        L = x.shape[0]
        if L % (num_stages * num_chunks):
            raise ValueError(
                f"{L} layers not divisible by {num_stages} stages x "
                f"{num_chunks} virtual chunks")
        lc = L // (num_stages * num_chunks)
        return x.reshape((num_chunks, num_stages, lc) + tuple(x.shape[1:]))

    return _tree_map(_split, params)


def _stage_dim(virtual_stages: int) -> int:
    return 1 if virtual_stages > 1 else 0


def stage_block(stage_params: Any, mesh=None, axis_name: str = AXIS_STAGE,
                virtual_stages: int = 1, device=None) -> Any:
    """This rank's block of a stage-stacked tree, as a copy on `device`
    (default: each leaf's own): leaves [1, ...] from [S, ...], or
    [V, 1, ...] from [V, S, ...]. The planner's placement on the stage
    axis (`sharding.shard_pytree` with the stage dim over `axis_name`),
    which the reference gives `shard_map`."""
    from ..sharding.planner import NamedSharding, PartitionSpec, \
        shard_pytree

    mesh = _default_mesh(mesh)
    spec = PartitionSpec(*([None] * _stage_dim(virtual_stages)), axis_name)
    plan = _tree_map(lambda _: NamedSharding(mesh, spec), stage_params)
    return shard_pytree(stage_params, plan, device=device)


# -- what a run did --------------------------------------------------------------


@dataclasses.dataclass
class ScheduleStats:
    """One schedule run on this rank, filled when passed as `stats=`:
    the clock's ticks; the tensors this rank handed to a neighbour
    (`handoffs`, `handoff_bytes`) and the host wall time of each
    exchange that moved one (`exchange_ms`, after a device synchronise,
    so the stage's compute is not in it); the bytes of the final
    broadcast; the most stage inputs it held at once
    (`max_saved_inputs`)."""

    ticks: int = 0
    handoffs: int = 0
    handoff_bytes: int = 0
    exchange_ms: list = dataclasses.field(default_factory=list)
    broadcast_bytes: int = 0
    max_saved_inputs: int = 0


# -- the axis's line -------------------------------------------------------------


def _default_mesh(mesh):
    if mesh is None:
        from ..state import PartialState

        mesh = PartialState().mesh
    return mesh


class _Line:
    """This rank's place on the stage axis: S stages, its index d, the
    clocks, and the exchanges with its neighbours."""

    def __init__(self, mesh, axis_name: str, num_micro: int,
                 virtual_stages: int, stats: ScheduleStats | None):
        self.S = mesh.shape[axis_name]
        self.M = num_micro
        self.V = virtual_stages
        self.d = mesh.axis_index(axis_name)
        self.mesh, self.axis = mesh, axis_name
        self.stats = stats
        if mesh.group(axis_name) is None:
            from ..state import PartialState

            raise ValueError(
                f"the {axis_name!r} axis of {mesh!r} needs a world of "
                f"{mesh.size} processes; this one has "
                f"{PartialState.num_processes}")

    @property
    def group(self):
        # looked up at each use (`ProcessMesh.groups`)
        return self.mesh.group(self.axis)

    def phi(self, m: int) -> int:
        return (m % self.S) + self.S * self.V * (m // self.S)

    def forward_ticks(self) -> int:
        return self.phi(self.M - 1) + self.S * self.V

    def one_f_one_b_ticks(self) -> int:
        return self.phi(self.M - 1) + 2 * (self.S * self.V - 1) + 1

    def slot(self, t: int, backward: bool = False):
        """(chunk, micro) this rank runs at tick t of the forward (or
        1F1B backward) clock, or None."""
        S, V, SV = self.S, self.V, self.S * self.V
        for c in range(V):
            j = c * S + self.d
            r = t - 2 * (SV - 1) + j if backward else t - j
            if r < 0:
                continue
            rem = r % SV
            m = (r // SV) * S + rem
            if rem < S and m < self.M:
                return c, m
        return None

    def first(self, c: int) -> bool:
        """Whether chunk c here is virtual stage 0 (reads the input)."""
        return self.d == 0 and c == 0

    def last(self, c: int) -> bool:
        """Whether chunk c here is the last virtual stage."""
        return self.d == self.S - 1 and c == self.V - 1

    def exchange(self, send, shift: int, recv_like):
        """Send `send` (None: nothing) `shift` places along the line and
        receive like `recv_like` (None: nothing) from `shift` places
        back."""
        if send is None and recv_like is None:
            return None
        st = self.stats
        if st is None:
            return ops.axis_ppermute(send, self.group, shift,
                                     recv_like=recv_like)
        probe = send if send is not None else recv_like
        if probe.is_cuda:
            torch.cuda.synchronize(probe.device)
        t0 = time.perf_counter()
        out = ops.axis_ppermute(send, self.group, shift,
                                recv_like=recv_like)
        st.exchange_ms.append((time.perf_counter() - t0) * 1e3)
        if send is not None:
            st.handoffs += 1
            st.handoff_bytes += send.numel() * send.element_size()
        return out

    def broadcast_from(self, tensor, src: int):
        if self.stats is not None:
            self.stats.broadcast_bytes += tensor.numel() * \
                tensor.element_size()
        return ops.axis_broadcast(tensor, self.group, src)

    def saved(self, n: int) -> None:
        if self.stats is not None:
            self.stats.max_saved_inputs = max(self.stats.max_saved_inputs, n)

    def ticked(self, n: int) -> None:
        if self.stats is not None:
            self.stats.ticks += n


# -- the block's params ----------------------------------------------------------


def _local_leaves(stage_params, line: _Line) -> list:
    """The leaves of this rank's block ([1, ...] or [V, 1, ...]): views
    of a whole stacked tree, or the block itself."""
    dim = _stage_dim(line.V)
    out = []
    for p in _tree_leaves(stage_params):
        if line.V > 1 and p.shape[0] != line.V:
            raise ValueError(
                f"virtual_stages={line.V} needs [V, S, ...] stage params "
                f"(stack_layers_into_virtual_stages); got {tuple(p.shape)}")
        n = p.shape[dim]
        if n == line.S:
            p = p.narrow(dim, line.d, 1)
        elif n != 1:
            raise ValueError(
                f"stage params lead with the stage dim, {line.S} (the whole "
                f"stacked tree) or 1 (this rank's block); got "
                f"{tuple(p.shape)}")
        out.append(p)
    return out


def _chunk(leaves: list, c: int, line: _Line) -> list:
    """Chunk c's views of the block's leaves (the stage dim dropped)."""
    return [p[c, 0] if line.V > 1 else p[0] for p in leaves]


def _split_micro(x: torch.Tensor, M: int) -> torch.Tensor:
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by {M} micro-batches")
    return x.reshape((M, b // M) + tuple(x.shape[1:]))


def _check_like(y: torch.Tensor, like: torch.Tensor) -> None:
    if y.shape != like.shape or y.dtype != like.dtype:
        raise ValueError(
            f"stage_fn must return its input's shape and dtype "
            f"{tuple(like.shape)} {like.dtype}; got {tuple(y.shape)} "
            f"{y.dtype}")


def _stage_vjp(stage_fn, tree, chunk_leaves, x, dy, need_dx: bool):
    """Recompute one stage forward from its saved input `x` and pull the
    cotangent `dy` back: (grads of the chunk's leaves, dx or None)."""
    params = [p.detach().requires_grad_(p.is_floating_point())
              for p in chunk_leaves]
    xin = x.detach().requires_grad_(need_dx)
    with torch.enable_grad():
        y = stage_fn(_tree_rebuild(tree, params), xin)
    wrt = [p for p in params if p.requires_grad] + ([xin] if need_dx else [])
    got = iter(torch.autograd.grad(y, wrt, dy, allow_unused=True))
    grads = []
    for p in params:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    dx = next(got) if need_dx else None
    if need_dx and dx is None:
        dx = torch.zeros_like(x)
    return grads, dx


def _add_chunk_grads(acc: list, grads: list, c: int, line: _Line) -> None:
    for a, g in zip(acc, grads):
        (a[c, 0] if line.V > 1 else a[0]).add_(g)


# -- GPipe / interleaved ---------------------------------------------------------


def _run_forward(stage_fn, tree, leaves, micro, line: _Line, keep=None):
    """The forward clock on this rank: [M, mb, ...] outputs on every
    rank. `keep` (a dict) collects each (chunk, micro)'s stage input."""
    outputs = [None] * line.M
    inbound = None
    T = line.forward_ticks()
    for t in range(T):
        slot = line.slot(t)
        send = None
        if slot is not None:
            c, m = slot
            x_in = micro[m] if line.first(c) else inbound
            if keep is not None:
                keep[(c, m)] = x_in
                line.saved(len(keep))
            y = stage_fn(_tree_rebuild(tree, _chunk(leaves, c, line)), x_in)
            _check_like(y, micro[0])
            if line.last(c):
                outputs[m] = y
            else:
                send = y
        nxt = line.slot(t + 1)
        recv = nxt is not None and not line.first(nxt[0])
        inbound = line.exchange(send, 1, micro[0] if recv else None)
    line.ticked(T)
    mine = (torch.stack(outputs) if line.d == line.S - 1
            else torch.empty_like(micro))
    return line.broadcast_from(mine, line.S - 1)


def _run_backward(stage_fn, tree, leaves, keep: dict, g_out, line: _Line,
                  need_dx: bool):
    """The forward clock in reverse: each (chunk, micro) pulls its
    cotangent back through a recomputed stage forward and hands the
    input's cotangent to the previous virtual stage. Returns (grads of
    the block's leaves, the input's cotangent [M, mb, ...] on every rank
    or None)."""
    acc = [torch.zeros_like(p) for p in leaves]
    dmicro = torch.zeros_like(g_out) if need_dx else None
    inbound = None
    T = line.forward_ticks()
    for tau in range(T):
        slot = line.slot(T - 1 - tau)
        send = None
        if slot is not None:
            c, m = slot
            dy = g_out[m] if line.last(c) else inbound
            want_dx = need_dx or not line.first(c)
            grads, dx = _stage_vjp(stage_fn, tree, _chunk(leaves, c, line),
                                   keep.pop((c, m)), dy, want_dx)
            _add_chunk_grads(acc, grads, c, line)
            if line.first(c):
                if need_dx:
                    dmicro[m] = dx
            else:
                send = dx
        nxt = line.slot(T - 2 - tau) if tau + 1 < T else None
        recv = nxt is not None and not line.last(nxt[0])
        inbound = line.exchange(send, -1, g_out[0] if recv else None)
    if need_dx:
        dmicro = line.broadcast_from(dmicro, 0)
    return acc, dmicro


class _PipelineApply(torch.autograd.Function):
    """The forward schedule with a backward that runs it in reverse."""

    @staticmethod
    def forward(ctx, run, micro, *leaves):
        stage_fn, tree, line = run
        keep: dict = {}
        out = _run_forward(stage_fn, tree, list(leaves), micro, line, keep)
        ctx.run, ctx.keep = run, keep
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        stage_fn, tree, line = ctx.run
        grads, dmicro = _run_backward(
            stage_fn, tree, list(ctx.saved_tensors), ctx.keep,
            g_out.contiguous(), line, ctx.needs_input_grad[1])
        ctx.keep = None
        return (None, dmicro, *grads)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    num_micro_batches: int,
    mesh=None,
    axis_name: str = AXIS_STAGE,
    virtual_stages: int = 1,
    *,
    stats: ScheduleStats | None = None,
) -> torch.Tensor:
    """GPipe-schedule apply, y = stages(x), on every rank of the stage
    axis; differentiable with respect to the block's leaves and `x`.

    - `stage_fn(params_slice, x_micro) -> y_micro` is one stage's compute
      (outputs share the input's shape and dtype).
    - `stage_params`: a tree whose leaves lead with the stage dim S (or
      [V, S] from `stack_layers_into_virtual_stages` with
      `virtual_stages=V > 1`, the interleaved schedule), whole or this
      rank's block (see the module docstring).
    - `x`: [B, ...] the global batch, the same on every rank (stage 0
      reads it); split into `num_micro_batches` micro-batches.

    Every rank gets the full [B, ...] output (broadcast from the last
    stage). Under autograd, `x`'s gradient is stage 0's, broadcast, and
    only the last stage's output cotangent is read (every rank's loss
    is the same replicated loss)."""
    mesh = _default_mesh(mesh)
    num_stages = mesh.shape.get(axis_name, 1)
    if num_stages == 1:
        raise ValueError(
            f"mesh has no '{axis_name}' axis (or size 1); apply the stages "
            "sequentially instead of via pipeline_apply")
    micro = _split_micro(x, num_micro_batches)
    line = _Line(mesh, axis_name, num_micro_batches, virtual_stages, stats)
    leaves = _local_leaves(stage_params, line)
    run = (stage_fn, stage_params, line)
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in leaves))
    if needs_grad:
        out = _PipelineApply.apply(run, micro, *leaves)
    else:
        with torch.no_grad():
            out = _run_forward(stage_fn, stage_params, leaves, micro, line)
    return out.reshape(x.shape[:1] + out.shape[2:])


# -- 1F1B ------------------------------------------------------------------------


def _loss_and_grad(loss_fn, y, target):
    """(f32 loss, its gradient with respect to y, in y's dtype)."""
    yy = y.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(yy, target).float()
    (dy,) = torch.autograd.grad(loss, yy)
    return loss.detach(), dy


def _run_1f1b(stage_fn, loss_fn, tree, leaves, micro, tmicro, line: _Line):
    """One chunk forward and one chunk backward a tick (the reference's
    `_pipeline_1f1b_local` and `_pipeline_1f1b_interleaved_local`
    clocks). Returns (loss on every rank, grads of the block's
    leaves)."""
    M = line.M
    acc = [torch.zeros_like(p) for p in leaves]
    saved: dict = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=micro.device)
    inb_act = inb_cot = dy_self = None
    T = line.one_f_one_b_ticks()
    for t in range(T):
        f = line.slot(t)
        y = None
        if f is not None:
            c, m = f
            x_in = micro[m] if line.first(c) else inb_act
            saved[(c, m)] = x_in
            line.saved(len(saved))
            with torch.no_grad():
                y = stage_fn(_tree_rebuild(tree, _chunk(leaves, c, line)),
                             x_in)
            _check_like(y, micro[0])
            if line.last(c):
                lval, dy_self = _loss_and_grad(
                    loss_fn, y, _tree_map(lambda v, m=m: v[m], tmicro))
                loss_sum = loss_sum + lval
        b = line.slot(t, backward=True)
        dx = None
        if b is not None:
            c, m = b
            # the last virtual stage's backward runs in the tick of its
            # forward, on that forward's loss gradient
            dy = (dy_self / M).to(micro.dtype) if line.last(c) else inb_cot
            grads, dx = _stage_vjp(stage_fn, tree, _chunk(leaves, c, line),
                                   saved.pop((c, m)), dy,
                                   not line.first(c))
            _add_chunk_grads(acc, grads, c, line)
        send_act = y if f is not None and not line.last(f[0]) else None
        nf = line.slot(t + 1)
        inb_act = line.exchange(
            send_act, 1,
            micro[0] if nf is not None and not line.first(nf[0]) else None)
        nb = line.slot(t + 1, backward=True)
        inb_cot = line.exchange(
            dx, -1,
            micro[0] if nb is not None and not line.last(nb[0]) else None)
    line.ticked(T)
    loss = line.broadcast_from(loss_sum, line.S - 1) / M
    return loss, acc


def pipeline_value_and_grad(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    targets: Any,
    num_micro_batches: int,
    mesh=None,
    axis_name: str = AXIS_STAGE,
    schedule: str = "1f1b",
    virtual_stages: int = 1,
    *,
    stats: ScheduleStats | None = None,
) -> tuple[torch.Tensor, Any]:
    """(loss, grads) of mean_m loss_fn(stages(x_m), targets_m).

    `schedule="1f1b"` runs the memory-bounded schedule (at most
    2(S-1-s)+1 saved stage inputs on stage s); with `virtual_stages=V >=
    2` the memory-bounded interleaved one (O(S*V) saved inputs).
    `"gpipe"` differentiates `pipeline_apply` (O(M) inputs);
    `"interleaved"` differentiates the interleaved forward (the same
    V-chunk bubble, O(M) inputs). All return the same values up to float
    reassociation.

    - `stage_fn(params_slice, x_micro) -> y_micro`: one stage's compute.
    - `loss_fn(y_micro, target_micro) -> scalar`: per-micro loss (mean-
      style; the pipeline averages it over micro-batches, in f32).
    - `targets`: a tree of tensors with `x`'s leading batch dim.

    The loss is a 0-d f32 tensor on every rank; the grads are this
    rank's block's ([1, ...], or [V, 1, ...] with V chunks), in the
    layout of `stage_params`' tree."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; use '1f1b', "
                         "'gpipe', or 'interleaved'")
    if schedule == "interleaved" and virtual_stages < 2:
        raise ValueError("schedule='interleaved' needs virtual_stages >= 2 "
                         "(1 chunk per device IS the gpipe schedule)")
    if schedule == "gpipe" and virtual_stages != 1:
        raise ValueError(
            f"virtual_stages={virtual_stages} requires schedule='interleaved'"
            f" or '1f1b' (got {schedule!r}); [V, S, ...] stage params don't "
            "fit the single-chunk gpipe schedule")
    mesh = _default_mesh(mesh)
    num_stages = mesh.shape.get(axis_name, 1)
    if num_stages == 1:
        raise ValueError(
            f"mesh has no '{axis_name}' axis (or size 1); use an ordinary "
            "value_and_grad instead of the pipeline schedules")
    M = num_micro_batches
    micro = _split_micro(x, M)
    tmicro = _tree_map(lambda v: _split_micro(v, M), targets)
    line = _Line(mesh, axis_name, M, virtual_stages, stats)
    leaves = _local_leaves(stage_params, line)

    if schedule in ("gpipe", "interleaved"):
        params = [p.detach().requires_grad_(p.is_floating_point())
                  for p in leaves]
        with torch.enable_grad():
            y = pipeline_apply(
                stage_fn, _tree_rebuild(stage_params, params), x, M,
                mesh=mesh, axis_name=axis_name,
                virtual_stages=virtual_stages, stats=stats)
            ym = _split_micro(y, M)
            loss = torch.stack([
                loss_fn(ym[m], _tree_map(lambda v, m=m: v[m], tmicro))
                .float() for m in range(M)]).mean()
        wrt = [p for p in params if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt))
        grads = [next(got) if p.requires_grad else torch.zeros_like(p)
                 for p in params]
        return loss.detach(), _tree_rebuild(stage_params, grads)

    with torch.no_grad():
        loss, grads = _run_1f1b(stage_fn, loss_fn, stage_params, leaves,
                                micro, tmicro, line)
    return loss, _tree_rebuild(stage_params, grads)
