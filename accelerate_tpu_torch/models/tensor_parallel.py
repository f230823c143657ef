"""Tensor-parallel forward helpers: the families' forward over this rank's
shards of params placed on a mesh's `model` axis (`serving.pod.
shard_params`, the Megatron column/row layout of `sharding/rules.py`).

The reference runs the single-device forward under GSPMD, which inserts
the collectives. The port's process mesh has one process per device, so
the forward does them itself, reading what to do off each leaf's spec
(never off a model size):

- a column-sharded projection ([in, out/N] here) keeps its local output
  columns; a replicated bias adds its slice of them;
- a row-sharded one ([in/N, out]) takes its slice of the input, forms
  its partial product in f32 and sums it over the axis (one all-reduce),
  then casts and adds the bias once: the reference's f32-accumulated
  product split over ranks;
- a vocab-sharded embedding looks up the ids that fall in its rows,
  zeros the rest and sums over the axis (exact: one nonzero per entry);
- a vocab-sharded head forms its f32 logits columns and all-gathers them
  (`_project_out`'s f32 contract);
- a weight the plan leaves replicated computes replicated, its input
  gathered first if it is a local slice.

Attention is head-parallel when the KV heads divide the axis: each rank
attends over its own heads (its column slices of q/k/v), against a KV
cache that holds those heads only. Otherwise q, k and v are gathered and
every rank attends over all heads.

Values carry a flag, local (this rank's column slice) or full, so a
local output feeds a row-sharded projection without moving. Collectives
are `utils.operations.axis_all_reduce`/`axis_all_gather` on the axis's
group: on the host under gloo, on the device under NCCL.
"""

from __future__ import annotations

import torch

from ..sharding.planner import NamedSharding, leaves_with_path
from ..utils.constants import AXIS_MODEL
from .common import dense, logits_f32

__all__ = [
    "ShardedParams",
    "TensorParallel",
    "tensor_parallel_of",
    "require_tensor_parallel",
]

_ITEM_6B = "queue 1 item 6b"


class TensorParallel:
    """The forward's view of a placement: the `model` axis's size `n`,
    this rank's `index` on it, its group (looked up at each use), and
    each leaf's spec by path ("layers/attn/q_proj/kernel")."""

    def __init__(self, mesh, plan):
        self.mesh = mesh
        self.n = mesh.shape.get(AXIS_MODEL, 1)
        self.index = mesh.axis_index(AXIS_MODEL) if self.n > 1 else 0
        self.specs = {
            path: sharding.spec for path, sharding in leaves_with_path(
                plan, is_leaf=lambda x: isinstance(x, NamedSharding))}
        sizes = dict(mesh.shape)
        for path, spec in self.specs.items():
            other = [a for a in spec.axes()
                     if a != AXIS_MODEL and sizes.get(a, 1) > 1]
            if other:
                raise NotImplementedError(
                    f"{path} is sharded over {other}: the port's forward "
                    f"runs the {AXIS_MODEL!r} axis only; sharded training "
                    f"axes arrive with {_ITEM_6B} (training half)")

    @property
    def group(self):
        return self.mesh.group(AXIS_MODEL)

    def sharded(self, path: str, dim: int) -> bool:
        """Whether leaf `path`'s dim `dim` (negative: from the end, so
        per-layer views of stacked leaves read the same) is split over
        the model axis."""
        spec = self.specs.get(path, ())
        if -dim > len(spec):
            return False
        entry = spec[dim]
        axes = entry if isinstance(entry, tuple) else (entry,)
        return AXIS_MODEL in axes

    # -- moving values -----------------------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        from ..utils.operations import axis_all_reduce

        return axis_all_reduce(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Full columns from every rank's local slice of the last dim."""
        from ..utils.operations import axis_all_gather

        return axis_all_gather(x.contiguous(), -1, self.group)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full value's last dim."""
        w = x.shape[-1] // self.n
        return x[..., self.index * w:(self.index + 1) * w]

    def to_local(self, x, is_local: bool):
        return x if is_local else self.local(x)

    def to_full(self, x, is_local: bool):
        return self.gather(x) if is_local else x


class ShardedParams(dict):
    """A family's params placed on a mesh: this rank's shard of every
    leaf, as the plain param dict the forward reads, with the placement
    (`mesh`, `plan`: a `NamedSharding` per leaf) and the forward's view
    of it (`tp`; None when the mesh's model axis is 1, or with
    `tensor_parallel=False`: a placement its user gathers whole at the
    call, `inference.prepare_sharded_inference`'s "gather" route)."""

    def __init__(self, tree=(), mesh=None, plan=None,
                 tensor_parallel: bool = True):
        super().__init__(tree)
        self.mesh = mesh
        self.plan = plan
        self.tp = (TensorParallel(mesh, plan)
                   if tensor_parallel and mesh is not None
                   and mesh.shape.get(AXIS_MODEL, 1) > 1 else None)


def tensor_parallel_of(params) -> TensorParallel | None:
    """The forward's tensor-parallel view of `params`, None for params
    that are not placed on a mesh."""
    return getattr(params, "tp", None)


def require_tensor_parallel(family) -> None:
    """Raise unless `family` (a model module, or its forward) has a
    tensor-parallel forward."""
    import sys

    module = family if not callable(family) else sys.modules.get(
        getattr(family, "__module__", ""), None)
    if not getattr(module, "TENSOR_PARALLEL", False):
        name = getattr(family, "__name__", repr(family))
        raise NotImplementedError(
            f"{name} has no tensor-parallel forward in the port (llama and "
            f"gpt2 have); serving it on a mesh arrives with {_ITEM_6B}")


# -- the ops -----------------------------------------------------------------


def embed(tp, path: str, table: torch.Tensor, ids: torch.Tensor):
    """Rows of an embedding table [V, h]; vocab-sharded tables look up
    their rows' ids, zero the others and sum over the axis."""
    if tp is None or not tp.sharded(path, -2):
        return table[ids.long()]
    rows = table.shape[0]
    local = ids.long() - tp.index * rows
    hit = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)]
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return tp.all_reduce(out)


def _matmul_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x @ kernel with f32 accumulation and an f32 result."""
    ct = torch.promote_types(x.dtype, kernel.dtype)
    x, kernel = x.to(ct), kernel.to(ct)
    if ct == torch.float32 or ct == torch.float64:
        return torch.matmul(x, kernel).float()
    if x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, kernel, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], kernel.shape[-1])
    return torch.matmul(x.float(), kernel.float())


def add_bias(tp, path: str, y, y_local: bool, bias):
    """y + bias, where y may be a local column slice and the bias
    replicated or sharded."""
    if bias is None:
        return y
    b_local = tp is not None and tp.sharded(path, -1)
    if y_local and not b_local:
        bias = tp.local(bias)
    elif b_local and not y_local:
        bias = tp.gather(bias)
    return y + bias


def project(tp, path: str, x, kernel, bias=None, bias_path: str = "",
            x_local: bool = False):
    """`dense(x, kernel, bias)` on this rank's shard of `kernel` (spec at
    `path`). `x_local` says whether `x` is this rank's column slice.
    Returns (y, y_local)."""
    if tp is None:
        return dense(x, kernel, bias), False
    if tp.sharded(path, -1):                      # column-parallel
        y = dense(tp.to_full(x, x_local), kernel)
        return add_bias(tp, bias_path, y, True, bias), True
    if tp.sharded(path, -2):                      # row-parallel
        part = _matmul_f32(tp.to_local(x, x_local), kernel)
        y = tp.all_reduce(part).to(x.dtype)
        return add_bias(tp, bias_path, y, False, bias), False
    y = dense(tp.to_full(x, x_local), kernel)     # replicated
    return add_bias(tp, bias_path, y, False, bias), False


def head_logits(tp, path: str, x, w, vocab_dim: int = -1):
    """f32 logits of x [..., h] against a head `w` [h, V] (`logits_f32`);
    `vocab_dim` is the dim of the leaf at `path` that holds the vocab
    (-1 for an [h, V] head, -2 for a tied [V, h] table)."""
    out = logits_f32(x, w)
    if tp is not None and tp.sharded(path, vocab_dim):
        out = tp.gather(out)
    return out
