"""ZeRO-1/2 on the mesh's `fsdp` axis (the reference's DeepSpeed stages
1 and 2 and FSDP's `SHARD_GRAD_OP`): the params stay whole on every
rank, and the optimizer moments and the accumulation buffer are each
rank's block of every leaf that the planner cuts on `fsdp`
(`plan_sharding(params, mesh, rules, shard_params=True)`, the plan the
reference gives the moments "as if params were fsdp-sharded").

The reference lets GSPMD place the collectives: "grads reduce-scatter
into moment shards and only the param delta is all-gathered". Here a
`ZeroLayout` makes them, in this order, on every rank alike:

1. `reduce_gradients`: the whole gradients reduce-scatter over the
   `fsdp` line into this rank's blocks (`utils.operations.
   reduce_scatter_mean_`, freeing the whole gradients bucket by bucket),
   and the blocks average over the rest of the batch line (`data`);
   leaves the plan leaves whole (a dimension that does not divide) are
   averaged whole over the line, as under data parallelism. The block
   tree's placement is recorded (`sharding.record_placement`), so the
   clip's norm and the fp16 check count each block once across the
   `fsdp` line (`training.sum_of_squares`).
2. `update_`: the optimizer's update on the blocks (the gradient blocks,
   the moment blocks and this rank's slice of each param, which
   AdamW's weight decay reads), added into that slice of the whole f32
   param, then every slice all-gathered over `fsdp` into the whole
   params in place (`utils.operations.all_gather_blocks_`), so every
   rank holds the same params bit for bit.
"""

from __future__ import annotations

import torch

from ..optimizers import apply_updates, tree_leaves, tree_map
from ..utils import operations as ops
from ..utils.constants import AXIS_FSDP, BATCH_AXES
from .planner import record_placement


def _fsdp_dim(sharding) -> int | None:
    """The dim a leaf's spec cuts on `fsdp` (None: whole). A spec that
    names another axis raises: ZeRO runs on `data` x `fsdp` alone."""
    dim = None
    for d, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if axes != (AXIS_FSDP,):
            raise ValueError(f"a ZeRO plan cuts on `fsdp` alone, not on "
                             f"{axes}")
        dim = d
    return dim


class ZeroLayout:
    """Where ZeRO-1/2 cuts each param leaf on `mesh`'s `fsdp` axis:
    `plan` is the moments' plan of `params` (a tree of `NamedSharding`
    like it, kept as `plan`). `dims` holds, for each leaf in
    `tree_leaves` order, the dim cut on `fsdp` or None for a leaf kept
    whole; `cut` says whether any leaf is. See the module docstring."""

    def __init__(self, params, plan, mesh):
        self.mesh = mesh
        self.plan = plan
        self.dims = [_fsdp_dim(s) for s in tree_leaves(plan)]
        self.size = mesh.shape.get(AXIS_FSDP, 1)
        self.index = mesh.axis_index(AXIS_FSDP) if self.size > 1 else 0
        self._skeleton = tree_map(lambda _: None, params)
        self.cut = self.size > 1 and any(d is not None for d in self.dims)
        # the gradient blocks (and a copy of them) are known as blocks
        it = iter(self.dims)
        record_placement(tree_map(
            lambda p: torch.empty(self._block_shape(p, next(it)),
                                  device="meta"), params), plan)

    def _block_shape(self, t, dim) -> tuple:
        shape = list(t.shape)
        if dim is not None:
            shape[dim] //= self.size
        return tuple(shape)

    def _tree(self, leaves: list):
        it = iter(leaves)
        return tree_map(lambda _: next(it), self._skeleton)

    @property
    def group(self):
        """The `fsdp` line's group."""
        return self.mesh.group(AXIS_FSDP)

    def _rest_group(self):
        """The batch line's other axes (`data`), or None where that is a
        line of one."""
        rest = tuple(a for a in self.mesh.axis_names
                     if a in BATCH_AXES and a != AXIS_FSDP)
        return self.mesh.group_over(rest) if rest else None

    def blocks(self, tree):
        """This rank's block of each cut leaf of `tree` (a tree like the
        params: the params, or whole gradients), as a view; whole leaves
        as they are."""
        it = iter(self.dims)

        def block(t):
            dim = next(it)
            if dim is None:
                return t
            b = t.shape[dim] // self.size
            return t.narrow(dim, self.index * b, b)

        return tree_map(block, tree)

    def reduce_gradients(self, leaves: list, line):
        """The global batch's gradient as this rank's blocks, from the
        whole gradients `leaves` (in `tree_leaves` order; the list's
        entries are released as they are scattered, so a caller that
        holds no other reference frees them bucket by bucket): a tree
        like the params, each cut leaf this rank's block of the mean
        over the batch line `line` (`state.DataLine`), each whole leaf
        the whole mean."""
        cut = [i for i, d in enumerate(self.dims) if d is not None]
        whole = [i for i, d in enumerate(self.dims) if d is None]
        blocks = [torch.empty(self._block_shape(leaves[i], self.dims[i]),
                              dtype=leaves[i].dtype,
                              device=leaves[i].device) for i in cut]
        scattered = [leaves[i] for i in cut]
        for i in cut:
            leaves[i] = None
        ops.reduce_scatter_mean_(scattered, blocks,
                                 [self.dims[i] for i in cut], self.group)
        rest = self._rest_group()
        if rest is not None:
            ops.all_reduce_mean_(blocks, group=rest)
        ops.all_reduce_mean_([leaves[i] for i in whole], group=line.group)
        for j, i in enumerate(cut):
            leaves[i] = blocks[j]
        return self._tree(leaves)

    @torch.no_grad()
    def update_(self, tx, grads, opt_state, params):
        """One optimizer update on the blocks: `grads` and `opt_state`
        hold this rank's blocks, `params` the whole params, whose slices
        take the update in place before the all-gather makes them whole
        again on every rank. Returns the new optimizer state."""
        param_blocks = self.blocks(params)
        updates, opt_state = tx.update(grads, opt_state, param_blocks)
        apply_updates(param_blocks, updates)
        del updates
        self.gather_(params)
        return opt_state

    def gather_(self, params) -> None:
        """Every rank's slice of each cut param written into the whole
        param on every rank (`all_gather_blocks_` over `fsdp`)."""
        leaves = tree_leaves(params)
        cut = [i for i, d in enumerate(self.dims) if d is not None]
        ops.all_gather_blocks_([leaves[i] for i in cut],
                               [self.dims[i] for i in cut], self.group)
