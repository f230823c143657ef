"""Sharding planner (port of `accelerate_tpu/sharding/planner.py`): param
tree + mesh + rules -> a `NamedSharding` per leaf.

The reference emits `jax.sharding.NamedSharding`s and lets GSPMD insert
the collectives. The port keeps the plan (the same `PartitionSpec` per
leaf, from the same rules) over its process mesh (`state.ProcessMesh`:
one process per device), and places a tree by slicing each leaf down to
this rank's shard (`shard_pytree`), which records the placement on
the mesh (`placement_of`). The forward that reads such shards
does its own collectives (`models/tensor_parallel.py`).

- ZeRO-3 / FSDP FULL_SHARD  -> params sharded on the `fsdp` axis
- ZeRO-1/2 / SHARD_GRAD_OP  -> only optimizer state sharded (params replicated)
- Megatron TP               -> `model`-axis entries in the rule templates
- MoE expert parallel       -> `expert`-axis entries
- DDP                       -> no axes present; everything replicates

Trees are nested dicts, lists, tuples and NamedTuples; a leaf is
anything with a `shape` (tensors, meta tensors, numpy arrays), other
leaves pass through. Paths join dict keys, sequence indices and
NamedTuple field names with "/", as the reference's do.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import numpy as np
import torch

from ..utils.constants import AXIS_FSDP, BATCH_AXES
from .rules import ShardingRules, SpecTemplate, transformer_rules

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "auto_fsdp_spec",
    "plan_sharding",
    "plan_optimizer_sharding",
    "batch_spec",
    "batch_sharding",
    "shard_pytree",
    "placement_of",
    "holds_blocks",
    "record_placement",
    "whole_pytree",
    "describe_plan",
]


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), an axis name, or a tuple of
    axis names (sharded over their product, the first axis major). Equal
    to the reference's spec of the same entries; no trailing Nones are
    implied (`PartitionSpec()` is not `PartitionSpec(None)`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self) -> list[str]:
        """The mesh axes the spec names, in order."""
        out = []
        for e in self:
            if e is None:
                continue
            out.extend(e if isinstance(e, tuple) else (e,))
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: `spec` over `mesh` (`state.ProcessMesh`, or
    anything with the reference mesh's `shape` mapping)."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        """The local shape of a leaf of global `shape`."""
        sizes = _axis_sizes(self.mesh)
        out = list(shape)
        for dim, e in enumerate(self.spec):
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                out[dim] //= sizes[a]
        return tuple(out)

    def whole_shape(self, shape) -> tuple:
        """The global shape of a leaf whose block has `shape` (the
        inverse of `shard_shape`)."""
        sizes = _axis_sizes(self.mesh)
        out = list(shape)
        for dim, e in enumerate(self.spec):
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                out[dim] *= sizes[a]
        return tuple(out)

    def local_slices(self, coords: dict[str, int], shape) -> tuple:
        """The slice of each dim held at mesh coordinates `coords`
        ({axis: index}); a dim over several axes takes them major to
        minor."""
        sizes = _axis_sizes(self.mesh)
        out = []
        for dim, n in enumerate(shape):
            e = self.spec[dim] if dim < len(self.spec) else None
            axes = () if e is None else e if isinstance(e, tuple) else (e,)
            index, count = 0, 1
            for a in axes:
                index = index * sizes[a] + coords[a]
                count *= sizes[a]
            step = n // count
            out.append(slice(index * step, (index + 1) * step))
        return tuple(out)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, dict)


def _map_with_path(fn: Callable, tree, path=()):
    """`fn(path, leaf)` over the shaped leaves of a tree (others kept)."""
    if isinstance(tree, dict):
        return type(tree)({k: _map_with_path(fn, v, path + (k,))
                           for k, v in tree.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if _is_leaf(tree):
        return fn(path, tree)
    return tree


def _zip_map(fn: Callable, tree, other):
    """`fn(leaf, other_leaf)` over `tree`'s shaped leaves, `other` a tree
    of the same structure."""
    if isinstance(tree, dict):
        return type(tree)({k: _zip_map(fn, v, other[k])
                           for k, v in tree.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(other, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    if _is_leaf(tree):
        return fn(tree, other)
    return tree


def leaves_with_path(tree, path=(), is_leaf=_is_leaf) -> list:
    """[(path string, leaf)] of a tree, dict keys sorted (the reference's
    flattening order)."""
    if is_leaf(tree):
        return [(_path_str(path), tree)]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    out = []
    for k, v in items:
        out.extend(leaves_with_path(v, path + (k,), is_leaf))
    return out


def _prune_template(template: SpecTemplate, shape: tuple,
                    mesh) -> PartitionSpec:
    """Fit a spec template to a concrete shape on a concrete mesh: drop axes
    that aren't in the mesh, are size 1, or don't divide the dim. Templates
    shorter than the rank align to the *trailing* dims (leading batch/expert
    dims handled by explicit longer templates)."""
    sizes = _axis_sizes(mesh)
    rank = len(shape)
    entries: list = [None] * rank
    template = tuple(template)[:rank] if len(template) > rank \
        else tuple(template)
    offset = rank - len(template)
    used: set[str] = set()
    for i, entry in enumerate(template):
        dim = offset + i
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        group = 1
        for a in axes:
            if a in used or sizes.get(a, 1) == 1:
                continue
            if shape[dim] % (group * sizes[a]) != 0:
                continue
            kept.append(a)
            group *= sizes[a]
        for a in kept:
            used.add(a)
        if kept:
            entries[dim] = tuple(kept) if len(kept) > 1 else kept[0]
    return PartitionSpec(*entries)


def auto_fsdp_spec(shape: tuple, mesh, axis: str = AXIS_FSDP) -> PartitionSpec:
    """ZeRO-style auto rule: shard the largest dim divisible by the fsdp axis
    (prefers later dims on ties — usually the output/feature dim)."""
    size = _axis_sizes(mesh).get(axis, 1)
    if size == 1 or not shape:
        return PartitionSpec()
    best_dim, best = -1, 0
    for dim, n in enumerate(shape):
        if n % size == 0 and n >= best:
            best, best_dim = n, dim
    if best_dim < 0:
        return PartitionSpec()
    entries = [None] * len(shape)
    entries[best_dim] = axis
    return PartitionSpec(*entries)


def plan_sharding(params: Any, mesh, rules: ShardingRules | None = None,
                  shard_params: bool = True) -> Any:
    """A tree of `NamedSharding` matching `params` (tensors, meta tensors
    from `big_modeling.init_empty_weights`, or anything with a `shape`:
    planning materialises nothing).

    `shard_params=False` replicates parameters (ZeRO-1/2: only the optimizer
    state adopts the sharded plan — see `plan_optimizer_sharding`).
    """
    rules = rules if rules is not None else transformer_rules()

    def _plan(path, leaf):
        shape = tuple(leaf.shape)
        if not shard_params:
            return NamedSharding(mesh, PartitionSpec())
        nelems = int(np.prod(shape)) if shape else 1
        if nelems < rules.min_weight_size:
            return NamedSharding(mesh, PartitionSpec())
        template = rules.find(_path_str(path))
        if template is not None:
            spec = _prune_template(template, shape, mesh)
        elif rules.default_fsdp:
            spec = auto_fsdp_spec(shape, mesh)
        else:
            spec = PartitionSpec()
        # fall back to auto-fsdp if a matched rule pruned to fully-replicated
        if (
            template is not None
            and len(template) > 0
            and spec == PartitionSpec(*([None] * len(shape)))
            and rules.default_fsdp
        ):
            spec = auto_fsdp_spec(shape, mesh)
        return NamedSharding(mesh, spec)

    return _map_with_path(_plan, params)


def plan_optimizer_sharding(optimizer, opt_state: Any, param_plan: Any,
                            mesh) -> Any:
    """Shard optimizer state like its params (ZeRO-1/2/3 optimizer-state
    sharding, ref DeepSpeed engine).

    The reference maps param-shaped state with `optax.tree_map_params`;
    the port's states (`optimizers.py`) are NamedTuples whose param-shaped
    fields (AdamW's `mu`/`nu`, SGD's momentum `trace`) mirror the params
    tree, so a field with the plan's structure and the params' leaf
    shapes adopts the plan, and every other leaf (the step `count`)
    replicates. `optimizer` is accepted for the reference's signature.
    Block-quantized moments (the reference's `adamw_8bit`) are not in the
    port."""
    replicated = NamedSharding(mesh, PartitionSpec())

    def plan_of(state):
        if _same_structure_plan(state, param_plan):
            return param_plan
        if isinstance(state, tuple) and hasattr(state, "_fields"):
            return type(state)(*(plan_of(getattr(state, f))
                                 for f in state._fields))
        if isinstance(state, dict):
            return type(state)({k: plan_of(v) for k, v in state.items()})
        if isinstance(state, (list, tuple)):
            return type(state)(plan_of(v) for v in state)
        return replicated if _is_leaf(state) else None

    return plan_of(opt_state)


def _same_structure_plan(state, plan) -> bool:
    """Whether `state` mirrors the plan's tree, leaf for leaf, with
    tensors where the plan has shardings (and at least one leaf)."""
    if isinstance(plan, NamedSharding):
        return _is_leaf(state)
    if isinstance(plan, dict):
        return (isinstance(state, dict) and len(plan) > 0
                and state.keys() == plan.keys()
                and all(_same_structure_plan(state[k], plan[k])
                        for k in plan))
    if isinstance(plan, (list, tuple)):
        return (isinstance(state, (list, tuple)) and len(plan) > 0
                and len(state) == len(plan)
                and all(_same_structure_plan(s, p)
                        for s, p in zip(state, plan)))
    return False


def batch_spec(mesh, batch_axes=BATCH_AXES,
               extra_dims: int = 0) -> PartitionSpec:
    """PartitionSpec for a batch: leading dim over the data-like axes."""
    sizes = _axis_sizes(mesh)
    axes = tuple(a for a in batch_axes
                 if a in mesh.axis_names and sizes[a] > 1)
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return PartitionSpec(lead, *([None] * extra_dims))


def batch_sharding(mesh, batch_axes=BATCH_AXES) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh, batch_axes))


def shard_pytree(tree: Any, plan: Any, rank: int | None = None,
                 device=None) -> Any:
    """This rank's shard of every leaf under `plan`: each leaf sliced by
    the rank's coordinate on each axis its spec names (a copy, contiguous)
    and put on `device` (the plan's mesh's device by default). A None plan
    leaf, or a leaf without a shape, passes through untouched. `rank` is
    this process's rank in the mesh (default: the live world's). Where a
    leaf is cut, the placement is recorded on the mesh
    (`placement_of`)."""
    cut: dict = {}

    def place(leaf, sharding):
        if sharding is None:
            return leaf
        mesh = sharding.mesh
        r = mesh.rank if rank is None else rank
        slices = sharding.local_slices(mesh.coords(r), tuple(leaf.shape))
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        dev = device if device is not None else mesh.device
        dev = leaf.device if dev is None else torch.device(dev)
        whole = all(sl == slice(0, n) for sl, n in zip(slices, leaf.shape))
        if whole and leaf.device == dev:
            return leaf
        # a copy, never a view: a view would keep the whole leaf alive
        block = leaf[slices].to(dev, copy=True,
                                memory_format=torch.contiguous_format)
        if not whole:
            cut[id(block)] = sharding
        return block

    placed = _zip_map(place, tree, plan)
    _record(placed, cut)
    return placed


def _record(placed, cut: dict) -> None:
    """Record the placement of `placed`, whose leaves of id in `cut` are
    blocks under that sharding."""
    if not cut:
        return
    leaves = leaves_with_path(placed)
    mesh = next(iter(cut.values())).mesh
    _PLACEMENTS.setdefault(mesh, {})[_tree_key(leaves)] = tuple(
        cut[id(leaf)].spec if id(leaf) in cut else None
        for _, leaf in leaves)


def record_placement(tree, plan) -> None:
    """Record `plan` as the placement of `tree`, whose leaves are already
    this rank's blocks under it (a tree cut by other means than
    `shard_pytree`: the gradient blocks of ZeRO's reduce-scatter), so
    `placement_of` knows it and its copies. Leaves whose spec cuts
    nothing are whole."""
    cut: dict = {}

    def note(leaf, sharding):
        if sharding is not None and sharding.spec.axes() and any(
                _axis_sizes(sharding.mesh)[a] > 1
                for a in sharding.spec.axes()):
            cut[id(leaf)] = sharding
        return leaf

    _zip_map(note, tree, plan)
    _record(tree, cut)


# mesh -> {(path, shape) of every leaf: the spec of each leaf, None where
# it is whole}: the placements `shard_pytree` cut on each mesh, kept by
# the placed tree's paths and shapes, so that a copy of the tree, a
# tree_map of it and its gradients (which mirror it) are known as well
_PLACEMENTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _tree_key(leaves: list) -> tuple:
    return tuple((path, tuple(leaf.shape)) for path, leaf in leaves)


def placement_of(tree, mesh=None) -> tuple | None:
    """Where `tree` holds this rank's blocks of larger leaves: the
    `PartitionSpec` of each leaf (None for a whole one), in
    `leaves_with_path` order, of the placement `shard_pytree` cut on
    `mesh` (default: the process state's) of a tree with `tree`'s paths
    and shapes. That is the placed tree itself, a copy or a tree_map of
    it, or its gradients. None where no such placement cut a leaf (a
    whole tree of the same paths and shapes as a placed one is taken
    for it)."""
    from ..state import mesh_or_state

    mesh = mesh_or_state(mesh)
    made = None if mesh is None else _PLACEMENTS.get(mesh)
    if not made or tree is None:
        return None
    return made.get(_tree_key(leaves_with_path(tree)))


def holds_blocks(tree, mesh=None) -> bool:
    """Whether `tree` holds blocks of larger leaves (`placement_of`)."""
    return placement_of(tree, mesh) is not None


def whole_pytree(tree, mesh=None):
    """`tree` with each block (`placement_of` on `mesh`, default the
    process state's) all-gathered over its line into the whole leaf, and
    every whole leaf as it is: a collective that every rank of the mesh
    makes, leaf by leaf in `leaves_with_path` order. A tree that holds
    no block comes back as it is."""
    from ..state import mesh_or_state
    from ..utils import operations as ops

    mesh = mesh_or_state(mesh)
    placement = placement_of(tree, mesh)
    if placement is None:
        return tree
    specs = {id(leaf): spec for (_, leaf), spec in
             zip(leaves_with_path(tree), placement)}
    # gathered in leaves_with_path order, so every rank agrees
    whole = {}
    for _, leaf in leaves_with_path(tree):
        spec, out = specs[id(leaf)], leaf
        for dim, entry in enumerate(spec or ()):
            axes = () if entry is None else entry \
                if isinstance(entry, tuple) else (entry,)
            # the minor axis first: a dim over several axes takes them
            # major to minor (`NamedSharding.local_slices`)
            for axis in reversed(axes):
                out = ops.axis_all_gather(out.detach().contiguous(), dim,
                                          mesh.group(axis))
        whole[id(leaf)] = out
    return _map_with_path(lambda _, leaf: whole[id(leaf)], tree)


def describe_plan(plan: Any, max_rows: int = 120) -> str:
    """Human-readable sharding table (debug aid; no reference equivalent)."""
    rows = []
    for path, sharding in leaves_with_path(
            plan, is_leaf=lambda x: isinstance(x, NamedSharding)):
        rows.append(f"  {path:60s} {sharding.spec}")
        if len(rows) >= max_rows:
            rows.append("  ...")
            break
    return "\n".join(rows)
