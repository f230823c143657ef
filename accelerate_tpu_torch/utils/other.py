"""Pytree helpers for checkpoints (port of `flatten_dict` and
`unflatten_dict` in `accelerate_tpu/utils/other.py`)."""

from __future__ import annotations

from typing import Any


def flatten_dict(tree: Any, prefix: str = "", sep: str = ".") -> dict[str, Any]:
    """Flatten nested dicts, lists, tuples and NamedTuples into
    {'a.b.c': leaf}. A dict's part of the key is its key, a NamedTuple's
    its field name (the optimizers' states: `opt_state.mu.embed`), a list's
    or tuple's the index, as in the reference."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_dict(v, f"{prefix}{sep}{k}" if prefix else k, sep))
    return out


def unflatten_dict(flat: dict[str, Any], sep: str = ".") -> dict[str, Any]:
    """Inverse of `flatten_dict` for nested dicts."""
    out: dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out
