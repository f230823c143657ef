"""Move a param tree between numpy and the port's torch dict.

A JAX param pytree turned to numpy (`jax.tree_util.tree_map(np.asarray,
params)`) has the same nested keys and stacked shapes as the port's
params, so one pair of functions serves every model family: the tests
hand the same weights to both packages through them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _to_tensor(a, device, dtype):
    # a writable copy: arrays read out of JAX are read-only, and the
    # tensor must not share memory with the caller's array
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from ml_dtypes; torch cannot read it,
        # but the 16-bit pattern is the same
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, device=None, dtype=None) -> dict:
    """Nested dict of arrays -> the same nested dict of tensors on
    `device` (CUDA unless "cpu"), optionally cast to `dtype`."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return walk(tree)


def params_to_numpy(params) -> dict:
    """Inverse of `params_from_numpy`: tensors -> numpy arrays (bf16
    tensors become ml_dtypes bfloat16 arrays), keys and shapes kept."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return walk(params)
