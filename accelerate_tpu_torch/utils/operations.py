"""Tree utilities and host-level collectives for one process (port of
`accelerate_tpu/utils/operations.py`).

Trees are nested dicts, lists, tuples and NamedTuples; their leaves are
torch tensors (numpy arrays are taken too). Tensors stay torch tensors
on their device, where the reference hands back numpy arrays.

At world size 1 every collective is the reference's one-process form:
`gather` and `broadcast` return their input, `gather_object` a list of
one, `reduce` scales by `scale`, `pad_across_processes` pads nothing.
Their forms across processes arrive with the port's parallelism slice
(ROADMAP.md, queue 1 item 6) and raise until then.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..data import to_device
from ..state import PartialState, _one_process


def is_tensor(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def honor_type(obj, generator):
    """`obj`'s container type rebuilt from `generator` (NamedTuples by
    position)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def _map(fn: Callable, data: Any) -> Any:
    """`fn` over the leaves of nested dicts, lists, tuples and
    NamedTuples; None stays None (an empty subtree, as in the
    reference's tree_map)."""
    if isinstance(data, dict):
        return type(data)({k: _map(fn, v) for k, v in data.items()})
    if isinstance(data, (list, tuple)):
        return honor_type(data, (_map(fn, v) for v in data))
    if data is None:
        return None
    return fn(data)


def _leaves(data: Any) -> list:
    if isinstance(data, dict):
        return [leaf for v in data.values() for leaf in _leaves(v)]
    if isinstance(data, (list, tuple)):
        return [leaf for v in data for leaf in _leaves(v)]
    return [] if data is None else [data]


def recursively_apply(func: Callable, data: Any, *args: Any,
                      test_type: Callable[[Any], bool] = is_tensor,
                      error_on_other_type: bool = False, **kwargs: Any):
    """`func(leaf, *args, **kwargs)` on every leaf that passes
    `test_type`; other leaves kept, or a TypeError with
    `error_on_other_type`."""
    def apply(x):
        if test_type(x):
            return func(x, *args, **kwargs)
        if error_on_other_type:
            raise TypeError(f"unsupported type {type(x)} in "
                            "recursively_apply")
        return x

    return _map(apply, data)


def send_to_device(tensor, device=None, non_blocking: bool = True,
                   skip_keys=None):
    """Every array leaf as a tensor on `device` (default: the process's
    device); with `skip_keys`, a dict's entries under those keys stay as
    they are."""
    if device is None:
        device = PartialState().device
    if skip_keys and isinstance(tensor, dict):
        return type(tensor)({
            k: (v if k in skip_keys else send_to_device(v, device,
                                                        non_blocking))
            for k, v in tensor.items()})
    return to_device(tensor, device, non_blocking=non_blocking)


def find_batch_size(data) -> int | None:
    """The leading size of the first array leaf with a dimension."""
    for leaf in _leaves(data):
        if is_tensor(leaf) and leaf.ndim > 0:
            return int(leaf.shape[0])
    return None


def slice_tensors(data, tensor_slice, process_index=None,
                  num_processes=None):
    """Every array leaf indexed by `tensor_slice`."""
    return recursively_apply(lambda x: x[tensor_slice], data)


def listify(data):
    """Array leaves as nested Python lists."""
    return recursively_apply(
        lambda x: (x.detach().cpu() if isinstance(x, torch.Tensor)
                   else x).tolist(), data)


def convert_to_fp32(tensor):
    """Floating leaves (f16, bf16, f64) as float32; others kept."""
    def convert(x):
        if isinstance(x, torch.Tensor):
            return x.float() if x.is_floating_point() else x
        return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) \
            else x

    return recursively_apply(convert, tensor)


convert_outputs_to_fp32 = convert_to_fp32


# ---------------------------------------------------------------------------
# host-level collectives, at world size 1
# ---------------------------------------------------------------------------


def gather(tensor):
    """Each leaf concatenated along dim 0 across processes: with one
    process, the leaf itself."""
    _one_process("gather")
    if PartialStateDebug.enabled():
        verify_operation(tensor, "gather")
    return tensor


def gather_object(obj: Any) -> list[Any]:
    """The list of every process's `obj`: [obj] with one process."""
    _one_process("gather_object")
    return [obj]


def broadcast(tensor, from_process: int = 0):
    """Every leaf as `from_process` holds it: the input, with one."""
    _one_process("broadcast")
    if PartialStateDebug.enabled():
        verify_operation(tensor, "broadcast")
    return tensor


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    _one_process("broadcast_object_list")
    return object_list


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """Each leaf summed (or averaged) across processes, times `scale`;
    `reduction="none"` returns the input. With one process the sum and
    the mean are the leaf itself."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean|sum|none, got {reduction}")
    if reduction == "none":
        return tensor
    _one_process("reduce")
    if PartialStateDebug.enabled():
        verify_operation(tensor, "reduce")
    return recursively_apply(lambda x: x * scale, tensor)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0,
                         pad_first: bool = False):
    """Each leaf padded along `dim` to the largest size across processes
    (so a `gather` is legal): with one process, as it is."""
    _one_process("pad_across_processes")
    return tensor


def pad_input_tensors(tensor, batch_size: int, num_processes: int,
                      dim: int = 0):
    """Each leaf padded along `dim` by repeating its last slice, so that
    `batch_size` divides evenly over `num_processes`."""
    def pad(x):
        remainder = batch_size % num_processes
        if remainder == 0:
            return x
        rows = num_processes - remainder
        if isinstance(x, np.ndarray):
            width = [(0, 0)] * x.ndim
            width[dim] = (0, rows)
            return np.pad(x, width, mode="edge")
        edge = x.narrow(dim, x.shape[dim] - 1, 1)
        return torch.cat([x, edge.repeat_interleave(rows, dim=dim)], dim=dim)

    return recursively_apply(pad, tensor)


def concatenate(data: list, dim: int = 0):
    """A list of trees of one structure, leaves concatenated along
    `dim`."""
    if not data:
        return data
    first = data[0]
    if isinstance(first, dict):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim)
                            for k in first})
    if isinstance(first, (tuple, list)):
        return honor_type(first, (concatenate([d[i] for d in data], dim=dim)
                                  for i in range(len(first))))
    if all(isinstance(d, torch.Tensor) for d in data):
        return torch.cat(list(data), dim=dim)
    return np.concatenate([np.asarray(d) for d in data], axis=dim)


# ---------------------------------------------------------------------------
# debug-mode verification
# ---------------------------------------------------------------------------


class PartialStateDebug:
    """Whether the process state asks for debug verification
    (`PartialState().debug`)."""

    @staticmethod
    def enabled() -> bool:
        return PartialState._shared_state.get("debug", False)


def verify_operation(tensor, op_name: str) -> None:
    """Check that every process passes leaves of the same shapes and
    dtypes to `op_name`: one process always agrees."""
    _one_process(f"verify_operation({op_name})")
