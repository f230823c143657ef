"""Disk offload store for big-model inference (port of
`accelerate_tpu/utils/offload.py`).

Weights that fit neither the card nor host memory live on disk as raw
files, `{name}.dat`, beside an `index.json` of `{name: {"dtype",
"shape"}}`. The files and the index are the reference's byte for byte, so
a folder written by either package loads in the other. A `.dat` file is
the tensor's bytes in C order (a rank-0 tensor is one element), and
`dtype` is numpy's name of it. bfloat16 and the float8 types have no numpy
dtype without `ml_dtypes`, which the card's machine lacks: the port writes
and reads them as raw words of their width, and the index still says
"bfloat16".

Reading maps the file privately (`torch.from_file(shared=False)`): the
bytes come in as they are touched, so a stacked [L, ...] weight can be
read one layer at a time, and nothing written to the tensor ever reaches
the file.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Iterator

import numpy as np
import torch

OFFLOAD_INDEX_NAME = "index.json"

# numpy's names of the torch dtypes (`str(np.dtype)`, and ml_dtypes' names
# for the types numpy lacks)
_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
}
_DTYPES = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype, as the index records it."""
    return _NAMES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an index's dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported offload dtype {name!r}") from None


def _host_tensor(weight) -> torch.Tensor:
    if isinstance(weight, torch.Tensor):
        return weight.detach().to("cpu")
    arr = np.array(weight, order="C")
    dtype = torch_dtype(arr.dtype.name)
    if arr.dtype.itemsize == 1 and dtype.is_floating_point:  # float8
        return torch.from_numpy(arr.view(np.uint8)).view(dtype)
    if dtype == torch.bfloat16:     # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(dtype)
    return torch.from_numpy(arr)


def write_raw(f, t: torch.Tensor) -> None:
    """Write a host tensor's bytes (C order) to an open binary file."""
    t = t.contiguous()
    if t.numel():
        f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def offload_weight(weight, weight_name: str, offload_folder: str,
                   index: dict) -> dict:
    """Write one tensor (or numpy array) to `{weight_name}.dat` and record
    it in `index`."""
    t = _host_tensor(weight)
    os.makedirs(offload_folder, exist_ok=True)
    with open(os.path.join(offload_folder, f"{weight_name}.dat"), "wb") as f:
        write_raw(f, t)
    index[weight_name] = {"dtype": dtype_name(t.dtype),
                          "shape": list(t.shape)}
    return index


def load_offloaded_weight(weight_file: str,
                          weight_info: dict) -> torch.Tensor:
    """A host tensor over the file, mapped privately: dtype- and
    shape-faithful, bfloat16 and rank-0 included."""
    shape = tuple(weight_info["shape"])
    dtype = torch_dtype(weight_info["dtype"])
    numel = int(np.prod(shape)) if shape else 1
    if numel == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.from_file(weight_file, shared=False, size=numel,
                           dtype=dtype).reshape(shape)


def save_offload_index(index: dict, offload_folder: str) -> None:
    os.makedirs(offload_folder, exist_ok=True)
    with open(os.path.join(offload_folder, OFFLOAD_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    with open(os.path.join(offload_folder, OFFLOAD_INDEX_NAME)) as f:
        return json.load(f)


def offload_state_dict(offload_folder: str,
                       state_dict: Mapping[str, Any]) -> dict:
    """Offload a whole flat state dict to disk."""
    index: dict = {}
    for name, weight in state_dict.items():
        index = offload_weight(weight, name, offload_folder, index)
    save_offload_index(index, offload_folder)
    return index


class OffloadedWeightsLoader(Mapping):
    """One {name: tensor} view over in-memory weights and a disk offload
    folder. Disk entries are mapped, so reading `loader["layers.w"][i]`
    touches only layer i's bytes."""

    def __init__(self, state_dict: Mapping[str, Any] | None = None,
                 offload_folder: str | None = None,
                 index: dict | None = None) -> None:
        if state_dict is None and offload_folder is None:
            raise ValueError("need state_dict and/or offload_folder")
        self.state_dict = dict(state_dict or {})
        self.offload_folder = offload_folder
        if index is None and offload_folder is not None:
            index_path = os.path.join(offload_folder, OFFLOAD_INDEX_NAME)
            index = (load_offload_index(offload_folder)
                     if os.path.exists(index_path) else {})
        self.index = dict(index or {})
        self.all_keys = list(self.state_dict)
        self.all_keys.extend(k for k in self.index if k not in self.all_keys)

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        info = self.index[key]
        fname = os.path.join(self.offload_folder, f"{key}.dat")
        return load_offloaded_weight(fname, info)

    def __iter__(self) -> Iterator[str]:
        return iter(self.all_keys)

    def __len__(self) -> int:
        return len(self.all_keys)


def extract_submodule_offload_index(index: dict, submodule: str) -> dict:
    """The part of an offload index under one module prefix."""
    prefix = submodule + "."
    return {k: v for k, v in index.items()
            if k == submodule or k.startswith(prefix)}
