"""Checkpoint reading for model import (port of `load_state_dict` and
`resolve_checkpoint_files` of `accelerate_tpu/utils/modeling.py`).

`.safetensors` files go through the port's own reader
(`utils/safetensors.py`: the card's machine has no `safetensors`
package); torch `.bin` files through `torch.load(weights_only=True)`.
Tensors come back on the host in the dtype the file holds.
"""

from __future__ import annotations

import json
import os

import torch

from . import safetensors
from .constants import (
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    WEIGHTS_INDEX_NAME,
    WEIGHTS_NAME,
)

__all__ = ["load_state_dict", "resolve_checkpoint_files"]


def load_state_dict(checkpoint_file: str,
                    keys: list[str] | None = None) -> dict[str, torch.Tensor]:
    """A checkpoint file as {name: host tensor}, all of it or `keys`."""
    if checkpoint_file.endswith(".safetensors"):
        want = None if keys is None else set(keys)
        out = {name: t for name, t in safetensors.iter_file(checkpoint_file)
               if want is None or name in want}
        if want is not None and want - out.keys():
            raise KeyError(f"{checkpoint_file}: no tensor "
                           f"{sorted(want - out.keys())}")
        return out
    sd = torch.load(checkpoint_file, map_location="cpu", weights_only=True)
    if keys is not None:
        sd = {k: sd[k] for k in keys}
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def resolve_checkpoint_files(checkpoint: str) -> list[str]:
    """The files of a checkpoint given as one file, an index json, or a
    directory (holding an index, one weights file, or shards)."""
    if os.path.isfile(checkpoint):
        if checkpoint.endswith(".json"):
            folder = os.path.dirname(checkpoint)
            with open(checkpoint) as f:
                index = json.load(f)
            return [os.path.join(folder, v)
                    for v in sorted(set(index["weight_map"].values()))]
        return [checkpoint]
    if os.path.isdir(checkpoint):
        for name in (SAFE_WEIGHTS_INDEX_NAME, WEIGHTS_INDEX_NAME):
            p = os.path.join(checkpoint, name)
            if os.path.exists(p):
                return resolve_checkpoint_files(p)
        for name in (SAFE_WEIGHTS_NAME, WEIGHTS_NAME):
            p = os.path.join(checkpoint, name)
            if os.path.exists(p):
                return [p]
        shards = sorted(os.path.join(checkpoint, f)
                        for f in os.listdir(checkpoint)
                        if f.endswith(".safetensors"))
        if shards:
            return shards
    raise FileNotFoundError(f"no checkpoint found at {checkpoint}")
