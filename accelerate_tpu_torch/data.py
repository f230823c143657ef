"""Batches onto the device, one batch ahead (port of the single-process
path of `accelerate_tpu/data.py` `DataLoaderShard`).

Each leaf of a batch (a tensor, a numpy array, or a nested dict/list of
them) is moved to the device with a pinned-memory, `non_blocking` copy
issued one batch ahead, so the copy of batch i+1 overlaps the step on
batch i. The final batch is known while it is handed out
(`end_of_dataloader`), as in the reference.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from .state import GradientState


def to_device(batch: Any, device, non_blocking: bool = True) -> Any:
    """Every array leaf of `batch` as a tensor on `device` (nested dicts,
    lists and tuples kept). For a `non_blocking` copy to a GPU, host
    leaves are pinned first, so the copy can overlap compute; other
    leaves pass through."""
    if isinstance(batch, dict):
        return {k: to_device(v, device, non_blocking)
                for k, v in batch.items()}
    if hasattr(batch, "_fields"):
        return type(batch)(*(to_device(v, device, non_blocking)
                             for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device, non_blocking) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor):
        return batch
    device = torch.device(device)
    if batch.device == device:
        return batch
    if non_blocking and device.type == "cuda" and batch.device.type == "cpu":
        batch = batch.pin_memory()
    return batch.to(device, non_blocking=non_blocking)


class DataLoaderShard:
    """Iterate `loader`'s batches on `device`, the next one's copy in
    flight while the current one is in use."""

    def __init__(self, loader: Iterable, device):
        self.loader = loader
        self.device = torch.device(device)
        self.gradient_state = GradientState()
        self.end_of_dataloader = False

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        try:
            it = iter(self.loader)
            try:
                nxt = to_device(next(it), self.device)
            except StopIteration:
                return
            while True:
                current = nxt
                try:
                    nxt = to_device(next(it), self.device)
                except StopIteration:
                    self.end_of_dataloader = True
                    yield current
                    return
                yield current
        finally:
            self.gradient_state._remove_dataloader(self)
