"""Batches onto the device, one batch ahead (port of the single-process
path of `accelerate_tpu/data.py` `DataLoaderShard`).

Each leaf of a batch (a tensor, a numpy array, or a nested dict/list of
them) is moved to the device with a pinned-memory, `non_blocking` copy
issued one batch ahead, so the copy of batch i+1 overlaps the step on
batch i. The final batch is known while it is handed out
(`end_of_dataloader`), as in the reference. `epoch` counts the passes
finished (a checkpoint saves it), and `skip_first_batches` resumes a
pass in its middle.
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
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Set the pass number, here and on the source (or its sampler)
        where it has `set_epoch`, as the reference does."""
        self.epoch = epoch
        for obj in (self.loader, getattr(self.loader, "sampler", None),
                    getattr(self.loader, "batch_sampler", None)):
            if obj is not None and hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)

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
                    break
                yield current
            self.set_epoch(self.epoch + 1)
        finally:
            self.gradient_state._remove_dataloader(self)


class SkipDataLoader:
    """Iterate `loader`, skipping its first `skip_batches` batches."""

    def __init__(self, loader: Iterable, skip_batches: int = 0):
        self.loader = loader
        self.skip_batches = skip_batches

    def __iter__(self):
        for index, batch in enumerate(self.loader):
            if index >= self.skip_batches:
                yield batch

    def __len__(self) -> int:
        return max(len(self.loader) - self.skip_batches, 0)


def skip_first_batches(dataloader, num_batches: int = 0):
    """Resume in the middle of a pass: a prepared loader comes back as a
    copy over its source with the first `num_batches` skipped (so it still
    moves batches to its device); any other iterable is wrapped."""
    if isinstance(dataloader, DataLoaderShard):
        import copy

        clone = copy.copy(dataloader)
        clone.loader = SkipDataLoader(dataloader.loader, num_batches)
        return clone
    return SkipDataLoader(dataloader, num_batches)
