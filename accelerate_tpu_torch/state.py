"""Process and precision singletons for one process on one device (port
of `accelerate_tpu/state.py`: `PartialState`, `AcceleratorState`,
`GradientState`). Multi-process worlds (`torch.distributed`) come with
the port's parallelism slice (ROADMAP.md, queue 1 item 6).

The process surface is the reference's, at world size 1: one process,
rank 0, main, local main and last; barriers return at once, the
`on_*_process` decorators run their function, `split_between_processes`
hands the whole input to the one process. The forms across processes
raise and name queue 1 item 6.

As in the reference, every instance of a class aliases one shared dict,
and `_reset_state` clears them all (for tests).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Iterator

import torch

from .device import resolve_device
from .utils.dataclasses import (
    GradientAccumulationPlugin,
    PrecisionType,
    resolve_mixed_precision,
)


class PartialState:
    """The device this process drives: CUDA unless `cpu=True`, raising
    with no GPU and no `cpu=True`."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, **kwargs: Any) -> None:
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        if kwargs:
            raise NotImplementedError(
                f"PartialState options {sorted(kwargs)} (process groups) "
                "arrive with the port's parallelism slice (ROADMAP.md, "
                "queue 1 item 6)")
        self.device = resolve_device("cpu" if cpu else None)
        self.backend = self.device.type
        self.debug = False

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @classmethod
    def _reset_state(cls) -> None:
        """Clear all singleton state (test use)."""
        cls._shared_state.clear()
        AcceleratorState._shared_state.clear()
        GradientState._shared_state.clear()

    # -- topology: one process driving one device ----------------------------
    num_processes = 1
    process_index = 0
    local_process_index = 0
    is_main_process = True
    is_local_main_process = True
    is_last_process = True
    use_distributed = False
    device_count = 1
    local_device_count = 1

    @property
    def devices(self) -> list[torch.device]:
        return [self.device]

    # -- process control (the reference's, at world size 1) ------------------
    def wait_for_everyone(self) -> None:
        """A barrier across processes: nothing to wait for with one."""

    @contextmanager
    def main_process_first(self) -> Iterator[None]:
        """The main process runs the body first: the only one does."""
        yield

    @contextmanager
    def local_main_process_first(self) -> Iterator[None]:
        yield

    @contextmanager
    def split_between_processes(self, inputs,
                                apply_padding: bool = False) -> Iterator[Any]:
        """This process's share of a list, tuple, dict or tensor: with one
        process, all of it, unpadded (as in the reference)."""
        _one_process("split_between_processes")
        yield inputs

    def on_main_process(self, function: Callable) -> Callable:
        """`function`, run only on global rank 0: here, always."""
        return self.on_process(function, 0)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self.on_process(function, 0)

    def on_last_process(self, function: Callable) -> Callable:
        return self.on_process(function, self.num_processes - 1)

    def on_process(self, function: Callable,
                   process_index: int = 0) -> Callable:
        """`function`, run only on `process_index` (None elsewhere)."""
        def wrapper(*args, **kwargs):
            if self.process_index == process_index:
                return function(*args, **kwargs)

        return wrapper

    def print(self, *args: Any, **kwargs: Any) -> None:
        """Print on the main process only."""
        if self.is_main_process:
            print(*args, **kwargs)

    def destroy_process_group(self) -> None:
        """One process joined no group: nothing to leave."""

    def __repr__(self) -> str:
        return (f"PartialState(num_processes=1, process_index=0, "
                f"device={self.device})")


def _one_process(op: str) -> None:
    """Raise for `op` across processes: those forms arrive with the
    port's parallelism slice."""
    if PartialState.num_processes > 1:
        raise NotImplementedError(
            f"{op} across processes arrives with the port's parallelism "
            "slice (ROADMAP.md, queue 1 item 6)")


class AcceleratorState:
    """PartialState plus the mixed-precision policy and the fp8 recipe
    (`fp8_recipe_handler`, set by the Accelerator from its
    `FP8RecipeKwargs`, read by `ops.fp8.resolve_history_len`)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: str | None = None, cpu: bool = False,
                 **kwargs: Any) -> None:
        self.__dict__ = self._shared_state
        if self.initialized:
            asked = mixed_precision
            if asked is not None and \
                    PrecisionType(asked) != self.mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with "
                    f"mixed_precision={self.mixed_precision}; cannot switch "
                    f"to {mixed_precision}. Call Accelerator() once, or "
                    "PartialState._reset_state() in tests.")
            return
        self.partial_state = PartialState(cpu=cpu, **kwargs)
        self.mixed_precision = resolve_mixed_precision(mixed_precision)
        self.fp8_recipe_handler = None

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @classmethod
    def _reset_state(cls) -> None:
        PartialState._reset_state()

    @property
    def dp_size(self) -> int:
        """The batch-sharding degree: 1 on one device."""
        return 1

    def __getattr__(self, name: str):
        # topology and process control come from PartialState
        if name in ("partial_state", "_shared_state"):
            raise AttributeError(name)
        partial = self.__dict__.get("partial_state")
        if partial is None:
            raise AttributeError(
                f"AcceleratorState has no attribute {name!r} "
                "(not initialized?)")
        return getattr(partial, name)

    def __repr__(self) -> str:
        return (f"AcceleratorState(mixed_precision={self.mixed_precision}, "
                f"{self.partial_state!r})")


class GradientState:
    """Gradient-accumulation bookkeeping: the plugin, whether this step
    is a sync boundary, and the active dataloader (with its `remainder`
    and `tail_layout`, where it has them)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self,
                 plugin: GradientAccumulationPlugin | None = None) -> None:
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references: list[Any] = [None]
            self.plugin = plugin or GradientAccumulationPlugin()
        if plugin is not None:
            self.plugin = plugin

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @property
    def num_steps(self) -> int:
        return self.plugin.num_steps

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin.adjust_scheduler

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin.sync_with_dataloader

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        if not self.in_dataloader:
            return False
        return getattr(self.active_dataloader, "end_of_dataloader", False)

    @property
    def remainder(self) -> int:
        """Real samples in the final uneven batch, or -1."""
        if not self.in_dataloader:
            return -1
        return getattr(self.active_dataloader, "remainder", -1)

    @property
    def tail_layout(self):
        """(processes, padded rows, real rows) of the final uneven batch,
        or None."""
        if not self.in_dataloader:
            return None
        return getattr(self.active_dataloader, "tail_layout", None)

    def _set_sync_gradients(self, sync: bool) -> None:
        self.sync_gradients = sync

    def _add_dataloader(self, dataloader) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        refs = self.__dict__.get("dataloader_references")
        if refs is None:
            return
        if dataloader in refs:
            refs.remove(dataloader)
        self.active_dataloader = refs[-1] if refs else None

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()

    def __repr__(self) -> str:
        return (f"GradientState(num_steps={self.num_steps}, "
                f"sync_gradients={self.sync_gradients}, "
                f"in_dataloader={self.in_dataloader})")


def is_initialized() -> bool:
    return AcceleratorState._shared_state != {}
