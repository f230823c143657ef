"""Process and precision singletons for one process on one device (port
of `accelerate_tpu/state.py`: `PartialState`, `AcceleratorState`,
`GradientState`). Multi-process worlds (`torch.distributed`) come with
the port's parallelism slice.

As in the reference, every instance of a class aliases one shared dict,
and `_reset_state` clears them all (for tests).
"""

from __future__ import annotations

from typing import Any

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
                "arrive with the port's parallelism slice")
        self.device = resolve_device("cpu" if cpu else None)
        self.backend = self.device.type

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @classmethod
    def _reset_state(cls) -> None:
        """Clear all singleton state (test use)."""
        cls._shared_state.clear()
        AcceleratorState._shared_state.clear()
        GradientState._shared_state.clear()

    num_processes = 1
    process_index = 0
    local_process_index = 0
    is_main_process = True
    is_local_main_process = True
    is_last_process = True
    use_distributed = False

    def wait_for_everyone(self) -> None:
        """A barrier across processes: nothing to wait for with one."""

    def __repr__(self) -> str:
        return (f"PartialState(num_processes=1, process_index=0, "
                f"device={self.device})")


class AcceleratorState:
    """PartialState plus the mixed-precision policy."""

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

    @property
    def initialized(self) -> bool:
        return bool(self._shared_state)

    @classmethod
    def _reset_state(cls) -> None:
        PartialState._reset_state()

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
    is a sync boundary, and the active dataloader."""

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
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        if not self.in_dataloader:
            return False
        return getattr(self.active_dataloader, "end_of_dataloader", False)

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


def is_initialized() -> bool:
    return AcceleratorState._shared_state != {}
