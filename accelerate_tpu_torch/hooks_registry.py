"""Removable hook handles for `Accelerator.register_save_state_pre_hook`
and `register_load_state_pre_hook` (a copy of
`accelerate_tpu/hooks_registry.py`)."""

from __future__ import annotations

import itertools

_counter = itertools.count()


class RemovableHandle:
    def __init__(self, hooks_dict: dict):
        self.hooks_dict = hooks_dict
        self.id = next(_counter)

    def remove(self) -> None:
        self.hooks_dict.pop(self.id, None)

    def __enter__(self) -> "RemovableHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.remove()
