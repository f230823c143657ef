"""Logging that knows the process it runs on (port of
`accelerate_tpu/logging.py`).

`get_logger(name)` returns a `MultiProcessAdapter`: a record logs on the
main process only unless `main_process_only=False`, and `in_order=True`
logs rank by rank. One process is a world of one: it is the main
process, and `in_order` logs its record as rank 0; across processes
`in_order` raises until the parallelism slice (queue 1 item 6). The
level is an argument (`log_level`); the port reads no environment
variable for it.
"""

from __future__ import annotations

import functools
import logging

from .state import PartialState, _one_process


class MultiProcessAdapter(logging.LoggerAdapter):
    """A logger adapter that emits on the main process unless asked
    otherwise (`main_process_only=False`); `in_order=True` emits rank by
    rank, each record prefixed with its rank."""

    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        return not main_process_only or PartialState.is_main_process

    def log(self, level, msg, *args, **kwargs):
        if not self.isEnabledFor(level):
            return
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)
        if in_order:
            _one_process("log(in_order=True)")
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, f"[rank {PartialState.process_index}] "
                            f"{msg}", *args, **kwargs)
            return
        if self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        """`warning`, once per distinct arguments."""
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """The named logger behind a `MultiProcessAdapter`; `log_level` (e.g.
    "INFO") sets its level and the root logger's."""
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
