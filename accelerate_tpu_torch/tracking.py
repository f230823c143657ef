"""Experiment trackers (port of `accelerate_tpu/tracking.py`).

A `GeneralTracker` base with `@on_main_process`-gated methods, the
dependency-free `JSONLTracker` (one JSON object per line: a "config"
line, then one "log" line per call), and the TensorBoard, WandB, MLflow,
Comet, Aim, ClearML and DVCLive backends, each importing its package
only when it is constructed. `filter_trackers` resolves names, "all" and
instances into live trackers, skipping a backend whose package is
missing with a warning.

A `log()` of 0-d CUDA tensors (a step's loss, its grad norm) moves them
to the host in one transfer per dtype (`torch.stack`, then one
`.cpu()`), not one blocking `.item()` per metric.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Any

import torch

from .logging import get_logger
from .state import PartialState
from .utils.dataclasses import LoggerType
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_tensorboard_available,
    is_wandb_available,
)

logger = get_logger(__name__)


def _scalarize(v):
    """A 0-d tensor or numpy value as a Python scalar, so the scalar
    filters below accept the metrics a loop produces."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v


def _scalarize_all(values: dict) -> dict:
    """A metrics dict with every 0-d device tensor moved to the host in
    one transfer per (device, dtype): the tensors are stacked on the card
    and copied once, where one `.item()` each would wait on the card once
    per metric. Host values go through `_scalarize`."""
    groups: dict = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor) and v.ndim == 0 and \
                v.device.type != "cpu":
            groups.setdefault((v.device, v.dtype), []).append(k)
    if groups:
        values = dict(values)
        for keys in groups.values():
            host = torch.stack([values[k].detach() for k in keys]).cpu()
            values.update(zip(keys, host.tolist()))
    return {k: _scalarize(v) for k, v in values.items()}


def on_main_process(function):
    """Run the method on the main process only (unless the tracker sets
    `main_process_only = False`); elsewhere it returns None."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True) and \
                not PartialState.is_main_process:
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """A tracker's interface: subclass with `name` and
    `requires_logging_directory`, and implement
    `store_init_configuration` and `log`."""

    name: str = "generic"
    requires_logging_directory: bool = False
    main_process_only: bool = True

    def __init__(self, run_name: str | None = None, **kwargs: Any):
        self.run_name = run_name

    @property
    def tracker(self):
        return None

    def store_init_configuration(self, values: dict) -> None:
        raise NotImplementedError

    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        raise NotImplementedError

    def log_images(self, values: dict, step: int | None = None,
                   **kwargs) -> None:
        pass

    def finish(self) -> None:
        pass


class JSONLTracker(GeneralTracker):
    """One JSON object per line in `<logging_dir>/<run_name>/metrics.jsonl`:
    `{"event": "config", "config": ...}`, then `{"event": "log", "step":
    ..., "ts": ..., **values}` per call."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = None,
                 **kwargs):
        super().__init__(run_name)
        logging_dir = logging_dir or "."
        os.makedirs(os.path.join(logging_dir, run_name), exist_ok=True)
        self.path = os.path.join(logging_dir, run_name, "metrics.jsonl")
        self._fh = open(self.path, "a")

    @property
    def tracker(self):
        return self._fh

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._write({"event": "config", "config": _jsonable(values)})

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        # the top-level device scalars cross in one transfer; _jsonable
        # still converts stragglers in nested containers
        self._write({"event": "log", "step": step, "ts": time.time(),
                     **_jsonable(_scalarize_all(values))})

    def _write(self, obj: dict) -> None:
        self._fh.write(json.dumps(obj) + "\n")
        self._fh.flush()

    @on_main_process
    def finish(self) -> None:
        self._fh.close()


class TensorBoardTracker(GeneralTracker):
    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = None,
                 **kwargs):
        super().__init__(run_name)
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard

        self.logging_dir = os.path.join(logging_dir or ".", run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.writer.add_hparams(_flatten_scalars(values), metric_dict={})
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        for k, v in _scalarize_all(values).items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self) -> None:
        self.writer.close()


class WandBTracker(GeneralTracker):
    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        import wandb

        self.run = wandb.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        self.run.finish()


class MLflowTracker(GeneralTracker):
    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = None,
                 **kwargs):
        super().__init__(run_name)
        import mlflow

        mlflow.set_experiment(run_name)
        self.run = mlflow.start_run(**kwargs)
        self._mlflow = mlflow

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        for k, v in _flatten_scalars(values).items():
            self._mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        metrics = {
            k: v for k, v in _scalarize_all(values).items()
            if isinstance(v, (int, float))
        }
        self._mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self) -> None:
        self._mlflow.end_run()


class CometMLTracker(GeneralTracker):
    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        from comet_ml import Experiment

        self.writer = Experiment(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        if step is not None:
            self.writer.set_step(step)
        self.writer.log_metrics(values, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        self.writer.end()


class AimTracker(GeneralTracker):
    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = None,
                 **kwargs):
        super().__init__(run_name)
        from aim import Run

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        self.writer.close()


class ClearMLTracker(GeneralTracker):
    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        from clearml import Task

        self.task = Task.init(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        logger_obj = self.task.get_logger()
        for k, v in _scalarize_all(values).items():
            if isinstance(v, (int, float)):
                logger_obj.report_scalar(title=k, series=k, value=v,
                                         iteration=step or 0)

    @on_main_process
    def finish(self) -> None:
        self.task.close()


class DVCLiveTracker(GeneralTracker):
    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, live=None, **kwargs):
        super().__init__(run_name)
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs) -> None:
        if step is not None:
            self.live.step = step
        for k, v in _scalarize_all(values).items():
            if isinstance(v, (int, float)):
                self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self) -> None:
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "jsonl": JSONLTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
}

_AVAILABILITY = {
    "jsonl": lambda: True,
    "tensorboard": is_tensorboard_available,
    "wandb": is_wandb_available,
    "mlflow": is_mlflow_available,
    "comet_ml": is_comet_ml_available,
    "aim": is_aim_available,
    "clearml": is_clearml_available,
    "dvclive": is_dvclive_available,
}


def filter_trackers(
    log_with: list,
    logging_dir: str | None = None,
    run_name: str = "accelerate_tpu",
    init_kwargs: dict | None = None,
) -> list[GeneralTracker]:
    """Live trackers for `log_with`'s names ("all": every available
    backend), `LoggerType`s and instances (passed through). A name that
    is no `LoggerType` raises; a backend whose package is missing is
    skipped with a warning. `init_kwargs[name]` goes to that backend."""
    init_kwargs = init_kwargs or {}
    names: list = []
    for entry in log_with or []:
        if isinstance(entry, GeneralTracker):
            names.append(entry)
        else:
            value = str(LoggerType(str(entry).lower())
                        if not isinstance(entry, LoggerType) else entry)
            if value == "all":
                names.extend(n for n in LOGGER_TYPE_TO_CLASS
                             if _AVAILABILITY[n]())
            else:
                names.append(value)
    trackers: list[GeneralTracker] = []
    seen = set()
    for entry in names:
        if isinstance(entry, GeneralTracker):
            trackers.append(entry)
            continue
        if entry in seen:
            continue
        seen.add(entry)
        cls = LOGGER_TYPE_TO_CLASS.get(entry)
        if cls is None or not _AVAILABILITY[entry]():
            logger.warning(f"Tracker {entry} unavailable; skipping")
            continue
        kwargs = dict(init_kwargs.get(entry, {}))
        if cls.requires_logging_directory:
            kwargs.setdefault("logging_dir", logging_dir)
        trackers.append(cls(run_name, **kwargs))
    return trackers


def _jsonable(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    if hasattr(tree, "item") and getattr(tree, "ndim", 1) == 0:
        return tree.item()
    if isinstance(tree, (int, float, str, bool, type(None))):
        return tree
    return str(tree)


def _flatten_scalars(values: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in values.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten_scalars(v, key))
        elif isinstance(v, (int, float, str, bool)):
            out[key] = v
        else:
            out[key] = str(v)
    return out
