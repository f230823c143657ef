"""Availability checks of the optional tracker backends (the tracker half
of `accelerate_tpu/utils/imports.py`). Each asks `importlib` whether the
package could be found and imports nothing, so importing this module
pulls in no backend."""

from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache()
def _package_available(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


def is_tensorboard_available() -> bool:
    return _package_available("tensorboardX") or \
        _package_available("tensorboard")


def is_wandb_available() -> bool:
    return _package_available("wandb")


def is_mlflow_available() -> bool:
    return _package_available("mlflow")


def is_comet_ml_available() -> bool:
    return _package_available("comet_ml")


def is_aim_available() -> bool:
    return _package_available("aim")


def is_clearml_available() -> bool:
    return _package_available("clearml")


def is_dvclive_available() -> bool:
    return _package_available("dvclive")
