"""Tiny deterministic workloads (port of
`accelerate_tpu/test_utils/training.py`): y = 2x + 1 (+ noise) drawn
from a seed with numpy, and a one-weight, one-bias regression whose
convergence and cross-process equality are exact and fast to assert."""

from __future__ import annotations

import numpy as np
import torch


class RegressionDataset:
    def __init__(self, a: float = 2.0, b: float = 1.0, length: int = 64,
                 seed: int = 42) -> None:
        rng = np.random.default_rng(seed)
        self.length = length
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b
                  + rng.normal(scale=0.1, size=(length,))).astype(np.float32)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        return {"x": self.x[i], "y": self.y[i]}


def regression_params(a: float = 0.0, b: float = 0.0, device=None) -> dict:
    """{"a", "b"} as f32 scalars on `device` (default: the process's)."""
    if device is None:
        from ..state import PartialState

        device = PartialState().device
    return {"a": torch.tensor(a, dtype=torch.float32, device=device),
            "b": torch.tensor(b, dtype=torch.float32, device=device)}


def regression_forward(params: dict, x):
    return params["a"] * x + params["b"]


def regression_loss(params: dict, batch: dict):
    pred = regression_forward(params, batch["x"])
    return ((pred - batch["y"]) ** 2).mean()
