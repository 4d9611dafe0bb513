"""Calibration observers: range statistics -> activation scales.

A copy of the JAX package's ``quant/observers.py``. Statistics and
scales are Python floats, so the same batches in the same order always
give the same scales; the kernels take them as fp32 epilogue constants.
"""
from __future__ import annotations

import torch

from repro_torch.quant.core import _EPS, QMAX


def _abs_max(x) -> float:
    return float(torch.as_tensor(x).abs().max())


class AbsMaxObserver:
    """Running max|x| over every ``update``; ``scale = amax / 127`` (the
    paper's static calibration: fixed-point positions chosen offline and
    frozen for serving)."""

    def __init__(self) -> None:
        self.amax = 0.0
        self.n_updates = 0

    def update(self, x) -> None:
        self.amax = max(self.amax, _abs_max(x))
        self.n_updates += 1

    def scale(self) -> float:
        if self.n_updates == 0:
            raise ValueError("observer saw no calibration data")
        return max(self.amax, _EPS) / QMAX


class MovingAverageAbsMaxObserver(AbsMaxObserver):
    """EMA of per-batch abs-max (``momentum=0``: the last batch wins)."""

    def __init__(self, momentum: float = 0.9) -> None:
        super().__init__()
        self.momentum = momentum

    def update(self, x) -> None:
        batch_amax = _abs_max(x)
        if self.n_updates == 0:
            self.amax = batch_amax
        else:
            self.amax = (self.momentum * self.amax
                         + (1.0 - self.momentum) * batch_amax)
        self.n_updates += 1


def make_observer(kind: str = "absmax") -> AbsMaxObserver:
    if kind == "absmax":
        return AbsMaxObserver()
    if kind == "ema":
        return MovingAverageAbsMaxObserver()
    raise ValueError(f"unknown observer kind {kind!r}")
