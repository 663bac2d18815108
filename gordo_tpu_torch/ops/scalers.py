"""Scalers as stored stats plus a pure function.

Counterpart of ``gordo_tpu/ops/scalers.py``.  A fitted scaler carries its
stats as host numpy arrays; ``apply``/``invert`` are functions of
``(stats, X)`` that the serving scorer folds into the fused kernel.
Fitting stats (K3) belongs to the training slice, ROADMAP queue 1 item 2.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.utils.args import ParamsMixin, capture_args

Stats = Dict[str, np.ndarray]


def _like(stat, X):
    if isinstance(X, torch.Tensor):
        return torch.as_tensor(stat, dtype=X.dtype, device=X.device)
    return np.asarray(stat, dtype=np.float32)


class BaseTransform(ParamsMixin):
    """Stats + pure-function transform."""

    def __init__(self):
        self.stats_: Optional[Stats] = None

    @staticmethod
    def apply(stats: Stats, X):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def invert(stats: Stats, X):
        raise NotImplementedError("transform is not invertible")

    def fit(self, X, y=None):
        raise NotImplementedError(
            f"{type(self).__name__}.fit waits for ROADMAP queue 1 item 2 "
            "(training: K3 scaler stats)"
        )

    def state_arrays(self) -> Stats:
        return dict(self.stats_ or {})

    def load_state_arrays(self, state: Stats) -> "BaseTransform":
        self.stats_ = {k: np.asarray(v, np.float32) for k, v in state.items()}
        return self


class MinMaxScaler(BaseTransform):
    """Scale features to ``feature_range`` (default [0, 1]).

    The stats are the folded affine map ``scale``/``offset``, so ``apply``
    is ``X * scale + offset`` whatever range was configured."""

    @capture_args
    def __init__(self, feature_range=(0, 1), **_sklearn_kwargs):
        super().__init__()
        self.feature_range = tuple(feature_range)

    @staticmethod
    def apply(stats: Stats, X):
        return X * _like(stats["scale"], X) + _like(stats["offset"], X)

    @staticmethod
    def invert(stats: Stats, X):
        return (X - _like(stats["offset"], X)) / _like(stats["scale"], X)
