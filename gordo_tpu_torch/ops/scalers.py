"""Scalers as stored stats plus a pure function.

Counterpart of ``gordo_tpu/ops/scalers.py``.  A fitted scaler carries its
stats as host numpy arrays; ``apply``/``invert`` are functions of
``(stats, X)`` that the serving scorer folds into the fused kernel.
``MinMaxScaler.fit`` computes its stats (K3) with the ``scaler_stats``
kernel (``gordo_tpu_torch/kernels/scaler_stats.py``), on the card unless
the CPU is asked for.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.kernels.scaler_stats import scaler_stats
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args

Stats = Dict[str, np.ndarray]


def as_float2d(X) -> np.ndarray:
    """Coerce input to a float32 2-D host array (shared shape/dtype policy)."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    if X.ndim == 1:
        X = X[:, None]
    return X


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

    def fit(self, X, y=None, device=None):
        raise NotImplementedError(
            f"{type(self).__name__}.fit waits for ROADMAP queue 1 item 2 "
            "(training: the other scalers)"
        )

    def fit_transform(self, X, y=None, device=None):
        return self.fit(X, y, device=device).transform(X)

    def transform(self, X) -> np.ndarray:
        if self.stats_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        return type(self).apply(self.stats_, as_float2d(X))

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

    def fit(self, X, y=None, device=None):
        """Stats of ``X`` (rows × features) through the ``scaler_stats``
        kernel; ``device`` as :func:`gordo_tpu_torch.device.resolve_device`."""
        X = as_float2d(X)
        x = torch.from_numpy(X[None]).to(resolve_device(device))
        scale, offset = scaler_stats(x, [np.arange(X.shape[0])], self.feature_range)
        self.stats_ = {"scale": scale[0, 0].cpu().numpy(), "offset": offset[0, 0].cpu().numpy()}
        return self

    @staticmethod
    def apply(stats: Stats, X):
        return X * _like(stats["scale"], X) + _like(stats["offset"], X)

    @staticmethod
    def invert(stats: Stats, X):
        return (X - _like(stats["offset"], X)) / _like(stats["scale"], X)
