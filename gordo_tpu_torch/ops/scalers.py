"""Scalers as stored stats plus a pure function.

Counterpart of ``gordo_tpu/ops/scalers.py``.  A fitted scaler carries its
stats as host numpy arrays under the JAX package's keys (``STAT_KEYS``),
so ``convert.py`` carries JAX stats across unchanged; ``apply``/``invert``
are functions of ``(stats, X)`` in the reference's form.  Each scaler's
statistic (K3) is a kernel, on the card unless the CPU is asked for:
``MinMaxScaler`` and ``StandardScaler`` through ``scaler_stats``
(``gordo_tpu_torch/kernels/scaler_stats.py``), ``RobustScaler`` through
``scaler_quantiles`` (``gordo_tpu_torch/kernels/scaler_quantiles.py``).
:meth:`BaseTransform.stats_of` is that statistic over many machines and row
lists, each value first taken through a chain's earlier steps: the fleet
build's chain (``parallel/anomaly.py``) and ``fit`` both go through it.

:func:`affine` gives a fitted step's map as ``x * scale + offset``, and
:func:`fold` composes a chain's maps into one: the form the fits, the
fleet scorer and the stream take.  The fold rounds otherwise than the
reference's step-by-step ``(x - mean) / std`` (a few ulp on well-conditioned
columns).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.kernels.scaler_quantiles import scaler_quantiles
from gordo_tpu_torch.kernels.scaler_stats import AFFINE, CENTER, Prefix, scaler_stats
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args

Stats = Dict[str, np.ndarray]

_UNPORTED_ITEM = "ROADMAP queue 1 item 2 (training: the other scalers)"


def _warn_ignored(cls_name: str, kwargs: dict) -> None:
    """Sklearn kwargs this implementation does not honour are accepted, so
    reference YAML loads unchanged, with a warning naming them (the JAX
    package's ``_warn_ignored``)."""
    if kwargs:
        warnings.warn(
            f"{cls_name}: ignoring unsupported sklearn kwargs "
            f"{sorted(kwargs)} — behaviour may differ from sklearn",
            UserWarning,
            stacklevel=3,
        )


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
    """Stats + pure-function transform.

    A ported scaler names its two stats leaves (``STAT_KEYS``) and the
    ``FORM`` of its map: ``AFFINE`` applies ``x * a + b``, ``CENTER``
    ``(x - a) / b``, ``a`` and ``b`` the leaves in that order."""

    STAT_KEYS: Tuple[str, str] = ()
    FORM: Optional[int] = None

    def __init__(self):
        self.stats_: Optional[Stats] = None

    @staticmethod
    def apply(stats: Stats, X):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def invert(stats: Stats, X):
        raise NotImplementedError("transform is not invertible")

    def _stat_options(self) -> dict:
        """Constructor options that change the stats (the fleet signature's)."""
        return {}

    def stats_of(self, x: torch.Tensor, row_lists, prefix: Prefix = ()) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two stats leaves, each (M, G, F), of each machine of ``x``
        (M, N, F) over each host row list, every value first taken through
        ``prefix`` (earlier chain steps, ``scaler_stats``'s form)."""
        raise NotImplementedError(
            f"{type(self).__name__}.fit waits for {_UNPORTED_ITEM}"
        )

    def fit(self, X, y=None, device=None):
        """Stats of ``X`` (rows × features) through the scaler's kernel;
        ``device`` as :func:`gordo_tpu_torch.device.resolve_device`."""
        X = as_float2d(X)
        x = torch.from_numpy(X[None]).to(resolve_device(device))
        leaves = self.stats_of(x, [np.arange(X.shape[0])])
        self.stats_ = {k: v[0, 0].cpu().numpy() for k, v in zip(self.STAT_KEYS, leaves)}
        return self

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


def affine(cls, a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map ``x * scale + offset`` of scaler class ``cls`` with stats
    leaves ``a``, ``b`` (``cls.STAT_KEYS`` order; float32 tensors of any
    shape): MinMax's own stats, or ``1 / b`` and ``-a / b``."""
    return (a, b) if cls.FORM == AFFINE else (1.0 / b, -a / b)


def fold(maps: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """One ``(scale, offset)`` for a chain of maps applied in order, in f32:
    ``x * s1 * s2 + (o1 * s2 + o2)``; None for no map."""
    out = None
    for s, o in maps:
        s, o = s.float(), o.float()
        out = (s, o) if out is None else (out[0] * s, out[1] * s + o)
    return out


class MinMaxScaler(BaseTransform):
    """Scale features to ``feature_range`` (default [0, 1]).

    The stats are the folded affine map ``scale``/``offset``, so ``apply``
    is ``X * scale + offset`` whatever range was configured."""

    STAT_KEYS = ("scale", "offset")
    FORM = AFFINE

    @capture_args
    def __init__(self, feature_range=(0, 1), **_sklearn_kwargs):
        super().__init__()
        self.feature_range = tuple(feature_range)

    def _stat_options(self):
        return {"feature_range": self.feature_range}

    def stats_of(self, x, row_lists, prefix: Prefix = ()):
        return scaler_stats(x, row_lists, self.feature_range, prefix=prefix)

    @staticmethod
    def apply(stats: Stats, X):
        return X * _like(stats["scale"], X) + _like(stats["offset"], X)

    @staticmethod
    def invert(stats: Stats, X):
        return (X - _like(stats["offset"], X)) / _like(stats["scale"], X)


class StandardScaler(BaseTransform):
    """Zero-mean unit-variance per feature (``jnp.nanmean``, ``jnp.nanstd``
    with ddof 0, the std floored at 1e-12)."""

    STAT_KEYS = ("mean", "std")
    FORM = CENTER

    @capture_args
    def __init__(self, with_mean: bool = True, with_std: bool = True, **_sklearn_kwargs):
        super().__init__()
        _warn_ignored(type(self).__name__, _sklearn_kwargs)
        self.with_mean = with_mean
        self.with_std = with_std

    def _stat_options(self):
        return {"with_mean": self.with_mean, "with_std": self.with_std}

    def stats_of(self, x, row_lists, prefix: Prefix = ()):
        return scaler_stats(x, row_lists, stat="standard", with_mean=self.with_mean,
                            with_std=self.with_std, prefix=prefix)

    @staticmethod
    def apply(stats: Stats, X):
        return (X - _like(stats["mean"], X)) / _like(stats["std"], X)

    @staticmethod
    def invert(stats: Stats, X):
        return X * _like(stats["std"], X) + _like(stats["mean"], X)


class RobustScaler(BaseTransform):
    """Median/IQR scaling (``jnp.nanpercentile`` at ``quantile_range``,
    linear; the scale floored at 1e-12)."""

    STAT_KEYS = ("center", "scale")
    FORM = CENTER

    @capture_args
    def __init__(self, with_centering: bool = True, with_scaling: bool = True,
                 quantile_range=(25.0, 75.0), **_sklearn_kwargs):
        super().__init__()
        _warn_ignored(type(self).__name__, _sklearn_kwargs)
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = tuple(quantile_range)

    def _stat_options(self):
        return {
            "with_centering": self.with_centering,
            "with_scaling": self.with_scaling,
            "quantile_range": self.quantile_range,
        }

    def stats_of(self, x, row_lists, prefix: Prefix = ()):
        return scaler_quantiles(x, row_lists, self.quantile_range, self.with_centering,
                                self.with_scaling, prefix=prefix)

    @staticmethod
    def apply(stats: Stats, X):
        return (X - _like(stats["center"], X)) / _like(stats["scale"], X)

    @staticmethod
    def invert(stats: Stats, X):
        return X * _like(stats["scale"], X) + _like(stats["center"], X)


#: the scalers the port fits, builds and serves (the JAX package's
#: ``FLEETABLE_SCALERS``)
PORTED_SCALERS = (MinMaxScaler, StandardScaler, RobustScaler)
