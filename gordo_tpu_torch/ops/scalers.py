"""Scalers as stored stats plus a pure function.

Counterpart of ``gordo_tpu/ops/scalers.py``.  A fitted scaler carries its
stats as host numpy arrays under the JAX package's keys (``STAT_KEYS``),
so ``convert.py`` carries JAX stats across unchanged; ``apply``/``invert``
are functions of ``(stats, X)`` in the reference's form.  A fitted
transform's map is ``steps(device)`` and its inverse ``inverse_steps(
device)``, each a list of ``chain_apply`` steps (K12): ``transform`` and
``inverse_transform`` run them through the kernel (its plain version for
host rows), and the serving scorer runs a ``TransformedTargetRegressor``'s
target inverse so.  Each scaler's
statistic (K3) is a kernel, on the card unless the CPU is asked for:
``MinMaxScaler`` and ``StandardScaler`` through ``scaler_stats``
(``gordo_tpu_torch/kernels/scaler_stats.py``), ``RobustScaler`` through
``scaler_quantiles`` (``gordo_tpu_torch/kernels/scaler_quantiles.py``).
:meth:`BaseTransform.stats_of` is that statistic over many machines and row
lists, each value first taken through a chain's earlier steps: the fleet
build's chain (``parallel/anomaly.py``) and ``fit`` both go through it.

The fits, the fleet scorer and the stream take a chain of the three
scalers as its steps, each ``(FORM, a, b)`` with its own stats leaves, and
apply them in turn as they load (``csrc/scaler_prefix.cuh``), as the
reference's ``_make_apply_chain`` does.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.kernels import chain_apply as ca
from gordo_tpu_torch.kernels.chain_apply import chain_apply, percentile_fractions
from gordo_tpu_torch.kernels.scaler_quantiles import scaler_quantiles, scaler_quantiles_grid
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


def rows_tensor(X, device=None) -> torch.Tensor:
    """Rows as a float32 2-D tensor: a tensor stays on its device, host
    rows go to ``device`` (:func:`gordo_tpu_torch.device.resolve_device`)."""
    if isinstance(X, torch.Tensor):
        return X.float() if X.dim() == 2 else X.float().reshape(len(X), -1)
    return torch.from_numpy(as_float2d(X)).to(resolve_device(device))


def inverse_marked(steps: Sequence[ca.Step]) -> List[ca.Step]:
    """``steps`` marked as a transform's inverse (``chain_apply`` counts
    their launches in ``inverse_launches``)."""
    return [dataclasses.replace(s, inverse=True) for s in steps]


def _through(steps_on, X):
    """``X`` through the ``chain_apply`` steps ``steps_on(device)``: a
    tensor on its device, host rows through the plain version (host
    arrays back)."""
    if isinstance(X, torch.Tensor):
        steps = steps_on(X.device)
        return chain_apply(X.float(), steps) if steps else X.float()
    x = torch.from_numpy(np.require(as_float2d(X), requirements="W"))
    steps = steps_on(x.device)
    return chain_apply(x, steps).numpy() if steps else x.numpy()


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

    @classmethod
    def _inverse_of(cls, stats: Stats, device) -> List[ca.Step]:
        """The inverse of the map with stats ``stats`` as ``chain_apply``
        steps, each rounding as the reference's eager ``invert`` (the three
        scalers: MinMax's ``(x - offset) / scale`` as CENTER, Standard's
        and Robust's ``x * scale + mean`` as AFFINE)."""
        if cls.FORM is None:
            raise NotImplementedError(f"{cls.__name__} is not invertible")
        a, b = (stats[k] for k in cls.STAT_KEYS)
        return [ca.center_step(b, a, device) if cls.FORM == AFFINE else ca.affine_step(b, a, device)]

    @classmethod
    def invert(cls, stats: Stats, X):
        """``X`` through the inverse of the map with stats ``stats``, on
        ``chain_apply`` (the reference's ``invert``)."""
        return _through(lambda device: inverse_marked(cls._inverse_of(stats, device)), X)

    def _stat_options(self) -> dict:
        """Constructor options that change the stats (the fleet signature's)."""
        return {}

    def stats_of(self, x: torch.Tensor, row_lists, prefix: Prefix = (),
                 fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two stats leaves, each (M, G, F), of each machine of ``x``
        (M, N, F) over each host row list, every value first taken through
        ``prefix`` (earlier chain steps, ``scaler_stats``'s form).
        ``fused``: round as the fleet programs' XLA fusions do, where that
        differs from the eager ``fit`` (a MinMax offset, one FMA)."""
        raise NotImplementedError(
            f"{type(self).__name__}.fit waits for {_UNPORTED_ITEM}"
        )

    def fit(self, X, y=None, device=None):
        """Stats of ``X`` (rows × features; a tensor, or host rows sent to
        ``device`` as :func:`gordo_tpu_torch.device.resolve_device`)
        through the scaler's kernel."""
        x = rows_tensor(X, device)
        leaves = self.stats_of(x[None].contiguous(), [np.arange(x.shape[0])])
        self.stats_ = {k: v[0, 0].cpu().numpy() for k, v in zip(self.STAT_KEYS, leaves)}
        return self

    def fit_transform(self, X, y=None, device=None):
        return self.fit(X, y, device=device).transform(X)

    def _check_fitted(self):
        if self.stats_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted")

    def steps(self, device) -> List[ca.Step]:
        """This fitted transform as ``chain_apply`` steps on ``device``
        (the three scalers: their map in the reference's form)."""
        self._check_fitted()
        a, b = (self.stats_[k] for k in self.STAT_KEYS)
        return [ca.affine_step(a, b, device) if self.FORM == AFFINE else ca.center_step(a, b, device)]

    def transform(self, X):
        """A tensor through ``chain_apply`` on its device, host rows
        through its plain version (host arrays back)."""
        self._check_fitted()
        return _through(self.steps, X)

    def inverse_steps(self, device) -> List[ca.Step]:
        """This fitted transform's inverse as ``chain_apply`` steps on
        ``device`` (none: the identity), marked as an inverse."""
        self._check_fitted()
        return inverse_marked(self._inverse_steps(device))

    def _inverse_steps(self, device) -> List[ca.Step]:
        return type(self)._inverse_of(self.stats_, device)

    def inverse_transform(self, X):
        """:meth:`transform`'s inverse, as :meth:`transform` runs."""
        self._check_fitted()
        return _through(self.inverse_steps, X)

    def state_arrays(self) -> Stats:
        return dict(self.stats_ or {})

    def load_state_arrays(self, state: Stats) -> "BaseTransform":
        self.stats_ = {k: np.asarray(v, np.float32) for k, v in state.items()}
        return self


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

    def stats_of(self, x, row_lists, prefix: Prefix = (), fused: bool = False):
        return scaler_stats(x, row_lists, self.feature_range, prefix=prefix, offset_fma=fused)

    @staticmethod
    def apply(stats: Stats, X):
        return X * _like(stats["scale"], X) + _like(stats["offset"], X)


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

    def stats_of(self, x, row_lists, prefix: Prefix = (), fused: bool = False):
        return scaler_stats(x, row_lists, stat="standard", with_mean=self.with_mean,
                            with_std=self.with_std, prefix=prefix)

    @staticmethod
    def apply(stats: Stats, X):
        return (X - _like(stats["mean"], X)) / _like(stats["std"], X)


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

    def stats_of(self, x, row_lists, prefix: Prefix = (), fused: bool = False):
        return scaler_quantiles(x, row_lists, self.quantile_range, self.with_centering,
                                self.with_scaling, prefix=prefix)

    @staticmethod
    def apply(stats: Stats, X):
        return (X - _like(stats["center"], X)) / _like(stats["scale"], X)


#: the scalers the port fits, builds and serves (the JAX package's
#: ``FLEETABLE_SCALERS``)
PORTED_SCALERS = (MinMaxScaler, StandardScaler, RobustScaler)


# ---------------------------------------------------------------------------
# The single-machine transforms
# ---------------------------------------------------------------------------

def _whole(x: torch.Tensor):
    """``x`` (n, F) as one machine and its one row list, the stat kernels'
    arguments."""
    return x[None].contiguous(), [np.arange(x.shape[0])]


class QuantileTransformer(BaseTransform):
    """Map features onto a uniform (or normal) distribution through a
    per-feature grid of ``n_quantiles`` percentiles (``jnp.nanpercentile``
    at ``jnp.linspace(0, 100, n_quantiles)``) and linear interpolation."""

    STAT_KEYS = ("grid",)

    @capture_args
    def __init__(self, n_quantiles: int = 100, output_distribution: str = "uniform",
                 **_sklearn_kwargs):
        super().__init__()
        _warn_ignored(type(self).__name__, _sklearn_kwargs)
        self.n_quantiles = int(n_quantiles)
        self.output_distribution = output_distribution

    def fit(self, X, y=None, device=None):
        x, rows = _whole(rows_tensor(X, device))
        q = torch.from_numpy(percentile_fractions(self.n_quantiles)).to(x.device)
        self.stats_ = {"grid": scaler_quantiles_grid(x, rows, q)[0, 0].cpu().numpy()}
        return self

    def steps(self, device):
        self._check_fitted()
        return [ca.quantile_step(self.stats_["grid"], self.output_distribution == "normal", device)]

    def _inverse_steps(self, device):
        return [ca.quantile_step(self.stats_["grid"], self.output_distribution == "normal", device,
                                 form=ca.QUANTILE_INV)]


class SimpleImputer(BaseTransform):
    """Fill NaNs with a per-feature statistic: ``jnp.nanmean``
    (``strategy="mean"``), ``jnp.nanmedian`` (``"median"``) or
    ``fill_value`` (``"constant"``)."""

    STAT_KEYS = ("fill",)

    @capture_args
    def __init__(self, strategy: str = "mean", fill_value: float = 0.0, **_sklearn_kwargs):
        super().__init__()
        _warn_ignored(type(self).__name__, _sklearn_kwargs)
        self.strategy = strategy
        self.fill_value = fill_value

    def fit(self, X, y=None, device=None):
        x, rows = _whole(rows_tensor(X, device))
        if self.strategy == "mean":
            fill = scaler_stats(x, rows, stat="nanmean")[0][0, 0]
        elif self.strategy == "median":
            half = torch.tensor([0.5], dtype=torch.float32, device=x.device)
            fill = scaler_quantiles_grid(x, rows, half, midpoint=True)[0, 0, 0]
        elif self.strategy == "constant":
            fill = torch.full((x.shape[2],), float(self.fill_value))
        else:
            raise ValueError(f"Unknown imputer strategy {self.strategy!r}")
        self.stats_ = {"fill": fill.cpu().numpy().astype(np.float32)}
        return self

    def steps(self, device):
        self._check_fitted()
        return [ca.impute_step(self.stats_["fill"], device)]

    @classmethod
    def _inverse_of(cls, stats, device):
        return []


class PCA(BaseTransform):
    """Principal component projection: ``jnp.mean`` (a NaN gives NaN) and
    the SVD of the centred rows (``torch.linalg.svd``, as K11's QR stays
    ``torch.linalg.qr``), the first ``n_components`` right singular
    vectors as ``components`` (k, F)."""

    STAT_KEYS = ("mean", "components")

    @capture_args
    def __init__(self, n_components: Optional[int] = None, **_sklearn_kwargs):
        super().__init__()
        _warn_ignored(type(self).__name__, _sklearn_kwargs)
        self.n_components = n_components

    def fit(self, X, y=None, device=None):
        x, rows = _whole(rows_tensor(X, device))
        F = int(x.shape[2])
        k = self.n_components or F
        mean = scaler_stats(x, rows, stat="mean")[0][0, 0]
        centred = chain_apply(x[0], [ca.Step(ca.CENTER, mean, torch.ones_like(mean))])
        if bool(torch.isfinite(mean).all()):
            _, _, vt = torch.linalg.svd(centred, full_matrices=False)
            components = vt[:k]
        else:  # the reference's SVD of NaN rows is NaN
            components = torch.full((min(k, F), F), float("nan"), device=x.device)
        self.stats_ = {"mean": mean.cpu().numpy(), "components": components.cpu().numpy()}
        return self

    def steps(self, device):
        self._check_fitted()
        return [ca.pca_step(self.stats_["mean"], self.stats_["components"], device)]

    @classmethod
    def _inverse_of(cls, stats, device):
        return [ca.pca_inv_step(stats["mean"], stats["components"], device)]


class FunctionTransformer(BaseTransform):
    """Apply one of ``ops.transformer_funcs`` (``multiplier``, ``adder``,
    ``log1p``, ``expm1``) as a pipeline step, a ``chain_apply`` step;
    another func raises ``NotImplementedError`` naming ROADMAP queue 1
    item 2.  The funcs are stored as dotted paths, as the JAX package
    stores them."""

    STAT_KEYS = ()

    @capture_args
    def __init__(self, func: Optional[Callable] = None, inverse_func: Optional[Callable] = None,
                 kw_args: Optional[dict] = None, inv_kw_args: Optional[dict] = None):
        from gordo_tpu_torch.ops.transformer_funcs import step_of

        super().__init__()
        self.func = func
        self.inverse_func = inverse_func
        self.kw_args = kw_args or {}
        self.inv_kw_args = inv_kw_args or {}
        # refuse an unported func now, not at the first request
        step_of(func, self.kw_args)
        step_of(inverse_func, self.inv_kw_args)
        # no stats: fitted from the start
        self.stats_ = {}

    def fit(self, X, y=None, device=None):
        self.stats_ = {}
        return self

    def steps(self, device):
        from gordo_tpu_torch.ops.transformer_funcs import step_of

        step = step_of(self.func, self.kw_args)
        return [] if step is None else [step]

    def _inverse_steps(self, device):
        from gordo_tpu_torch.ops.transformer_funcs import step_of

        step = step_of(self.inverse_func, self.inv_kw_args)
        return [] if step is None else [step]

    def get_params(self, deep: bool = False):
        params = dict(self._init_params)
        for key in ("func", "inverse_func"):
            fn = params.get(key)
            if callable(fn):
                params[key] = f"{fn.__module__}.{fn.__qualname__}"
        return params


#: every transform the port fits and serves as a pipeline step
TRANSFORMS = PORTED_SCALERS + (QuantileTransformer, SimpleImputer, PCA, FunctionTransformer)
