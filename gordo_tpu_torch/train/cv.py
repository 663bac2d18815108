"""Cross-validation (copy of ``gordo_tpu/train/cv.py``).

Fold indices are host numpy.  :func:`cross_validate` is the generic
clone → fit → predict loop for any estimator with ``fit`` and
``predict``; the anomaly detector's own ``cross_validate`` runs its folds
through the fleet build instead (``gordo_tpu_torch/parallel/anomaly.py``)
where the fleet engine takes its definition, and through this loop
otherwise, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from gordo_tpu_torch.ops import metrics as tmetrics

METRIC_NAMES = (
    "explained_variance_score",
    "r2_score",
    "mean_squared_error",
    "mean_absolute_error",
)


class TimeSeriesSplit:
    """Expanding-window splitter (sklearn ``TimeSeriesSplit`` semantics):
    fold k trains on the first k blocks and tests on block k+1."""

    def __init__(self, n_splits: int = 3):
        if n_splits < 1:
            raise ValueError("n_splits must be >= 1")
        self.n_splits = n_splits

    def split(self, X, y=None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(X)
        if n < self.n_splits + 1:
            raise ValueError(
                f"Cannot split {n} samples into {self.n_splits} folds"
            )
        fold_size = n // (self.n_splits + 1)
        for k in range(1, self.n_splits + 1):
            train_end = fold_size * k
            test_end = fold_size * (k + 1) if k < self.n_splits else n
            yield (
                np.arange(0, train_end),
                np.arange(train_end, test_end),
            )

    def get_n_splits(self, X=None, y=None) -> int:
        return self.n_splits


class KFold:
    """Contiguous (unshuffled) K-fold."""

    def __init__(self, n_splits: int = 5):
        self.n_splits = n_splits

    def split(self, X, y=None):
        n = len(X)
        indices = np.arange(n)
        for test_idx in np.array_split(indices, self.n_splits):
            train_idx = np.setdiff1d(indices, test_idx)
            yield train_idx, test_idx

    def get_n_splits(self, X=None, y=None) -> int:
        return self.n_splits


SPLITTERS = {"TimeSeriesSplit": TimeSeriesSplit, "KFold": KFold}


def build_splitter(cv: Any) -> Any:
    """Config → splitter: dict ``{"TimeSeriesSplit": {"n_splits": 3}}``,
    a splitter instance, or None (default TimeSeriesSplit(3))."""
    if cv is None:
        return TimeSeriesSplit(3)
    if isinstance(cv, dict):
        (name, kwargs), = cv.items()
        name = name.rsplit(".", 1)[-1]
        if name not in SPLITTERS:
            raise ValueError(f"Unknown CV splitter {name!r}; available: {sorted(SPLITTERS)}")
        return SPLITTERS[name](**(kwargs or {}))
    if hasattr(cv, "split"):
        return cv
    raise ValueError(f"Cannot build CV splitter from {cv!r}")


def summarize(folds: List[Dict[str, float]], metric_names=METRIC_NAMES) -> Dict[str, Any]:
    """Per-metric ``{"folds", "mean", "std"}`` over fold scores."""
    return {
        name: {
            "folds": [f[name] for f in folds],
            "mean": float(np.mean([f[name] for f in folds])),
            "std": float(np.std([f[name] for f in folds])),
        }
        for name in metric_names
    }


def cross_validate(
    model,
    X: np.ndarray,
    y: Optional[np.ndarray] = None,
    cv: Any = None,
    metric_names: Tuple[str, ...] = METRIC_NAMES,
    predict: Optional[Callable] = None,
    **fit_kwargs,
) -> Dict[str, Any]:
    """Out-of-fold predictions + per-fold metrics.

    ``model`` must expose ``clone()`` (unfitted copy), ``fit`` and
    ``predict``; ``fit_kwargs`` (``device=...``) go to each fold's fit.
    ``predict(est, X_test, y_test)``, when given, makes a fold's
    predictions instead of ``est.predict`` (the detector scores them in
    the same launch).  Returns ``{"folds": [...], "scores": {...},
    "predictions": [(test_index, y_true_aligned, y_pred), ...]}``.
    """
    X = np.asarray(X, dtype=np.float32)
    y_arr = X if y is None else np.asarray(y, dtype=np.float32)
    splitter = build_splitter(cv)
    device = fit_kwargs.get("device")

    folds: List[Dict[str, float]] = []
    predictions = []
    for train_idx, test_idx in splitter.split(X):
        est = model.clone() if hasattr(model, "clone") else model
        est.fit(X[train_idx], y_arr[train_idx], **fit_kwargs)
        if predict is None:
            pred = np.asarray(est.predict(X[test_idx], device=device))
        else:
            pred = np.asarray(predict(est, X[test_idx], y_arr[test_idx]))
        offset = getattr(est, "offset", 0)
        y_true = y_arr[test_idx][offset:]
        folds.append({
            name: float(getattr(tmetrics, name)(y_true, pred))
            for name in metric_names
        })
        predictions.append((test_idx[offset:], y_true, pred))
    return {"folds": folds, "scores": summarize(folds, metric_names), "predictions": predictions}
