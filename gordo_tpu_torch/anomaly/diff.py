"""Diff-based anomaly detection.

Counterpart of ``gordo_tpu/anomaly/diff.py::DiffBasedAnomalyDetector``: a
base estimator (usually ``Pipeline[MinMaxScaler, AutoEncoder]``), a
detector scaler applied to targets and predictions, per-tag
``feature_thresholds_`` and an ``aggregate_threshold_``.  The scoring math
(scaled |diff|, L2 total over tags, confidence) runs in the fused
``fleet_score`` kernel and its plain twin
(``gordo_tpu_torch/kernels/fleet_score.py``); with ``window`` set, the tag
and total scores are smoothed by a trailing rolling median of ``window``
rows (``min_periods=1``) and the confidence taken from the smoothed total,
in the ``rolling_median`` kernel (``gordo_tpu_torch/kernels/
rolling_median.py``), as ``gordo_tpu/anomaly/diff.py:143-160`` smooths
them with pandas.  ``cross_validate`` derives
the thresholds through the exact fleet build with one machine
(``gordo_tpu_torch/parallel/anomaly.py``): fold fits in ``fleet_fit``,
out-of-fold scoring in ``fleet_score``, smoothed maxima and metrics in
``cv_epilogue``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.anomaly.base import AnomalyDetectorBase
from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.models.estimator import LSTMAutoEncoder
from gordo_tpu_torch.ops.scalers import BaseTransform, MinMaxScaler, as_float2d
from gordo_tpu_torch.parallel.fleet import Draws, fleet_draws
from gordo_tpu_torch.train.cv import METRIC_NAMES, build_splitter
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args


class DiffBasedAnomalyDetector(ParamsMixin, AnomalyDetectorBase):
    @capture_args
    def __init__(
        self,
        base_estimator: Any = None,
        scaler: Optional[BaseTransform] = None,
        require_thresholds: bool = True,
        window: Optional[int] = None,
    ):
        if base_estimator is None:
            from gordo_tpu_torch.models.estimator import AutoEncoder
            from gordo_tpu_torch.pipeline import Pipeline

            base_estimator = Pipeline([MinMaxScaler(), AutoEncoder()])
        self.base_estimator = base_estimator
        self.scaler = scaler if scaler is not None else MinMaxScaler()
        self.require_thresholds = require_thresholds
        self.window = window
        self.feature_thresholds_: Optional[np.ndarray] = None
        self.aggregate_threshold_: Optional[float] = None
        self.cv_metadata_: Dict[str, Any] = {}

    @property
    def offset(self) -> int:
        return getattr(self.base_estimator, "offset", 0)

    def fit(self, X, y=None, device=None, **kwargs):
        """Fit the detector scaler on ``y`` (default ``X``), then the base
        estimator on ``X`` against ``y``."""
        X_arr = as_float2d(X)
        y_arr = X_arr if y is None else as_float2d(y)
        self.scaler.fit(y_arr, device=device)
        self.base_estimator.fit(X_arr, y_arr, device=device, **kwargs)
        return self

    def cross_validate(self, X, y=None, cv=None, device=None, draws: Draws = fleet_draws) -> Dict[str, Any]:
        """Fold-wise fit/predict; derives thresholds from out-of-fold errors.

        Per fold, the detector-scaled absolute error per tag is smoothed
        (rolling min over 6 rows) and its maximum taken; the fold maxima's
        mean is ``feature_thresholds_``, the same on the L2 total
        ``aggregate_threshold_``.  Runs as the exact fleet build of one
        machine.  Returns ``{"folds", "scores", "predictions":
        [(test_index, y_true, y_pred), ...]}``."""
        from gordo_tpu_torch.parallel.anomaly import (
            analyze_definition,
            exact_fleet_program,
            scores_summary,
        )

        X_arr = as_float2d(X)
        y_arr = X_arr if y is None else as_float2d(y)
        dev = resolve_device(device)
        spec = analyze_definition(self.clone())
        if spec is None and isinstance(getattr(self.base_estimator, "_final", self.base_estimator),
                                       LSTMAutoEncoder):
            raise NotImplementedError(
                "cross_validate of an LSTM detector waits for ROADMAP queue 1 item 5 "
                "(LSTM training, K6 backward)"
            )
        if spec is None:
            raise NotImplementedError(
                f"cross_validate of {type(self.base_estimator).__name__} waits for "
                "ROADMAP queue 1 item 2 (the other scalers and pipeline containers)"
            )
        self.scaler.fit(y_arr, device=dev)
        folds = list(build_splitter(cv).split(X_arr))
        with torch.no_grad():
            out = exact_fleet_program(
                spec, torch.from_numpy(X_arr[None]).to(dev),
                torch.from_numpy(y_arr[None]).to(dev), folds, final=False, draws=draws,
            )
        metrics = {name: v.cpu().numpy() for name, v in out["metrics"].items()}
        scores = scores_summary(metrics)[0]
        self.feature_thresholds_ = out["feature_thresholds"][0].cpu().numpy()
        self.aggregate_threshold_ = float(out["aggregate_threshold"][0])
        self.cv_metadata_ = {
            "scores": scores,
            "feature_thresholds": [float(v) for v in self.feature_thresholds_],
            "aggregate_threshold": self.aggregate_threshold_,
        }
        preds = out["predictions"][0].cpu().numpy()
        return {
            "folds": [
                {name: float(metrics[name][0, k]) for name in METRIC_NAMES}
                for k in range(len(folds))
            ],
            "scores": scores,
            "predictions": [
                (te, y_arr[te], preds[k, : len(te)]) for k, te in enumerate(out["test_rows"])
            ],
        }

    def predict(self, X, device=None) -> np.ndarray:
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).predict(X)

    def anomaly(self, X, y=None, device=None) -> Dict[str, np.ndarray]:
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).anomaly_arrays(X, y)

    def get_metadata(self) -> Dict[str, Any]:
        meta = {
            "anomaly_detector": type(self).__name__,
            "scaler": type(self.scaler).__name__,
            "require_thresholds": self.require_thresholds,
        }
        if self.cv_metadata_:
            meta["cross_validation"] = self.cv_metadata_
        if hasattr(self.base_estimator, "get_metadata"):
            meta["base_estimator"] = self.base_estimator.get_metadata()
        return meta

    # -- fitted state ---------------------------------------------------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        out = {
            f"base_estimator.{k}": v
            for k, v in self.base_estimator.state_arrays().items()
        }
        out.update({f"scaler.{k}": v for k, v in self.scaler.state_arrays().items()})
        if self.feature_thresholds_ is not None:
            out["feature_thresholds"] = np.asarray(self.feature_thresholds_, np.float32)
        if self.aggregate_threshold_ is not None:
            out["aggregate_threshold"] = np.asarray(self.aggregate_threshold_, np.float64)
        return out

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> "DiffBasedAnomalyDetector":
        def sub(prefix):
            return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

        self.base_estimator.load_state_arrays(sub("base_estimator."))
        scaler_state = sub("scaler.")
        if scaler_state:
            self.scaler.load_state_arrays(scaler_state)
        if "feature_thresholds" in state:
            self.feature_thresholds_ = np.asarray(state["feature_thresholds"], np.float32)
        if "aggregate_threshold" in state:
            self.aggregate_threshold_ = float(state["aggregate_threshold"])
        return self
