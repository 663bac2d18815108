"""Diff-based anomaly detection, serving half.

Counterpart of ``gordo_tpu/anomaly/diff.py::DiffBasedAnomalyDetector``: a
base estimator (usually ``Pipeline[MinMaxScaler, AutoEncoder]``), a
detector scaler applied to targets and predictions, per-tag
``feature_thresholds_`` and an ``aggregate_threshold_``.  The scoring math
(scaled |diff|, L2 total over tags, confidence) runs in the fused
``fleet_score`` kernel and its plain twin
(``gordo_tpu_torch/kernels/fleet_score.py``).  Deriving thresholds by
cross-validation (K4) belongs to the training slice, ROADMAP queue 1
item 2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from gordo_tpu_torch.anomaly.base import AnomalyDetectorBase
from gordo_tpu_torch.ops.scalers import BaseTransform, MinMaxScaler
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

    @property
    def offset(self) -> int:
        return getattr(self.base_estimator, "offset", 0)

    def fit(self, X, y=None, **kwargs):
        raise NotImplementedError(
            "DiffBasedAnomalyDetector.fit waits for ROADMAP queue 1 item 2 "
            "(training)"
        )

    def cross_validate(self, X, y=None, cv=None):
        raise NotImplementedError(
            "DiffBasedAnomalyDetector.cross_validate waits for ROADMAP queue 1 "
            "item 2 (training: K4 thresholds and CV metrics)"
        )

    def predict(self, X, device=None) -> np.ndarray:
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).predict(X)

    def anomaly(self, X, y=None, device=None) -> Dict[str, np.ndarray]:
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).anomaly_arrays(X, y)

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
