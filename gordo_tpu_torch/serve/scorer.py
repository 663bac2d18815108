"""Fused serving scorer: one ``fleet_score`` launch per request.

Counterpart of ``gordo_tpu/serve/scorer.py``.  The whole scoring chain —
pipeline scaler, dense stack, detector scaling, |diff|, L2 total and
confidence — runs in one launch of the hand-written ``fleet_score``
kernel over the machine's chain, stacked once onto the device as a bucket
of one (:class:`_Stack`, which the fleet scorer's buckets extend).

The JAX scorer pads request rows to power-of-two buckets to keep its jit
cache small; rows are independent in the feedforward chain and nothing
here compiles per shape, so the port scores exactly the rows it is given.

Chains the slice does not take raise ``NotImplementedError`` naming the
ROADMAP item they wait for; nothing is scored another way.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gordo_tpu_torch.anomaly.base import AnomalyDetectorBase
from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.kernels.fleet_score import fleet_score
from gordo_tpu_torch.models.estimator import AutoEncoder
from gordo_tpu_torch.ops.scalers import MinMaxScaler
from gordo_tpu_torch.pipeline import Pipeline

_REQUIRE_THRESHOLDS_MESSAGE = (
    "DiffBasedAnomalyDetector.anomaly called with require_thresholds=True "
    "but cross_validate() has not been run to derive thresholds"
)


def short_rows_message(offset: int, rows: int) -> str:
    """The one short-rows client-error text (same as the JAX server's)."""
    return f"needs more than {offset} rows (lookback window), got {rows}"


def _minmax_stats(step, what: str):
    if not isinstance(step, MinMaxScaler):
        raise NotImplementedError(
            f"{what} {type(step).__name__} waits for ROADMAP queue 1 item 2 "
            "(training: the other scalers); the port serves MinMaxScaler"
        )
    if step.stats_ is None:
        raise RuntimeError(f"{what} {type(step).__name__} is not fitted")
    return (
        np.asarray(step.stats_["scale"], np.float32),
        np.asarray(step.stats_["offset"], np.float32),
    )


def _extract_chain(model) -> Dict[str, Any]:
    """The pure pieces of a detector/pipeline/estimator as host arrays."""
    detector = None
    base = model
    if isinstance(model, DiffBasedAnomalyDetector):
        detector = model
        base = model.base_estimator

    scale = offset = None
    if isinstance(base, Pipeline):
        for _, step in base.steps[:-1]:
            s, o = _minmax_stats(step, "pipeline step")
            # consecutive affine maps fold into one
            scale, offset = (s, o) if scale is None else (scale * s, offset * s + o)
        est = base._final
    else:
        est = base
    if not isinstance(est, AutoEncoder):
        raise NotImplementedError(
            f"estimator {type(est).__name__} waits for ROADMAP queue 1 item 5 "
            "(the LSTM path); the port serves the feedforward AutoEncoder"
        )
    if est.module_ is None:
        raise RuntimeError(f"{type(est).__name__} is not fitted")

    layers, acts = [], []
    for linear, act in est.module_.layers():
        layers.append((
            linear.weight.detach().cpu().numpy().T.astype(np.float32),
            linear.bias.detach().cpu().numpy().astype(np.float32),
        ))
        acts.append(act)
    chain: Dict[str, Any] = {
        "n_features": int(layers[0][0].shape[0]),
        "layers": layers,
        "acts": tuple(acts),
        "scale": scale,
        "offset": offset,
        "detector": None,
    }
    if detector is not None:
        if detector.window:
            raise NotImplementedError(
                f"detector window={detector.window} (rolling median, K7) waits "
                "for ROADMAP queue 1 item 5 (the LSTM path, K6/K7)"
            )
        ds, do = _minmax_stats(detector.scaler, "detector scaler")
        chain["detector"] = {
            "scale": ds,
            "offset": do,
            "feature_thresholds": detector.feature_thresholds_,
            "aggregate_threshold": detector.aggregate_threshold_,
            "require_thresholds": detector.require_thresholds,
        }
    return chain


class _Stack:
    """The chains of M structurally identical machines, stacked along a
    leading machine axis and resident on ``device``."""

    def __init__(self, chains: List[Dict[str, Any]], device: torch.device):
        self.device = device
        c0 = chains[0]
        self.n_features = c0["n_features"]
        self.acts = c0["acts"]

        def put(arrays):
            return torch.from_numpy(np.ascontiguousarray(np.stack(arrays), np.float32)).to(device)

        self.layers = [
            (put([c["layers"][i][0] for c in chains]), put([c["layers"][i][1] for c in chains]))
            for i in range(len(c0["layers"]))
        ]
        self.scale = self.offset = None
        if c0["scale"] is not None:
            self.scale = put([c["scale"] for c in chains])
            self.offset = put([c["offset"] for c in chains])
        self.det_scale = self.det_offset = self.agg_thr = None
        self.thresholds_np = self.agg_thresholds_np = None
        self.with_thresholds = False
        if c0["detector"] is not None:
            dets = [c["detector"] for c in chains]
            self.det_scale = put([d["scale"] for d in dets])
            self.det_offset = put([d["offset"] for d in dets])
            self.with_thresholds = all(d["feature_thresholds"] is not None for d in dets)
            if self.with_thresholds:
                self.thresholds_np = np.stack(
                    [np.asarray(d["feature_thresholds"], np.float32) for d in dets]
                )
                self.agg_thresholds_np = np.asarray(
                    [float(d["aggregate_threshold"]) for d in dets], np.float32
                )
                self.agg_thr = torch.from_numpy(self.agg_thresholds_np).to(device)

    def score(
        self,
        X: np.ndarray,
        with_anomaly: bool,
        idx=None,
        n_rows=None,
        y: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """One kernel launch over ``X`` (m, n, f) float32; host outputs."""
        kw: Dict[str, Any] = dict(
            scale=self.scale, offset=self.offset, idx=idx, n_rows=n_rows
        )
        if with_anomaly:
            kw.update(
                det_scale=self.det_scale,
                det_offset=self.det_offset,
                agg_thr=self.agg_thr,
                y=None if y is None else torch.from_numpy(y).to(self.device),
            )
        with torch.no_grad():
            out = fleet_score(
                torch.from_numpy(X).to(self.device), self.layers, self.acts, **kw
            )
        return {k: v.cpu().numpy() for k, v in out.items()}


class CompiledScorer:
    """Scoring surface over one model, through the fused kernel.

    ``device``: where the chain lives and the kernel runs; ``None`` is the
    current CUDA device and raises without CUDA (``"cpu"`` runs the
    kernel's plain twin).  ``machine``: the machine name it serves, when
    known.
    """

    def __init__(self, model, device=None, machine: Optional[str] = None):
        self.model = model
        self.device = resolve_device(device)
        self.chain = _extract_chain(model)
        self.is_anomaly = isinstance(model, AnomalyDetectorBase)
        self.offset = getattr(model, "offset", 0)
        self.machine = machine
        self._stack = _Stack([self.chain], self.device)

    def _rows(self, X, name: str = "X") -> np.ndarray:
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"{name} must be 2-dimensional, got shape {X.shape}")
        if X.shape[0] <= self.offset:
            raise ValueError(short_rows_message(self.offset, X.shape[0]))
        if X.shape[1] != self.chain["n_features"]:
            raise ValueError(
                f"{name} has {X.shape[1]} columns; model expects "
                f"{self.chain['n_features']}"
            )
        return X

    def predict(self, X) -> np.ndarray:
        X = self._rows(X)
        return self._stack.score(X[None], with_anomaly=False)["model-output"][0]

    def anomaly_arrays(self, X, y=None) -> Dict[str, Any]:
        """Anomaly scoring as plain arrays."""
        if not self.is_anomaly:
            raise TypeError(f"{type(self.model).__name__} is not an anomaly detector")
        X = self._rows(X)
        det = self.chain["detector"]
        if det["feature_thresholds"] is None and det["require_thresholds"]:
            # same contract as DiffBasedAnomalyDetector.anomaly: refuse to
            # emit unthresholded scores
            raise AttributeError(_REQUIRE_THRESHOLDS_MESSAGE)
        Y = None
        if y is not None:
            Y = self._rows(y, "y")
            if Y.shape != X.shape:
                raise ValueError(f"y has shape {Y.shape}; X has {X.shape}")
            Y = Y[None]
        out = self._stack.score(X[None], with_anomaly=True, y=Y)
        result: Dict[str, Any] = {
            "model-output": out["model-output"][0],
            "tag-anomaly-scores": out["tag-anomaly-scores"][0],
            "total-anomaly-score": out["total-anomaly-score"][0],
        }
        if self._stack.with_thresholds:
            result["tag-anomaly-thresholds"] = np.asarray(det["feature_thresholds"])
            result["total-anomaly-threshold"] = float(det["aggregate_threshold"])
            result["anomaly-confidence"] = out["anomaly-confidence"][0]
        return result
