"""Serving scorer: a request is a few hand-written kernel launches.

Counterpart of ``gordo_tpu/serve/scorer.py``.  The machine's chain is
stacked once onto the device as a bucket of one (:class:`_Stack`, which
the fleet scorer's buckets extend), and a request runs:

- a feedforward model: one ``fleet_score`` launch (pipeline scaler, dense
  stack, detector scaling, |diff|, L2 total and confidence);
- an LSTM model (mode ``ae`` or ``forecast``): one ``lstm_layer`` launch
  per layer, the first windowing and scaling the request rows as it loads,
  then ``fleet_score`` as the ``out`` head and the detector epilogue
  against the raw rows from the model's offset on; ``n - offset`` rows
  come back;
- with a detector ``window``: then one ``rolling_median`` launch, which
  smooths the tag and total scores and computes the confidence from the
  smoothed total.

A pipeline whose transform steps are all MinMax, Standard or Robust folds
them into one map that the first kernel applies as it loads.  Any other
chain (``SimpleImputer``, ``PCA``, ``QuantileTransformer``,
``FunctionTransformer`` steps, which the JAX package serves through its
fused program or the model's own path, ``gordo_tpu/serve/scorer.py:240-241,
562``) runs as one ``chain_apply`` launch over the request rows first, each
step in its own form; the model's kernels then take its output with no
fold, and the detector epilogue takes the raw rows as its targets.

The serving precision (``dtype``, :mod:`gordo_tpu_torch.serve.precision`)
is resolved when a scorer is made: at ``bfloat16`` and ``int8`` the stack
is stored in bf16 (int8: fake-quantised by ``fake_quant`` as it loads),
request rows are cast to bf16 on the host before the copy, and the
kernels' bf16 instantiations run; outputs are float32 at every dtype.

The JAX scorer pads request rows to power-of-two buckets to keep its jit
cache small; the windows and the trailing median only look back, and
nothing here compiles per shape, so the port scores exactly the rows it
is given.

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
from gordo_tpu_torch.kernels.chain_apply import chain_apply
from gordo_tpu_torch.kernels.fleet_score import fleet_score, slot_ints
from gordo_tpu_torch.kernels.lstm_layer import launch_plan, lstm_layer
from gordo_tpu_torch.kernels.rolling_median import MAX_WINDOW, rolling_median
from gordo_tpu_torch.models.estimator import AutoEncoder, LSTMAutoEncoder, LSTMForecast
from gordo_tpu_torch.ops.scalers import PORTED_SCALERS, TRANSFORMS, affine, fold
from gordo_tpu_torch.pipeline import Pipeline
from gordo_tpu_torch.serve import precision

_REQUIRE_THRESHOLDS_MESSAGE = (
    "DiffBasedAnomalyDetector.anomaly called with require_thresholds=True "
    "but cross_validate() has not been run to derive thresholds"
)


def short_rows_message(offset: int, rows: int) -> str:
    """The one short-rows client-error text (same as the JAX server's)."""
    return f"needs more than {offset} rows (lookback window), got {rows}"


def _scaler_stats(step, what: str):
    """``(class, stats leaves)`` of a fitted scaler the port serves: its
    own leaves in ``STAT_KEYS`` order, which :class:`_Stack` casts and then
    folds."""
    if not isinstance(step, PORTED_SCALERS):
        raise NotImplementedError(
            f"{what} {type(step).__name__} waits for ROADMAP queue 1 item 2 "
            "(training: the other scalers); the port serves MinMaxScaler, "
            "StandardScaler and RobustScaler"
        )
    if step.stats_ is None:
        raise RuntimeError(f"{what} {type(step).__name__} is not fitted")
    return type(step), tuple(np.asarray(step.stats_[k], np.float32) for k in step.STAT_KEYS)


def _transform_step(step):
    """A fitted pipeline step the port serves through ``chain_apply``."""
    if not isinstance(step, TRANSFORMS):
        raise NotImplementedError(
            f"pipeline step {type(step).__name__} waits for ROADMAP queue 1 item 2 "
            "(training: the other transforms and pipeline containers)"
        )
    step._check_fitted()
    return step


def _check_kernel_limits(cells, window: int) -> None:
    """Refuse, when the model loads, what the kernels cannot take: LSTM
    layers whose weights do not fit a block's shared memory, and windows
    longer than ``rolling_median``'s sorted buffers hold."""
    for i, (kernel_i, kernel_h, _) in enumerate(cells):
        try:
            launch_plan(int(kernel_i.shape[0]), int(kernel_h.shape[0]), 1)
        except ValueError as exc:  # its text names ROADMAP queue 1 item 14
            raise NotImplementedError(f"LSTM layer {i}: {exc}") from None
    if window > MAX_WINDOW:
        raise NotImplementedError(
            f"detector window of {window} rows waits for ROADMAP queue 1 item "
            f"15 (long smoothing windows): rolling_median takes at most "
            f"{MAX_WINDOW} rows"
        )


def _extract_chain(model) -> Dict[str, Any]:
    """The pure pieces of a detector/pipeline/estimator as host arrays."""
    detector = None
    base = model
    if isinstance(model, DiffBasedAnomalyDetector):
        detector = model
        base = model.base_estimator

    scalers, transforms = [], []
    if isinstance(base, Pipeline):
        steps = [step for _, step in base.steps[:-1]]
        if all(isinstance(step, PORTED_SCALERS) for step in steps):
            scalers = [_scaler_stats(step, "pipeline step") for step in steps]
        else:
            transforms = [_transform_step(step) for step in steps]
        est = base._final
    else:
        est = base
    if not isinstance(est, (AutoEncoder, LSTMAutoEncoder)):
        raise NotImplementedError(
            f"estimator {type(est).__name__} is not served by the port; it "
            "serves the feedforward AutoEncoder, LSTMAutoEncoder and LSTMForecast"
        )
    if est.module_ is None:
        raise RuntimeError(f"{type(est).__name__} is not fitted")

    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    cells, cell_acts = [], []
    if isinstance(est, LSTMAutoEncoder):
        mode = "forecast" if isinstance(est, LSTMForecast) else "ae"
        lookback = est.lookback_window
        for cell, act in est.module_.cells():
            cells.append((host(cell.kernel_i), host(cell.kernel_h), host(cell.bias)))
            cell_acts.append(act)
        dense = [(est.module_.out, est.module_.out_func)]
        n_features = int(cells[0][0].shape[0])
    else:
        mode, lookback = "none", 1
        dense = est.module_.layers()
        n_features = int(dense[0][0].weight.shape[1])
    if transforms and mode != "none":
        raise NotImplementedError(
            f"{type(est).__name__} behind SimpleImputer, PCA, QuantileTransformer or "
            "FunctionTransformer steps waits for ROADMAP queue 1 item 2"
        )
    if transforms:
        # the request's width: the first step's (a PCA's components, a
        # quantile grid's or the stats' width; funcs keep the width)
        n_features = next(
            (int(np.shape(t.stats_[t.STAT_KEYS[-1]])[-1]) for t in transforms if t.STAT_KEYS), n_features)
    chain: Dict[str, Any] = {
        "n_features": n_features,
        "mode": mode,
        "lookback": lookback,
        # rows of the request consumed before the first output row
        "offset_rows": est.offset,
        "cells": cells,
        "cell_acts": tuple(cell_acts),
        # the dense stack; an LSTM's head alone
        "layers": [(host(lin.weight).T.copy(), host(lin.bias)) for lin, _ in dense],
        "acts": tuple(act for _, act in dense),
        # each scaler's (class, stats leaves); _Stack folds them into one map
        "scalers": scalers,
        # or the fitted transform steps that chain_apply runs first
        "transforms": transforms,
        "detector": None,
    }
    if detector is not None:
        chain["detector"] = {
            "scaler": _scaler_stats(detector.scaler, "detector scaler"),
            "feature_thresholds": detector.feature_thresholds_,
            "aggregate_threshold": detector.aggregate_threshold_,
            "require_thresholds": detector.require_thresholds,
            "window": int(detector.window or 0),
        }
    _check_kernel_limits(cells, chain["detector"]["window"] if chain["detector"] else 0)
    return chain


class _Stack:
    """The chains of M structurally identical machines, stacked along a
    leading machine axis and resident on ``device`` at the storage dtype
    of serving precision ``dtype``.

    ``stacked``: a bucket of the fleet scorer.  The reference's bucket path
    stores its stacked leaves in bf16 and quantises each (int8) with one
    scale across its machines; the per-machine path quantises the float32
    leaf.  Each scaler's own stats leaves (MinMax's scale and offset,
    Standard's mean and std, Robust's center and scale) are cast
    (quantised) first, as the reference casts each leaf; then the pipeline
    chain folds into one affine map ``x * scale + offset`` and the detector
    scaler becomes one, in f32 (``ops.scalers.affine``, ``fold``), stored
    at the storage dtype (at reduced precision, one more bf16 rounding
    than the reference's where a step is not MinMax or the chain has two
    or more)."""

    def __init__(
        self,
        chains: List[Dict[str, Any]],
        device: torch.device,
        dtype: str = "float32",
        stacked: bool = False,
    ):
        self.device = device
        self.dtype = precision.canonical(dtype)
        c0 = chains[0]
        self.n_features = c0["n_features"]
        self.mode = c0["mode"]
        self.lookback = c0["lookback"]
        self.offset_rows = c0["offset_rows"]
        self.acts = c0["acts"]
        self.cell_acts = c0["cell_acts"]
        self.window = c0["detector"]["window"] if c0["detector"] else 0
        # chain_apply's steps: one machine's (a chain that does not fold
        # is never stacked)
        self.transform_steps = [st for t in c0["transforms"] for st in t.steps(device)]
        if c0["transforms"] and (len(chains) > 1 or self.dtype != "float32"):
            raise NotImplementedError(
                "a pipeline with SimpleImputer, PCA, QuantileTransformer or FunctionTransformer "
                "steps is served one machine at a time at float32; stacking and reduced "
                "precision for it wait for ROADMAP queue 1 item 2"
            )

        def put(arrays, groups=1):
            t = torch.from_numpy(np.ascontiguousarray(np.stack(arrays), np.float32)).to(device)
            if stacked:
                t = precision.cast_storage(t, self.dtype)
            return precision.cast_params(t, self.dtype, groups)

        # an LSTM cell's four gate blocks are separate leaves of the reference
        self.cells = [
            tuple(put([c["cells"][i][k] for c in chains], groups=4) for k in range(3))
            for i in range(len(c0["cells"]))
        ]
        self.layers = [
            (put([c["layers"][i][0] for c in chains]), put([c["layers"][i][1] for c in chains]))
            for i in range(len(c0["layers"]))
        ]
        def scaler_map(stats):
            """The map of one scaler of every chain, from its leaves, each
            cast first."""
            leaves = [put([s[1][k] for s in stats]).float() for k in range(2)]
            return affine(stats[0][0], *leaves)

        self.scale = self.offset = None
        folded = fold([scaler_map([c["scalers"][i] for c in chains]) for i in range(len(c0["scalers"]))])
        if folded is not None:
            self.scale, self.offset = (precision.cast_storage(t.contiguous(), self.dtype) for t in folded)
        self.det_scale = self.det_offset = self.agg_thr = None
        self.thresholds_np = self.agg_thresholds_np = None
        self.with_thresholds = False
        if c0["detector"] is not None:
            dets = [c["detector"] for c in chains]
            self.det_scale, self.det_offset = (
                precision.cast_storage(t.contiguous(), self.dtype)
                for t in scaler_map([d["scaler"] for d in dets])
            )
            self.with_thresholds = all(d["feature_thresholds"] is not None for d in dets)
            if self.with_thresholds:
                self.thresholds_np = np.stack(
                    [np.asarray(d["feature_thresholds"], np.float32) for d in dets]
                )
                self.agg_thresholds_np = np.asarray(
                    [float(d["aggregate_threshold"]) for d in dets], np.float32
                )
                self.agg_thr = torch.from_numpy(self.agg_thresholds_np).to(device)

    def resident_bytes(self) -> int:
        """Device bytes of the stacked parameters, stats and thresholds."""
        tensors = [t for cell in self.cells for t in cell]
        tensors += [t for layer in self.layers for t in layer]
        tensors += [self.scale, self.offset, self.det_scale, self.det_offset, self.agg_thr]
        tensors += [t for st in self.transform_steps for t in (st.a, st.b)]
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def put_rows(self, X: np.ndarray) -> torch.Tensor:
        """Host rows (float32) on the device at the storage dtype, cast on
        the host before the copy."""
        return precision.cast_input(torch.from_numpy(X), self.dtype).to(self.device)

    def score(
        self,
        X: np.ndarray,
        with_anomaly: bool,
        idx=None,
        n_rows=None,
        y: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """Score ``X`` (m, n, f) float32, each slot's first ``n_rows``
        rows (default all; each more than the offset); host outputs of
        ``n - offset`` rows per slot, valid up to ``n_rows - offset``."""
        targets = None if y is None else self.put_rows(y)
        out = self.run(self.put_rows(X), with_anomaly, idx, n_rows, targets)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def run(
        self,
        x: torch.Tensor,
        with_anomaly: bool,
        idx=None,
        n_rows=None,
        targets: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """:meth:`score` on tensors already on the device: the kernel
        launches alone."""
        off = self.offset_rows
        # every kernel of the request reads the same slot indices and
        # counts: checked and copied to the device once
        n_out = int(x.shape[1]) - off
        machines = int(self.layers[0][0].shape[0])
        if idx is not None:
            idx = slot_ints(idx, "idx", 0, machines - 1, self.device)
        rows = None
        if n_rows is not None:
            rows = slot_ints([int(r) - off for r in n_rows], "n_rows - offset", 1, n_out, self.device)
        kw: Dict[str, Any] = dict(idx=idx, n_rows=rows)
        with torch.no_grad():
            h = x
            if self.transform_steps:
                h = chain_apply(x, self.transform_steps)
                if targets is None:
                    targets = x
            if self.mode == "none":
                kw.update(scale=self.scale, offset=self.offset)
            else:
                for i, ((ki, kh, b), act) in enumerate(zip(self.cells, self.cell_acts)):
                    first = i == 0
                    h = lstm_layer(
                        h, ki, kh, b, lookback=self.lookback, act=act,
                        n_windows=x.shape[1] - off if first else None,
                        scale=self.scale if first else None,
                        offset=self.offset if first else None,
                        idx=idx, slot_windows=rows, last=i == len(self.cells) - 1,
                    )
                if targets is None:
                    targets = x
            if with_anomaly:
                kw.update(
                    det_scale=self.det_scale,
                    det_offset=self.det_offset,
                    # with a window, the confidence comes from the smoothed total
                    agg_thr=None if self.window else self.agg_thr,
                    y=targets,
                    y_offset=off,
                )
            out = fleet_score(h, self.layers, self.acts, **kw)
            if with_anomaly and self.window:
                out.update(rolling_median(
                    out["tag-anomaly-scores"], out["total-anomaly-score"], self.window,
                    agg_thr=self.agg_thr, idx=idx, n_rows=rows,
                ))
        return out


class CompiledScorer:
    """Scoring surface over one model, through the serving kernels.

    ``device``: where the chain lives and the kernel runs; ``None`` is the
    current CUDA device and raises without CUDA (``"cpu"`` runs the
    kernel's plain twin).  ``machine``: the machine name it serves, when
    known.  ``dtype``: the serving precision (``None`` resolves
    ``GORDO_SERVE_DTYPE`` now; collections pass theirs, so that a fleet
    serves at one precision).
    """

    def __init__(self, model, device=None, machine: Optional[str] = None,
                 dtype: Optional[str] = None):
        self.model = model
        self.device = resolve_device(device)
        self.dtype = precision.resolve(dtype)
        self.chain = _extract_chain(model)
        self.is_anomaly = isinstance(model, AnomalyDetectorBase)
        self.offset = getattr(model, "offset", 0)
        self.machine = machine
        self._stack = _Stack([self.chain], self.device, self.dtype)

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
