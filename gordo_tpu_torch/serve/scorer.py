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

A pipeline whose transform steps are all MinMax, Standard or Robust hands
them to the first kernel, which applies them in turn as it loads, each
step in its own form (``csrc/scaler_prefix.cuh``); the detector scaler is
one such step, on the prediction and the target.  Any other
chain runs as one ``chain_apply`` launch over the request rows first, each
step in its own form; the model's kernels then take its output with no
scaler step (an LSTM's first ``lstm_layer`` windows it), and the detector
epilogue takes the raw rows as its targets.  Such a chain is *fused* when
every step is ``SimpleImputer``, ``PCA`` or one of the three scalers (each
has a static ``apply`` in the JAX package, which serves these chains
inside ``serve.score``, ``serve.fleet`` and ``serve.stream_step``:
``gordo_tpu/serve/scorer.py:119-126``): it stacks into the fleet
scorer's buckets, streams, and serves at every precision, its stats leaves
cast as the reference casts them.  A chain with a ``QuantileTransformer``
or ``FunctionTransformer`` step has no fused program in the JAX package,
which serves it through the model's own float32 path
(``gordo_tpu/serve/scorer.py:562-575``): the port serves it one machine
at a time through the same kernels, at float32 whatever the serving
dtype.

The pipeline containers serve as the JAX package serves them, through
the model's own float32 path (``gordo_tpu/serve/scorer.py:562-581``),
not fused: one machine at a time, at float32 whatever the serving dtype.
A ``TransformedTargetRegressor`` runs its regressor's launches for the
model output alone, one ``chain_apply`` of its transformer's inverse
steps, then the detector epilogue alone (``fleet_score`` with no layers)
against the raw rows: three launches, four with a window.  A
``MultiOutputRegressor``'s column estimators are clones, stacked as the
machines of one bucket: the request rows go once through each, in one
model launch, then the epilogue alone.  A ``FeatureUnion`` pipeline step
runs one ``chain_apply`` per branch, each writing its columns of the
model's input.

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
from gordo_tpu_torch.kernels.chain_apply import chain_apply, chain_apply_union, stack_steps
from gordo_tpu_torch.kernels.fleet_score import fleet_score, slot_ints
from gordo_tpu_torch.kernels.lstm_layer import launch_plan, lstm_layer
from gordo_tpu_torch.kernels.rolling_median import MAX_WINDOW, rolling_median
from gordo_tpu_torch.models.estimator import AutoEncoder, LSTMAutoEncoder, LSTMForecast
from gordo_tpu_torch.ops.scalers import PCA, PORTED_SCALERS, TRANSFORMS, SimpleImputer
from gordo_tpu_torch.pipeline import FeatureUnion, MultiOutputRegressor, Pipeline, TransformedTargetRegressor
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
    own leaves in ``STAT_KEYS`` order, which :class:`_Stack` stacks and
    casts into a kernel's step."""
    if not isinstance(step, PORTED_SCALERS):
        raise NotImplementedError(
            f"{what} {type(step).__name__} waits for ROADMAP queue 1 item 2 "
            "(training: the other scalers); the port serves MinMaxScaler, "
            "StandardScaler and RobustScaler"
        )
    if step.stats_ is None:
        raise RuntimeError(f"{what} {type(step).__name__} is not fitted")
    return type(step), tuple(np.asarray(step.stats_[k], np.float32) for k in step.STAT_KEYS)


#: the transform steps the JAX package serves inside its fused programs
FUSED_TRANSFORMS = PORTED_SCALERS + (SimpleImputer, PCA)


def _transform_step(step):
    """A fitted pipeline step the port serves through ``chain_apply``."""
    if not isinstance(step, TRANSFORMS + (FeatureUnion,)):
        raise NotImplementedError(
            f"pipeline step {type(step).__name__} waits for ROADMAP queue 1 item 2 "
            "(training breadth: the other pipeline steps)"
        )
    step._check_fitted()
    return step


def _input_width(step) -> Optional[int]:
    """The width of a fitted transform step's input, where its stats tell
    it (a PCA's components, a quantile grid's or the stats' width; funcs
    keep the width and tell nothing)."""
    if isinstance(step, FeatureUnion):
        return next((w for w in (_input_width(t) for _, t in step.transformer_list) if w), None)
    return int(np.shape(step.stats_[step.STAT_KEYS[-1]])[-1]) if step.STAT_KEYS else None


def _stages(transforms) -> List[List[List[Any]]]:
    """One machine's transform steps as ``chain_apply`` stages: a stage is
    a list of branches, each a list of steps (on the host) that writes its
    own columns of the stage's output.  Consecutive transforms share one
    stage of one branch; a ``FeatureUnion`` is a stage of its branches."""
    stages, linear = [], []
    for t in transforms:
        if isinstance(t, FeatureUnion):
            if linear:
                stages.append([linear])
                linear = []
            stages.append(t.branch_steps("cpu"))
        else:
            linear = linear + t.steps("cpu")
    return stages + [[linear]] if linear else stages


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


def _model_chain(base) -> Dict[str, Any]:
    """The model part of a chain: a pipeline (its scaler steps applied by
    the model's first kernel, or its steps run through ``chain_apply``) or
    a bare estimator."""
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
    if transforms:
        # the request's width: the first step's that tells it
        n_features = next((w for w in map(_input_width, transforms) if w), n_features)
    _check_kernel_limits(cells, 0)
    return {
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
        # each scaler's (class, stats leaves); _Stack makes them the steps
        # the model's first kernel applies
        "scalers": scalers,
        # or the fitted transform steps that chain_apply runs first
        "transforms": transforms,
        # the JAX package's fused chain: stacked, streamed, cast (a chain
        # that does not fuse is served at float32, one machine at a time)
        "fused": all(isinstance(t, FUSED_TRANSFORMS) for t in transforms),
        # a TransformedTargetRegressor's inverse steps, a
        # MultiOutputRegressor's column chains
        "target_inverse": [],
        "columns": [],
        "detector": None,
    }


def _extract_chain(model) -> Dict[str, Any]:
    """The pure pieces of a detector/pipeline/estimator as host arrays."""
    detector = None
    base = model
    if isinstance(model, DiffBasedAnomalyDetector):
        detector = model
        base = model.base_estimator
    if isinstance(base, TransformedTargetRegressor):
        chain = _model_chain(base.regressor)
        # the transformer's inverse, on the model output (none: the identity)
        chain["target_inverse"] = [] if base.transformer is None else base.transformer.inverse_steps("cpu")
        chain["fused"] = False
    elif isinstance(base, MultiOutputRegressor):
        if not base.estimators_:
            raise RuntimeError("MultiOutputRegressor is not fitted")
        columns = [_model_chain(est) for est in base.estimators_]
        chain = {**columns[0], "cells": [], "cell_acts": (), "layers": [], "acts": (), "scalers": [],
                 "transforms": [], "columns": columns, "fused": False}
    else:
        chain = _model_chain(base)
    if detector is not None:
        chain["detector"] = {
            "scaler": _scaler_stats(detector.scaler, "detector scaler"),
            "feature_thresholds": detector.feature_thresholds_,
            "aggregate_threshold": detector.aggregate_threshold_,
            "require_thresholds": detector.require_thresholds,
            "window": int(detector.window or 0),
        }
    _check_kernel_limits([], chain["detector"]["window"] if chain["detector"] else 0)
    return chain


class _Stack:
    """The chains of M structurally identical machines, stacked along a
    leading machine axis and resident on ``device`` at the storage dtype
    of serving precision ``dtype``.

    ``stacked``: a bucket of the fleet scorer.  The reference's bucket path
    stores its stacked leaves in bf16 and quantises each (int8) with one
    scale across its machines; the per-machine path quantises the float32
    leaf.  Each scaler's own stats leaves (MinMax's scale and offset,
    Standard's mean and std, Robust's center and scale) are stacked and
    cast (quantised) as the reference casts each leaf, and stored at the
    storage dtype: the pipeline's scalers as ``scalers``, the steps
    ``(form, a, b)`` the model's first kernel applies in turn, and the
    detector scaler as ``det``, the step of the detector epilogue.  A chain
    that ``chain_apply`` runs keeps its steps: each
    step's stats leaves stacked (M, ...) and cast as the reference casts
    them.  One that does not fuse (``chain["fused"]``) is one machine's,
    stored and served at float32 whatever ``dtype`` asks: a
    ``FeatureUnion`` step's branches (``stages``), a
    ``TransformedTargetRegressor``'s inverse steps (``target_inverse``),
    a ``MultiOutputRegressor``'s column chains as the machines of one
    stack (``columns``)."""

    def __init__(
        self,
        chains: List[Dict[str, Any]],
        device: torch.device,
        dtype: str = "float32",
        stacked: bool = False,
    ):
        self.device = device
        c0 = chains[0]
        if not c0["fused"]:
            if len(chains) > 1:
                raise ValueError("a transform chain that does not fuse is served one machine at a time")
            dtype = "float32"
        self.dtype = precision.canonical(dtype)
        self.n_features = c0["n_features"]
        self.mode = c0["mode"]
        self.lookback = c0["lookback"]
        self.offset_rows = c0["offset_rows"]
        self.acts = c0["acts"]
        self.cell_acts = c0["cell_acts"]
        self.window = c0["detector"]["window"] if c0["detector"] else 0
        self.machines = len(chains)

        # every float leaf of the stack is uploaded as ``put`` takes it,
        # then all are cast in one call (at int8 one fake_quant launch) and
        # each cast leaf takes its leaf's place
        leaves, leaf_groups = [], []

        def put(arrays, groups=1):
            t = torch.from_numpy(np.ascontiguousarray(np.stack(arrays), np.float32)).to(device)
            if stacked:
                t = precision.cast_storage(t, self.dtype)
            leaves.append(t)
            leaf_groups.append(groups)
            return t

        # an LSTM cell's four gate blocks are separate leaves of the reference
        self.cells = [
            tuple(put([c["cells"][i][k] for c in chains], groups=4) for k in range(3))
            for i in range(len(c0["cells"]))
        ]
        self.layers = [
            (put([c["layers"][i][0] for c in chains]), put([c["layers"][i][1] for c in chains]))
            for i in range(len(c0["layers"]))
        ]
        def scaler_step(stats):
            """One scaler of every chain as a kernel's step ``(form, a,
            b)``, each stats leaf stacked (M, F) and cast."""
            return (stats[0][0].FORM,) + tuple(put([s[1][k] for s in stats]) for k in range(2))

        def stack_chain(step_lists):
            return stack_steps(step_lists, stack=lambda ts: put([t.numpy() for t in ts]))

        # chain_apply's stages, every stats leaf stacked and cast as the
        # reference's cast_params casts the scalers' (a fused chain's fill,
        # mean, components and scaler stats; PCA's components are stored
        # transposed, which leaves a leaf's max-abs int8 scale as it is):
        # a fused chain is one stage of one branch, ``transform_steps``
        machine_stages = [_stages(c["transforms"]) for c in chains]
        self.stages = [
            [stack_chain([ms[i][j] for ms in machine_stages]) for j in range(len(stage))]
            for i, stage in enumerate(machine_stages[0])
        ]
        self.transform_steps = self.stages[0][0] if len(self.stages) == 1 and len(self.stages[0]) == 1 else []
        self.target_inverse = stack_chain([c["target_inverse"] for c in chains]) if c0["target_inverse"] else []
        self.columns = _Stack(c0["columns"], device, self.dtype) if c0["columns"] else None
        self.scalers = [scaler_step([c["scalers"][i] for c in chains]) for i in range(len(c0["scalers"]))]
        self.det = self.agg_thr = None
        self.thresholds_np = self.agg_thresholds_np = None
        self.with_thresholds = False
        if c0["detector"] is not None:
            dets = [c["detector"] for c in chains]
            self.det = scaler_step([d["scaler"] for d in dets])
            self.with_thresholds = all(d["feature_thresholds"] is not None for d in dets)
            if self.with_thresholds:
                self.thresholds_np = np.stack(
                    [np.asarray(d["feature_thresholds"], np.float32) for d in dets]
                )
                self.agg_thresholds_np = np.asarray(
                    [float(d["aggregate_threshold"]) for d in dets], np.float32
                )
                self.agg_thr = torch.from_numpy(self.agg_thresholds_np).to(device)
        cast = dict(zip(map(id, leaves), precision.cast_params(leaves, self.dtype, leaf_groups)))
        self._replace_leaves(lambda t: cast.pop(id(t)))
        assert not cast, "every uploaded leaf is cast"

    def _replace_leaves(self, f) -> None:
        """Every leaf ``put`` uploaded (cells, layers, the steps of
        ``stages`` and ``target_inverse``, ``scalers``, ``det``) replaced
        by ``f(leaf)``."""
        g = lambda t: None if t is None else f(t)  # noqa: E731
        self.cells = [tuple(map(g, cell)) for cell in self.cells]
        self.layers = [tuple(map(g, layer)) for layer in self.layers]
        self.scalers = [(form,) + tuple(map(g, ab)) for form, *ab in self.scalers]
        if self.det is not None:
            self.det = (self.det[0],) + tuple(map(g, self.det[1:]))
        for st in [st for stage in self.stages for branch in stage for st in branch] + self.target_inverse:
            st.a, st.b = g(st.a), g(st.b)

    def resident_bytes(self) -> int:
        """Device bytes of the stacked parameters, stats and thresholds."""
        tensors = [t for cell in self.cells for t in cell]
        tensors += [t for layer in self.layers for t in layer]
        tensors += [t for step in self.scalers + [self.det or ()] for t in step[1:]] + [self.agg_thr]
        steps = [st for stage in self.stages for branch in stage for st in branch] + self.target_inverse
        tensors += [t for st in steps for t in (st.a, st.b)]
        return (sum(t.numel() * t.element_size() for t in tensors if t is not None)
                + (self.columns.resident_bytes() if self.columns else 0))

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
        if idx is not None:
            idx = slot_ints(idx, "idx", 0, self.machines - 1, self.device)
        rows = chain_rows = None
        if n_rows is not None:
            rows = slot_ints([int(r) - off for r in n_rows], "n_rows - offset", 1, n_out, self.device)
            if self.stages or self.columns:
                chain_rows = slot_ints(n_rows, "n_rows", 1, int(x.shape[1]), self.device)
        detector = None
        if with_anomaly:
            detector = dict(
                det=self.det,
                # with a window, the confidence comes from the smoothed total
                agg_thr=None if self.window else self.agg_thr,
                y=targets,
                y_offset=off,
            )
        with torch.no_grad():
            if self.columns or self.target_inverse:
                # the model output first, the epilogue in a launch of its own
                pred = self._model_output(x, idx, chain_rows, rows)["model-output"]
                if self.target_inverse:
                    pred = chain_apply(pred, self.target_inverse, idx=idx, n_rows=rows)
                if detector is None:
                    return {"model-output": pred}
                detector["y"] = x if targets is None else targets
                out = fleet_score(pred, [], [], idx=idx, n_rows=rows, **detector)
            else:
                out = self._model_output(x, idx, chain_rows, rows, detector)
            if with_anomaly and self.window:
                out.update(rolling_median(
                    out["tag-anomaly-scores"], out["total-anomaly-score"], self.window,
                    agg_thr=self.agg_thr, idx=idx, n_rows=rows,
                ))
        return out

    def _model_output(self, x, idx, chain_rows, rows, detector=None):
        """``fleet_score``'s outputs for rows ``x``: the transform stages,
        the LSTM layers and the dense stack, with the detector epilogue in
        the same launch where ``detector`` gives its arguments.  A
        ``MultiOutputRegressor`` runs each request slot once per column
        machine (slot ``s``'s copy ``j`` through column ``j``), and its
        (m·M, n, 1) outputs become the (m, n, M) prediction."""
        if self.columns:
            m, M = int(x.shape[0]), self.columns.machines
            cols = slot_ints(list(range(M)) * m, "idx", 0, M - 1, self.device)
            each = lambda t: None if t is None else t.repeat_interleave(M)  # noqa: E731
            pred = self.columns._model_output(x.repeat_interleave(M, dim=0), cols, each(chain_rows),
                                              each(rows))["model-output"]
            return {"model-output": pred.reshape(m, M, -1).transpose(1, 2).contiguous()}
        kw: Dict[str, Any] = dict(idx=idx, n_rows=rows, **(detector or {}))
        # out at the type the next kernel reads: fleet_score an f32 input,
        # the first lstm_layer rows at the storage type
        h = self._transform(x, idx, chain_rows, torch.float32 if self.mode == "none" else x.dtype)
        if self.mode == "none":
            kw.update(chain=self.scalers)
        else:
            for i, ((ki, kh, b), act) in enumerate(zip(self.cells, self.cell_acts)):
                first = i == 0
                h = lstm_layer(
                    h, ki, kh, b, lookback=self.lookback, act=act,
                    n_windows=x.shape[1] - self.offset_rows if first else None,
                    chain=self.scalers if first else None,
                    idx=idx, slot_windows=rows, last=i == len(self.cells) - 1,
                )
        if detector is not None and h is not x and kw["y"] is None:
            # the raw rows are the targets of a transformed or windowed input
            kw["y"] = x
        return fleet_score(h, self.layers, self.acts, **kw)

    def _transform(self, x, idx, chain_rows, out_dtype):
        """``x`` through the transform stages: one ``chain_apply`` launch
        per branch, a stage's branches each into its columns of one
        output."""
        h = x
        for k, stage in enumerate(self.stages):
            kw = dict(idx=idx, n_rows=chain_rows, out_dtype=out_dtype if k == len(self.stages) - 1 else x.dtype)
            h = chain_apply(h, stage[0], **kw) if len(stage) == 1 else chain_apply_union(h, stage, **kw)
        return h


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
