"""Whole-fleet anomaly-detector builds, exact mode (counterpart of
``gordo_tpu/parallel/anomaly.py``).

A bucket of M machines that share one model definition is built in a few
kernel launches per length group, the port of the XLA program
``fleet.exact`` (``_exact_fleet_program``):

1. ``scaler_stats`` (K3): the pipeline MinMax of every CV fold's train
   rows and of the full series, and the detector MinMax of the targets;
2. ``fleet_fit`` (K1 + K2): the K fold fits and the final fit of every
   machine, one launch;
3. ``fleet_score`` (K5): every fold's out-of-fold prediction, tag error
   and total, one launch over (machine × fold) slots;
4. ``cv_epilogue`` (K4): smoothed maxima and the four metrics per slot;
   their means over folds are the thresholds.

Exact parity with the single-machine path holds by construction, as in
the JAX package: machines are grouped by row count, and each fold's rows,
scaling and batch geometry are those ``cross_validate`` would use.  The
single-machine ``DiffBasedAnomalyDetector.cross_validate`` runs through
:func:`exact_fleet_program` with M = 1.

Not ported here: pad-up mode (``pad_lengths``, K8) and warm builds
(``warm_params``) raise ``NotImplementedError``; there is no power-of-two
padding of the machine axis, which the JAX package needs only to bound
XLA recompiles.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.device import resolve_device, to_device
from gordo_tpu_torch.kernels.cv_epilogue import cv_epilogue
from gordo_tpu_torch.kernels.fleet_fit import fleet_fit, geometry
from gordo_tpu_torch.kernels.fleet_score import fleet_score
from gordo_tpu_torch.kernels.scaler_stats import scaler_stats
from gordo_tpu_torch.models.estimator import AutoEncoder
from gordo_tpu_torch.models.factories.feedforward import layer_names
from gordo_tpu_torch.ops.scalers import MinMaxScaler
from gordo_tpu_torch.parallel.fleet import Draws, chain_of, fleet_draws, put_draws, stack_rows
from gordo_tpu_torch.pipeline import Pipeline
from gordo_tpu_torch.registry import lookup_factory
from gordo_tpu_torch.train.cv import METRIC_NAMES, build_splitter, summarize
from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams

#: scalers whose stats the port computes (K3)
FLEETABLE_SCALERS = (MinMaxScaler,)
_ITEM_MODES = "ROADMAP queue 1 item 6 (ragged and warm builds, K8)"

# ---------------------------------------------------------------------------
# Definition analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetSpec:
    """Everything needed to run one homogeneous bucket as a fleet build."""

    detector_proto: DiffBasedAnomalyDetector
    scaler_protos: List[MinMaxScaler]       # pipeline scalers, in order
    estimator_proto: AutoEncoder
    train_cfg: TrainConfig
    factory_kwargs: Dict[str, Any]
    seed: int


def analyze_definition(model) -> Optional[FleetSpec]:
    """Return a :class:`FleetSpec` if ``model`` (a built-but-unfitted
    prototype) matches the fleetable shape, else None."""
    if not isinstance(model, DiffBasedAnomalyDetector):
        return None
    if not isinstance(model.scaler, FLEETABLE_SCALERS):
        return None
    base = model.base_estimator
    scalers: List[MinMaxScaler] = []
    if isinstance(base, Pipeline):
        for _, step in base.steps[:-1]:
            if not isinstance(step, FLEETABLE_SCALERS):
                return None
            scalers.append(step)
        est = base._final
    else:
        est = base
    if not isinstance(est, AutoEncoder):
        return None
    if est.module_ is not None:  # already fitted — not a prototype
        return None
    cfg, factory_kwargs = TrainConfig.from_kwargs(dict(est.kwargs))
    seed = int(factory_kwargs.get("seed", 0) or 0)
    return FleetSpec(
        detector_proto=model,
        scaler_protos=scalers,
        estimator_proto=est,
        train_cfg=cfg,
        factory_kwargs=factory_kwargs,
        seed=seed,
    )


# ---------------------------------------------------------------------------
# The exact program
# ---------------------------------------------------------------------------

def module_for(spec: FleetSpec, n_features: int, n_out: int):
    est = spec.estimator_proto
    factory = lookup_factory(est.model_type, est.kind)
    return factory(n_features=n_features, n_features_out=n_out, **spec.factory_kwargs)


def _scaler_range(spec: FleetSpec) -> Optional[Tuple[float, float]]:
    if len(spec.scaler_protos) > 1:
        raise NotImplementedError(
            "a pipeline of several scalers waits for ROADMAP queue 1 item 2 "
            "(training: the other scalers and pipeline containers)"
        )
    return spec.scaler_protos[0].feature_range if spec.scaler_protos else None


def exact_fleet_program(
    spec: FleetSpec,
    X: torch.Tensor,
    y: torch.Tensor,
    folds: Sequence[Tuple[np.ndarray, np.ndarray]],
    final: bool,
    draws: Draws = fleet_draws,
) -> Dict[str, Any]:
    """The port of ``_exact_fleet_program``'s body for one length group.

    ``X`` (M, N, F) and ``y`` (M, N, Fo) raw rows on the device; ``folds``
    the CV folds' (train, test) rows; ``final``: also fit on every row
    (fit slot ``len(folds)``).  Returns device tensors: ``scale``/
    ``offset`` (M, G, F) each fit's pipeline MinMax (None without a
    scaler step), ``det_scale``/``det_offset`` (M, Fo), ``layers``
    ``[(W (M, G, in, out), b (M, G, out)), ...]``, ``history`` (M, G,
    epochs); with folds also ``feature_thresholds`` (M, Fo),
    ``aggregate_threshold`` (M,), ``metrics`` {name: (M, K)} and the
    out-of-fold ``predictions`` (M, K, nt, Fo) with ``test_rows``."""
    cfg = spec.train_cfg
    hp = adam_hparams(cfg)
    M, N, F = (int(s) for s in X.shape)
    Fo = int(y.shape[2])
    dims, acts = chain_of(module_for(spec, F, Fo))
    fit_rows = [np.asarray(tr) for tr, _ in folds] + ([np.arange(N)] if final else [])
    fits = [geometry(rows, cfg.batch_size) for rows in fit_rows]
    G = len(fits)

    feature_range = _scaler_range(spec)
    if feature_range is None:
        scale = torch.ones((M, G, F), dtype=torch.float32, device=X.device)
        offset = torch.zeros_like(scale)
    else:
        scale, offset = scaler_stats(X, fit_rows, feature_range)
    det_scale, det_offset = scaler_stats(
        y, [np.arange(N)], spec.detector_proto.scaler.feature_range
    )
    params0, perms = put_draws(draws, spec.seed, dims, fits, cfg.epochs, X.device)
    layers, history = fleet_fit(
        X, y, fits, scale, offset, params0, perms, np.zeros(M, np.int64), acts, cfg.epochs, hp
    )
    out: Dict[str, Any] = {
        "scale": scale if feature_range is not None else None,
        "offset": offset if feature_range is not None else None,
        "det_scale": det_scale[:, 0],
        "det_offset": det_offset[:, 0],
        "layers": layers,
        "history": history,
    }
    if not folds:
        return out

    # out-of-fold scoring: slot i * K + k is machine i's test rows of fold k
    K = len(folds)
    tests = [np.asarray(te) for _, te in folds]
    lens = np.array([len(te) for te in tests])
    nt = int(lens.max())
    te_idx = np.stack([np.pad(te, (0, nt - len(te)), mode="edge") for te in tests])
    te_dev = to_device(te_idx.reshape(-1), X.device)
    x_oof = X.index_select(1, te_dev).reshape(M * K, nt, F)
    y_oof = y.index_select(1, te_dev).reshape(M * K, nt, Fo)
    n_rows = np.tile(lens, M)
    ragged = lens.min() != nt
    flat = [(W.reshape(M * G, W.shape[2], W.shape[3]), b.reshape(M * G, b.shape[2])) for W, b in layers]
    scored = fleet_score(
        x_oof, flat, acts,
        scale=scale.reshape(M * G, F),
        offset=offset.reshape(M * G, F),
        det_scale=out["det_scale"][:, None].expand(M, G, Fo).reshape(M * G, Fo),
        det_offset=out["det_offset"][:, None].expand(M, G, Fo).reshape(M * G, Fo),
        idx=(np.arange(M)[:, None] * G + np.arange(K)[None]).reshape(-1),
        n_rows=n_rows if ragged else None,
        y=y_oof,
    )
    pred = scored["model-output"]
    epi = cv_epilogue(
        scored["tag-anomaly-scores"], scored["total-anomaly-score"], pred, y_oof, n_rows
    )
    out.update(
        feature_thresholds=epi["feature_max"].reshape(M, K, Fo).mean(dim=1),
        aggregate_threshold=epi["total_max"].reshape(M, K).mean(dim=1),
        metrics={name: epi[name].reshape(M, K) for name in METRIC_NAMES},
        predictions=pred.reshape(M, K, nt, Fo),
        test_rows=tests,
    )
    return out


def scores_summary(metrics: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    """Per machine, ``{name: {"folds", "mean", "std"}}`` of (M, K) host
    metrics."""
    M, K = metrics[METRIC_NAMES[0]].shape
    return [
        summarize([{name: float(metrics[name][i, k]) for name in METRIC_NAMES} for k in range(K)])
        for i in range(M)
    ]


def layer_state(layers, i: int, slot: int) -> Dict[str, np.ndarray]:
    """``nn.Linear`` state of machine ``i``'s fit ``slot`` from stacked host
    layers ``[(W (M, G, in, out), b (M, G, out)), ...]``."""
    state = {}
    for name, (W, b) in zip(layer_names(len(layers)), layers):
        state[f"{name}.weight"] = np.ascontiguousarray(W[i, slot].T)
        state[f"{name}.bias"] = b[i, slot]
    return state


# ---------------------------------------------------------------------------
# The fleet builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PendingGroup:
    """One length group's launched work + assembly context."""

    indices: List[int]
    out: Any
    m: int
    k_folds: int
    t0: float
    fetch_seconds: float = 0.0
    assemble_seconds: float = 0.0


class PendingFleetBuild:
    """A launched fleet build: every group's kernels are enqueued on the
    device, nothing fetched.  :meth:`collect` waits for the results,
    fetches them and assembles the detectors (idempotent)."""

    def __init__(self, builder: "FleetDiffBuilder", n: int, groups: List[_PendingGroup]):
        self._builder = builder
        self._n = n
        self._groups = groups
        self._detectors: Optional[List[DiffBasedAnomalyDetector]] = None
        self.fetch_seconds = 0.0
        self.assemble_seconds = 0.0

    def collect(self) -> List[DiffBasedAnomalyDetector]:
        """Detectors in the original ``Xs`` input order; repeat calls
        return the cached list."""
        if self._detectors is None:
            detectors: List[Optional[DiffBasedAnomalyDetector]] = [None] * self._n
            for g in self._groups:
                for i, det in zip(g.indices, self._builder._collect_group(g)):
                    detectors[i] = det
                self.fetch_seconds += g.fetch_seconds
                self.assemble_seconds += g.assemble_seconds
            self._detectors = detectors  # type: ignore[assignment]
        return self._detectors  # type: ignore[return-value]


class FleetDiffBuilder:
    """Build M homogeneous ``DiffBasedAnomalyDetector`` machines at once.

    ``device``: where the kernels run (``None``: CUDA, raising without
    it; ``"cpu"``: their plain versions).  ``draws``: the source of
    initial params and permutations (default :func:`fleet_draws`; the
    tests inject the JAX package's).
    """

    def __init__(
        self,
        spec: FleetSpec,
        cv: Any = None,
        pad_lengths: Optional[int] = None,
        device=None,
        draws: Draws = fleet_draws,
    ):
        if pad_lengths:
            raise NotImplementedError(f"pad_lengths waits for {_ITEM_MODES}")
        self.spec = spec
        self.splitter = build_splitter(cv)
        self.device = resolve_device(device)
        self.draws = draws

    def build(
        self,
        Xs: Sequence[np.ndarray],
        ys: Optional[Sequence[np.ndarray]] = None,
        warm_params: Optional[Sequence[Any]] = None,
    ) -> List[DiffBasedAnomalyDetector]:
        """Build detectors for ``Xs`` in input order (dispatch + collect)."""
        return self.dispatch(Xs, ys, warm_params=warm_params).collect()

    def dispatch(
        self,
        Xs: Sequence[np.ndarray],
        ys: Optional[Sequence[np.ndarray]] = None,
        warm_params: Optional[Sequence[Any]] = None,
    ) -> PendingFleetBuild:
        """Launch every length group's kernels and return without waiting
        for them."""
        if warm_params is not None:
            raise NotImplementedError(f"warm_params waits for {_ITEM_MODES}")
        if ys is not None and len(ys) != len(Xs):
            raise ValueError(f"Got {len(Xs)} input series but {len(ys)} target series")
        Xs = [np.asarray(x, np.float32) for x in Xs]
        if ys is not None:
            for i, (x, yy) in enumerate(zip(Xs, ys)):
                if len(yy) != len(x):
                    raise ValueError(
                        f"Target row count differs from input for machine {i}: "
                        f"{len(yy)} != {len(x)}"
                    )
            ys = [np.asarray(yy, np.float32) for yy in ys]
        groups: List[_PendingGroup] = []
        self._dispatch_exact_length_groups(Xs, ys, range(len(Xs)), groups)
        return PendingFleetBuild(self, len(Xs), groups)

    def _dispatch_exact_length_groups(self, Xs, ys, idxs, groups: List[_PendingGroup]) -> None:
        """Group ``idxs`` by row count and launch the exact program per
        length group, appending the pending groups."""
        by_len: Dict[int, List[int]] = {}
        for i in idxs:
            by_len.setdefault(int(Xs[i].shape[0]), []).append(i)
        for group in by_len.values():
            X_g, _, _ = stack_rows([Xs[i] for i in group])
            y_g = X_g if ys is None else stack_rows([ys[i] for i in group])[0]
            g = self._dispatch_group(X_g, y_g)
            g.indices = list(group)
            groups.append(g)

    def _dispatch_group(self, X: np.ndarray, y: np.ndarray) -> _PendingGroup:
        t0 = time.time()
        folds = [
            (np.asarray(tr), np.asarray(te))
            for tr, te in self.splitter.split(np.empty((X.shape[1], 1)))
        ]
        X_dev = torch.from_numpy(X).to(self.device)
        y_dev = X_dev if y is X else torch.from_numpy(y).to(self.device)
        with torch.no_grad():
            out = exact_fleet_program(self.spec, X_dev, y_dev, folds, final=True, draws=self.draws)
        return _PendingGroup(indices=[], out=out, m=X.shape[0], k_folds=len(folds), t0=t0)

    def _collect_group(self, g: _PendingGroup) -> List[DiffBasedAnomalyDetector]:
        out = g.out
        K = g.k_folds
        t0 = time.time()
        host = {
            # fit slot K is the final full-data fit, the only one kept
            "scaler_stats": [] if out["scale"] is None else [{
                "scale": out["scale"][:, K].cpu().numpy(),
                "offset": out["offset"][:, K].cpu().numpy(),
            }],
            "det_scaler_stats": {
                "scale": out["det_scale"].cpu().numpy(),
                "offset": out["det_offset"].cpu().numpy(),
            },
            "final_layers": [
                (W[:, K:].cpu().numpy(), b[:, K:].cpu().numpy()) for W, b in out["layers"]
            ],
            "final_history": out["history"][:, K].cpu().numpy(),
            "feature_thresholds": out["feature_thresholds"].cpu().numpy(),
            "aggregate_threshold": out["aggregate_threshold"].cpu().numpy(),
            "metrics": {name: v.cpu().numpy() for name, v in out["metrics"].items()},
        }
        g.out = None
        fleet_seconds = time.time() - g.t0
        g.fetch_seconds = time.time() - t0
        t1 = time.time()
        detectors = self._assemble(host, g.m, fleet_seconds)
        g.assemble_seconds = time.time() - t1
        return detectors

    def _assemble(self, out: Dict[str, Any], m: int, fleet_seconds: float) -> List[DiffBasedAnomalyDetector]:
        """Unpack one group's host results into per-machine detectors."""
        spec = self.spec
        est_blob = pickle.dumps(spec.estimator_proto)
        scaler_blobs = [pickle.dumps(p) for p in spec.scaler_protos]
        det_scaler_blob = pickle.dumps(spec.detector_proto.scaler)
        wrap = bool(spec.scaler_protos) or isinstance(spec.detector_proto.base_estimator, Pipeline)
        scores = scores_summary(out["metrics"])
        feat = out["feature_thresholds"]
        agg = out["aggregate_threshold"]
        detectors = []
        for i in range(m):
            est = pickle.loads(est_blob)
            est.load_state_arrays(layer_state(out["final_layers"], i, 0))
            est.history_ = out["final_history"][i]
            est.fit_seconds_ = fleet_seconds / m
            steps = []
            for blob, stats in zip(scaler_blobs, out["scaler_stats"]):
                sc = pickle.loads(blob)
                sc.stats_ = {key: val[i] for key, val in stats.items()}
                steps.append(sc)
            base: Any = Pipeline([*steps, est]) if wrap else est
            det_scaler = pickle.loads(det_scaler_blob)
            det_scaler.stats_ = {key: val[i] for key, val in out["det_scaler_stats"].items()}
            det = DiffBasedAnomalyDetector(
                base_estimator=base,
                scaler=det_scaler,
                require_thresholds=spec.detector_proto.require_thresholds,
                window=spec.detector_proto.window,
            )
            det.feature_thresholds_ = feat[i]
            det.aggregate_threshold_ = float(agg[i])
            det.cv_metadata_ = {
                "scores": scores[i],
                "feature_thresholds": feat[i].tolist(),
                "aggregate_threshold": float(agg[i]),
                "fleet": {"bucket_size": m, "fleet_seconds": fleet_seconds},
            }
            detectors.append(det)
        return detectors
