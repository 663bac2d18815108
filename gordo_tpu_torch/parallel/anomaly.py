"""Whole-fleet anomaly-detector builds (counterpart of
``gordo_tpu/parallel/anomaly.py``).

A bucket of M machines that share one model definition is built in a few
kernel launches per length group, the port of the XLA program
``fleet.exact`` (``_exact_fleet_program``):

1. K3: the pipeline's scaler chain on every CV fold's train rows and on
   the full series, one launch per step (``scaler_stats`` for MinMax and
   Standard, ``scaler_quantiles`` for Robust; each step's stats taken on
   the previous step's output, which the kernel applies as it loads), and
   the detector scaler's stats of the targets.  The fits and the scorer
   take the chain's steps, each in its own form, and apply them in turn as
   they load (``csrc/scaler_prefix.cuh``), as the reference's
   ``_make_apply_chain`` does;
2. ``fleet_fit`` (K1 + K2): the K fold fits and the final fit of every
   machine, one launch;
3. ``fleet_score`` (K5): every fold's out-of-fold prediction, tag error
   and total, one launch over (machine × fold) slots;
4. ``cv_epilogue`` (K4): smoothed maxima and the four metrics per slot;
   their means over folds are the thresholds.

An LSTM bucket (``LSTMAutoEncoder`` / ``LSTMForecast``) trains its fits
in the lockstep loop of ``gordo_tpu_torch/train/lstm_fit.py`` instead of
step 2 (per epoch and step: ``lstm_layer`` per layer, ``lstm_head_fit``,
``lstm_layer_bwd`` per layer, ``fleet_adam``), and scores its folds
through ``lstm_layer`` per layer before ``fleet_score``'s LSTM head, on the
windows of each fold's test rows alone (``_make_windowize``).

Exact parity with the single-machine path holds by construction, as in
the JAX package: machines are grouped by row count, and each fold's rows,
scaling and batch geometry are those ``cross_validate`` would use.  The
single-machine ``DiffBasedAnomalyDetector.cross_validate`` runs through
:func:`exact_fleet_program` with M = 1.

Pad-up mode (``pad_lengths``), the port of ``fleet.padded``
(``_padded_fleet_program``): machines are grouped by row count rounded up,
and a group's rows past each machine's length are masked, never dropped.
``X`` and ``y`` stay NaN-padded on the device for the stat kernels alone,
which skip NaN as ``jnp.nanmin``, ``jnp.nanmean`` and
``jnp.nanpercentile`` do (a NaN stays NaN through the chain); the fits and the
out-of-fold scoring read zero-filled copies (JAX's ``Xz``/``yz``: NaN
anywhere becomes 0) and, through per-slot counts, only each machine's real
rows: ``fleet_fit`` and the LSTM fit weigh rows (windows) past a machine's
count 0, ``fleet_score`` and ``lstm_layer`` score each slot's real rows,
and ``cv_epilogue`` takes its maxima and metrics over them (K8).  So NaN
reaches no kernel's arithmetic.  Warm builds (``warm_params``, the
programs ``fleet.exact_warm``/``fleet.padded_warm``) start every fit of a
machine from its previous params.  There is no power-of-two padding of the
machine axis, which the JAX package needs only to bound XLA recompiles.
"""

from __future__ import annotations

import dataclasses
import logging
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
from gordo_tpu_torch.kernels.lstm_layer import lstm_layer
from gordo_tpu_torch.models.estimator import AutoEncoder, LSTMAutoEncoder, LSTMForecast
from gordo_tpu_torch.models.factories.feedforward import layer_names
from gordo_tpu_torch.models.factories.lstm import lstm_state
from gordo_tpu_torch.ops.scalers import PORTED_SCALERS, BaseTransform
from gordo_tpu_torch.parallel.fleet import (
    Draws,
    chain_of,
    fleet_draws,
    lstm_chain_of,
    put_draws,
    put_lstm_draws,
    stack_rows,
    stack_warm_params,
)
from gordo_tpu_torch.pipeline import Pipeline
from gordo_tpu_torch.registry import lookup_factory
from gordo_tpu_torch.train.cv import METRIC_NAMES, build_splitter, summarize
from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams
from gordo_tpu_torch.train.lstm_fit import lstm_fit, window_fit

#: scalers whose stats the port computes (K3): the pipeline's chain steps
#: and the detector scaler
FLEETABLE_SCALERS = PORTED_SCALERS

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Definition analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetSpec:
    """Everything needed to run one homogeneous bucket as a fleet build."""

    detector_proto: DiffBasedAnomalyDetector
    scaler_protos: List[BaseTransform]      # pipeline scalers, in order
    estimator_proto: Any                    # AutoEncoder, LSTMAutoEncoder, LSTMForecast
    train_cfg: TrainConfig
    factory_kwargs: Dict[str, Any]
    seed: int
    #: the estimator's windows, as ``_group_context`` reads them:
    #: "none" (rows), "ae" (reconstruct a window's last row), "forecast"
    window_mode: str = "none"
    lookback: int = 1
    #: rows of a series before its first prediction
    offset: int = 0

    @property
    def signature(self) -> Tuple:
        """Bucket key: machines with equal signatures build together (the
        JAX package's ``FleetSpec.signature``)."""
        return (
            type(self.detector_proto).__name__,
            self.detector_proto.window,
            tuple(
                (type(s).__name__, tuple(sorted(s._stat_options().items())))
                for s in self.scaler_protos
            ),
            (
                type(self.detector_proto.scaler).__name__,
                tuple(sorted(self.detector_proto.scaler._stat_options().items())),
            ),
            type(self.estimator_proto).__name__,
            self.estimator_proto.kind,
            self.train_cfg,
            tuple(sorted((k, repr(v)) for k, v in self.factory_kwargs.items())),
        )


def analyze_definition(model) -> Optional[FleetSpec]:
    """Return a :class:`FleetSpec` if ``model`` (a built-but-unfitted
    prototype) matches the fleetable shape, else None."""
    if not isinstance(model, DiffBasedAnomalyDetector):
        return None
    if not isinstance(model.scaler, FLEETABLE_SCALERS):
        return None
    base = model.base_estimator
    scalers: List[BaseTransform] = []
    if isinstance(base, Pipeline):
        for _, step in base.steps[:-1]:
            if not isinstance(step, FLEETABLE_SCALERS):
                return None
            scalers.append(step)
        est = base._final
    else:
        est = base
    if isinstance(est, LSTMForecast):
        window_mode, lookback = "forecast", est.lookback_window
    elif isinstance(est, LSTMAutoEncoder):
        window_mode, lookback = "ae", est.lookback_window
    elif isinstance(est, AutoEncoder):
        window_mode, lookback = "none", 1
    else:
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
        window_mode=window_mode,
        lookback=int(lookback),
        offset=int(est.offset),
    )


# ---------------------------------------------------------------------------
# The exact program
# ---------------------------------------------------------------------------

def module_for(spec: FleetSpec, n_features: int, n_out: int):
    est = spec.estimator_proto
    factory = lookup_factory(est.model_type, est.kind)
    return factory(n_features=n_features, n_features_out=n_out, **spec.factory_kwargs)


def _stats(spec: FleetSpec, X: torch.Tensor, y: torch.Tensor, fit_rows):
    """(K3) the port of ``_make_scale_chain`` and of the detector scaler's
    stats, one stats launch per chain step over every fit's row list: step
    i's stats (M, G, F) taken on step i-1's output (the kernels apply the
    earlier steps as they load).  Returns the chain, each step ``(form, a,
    b)`` with its stats leaves (M, G, F) (none without a scaler step), and
    the detector scaler's step with its stats of the targets (M, 1, Fo).
    NaN rows (a pad-up group's padding) stay NaN through the chain and
    fall out of every statistic, as in the reference.  The stats round as
    the fleet programs' fusions round them (``fused``: a MinMax offset is
    one FMA there, two roundings in the reference's eager ``fit``)."""
    N = int(X.shape[1])
    chain = []
    for proto in spec.scaler_protos:
        a, b = proto.stats_of(X, fit_rows, prefix=chain, fused=True)
        chain.append((proto.FORM, a, b))
    det = spec.detector_proto.scaler
    return chain, (det.FORM,) + tuple(det.stats_of(y, [np.arange(N)], fused=True))


def chain_dims(spec: FleetSpec, n_features: int, n_out: int):
    """The widths of the bucket's chain (an ``LSTMDims`` for an LSTM)."""
    module = module_for(spec, n_features, n_out)
    if spec.window_mode != "none":
        return lstm_chain_of(module)[0]
    return chain_of(module)[0]


def _suffix_counts(lens: np.ndarray, row_lists) -> np.ndarray:
    """(M, len(row_lists)) real rows of each machine in each contiguous
    block of rows, the machine's rows being the first ``lens[i]``."""
    lens = np.asarray(lens, np.int64)[:, None]
    first = np.array([int(r[0]) for r in row_lists])[None]
    size = np.array([len(r) for r in row_lists])[None]
    return np.clip(lens - first, 0, size)


def exact_fleet_program(
    spec: FleetSpec,
    X: torch.Tensor,
    y: torch.Tensor,
    folds: Sequence[Tuple[np.ndarray, np.ndarray]],
    final: bool,
    draws: Draws = fleet_draws,
    route: Optional[str] = None,
    params0=None,
) -> Dict[str, Any]:
    """The port of ``_exact_fleet_program``'s body for one length group.

    ``X`` (M, N, F) and ``y`` (M, N, Fo) raw rows on the device; ``folds``
    the CV folds' (train, test) rows; ``final``: also fit on every row
    (fit slot ``len(folds)``); ``params0``: a warm build's initial params
    of each machine (``parallel.fleet.stack_warm_params``; default the
    seed's draw), with the seed's permutations (``fleet.exact_warm``).
    Returns device tensors: ``chain`` each fit's scaler steps ``[(form, a
    (M, G, F), b), ...]``, ``steps`` each chain step's own stats leaves
    (M, G, F) in its ``STAT_KEYS`` order, ``det`` the detector scaler's
    step ``(form, a (M, Fo), b)`` and ``det_stats`` its stats leaves (M,
    Fo), ``layers`` ``[(W (M, G, in, out), b (M, G,
    out)), ...]``, ``history`` (M, G, epochs); with folds also
    ``feature_thresholds`` (M, Fo), ``aggregate_threshold`` (M,),
    ``metrics`` {name: (M, K)} and the out-of-fold ``predictions`` (M, K,
    nt - offset, Fo) with ``test_rows``.  An LSTM bucket has ``cells``
    ``[(kernel_i (M, G, in, 4H), kernel_h, bias), ...]`` and ``head`` ``(W
    (M, G, H, Fo), b)`` instead of ``layers``; ``route`` picks its fit's
    kernels or plain version (``train.lstm_fit.lstm_fit``)."""
    return _fleet_program(spec, X, y, folds, final, draws, route, params0, None)


def padded_fleet_program(
    spec: FleetSpec,
    X: torch.Tensor,
    y: torch.Tensor,
    lens,
    folds: Sequence[Tuple[np.ndarray, np.ndarray]],
    final: bool = True,
    draws: Draws = fleet_draws,
    route: Optional[str] = None,
    params0=None,
) -> Dict[str, Any]:
    """The port of ``_padded_fleet_program``'s body (``fleet.padded``,
    ``fleet.padded_warm`` with ``params0``) for one padded group.

    ``X`` (M, N, F) and ``y`` (M, N, Fo) hold each machine's rows, NaN
    past its length ``lens[i]`` (host ints); ``folds`` are the padded
    length's, each train and test block contiguous
    (``FleetDiffBuilder._dispatch_padded`` demotes other splitters and
    machines too short for the last test block).  Fold boundaries and
    minibatch geometry come from the padded length; rows past a machine's
    length are masked, never dropped: they fall out of the stats (NaN),
    weigh 0 in the fits, and the out-of-fold maxima and metrics take each
    slot's real rows (``cv_epilogue`` with counts, K8); the thresholds are
    the fold maxima's mean over the folds with real rows.  Returns what
    :func:`exact_fleet_program` returns."""
    return _fleet_program(spec, X, y, folds, final, draws, route, params0, np.asarray(lens, np.int64))


def _fleet_program(spec, X, y, folds, final, draws, route, params0, lens) -> Dict[str, Any]:
    cfg = spec.train_cfg
    hp = adam_hparams(cfg)
    M, N, F = (int(s) for s in X.shape)
    Fo = int(y.shape[2])
    fit_rows = [np.asarray(tr) for tr, _ in folds] + ([np.arange(N)] if final else [])
    G = len(fit_rows)
    chain, (det_form, *det_stats) = _stats(spec, X, y, fit_rows)
    det_stats = tuple(t[:, 0] for t in det_stats)
    counts = None
    if lens is not None:
        # what the fits and the scorer read: the rows zero-filled (JAX's Xz,
        # yz), and only rows below each slot's count
        Xz = X.masked_fill(torch.isnan(X), 0.0)
        y = Xz if y is X else y.masked_fill(torch.isnan(y), 0.0)
        X = Xz
        counts = _suffix_counts(lens, fit_rows)
    draw = np.zeros(M, np.int64)
    perm_draw = None
    if params0 is not None:  # each machine its own params, every one the seed's permutations
        draw, perm_draw = np.arange(M), draw
    out: Dict[str, Any] = {
        "chain": chain,
        "steps": [(a, b) for _, a, b in chain],
        "det": (det_form,) + det_stats,
        "det_stats": det_stats,
    }
    if spec.window_mode != "none":
        L, off = spec.lookback, spec.offset
        dims, acts, out_act = lstm_chain_of(module_for(spec, F, Fo))
        fits = [window_fit(rows, cfg.batch_size, off) for rows in fit_rows]
        drawn, perms = put_lstm_draws(draws, spec.seed, dims, fits, cfg.epochs, X.device)
        if counts is not None:
            counts = np.clip(counts - off, 0, [fg.n_windows for fg in fits])
        cells, head, history = lstm_fit(
            X, y, fits, drawn if params0 is None else params0, perms, draw, acts, out_act, L, off,
            cfg.epochs, hp, route=route, perm_draw=perm_draw, counts=counts, chain=chain,
        )
        out.update(cells=cells, head=head, history=history)
    else:
        off = 0
        dims, acts = chain_of(module_for(spec, F, Fo))
        fits = [geometry(rows, cfg.batch_size) for rows in fit_rows]
        drawn, perms = put_draws(draws, spec.seed, dims, fits, cfg.epochs, X.device)
        layers, history = fleet_fit(
            X, y, fits, drawn if params0 is None else params0, perms, draw, acts, cfg.epochs, hp,
            perm_draw=perm_draw, counts=counts, chain=chain,
        )
        out.update(layers=layers, history=history)
    if not folds:
        return out

    # out-of-fold scoring: slot i * K + k is machine i's test rows of fold k,
    # scored by fit slot i * G + k
    K = len(folds)
    tests, nt, te_dev, idx, n_out = _test_slots(folds, G, M, off, X.device, lens)
    S = M * G
    x_oof = X.index_select(1, te_dev).reshape(M * K, nt, F)
    y_oof = y.index_select(1, te_dev).reshape(M * K, nt, Fo)
    # a slot with no real row (cv_epilogue gives it has = 0) is scored on one
    n_scored = None if n_out is None else np.maximum(n_out, 1)
    # each fit slot's stats (S, ...): slot i * G + g is machine i's fit g
    det = dict(det=(det_form,) + tuple(t[:, None].expand(M, G, Fo).reshape(S, Fo) for t in det_stats))
    chain_s = [(form, a.reshape(S, F), b.reshape(S, F)) for form, a, b in chain]
    if spec.window_mode != "none":
        h = x_oof
        for i, ((ki, kh, b), act) in enumerate(zip(cells, acts)):
            first = i == 0
            h = lstm_layer(
                h, ki.reshape(S, *ki.shape[2:]), kh.reshape(S, *kh.shape[2:]), b.reshape(S, -1),
                lookback=L, act=act, n_windows=nt - off if first else None,
                chain=chain_s if first else None,
                idx=idx, slot_windows=n_scored, last=i == len(cells) - 1,
            )
        W, bh = head
        scored = fleet_score(
            h, [(W.reshape(S, *W.shape[2:]), bh.reshape(S, Fo))], [out_act], **det,
            idx=idx, n_rows=n_scored, y=y_oof, y_offset=off,
        )
        y_true = y_oof[:, off:].contiguous()
    else:
        flat = [(W.reshape(S, W.shape[2], W.shape[3]), b.reshape(S, b.shape[2])) for W, b in layers]
        scored = fleet_score(
            x_oof, flat, acts, chain=chain_s, **det,
            idx=idx, n_rows=n_scored, y=y_oof,
        )
        y_true = y_oof
    pred = scored["model-output"]
    # pad-up groups take the masked epilogue (K8), exact groups K4
    epi = cv_epilogue(
        scored["tag-anomaly-scores"], scored["total-anomaly-score"], pred, y_true, n_out,
        masked=lens is not None,
    )
    has = epi["has"].reshape(M, K)
    out.update(
        feature_thresholds=_fold_mean(epi["feature_max"].reshape(M, K, Fo), has),
        aggregate_threshold=_fold_mean(epi["total_max"].reshape(M, K), has),
        metrics={name: epi[name].reshape(M, K) for name in METRIC_NAMES},
        predictions=pred.reshape(M, K, nt - off, Fo),
        test_rows=tests,
    )
    return out


def _fold_mean(x: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """The thresholds: each machine's mean of ``x`` (M, K, ...) over its
    folds with real rows (``has`` (M, K); in an exact group every fold),
    ``sum(x * has) / max(sum(has), 1)`` as ``fleet.padded`` takes it, the
    folds summed in order so that a machine's result does not depend on
    its group's size."""
    h = has.reshape(tuple(has.shape) + (1,) * (x.dim() - 2))
    total, count = x[:, 0] * h[:, 0], has[:, 0]
    for k in range(1, x.shape[1]):
        total, count = total + x[:, k] * h[:, k], count + has[:, k]
    return total / torch.clamp_min(count, 1.0).reshape(h[:, 0].shape)


def _test_slots(folds, G: int, M: int, offset: int, device, lens=None):
    """Out-of-fold slot ``i * K + k``: machine ``i``'s test rows of fold
    ``k`` (each fold's rows padded to the longest by repeating its last),
    scored by fit slot ``i * G + k``.  Returns ``(tests, nt, te_dev, idx,
    n_out)``: ``n_out`` each slot's rows of output past ``offset`` (with
    machine lengths ``lens``, those below the machine's length, from 0),
    or None when every slot has as many."""
    K = len(folds)
    tests = [np.asarray(te) for _, te in folds]
    sizes = np.array([len(te) for te in tests])
    if sizes.min() <= offset:
        raise ValueError(
            f"a test fold of {sizes.min()} rows has no window for a model of offset {offset}"
        )
    nt = int(sizes.max())
    te_idx = np.stack([np.pad(te, (0, nt - len(te)), mode="edge") for te in tests])
    te_dev = to_device(te_idx.reshape(-1), device)
    idx = (np.arange(M)[:, None] * G + np.arange(K)[None]).reshape(-1)
    if lens is not None:
        n_out = np.clip(_suffix_counts(lens, tests) - offset, 0, None).reshape(-1)
    else:
        n_out = np.tile(sizes - offset, M) if sizes.min() != nt else None
    return tests, nt, te_dev, idx, n_out


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


def lstm_slot_state(cells, head, i: int, slot: int) -> Dict[str, np.ndarray]:
    """The LSTM module's state of machine ``i``'s fit ``slot`` from stacked
    host cells ``[(kernel_i (M, G, ...), kernel_h, bias), ...]`` and head
    ``(W (M, G, H, Fo), b)``."""
    return lstm_state([tuple(t[i, slot] for t in cell) for cell in cells],
                      tuple(t[i, slot] for t in head))


# ---------------------------------------------------------------------------
# The fleet builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PendingGroup:
    """One length group's launched work + assembly context, and what was
    launched: the stacked host rows ``X``/``y`` (NaN past each machine's
    length ``lens`` in a pad-up group, whose ``lens`` is None otherwise),
    the ``folds`` and the ``warm`` params of its machines."""

    indices: List[int]
    out: Any
    m: int
    folds: List[Tuple[np.ndarray, np.ndarray]]
    t0: float
    X: np.ndarray
    y: np.ndarray
    lens: Optional[np.ndarray] = None
    warm: Optional[List[Dict[str, np.ndarray]]] = None
    pad_built: bool = False
    fetch_seconds: float = 0.0
    assemble_seconds: float = 0.0


class PendingFleetBuild:
    """A launched fleet build: every group's kernels are enqueued on the
    device, nothing fetched.  :meth:`collect` waits for the results,
    fetches them and assembles the detectors (idempotent)."""

    def __init__(self, builder: "FleetDiffBuilder", n: int, groups: List[_PendingGroup]):
        self._builder = builder
        self._n = n
        self.groups = groups
        self._detectors: Optional[List[DiffBasedAnomalyDetector]] = None
        self.fetch_seconds = 0.0
        self.assemble_seconds = 0.0

    def collect(self) -> List[DiffBasedAnomalyDetector]:
        """Detectors in the original ``Xs`` input order; repeat calls
        return the cached list."""
        if self._detectors is None:
            detectors: List[Optional[DiffBasedAnomalyDetector]] = [None] * self._n
            for g in self.groups:
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
    tests inject the JAX package's).  ``pad_lengths``: pad-up mode, as in
    the JAX package: machines are grouped by row count rounded up to a
    multiple of it and built by :func:`padded_fleet_program`, one group
    per padded length; machines it cannot take are built exactly
    (:meth:`_dispatch_padded`), and the padded groups' detectors carry
    ``pad_built_ = True``.
    """

    def __init__(
        self,
        spec: FleetSpec,
        cv: Any = None,
        pad_lengths: Optional[int] = None,
        device=None,
        draws: Draws = fleet_draws,
    ):
        self.spec = spec
        self.splitter = build_splitter(cv)
        self.pad_lengths = int(pad_lengths) if pad_lengths else None
        self.device = resolve_device(device)
        self.draws = draws

    def build(
        self,
        Xs: Sequence[np.ndarray],
        ys: Optional[Sequence[np.ndarray]] = None,
        warm_params: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    ) -> List[DiffBasedAnomalyDetector]:
        """Build detectors for ``Xs`` in input order (dispatch + collect).

        ``warm_params`` (one per machine, aligned with ``Xs``: the
        estimator's ``state_arrays()``, as ``arrays.npz`` keeps it under
        ``base_estimator.steps.1.``) makes every fit of a machine start
        from its previous params instead of the seed's draw, the
        incremental-refresh build; the permutations still come from the
        seed."""
        return self.dispatch(Xs, ys, warm_params=warm_params).collect()

    def dispatch(
        self,
        Xs: Sequence[np.ndarray],
        ys: Optional[Sequence[np.ndarray]] = None,
        warm_params: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    ) -> PendingFleetBuild:
        """Launch every group's kernels and return without waiting for
        them."""
        if ys is not None and len(ys) != len(Xs):
            raise ValueError(f"Got {len(Xs)} input series but {len(ys)} target series")
        if warm_params is not None and len(warm_params) != len(Xs):
            raise ValueError(f"Got {len(Xs)} input series but {len(warm_params)} warm-start param sets")
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
        if self.pad_lengths:
            self._dispatch_padded(Xs, ys, warm_params, groups)
        else:
            self._dispatch_exact_length_groups(Xs, ys, range(len(Xs)), groups, warm_params)
        return PendingFleetBuild(self, len(Xs), groups)

    def _dispatch_exact_length_groups(self, Xs, ys, idxs, groups: List[_PendingGroup],
                                      warm_params=None) -> None:
        """Group ``idxs`` by row count and launch the exact program per
        length group, appending the pending groups."""
        by_len: Dict[int, List[int]] = {}
        for i in idxs:
            by_len.setdefault(int(Xs[i].shape[0]), []).append(i)
        for group in by_len.values():
            X_g, _, _ = stack_rows([Xs[i] for i in group])
            y_g = X_g if ys is None else stack_rows([ys[i] for i in group])[0]
            warm = None if warm_params is None else [warm_params[i] for i in group]
            g = self._dispatch_group(X_g, y_g, warm=warm)
            g.indices = list(group)
            groups.append(g)

    def _dispatch_padded(self, Xs, ys, warm_params, groups: List[_PendingGroup]) -> None:
        """Pad-up mode (``gordo_tpu/parallel/anomaly.py:622-718``): group by
        row count rounded up to ``pad_lengths``, NaN-pad each machine's
        rows to its group's length, and launch the masked program once per
        group.  A group whose splitter yields a fold that is not one
        contiguous block, and machines shorter than the last test block's
        start plus the model's offset + 1, are built exactly instead, with
        the JAX package's warnings."""
        pad = self.pad_lengths
        offset = self.spec.offset
        by_pad: Dict[int, List[int]] = {}
        exact_fallback: List[int] = []
        for i, x in enumerate(Xs):
            by_pad.setdefault(-(-x.shape[0] // pad) * pad, []).append(i)
        for n_pad, idxs in list(by_pad.items()):
            folds = [(np.asarray(tr), np.asarray(te))
                     for tr, te in self.splitter.split(np.empty((n_pad, 1)))]
            contiguous = all(
                np.array_equal(idx, np.arange(idx[0], idx[-1] + 1))
                for tr, te in folds for idx in (tr, te)
            )
            if not contiguous:
                logger.warning(
                    "pad_lengths=%d: CV splitter %s yields non-contiguous "
                    "fold indices — pad-up mode requires contiguous blocks; "
                    "building the %d machine(s) at padded length %d through "
                    "the exact per-length path",
                    pad, type(self.splitter).__name__, len(idxs), n_pad,
                )
                exact_fallback.extend(idxs)
                del by_pad[n_pad]
                continue
            min_len = max(int(te[0]) for _, te in folds) + offset + 1
            short = [i for i in idxs if Xs[i].shape[0] < min_len]
            if short:
                logger.warning(
                    "pad_lengths=%d: %d machine(s) are shorter than %d rows "
                    "(their real rows would miss a CV test block at padded "
                    "length %d) — building them through the exact per-length "
                    "path instead",
                    pad, len(short), min_len, n_pad,
                )
                exact_fallback.extend(short)
                idxs = [i for i in idxs if i not in set(short)]
                if not idxs:
                    del by_pad[n_pad]
                    continue
                by_pad[n_pad] = idxs

        self._dispatch_exact_length_groups(Xs, ys, exact_fallback, groups, warm_params)
        for n_pad, idxs in by_pad.items():
            n_feat = Xs[idxs[0]].shape[1]
            X = np.full((len(idxs), n_pad, n_feat), np.nan, np.float32)
            lens = np.array([Xs[i].shape[0] for i in idxs], np.int64)
            for j, i in enumerate(idxs):
                X[j, : lens[j]] = Xs[i]
            y = X
            if ys is not None:
                y = np.full((len(idxs), n_pad, ys[idxs[0]].shape[1]), np.nan, np.float32)
                for j, i in enumerate(idxs):
                    y[j, : lens[j]] = ys[i]
            warm = None if warm_params is None else [warm_params[i] for i in idxs]
            g = self._dispatch_group(X, y, lens=lens, warm=warm)
            g.indices = list(idxs)
            groups.append(g)

    def _dispatch_group(self, X: np.ndarray, y: np.ndarray, lens=None, warm=None) -> _PendingGroup:
        """Launch one group's program (``lens``: the pad-up program;
        ``warm``: from each machine's params) without waiting for it."""
        t0 = time.time()
        folds = [
            (np.asarray(tr), np.asarray(te))
            for tr, te in self.splitter.split(np.empty((X.shape[1], 1)))
        ]
        params0 = None
        if warm is not None:
            dims = chain_dims(self.spec, X.shape[2], y.shape[2])
            params0 = stack_warm_params(warm, dims, self.device)
        X_dev = torch.from_numpy(X).to(self.device)
        y_dev = X_dev if y is X else torch.from_numpy(y).to(self.device)
        kw = dict(final=True, draws=self.draws, params0=params0)
        with torch.no_grad():
            if lens is None:
                out = exact_fleet_program(self.spec, X_dev, y_dev, folds, **kw)
            else:
                out = padded_fleet_program(self.spec, X_dev, y_dev, lens, folds, **kw)
        return _PendingGroup(indices=[], out=out, m=X.shape[0], folds=folds, t0=t0, X=X, y=y,
                             lens=lens, warm=warm, pad_built=lens is not None)

    def _collect_group(self, g: _PendingGroup) -> List[DiffBasedAnomalyDetector]:
        out = g.out
        K = len(g.folds)
        t0 = time.time()
        spec = self.spec
        host = {
            # each step's own stats under the reference's keys; fit slot K
            # is the final full-data fit, the only one kept
            "scaler_stats": [
                {k: t[:, K].cpu().numpy() for k, t in zip(proto.STAT_KEYS, leaves)}
                for proto, leaves in zip(spec.scaler_protos, out["steps"])
            ],
            "det_scaler_stats": {
                k: t.cpu().numpy() for k, t in zip(spec.detector_proto.scaler.STAT_KEYS, out["det_stats"])
            },
            "final_layers": [
                (W[:, K:].cpu().numpy(), b[:, K:].cpu().numpy()) for W, b in out["layers"]
            ] if "layers" in out else None,
            "final_cells": [
                tuple(t[:, K:].cpu().numpy() for t in cell) for cell in out["cells"]
            ] if "cells" in out else None,
            "final_head": tuple(t[:, K:].cpu().numpy() for t in out["head"]) if "head" in out else None,
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
        if g.pad_built:
            for det in detectors:
                det.pad_built_ = True
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
            if out["final_cells"] is not None:
                est.load_state_arrays(lstm_slot_state(out["final_cells"], out["final_head"], i, 0))
            else:
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
