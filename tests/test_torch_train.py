"""The port's training pieces against the JAX package, on the CPU.

Every case feeds both packages the same seeded numpy inputs; the port's
fits start from the JAX package's initial params and epoch permutations
(``tests/torch_parity.py``).  Bounds use the repo's parity metric,
``max|ref - port| / max|ref|`` per machine and output series:

- fits (loss history, final params): 1e-5.  The port's plain fit follows
  ``make_fit_fn`` op for op; only the order of the sums inside a matmul
  differs from XLA's, and Adam divides by ``sqrt(nu)``, which amplifies
  that where gradients are small.  Measured on this container: <= 3.3e-7
  on params, <= 1.3e-7 on the history.
- MinMax stats: 1e-6 (measured 0: the same min, max and two roundings).
- smoothed maxima: 0 (a min and a max are exact); metrics: 1e-5
  (measured <= 4e-7, float32 means taken in another order).
"""

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder
from gordo_tpu.ops import metrics as jmetrics
from gordo_tpu.ops.scalers import MinMaxScaler as JaxMinMax
from gordo_tpu.parallel.anomaly import _smoothed_max
from gordo_tpu.train import cv as jcv
from gordo_tpu.train.fit import TrainConfig as JaxTrainConfig
from gordo_tpu_torch.kernels import cv_epilogue as ce
from gordo_tpu_torch.kernels import fleet_fit as ff
from gordo_tpu_torch.kernels.scaler_stats import scaler_stats
from gordo_tpu_torch.models.estimator import AutoEncoder
from gordo_tpu_torch.ops import metrics as tmetrics
from gordo_tpu_torch.ops.scalers import MinMaxScaler
from gordo_tpu_torch.train import cv as tcv
from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams, batch_geometry
from torch_parity import jax_draws, port_params, r12, sine_rows

FIT_TOL = 1e-5
STATS_TOL = 1e-6
METRIC_TOL = 1e-5
TAGS = 4


# -- (a) a fit, step for step ------------------------------------------------

@pytest.mark.parametrize(
    "n,epochs,batch_size,targets",
    [
        (150, 3, 64, "x"),   # 3 batches, 42 padded rows
        (150, 2, 32, "y"),   # 5 batches, 10 padded rows, y != X
        (40, 2, 256, "x"),   # one batch of all 40 rows
    ],
)
def test_fit_matches_jax(n, epochs, batch_size, targets):
    rng = np.random.default_rng(n + epochs)
    X = sine_rows(rng, n, TAGS)
    y = X if targets == "x" else (0.5 * X + 0.1).astype(np.float32)
    kw = dict(kind="feedforward_hourglass", epochs=epochs, batch_size=batch_size)
    ref = JaxAutoEncoder(**kw).fit(X, y)
    port = AutoEncoder(**kw).fit(X, y, device="cpu", draws=jax_draws)
    assert port.history_.shape == (epochs,)
    assert r12(ref.history_, port.history_) <= FIT_TOL
    ref_params = jax.tree.map(np.asarray, ref.params_)
    got = port_params(port)
    assert set(got) == set(ref_params)
    for name, leaf in ref_params.items():
        for key in ("kernel", "bias"):
            assert got[name][key].shape == leaf[key].shape
            if np.any(leaf[key]):
                assert r12(leaf[key], got[name][key]) <= FIT_TOL, (name, key)


def test_train_config_and_geometry_match_jax():
    kwargs = {"epochs": 4, "batch_size": 32, "optimizer_kwargs": {"b1": 0.8}, "kind": "x"}
    ref_cfg, ref_rest = JaxTrainConfig.from_kwargs(dict(kwargs))
    cfg, rest = TrainConfig.from_kwargs(dict(kwargs))
    assert (cfg.epochs, cfg.batch_size, cfg.optimizer_kwargs) == (
        ref_cfg.epochs, ref_cfg.batch_size, ref_cfg.optimizer_kwargs
    )
    assert rest == ref_rest
    from gordo_tpu.train.fit import batch_geometry as jax_geometry

    for n, bs in ((1, 256), (144, 256), (576, 256), (150, 64), (64, 64)):
        assert batch_geometry(n, bs) == jax_geometry(n, bs)
    assert adam_hparams(cfg) == {"lr": 1e-3, "b1": 0.8, "b2": 0.999, "eps": 1e-8}


@pytest.mark.parametrize(
    "cfg",
    [
        TrainConfig(loss="mae"),
        TrainConfig(optimizer="sgd"),
        TrainConfig(shuffle=False),
        TrainConfig(optimizer_kwargs=(("nesterov", True),)),
    ],
)
def test_untrained_options_raise(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        adam_hparams(cfg)


def test_wide_fleet_fit_is_refused():
    # the 128-tag hourglass: 60,558 weights and their Adam moments
    dims = [128, 107, 85, 64, 64, 85, 107, 128]
    with pytest.raises(NotImplementedError, match="wide fleet fit"):
        ff.launch_plan(dims, 256)
    plan = ff.launch_plan([10, 8, 7, 5, 5, 7, 8, 10], 256)
    assert plan.threads == 256 and plan.row_stride % 4 == 0 and plan.warp_partials


# -- (b) MinMax stats (K3) ---------------------------------------------------

def test_minmax_stats_match_jax_with_nan_columns():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((2, 60, 5)).astype(np.float32) * 3
    X[0, ::4, 1] = np.nan       # NaN in some rows of one column
    X[1, :, 3] = np.nan         # an all-NaN column
    X[0, :, 4] = 2.5            # a constant column (span floored at 1e-12)
    row_lists = [np.arange(20), np.arange(60), np.array([5, 1, 40, 41, 59])]
    for feature_range in ((0, 1), (-1, 1)):
        scale, offset = scaler_stats(torch.from_numpy(X), row_lists, feature_range)
        for i in range(2):
            for g, rows in enumerate(row_lists):
                with np.errstate(all="ignore"):
                    ref = JaxMinMax.compute_stats(X[i, rows], feature_range=feature_range)
                for key, got in (("scale", scale), ("offset", offset)):
                    want = np.asarray(ref[key])
                    have = got[i, g].numpy()
                    np.testing.assert_array_equal(np.isnan(want), np.isnan(have))
                    ok = ~np.isnan(want)
                    assert r12(want[ok], have[ok]) <= STATS_TOL, (i, g, key)
    assert torch.isnan(scale[1, 1, 3]) and torch.isnan(offset[1, 1, 3])


def test_minmax_fit_matches_jax():
    rng = np.random.default_rng(4)
    X = rng.uniform(-5, 5, (80, 6)).astype(np.float32)
    ref = JaxMinMax(feature_range=(-1, 1)).fit(X)
    port = MinMaxScaler(feature_range=(-1, 1)).fit(X, device="cpu")
    for key in ("scale", "offset"):
        assert r12(np.asarray(ref.stats_[key]), port.stats_[key]) <= STATS_TOL
    assert r12(np.asarray(ref.transform(X)), port.transform(X)) <= STATS_TOL


# -- (c) smoothed maxima and metrics (K4) ------------------------------------

def _epilogue_inputs(rng, slots, nt, fo):
    tag = rng.uniform(0, 2, (slots, nt, fo)).astype(np.float32)
    total = np.sqrt((tag ** 2).sum(-1)).astype(np.float32)
    y = rng.standard_normal((slots, nt, fo)).astype(np.float32)
    pred = (y + 0.3 * rng.standard_normal((slots, nt, fo))).astype(np.float32)
    return tag, total, pred, y


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 40])
def test_epilogue_matches_jax(n):
    rng = np.random.default_rng(n)
    tag, total, pred, y = _epilogue_inputs(rng, 3, n, 4)
    # slot 1 reads only its first rows; the rest is garbage it must ignore
    rows = [n, max(1, n - 1), n]
    tag[1, rows[1]:] = np.nan
    out = ce.cv_epilogue(*map(torch.from_numpy, (tag, total, pred, y)), n_rows=rows)
    for s, k in enumerate(rows):
        want_feat = np.asarray(_smoothed_max(tag[s, :k], ce.SMOOTHING_WINDOW))
        want_total = np.asarray(_smoothed_max(total[s, :k, None], ce.SMOOTHING_WINDOW))[0]
        np.testing.assert_array_equal(out["feature_max"][s].numpy(), want_feat)
        assert float(out["total_max"][s]) == float(want_total)
        for name in ce.METRIC_NAMES:
            want = float(getattr(jmetrics, name)(y[s, :k], pred[s, :k]))
            assert abs(float(out[name][s]) - want) <= METRIC_TOL * max(abs(want), 1.0), name


def test_epilogue_window_edge_and_nan():
    # a low value in row 0 must not reach rows 6+ (the window is 6 rows,
    # and it never reaches before row 0); a NaN poisons its windows
    tag = np.ones((2, 12, 1), np.float32)
    tag[:, 0] = 0.0
    tag[:, 6:] = 5.0
    tag[1, 9] = np.nan
    total = tag[..., 0].copy()
    pred = np.zeros_like(tag)
    out = ce.cv_epilogue(*map(torch.from_numpy, (tag, total, pred, tag.copy())))
    assert float(out["feature_max"][0, 0]) == 5.0
    assert np.isnan(float(out["feature_max"][1, 0]))
    for s in range(2):
        ref = np.asarray(_smoothed_max(tag[s], ce.SMOOTHING_WINDOW))
        np.testing.assert_array_equal(out["feature_max"][s].numpy(), ref)


@pytest.mark.parametrize("name", sorted(tmetrics.METRICS))
def test_metrics_match_jax(name):
    rng = np.random.default_rng(9)
    y = rng.standard_normal((50, 3)).astype(np.float32)
    p = (y + 0.2 * rng.standard_normal((50, 3))).astype(np.float32)
    y[:, 2] = 1.0  # a constant column: the 1e-12 floor
    want = float(getattr(jmetrics, name)(y, p))
    got = float(getattr(tmetrics, name)(y, p))
    assert abs(got - want) <= METRIC_TOL * max(abs(want), 1.0)


# -- splitters (numpy, carried over whole) -----------------------------------

@pytest.mark.parametrize(
    "cv", [None, {"TimeSeriesSplit": {"n_splits": 4}}, {"sklearn.model_selection.KFold": {"n_splits": 3}}]
)
def test_splitters_match_jax(cv):
    X = np.empty((103, 2))
    ref = list(jcv.build_splitter(cv).split(X))
    got = list(tcv.build_splitter(cv).split(X))
    assert len(got) == len(ref)
    for (a, b), (c, d) in zip(ref, got):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
