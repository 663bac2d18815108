"""The port's pad-up and warm fleet builds of the default detector against
the JAX package's.

Five machines of 4 tags at 140, 162, 170, 185 and 203 rows are built with
``pad_lengths=64`` by ``gordo_tpu.parallel.anomaly.FleetDiffBuilder`` and
by the port's, on the CPU (the kernels' plain versions), the port from the
JAX package's initial params and epoch permutations
(``tests/torch_parity.py``).  That makes two padded groups (192 rows:
162, 170, 185; 256 rows: 203) and demotes the 140-row machine to the exact
path (``TimeSeriesSplit(3)`` at 192 rows tests from row 144 on).  Then both
build warm from the JAX cold build's params: the padded groups through
``fleet.padded_warm``, the demoted machine through ``fleet.exact_warm``.
Bounds, per machine and output series, ``max|ref - port| / max|ref|``, as
``tests/test_torch_fleet_build.py`` states them: stats 1e-6 (measured
0); params, history, thresholds, mse, mae and r2 1e-5 (measured on the
CPU, cold and warm, <= 6.2e-7); explained variance 1e-4 (measured
<= 3.4e-6).  The
masked metrics of the JAX package are its row-weighted ones, the port's
are ``cv_epilogue`` over each slot's real rows (a suffix mask): the same
function, summed in another order.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.parallel.anomaly import FleetDiffBuilder as JaxBuilder
from gordo_tpu.parallel.anomaly import analyze_definition as jax_analyze
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu_torch import convert
from gordo_tpu_torch.kernels import cv_epilogue as ce
from gordo_tpu_torch.kernels import fleet_fit as ff
from gordo_tpu_torch.ops import metrics as tmetrics
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.train import fit as tfit
from test_torch_fleet_build import EV_TOL, FIT_TOL, TAGS, assert_same_detector, definition
from torch_parity import jax_draws, port_params, r12, sine_rows

LENGTHS = (140, 162, 170, 185, 203)
PAD = 64
DEMOTED = 0


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(23)
    return [sine_rows(rng, n, TAGS, phase=0.3 * i) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def builds(inputs):
    """The JAX and the port's builds, cold then warm from the JAX cold
    build's params."""
    spec_j = jax_analyze(jax_from_definition(definition()))
    spec_p = analyze_definition(from_definition(definition()))
    jax_cold = JaxBuilder(spec_j, pad_lengths=PAD).build(inputs)
    port_cold = FleetDiffBuilder(spec_p, pad_lengths=PAD, device="cpu", draws=jax_draws).build(inputs)
    warm = [jax.tree.map(np.asarray, d.base_estimator._final.params_) for d in jax_cold]
    jax_warm = JaxBuilder(spec_j, pad_lengths=PAD).build(inputs, warm_params=warm)
    port_warm = FleetDiffBuilder(spec_p, pad_lengths=PAD, device="cpu", draws=jax_draws).build(
        inputs, warm_params=[convert.flax_to_state_arrays(p) for p in warm])
    return {"cold": (jax_cold, port_cold), "warm": (jax_warm, port_warm)}


@pytest.mark.parametrize("kind,machine", [(k, i) for k in ("cold", "warm") for i in range(len(LENGTHS))])
def test_padded_build_matches_jax(builds, kind, machine):
    ref, got = builds[kind][0][machine], builds[kind][1][machine]
    assert getattr(got, "pad_built_", False) == (machine != DEMOTED)
    assert getattr(ref, "pad_built_", False) == (machine != DEMOTED)
    assert np.isfinite(got.feature_thresholds_).all() and got.feature_thresholds_.min() > 0
    assert_same_detector(ref, got, f"{kind} machine {machine}")


def test_warm_build_starts_from_the_given_params(builds):
    # a warm fit resumes where the cold one ended: its first epoch's loss
    # is below the cold fit's first
    for (ref_c, got_c), (ref_w, got_w) in zip(zip(*builds["cold"]), zip(*builds["warm"])):
        assert got_w.base_estimator._final.history_[0] < got_c.base_estimator._final.history_[0]
        assert r12(ref_w.base_estimator._final.history_, got_w.base_estimator._final.history_) <= FIT_TOL


def test_padded_groups_dispatch_one_program_each(inputs, monkeypatch):
    from gordo_tpu_torch.parallel import anomaly

    calls = []
    original = anomaly.FleetDiffBuilder._dispatch_group

    def counting(self, X, y, lens=None, warm=None):
        calls.append((X.shape[:2], None if lens is None else sorted(lens.tolist())))
        return original(self, X, y, lens=lens, warm=warm)

    monkeypatch.setattr(anomaly.FleetDiffBuilder, "_dispatch_group", counting)
    spec = analyze_definition(from_definition(definition()))
    FleetDiffBuilder(spec, pad_lengths=PAD, device="cpu").build(inputs)
    assert sorted(calls, key=str) == sorted(
        [((1, 140), None), ((3, 192), [162, 170, 185]), ((1, 256), [203])], key=str)


def test_aligned_padded_build_equals_exact_bit_for_bit(inputs, monkeypatch):
    # every machine at a multiple of pad_lengths: all-ones masks, the same
    # folds and geometry as the exact build, so the same kernels' results;
    # the CV scores are the weighted metrics of fleet.padded (K8) over the
    # exact build's out-of-fold predictions, bit for bit, where the exact
    # build's are fleet.exact's (K4: another order of the same sums)
    from gordo_tpu_torch.parallel import anomaly

    Xs = [x[:128] for x in inputs] + [inputs[4][64:192]]
    spec = analyze_definition(from_definition(definition()))
    padded = FleetDiffBuilder(spec, pad_lengths=PAD, device="cpu").build(Xs)
    groups = []
    collect = anomaly.FleetDiffBuilder._collect_group
    monkeypatch.setattr(anomaly.FleetDiffBuilder, "_collect_group",
                        lambda self, g: groups.append(g.out) or collect(self, g))
    exact = FleetDiffBuilder(spec, device="cpu").build(Xs)
    (out,) = groups
    for i, (p, e) in enumerate(zip(padded, exact)):
        assert p.pad_built_ and not getattr(e, "pad_built_", False)
        np.testing.assert_array_equal(p.feature_thresholds_, e.feature_thresholds_)
        assert p.aggregate_threshold_ == e.aggregate_threshold_
        for k, rows in enumerate(out["test_rows"]):
            y = torch.from_numpy(np.ascontiguousarray(Xs[i][rows]))[None]
            pred = out["predictions"][i, k][None]
            want = ce.fold_metrics(y, pred, len(rows), masked=True)
            for name in ce.METRIC_NAMES:
                assert p.cv_metadata_["scores"][name]["folds"][k] == float(want[name][0]), (i, k, name)
        np.testing.assert_array_equal(p.base_estimator._final.history_, e.base_estimator._final.history_)
        for name, leaf in port_params(e.base_estimator._final).items():
            for key in ("kernel", "bias"):
                np.testing.assert_array_equal(port_params(p.base_estimator._final)[name][key], leaf[key])


def test_shuffled_kfold_is_demoted_with_the_jax_warning(inputs, caplog):
    from sklearn.model_selection import KFold

    spec = analyze_definition(from_definition(definition()))
    builder = FleetDiffBuilder(spec, cv=KFold(n_splits=3, shuffle=True, random_state=0),
                               pad_lengths=PAD, device="cpu")
    with caplog.at_level(logging.WARNING, logger="gordo_tpu_torch.parallel.anomaly"):
        detectors = builder.build(inputs[1:3])
    assert any("non-contiguous" in r.message and "exact per-length path" in r.message
               for r in caplog.records)
    for det in detectors:
        assert not getattr(det, "pad_built_", False)
        assert np.isfinite(det.feature_thresholds_).all()


def test_short_machine_is_demoted_with_the_jax_warning(inputs, caplog):
    spec = analyze_definition(from_definition(definition()))
    with caplog.at_level(logging.WARNING, logger="gordo_tpu_torch.parallel.anomaly"):
        det = FleetDiffBuilder(spec, pad_lengths=PAD, device="cpu").build(inputs[:1])[0]
    assert any("shorter than 145 rows" in r.message for r in caplog.records)
    alone = FleetDiffBuilder(spec, device="cpu").build(inputs[:1])[0]
    np.testing.assert_array_equal(det.feature_thresholds_, alone.feature_thresholds_)


def test_mismatched_warm_leaf_raises(inputs, builds):
    spec = analyze_definition(from_definition(definition()))
    states = [d.base_estimator._final.state_arrays() for d in builds["cold"][1]]
    states[2] = dict(states[2], **{"dense_0.weight": np.zeros((7, TAGS), np.float32)})
    for pad in (None, PAD):
        with pytest.raises(ValueError, match="leaf signature"):
            FleetDiffBuilder(spec, pad_lengths=pad, device="cpu").build(inputs, warm_params=states)
    with pytest.raises(ValueError, match="warm-start param sets"):
        FleetDiffBuilder(spec, device="cpu").build(inputs, warm_params=states[:2])


def test_weighted_metrics_match_jax_and_the_epilogue():
    from gordo_tpu.ops.metrics import WEIGHTED_METRICS

    rng = np.random.default_rng(5)
    y = rng.standard_normal((3, 40, TAGS)).astype(np.float32)
    p = (y + 0.2 * rng.standard_normal(y.shape)).astype(np.float32)
    counts = np.array([40, 17, 0])
    w = (np.arange(40)[None] < counts[:, None]).astype(np.float32)
    tag = np.abs(p - y)
    epi = ce.cv_epilogue_plain(torch.from_numpy(tag), torch.from_numpy(np.linalg.norm(tag, axis=-1)),
                               torch.from_numpy(p), torch.from_numpy(y), counts)
    np.testing.assert_array_equal(epi["has"].numpy(), [1, 1, 0])
    assert not epi["feature_max"][2].any() and epi["total_max"][2] == 0
    for name, fn in WEIGHTED_METRICS.items():
        ref = np.array([float(fn(y[i], p[i], w[i])) for i in range(3)])
        got = tmetrics.WEIGHTED_METRICS[name](y, p, w).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
        tol = EV_TOL if name == "explained_variance_score" else FIT_TOL
        assert r12(ref, epi[name].numpy()) <= tol, name
    assert [float(epi[n][2]) for n in ce.METRIC_NAMES] == [1.0, 1.0, 0.0, 0.0]


def test_all_padding_minibatch_takes_a_zero_gradient_adam_step(monkeypatch):
    # machine 1's fit has 3 real rows of 8; with batches of 4 and the
    # identity permutation its second minibatch is padding alone
    rng = np.random.default_rng(9)
    X = torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(np.float32))
    dims, acts = [3, 2, 3], ["tanh", None]
    params0 = [(torch.from_numpy(rng.standard_normal((1, a, b)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((1, b)).astype(np.float32)))
               for a, b in zip(dims[:-1], dims[1:])]
    fits = [ff.geometry(np.arange(8), 4)]
    perms = torch.from_numpy(ff.pack_perms([np.arange(8)[None, None]]))
    hp = tfit.adam_hparams(tfit.TrainConfig())
    steps = []
    original = tfit.adam_update

    def recording(param, grad, mu, nu, count, hp_):
        out = original(param, grad, mu, nu, count, hp_)
        steps.append((param, grad, mu, nu, count, out))
        return out

    monkeypatch.setattr(tfit, "adam_update", recording)
    layers, history = ff.fleet_fit(X, X, fits, params0, perms, [0, 0], acts, 1, hp, counts=[[8], [3]])
    second = [s for s in steps if s[4] == 2]
    assert len(second) == 2 * len(dims) - 2
    for param, grad, mu, nu, count, (new_p, _, _) in second:
        assert not grad[1].any()
        want, _, _ = original(param[1], torch.zeros_like(param[1]), mu[1], nu[1], 2, hp)
        torch.testing.assert_close(new_p[1], want, rtol=0, atol=0)
        assert not torch.equal(new_p[1], param[1])
    assert torch.isfinite(history).all()


@pytest.mark.parametrize("masked", [True, False], ids=["K8-masked", "K4-exact"])
def test_non_finite_maximum_matches_jax(masked):
    """A pad-up fit that diverges (a too high learning rate) gives NaN
    errors on real rows: the masked epilogue (K8) maps such a slot's
    non-finite maximum to 0, as ``_masked_smoothed_max`` does, and the
    exact one (K4) keeps NaN, as ``_smoothed_max`` does.  Held exactly (a
    min and a max, no arithmetic): measured 0 difference."""
    from gordo_tpu.parallel.anomaly import SMOOTHING_WINDOW, _masked_smoothed_max, _smoothed_max

    rng = np.random.default_rng(9)
    S, nt = 4, 30
    y = rng.standard_normal((S, nt, TAGS)).astype(np.float32)
    p = (y + 0.2 * rng.standard_normal(y.shape)).astype(np.float32)
    p[0, 3:20] = np.nan  # every window of every tag reaches a NaN row
    p[1, :, 1] = np.nan  # one tag NaN throughout
    p[2, 4, 2] = np.inf
    tag = np.abs(p - y)
    total = np.sqrt((tag * tag).sum(-1)).astype(np.float32)
    counts = np.array([nt, 12, nt, 7]) if masked else np.full(S, nt)
    epi = ce.cv_epilogue_plain(*(torch.from_numpy(a) for a in (tag, total, p, y)), counts, masked=masked)
    for s in range(S):
        if masked:
            mask = (np.arange(nt) < counts[s]).astype(np.float32)
            ref_f = _masked_smoothed_max(tag[s], mask)
            ref_t = _masked_smoothed_max(total[s][:, None], mask)[0]
        else:
            ref_f = _smoothed_max(tag[s], SMOOTHING_WINDOW)
            ref_t = _smoothed_max(total[s][:, None], SMOOTHING_WINDOW)[0]
        np.testing.assert_array_equal(epi["feature_max"][s].numpy(), np.asarray(ref_f))
        np.testing.assert_array_equal(epi["total_max"][s].numpy(), np.asarray(ref_t))
    assert bool(np.isnan(epi["feature_max"][0].numpy()).all()) != masked
    assert (float(epi["total_max"][1]) == 0.0) == masked
