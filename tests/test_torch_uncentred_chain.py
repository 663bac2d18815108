"""Scaler chains on uncentred columns: the port against the JAX package.

Real tags often sit far from zero against their spread (a pressure of
100 ± 1, a temperature in kelvin).  The reference applies each scaler step
in its own form, ``(x - mean) / std`` for a Standard step
(``gordo_tpu/parallel/anomaly.py::_make_apply_chain``); the port's fits,
scorer and stream apply the same steps in turn as their kernels load each
value (``gordo_tpu_torch/csrc/scaler_prefix.cuh``).  A chain folded into one
``x * (1 / std) + (-mean / std)`` cancels on such a column: its digits go
with the level.

Feedforward detectors (4 tags, 2 epochs, batch 64) of 4 machines × 160 rows
of ``torch_parity.sine_rows`` plus a constant level of 0, 1e2, 1e3 and
1e4, built on the CPU (the kernels' plain versions; the port from the JAX
package's draws):

- ``standard``: ``Pipeline[StandardScaler, AutoEncoder]`` with a
  ``StandardScaler`` detector scaler;
- ``robust``: ``Pipeline[RobustScaler, AutoEncoder]`` with a
  ``RobustScaler`` detector scaler;
- ``minmax_standard``: ``Pipeline[MinMaxScaler, StandardScaler,
  AutoEncoder]`` with a ``StandardScaler`` detector scaler.

Held, per output array, ``max|ref - port| / max|ref|`` (``r12``):

- a JAX-built detector carried across (``torch_parity.carry``) serves
  ``model-output``, ``tag-anomaly-scores`` and ``total-anomaly-score``
  within the serving bound of 1e-5 of the JAX package's scorer at f32;
- a detector built by both packages: params, history, thresholds, CV
  mse/mae/r2 and the anomaly outputs within 1e-5; CV explained variance
  within 1e-5 in absolute terms (the CV metrics compare raw targets with
  the model's scaled output, so each fold's EV sits near 0 on an
  uncentred column: ROADMAP queue 3, "CV explained variance near zero");
- a carried detector's streamed verdicts within 1e-5 of the JAX
  package's ``MachineStream``.

At level 1e4 the serving and streaming hold for every chain; the builds
hold without their CV scores for the Standard and Robust chains, and not
for the chain with a MinMax step first (``BUILD_CASES``, ``BUILD_1E4``).
The stats match the reference's roundings: the Standard statistic sums in
XLA:CPU's window order and Robust's interpolation is XLA's FMA (another
order moved the mean by 2 ulp of the level, the separate roundings
Robust's scale by 6e-5 at level 1e3).

With the chain folded (the port before the steps were applied in turn)
the carried Standard detector served a ``model-output`` 1.2e-4 off at
level 1e3 (ROADMAP queue 3 records the measured errors at every level).
"""

import jax
import numpy as np
import pytest

from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.parallel.anomaly import FleetDiffBuilder as JaxBuilder
from gordo_tpu.parallel.anomaly import analyze_definition as jax_analyze
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.serve.stream import MachineStream as JaxMachineStream
from gordo_tpu_torch.kernels import cv_epilogue as ce
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.stream import MachineStream
from torch_parity import carry, init_detector, jax_draws, port_params, r12, sine_rows

TAGS, MACHINES, ROWS = 4, 4, 160
LEVELS = (0.0, 1e2, 1e3, 1e4)
TOL = 1e-5
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score")
SCALERS = "gordo_tpu.ops.scalers"


def definition(steps, detector_scaler):
    estimator = {"gordo_tpu.models.estimator.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 2, "batch_size": 64}}
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "scaler": detector_scaler,
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [*steps, estimator]}}}}


DEFINITIONS = {
    "standard": definition([f"{SCALERS}.StandardScaler"], f"{SCALERS}.StandardScaler"),
    "robust": definition([f"{SCALERS}.RobustScaler"], f"{SCALERS}.RobustScaler"),
    "minmax_standard": definition([f"{SCALERS}.MinMaxScaler", f"{SCALERS}.StandardScaler"],
                                  f"{SCALERS}.StandardScaler"),
}
CASES = [(name, level) for name in DEFINITIONS for level in LEVELS]
#: every level's build with its CV scores: the CV epilogue sums in
#: XLA:CPU's window order (before it did, the raw targets' sums of squares
#: at level 1e4 moved r2 by 3.2e-5 and explained variance by 5.9e-5), and
#: a MinMax step is one FMA before the stats and in the fits, as XLA's
#: fleet program fuses it (before, the MinMax-then-Standard build's model
#: output was 6.4e-5 off at level 1e4)
BUILD_CASES = CASES


def inputs(level: float):
    rng = np.random.default_rng(73)
    return [sine_rows(rng, ROWS, TAGS, phase=0.6 * i) + np.float32(level) for i in range(MACHINES)]


@pytest.fixture(scope="module")
def builds():
    """``(name, level) -> (Xs, JAX-built detectors, port-built detectors)``,
    built on first use."""
    cache = {}

    def get(name, level):
        if (name, level) not in cache:
            Xs = inputs(level)
            d = DEFINITIONS[name]
            ref = JaxBuilder(jax_analyze(jax_from_definition(d))).build(Xs)
            got = FleetDiffBuilder(analyze_definition(from_definition(d)), device="cpu",
                                   draws=jax_draws).build(Xs)
            cache[name, level] = (Xs, ref, got)
        return cache[name, level]

    return get


def request(X):
    return X[::-1][:60].copy()


@pytest.mark.parametrize("name,level", CASES)
def test_carried_jax_detector_serves_like_jax(builds, name, level):
    Xs, ref, _ = builds(name, level)
    X = request(Xs[1])
    want = JaxScorer(ref[1], dtype="float32").anomaly_arrays(X)
    got = CompiledScorer(carry(ref[1]), device="cpu", dtype="float32").anomaly_arrays(X)
    for key in OUTPUTS:
        assert r12(np.asarray(want[key]), got[key]) <= TOL, (key, r12(np.asarray(want[key]), got[key]))


def assert_same_build(Xs, refs, gots, cv_scores: bool = True):
    for i, (ref, got) in enumerate(zip(refs, gots)):
        what = f"machine {i}"
        params = port_params(got.base_estimator._final)
        for layer, leaf in jax.tree.map(np.asarray, ref.base_estimator._final.params_).items():
            for key in ("kernel", "bias"):
                if np.any(leaf[key]):
                    assert r12(leaf[key], params[layer][key]) <= TOL, (what, layer, key)
        assert r12(ref.base_estimator._final.history_, got.base_estimator._final.history_) <= TOL, what
        assert r12(ref.feature_thresholds_, got.feature_thresholds_) <= TOL, what
        assert r12(ref.aggregate_threshold_, got.aggregate_threshold_) <= TOL, what
        for metric in ce.METRIC_NAMES if cv_scores else ():
            want = np.asarray(ref.cv_metadata_["scores"][metric]["folds"], np.float64)
            have = np.asarray(got.cv_metadata_["scores"][metric]["folds"], np.float64)
            if metric == "explained_variance_score":
                assert float(np.abs(want - have).max()) <= TOL, (what, metric)
            else:
                assert r12(want, have) <= TOL, (what, metric)
        X = request(Xs[i])
        want = JaxScorer(ref, dtype="float32").anomaly_arrays(X)
        have = CompiledScorer(got, device="cpu", dtype="float32").anomaly_arrays(X)
        for key in OUTPUTS:
            assert r12(np.asarray(want[key]), have[key]) <= TOL, (what, key)


@pytest.mark.parametrize("name,level", BUILD_CASES)
def test_build_matches_jax(builds, name, level):
    assert_same_build(*builds(name, level))


@pytest.mark.parametrize("name,level", CASES)
def test_streamed_verdicts_match_jax(builds, name, level):
    Xs, ref, _ = builds(name, level)
    jax_ms = JaxMachineStream("s", JaxScorer(ref[2], dtype="float32"))
    ms = MachineStream("s", CompiledScorer(carry(ref[2]), device="cpu", dtype="float32"))
    refs, gots = [], []
    for row in request(Xs[2])[:30]:
        r, g = jax_ms.ingest(row), ms.ingest(row)
        assert (r is None) == (g is None)
        if r is not None:
            refs.append(r)
            gots.append(g)
    assert len(gots) == 30
    for key in refs[0]:
        want = np.stack([np.atleast_1d(r[key]) for r in refs])
        have = np.stack([np.atleast_1d(g[key]) for g in gots])
        assert r12(want, have) <= TOL, key


def test_stats_after_a_minmax_step_are_fleet_exact_s(builds):
    """At level 1e4 the Standard step after a MinMax step takes its stats
    on the MinMax step's output, which XLA's fleet program computes as one
    FMA: every machine's stats of both steps are ``fleet.exact``'s bit for
    bit (with the MinMax step rounded twice the mean was up to 471 ulp off
    and the std up to 992)."""
    _, refs, gots = builds("minmax_standard", 1e4)
    for i, (ref, got) in enumerate(zip(refs, gots)):
        ref_steps = [step for _, step in ref.base_estimator.steps[:-1]]
        got_steps = [step for _, step in got.base_estimator.steps[:-1]]
        for j, (r, g) in enumerate(zip(ref_steps, got_steps)):
            for key, leaf in r.stats_.items():
                want = np.asarray(leaf, np.float32)
                have = np.asarray(g.stats_[key], np.float32)
                assert want.tobytes() == have.tobytes(), (i, j, key, want, have)


def test_lstm_behind_a_minmax_step_serves_like_jax_at_level_1e4():
    """An LSTM detector (lookback 4, one encoding layer) behind a MinMax
    step on tags at a level of 1e4, carried across and served: its first
    LSTM layer takes the MinMax step as one FMA, as the JAX package's
    ``serve.score`` program fuses it into the windows' gather."""
    rng = np.random.default_rng(29)
    X = sine_rows(rng, 160, TAGS) + np.float32(1e4)
    ref = init_detector(JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=4, encoding_layers=1),
                        X, rng, seed=3)
    R = request(X)
    want = JaxScorer(ref, dtype="float32").anomaly_arrays(R)
    got = CompiledScorer(carry(ref), device="cpu", dtype="float32").anomaly_arrays(R)
    for key in OUTPUTS:
        assert r12(np.asarray(want[key]), got[key]) <= TOL, (key, r12(np.asarray(want[key]), got[key]))
