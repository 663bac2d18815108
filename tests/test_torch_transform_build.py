"""Detectors with SimpleImputer, PCA, QuantileTransformer and
FunctionTransformer steps, built by both packages on the CPU.

Chain A is ``SimpleImputer(median) → FunctionTransformer(multiplier,
factor 2) → PCA(8) → MinMaxScaler → AutoEncoder``; chain B is
``QuantileTransformer(100, normal) → AutoEncoder``, and B-uniform the same
with a uniform output.  The fleet engine takes none of them: both
packages cross-validate them through the generic fold loop (the port's
fold fits draw their params and permutations from the JAX package's
threefry keys, K11) and score each fold through the detector scaler, the
port in one ``chain_apply`` and one ``fleet_score`` request.  The rows the
detectors fit are NaN-free (a NaN in the fit rows gives NaN thresholds on
both sides); the rows they score carry NaN cells.  Each detector at 240
rows × 10 tags of correlated signals (``correlated_rows``: PCA's leading
singular values well apart), 2 epochs; a 2-machine RandomDataset project
YAML through both packages' ``build_project`` singles pass.

Bounds, per array, ``max|ref - port| / max|ref|`` over the non-NaN
values, NaN where the reference has NaN (``test_torch_transforms.py``
holds the steps themselves): each step's stats as there (the grids and
fills bit for bit, PCA's mean 1e-6 and components 1e-5); params,
thresholds and outputs 1e-5; explained variance 1e-4 and the other CV
scores 1e-3; the out-of-fold predictions, which the CV scores are taken
from, at the CV bound.  Measured (chains A, B, B-uniform): PCA's mean 0
and components 6.5e-7, MinMax after PCA 8.4e-7, params 1.9e-6,
thresholds 1.3e-7, CV scores 4.2e-7 (EV 2.8e-6), out-of-fold predictions
3.2e-6, served outputs 1.4e-6 (the carried JAX model 5.9e-7).
"""

import copy
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import fleet_build as jax_fleet_build
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.workflow import config as jax_config
from gordo_tpu_torch import serializer
from gordo_tpu_torch.bench import project_config
from gordo_tpu_torch.builder import fleet_build
from gordo_tpu_torch.dataset.base import GordoBaseDataset
from gordo_tpu_torch.ops.scalers import PCA, QuantileTransformer
from gordo_tpu_torch.parallel.anomaly import analyze_definition
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.server import ModelCollection, make_server
from gordo_tpu_torch.serve.stream import MachineStream, StreamUnsupported
from gordo_tpu_torch.workflow import config
from torch_parity import carry, r12, sine_rows

TOL = 1e-5
EV_TOL = 1e-4
CV_TOL = 1e-3
ROWS, TAGS, EPOCHS = 240, 10, 2
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")

AE = {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": EPOCHS}}
CHAINS = {
    "A": {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            {"gordo_tpu.ops.scalers.SimpleImputer": {"strategy": "median"}},
            {"gordo_tpu.ops.scalers.FunctionTransformer": {
                "func": "gordo_tpu.ops.transformer_funcs.multiplier", "kw_args": {"factor": 2}}},
            {"gordo_tpu.ops.scalers.PCA": {"n_components": 8}},
            "gordo_tpu.ops.scalers.MinMaxScaler",
            AE,
        ]}}}},
}
for _name, _dist in (("B", "normal"), ("B-uniform", "uniform")):
    CHAINS[_name] = {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            {"gordo_tpu.ops.scalers.QuantileTransformer": {"n_quantiles": 100, "output_distribution": _dist}},
            AE,
        ]}}}}


def r12_nan(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got)), "NaN where the reference has NaN"
    return r12(ref[~nan], got[~nan]) if (~nan).any() else 0.0


def request_rows(X):
    Q = X[-50:].copy()
    Q[3, 2] = Q[17, 0] = Q[40, 9] = np.nan        # sensor dropouts
    return Q


def correlated_rows(rng, n):
    """Tags that mix latent signals of decreasing strength, as correlated
    sensors do: a spectrum whose leading singular values are well apart,
    so that PCA's components are well defined."""
    latent = sine_rows(rng, n, TAGS) * (0.6 ** np.arange(TAGS))
    mix, _ = np.linalg.qr(rng.standard_normal((TAGS, TAGS)))
    return (latent @ mix.T).astype(np.float32)


def fit_both(definition, X):
    from gordo_tpu.serializer import from_definition as jax_definition
    from gordo_tpu_torch.serializer import from_definition

    ref = jax_definition(copy.deepcopy(definition))
    ref_cv = ref.cross_validate(X)
    ref.fit(X)
    got = from_definition(copy.deepcopy(definition))
    got_cv = got.cross_validate(X, device="cpu")
    got.fit(X, device="cpu")
    return ref, got, ref_cv, got_cv


@pytest.fixture(scope="module")
def built():
    """Per chain: the JAX detector and the port's, each cross-validated
    and fitted on the same rows; the rows."""
    X = correlated_rows(np.random.default_rng(41), ROWS)
    out = {}
    for name, definition in CHAINS.items():
        out[name] = fit_both(definition, X)
    return X, out


@pytest.mark.parametrize("chain", list(CHAINS))
def test_the_fleet_engine_takes_none_of_them(chain):
    from gordo_tpu_torch.serializer import from_definition

    assert analyze_definition(from_definition(copy.deepcopy(CHAINS[chain]))) is None


@pytest.mark.parametrize("chain", list(CHAINS))
def test_thresholds_and_cv_scores(built, chain):
    _, models = built
    ref, got, ref_cv, got_cv = models[chain]
    assert r12(ref.feature_thresholds_, got.feature_thresholds_) <= TOL
    assert r12(ref.aggregate_threshold_, got.aggregate_threshold_) <= TOL
    for name, score in ref_cv["scores"].items():
        bound = EV_TOL if name == "explained_variance_score" else CV_TOL
        assert r12(score["folds"], got_cv["scores"][name]["folds"]) <= bound, name
    assert got.cv_metadata_["scores"] == got_cv["scores"]
    # the out-of-fold predictions the scores are taken from, at the CV bound
    for (ri, ry, rp), (gi, gy, gp) in zip(ref_cv["predictions"], got_cv["predictions"]):
        assert np.array_equal(ri, gi) and np.array_equal(ry, gy)
        assert r12(rp, gp) <= CV_TOL


@pytest.mark.parametrize("chain", list(CHAINS))
def test_fitted_steps_and_params(built, chain):
    _, models = built
    ref, got, _, _ = models[chain]
    ref_steps = [s for _, s in ref.base_estimator.steps]
    got_steps = [s for _, s in got.base_estimator.steps]
    for rs, gs in zip(ref_steps[:-1], got_steps[:-1]):
        if isinstance(gs, QuantileTransformer):
            assert np.array_equal(rs.stats_["grid"], gs.stats_["grid"])
        elif isinstance(gs, PCA):
            assert r12_nan(rs.stats_["mean"], gs.stats_["mean"]) <= 1e-6
            assert r12_nan(rs.stats_["components"], gs.stats_["components"]) <= TOL
        elif gs.stats_:
            for key, v in rs.stats_.items():
                assert r12_nan(v, gs.stats_[key]) <= TOL, key
    ref_params = jax.tree.leaves(jax.tree.map(np.asarray, ref_steps[-1].params_))
    got_state = carry(ref).base_estimator.steps[-1][1].state_arrays()
    assert len(ref_params) == len(got_state)
    port_state = got_steps[-1].state_arrays()
    for key, v in got_state.items():
        assert r12(v, port_state[key]) <= TOL, key


@pytest.mark.parametrize("chain", list(CHAINS))
def test_anomaly_of_rows_with_nan_cells(built, chain):
    X, models = built
    ref, got, _, _ = models[chain]
    Q = request_rows(X)
    want = JaxScorer(ref).anomaly_arrays(Q)
    have = got.anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert r12_nan(want[key], have[key]) <= TOL, key
    # the carried JAX model scores the same
    carried = carry(ref).anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert r12_nan(want[key], carried[key]) <= TOL, key


def test_a_near_degenerate_spectrum_moves_pca_not_the_kernels():
    """Tags of equal strength (``sine_rows``: independent sines and noise)
    have near-equal singular values (a gap of 0.013 in 22.4 here), where
    two LAPACKs' singular vectors differ far past their roundings: the
    port's fitted components are 4.6e-4 off the reference's, and chain A's
    served outputs 1.7e-4 (ROADMAP queue 3).  The reference's own fit moves
    as much under another LAPACK.  The port's kernels are not the cause:
    the reference's fitted detector, carried across, serves within 1e-5,
    and the port's own fit stays within the CV bound."""
    X = sine_rows(np.random.default_rng(41), ROWS, TAGS)
    ref, got, _, _ = fit_both(CHAINS["A"], X)
    Q = request_rows(X)
    want = JaxScorer(ref).anomaly_arrays(Q)
    carried, have = carry(ref).anomaly(Q, device="cpu"), got.anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert r12_nan(want[key], carried[key]) <= TOL, key
        assert r12_nan(want[key], have[key]) <= CV_TOL, key


@pytest.mark.parametrize("chain", list(CHAINS))
def test_dump_load_serves_the_same(built, chain, tmp_path):
    X, models = built
    _, got, _, _ = models[chain]
    serializer.dump(got, str(tmp_path / "m"))
    loaded = serializer.load(str(tmp_path / "m"))
    Q = request_rows(X)
    a, b = got.anomaly(Q, device="cpu"), loaded.anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert np.array_equal(a[key], b[key], equal_nan=True), key
    assert loaded.get_metadata() == got.get_metadata()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_http_per_machine_and_bulk(built, tmp_path):
    X, models = built
    for name, (_, got, _, _) in models.items():
        serializer.dump(got, str(tmp_path / name))
    collection = ModelCollection.from_directory(str(tmp_path), project="p", device="cpu")
    server = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/p"
    Q = request_rows(X)
    try:
        bulk_status, bulk = _post(f"{base}/_bulk/anomaly/prediction", {"X": {n: Q.tolist() for n in models}})
        single = {n: _post(f"{base}/{n}/anomaly/prediction", {"X": Q.tolist()}) for n in models}
        stream_status, stream_body = _post(f"{base}/stream/ingest", {"machine": "A", "x": Q[:2].tolist()})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert bulk_status == 200
    # the bulk route scores these one by one, as the JAX FleetScorer does
    assert sorted(collection.fleet_scorer.fallbacks) == sorted(models)
    for name, (_, got, _, _) in models.items():
        want = got.anomaly(Q, device="cpu")
        status, body = single[name]
        assert status == 200
        for key in OUTPUTS:
            np.testing.assert_allclose(np.asarray(body["data"][key], np.float64), want[key], rtol=0, atol=0)
            np.testing.assert_allclose(np.asarray(bulk["data"][name][key], np.float64), want[key], rtol=0, atol=0)
    assert stream_status == 422 and "queue 1 item 2" in stream_body["error"]


def test_stream_and_reduced_precision_wait_for_item_2(built):
    _, models = built
    got = models["A"][1]
    with pytest.raises(StreamUnsupported, match="queue 1 item 2"):
        MachineStream("A", CompiledScorer(got, device="cpu", dtype="float32"))
    for dtype in ("bfloat16", "int8"):
        with pytest.raises(NotImplementedError, match="queue 1 item 2"):
            CompiledScorer(got, device="cpu", dtype=dtype)


def test_an_lstm_behind_these_steps_waits_for_item_2():
    from gordo_tpu_torch.serializer import from_definition

    definition = copy.deepcopy(CHAINS["B"])
    steps = definition["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
        "gordo_tpu.pipeline.Pipeline"]["steps"]
    steps[-1] = {"gordo_tpu.models.estimator.LSTMAutoEncoder": {
        "kind": "lstm_symmetric", "dims": [2], "lookback_window": 3, "epochs": 1}}
    model = from_definition(definition)
    X = sine_rows(np.random.default_rng(3), 60, 3)
    model.fit(X, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        CompiledScorer(model, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        from_definition(copy.deepcopy(definition)).cross_validate(X, device="cpu")


def test_build_project_singles_pass_matches_jax(tmp_path):
    """A project YAML of a chain A and a chain B machine: both packages'
    ``build_project`` build them through the singles pass."""
    raw = config.load_machine_config(project_config(2, TAGS, ROWS, seed=5))
    for machine, chain in zip(raw["machines"], ("A", "B")):
        machine["model"] = copy.deepcopy(CHAINS[chain])
    env = os.environ.get("GORDO_FLEET_BASELINE")
    os.environ["GORDO_FLEET_BASELINE"] = "off"
    try:
        jax_cfg = jax_config.NormalizedConfig(copy.deepcopy(raw), "transforms")
        jax_result = jax_fleet_build.build_project(
            jax_cfg.machines, str(tmp_path / "jax"), artifact_format="v1", ingest=False)
    finally:
        if env is None:
            os.environ.pop("GORDO_FLEET_BASELINE")
        else:
            os.environ["GORDO_FLEET_BASELINE"] = env
    cfg = config.NormalizedConfig(copy.deepcopy(raw), "transforms")
    result = fleet_build.build_project(cfg.machines, str(tmp_path / "port"), device="cpu")
    assert not result.failed and not jax_result.failed
    assert sorted(result.single_built) == sorted(jax_result.single_built) == [m.name for m in cfg.machines]
    for m in cfg.machines:
        ref = jax_serializer.load(jax_result.artifacts[m.name])
        got = serializer.load(result.artifacts[m.name])
        assert r12(np.append(ref.feature_thresholds_, ref.aggregate_threshold_),
                   np.append(got.feature_thresholds_, got.aggregate_threshold_)) <= TOL, m.name
        for name, score in ref.cv_metadata_["scores"].items():
            bound = EV_TOL if name == "explained_variance_score" else CV_TOL
            assert r12(score["folds"], got.cv_metadata_["scores"][name]["folds"]) <= bound, (m.name, name)
        X = np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)
        Q = request_rows(X)
        want = JaxScorer(ref).anomaly_arrays(Q)
        have = got.anomaly(Q, device="cpu")
        for key in OUTPUTS:
            assert r12_nan(want[key], have[key]) <= TOL, (m.name, key)
