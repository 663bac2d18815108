"""The pipeline containers of the port against the JAX package's.

``TransformedTargetRegressor``, ``FeatureUnion`` and
``MultiOutputRegressor`` of ``gordo_tpu_torch/pipeline.py`` against their
namesakes in ``gordo_tpu/pipeline.py`` on the CPU, where the kernels run
their plain versions: first every transform's inverse (``inverse_steps``
through ``chain_apply_plain``, K12) against the JAX ``inverse_transform``,
then a TTR fitted by both with no injected draws (the port draws its
params and permutations from the JAX package's threefry keys, K11), then
four detectors built by both packages (cross-validated through the
generic fold loop and fitted) and served:

- ``ttr``: gordo's default, ``TransformedTargetRegressor(MinMaxScaler,
  Pipeline[MinMaxScaler, AutoEncoder])``;
- ``ttr_quantile``: the same with ``QuantileTransformer(50, normal)`` as
  the target transformer;
- ``union``: ``Pipeline[FeatureUnion[PCA(3), MinMaxScaler], AutoEncoder]``;
- ``mor``: ``MultiOutputRegressor(AutoEncoder)``.

Each detector at 240 rows × 6 tags of correlated signals (PCA's leading
singular values well apart), 2 epochs; the requests carry NaN cells.

Bounds, ``max|ref - port| / max|ref|`` (``torch_parity.r12``) over the
non-NaN values, NaN where the reference has NaN, or in units in the last
place (ulp), each measured and stated:

- the MinMax, Standard and Robust inverses, the imputer's (the identity),
  the uniform quantile inverse and the ``multiplier``/``adder`` inverses:
  0 (bit for bit: eager ops with no FMA, ``jnp.interp`` with XLA:CPU's
  fused ``fp[i-1] + (delta / dx) * df``);
- ``ndtr`` (``norm.cdf``): 4 ulp (measured 3 over 440,000 values): its
  polynomials and constants are XLA's, bit for bit; its tails take an
  ``exp``, XLA's against PyTorch's; the normal quantile inverse 4e-6
  (measured 1.3e-6 at 1,000 quantiles): that gap, a few ulp of a value
  near 0 or 1, over the qs step times the grid's step in the tails;
- PCA's inverse 1e-6 (measured 2.0e-7: XLA:CPU's dot sums in another
  order); ``log1p`` 4 ulp and ``expm1`` 8 ulp (measured 2 and 5), as in
  ``test_torch_transforms.py``;
- the epilogue-only ``fleet_score`` against ``anomaly.scores`` 1e-5
  (measured 2.0e-7);
- the TTR's transformer stats 1e-6, as ``test_torch_scalers.py`` holds
  them (measured 1 ulp of the mean), its params and predictions 1e-5
  (measured 2.4e-6), its explained variance 1e-4;
- the detectors' thresholds 1e-5, CV scores 1e-3 and explained variance
  1e-4 (all measured at most 1.5e-6), anomaly outputs 1e-5 (measured
  7.1e-7), the JAX-fitted detectors carried across by
  ``convert.from_reference`` 1e-5 (measured 7.1e-7).
"""

import copy
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.stats import norm

from gordo_tpu.ops import scalers as J
from gordo_tpu.ops import transformer_funcs as JF
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu_torch import pipeline as PP
from gordo_tpu_torch import serializer
from gordo_tpu_torch.kernels import chain_apply as ca
from gordo_tpu_torch.kernels import fleet_score as fs
from gordo_tpu_torch.kernels import rolling_median as rm
from gordo_tpu_torch.ops import scalers as P
from gordo_tpu_torch.ops import transformer_funcs as PF
from gordo_tpu_torch.parallel.anomaly import analyze_definition
from gordo_tpu_torch.serializer import from_definition, into_definition
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.server import ModelCollection, make_server
from gordo_tpu_torch.serve.stream import MachineStream, StreamUnsupported
from gordo_tpu_torch.kernels.scaler_stats import AFFINE
from torch_parity import carry, r12, sine_rows

TOL = 1e-5
EV_TOL = 1e-4
CV_TOL = 1e-3
INVERSE_TOL = 1e-6
NORMAL_INVERSE_TOL = 4e-6
STATS_TOL = 1e-6
NDTR_ULP = 4
FUNC_ULP = {"log1p": 4, "expm1": 8, "multiplier": 0, "adder": 0}
ROWS, TAGS, EPOCHS = 240, 6, 2
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")

AE = {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": EPOCHS}}


def _detector(base):
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": base}}


def _ttr(transformer):
    return _detector({"sklearn.compose.TransformedTargetRegressor": {
        "transformer": transformer,
        "regressor": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", AE]}},
    }})


DEFINITIONS = {
    "ttr": _ttr("sklearn.preprocessing.MinMaxScaler"),
    "ttr_quantile": _ttr({"sklearn.preprocessing.QuantileTransformer": {
        "n_quantiles": 50, "output_distribution": "normal"}}),
    "union": _detector({"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
            {"sklearn.decomposition.PCA": {"n_components": 3}}, "sklearn.preprocessing.MinMaxScaler"]}},
        AE,
    ]}}),
    "mor": _detector({"sklearn.multioutput.MultiOutputRegressor": {"estimator": AE}}),
}


def r12_nan(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got)), "NaN where the reference has NaN"
    return r12(ref[~nan], got[~nan]) if (~nan).any() else 0.0


def ulp_gap(ref, got) -> int:
    """The largest distance in float32 steps between finite values; the
    non-finite ones must be equal."""
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got)) and np.array_equal(np.isnan(ref), np.isnan(got))
    assert np.array_equal(ref[~fin & ~np.isnan(ref)], got[~fin & ~np.isnan(got)])

    def ordered(a):
        i = a[fin].view(np.int32).astype(np.int64)
        return np.where(i < 0, -(2 ** 31) - i, i)

    return int(np.abs(ordered(ref) - ordered(got)).max()) if fin.any() else 0


def correlated_rows(rng, n, tags=TAGS):
    """Tags that mix latent signals of decreasing strength, as correlated
    sensors do: PCA's leading singular values stand well apart."""
    latent = sine_rows(rng, n, tags) * (0.6 ** np.arange(tags))
    mix, _ = np.linalg.qr(rng.standard_normal((tags, tags)))
    return (latent @ mix.T).astype(np.float32)


def request_rows(X):
    Q = X[-50:].copy()
    Q[3, 2] = Q[17, 0] = Q[40, 5] = np.nan        # sensor dropouts
    return Q


# ---------------------------------------------------------------------------
# Every transform's inverse
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(14)
    X = (np.round(rng.standard_normal((300, TAGS)) * 4) / 4).astype(np.float32)
    Y = (1.5 * rng.standard_normal((200, TAGS))).astype(np.float32)
    Y[::9, 2] = np.nan                        # sensor dropouts in the rows inverted
    return X, Y, correlated_rows(rng, 300)


def test_ndtr_is_jax_s():
    x = np.concatenate([np.linspace(-14, 14, 400001), np.geomspace(1e-30, 14, 20000),
                        -np.geomspace(1e-30, 14, 20000), [np.nan, np.inf, -np.inf, 0.0, -0.0]]).astype(np.float32)
    want = np.asarray(norm.cdf(jnp.asarray(x)))
    assert ulp_gap(want, ca.ndtr_plain(torch.from_numpy(x)).numpy()) <= NDTR_ULP


@pytest.mark.parametrize("name", ["minmax", "standard", "robust", "imputer"])
def test_scaler_inverses_are_bit_for_bit(rows, name):
    X, Y, _ = rows
    cls = {"minmax": "MinMaxScaler", "standard": "StandardScaler", "robust": "RobustScaler",
           "imputer": "SimpleImputer"}[name]
    ref = getattr(J, cls)().fit(X)
    got = getattr(P, cls)().load_state_arrays({k: np.asarray(v) for k, v in ref.stats_.items()})
    want = np.asarray(ref.inverse_transform(Y))
    out = got.inverse_transform(Y)
    assert np.array_equal(want, out, equal_nan=True)
    # the tensor path is the host path
    assert np.array_equal(got.inverse_transform(torch.from_numpy(Y)).numpy(), out, equal_nan=True)
    assert [s.form for s in got.inverse_steps("cpu")] == {
        "minmax": [ca.CENTER], "standard": [ca.AFFINE], "robust": [ca.AFFINE], "imputer": []}[name]
    # marked, so that chain_apply counts their launches as an inverse's
    assert all(s.inverse for s in got.inverse_steps("cpu")) and not any(s.inverse for s in got.steps("cpu"))


@pytest.mark.parametrize("n_quantiles", [50, 1000])
@pytest.mark.parametrize("distribution", ["uniform", "normal"])
def test_quantile_inverse(rows, n_quantiles, distribution):
    X, Y, _ = rows
    ref = J.QuantileTransformer(n_quantiles=n_quantiles, output_distribution=distribution).fit(X)
    got = P.QuantileTransformer(n_quantiles=n_quantiles, output_distribution=distribution).fit(X, device="cpu")
    assert np.array_equal(ref.stats_["grid"], got.stats_["grid"])
    U = np.array(ref.transform(Y))
    if distribution == "uniform":
        U[5] = [-0.1, 1.2, 0.0, 1.0, 0.5, np.nan]       # past both ends, the ends, NaN
    want, out = np.asarray(ref.inverse_transform(U)), got.inverse_transform(U)
    if distribution == "uniform":
        assert np.array_equal(want, out, equal_nan=True)
    else:
        assert r12_nan(want, out) <= NORMAL_INVERSE_TOL
    assert [(s.form, s.inverse) for s in got.inverse_steps("cpu")] == [(ca.QUANTILE_INV, True)]


@pytest.mark.parametrize("n_components", [3, None])
def test_pca_inverse(rows, n_components):
    _, _, C = rows
    ref = J.PCA(n_components=n_components).fit(C)
    got = P.PCA().load_state_arrays({k: np.asarray(v) for k, v in ref.stats_.items()})
    Z = np.asarray(ref.transform(C))
    out = got.inverse_transform(Z)
    assert out.shape == C.shape
    assert r12_nan(np.asarray(ref.inverse_transform(Z)), out) <= INVERSE_TOL
    assert r12_nan(np.asarray(J.PCA.invert(ref.stats_, Z)), P.PCA.invert(got.stats_, Z)) <= INVERSE_TOL


@pytest.mark.parametrize("name, kw", [
    ("multiplier", {"factor": 2.7}), ("adder", {"addend": 0.3}), ("log1p", {}), ("expm1", {}),
])
def test_func_inverses(rows, name, kw):
    _, _, C = rows
    Z = np.abs(C) if name == "log1p" else C / 3
    ref = J.FunctionTransformer(inverse_func=getattr(JF, name), inv_kw_args=kw).fit(Z)
    got = P.FunctionTransformer(inverse_func=getattr(PF, name), inv_kw_args=kw).fit(Z, device="cpu")
    assert ulp_gap(np.asarray(ref.inverse_transform(Z)), got.inverse_transform(Z)) <= FUNC_ULP[name]
    assert np.array_equal(P.FunctionTransformer().inverse_transform(Z), Z)


def test_chain_apply_writes_its_columns_of_a_wider_output(rows):
    """A FeatureUnion's branches each write their columns of one output."""
    _, _, C = rows
    x = torch.from_numpy(C)
    pca = P.PCA(n_components=2).fit(C, device="cpu")
    mm = P.MinMaxScaler().fit(C, device="cpu")
    out = torch.full((len(C), 2 + TAGS), -7.0)
    ca.chain_apply(x, pca.steps("cpu"), out=out, out_col=0)
    ca.chain_apply(x, mm.steps("cpu"), out=out, out_col=2)
    assert torch.equal(out[:, :2], ca.chain_apply(x, pca.steps("cpu")))
    assert torch.equal(out[:, 2:], ca.chain_apply(x, mm.steps("cpu")))
    with pytest.raises(ValueError, match="do not lie"):
        ca.chain_apply(x, mm.steps("cpu"), out=out, out_col=3)
    union = PP.FeatureUnion([P.PCA(n_components=2), P.MinMaxScaler()]).fit(C, device="cpu")
    assert np.array_equal(union.transform(C), out.numpy())


def test_epilogue_only_fleet_score_is_the_reference_scores(rows):
    """``fleet_score`` with no layers: ``anomaly.scores`` of a prediction
    already computed, against the JAX package's ``scores_fn``."""
    from gordo_tpu.anomaly.diff import scores_fn

    _, Y, C = rows
    pred, y = C[:200], np.nan_to_num(Y)
    det = J.MinMaxScaler().fit(y)
    tag, total = scores_fn(J.MinMaxScaler, det.stats_, jnp.asarray(y[2:]), jnp.asarray(pred[:-2]))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    out = fs.fleet_score(put(pred[None, :-2]), [], [],
                         det=(AFFINE, put(det.stats_["scale"][None]), put(det.stats_["offset"][None])),
                         agg_thr=put([0.5]), y=put(y[None]), y_offset=2)
    assert torch.equal(out["model-output"][0], put(pred[:-2]))
    assert r12(np.asarray(tag), out["tag-anomaly-scores"][0].numpy()) <= TOL
    assert r12(np.asarray(total), out["total-anomaly-score"][0].numpy()) <= TOL
    assert r12(np.asarray(total) / 0.5, out["anomaly-confidence"][0].numpy()) <= TOL
    with pytest.raises(ValueError, match="epilogue-only"):
        fs.fleet_score(put(pred[None]), [], [])


# ---------------------------------------------------------------------------
# A TransformedTargetRegressor, fitted by both
# ---------------------------------------------------------------------------

def test_ttr_fit_predict_score():
    X = correlated_rows(np.random.default_rng(7), ROWS)
    y = (X * 3.0 + 1.0).astype(np.float32)
    definition = {"sklearn.compose.TransformedTargetRegressor": {
        "transformer": "sklearn.preprocessing.StandardScaler",
        "regressor": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", AE]}},
    }}
    ref = jax_from_definition(copy.deepcopy(definition)).fit(X, y)
    got = from_definition(copy.deepcopy(definition)).fit(X, y, device="cpu")
    for key in ("mean", "std"):
        assert r12(ref.transformer.stats_[key], got.transformer.stats_[key]) <= STATS_TOL, key
    carried = carry(ref).regressor.steps[-1][1].state_arrays()
    mine = got.regressor.steps[-1][1].state_arrays()
    for key, v in carried.items():
        assert r12(v, mine[key]) <= TOL, key
    Q = X[-60:]
    assert r12(np.asarray(ref.predict(Q)), got.predict(Q, device="cpu")) <= TOL
    assert abs(ref.score(X, y) - got.score(X, y, device="cpu")) <= EV_TOL
    assert got.offset == 0 and got.get_metadata()["model_type"] == "AutoEncoder"


# ---------------------------------------------------------------------------
# The detectors, built by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    """Per definition: the JAX detector and the port's, each
    cross-validated and fitted on the same rows; the rows."""
    X = correlated_rows(np.random.default_rng(41), ROWS)
    out = {}
    for name, definition in DEFINITIONS.items():
        ref = jax_from_definition(copy.deepcopy(definition))
        ref_cv = ref.cross_validate(X)
        ref.fit(X)
        got = from_definition(copy.deepcopy(definition))
        got_cv = got.cross_validate(X, device="cpu")
        got.fit(X, device="cpu")
        out[name] = ref, got, ref_cv, got_cv
    return X, out


@pytest.mark.parametrize("name", list(DEFINITIONS))
def test_the_fleet_engine_takes_none_of_them(name):
    model = from_definition(copy.deepcopy(DEFINITIONS[name]))
    assert analyze_definition(model) is None
    # the definition round trip
    assert into_definition(from_definition(into_definition(model))) == into_definition(model)
    again = from_definition(into_definition(model))
    assert type(again.base_estimator) is type(model.base_estimator)


@pytest.mark.parametrize("name", list(DEFINITIONS))
def test_thresholds_and_cv_scores(built, name):
    _, models = built
    ref, got, ref_cv, got_cv = models[name]
    assert r12(ref.feature_thresholds_, got.feature_thresholds_) <= TOL
    assert r12(ref.aggregate_threshold_, got.aggregate_threshold_) <= TOL
    for metric, score in ref_cv["scores"].items():
        bound = EV_TOL if metric == "explained_variance_score" else CV_TOL
        assert r12(score["folds"], got_cv["scores"][metric]["folds"]) <= bound, metric
    for (ri, ry, rp), (gi, gy, gp) in zip(ref_cv["predictions"], got_cv["predictions"]):
        assert np.array_equal(ri, gi) and np.array_equal(ry, gy)
        assert r12(rp, gp) <= CV_TOL


@pytest.mark.parametrize("name", list(DEFINITIONS))
def test_anomaly_of_rows_with_nan_cells(built, name):
    X, models = built
    ref, got, _, _ = models[name]
    Q = request_rows(X)
    want = JaxScorer(ref).anomaly_arrays(Q)
    have = got.anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert r12_nan(want[key], have[key]) <= TOL, key
    # a JAX-fitted detector carried across serves the same
    carried = carry(ref).anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert r12_nan(want[key], carried[key]) <= TOL, key


def _launches(monkeypatch):
    """Calls of each serving kernel's wrapper, on the CPU: each wrapper
    takes its plain version there, whose calls are counted."""
    counts = {}
    for mod, name in ((ca, "chain_apply"), (fs, "fleet_score"), (rm, "rolling_median")):
        real = getattr(mod, f"{name}_plain")

        def counted(*args, _name=name, _real=real, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, f"{name}_plain", counted)
    return counts


@pytest.mark.parametrize("name, launches", [
    ("ttr", {"fleet_score": 2, "chain_apply": 1}),
    ("union", {"fleet_score": 1, "chain_apply": 2}),
    ("mor", {"fleet_score": 2}),
])
def test_launches_of_a_request(built, name, launches, monkeypatch):
    """A TTR request is three launches (the model output, the target's
    inverse, the epilogue), four with a window; a FeatureUnion step one
    ``chain_apply`` per branch; a MultiOutputRegressor one model launch over
    its columns, stacked as machines, and the epilogue."""
    X, models = built
    got = models[name][1]
    scorer = CompiledScorer(got, device="cpu")
    counts = _launches(monkeypatch)
    scorer.anomaly_arrays(request_rows(X))
    assert counts == launches


def test_a_windowed_ttr_smooths_as_the_reference(built, monkeypatch):
    X, models = built
    ref = copy.deepcopy(models["ttr"][0])
    ref.window = 12
    got = carry(ref)
    got.window = 12
    Q = request_rows(X)
    want = JaxScorer(ref).anomaly_arrays(Q)
    scorer = CompiledScorer(got, device="cpu")
    counts = _launches(monkeypatch)
    have = scorer.anomaly_arrays(Q)
    assert counts == {"fleet_score": 2, "chain_apply": 1, "rolling_median": 1}
    for key in OUTPUTS:
        assert r12_nan(want[key], have[key]) <= TOL, key


@pytest.mark.parametrize("name", list(DEFINITIONS))
def test_dump_load_and_reduced_precision_serve_the_same(built, name, tmp_path, monkeypatch):
    """A saved detector reloads bit for bit; at bf16 and int8 it serves at
    float32, as the reference's model path does, bit for bit."""
    X, models = built
    got = models[name][1]
    serializer.dump(got, str(tmp_path / "m"))
    loaded = serializer.load(str(tmp_path / "m"))
    Q = request_rows(X)
    want = got.anomaly(Q, device="cpu")
    have = loaded.anomaly(Q, device="cpu")
    for key in OUTPUTS:
        assert np.array_equal(want[key], have[key], equal_nan=True), key
    assert loaded.get_metadata() == got.get_metadata()
    for a, b in zip(sorted(got.state_arrays().items()), sorted(loaded.state_arrays().items())):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    monkeypatch.setenv("GORDO_SERVE_INT8", "1")
    for dtype in ("bfloat16", "int8"):
        scorer = CompiledScorer(got, device="cpu", dtype=dtype)
        assert scorer._stack.dtype == "float32"
        out = scorer.anomaly_arrays(Q)
        for key in OUTPUTS:
            assert np.array_equal(out[key], want[key], equal_nan=True), (dtype, key)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_http_per_machine_bulk_and_the_stream_s_422(built, tmp_path):
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
        stream = {n: _post(f"{base}/stream/ingest", {"machine": n, "x": Q[:2].tolist()}) for n in models}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert bulk_status == 200
    # the bulk route serves these one by one, as the JAX FleetScorer does
    assert sorted(collection.fleet_scorer.fallbacks) == sorted(models)
    for name, (_, got, _, _) in models.items():
        want = got.anomaly(Q, device="cpu")
        status, body = single[name]
        assert status == 200
        for key in OUTPUTS:
            np.testing.assert_array_equal(np.asarray(body["data"][key], np.float64), want[key])
            np.testing.assert_array_equal(np.asarray(bulk["data"][name][key], np.float64), want[key])
        status, body = stream[name]
        assert status == 422 and "no fused anomaly chain" in body["error"], name
    with pytest.raises(StreamUnsupported, match="no fused anomaly chain"):
        MachineStream("ttr", CompiledScorer(models["ttr"][1], device="cpu"))


def test_a_mor_of_pipelines_and_an_lstm_ttr_serve():
    """A MultiOutputRegressor of pipelines and a TTR around an LSTM serve
    through the same launches (an LSTM's rows from its offset on)."""
    X = sine_rows(np.random.default_rng(3), 60, 3)
    mor = from_definition(_detector({"sklearn.multioutput.MultiOutputRegressor": {"estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", AE]}}}}))
    mor.fit(X, device="cpu")
    assert len(mor.base_estimator.estimators_) == 3
    out = CompiledScorer(mor, device="cpu").predict(X[:20])
    assert out.shape == (20, 3) and np.isfinite(out).all()
    lstm = from_definition(_detector({"sklearn.compose.TransformedTargetRegressor": {
        "transformer": "sklearn.preprocessing.MinMaxScaler",
        "regressor": {"gordo_tpu.models.estimator.LSTMAutoEncoder": {
            "kind": "lstm_symmetric", "dims": [2], "lookback_window": 3, "epochs": 1}}}}))
    lstm.fit(X, device="cpu")
    lstm.feature_thresholds_, lstm.aggregate_threshold_ = np.full(3, 0.5, np.float32), 0.5
    res = CompiledScorer(lstm, device="cpu").anomaly_arrays(X[:20])
    assert res["model-output"].shape == (18, 3) and np.isfinite(res["total-anomaly-score"]).all()
    assert lstm.offset == 2
