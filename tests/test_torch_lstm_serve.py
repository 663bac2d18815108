"""LSTM and smoothed detectors served by the port against the JAX package.

Models (3 tags):

- ``ae``: the fitted JAX LSTM detector of ``tests/lstm_detectors.py``
  (lookback 6, cross-validated thresholds);
- ``ae-init``: the same architecture from ``module.init`` params;
- ``forecast``: an ``LSTMForecast`` (lookback 4) with a detector window
  of 3, from ``module.init`` params;
- ``ff-window``: a feedforward hourglass detector with a window of 5,
  from ``module.init`` params.

The init-param models get MinMax stats fitted by hand and thresholds from
seeded numpy: no JAX LSTM fit of a new shape (see ``tests/lstm_detectors.py``).
Each is carried across with ``gordo_tpu_torch.convert`` and scored by the
port on the CPU (the kernels' plain versions), through ``CompiledScorer``,
``FleetScorer`` and the HTTP routes, against the JAX package's
``CompiledScorer`` and ``FleetScorer``.  Tolerance: ``max|ref - port| /
max|ref|`` per output series <= 1e-5 in float32 (measured on the CPU: at
most 5.9e-7 over every series of these tests).
"""

import copy
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.models.estimator import LSTMForecast as JaxLSTMForecast
from gordo_tpu.serve.fleet_scorer import FleetScorer as JaxFleetScorer
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu_torch import serializer
from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.kernels import fleet_score as fs
from gordo_tpu_torch.kernels import lstm_layer as ll
from gordo_tpu_torch.kernels import rolling_median as rm
from gordo_tpu_torch.models.estimator import LSTMAutoEncoder
from gordo_tpu_torch.registry import lookup_factory
from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
from gordo_tpu_torch.serve.scorer import CompiledScorer, short_rows_message
from gordo_tpu_torch.serve.server import ModelCollection, make_server
from lstm_detectors import LOOKBACK, N_TAGS, fitted_lstm_detector
from torch_parity import carry, init_detector, r12

TOL = 1e-5
PROJECT = "lstm"
NAMES = ["ae", "ae-init", "forecast", "ff-window"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    rng = np.random.default_rng(11)
    X = rng.standard_normal((200, N_TAGS)).astype(np.float32)
    jax_models = {
        "ae": fitted_lstm_detector(rng),
        "ae-init": init_detector(
            JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=LOOKBACK), X, rng, seed=1),
        "forecast": init_detector(
            JaxLSTMForecast(kind="lstm_hourglass", lookback_window=4), X, rng, window=3, seed=2),
        "ff-window": init_detector(
            JaxAutoEncoder(kind="feedforward_hourglass"), X, rng, window=5, seed=3),
    }
    port = {name: carry(model) for name, model in jax_models.items()}
    out = tmp_path_factory.mktemp("port-lstm-models")
    for name, model in port.items():
        meta = {"dataset": {"tag_list": [f"tag-{j}" for j in range(N_TAGS)]}}
        serializer.dump(model, str(out / name), metadata=meta)
    return {"jax": jax_models, "port": port, "dir": out, "rng": rng}


@pytest.fixture(scope="module")
def server(models):
    collection = ModelCollection.from_directory(str(models["dir"]), project=PROJECT, device="cpu")
    srv = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/gordo/v0/{PROJECT}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _rows(rng, n):
    return rng.standard_normal((n, N_TAGS)).astype(np.float32)


def _assert_series(ref: dict, got: dict):
    assert set(got) == set(ref)
    for k in ref:
        assert np.shape(got[k]) == np.shape(ref[k]), k
        assert r12(ref[k], got[k]) <= TOL, (k, r12(ref[k], got[k]))


def call(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


@pytest.mark.parametrize("name", NAMES)
def test_compiled_scorer_matches_jax(models, name):
    X = _rows(models["rng"], 50)
    jax_scorer = JaxScorer(models["jax"][name])
    scorer = CompiledScorer(models["port"][name], device="cpu")
    got = scorer.predict(X)
    _assert_series({"model-output": jax_scorer.predict(X)}, {"model-output": got})
    assert got.shape == (50 - scorer.offset, N_TAGS)
    ref = jax_scorer.anomaly_arrays(X)
    assert "anomaly-confidence" in ref
    _assert_series(ref, scorer.anomaly_arrays(X))
    # the detector's own entry points
    _assert_series(ref, models["port"][name].anomaly(X, device="cpu"))
    _assert_series({"m": ref["model-output"]}, {"m": models["port"][name].predict(X, device="cpu")})


def test_lstm_estimator_predicts_its_windows(models):
    pipe = models["port"]["ae"].base_estimator
    X = _rows(models["rng"], 30)
    Xs = pipe.steps[0][1].transform(X)
    got = pipe._final.predict(Xs, device="cpu")
    ref = models["jax"]["ae"].base_estimator._final.predict(Xs)
    assert got.shape == ref.shape == (30 - (LOOKBACK - 1), N_TAGS)
    assert r12(ref, got) <= TOL


def test_targets_other_than_the_input(models):
    """``anomaly(X, y)`` scores against ``y`` from the model's offset on
    (the JAX package takes its host path for a separate y)."""
    rng = models["rng"]
    X, y = _rows(rng, 40), _rows(rng, 40)
    for name in ("ae", "forecast"):
        ref = JaxScorer(models["jax"][name]).anomaly_arrays(X, y)
        _assert_series(ref, CompiledScorer(models["port"][name], device="cpu").anomaly_arrays(X, y))


def test_short_requests_are_refused_like_jax(models):
    for name, offset in (("ae", LOOKBACK - 1), ("forecast", 4)):
        X = _rows(models["rng"], offset)
        with pytest.raises(ValueError) as jax_err:
            JaxScorer(models["jax"][name]).anomaly_arrays(X)
        with pytest.raises(ValueError) as port_err:
            CompiledScorer(models["port"][name], device="cpu").anomaly_arrays(X)
        assert str(port_err.value) == str(jax_err.value) == short_rows_message(offset, offset)


@pytest.mark.parametrize("case", ["ragged", "subset"])
def test_fleet_scorer_matches_jax(models, case):
    rng = models["rng"]
    rows = {"ragged": {"ae": 40, "ae-init": 7, "forecast": 30, "ff-window": 1},
            "subset": {"ae-init": 12, "forecast": 5}}[case]
    X_by = {n: _rows(rng, r) for n, r in rows.items()}
    ref = JaxFleetScorer.from_models({n: models["jax"][n] for n in NAMES}).score_all(X_by)
    fleet = FleetScorer.from_models(models["port"], device="cpu")
    # one bucket per architecture: the two ae detectors share theirs
    assert sorted(len(b.names) for b in fleet.buckets) == [1, 1, 2]
    got = fleet.score_all(X_by)
    assert set(got) == set(ref) == set(rows)
    for n in rows:
        _assert_series(ref[n], got[n])


def test_fleet_scorer_reports_short_rows_per_machine(models):
    rng = models["rng"]
    X_by = {"ae": _rows(rng, LOOKBACK - 1), "forecast": _rows(rng, 4), "ff-window": _rows(rng, 3)}
    ref = JaxFleetScorer.from_models({n: models["jax"][n] for n in NAMES}).score_all(X_by)
    got = FleetScorer.from_models(models["port"], device="cpu").score_all(X_by)
    for n, offset in (("ae", LOOKBACK - 1), ("forecast", 4)):
        assert got[n] == ref[n] == {"error": short_rows_message(offset, len(X_by[n])),
                                    "client-error": True}
    _assert_series(ref["ff-window"], got["ff-window"])


@pytest.mark.parametrize("name", NAMES)
def test_routes_match_jax(models, server, name):
    X = _rows(models["rng"], 33)
    status, body = call(f"{server}/{name}/healthcheck")
    assert status == 200
    status, body = call(f"{server}/{name}/metadata")
    assert status == 200 and body["endpoint-metadata"] == {"model-name": name}
    jax_scorer = JaxScorer(models["jax"][name])
    status, body = call(f"{server}/{name}/prediction", {"X": X.tolist()})
    assert status == 200
    _assert_series({"model-output": jax_scorer.predict(X)}, body["data"])
    status, body = call(f"{server}/{name}/anomaly/prediction", {"X": X.tolist()})
    assert status == 200
    ref = jax_scorer.anomaly_arrays(X)
    assert list(body["data"]) == list(ref)
    _assert_series(ref, body["data"])


def test_bulk_route_mixes_lstm_and_feedforward_buckets(models, server):
    rng = models["rng"]
    X_by = {"ae": _rows(rng, 64), "ae-init": _rows(rng, 20), "forecast": _rows(rng, 9),
            "ff-window": _rows(rng, 48)}
    ref = JaxFleetScorer.from_models(models["jax"]).score_all(X_by)
    before = (ll.launches, fs.launches, rm.launches)
    status, body = call(f"{server}/_bulk/anomaly/prediction",
                        {"X": {n: X.tolist() for n, X in X_by.items()}})
    assert status == 200
    assert (ll.launches, fs.launches, rm.launches) == before  # the CPU launches nothing
    for n in X_by:
        _assert_series(ref[n], body["data"][n])


def test_short_rows_are_400_per_machine_and_a_slot_error_in_bulk(models, server):
    X = _rows(models["rng"], LOOKBACK - 1)
    message = short_rows_message(LOOKBACK - 1, LOOKBACK - 1)
    for route in ("prediction", "anomaly/prediction"):
        status, body = call(f"{server}/ae/{route}", {"X": X.tolist()})
        assert (status, body) == (400, {"error": message})
    status, body = call(f"{server}/_bulk/anomaly/prediction",
                        {"X": {"ae": X.tolist(), "ff-window": X.tolist()}})
    assert status == 200
    assert body["data"]["ae"] == {"error": message}
    assert "anomaly-confidence" in body["data"]["ff-window"]


@pytest.mark.parametrize("name", NAMES)
def test_serializer_round_trip_is_exact(models, tmp_path, name):
    model = models["port"][name]
    serializer.dump(model, str(tmp_path / name))
    loaded = serializer.load(str(tmp_path / name))
    assert serializer.into_definition(loaded) == serializer.into_definition(model)
    state, back = model.state_arrays(), loaded.state_arrays()
    assert set(state) == set(back)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    X = _rows(models["rng"], 25)
    a = CompiledScorer(model, device="cpu").anomaly_arrays(X)
    b = CompiledScorer(loaded, device="cpu").anomaly_arrays(X)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    if name != "ff-window":
        assert any(k.endswith("OptimizedLSTMCell_0.kernel_i") for k in state)


def test_lstm_training_is_refused_naming_its_item(models):
    X = _rows(models["rng"], 60)
    detector = models["port"]["ae"].clone()
    for train in (lambda: detector.fit(X, device="cpu"),
                  lambda: detector.cross_validate(X, device="cpu")):
        with pytest.raises(NotImplementedError, match="LSTM training"):
            train()


def _lstm_estimator(kind: str, tags: int) -> LSTMAutoEncoder:
    """A port LSTM estimator at ``kind``'s default widths for ``tags``,
    with its factory's initial params."""
    module = lookup_factory("LSTMAutoEncoder", kind)(
        n_features=tags, n_features_out=tags, lookback_window=3)
    state = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    return LSTMAutoEncoder(kind=kind, lookback_window=3).load_state_arrays(state)


def _with_window(models, window: int) -> DiffBasedAnomalyDetector:
    """The fitted ``ff-window`` detector with another ``window``."""
    source = models["port"]["ff-window"]
    detector = DiffBasedAnomalyDetector(
        base_estimator=copy.deepcopy(source.base_estimator),
        scaler=copy.deepcopy(source.scaler), window=window)
    detector.feature_thresholds_ = source.feature_thresholds_
    detector.aggregate_threshold_ = source.aggregate_threshold_
    return detector


@pytest.mark.parametrize("case", ["lstm_model defaults", "lstm_hourglass at 94 tags",
                                  "window over MAX_WINDOW"])
def test_chains_the_kernels_cannot_take_are_refused_at_load(models, tmp_path, case):
    """Wide LSTM layers (weights over a block's shared memory) and windows
    longer than ``rolling_median`` holds raise ``NotImplementedError``
    naming their ROADMAP item when the model loads, on every device, so
    the server never takes a model it would answer with client errors."""
    if case == "window over MAX_WINDOW":
        model, item = _with_window(models, rm.MAX_WINDOW + 1), "item 15"
    else:
        kind, tags = ("lstm_model", N_TAGS) if case == "lstm_model defaults" else ("lstm_hourglass", 94)
        model, item = _lstm_estimator(kind, tags), "item 14"
    with pytest.raises(NotImplementedError, match=item):
        CompiledScorer(model, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        FleetScorer.from_models({"m": model}, device="cpu")
    serializer.dump(model, str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match=item):
        ModelCollection.from_directory(str(tmp_path / "m"), device="cpu")


def test_the_widest_chains_the_kernels_take_load(models):
    for model in (_lstm_estimator("lstm_hourglass", 92), _with_window(models, rm.MAX_WINDOW)):
        CompiledScorer(model, device="cpu")


def test_slot_ints_already_on_the_device_are_taken_as_they_are():
    """``_Stack.run`` copies a request's slot indices and counts to the
    device once and hands every kernel the same tensors."""
    cpu = torch.device("cpu")
    t = torch.tensor([0, 2], dtype=torch.int32)
    assert fs.slot_ints(t, "idx", 0, 3, cpu) is t
    got = fs.slot_ints([0, 2], "idx", 0, 3, cpu)
    assert got.dtype == torch.int32 and got.tolist() == [0, 2]
    with pytest.raises(ValueError, match=r"\[0, 3\]"):
        fs.slot_ints([0, 4], "idx", 0, 3, cpu)
    with pytest.raises(ValueError, match="int32"):
        fs.slot_ints(t.long(), "idx", 0, 3, cpu)
