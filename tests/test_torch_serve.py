"""The port's server against the JAX package's scorers.

Three JAX default detectors (``DEFAULT_MODEL``, 4 tags, one epoch) are
fitted once, given thresholds from seeded numpy, carried across with
``gordo_tpu_torch.convert`` and served by the port on the CPU.  Every
route's JSON is held to ``CompiledScorer.predict`` / ``anomaly_arrays``
and ``FleetScorer.score_all`` of the JAX package.  Tolerance: ``max|ref -
port| / max|ref|`` per output series, <= 1e-5 in float32 (the ROADMAP
parity metric).
"""

import copy
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.serve.fleet_scorer import FleetScorer as JaxFleetScorer
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.workflow.config import DEFAULT_MODEL
import gordo_tpu_torch
from gordo_tpu_torch import convert, serializer
from gordo_tpu_torch.kernels import fleet_score as fs
from gordo_tpu_torch.serve.server import ModelCollection, make_server

TOL = 1e-5
TAGS = 4
PROJECT = "proj"


def max_norm_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def carry(jax_model):
    """The port's model for a fitted JAX detector or pipeline."""
    detector = hasattr(jax_model, "base_estimator")
    pipe = jax_model.base_estimator if detector else jax_model
    host = lambda stats: {k: np.asarray(v) for k, v in stats.items()}  # noqa: E731
    kw = {}
    if detector:
        kw = dict(
            detector_stats=host(jax_model.scaler.stats_),
            feature_thresholds=jax_model.feature_thresholds_,
            aggregate_threshold=jax_model.aggregate_threshold_,
        )
    return convert.from_reference(
        jax_serializer.into_definition(jax_model),
        jax.tree.map(np.asarray, pipe._final.params_),
        scaler_stats=[host(step.stats_) for _, step in pipe.steps[:-1]],
        **kw,
    )


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    rng = np.random.default_rng(7)
    definition = copy.deepcopy(DEFAULT_MODEL)
    steps = definition["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"][
        "base_estimator"]["gordo_tpu.pipeline.Pipeline"]["steps"]
    steps[1]["gordo_tpu.models.estimator.AutoEncoder"]["epochs"] = 1
    jax_models = {}
    for i in range(3):
        t = np.arange(300)[:, None]
        X = np.sin(0.05 * t * (1 + np.arange(TAGS)) + i) + 0.1 * rng.standard_normal((300, TAGS))
        model = jax_serializer.from_definition(copy.deepcopy(definition))
        model.fit(X.astype(np.float32))
        model.feature_thresholds_ = rng.uniform(0.05, 0.5, TAGS).astype(np.float32)
        model.aggregate_threshold_ = float(rng.uniform(0.2, 1.0))
        jax_models[f"machine-{i}"] = model
    # the same weights without thresholds (refused on anomaly routes), and
    # the bare pipeline (no anomaly route)
    unthresholded = copy.copy(jax_models["machine-0"])
    unthresholded.feature_thresholds_ = None
    unthresholded.aggregate_threshold_ = None
    extras = {
        "no-thresholds": unthresholded,
        "pipeline-only": jax_models["machine-1"].base_estimator,
    }
    out = tmp_path_factory.mktemp("port-models")
    for name, model in {**jax_models, **extras}.items():
        meta = {"dataset": {"tag_list": [f"tag-{j}" for j in range(TAGS)]}}
        serializer.dump(carry(model), str(out / name), metadata=meta)
    collection = ModelCollection.from_directory(str(out), project=PROJECT, device="cpu")
    server = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/{PROJECT}"
    yield {"jax": jax_models, "extras": extras, "base": base, "rng": rng}
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def call(url, payload=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        try:
            return exc.code, json.loads(body)
        except ValueError:
            return exc.code, body


def _rows(rng, n):
    return rng.standard_normal((n, TAGS)).astype(np.float32)


def _assert_series(ref: dict, got: dict):
    assert set(got) == set(ref)
    for k in ref:
        assert np.shape(got[k]) == np.shape(ref[k]), k
        assert max_norm_err(ref[k], got[k]) <= TOL, k


def test_healthcheck_and_metadata(fleet):
    status, body = call(f"{fleet['base']}/machine-0/healthcheck")
    assert status == 200
    assert body == {"gordo-server-version": gordo_tpu_torch.__version__}
    status, body = call(f"{fleet['base']}/machine-2/metadata")
    assert status == 200
    assert body["endpoint-metadata"] == {"model-name": "machine-2"}
    assert body["metadata"]["dataset"]["tag_list"] == [f"tag-{j}" for j in range(TAGS)]


@pytest.mark.parametrize("name", ["machine-0", "machine-1", "machine-2", "pipeline-only"])
def test_prediction_matches_jax(fleet, name):
    X = _rows(fleet["rng"], 37)
    jax_model = {**fleet["jax"], **fleet["extras"]}[name]
    ref = JaxScorer(jax_model).predict(X)
    status, body = call(f"{fleet['base']}/{name}/prediction", {"X": X.tolist()})
    assert status == 200
    assert set(body) == {"data", "time-seconds"}
    _assert_series({"model-output": ref}, body["data"])


@pytest.mark.parametrize("name", ["machine-0", "machine-1", "machine-2"])
def test_anomaly_prediction_matches_jax(fleet, name):
    X = _rows(fleet["rng"], 300)
    ref = JaxScorer(fleet["jax"][name]).anomaly_arrays(X)
    status, body = call(f"{fleet['base']}/{name}/anomaly/prediction", {"X": X.tolist()})
    assert status == 200
    assert list(body["data"]) == list(ref)
    _assert_series(ref, body["data"])


def test_record_style_X_matches_list_of_lists(fleet):
    X = _rows(fleet["rng"], 5)
    records = [{f"tag-{j}": float(v) for j, v in enumerate(row)} for row in X]
    url = f"{fleet['base']}/machine-1/anomaly/prediction"
    _, by_rows = call(url, {"X": X.tolist()})
    status, by_records = call(url, {"X": records})
    assert status == 200
    assert by_records["data"] == by_rows["data"]


def test_bulk_matches_jax_fleet_scorer(fleet):
    rng = fleet["rng"]
    # ragged row counts, and a subset of the bucket
    for names, rows in (
        (["machine-0", "machine-1", "machine-2"], [64, 40, 1]),
        (["machine-2", "machine-0"], [17, 17]),
    ):
        X_by = {n: _rows(rng, r) for n, r in zip(names, rows)}
        ref = JaxFleetScorer.from_models(
            {n: fleet["jax"][n] for n in names}
        ).score_all(X_by)
        before = fs.launches
        status, body = call(
            f"{fleet['base']}/_bulk/anomaly/prediction",
            {"X": {n: X.tolist() for n, X in X_by.items()}},
        )
        assert status == 200
        assert fs.launches == before  # the CPU never launches the kernel
        assert set(body["data"]) == set(names)
        for n in names:
            _assert_series(ref[n], body["data"][n])


def test_unknown_machine_is_404(fleet):
    status, body = call(f"{fleet['base']}/no-such-machine/healthcheck")
    assert status == 404
    assert "no-such-machine" in body
    status, _ = call(f"{fleet['base']}/no-such-machine/anomaly/prediction", {"X": [[0] * TAGS]})
    assert status == 404


@pytest.mark.parametrize("payload", [
    {"X": [["a", 1, 2, 3]]},
    {"X": [[[0, 1, 2, 3]]]},
    {"Y": [[0, 1, 2, 3]]},
    {"X": [[0, 1, 2]]},
])
@pytest.mark.parametrize("route", ["prediction", "anomaly/prediction"])
def test_malformed_X_is_400(fleet, route, payload):
    status, body = call(f"{fleet['base']}/machine-0/{route}", payload)
    assert status == 400
    assert "error" in body


def test_invalid_json_is_400(fleet):
    status, body = call(f"{fleet['base']}/machine-0/prediction", raw=b"{not json")
    assert status == 400


def test_bulk_wrong_column_count_is_400(fleet):
    url = f"{fleet['base']}/_bulk/anomaly/prediction"
    status, body = call(url, {"X": {"machine-0": [[0.0, 1.0]], "machine-1": [[1.0]]}})
    assert status == 400
    assert body["error"] == "No valid machines in payload"
    assert set(body["data"]) == {"machine-0", "machine-1"}
    # beside a valid machine, the bad one reports in its own slot
    status, body = call(url, {"X": {"machine-0": [[0.0, 1.0]], "machine-1": [[1.0] * TAGS]}})
    assert status == 200
    assert "columns" in body["data"]["machine-0"]["error"]
    assert "total-anomaly-score" in body["data"]["machine-1"]
    status, _ = call(url, {"X": [[0.0] * TAGS]})
    assert status == 400


def test_require_thresholds_refusal_matches_jax(fleet):
    X = _rows(fleet["rng"], 8)
    with pytest.raises(AttributeError) as refused:
        JaxScorer(fleet["extras"]["no-thresholds"]).anomaly_arrays(X)
    status, body = call(f"{fleet['base']}/no-thresholds/anomaly/prediction", {"X": X.tolist()})
    assert status == 500
    assert body == {"error": str(refused.value)}
    # its prediction still serves
    status, _ = call(f"{fleet['base']}/no-thresholds/prediction", {"X": X.tolist()})
    assert status == 200
    # and the bulk route reports the refusal in its slot
    status, body = call(
        f"{fleet['base']}/_bulk/anomaly/prediction",
        {"X": {"no-thresholds": X.tolist(), "machine-0": X.tolist()}},
    )
    assert status == 200
    assert body["data"]["no-thresholds"] == {"error": str(refused.value)}
    assert "anomaly-confidence" in body["data"]["machine-0"]


def test_anomaly_route_on_a_pipeline_is_422(fleet):
    status, body = call(
        f"{fleet['base']}/pipeline-only/anomaly/prediction", {"X": [[0.0] * TAGS]}
    )
    assert status == 422
    assert "not an AnomalyDetector" in body["error"]
