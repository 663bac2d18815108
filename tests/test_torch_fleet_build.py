"""The port's fleet build of the default detector against the JAX package's.

Four machines in two length groups (162 and 203 rows, 4 tags: the last
fold's test block is longer than the others, so out-of-fold scoring and
the epilogue take ragged slots) are built by
``gordo_tpu.parallel.anomaly.FleetDiffBuilder`` and by the port's, on the
CPU (the kernels' plain versions), the port from the JAX package's initial
params and epoch permutations (``tests/torch_parity.py``).  Bounds, per
machine and output series, ``max|ref - port| / max|ref|``:

- scaler and detector stats: 1e-6 (measured 0);
- final params, loss history, thresholds, MSE, MAE, r2: 1e-5 (measured on
  this container <= 9.9e-7; the sums inside a matmul run in another order
  than XLA's, and Adam amplifies that where gradients are small);
- explained variance: 1e-4 (measured <= 3.1e-6): ``1 - var(y - p) /
  var(y)`` of a well-fitted fold is a small difference of near-equal
  numbers, which magnifies the error of its parts;
- a served response of a port-built detector against the JAX-built one
  scored by JAX: 1e-5 (measured <= 6e-7).
"""

import copy
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gordo_tpu.parallel.anomaly import FleetDiffBuilder as JaxBuilder
from gordo_tpu.parallel.anomaly import analyze_definition as jax_analyze
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.workflow.config import DEFAULT_MODEL
from gordo_tpu_torch import serializer
from gordo_tpu_torch.kernels import cv_epilogue as ce
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.serve.server import ModelCollection, make_server
from torch_parity import jax_draws, port_params, r12, sine_rows

TAGS = 4
LENGTHS = (162, 203, 162, 203)
STATS_TOL = 1e-6
FIT_TOL = 1e-5
EV_TOL = 1e-4
SERVE_TOL = 1e-5


def definition(epochs=2, batch_size=64):
    d = copy.deepcopy(DEFAULT_MODEL)
    steps = d["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
        "gordo_tpu.pipeline.Pipeline"]["steps"]
    steps[1]["gordo_tpu.models.estimator.AutoEncoder"].update(epochs=epochs, batch_size=batch_size)
    return d


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    return [sine_rows(rng, n, TAGS, phase=i) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def jax_fleet(inputs):
    spec = jax_analyze(jax_from_definition(definition()))
    return JaxBuilder(spec).build(inputs)


@pytest.fixture(scope="module")
def port_fleet(inputs):
    spec = analyze_definition(from_definition(definition()))
    return FleetDiffBuilder(spec, device="cpu", draws=jax_draws).build(inputs)


def assert_same_detector(ref, got, what=""):
    pipe_ref, pipe = ref.base_estimator, got.base_estimator
    for key in ("scale", "offset"):
        assert r12(pipe_ref.steps[0][1].stats_[key], pipe.steps[0][1].stats_[key]) <= STATS_TOL, what
        assert r12(ref.scaler.stats_[key], got.scaler.stats_[key]) <= STATS_TOL, what
    params = port_params(pipe._final)
    for name, leaf in jax.tree.map(np.asarray, pipe_ref._final.params_).items():
        for key in ("kernel", "bias"):
            if np.any(leaf[key]):
                assert r12(leaf[key], params[name][key]) <= FIT_TOL, (what, name, key)
    assert r12(pipe_ref._final.history_, pipe._final.history_) <= FIT_TOL, what
    assert r12(ref.feature_thresholds_, got.feature_thresholds_) <= FIT_TOL, what
    assert r12(ref.aggregate_threshold_, got.aggregate_threshold_) <= FIT_TOL, what
    for name in ce.METRIC_NAMES:
        tol = EV_TOL if name == "explained_variance_score" else FIT_TOL
        want = ref.cv_metadata_["scores"][name]
        have = got.cv_metadata_["scores"][name]
        assert r12(want["folds"], have["folds"]) <= tol, (what, name)
        assert r12(want["mean"], have["mean"]) <= tol, (what, name)


# -- (d) the fleet build -----------------------------------------------------

@pytest.mark.parametrize("machine", range(len(LENGTHS)))
def test_fleet_build_matches_jax(jax_fleet, port_fleet, machine):
    ref, got = jax_fleet[machine], port_fleet[machine]
    assert got.feature_thresholds_.shape == (TAGS,)
    assert np.isfinite(got.feature_thresholds_).all()
    assert got.cv_metadata_["fleet"]["bucket_size"] == 2
    assert_same_detector(ref, got, f"machine {machine}")


def test_fleet_build_refuses_unported_modes(inputs):
    spec = analyze_definition(from_definition(definition()))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        FleetDiffBuilder(spec, pad_lengths=100, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        FleetDiffBuilder(spec, device="cpu").build(inputs[:1], warm_params=[{}])


def test_analyze_definition_matches_jax():
    assert analyze_definition(from_definition(definition())) is not None
    detector = from_definition(definition())
    assert analyze_definition(detector.base_estimator) is None  # not a detector
    spec = analyze_definition(detector)
    ref = jax_analyze(jax_from_definition(definition()))
    assert (spec.train_cfg.epochs, spec.train_cfg.batch_size, spec.seed) == (
        ref.train_cfg.epochs, ref.train_cfg.batch_size, ref.seed
    )


# -- (e) one machine: cross_validate then fit ---------------------------------

@pytest.mark.parametrize("cv", [None, {"KFold": {"n_splits": 3}}], ids=["tss", "kfold"])
def test_single_machine_matches_jax(inputs, jax_fleet, cv):
    # KFold's train rows are not a prefix: the fits take index lists
    X = inputs[1]
    ref = jax_from_definition(definition())
    ref.cross_validate(X, cv=cv)
    ref.fit(X)
    got = from_definition(definition())
    results = got.cross_validate(X, cv=cv, device="cpu", draws=jax_draws)
    got.fit(X, device="cpu", draws=jax_draws)
    assert_same_detector(ref, got, "single machine")
    assert len(results["predictions"]) == 3
    for te, y_true, pred in results["predictions"]:
        assert pred.shape == y_true.shape == (len(te), TAGS)
    assert got.get_metadata()["cross_validation"]["aggregate_threshold"] == got.aggregate_threshold_
    if cv is None:
        # the JAX single-machine path equals its fleet build; so does the port's
        assert_same_detector(jax_fleet[1], got, "single vs fleet")


# -- (f) serve a port-built detector ------------------------------------------

def test_port_built_detector_serves_like_jax(jax_fleet, port_fleet, inputs, tmp_path):
    for i in (0, 1):
        meta = {"dataset": {"tag_list": [f"m{i}-t{j}" for j in range(TAGS)]}}
        serializer.dump(port_fleet[i], str(tmp_path / f"m{i}"), metadata=meta)
    collection = ModelCollection.from_directory(str(tmp_path), project="p", device="cpu")
    server = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for i in (0, 1):
            X = inputs[i][:50]
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/p/m{i}/anomaly/prediction",
                data=json.dumps({"X": X.tolist()}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                body = json.loads(resp.read())["data"]
            ref = JaxScorer(jax_fleet[i]).anomaly_arrays(X)
            for key in ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence"):
                assert r12(np.asarray(ref[key]), np.asarray(body[key])) <= SERVE_TOL, (i, key)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


# -- (g) a machine's model does not depend on its fleet ------------------------

def test_machine_alone_equals_machine_in_fleet(inputs):
    spec = analyze_definition(from_definition(definition()))
    fleet = FleetDiffBuilder(spec, device="cpu").build(inputs)
    alone = FleetDiffBuilder(spec, device="cpu").build([inputs[2]])[0]
    single = from_definition(definition())
    single.cross_validate(inputs[2], device="cpu")
    single.fit(inputs[2], device="cpu")
    for other in (alone, single):
        for (lin_a, _), (lin_b, _) in zip(
            fleet[2].base_estimator._final.module_.layers(),
            other.base_estimator._final.module_.layers(),
        ):
            torch.testing.assert_close(lin_a.weight, lin_b.weight, rtol=0, atol=1e-6)
        np.testing.assert_allclose(fleet[2].feature_thresholds_, other.feature_thresholds_, rtol=1e-5)
        np.testing.assert_allclose(
            fleet[2].base_estimator._final.history_, other.base_estimator._final.history_, rtol=1e-6
        )
