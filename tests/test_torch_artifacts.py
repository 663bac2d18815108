"""The port's artifacts carry the fitted metadata.

``serializer.dump`` writes, beside ``arrays.npz``, what ``get_metadata()``
reads from a fitted model (the detector's ``cv_metadata_``, the
estimator's ``history_`` and ``fit_seconds_``) and a pad-up build's
``pad_built_``; ``load`` restores them.  So ``load(dump(det))
.get_metadata()`` equals ``det.get_metadata()``, and has the keys of the
JAX package's round trip of the same model (which pickles the object).
Models are fitted on the CPU (the kernels' plain versions): the default
pipeline, and an LSTM detector at ``tests/lstm_detectors.py``'s shapes
(the JAX side fits only that shared LSTM shape).
"""

import copy

import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.workflow.config import DEFAULT_MODEL
from gordo_tpu_torch import serializer
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from lstm_detectors import ROWS, fitted_lstm_detector
from torch_parity import sine_rows


def key_paths(tree, prefix=()):
    """Every key path of a nested dict."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= key_paths(v, prefix + (k,))
    return out


def _default_definition(epochs=2):
    definition = copy.deepcopy(DEFAULT_MODEL)
    steps = definition["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"][
        "base_estimator"]["gordo_tpu.pipeline.Pipeline"]["steps"]
    steps[1]["gordo_tpu.models.estimator.AutoEncoder"].update(epochs=epochs, batch_size=32)
    return definition


def _round_trip(det, path):
    return serializer.load(serializer.dump(det, str(path)))


def _jax_round_trip(det, path):
    return jax_serializer.load(jax_serializer.dump(det, str(path)))


@pytest.fixture(scope="module")
def ff_models():
    rng = np.random.default_rng(3)
    X = sine_rows(rng, 200, 4)
    definition = _default_definition()
    port = from_definition(copy.deepcopy(definition))
    port.cross_validate(X, device="cpu")
    port.fit(X, device="cpu")
    jax_det = jax_serializer.from_definition(copy.deepcopy(definition))
    jax_det.cross_validate(X)
    jax_det.fit(X)
    return {"port": port, "jax": jax_det, "X": X}


@pytest.fixture(scope="module")
def lstm_models():
    rng = np.random.default_rng(4)
    jax_det = fitted_lstm_detector(rng)
    X = np.random.default_rng(5).standard_normal((ROWS, 3)).astype(np.float32)
    port = from_definition(jax_serializer.into_definition(jax_det))
    port.cross_validate(X, device="cpu")
    port.fit(X, device="cpu")
    return {"port": port, "jax": jax_det, "X": X}


@pytest.fixture(params=["feedforward", "lstm"])
def models(request, ff_models, lstm_models):
    return ff_models if request.param == "feedforward" else lstm_models


def test_round_trip_keeps_get_metadata(models, tmp_path):
    det = models["port"]
    meta = det.get_metadata()
    assert meta["cross_validation"]["scores"]
    assert meta["base_estimator"]["history"]["loss"]
    assert meta["base_estimator"]["fit_seconds"] is not None
    loaded = _round_trip(det, tmp_path / "m")
    assert loaded.get_metadata() == meta
    # the arrays came back with it: the same scores, bit for bit
    X = models["X"][:50]
    got = loaded.anomaly(X, device="cpu")
    ref = det.anomaly(X, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_round_trip_has_the_keys_of_the_jax_round_trip(models, tmp_path):
    port = _round_trip(models["port"], tmp_path / "port").get_metadata()
    ref = _jax_round_trip(models["jax"], tmp_path / "jax").get_metadata()
    assert key_paths(port) == key_paths(ref)
    assert len(port["base_estimator"]["history"]["loss"]) == len(ref["base_estimator"]["history"]["loss"])


def test_round_trip_keeps_pad_built(tmp_path):
    rng = np.random.default_rng(6)
    lengths = [162, 170, 185]
    Xs = [sine_rows(rng, n, 4) for n in lengths]
    spec = analyze_definition(from_definition(_default_definition(epochs=1)))
    detectors = FleetDiffBuilder(spec, pad_lengths=64, device="cpu").build(Xs)
    assert all(getattr(d, "pad_built_", False) for d in detectors)
    for i, det in enumerate(detectors):
        loaded = _round_trip(det, tmp_path / f"m{i}")
        assert loaded.pad_built_ is True
        assert loaded.get_metadata() == det.get_metadata()
    # an exact build's detector has no pad_built_, before and after
    exact = FleetDiffBuilder(spec, device="cpu").build(Xs[:1])[0]
    assert not hasattr(_round_trip(exact, tmp_path / "exact"), "pad_built_")


def test_artifacts_without_fitted_json_still_load(ff_models, tmp_path):
    """An artifact written before the metadata was carried loads as before,
    its arrays intact and its fitted metadata empty."""
    import os

    path = serializer.dump(ff_models["port"], str(tmp_path / "old"))
    os.remove(os.path.join(path, serializer.FITTED_FILE))
    loaded = serializer.load(path)
    assert "cross_validation" not in loaded.get_metadata()
    np.testing.assert_array_equal(loaded.feature_thresholds_, ff_models["port"].feature_thresholds_)
