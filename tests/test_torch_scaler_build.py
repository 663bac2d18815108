"""Detectors with StandardScaler, RobustScaler and chains of scalers,
built, served and streamed by the port against the JAX package.

Feedforward detectors (4 tags, 2 epochs, batch 64) on machines of 140 to
203 rows, built on the CPU (the kernels' plain versions; the port from the
JAX package's draws, ``tests/torch_parity.py``):

- ``robust_standard``: ``Pipeline[RobustScaler, AutoEncoder]`` with a
  ``StandardScaler`` detector scaler, built exactly, pad-up
  (``pad_lengths=64``) and warm from the JAX cold build's params, and by
  one machine's ``cross_validate`` + ``fit``;
- ``chain``: ``Pipeline[StandardScaler, MinMaxScaler((1, -1)),
  RobustScaler((10, 90)), AutoEncoder]`` with a ``RobustScaler((10, 90),
  with_centering=False)`` detector scaler, built exactly;
- an ``LSTMAutoEncoder`` bucket behind a ``RobustScaler`` (130 rows,
  lookback 4, the JAX build in a fresh process as
  ``tests/test_torch_lstm_fleet_build.py`` runs it);
- served (f32 and bf16) and streamed against the JAX package's
  ``CompiledScorer`` and ``MachineStream``; one project YAML built by both
  packages through ``build_project``.

Bounds, per machine and output series, ``max|ref - port| / max|ref|``
(measured on the CPU): the first chain step's and the detector scaler's
stats 1e-6 (measured <= 6.7e-7), and every step's output on the
reference's input to it 1e-6 (measured <= 4.2e-7; a later step's leaves
are held through their output, ``assert_same_stats``); params, history,
thresholds, mse, mae, r2 1e-5 (measured: params <= 1.0e-6, thresholds
<= 2.6e-7); explained variance 1e-4 (CV scores measured <= 3.0e-6);
served and streamed scores 1e-5 (measured <= 7.2e-7 over HTTP, <= 5.7e-7
for a carried JAX detector, <= 1.4e-7 streamed); bf16 serving 3% model
output and 10% scores against JAX at f32
(``tests/test_torch_precision.py``'s bounds; measured 0.60% and 0.64%);
the LSTM bucket as ``tests/test_torch_lstm_fleet_build.py`` holds it:
stats 1e-6 (measured 8.8e-8), params 1e-4 (8.5e-7), history 1e-5
(1.2e-7), thresholds 1e-4 (1.6e-7), CV scores 1e-3 (3.6e-5), scores of
the port-built detector 1e-4 (1.1e-6); one YAML by both packages:
thresholds (9.4e-8), CV scores (5.5e-7) and anomaly outputs (4.9e-7)
within 1e-5.  The fits, the out-of-fold scorer and the stream take the
chain folded into one ``x * scale + offset``; the reference applies each
step as ``(x - mean) / std``: a few ulp apart on these columns.
"""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder import fleet_build as jax_fleet_build
from gordo_tpu.parallel.anomaly import FleetDiffBuilder as JaxBuilder
from gordo_tpu.parallel.anomaly import analyze_definition as jax_analyze
from gordo_tpu.serializer import from_definition as jax_from_definition
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.serve.stream import MachineStream as JaxMachineStream
from gordo_tpu.workflow import config as jax_config
from gordo_tpu_torch import convert, serializer
from gordo_tpu_torch.bench import project_config
from gordo_tpu_torch.builder import fleet_build
from gordo_tpu_torch.dataset.base import GordoBaseDataset
from gordo_tpu_torch.kernels import cv_epilogue as ce
from gordo_tpu_torch.ops.scalers import RobustScaler, StandardScaler
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.server import ModelCollection, make_server
from gordo_tpu_torch.serve.stream import MachineStream
from gordo_tpu_torch.workflow import config
from torch_parity import (
    flatten,
    jax_draws,
    port_params,
    r12,
    recorded_draws,
    run_in_fresh_process,
    sine_rows,
    unflatten,
)

TAGS = 4
LENGTHS = (162, 203, 162, 203)
PAD_LENGTHS = (140, 162, 185, 203)
PAD = 64
STATS_TOL = 1e-6
FIT_TOL = 1e-5
EV_TOL = 1e-4
SERVE_TOL = 1e-5
BF16_BOUNDS = {"model-output": 0.03, "tag-anomaly-scores": 0.10,
               "total-anomaly-score": 0.10, "anomaly-confidence": 0.10}
OUTPUTS = tuple(BF16_BOUNDS)
SCALERS = "gordo_tpu.ops.scalers"


def definition(steps, detector_scaler, estimator=None):
    estimator = estimator or {"gordo_tpu.models.estimator.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 2, "batch_size": 64}}
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "scaler": detector_scaler,
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [*steps, estimator]}}}}


DEFINITIONS = {
    "robust_standard": definition([f"{SCALERS}.RobustScaler"], f"{SCALERS}.StandardScaler"),
    "chain": definition(
        [f"{SCALERS}.StandardScaler",
         {f"{SCALERS}.MinMaxScaler": {"feature_range": [1, -1]}},
         {f"{SCALERS}.RobustScaler": {"quantile_range": [10.0, 90.0]}}],
        {f"{SCALERS}.RobustScaler": {"quantile_range": [10.0, 90.0], "with_centering": False}}),
}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(41)
    return [sine_rows(rng, n, TAGS, phase=0.7 * i) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def exact_builds(inputs):
    out = {}
    for name, d in DEFINITIONS.items():
        ref = JaxBuilder(jax_analyze(jax_from_definition(d))).build(inputs)
        got = FleetDiffBuilder(analyze_definition(from_definition(d)), device="cpu",
                               draws=jax_draws).build(inputs)
        out[name] = (ref, got)
    return out


@pytest.fixture(scope="module")
def padded_builds():
    rng = np.random.default_rng(43)
    Xs = [sine_rows(rng, n, TAGS, phase=0.4 * i) for i, n in enumerate(PAD_LENGTHS)]
    d = DEFINITIONS["robust_standard"]
    spec_j, spec_p = jax_analyze(jax_from_definition(d)), analyze_definition(from_definition(d))
    jax_cold = JaxBuilder(spec_j, pad_lengths=PAD).build(Xs)
    port_cold = FleetDiffBuilder(spec_p, pad_lengths=PAD, device="cpu", draws=jax_draws).build(Xs)
    warm = [jax.tree.map(np.asarray, det.base_estimator._final.params_) for det in jax_cold]
    jax_warm = JaxBuilder(spec_j, pad_lengths=PAD).build(Xs, warm_params=warm)
    port_warm = FleetDiffBuilder(spec_p, pad_lengths=PAD, device="cpu", draws=jax_draws).build(
        Xs, warm_params=[convert.flax_to_state_arrays(p) for p in warm])
    return {"cold": (jax_cold, port_cold), "warm": (jax_warm, port_warm), "X": Xs}


def assert_same_stats(ref_steps, got_steps, ref_det, got_det, X, what):
    """Each chain step's and the detector scaler's stats, under the
    reference's keys: the first step's and the detector's leaf by leaf;
    every step through what it does, its output on the reference's input
    to it (the machine's rows ``X`` through the reference's earlier
    steps).  A later step's leaves can be rounding residue: a MinMax
    after a MinMax has offsets of ~1e-8 in the reference (XLA:CPU fuses
    ``x * scale + offset`` into one rounding) and 0 in the port."""
    assert [type(s).__name__ for s in got_steps] == [type(s).__name__ for s in ref_steps], what
    Z = np.asarray(X, np.float32)
    for i, (r, g) in enumerate(zip(ref_steps, got_steps)):
        assert sorted(g.stats_) == sorted(r.stats_), what
        if i == 0:
            for key, leaf in r.stats_.items():
                assert r12(leaf, g.stats_[key]) <= STATS_TOL, (what, i, key)
        want = np.asarray(type(r).apply(r.stats_, Z))
        assert r12(want, type(g).apply(g.stats_, Z)) <= STATS_TOL, (what, i, "output")
        Z = want
    assert sorted(got_det.stats_) == sorted(ref_det.stats_), what
    for key, leaf in ref_det.stats_.items():
        assert r12(leaf, got_det.stats_[key]) <= STATS_TOL, (what, "detector", key)


def assert_same_detector(ref, got, X, what):
    pipe_ref, pipe = ref.base_estimator, got.base_estimator
    assert_same_stats([s for _, s in pipe_ref.steps[:-1]], [s for _, s in pipe.steps[:-1]],
                      ref.scaler, got.scaler, X, what)
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


# -- fleet builds: exact, pad-up, warm -------------------------------------------

@pytest.mark.parametrize("name,machine", [(n, i) for n in DEFINITIONS for i in range(len(LENGTHS))])
def test_exact_build_matches_jax(exact_builds, inputs, name, machine):
    ref, got = exact_builds[name][0][machine], exact_builds[name][1][machine]
    assert np.isfinite(got.feature_thresholds_).all()
    assert got.cv_metadata_["fleet"]["bucket_size"] == 2
    assert_same_detector(ref, got, inputs[machine], f"{name} machine {machine}")


@pytest.mark.parametrize("kind,machine", [(k, i) for k in ("cold", "warm") for i in range(len(PAD_LENGTHS))])
def test_padded_and_warm_builds_match_jax(padded_builds, kind, machine):
    ref, got = padded_builds[kind][0][machine], padded_builds[kind][1][machine]
    # the 140-row machine is demoted to the exact path, as in the JAX package
    assert getattr(got, "pad_built_", False) == getattr(ref, "pad_built_", False) == (machine != 0)
    assert_same_detector(ref, got, padded_builds["X"][machine], f"{kind} machine {machine}")


def test_single_machine_matches_jax(inputs, exact_builds):
    X = inputs[1]
    d = DEFINITIONS["robust_standard"]
    ref = jax_from_definition(d)
    ref.cross_validate(X)
    ref.fit(X)
    got = from_definition(d)
    got.cross_validate(X, device="cpu", draws=jax_draws)
    got.fit(X, device="cpu", draws=jax_draws)
    assert isinstance(got.scaler, StandardScaler)
    assert isinstance(got.base_estimator.steps[0][1], RobustScaler)
    assert_same_detector(ref, got, X, "single machine")
    # the single path's final fit takes the rows scaled step by step, the
    # fleet's the folded map: the same detector within the fit bound
    assert_same_detector(exact_builds["robust_standard"][0][1], got, X, "single vs fleet")


# -- serving and streaming -----------------------------------------------------------

def test_port_built_detectors_serve_like_jax(exact_builds, inputs, tmp_path):
    """Both definitions' port-built detectors over HTTP (per machine and
    bulk) against the JAX-built ones scored by JAX, f32."""
    names = {}
    for name, (_, got) in exact_builds.items():
        for i in (0, 1):
            names[f"{name}-{i}"] = (name, i)
            serializer.dump(got[i], str(tmp_path / f"{name}-{i}"),
                            metadata={"dataset": {"tag_list": [f"t{j}" for j in range(TAGS)]}})
    collection = ModelCollection.from_directory(str(tmp_path), project="p", device="cpu")
    server = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/p"

    def post(url, body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        X = {m: inputs[i][-50:] for m, (_, i) in names.items()}
        bulk = post(f"{base}/_bulk/anomaly/prediction", {"X": {m: x.tolist() for m, x in X.items()}})
        for m, (name, i) in names.items():
            ref = JaxScorer(exact_builds[name][0][i]).anomaly_arrays(X[m])
            one = post(f"{base}/{m}/anomaly/prediction", {"X": X[m].tolist()})["data"]
            for body in (one, bulk["data"][m]):
                for key in OUTPUTS:
                    assert r12(np.asarray(ref[key]), np.asarray(body[key])) <= SERVE_TOL, (m, key)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("name", sorted(DEFINITIONS))
def test_carried_jax_detector_serves_and_streams_like_jax(exact_builds, inputs, name):
    """A JAX-built detector carried across (``convert.from_reference``):
    its requests at f32 and bf16 and its streamed rows against the JAX
    package's scorer and ``MachineStream``."""
    from torch_parity import carry

    jax_det = exact_builds[name][0][0]
    port_det = carry(jax_det)
    for (_, r), (_, g) in zip(jax_det.base_estimator.steps[:-1], port_det.base_estimator.steps[:-1]):
        assert type(g).__name__ == type(r).__name__
        assert all(np.array_equal(np.asarray(v), g.stats_[k]) for k, v in r.stats_.items())
    X = inputs[0][::-1][:60].copy()
    ref = JaxScorer(jax_det).anomaly_arrays(X)
    got = CompiledScorer(port_det, device="cpu").anomaly_arrays(X)
    for key in OUTPUTS:
        assert r12(np.asarray(ref[key]), got[key]) <= SERVE_TOL, key
    bf16 = CompiledScorer(port_det, device="cpu", dtype="bfloat16").anomaly_arrays(X)
    for key, tol in BF16_BOUNDS.items():
        err = float(np.abs(np.asarray(ref[key], np.float64) - bf16[key]).max()
                    / max(np.abs(np.asarray(ref[key])).max(), 1e-6))
        assert err <= tol, (key, err)
    jax_ms = JaxMachineStream("s", JaxScorer(jax_det))
    ms = MachineStream("s", CompiledScorer(port_det, device="cpu"))
    refs, gots = [], []
    for row in X[:30]:
        r, g = jax_ms.ingest(row), ms.ingest(row)
        assert (r is None) == (g is None)
        if r is not None:
            refs.append(r)
            gots.append(g)
    assert len(gots) == 30
    for key in refs[0]:
        want = np.stack([np.atleast_1d(r[key]) for r in refs])
        have = np.stack([np.atleast_1d(g[key]) for g in gots])
        assert r12(want, have) <= SERVE_TOL, key


# -- an LSTM bucket behind a RobustScaler -------------------------------------------

LSTM_ROWS, LSTM_LOOKBACK, LSTM_MACHINES = 130, 4, 2
LSTM_DEFINITION = definition(
    [f"{SCALERS}.RobustScaler"], f"{SCALERS}.RobustScaler",
    estimator={"gordo_tpu.models.estimator.LSTMAutoEncoder": {
        "kind": "lstm_hourglass", "lookback_window": LSTM_LOOKBACK, "epochs": 2, "batch_size": 32}})


def test_lstm_bucket_with_robust_scalers_matches_jax(tmp_path):
    rng = np.random.default_rng(67)
    Xs = [sine_rows(rng, LSTM_ROWS, TAGS, phase=i) for i in range(LSTM_MACHINES)]
    arrays = {f"X/{i}": X for i, X in enumerate(Xs)}
    arrays.update({f"score/{i}": X[::-1][:60].copy() for i, X in enumerate(Xs)})
    arrays["definition"] = np.array(json.dumps(LSTM_DEFINITION))
    ref = run_in_fresh_process("lstm_build_reference", arrays, tmp_path)
    got = FleetDiffBuilder(analyze_definition(from_definition(LSTM_DEFINITION)), device="cpu",
                           draws=recorded_draws(ref, "draws")).build(Xs)
    from gordo_tpu_torch.serve.scorer import CompiledScorer as PortScorer

    for i, det in enumerate(got):
        step = det.base_estimator.steps[0][1]
        assert isinstance(step, RobustScaler) and isinstance(det.scaler, RobustScaler)
        for key in ("center", "scale"):
            assert r12(ref[f"m{i}/scaler/{key}"], step.stats_[key]) <= STATS_TOL, (i, key)
            assert r12(ref[f"m{i}/detector/{key}"], det.scaler.stats_[key]) <= STATS_TOL, (i, key)
        est = det.base_estimator._final
        cells = [(c.kernel_i.detach().numpy(), c.kernel_h.detach().numpy(), c.bias.detach().numpy())
                 for c, _ in est.module_.cells()]
        head = (est.module_.out.weight.detach().numpy().T, est.module_.out.bias.detach().numpy())
        have = flatten(convert.lstm_layers_to_flax(cells, head))
        for key, leaf in flatten(unflatten(ref, f"m{i}/params")).items():
            if np.any(leaf):
                assert r12(leaf, have[key]) <= 1e-4, (i, key)
        assert r12(ref[f"m{i}/history"], est.history_) <= 1e-5, i
        assert r12(ref[f"m{i}/thresholds"], det.feature_thresholds_) <= 1e-4, i
        assert r12(ref[f"m{i}/aggregate"], det.aggregate_threshold_) <= 1e-4, i
        for name in ce.METRIC_NAMES:
            assert r12(ref[f"m{i}/scores/{name}"], det.cv_metadata_["scores"][name]["folds"]) <= 1e-3, (i, name)
        scored = PortScorer(det, device="cpu").anomaly_arrays(arrays[f"score/{i}"])
        for key in OUTPUTS:
            assert r12(ref[f"m{i}/anomaly/{key}"], scored[key]) <= 1e-4, (i, key)


# -- a project YAML through build_project -------------------------------------------

def scaler_project(machines, tags, rows):
    """``project_config``'s YAML with a ``RobustScaler`` pipeline step (by
    its sklearn path) and a ``StandardScaler`` detector scaler."""
    yaml = project_config(machines, tags, rows, epochs=2)
    yaml = yaml.replace("            - gordo_tpu.ops.scalers.MinMaxScaler",
                        "            - sklearn.preprocessing.RobustScaler")
    return yaml.replace("    gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector:\n",
                        "    gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector:\n"
                        "      scaler: sklearn.preprocessing.StandardScaler\n")


def test_project_yaml_with_these_scalers_builds_as_jax(tmp_path):
    yaml = scaler_project(3, 5, 144)
    assert "RobustScaler" in yaml and "StandardScaler" in yaml
    saved = os.environ.get("GORDO_FLEET_BASELINE")
    os.environ["GORDO_FLEET_BASELINE"] = "off"
    try:
        jax_cfg = jax_config.NormalizedConfig.from_source(yaml, "scalers")
        jax_result = jax_fleet_build.build_project(jax_cfg.machines, str(tmp_path / "jax"),
                                                   artifact_format="v1", ingest=False)
    finally:
        if saved is None:
            os.environ.pop("GORDO_FLEET_BASELINE")
        else:
            os.environ["GORDO_FLEET_BASELINE"] = saved
    cfg = config.NormalizedConfig.from_source(yaml, "scalers")
    result = fleet_build.build_project(cfg.machines, str(tmp_path / "port"), device="cpu")
    assert not jax_result.failed and not result.failed
    assert sorted(result.fleet_built) == sorted(jax_result.fleet_built) == sorted(m.name for m in cfg.machines)
    for m in cfg.machines:
        ref = jax_serializer.load(jax_result.artifacts[m.name])
        got = serializer.load(result.artifacts[m.name])
        assert isinstance(got.scaler, StandardScaler)
        X = np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)
        assert_same_stats([s for _, s in ref.base_estimator.steps[:-1]],
                          [s for _, s in got.base_estimator.steps[:-1]], ref.scaler, got.scaler, X, m.name)
        assert r12(np.append(ref.feature_thresholds_, ref.aggregate_threshold_),
                   np.append(got.feature_thresholds_, got.aggregate_threshold_)) <= FIT_TOL, m.name
        for name, score in ref.cv_metadata_["scores"].items():
            tol = EV_TOL if name == "explained_variance_score" else FIT_TOL
            assert r12(score["folds"], got.cv_metadata_["scores"][name]["folds"]) <= tol, (m.name, name)
        want = JaxScorer(ref).anomaly_arrays(X[:50])
        have = got.anomaly(X[:50], device="cpu")
        for key in OUTPUTS:
            assert r12(np.asarray(want[key]), np.asarray(have[key])) <= SERVE_TOL, (m.name, key)


def test_single_machine_build_takes_these_scalers():
    """The single-machine path (``builder.build_model``, where the fleet
    build demotes a machine) with the ``chain`` detector, against the JAX
    package's ``build_model`` on the same RandomDataset machine, the port
    drawing its own initial params (``fleet_init``, K11)."""
    from gordo_tpu.builder.build_model import build_model as jax_build_model
    from gordo_tpu_torch.builder.build_model import build_model

    data_config = {"type": "RandomDataset", "tag_list": [f"single-t{j}" for j in range(TAGS)],
                   "train_start_date": "2017-12-25T06:00:00Z", "train_end_date": "2017-12-26T06:00:00Z"}
    ref, ref_meta = jax_build_model("single", DEFINITIONS["chain"], data_config)
    got, meta = build_model("single", DEFINITIONS["chain"], data_config, device="cpu")
    assert [type(s).__name__ for _, s in got.base_estimator.steps[:-1]] == [
        "StandardScaler", "MinMaxScaler", "RobustScaler"]
    X = np.asarray(GordoBaseDataset.from_dict(data_config).get_data()[0], np.float32)
    assert_same_detector(ref, got, X, "build_model")
    assert meta["model"]["cross_validation"]["scores"].keys() == ref_meta["model"]["cross_validation"]["scores"].keys()
