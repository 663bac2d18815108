"""``build_project`` of one project YAML by both packages on the CPU, with
no injected draws: the port draws its initial params and permutations
from the JAX package's threefry keys (``fleet_init``, K11).

The project: 4 ``RandomDataset`` machines × 10 tags × 144 rows, the
default detector at 2 epochs, ``TimeSeriesSplit(3)``.  The JAX package
builds it with ``artifact_format="v1", ingest=False`` (and no fleet-health
baseline, which the port does not write yet); the port with
``device="cpu"``.  Bounds, per machine, ``max|ref - port| / max|ref|``
(``torch_parity.r12``), the existing fit bound of 1e-5: thresholds
(measured 8.6e-8), CV scores per fold (measured 4.3e-7 explained
variance, 2.3e-7 r2, 2.5e-7 mse, 1.8e-7 mae), and the anomaly output of a
request of 50 rows (measured 7.0e-7 model output, 2.9e-7 tag scores,
1.7e-7 total score, 2.8e-7 confidence).  The draws differ from JAX's by at most a few ulp in
the initial params (``test_torch_fleet_init.py``); two epochs of Adam
carry that below the fit bound.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

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
from gordo_tpu_torch.workflow import config
from torch_parity import r12

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
MACHINES, TAGS, ROWS, EPOCHS = 4, 10, 144, 2
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")
YAML = project_config(MACHINES, TAGS, ROWS, epochs=EPOCHS)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("build_project")
    env = {"GORDO_FLEET_BASELINE": os.environ.get("GORDO_FLEET_BASELINE")}
    os.environ["GORDO_FLEET_BASELINE"] = "off"
    try:
        jax_cfg = jax_config.NormalizedConfig.from_source(YAML, "parity")
        jax_result = jax_fleet_build.build_project(
            jax_cfg.machines, str(root / "jax"), artifact_format="v1", ingest=False,
        )
    finally:
        if env["GORDO_FLEET_BASELINE"] is None:
            os.environ.pop("GORDO_FLEET_BASELINE")
        else:
            os.environ["GORDO_FLEET_BASELINE"] = env["GORDO_FLEET_BASELINE"]
    cfg = config.NormalizedConfig.from_source(YAML, "parity")
    port_result = fleet_build.build_project(
        cfg.machines, str(root / "port"), model_register_dir=str(root / "registry"), device="cpu",
    )
    assert not jax_result.failed and not port_result.failed
    return root, cfg, jax_result, port_result


def _keys(meta, depth=2):
    if not isinstance(meta, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in meta.items()}


def test_thresholds_scores_and_anomaly_match_jax(built):
    root, cfg, jax_result, port_result = built
    assert sorted(port_result.fleet_built) == sorted(jax_result.fleet_built) == [m.name for m in cfg.machines]
    for m in cfg.machines:
        ref = jax_serializer.load(jax_result.artifacts[m.name])
        got = serializer.load(port_result.artifacts[m.name])
        assert r12(np.append(ref.feature_thresholds_, ref.aggregate_threshold_),
                   np.append(got.feature_thresholds_, got.aggregate_threshold_)) <= TOL, m.name
        for name, score in ref.cv_metadata_["scores"].items():
            assert r12(score["folds"], got.cv_metadata_["scores"][name]["folds"]) <= TOL, (m.name, name)
        X = np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)[:50]
        want = JaxScorer(ref).anomaly_arrays(X)
        have = got.anomaly(X, device="cpu")
        for key in OUTPUTS:
            assert r12(np.asarray(want[key]), np.asarray(have[key])) <= TOL, (m.name, key)
        jax_meta = jax_serializer.load_metadata(jax_result.artifacts[m.name])
        port_meta = serializer.load_metadata(port_result.artifacts[m.name])
        assert _keys(port_meta) == _keys(jax_meta)
        assert port_meta["model"]["fleet_built"] is True
        assert port_meta["dataset"]["summary_statistics"] == jax_meta["dataset"]["summary_statistics"]


def test_second_run_hits_the_cache_and_a_changed_config_rebuilds(built):
    root, cfg, _, first = built
    out, reg = str(root / "port"), str(root / "registry")
    again = fleet_build.build_project(cfg.machines, out, model_register_dir=reg, device="cpu")
    assert sorted(again.cached) == sorted(first.fleet_built)
    assert not again.fleet_built and not again.single_built
    assert again.summary()["stage_seconds"]["dispatch"] == 0.0
    changed = [config.Machine.from_config(m.to_dict()) for m in cfg.machines]
    changed[0].metadata = {"owner": "someone-else"}
    third = fleet_build.build_project(changed, out, model_register_dir=reg, device="cpu")
    assert third.fleet_built == [changed[0].name]
    assert sorted(third.cached) == sorted(m.name for m in changed[1:])


def test_non_fleetable_model_falls_back_to_a_single_build(tmp_path):
    raw = config.load_machine_config(project_config(2, 3, ROWS, epochs=1))
    raw["machines"][1]["model"] = {"gordo_tpu.models.estimator.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1}}
    cfg = config.NormalizedConfig(raw, "fallback")
    result = fleet_build.build_project(cfg.machines, str(tmp_path / "out"), device="cpu",
                                       pipeline=False)
    assert result.fleet_built == [cfg.machines[0].name]
    assert result.single_built == [cfg.machines[1].name]
    model = serializer.load(result.artifacts[cfg.machines[1].name])
    assert model.predict(np.zeros((4, 3), np.float32), device="cpu").shape == (4, 3)


def _ragged_pair(prefix):
    """The ragged machines of ``tests/test_fleet_build.py::TestAutoPad``
    (122, 128 and 134 rows), as configs for both packages."""
    def cfg(i, hours):
        day = 25 + (6 + hours) // 24
        hh = (6 + hours) % 24
        return {"name": f"{prefix}-{i}", "dataset": {
            "type": "RandomDataset", "tag_list": ["a", "b", "c"],
            "train_start_date": "2017-12-25T06:00:00Z",
            "train_end_date": f"2017-12-{day}T{hh:02d}:10:00Z",
        }}
    raw = [cfg(i, h) for i, h in enumerate((20, 21, 22))]
    return ([config.Machine.from_config(c) for c in raw],
            [jax_config.Machine.from_config(c) for c in raw])


@pytest.mark.parametrize("budget", [1.0, None], ids=["over_budget", "default_budget"])
def test_auto_pad_decides_as_jax(tmp_path, budget):
    port_ms, jax_ms = _ragged_pair(f"ap{int(budget or 0)}")
    assert fleet_build.estimate_ragged_compile_seconds(port_ms) == \
        jax_fleet_build.estimate_ragged_compile_seconds(jax_ms)
    result = fleet_build.build_project(port_ms, str(tmp_path / "out"), device="cpu",
                                       auto_pad_budget_seconds=budget)
    assert not result.failed
    jax_bill = jax_fleet_build.estimate_ragged_compile_seconds(jax_ms)
    jax_budget = jax_fleet_build.DEFAULT_AUTO_PAD_BUDGET_SECONDS if budget is None else budget
    want = jax_fleet_build.DEFAULT_AUTO_PAD_LENGTHS if jax_bill > jax_budget else None
    assert result.auto_pad == want
    if want:  # the padded groups' detectors say so
        meta = serializer.load_metadata(result.artifacts[port_ms[0].name])
        assert meta["model"]["pad_lengths"] == want
    off = fleet_build.build_project(port_ms, str(tmp_path / "off"), device="cpu", auto_pad=False,
                                    auto_pad_budget_seconds=1.0)
    assert off.auto_pad is None


def test_estimate_counts_filtered_machines_as_jax():
    def raw(i, row_filter=None):
        ds = {"type": "RandomDataset", "tag_list": ["a", "b", "c"],
              "train_start_date": "2017-12-25T06:00:00Z", "train_end_date": "2017-12-26T06:00:00Z"}
        if row_filter:
            ds["row_filter"] = row_filter
        return {"name": f"est-{i}", "dataset": ds}

    configs = [raw(i) for i in range(5)] + [raw(10 + i, f"`a` > {i}") for i in range(4)]
    for n in (5, 9):
        port = fleet_build.estimate_ragged_compile_seconds([config.Machine.from_config(c) for c in configs[:n]])
        ref = jax_fleet_build.estimate_ragged_compile_seconds(
            [jax_config.Machine.from_config(c) for c in configs[:n]])
        assert port == ref


@pytest.mark.parametrize("kwargs,match", [
    ({"artifact_format": "v2"}, "4c"),
    ({"ingest": True}, "4b"),
    ({"warm_start": True}, "4c"),
    ({"shard": object()}, "item 11"),
    ({"mesh": object()}, "item 11"),
], ids=["v2", "ingest", "warm_start", "shard", "mesh"])
def test_unported_options_raise(tmp_path, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        fleet_build.build_project([], str(tmp_path), device="cpu", **kwargs)


def test_environment_resolves_to_v1_and_refuses_v2(tmp_path, monkeypatch):
    monkeypatch.delenv("GORDO_ARTIFACT_FORMAT", raising=False)
    monkeypatch.delenv("GORDO_INGEST", raising=False)
    assert fleet_build.build_project([], str(tmp_path), device="cpu").artifact_format == "v1"
    monkeypatch.setenv("GORDO_ARTIFACT_FORMAT", "v2")
    with pytest.raises(NotImplementedError, match="4c"):
        fleet_build.build_project([], str(tmp_path), device="cpu")
    monkeypatch.setenv("GORDO_ARTIFACT_FORMAT", "v1")
    monkeypatch.setenv("GORDO_INGEST", "on")
    with pytest.raises(NotImplementedError, match="4b"):
        fleet_build.build_project([], str(tmp_path), device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(*args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "gordo_tpu_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, **(env or {})))


def test_cli_build_project_writes_what_run_server_serves(tmp_path):
    yaml_path = tmp_path / "project.yaml"
    yaml_path.write_text(project_config(2, 3, ROWS, epochs=1))
    out = tmp_path / "models"
    proc = _cli("build-project", "--machine-config", str(yaml_path), "--output-dir", str(out),
                "--project-name", "cli", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["fleet_built"] == 2 and summary["artifact_format"] == "v1"
    names = sorted(os.listdir(out))
    assert names == ["machine-00000", "machine-00001"]

    port = _free_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "gordo_tpu_torch.cli", "run-server", "--model-dir", str(out),
         "--project", "cli", "--port", str(port), "--host", "127.0.0.1", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        base = f"http://127.0.0.1:{port}/gordo/v0/cli/{names[0]}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(f"{base}/healthcheck", timeout=5):
                    break
            except OSError:
                assert time.time() < deadline and server.poll() is None, "run-server did not start"
                time.sleep(0.5)
        X = np.random.default_rng(0).standard_normal((20, 3)).tolist()
        req = urllib.request.Request(f"{base}/anomaly/prediction", data=json.dumps({"X": X}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())["data"]
        ref = serializer.load(str(out / names[0])).anomaly(np.asarray(X, np.float32), device="cpu")
        for key in OUTPUTS:
            np.testing.assert_allclose(np.asarray(body[key]), ref[key], rtol=1e-6, atol=1e-6)
    finally:
        server.terminate()
        server.wait(timeout=30)


def test_cli_build_one_machine(tmp_path):
    data = json.dumps({"type": "RandomDataset", "tag_list": ["a", "b", "c"],
                       "train_start_date": "2017-12-25T06:00:00Z",
                       "train_end_date": "2017-12-26T05:50:00Z"})
    model = json.dumps({"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
        "gordo_tpu.pipeline.Pipeline": {"steps": ["gordo_tpu.ops.scalers.MinMaxScaler", {
            "gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": 1}}]}}}})
    proc = _cli("build", "--device", "cpu", "--print-cv-scores",
                env={"OUTPUT_DIR": str(tmp_path), "DATA_CONFIG": data, "MODEL_CONFIG": model,
                     "MACHINE_NAME": "one"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str(tmp_path / "one")
    assert any(line.startswith("explained_variance_score") for line in proc.stdout.splitlines())
    meta = serializer.load_metadata(str(tmp_path / "one"))
    assert meta["model"]["cross_validation"]["scores"] and meta["cache_key"]
