"""The PyTorch port stands alone: no module of ``gordo_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax or the JAX package, and no entry
point runs on the CPU unless asked."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "gordo_tpu")

_WALK_UNDER_BLOCKER = textwrap.dedent(
    """
    import importlib, importlib.abc, json, pkgutil, sys

    BLOCKED = {blocked!r}
    before = set(sys.modules)

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            # the exact top-level name: gordo_tpu_torch shares gordo_tpu's prefix
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import gordo_tpu_torch

    names = []
    for info in pkgutil.walk_packages(gordo_tpu_torch.__path__, "gordo_tpu_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    leaked = sorted(
        n for n in set(sys.modules) - before if n.split(".")[0] in BLOCKED
    )
    print(json.dumps({{"modules": names, "leaked": leaked}}))
    """
).format(blocked=BLOCKED)


def test_every_port_module_imports_with_jax_and_gordo_tpu_blocked():
    # a subprocess: this test process has already imported jax (conftest)
    proc = subprocess.run(
        [sys.executable, "-c", _WALK_UNDER_BLOCKER],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    for expected in (
        "gordo_tpu_torch.serve.server",
        "gordo_tpu_torch.serve.fleet_scorer",
        "gordo_tpu_torch.kernels.fleet_score",
        "gordo_tpu_torch.convert",
        "gordo_tpu_torch.cli",
        "gordo_tpu_torch.train.fit",
        "gordo_tpu_torch.train.cv",
        "gordo_tpu_torch.ops.metrics",
        "gordo_tpu_torch.parallel.fleet",
        "gordo_tpu_torch.parallel.anomaly",
        "gordo_tpu_torch.kernels.fleet_fit",
        "gordo_tpu_torch.kernels.scaler_stats",
        "gordo_tpu_torch.kernels.scaler_quantiles",
        "gordo_tpu_torch.ops.scalers",
        "gordo_tpu_torch.kernels.cv_epilogue",
        "gordo_tpu_torch.kernels.lstm_layer",
        "gordo_tpu_torch.kernels.rolling_median",
        "gordo_tpu_torch.models.factories.lstm",
        "gordo_tpu_torch.ops.windows",
        "gordo_tpu_torch.serve.precision",
        "gordo_tpu_torch.serve.stream",
        "gordo_tpu_torch.kernels.fake_quant",
        "gordo_tpu_torch.kernels.stream_step",
        "gordo_tpu_torch.train.checkpoint",
        "gordo_tpu_torch.kernels.fleet_apply",
        "gordo_tpu_torch.kernels.fleet_init",
        "gordo_tpu_torch.workflow.config",
        "gordo_tpu_torch.dataset.sensor_tag",
        "gordo_tpu_torch.dataset.filter_rows",
        "gordo_tpu_torch.dataset.base",
        "gordo_tpu_torch.dataset.datasets",
        "gordo_tpu_torch.dataset.data_provider.base",
        "gordo_tpu_torch.dataset.data_provider.providers",
        "gordo_tpu_torch.utils.disk_registry",
        "gordo_tpu_torch.builder.build_model",
        "gordo_tpu_torch.builder.fleet_build",
        "gordo_tpu_torch.bench",
        "gordo_tpu_torch.kernels.chain_apply",
        "gordo_tpu_torch.ops.transformer_funcs",
    ):
        assert expected in result["modules"]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "gordo_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build output
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_source_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & set(BLOCKED)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_detector():
    from gordo_tpu_torch import convert

    rng = np.random.default_rng(0)
    params = {
        "dense_0": {"kernel": rng.standard_normal((3, 2)), "bias": np.zeros(2)},
        "out": {"kernel": rng.standard_normal((2, 3)), "bias": np.zeros(3)},
    }
    stats = {"scale": np.ones(3), "offset": np.zeros(3)}
    definition = {
        "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
                "gordo_tpu.ops.scalers.MinMaxScaler",
                {"gordo_tpu.models.estimator.AutoEncoder": {
                    "kind": "feedforward_model", "encoding_dim": [2],
                    "decoding_dim": [],
                }},
            ]}}
        }
    }
    return convert.from_reference(
        definition, params, scaler_stats=[stats], detector_stats=stats,
        feature_thresholds=np.ones(3), aggregate_threshold=1.0,
    )


def _tiny_lstm_detector():
    """A forecast LSTM detector (lookback 2) with a smoothing window."""
    from gordo_tpu_torch import convert

    rng = np.random.default_rng(1)
    widths = [3, 2, 2]  # lstm_symmetric with dims [2]
    cells = [(rng.standard_normal((widths[i], 4 * widths[i + 1])),
              rng.standard_normal((widths[i + 1], 4 * widths[i + 1])),
              np.zeros(4 * widths[i + 1]))
             for i in range(len(widths) - 1)]
    head = (rng.standard_normal((2, 3)), np.zeros(3))
    stats = {"scale": np.ones(3), "offset": np.zeros(3)}
    definition = {
        "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
            "window": 3,
            "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
                "gordo_tpu.ops.scalers.MinMaxScaler",
                {"gordo_tpu.models.estimator.LSTMForecast": {
                    "kind": "lstm_symmetric", "dims": [2], "lookback_window": 2,
                }},
            ]}},
        }
    }
    return convert.from_reference(
        definition, convert.lstm_layers_to_flax(cells, head), scaler_stats=[stats],
        detector_stats=stats, feature_thresholds=np.ones(3), aggregate_threshold=1.0,
    )


def test_entry_points_refuse_the_cpu_unless_asked(no_cuda, tmp_path):
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.device import resolve_device
    from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
    from gordo_tpu_torch.serve.scorer import CompiledScorer
    from gordo_tpu_torch.serve.server import ModelCollection

    model = _tiny_detector()
    lstm = _tiny_lstm_detector()
    serializer.dump(model, str(tmp_path / "m"))
    serializer.dump(lstm, str(tmp_path / "lstm"))
    for build in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: CompiledScorer(model),
        lambda: FleetScorer.from_models({"m": model}),
        lambda: ModelCollection.from_directory(str(tmp_path)),
        lambda: model.anomaly(np.zeros((2, 3), np.float32)),
        lambda: CompiledScorer(lstm),
        lambda: FleetScorer.from_models({"lstm": lstm}),
        lambda: lstm.anomaly(np.zeros((5, 3), np.float32)),
        lambda: lstm.predict(np.zeros((5, 3), np.float32)),
        lambda: lstm.base_estimator._final.predict(np.zeros((5, 3), np.float32)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    # asked for by name, the CPU serves
    scorer = CompiledScorer(model, device="cpu")
    assert scorer.device.type == "cpu"
    assert scorer.predict(np.zeros((2, 3), np.float32)).shape == (2, 3)
    # the forecast model consumes its lookback: 5 rows give 3 outputs
    out = lstm.anomaly(np.zeros((5, 3), np.float32), device="cpu")
    assert out["total-anomaly-score"].shape == (3,)
    assert ModelCollection.from_directory(str(tmp_path), device="cpu").fleet_scorer.buckets


def test_training_entry_points_refuse_the_cpu_unless_asked(no_cuda):
    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.models.estimator import AutoEncoder
    from gordo_tpu_torch.ops.scalers import MinMaxScaler
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.parallel.fleet import draw_fleet

    X = np.random.default_rng(0).standard_normal((40, 3)).astype(np.float32)
    detector = _tiny_detector().clone()
    spec = analyze_definition(detector.clone())
    assert spec is not None
    for train in (
        lambda: MinMaxScaler().fit(X),
        lambda: AutoEncoder(kind="feedforward_hourglass", epochs=1).fit(X),
        lambda: detector.clone().fit(X),
        lambda: detector.clone().cross_validate(X),
        lambda: FleetDiffBuilder(spec),
        lambda: build_project([], "unused"),
        lambda: draw_fleet([0], [3, 2, 3], [8], 1),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train()
    # asked for by name, the CPU trains
    assert AutoEncoder(kind="feedforward_hourglass", epochs=1).fit(X, device="cpu").history_.shape == (1,)


def test_cli_run_server_refuses_the_cpu_unless_asked(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "gordo_tpu_torch.cli", "run-server",
         "--model-dir", str(tmp_path), "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
