"""The port's data layer and project config against the JAX package's on
the CPU: ``TimeSeriesDataset`` over ``RandomDataProvider`` and
``FileSystemTagProvider`` gives the same ``X`` and ``y``, byte for byte,
and the same metadata (but for the provider's own class path); the
normalized project config is the JAX package's, the default model named
by the port's paths."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.dataset.base import GordoBaseDataset as JaxDataset
from gordo_tpu.workflow import config as jax_config
from gordo_tpu_torch.dataset import (
    DataLakeProvider,
    InfluxDataProvider,
    InsufficientDataError,
    IrocBundleProvider,
    RandomDataProvider,
    normalize_sensor_tags,
)
from gordo_tpu_torch.dataset.base import GordoBaseDataset
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.workflow import config
from test_workflow_config import PROJECT_YAML


def _same_frames(a: pd.DataFrame, b: pd.DataFrame) -> None:
    assert list(a.columns) == list(b.columns)
    assert a.index.equals(b.index)
    assert a.to_numpy().dtype == b.to_numpy().dtype
    assert a.to_numpy().tobytes() == b.to_numpy().tobytes()


def _without_provider_type(meta: dict) -> dict:
    meta = json.loads(json.dumps(meta, default=str))
    meta["data_provider"].pop("type")
    return meta


def _both(data_config: dict):
    jax_ds = JaxDataset.from_dict(dict(data_config))
    port_ds = GordoBaseDataset.from_dict(dict(data_config))
    (jX, jy), (pX, py) = jax_ds.get_data(), port_ds.get_data()
    _same_frames(jX, pX)
    _same_frames(jy, py)
    assert _without_provider_type(port_ds.get_metadata()) == _without_provider_type(jax_ds.get_metadata())
    return pX


@pytest.mark.parametrize("extra", [
    {},
    {"row_filter": "`tag-1` > -1.0", "row_filter_buffer_size": 2},
    {"target_tag_list": ["tag-2"], "resolution": "30min"},
], ids=["plain", "row_filter", "targets"])
def test_random_dataset_matches_jax_bytewise(extra):
    X = _both({
        "type": "RandomDataset",
        "tag_list": ["tag-1", "tag-2", "tag-3"],
        "train_start_date": "2017-12-25 06:00:00Z",
        "train_end_date": "2017-12-29 05:50:00Z",
        **extra,
    })
    if not extra:
        assert X.shape == (576, 3)


def test_file_system_provider_matches_jax_bytewise(tmp_path):
    rng = np.random.default_rng(0)
    asset = tmp_path / "asset-a"
    asset.mkdir()
    times = pd.date_range("2020-01-01", periods=500, freq="7min", tz="UTC")
    for tag in ("t-1", "t-2"):
        frame = pd.DataFrame({"time": times.strftime("%Y-%m-%dT%H:%M:%S%z"),
                              "value": rng.standard_normal(len(times))})
        frame.to_csv(asset / f"{tag}.csv", index=False)
    _both({
        "type": "TimeSeriesDataset",
        "tag_list": ["t-1", "t-2"],
        "train_start_date": "2020-01-01T00:00:00Z",
        "train_end_date": "2020-01-03T00:00:00Z",
        "data_provider": {"type": "FileSystemTagProvider", "base_dir": str(tmp_path),
                          "asset": "asset-a"},
    })


def test_jax_and_reference_type_paths_resolve_to_the_port():
    for path in ("gordo_tpu.dataset.datasets.RandomDataset",
                 "gordo_components.dataset.datasets.RandomDataset"):
        ds = GordoBaseDataset.from_dict({"type": path, "tag_list": ["a"]})
        assert type(ds).__module__ == "gordo_tpu_torch.dataset.datasets"
    provider = RandomDataProvider(seed=3)
    again = type(provider).from_dict(provider.to_dict())
    assert again.get_params() == provider.get_params()


def test_outside_service_providers_wait_for_item_4():
    for cls in (IrocBundleProvider, InfluxDataProvider, DataLakeProvider):
        with pytest.raises(NotImplementedError, match="item 4"):
            cls(base_dir="x")


def test_insufficient_data_raises():
    ds = GordoBaseDataset.from_dict({
        "type": "RandomDataset", "tag_list": ["a"], "n_samples_threshold": 10_000,
        "train_start_date": "2017-12-25 06:00:00Z", "train_end_date": "2017-12-26 06:00:00Z",
    })
    with pytest.raises(InsufficientDataError):
        ds.get_data()


def test_sensor_tags_normalize_as_jax():
    from gordo_tpu.dataset.sensor_tag import normalize_sensor_tags as jax_normalize

    tags = ["a", ["b", "asset-1"], {"name": "c"}, ("d",)]
    assert [tuple(t) for t in normalize_sensor_tags(tags, asset="x")] == \
        [tuple(t) for t in jax_normalize(tags, asset="x")]


def _machines(cfg):
    return [m.to_dict() for m in cfg.machines]


def test_normalized_config_matches_jax():
    port = config.NormalizedConfig.from_source(PROJECT_YAML, "proj")
    ref = jax_config.NormalizedConfig.from_source(PROJECT_YAML, "proj")
    assert port.config_globals == ref.config_globals
    port_machines, ref_machines = _machines(port), _machines(ref)
    # the default model names the port's classes; the same model otherwise
    assert port_machines[0]["model"] == config.DEFAULT_MODEL
    assert ref_machines[0]["model"] == jax_config.DEFAULT_MODEL
    assert json.dumps(jax_config.DEFAULT_MODEL).replace('"gordo_tpu.', '"gordo_tpu_torch.') == \
        json.dumps(config.DEFAULT_MODEL)
    for m in (port_machines[0], ref_machines[0]):
        m.pop("model")
    assert port_machines == ref_machines
    # the JAX package's paths build the port's classes
    model = from_definition(ref.machines[1].model)
    assert type(model).__module__ == "gordo_tpu_torch.models.estimator"


def test_config_cache_round_trips(tmp_path):
    cold = config.NormalizedConfig.from_source(PROJECT_YAML, "proj", cache_dir=str(tmp_path))
    assert len(os.listdir(tmp_path)) == 1
    warm = config.NormalizedConfig.from_source(PROJECT_YAML, "proj", cache_dir=str(tmp_path))
    assert _machines(warm) == _machines(cold)
    with pytest.raises(ValueError, match="Duplicate"):
        config.NormalizedConfig({"machines": [{"name": "a", "dataset": {"tags": ["t"]}}] * 2})
    with pytest.raises(ValueError, match="name"):
        config.Machine(name="Bad_Name", dataset={"tags": ["t"]})
