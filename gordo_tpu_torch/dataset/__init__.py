"""Datasets and data providers (counterpart of ``gordo_tpu/dataset``)."""

from gordo_tpu_torch.dataset.base import GordoBaseDataset  # noqa: F401
from gordo_tpu_torch.dataset.data_provider.base import GordoBaseDataProvider  # noqa: F401
from gordo_tpu_torch.dataset.data_provider.providers import (  # noqa: F401
    DataLakeProvider,
    FileSystemTagProvider,
    InfluxDataProvider,
    IrocBundleProvider,
    RandomDataProvider,
)
from gordo_tpu_torch.dataset.datasets import (  # noqa: F401
    InsufficientDataError,
    RandomDataset,
    TimeSeriesDataset,
    dataset_from_metadata,
)
from gordo_tpu_torch.dataset.sensor_tag import SensorTag, normalize_sensor_tags  # noqa: F401
