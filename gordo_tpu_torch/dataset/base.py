"""Dataset contract + config dispatch.

Copy of ``gordo_tpu/dataset/base.py``; a short ``type`` resolves in
``gordo_tpu_torch.dataset.datasets``, a dotted one through the port's
``registry``.

Reference equivalent: ``gordo_components/dataset/base.py`` —
``GordoBaseDataset.get_data() -> (X, y)``, ``get_metadata()``, and
``from_dict`` config dispatch.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

from gordo_tpu_torch.utils.args import ParamsMixin


class GordoBaseDataset(ParamsMixin, abc.ABC):
    @abc.abstractmethod
    def get_data(self) -> Tuple[Any, Any]:
        """Return (X, y) — pandas DataFrames with a shared time index."""

    @abc.abstractmethod
    def get_metadata(self) -> Dict[str, Any]:
        ...

    @classmethod
    def from_dict(cls, config: dict) -> "GordoBaseDataset":
        """Instantiate a dataset from a data-config dict.

        ``type`` selects the dataset class (short name within
        ``gordo_tpu_torch.dataset.datasets`` or a dotted path); everything else is
        constructor kwargs — the reference's dispatch convention.
        """
        from gordo_tpu_torch.serializer.definition import import_locate

        config = dict(config)
        type_path = config.pop("type", "TimeSeriesDataset")
        if "." not in type_path:
            type_path = f"gordo_tpu_torch.dataset.datasets.{type_path}"
        target = import_locate(type_path)
        return target(**config)
