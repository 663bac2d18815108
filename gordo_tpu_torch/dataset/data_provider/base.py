"""Data-provider contract.

Copy of ``gordo_tpu/dataset/data_provider/base.py``.

Reference equivalent: ``gordo_components/dataset/data_provider/base.py`` —
``GordoBaseDataProvider`` with the ``load_series`` generator contract,
``can_handle_tag``, and ``capture_args`` so providers round-trip through
metadata JSON (``to_dict``/``from_dict``).
"""

from __future__ import annotations

import abc
from typing import Iterable, List

import pandas as pd

from gordo_tpu_torch.utils.args import ParamsMixin


class GordoBaseDataProvider(ParamsMixin, abc.ABC):
    @abc.abstractmethod
    def load_series(
        self,
        from_ts: pd.Timestamp,
        to_ts: pd.Timestamp,
        tag_list: List,
        dry_run: bool = False,
    ) -> Iterable[pd.Series]:
        """Yield one timezone-aware, time-indexed series per requested tag,
        named after the tag."""

    @abc.abstractmethod
    def can_handle_tag(self, tag) -> bool:
        ...

    def load_arrays(
        self,
        from_ts: pd.Timestamp,
        to_ts: pd.Timestamp,
        tag_list: List,
    ):
        """Optional array-grain fetch for the fleet ingest plane: return
        ``(index, values)`` — ONE shared ``pd.DatetimeIndex`` and a
        float64 ``(len(index), len(tag_list))`` matrix whose columns
        follow ``tag_list`` order and hold bit-identical values to what
        :meth:`load_series` would yield — or None when the provider can
        only speak per-tag Series (the plane then materializes the
        series itself).  Providers whose tags share a sampling grid
        should implement it: per-tag ``pd.Series`` construction was ~40%
        of the fleet build's measured load-stage cost."""
        return None

    def to_dict(self) -> dict:
        """Self-describing config (reference: ``capture_args`` round-trip)."""
        cls = type(self)
        return {
            "type": f"{cls.__module__}.{cls.__qualname__}",
            **{
                k: v
                for k, v in self.get_params().items()
                if isinstance(v, (str, int, float, bool, list, dict, type(None)))
            },
        }

    @classmethod
    def from_dict(cls, config: dict) -> "GordoBaseDataProvider":
        from gordo_tpu_torch.serializer.definition import import_locate

        config = dict(config)
        type_path = config.pop("type", None)
        if type_path is None:
            from gordo_tpu_torch.dataset.data_provider.providers import RandomDataProvider

            return RandomDataProvider(**config)
        target = import_locate(
            type_path
            if "." in type_path
            else f"gordo_tpu_torch.dataset.data_provider.providers.{type_path}"
        )
        return target(**config)
