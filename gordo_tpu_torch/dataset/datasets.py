"""Dataset assembly (copy of ``gordo_tpu/dataset/datasets.py``).

Reference equivalent: ``gordo_components/dataset/datasets.py`` —
``TimeSeriesDataset`` (the workhorse: per-tag series → resampled, joined,
row-filtered tag matrix) and ``RandomDataset``.

Host-side by design: this is the I/O + pandas layer (SURVEY.md §4 marks it
I/O-bound, not compute-bound).  It produces contiguous float32 matrices that
the builder moves to device once; nothing here runs on the card.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from gordo_tpu_torch.dataset.base import GordoBaseDataset
from gordo_tpu_torch.dataset.data_provider.base import GordoBaseDataProvider
from gordo_tpu_torch.dataset.data_provider.providers import RandomDataProvider
from gordo_tpu_torch.dataset.filter_rows import pandas_filter_rows
from gordo_tpu_torch.dataset.sensor_tag import SensorTag, normalize_sensor_tags
from gordo_tpu_torch.utils.args import capture_args


def _summary_statistics(data: pd.DataFrame) -> Dict[str, Dict[str, float]]:
    """Per-tag mean/std/min/max for dataset metadata.

    One vectorized numpy pass instead of four pandas reductions per
    column: the pandas nanops machinery costs ~2ms per call, which at
    4 stats x tags x thousands of machines made METADATA the largest
    single host cost of a warm project build (measured ~75ms/machine,
    ~80% of warm build wall time).  ddof=1 matches ``Series.std``."""
    return summary_statistics_arrays(
        data.to_numpy(dtype=np.float64, copy=False), list(data.columns)
    )


def summary_statistics_arrays(
    values: np.ndarray, cols: List[Any]
) -> Dict[str, Dict[str, float]]:
    """:func:`_summary_statistics` on a ``(rows, len(cols))`` float64
    matrix — the shared kernel the fleet ingest plane calls column-slice
    by column-slice without materializing per-machine DataFrames."""
    if not cols:
        return {}
    if values.shape[0] == 0:
        nan = float("nan")
        return {
            str(c): {"mean": nan, "std": nan, "min": nan, "max": nan}
            for c in cols
        }
    with np.errstate(all="ignore"):
        import warnings

        with warnings.catch_warnings():
            # all-NaN columns: emit NaN stats like pandas, not warnings
            warnings.simplefilter("ignore", category=RuntimeWarning)
            means = np.nanmean(values, axis=0)
            stds = np.nanstd(values, axis=0, ddof=1)
            mins = np.nanmin(values, axis=0)
            maxs = np.nanmax(values, axis=0)
    return {
        str(c): {
            "mean": float(means[i]),
            "std": float(stds[i]),
            "min": float(mins[i]),
            "max": float(maxs[i]),
        }
        for i, c in enumerate(cols)
    }


def _bin_label_index(
    origin: int, first_bin: int, last_bin: int, nanos: int, name
) -> pd.DatetimeIndex:
    """Resample-output label index, cached: machines in a fleet share the
    train period and resolution, so the (identical) tz-aware label grid was
    being rebuilt per tag per machine — about half of the vectorized
    resample's remaining cost."""
    key = (origin, first_bin, last_bin, nanos, name)
    cached = _bin_label_index._cache.get(key)
    if cached is None:
        label_ns = origin + np.arange(first_bin, last_bin + 1) * nanos
        cached = pd.DatetimeIndex(
            label_ns.view("datetime64[ns]"), name=name
        ).tz_localize("UTC")
        # loader-pool threads share this cache; the lock only guards the
        # bounded-size eviction (reads stay lock-free)
        with _bin_label_index._lock:
            if len(_bin_label_index._cache) >= 32:
                _bin_label_index._cache.pop(
                    next(iter(_bin_label_index._cache)), None
                )
            _bin_label_index._cache[key] = cached
    return cached


_bin_label_index._cache = {}
_bin_label_index._lock = threading.Lock()


#: nanoseconds per day — resample origin is midnight UTC of the first sample
_DAY_NS = 86_400_000_000_000


def resample_prep(
    index: pd.DatetimeIndex, nanos: int
) -> Tuple[np.ndarray, int, np.ndarray, pd.DatetimeIndex]:
    """Binning geometry for a mean-resample of ``index`` at a fixed
    ``nanos``-wide resolution: ``(starts, grid_size, scatter,
    label_index)`` — bin-boundary positions for ``np.add.reduceat``, the
    complete output grid size, the scatter positions of the occupied
    bins, and the (cached) label index.

    The ONE definition of the resample geometry: the per-machine fast
    path (:meth:`TimeSeriesDataset._resample_one_arrays`) and the fleet
    ingest plane's cross-machine columnar pass
    (``gordo_tpu/ingest/plane.py``) both call it, so they cannot drift.
    Assumes a non-empty, monotonic, UTC index."""
    # pandas 2.x indexes may be us/ms-resolution; do the math in ns
    idx = index.asi8 if index.unit == "ns" else index.as_unit("ns").asi8
    # midnight UTC of the first sample as pure integer math
    # (Timestamp.normalize() was a measurable per-tag cost)
    origin = (idx[0] // _DAY_NS) * _DAY_NS
    bins = (idx - origin) // nanos
    starts = np.concatenate([[0], np.flatnonzero(np.diff(bins)) + 1])
    grid_size = int(bins[-1] - bins[0]) + 1
    scatter = (bins[starts] - bins[0]).astype(np.int64)
    label_index = _bin_label_index(
        origin, int(bins[0]), int(bins[-1]), nanos, index.name
    )
    return starts, grid_size, scatter, label_index


def _to_timestamp(value) -> pd.Timestamp:
    ts = pd.Timestamp(value)
    if ts.tzinfo is None:
        ts = ts.tz_localize("UTC")
    return ts


class InsufficientDataError(ValueError):
    pass


class TimeSeriesDataset(GordoBaseDataset):
    """Pull tags from a provider over a train period, resample + join +
    filter into an aligned tag matrix.

    Parameters mirror the reference's config surface:
    ``train_start_date``/``train_end_date``, ``tag_list``,
    ``target_tag_list`` (defaults to ``tag_list`` — autoencoder X == y),
    ``resolution`` (pandas offset, default "10min"), ``row_filter`` (safe
    boolean expression), ``aggregation_methods``, ``row_filter_buffer_size``,
    ``n_samples_threshold``.
    """

    @capture_args
    def __init__(
        self,
        train_start_date: Union[str, pd.Timestamp] = None,
        train_end_date: Union[str, pd.Timestamp] = None,
        tag_list: Optional[List] = None,
        target_tag_list: Optional[List] = None,
        data_provider: Union[GordoBaseDataProvider, dict, None] = None,
        resolution: str = "10min",
        row_filter: Union[str, list, None] = None,
        aggregation_methods: Union[str, List[str]] = "mean",
        row_filter_buffer_size: int = 0,
        n_samples_threshold: int = 0,
        asset: Optional[str] = None,
        tags: Optional[List] = None,
        **_ignored,
    ):
        # project-YAML spelling (reference config uses ``tags:``)
        if tag_list is None and tags is not None:
            tag_list = tags
        if train_start_date is None or train_end_date is None:
            raise ValueError("train_start_date and train_end_date are required")
        self.train_start_date = _to_timestamp(train_start_date)
        self.train_end_date = _to_timestamp(train_end_date)
        if self.train_start_date >= self.train_end_date:
            raise ValueError(
                f"train_start_date {self.train_start_date} must precede "
                f"train_end_date {self.train_end_date}"
            )
        self.asset = asset
        self.tag_list = normalize_sensor_tags(list(tag_list or []), asset=asset)
        self.target_tag_list = (
            normalize_sensor_tags(list(target_tag_list), asset=asset)
            if target_tag_list
            else list(self.tag_list)
        )
        if isinstance(data_provider, dict):
            data_provider = GordoBaseDataProvider.from_dict(data_provider)
        self.data_provider = data_provider or RandomDataProvider()
        self.resolution = resolution
        self.row_filter = row_filter
        self.aggregation_methods = aggregation_methods
        self.row_filter_buffer_size = row_filter_buffer_size
        self.n_samples_threshold = n_samples_threshold
        self._metadata: Dict[str, Any] = {}

    # -- assembly ------------------------------------------------------------

    def _resample_one_arrays(self, series: pd.Series, _memo=None):
        """Vectorized resample of one tag to ``(values, label_index)``, or
        None when only the pandas path applies.

        Mean aggregation of a UTC series over a fixed-width resolution is
        O(n) ``np.add.reduceat`` over bin boundaries — at fleet scale the
        per-tag pandas ``resample().mean()`` dominated project-build wall
        time by ~10x.  Output is bin-for-bin identical to pandas (origin =
        midnight of the first sample's day, left-closed/left-labeled,
        empty bins NaN).  Returning raw arrays (not a Series) lets the
        join build its matrix without ever materializing per-tag pandas
        objects — the Series constructor itself was ~25% of assembly.
        """
        if (
            self.aggregation_methods != "mean"
            or len(series) == 0
            or str(series.index.tz) != "UTC"
        ):
            return None
        try:
            nanos = pd.tseries.frequencies.to_offset(self.resolution).nanos
        except ValueError:  # non-fixed frequency (e.g. months) — pandas path
            return None

        if not series.index.is_monotonic_increasing:
            series = series.sort_index()
        # The binning geometry (ns timestamps, bin boundaries, scatter
        # positions, label index) depends only on the index object — and a
        # provider yields every tag of one machine on ONE shared index, so
        # it is computed once per machine, not once per tag.
        index = series.index
        prep = _memo.get(id(index)) if _memo is not None else None
        if prep is None:
            starts, grid_size, scatter, label_index = resample_prep(
                index, nanos
            )
            # the entry holds the index object itself: the memo is keyed by
            # id(), and letting the index be GC'd could recycle its id for
            # a DIFFERENT index within the same join
            prep = (index, starts, grid_size, scatter, label_index)
            if _memo is not None:
                _memo[id(index)] = prep
        _, starts, grid_size, scatter, label_index = prep
        values = series.to_numpy(dtype=np.float64, copy=False)
        # NaN samples must not poison bucket means (pandas mean skips them)
        nan_mask = np.isnan(values)
        sums = np.add.reduceat(np.where(nan_mask, 0.0, values), starts)
        valid = np.add.reduceat((~nan_mask).astype(np.int64), starts)
        # where= keeps the empty-bin lanes NaN without an errstate guard
        means = np.divide(
            sums, valid, out=np.full(sums.shape, np.nan), where=valid > 0
        )
        # scatter onto the COMPLETE bin grid (empty bins NaN) so length,
        # labels, and metadata match the pandas path exactly
        grid = np.full(grid_size, np.nan)
        grid[scatter] = means
        return grid, label_index

    def _resample_one(self, series: pd.Series) -> pd.Series:
        """Resample a single tag's series to ``self.resolution`` (the
        vectorized path when applicable, else pandas)."""
        fast = self._resample_one_arrays(series)
        if fast is None:
            return series.resample(self.resolution).agg(
                self.aggregation_methods
            )
        grid, label_index = fast
        return pd.Series(grid, index=label_index, name=series.name)

    def _join_timeseries(self, series_iter) -> pd.DataFrame:
        entries = []            # ("fast", name, values, label_index) |
        all_fast = True         # ("slow", aggregated pandas object)
        metadata = {}
        idx_memo: Dict[int, Any] = {}
        for series in series_iter:
            raw_len = len(series)
            fast = (
                self._resample_one_arrays(series, idx_memo)
                if raw_len else None
            )
            if fast is not None:
                grid, label_index = fast
                entries.append(("fast", series.name, grid, label_index))
                n_out = len(grid)
            else:
                all_fast = False
                agg = (
                    series.resample(self.resolution).agg(
                        self.aggregation_methods
                    )
                    if raw_len
                    else series
                )
                if isinstance(agg, pd.DataFrame):  # multi-agg methods
                    agg.columns = [f"{series.name}_{m}" for m in agg.columns]
                else:
                    agg.name = series.name
                entries.append(("slow", agg))
                n_out = len(agg)
            metadata[str(series.name)] = {
                "original_length": int(raw_len),
                "resampled_length": int(n_out),
            }
        self._metadata["tag_loading_metadata"] = metadata

        if all_fast and entries and all(
            e[3] is entries[0][3] or e[3].equals(entries[0][3])
            for e in entries[1:]
        ):
            # all-fast, identical label grids (guaranteed when tags share a
            # provider period and the label-index cache hits): build the
            # matrix directly and drop NaN rows with one vectorized mask —
            # no per-tag Series, no concat alignment, no block dropna
            mat = np.column_stack([e[2] for e in entries])
            keep = ~np.isnan(mat).any(axis=1)
            return pd.DataFrame(
                mat[keep],
                index=entries[0][3][keep],
                columns=[e[1] for e in entries],
            )
        # mixed/slow path: materialize fast columns as Series (original
        # iteration order preserved) and join through pandas
        frames = [
            e[1] if e[0] == "slow"
            else pd.Series(e[2], index=e[3], name=e[1])
            for e in entries
        ]
        if (
            len(frames) > 1
            and all(
                isinstance(f, pd.Series) and f.dtype == np.float64
                for f in frames
            )
            and all(f.index.equals(frames[0].index) for f in frames[1:])
        ):
            joined = pd.DataFrame(
                np.column_stack([f.to_numpy() for f in frames]),
                index=frames[0].index,
                columns=[f.name for f in frames],
            ).dropna()
        else:
            joined = pd.concat(frames, axis=1, join="inner").dropna()
        return joined

    def get_data(self) -> Tuple[pd.DataFrame, pd.DataFrame]:
        all_tags: List[SensorTag] = list(
            dict.fromkeys(self.tag_list + self.target_tag_list)
        )
        series_iter = self.data_provider.load_series(
            self.train_start_date, self.train_end_date, all_tags
        )
        data = self._join_timeseries(series_iter)
        rows_after_join = len(data)

        if self.row_filter:
            data = pandas_filter_rows(
                data, self.row_filter, buffer_size=self.row_filter_buffer_size
            )
        rows_after_filter = len(data)

        if rows_after_filter < max(self.n_samples_threshold, 1):
            raise InsufficientDataError(
                f"Only {rows_after_filter} rows after filtering "
                f"(threshold {self.n_samples_threshold}) for period "
                f"{self.train_start_date} → {self.train_end_date}"
            )

        # Column order follows the config's tag order.  With multiple
        # aggregation methods the columns are "<tag>_<method>" and X spans
        # them all (the reference behaves the same way).
        x_cols = [t.name for t in self.tag_list]
        y_cols = [t.name for t in self.target_tag_list]
        cols = list(data.columns)
        # already in config order (the normal case): skip the listlike
        # reindex, which costs more than the rest of column selection
        # combined on the fleet-build hot path
        if cols == x_cols:
            X = data
        elif all(c in data.columns for c in x_cols):
            X = data[x_cols]
        else:
            X = data
        if y_cols == x_cols:
            # autoencoder default (targets == inputs): reuse X — every
            # consumer treats X and y as read-only (the builders copy)
            y = X
        elif all(c in data.columns for c in y_cols):
            y = data[y_cols]
        else:
            y = X.copy()

        self._metadata.update(
            {
                "train_start_date": str(self.train_start_date),
                "train_end_date": str(self.train_end_date),
                "resolution": self.resolution,
                "row_filter": self.row_filter,
                "rows_after_join": int(rows_after_join),
                "rows_after_filter": int(rows_after_filter),
                "filtered_periods": int(rows_after_join - rows_after_filter),
                "tag_list": [t.to_json() for t in self.tag_list],
                "target_tag_list": [t.to_json() for t in self.target_tag_list],
                "data_provider": self.data_provider.to_dict(),
                "summary_statistics": _summary_statistics(data),
            }
        )
        return X, y

    def get_metadata(self) -> Dict[str, Any]:
        return dict(self._metadata)


def dataset_from_metadata(
    dataset_meta: Dict[str, Any],
    start: Any,
    end: Any,
    data_provider: Optional[GordoBaseDataProvider] = None,
) -> TimeSeriesDataset:
    """A scoring-period :class:`TimeSeriesDataset` reconstructed from a
    build's dataset metadata (``metadata["dataset"]`` as the builder
    records it: ``tag_list``, ``resolution``, ``data_provider``).

    The shared refetch recipe: the HTTP client re-pulls raw data for a
    prediction period with it, and the backfill runner drives historical
    windows through the exact same assembly — one definition of "the
    data a machine scores over", not two."""
    tag_list = [
        t["name"] if isinstance(t, dict) else str(t)
        for t in dataset_meta.get("tag_list", [])
    ]
    if not tag_list:
        raise ValueError("Dataset metadata has no tag_list")
    provider = data_provider
    if provider is None:
        dp_cfg = dataset_meta.get("data_provider")
        if not dp_cfg:
            raise ValueError(
                "No data_provider in dataset metadata and none supplied"
            )
        provider = GordoBaseDataProvider.from_dict(dict(dp_cfg))
    return TimeSeriesDataset(
        train_start_date=start,
        train_end_date=end,
        tag_list=tag_list,
        resolution=dataset_meta.get("resolution", "10min"),
        data_provider=provider,
    )


class RandomDataset(TimeSeriesDataset):
    """TimeSeriesDataset preconfigured with the RandomDataProvider
    (reference: ``datasets.RandomDataset``)."""

    @capture_args
    def __init__(
        self,
        train_start_date="2017-12-25 06:00:00Z",
        train_end_date="2017-12-29 06:00:00Z",
        tag_list: Optional[List] = None,
        **kwargs,
    ):
        kwargs.pop("data_provider", None)
        if not tag_list and not kwargs.get("tags"):
            tag_list = ["tag-1", "tag-2", "tag-3"]
        super().__init__(
            train_start_date=train_start_date,
            train_end_date=train_end_date,
            tag_list=tag_list,
            data_provider=RandomDataProvider(),
            **kwargs,
        )
