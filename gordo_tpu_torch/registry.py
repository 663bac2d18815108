"""Component registries of the port.

1. ``register_model_builder`` / ``lookup_factory``: the model-factory
   registry, ``{model_type: {name: fn}}``, as in ``gordo_tpu/registry.py``.
2. ``ALIASES``: dotted paths that definitions name, resolved to the
   port's classes.  ``DEFAULT_MODEL`` and project YAMLs name the JAX
   package's classes (``gordo_tpu.*``), and reference-era configs name
   ``sklearn.*`` / ``gordo_components.*``; all of them map here onto
   ``gordo_tpu_torch.*`` so that one definition builds on both packages.
   A ``gordo_tpu.*`` path is never imported: only the port's own module
   paths reach ``importlib``.
3. ``UNPORTED``: paths the port knows but does not serve yet, each with
   the ROADMAP item it waits for.  Resolving one raises
   ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict

# {model_type: {factory_name: factory_fn}}
FACTORY_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_model_builder(type: str) -> Callable:  # noqa: A002 - parity name
    """Decorator filing a model factory under an estimator type."""

    def decorator(fn: Callable) -> Callable:
        FACTORY_REGISTRY.setdefault(type, {})[fn.__name__] = fn
        return fn

    return decorator


def lookup_factory(model_type: str, kind: str) -> Callable:
    """Resolve a registered factory; raise with the available names."""
    # factories register on import of their module
    import gordo_tpu_torch.models.factories  # noqa: F401

    by_type = FACTORY_REGISTRY.get(model_type, {})
    if kind in by_type:
        return by_type[kind]
    raise ValueError(
        f"Unknown model factory kind={kind!r} for type={model_type!r}; "
        f"available: {sorted(by_type)}"
    )


_DETECTOR = "gordo_tpu_torch.anomaly.diff.DiffBasedAnomalyDetector"
_PIPELINE = "gordo_tpu_torch.pipeline.Pipeline"
_MINMAX = "gordo_tpu_torch.ops.scalers.MinMaxScaler"
_STANDARD = "gordo_tpu_torch.ops.scalers.StandardScaler"
_ROBUST = "gordo_tpu_torch.ops.scalers.RobustScaler"
_SCALERS = "gordo_tpu_torch.ops.scalers"
_FUNCS = "gordo_tpu_torch.ops.transformer_funcs"
_AUTOENCODER = "gordo_tpu_torch.models.estimator.AutoEncoder"
_LSTM_AE = "gordo_tpu_torch.models.estimator.LSTMAutoEncoder"
_LSTM_FORECAST = "gordo_tpu_torch.models.estimator.LSTMForecast"

ALIASES: Dict[str, str] = {
    # the JAX package's own paths (DEFAULT_MODEL, project YAMLs)
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": _DETECTOR,
    "gordo_tpu.pipeline.Pipeline": _PIPELINE,
    "gordo_tpu.ops.scalers.MinMaxScaler": _MINMAX,
    "gordo_tpu.ops.scalers.StandardScaler": _STANDARD,
    "gordo_tpu.ops.scalers.RobustScaler": _ROBUST,
    "gordo_tpu.models.estimator.AutoEncoder": _AUTOENCODER,
    "gordo_tpu.models.estimator.KerasAutoEncoder": _AUTOENCODER,
    "gordo_tpu.models.estimator.LSTMAutoEncoder": _LSTM_AE,
    "gordo_tpu.models.estimator.KerasLSTMAutoEncoder": _LSTM_AE,
    "gordo_tpu.models.estimator.LSTMForecast": _LSTM_FORECAST,
    "gordo_tpu.models.estimator.KerasLSTMForecast": _LSTM_FORECAST,
    # reference-era paths
    "sklearn.pipeline.Pipeline": _PIPELINE,
    "sklearn.preprocessing.MinMaxScaler": _MINMAX,
    "sklearn.preprocessing.data.MinMaxScaler": _MINMAX,
    "sklearn.preprocessing.StandardScaler": _STANDARD,
    "sklearn.preprocessing.data.StandardScaler": _STANDARD,
    "sklearn.preprocessing.RobustScaler": _ROBUST,
    "sklearn.preprocessing.data.RobustScaler": _ROBUST,
    "gordo_components.model.models.KerasAutoEncoder": _AUTOENCODER,
    "gordo_components.model.models.KerasRawModelRegressor": _AUTOENCODER,
    "gordo_components.model.models.KerasLSTMAutoEncoder": _LSTM_AE,
    "gordo_components.model.models.KerasLSTMForecast": _LSTM_FORECAST,
    "gordo_components.model.anomaly.diff.DiffBasedAnomalyDetector": _DETECTOR,
}
# the single-machine transforms and the transformer funcs
for _name, _sklearn in (
    ("QuantileTransformer", ("preprocessing.QuantileTransformer", "preprocessing.data.QuantileTransformer")),
    ("FunctionTransformer", ("preprocessing.FunctionTransformer",)),
    ("SimpleImputer", ("impute.SimpleImputer",)),
    ("PCA", ("decomposition.PCA",)),
):
    ALIASES[f"gordo_tpu.ops.scalers.{_name}"] = f"{_SCALERS}.{_name}"
    for _path in _sklearn:
        ALIASES[f"sklearn.{_path}"] = f"{_SCALERS}.{_name}"
for _name in ("multiplier", "adder", "log1p", "expm1"):
    ALIASES[f"gordo_tpu.ops.transformer_funcs.{_name}"] = f"{_FUNCS}.{_name}"
    ALIASES[f"gordo_components.model.transformer_funcs.general.{_name}"] = f"{_FUNCS}.{_name}"
# datasets and data providers, by the JAX package's and the reference's paths
for _name in ("TimeSeriesDataset", "RandomDataset"):
    for _prefix in ("gordo_tpu.dataset.datasets", "gordo_components.dataset.datasets"):
        ALIASES[f"{_prefix}.{_name}"] = f"gordo_tpu_torch.dataset.datasets.{_name}"
for _name in (
    "RandomDataProvider", "FileSystemTagProvider", "IrocBundleProvider",
    "InfluxDataProvider", "DataLakeProvider",
):
    for _prefix in (
        "gordo_tpu.dataset.data_provider.providers",
        "gordo_components.dataset.data_provider.providers",
    ):
        ALIASES[f"{_prefix}.{_name}"] = f"gordo_tpu_torch.dataset.data_provider.providers.{_name}"

_ITEM_TRAINING = "ROADMAP queue 1 item 2 (training: the other pipeline containers)"

UNPORTED: Dict[str, str] = {}
for _path in (
    "gordo_tpu.pipeline.FeatureUnion",
    "gordo_tpu.pipeline.TransformedTargetRegressor",
    "gordo_tpu.pipeline.MultiOutputRegressor",
    "sklearn.pipeline.FeatureUnion",
    "sklearn.compose.TransformedTargetRegressor",
    "sklearn.multioutput.MultiOutputRegressor",
):
    UNPORTED[_path] = _ITEM_TRAINING

#: the only prefix ``importlib`` ever sees (after alias rewriting)
ALLOWED_IMPORT_PREFIXES = ("gordo_tpu_torch.",)


def resolve_alias(dotted: str) -> str:
    """Port path for ``dotted``; raises for a known but unported path."""
    if dotted in UNPORTED:
        raise NotImplementedError(f"{dotted} waits for {UNPORTED[dotted]}")
    return ALIASES.get(dotted, dotted)
