"""Model artifacts of the port.

Counterpart of ``gordo_tpu/serializer``, without pickle:

``````
<dir>/
  metadata.json     build and dataset metadata
  definition.json   into_definition() of the model
  arrays.npz        the fitted state as named numpy arrays
  fitted.json       the fitted metadata get_metadata() reads: the
                    detector's cv_metadata_ and pad_built_, the
                    estimator's history_ and fit_seconds_
``````

``load`` rebuilds the model from its definition, loads the arrays by
name (``base_estimator.steps.1.dense_0.weight``, ``scaler.scale``, ...)
and restores the fitted metadata, so a loaded model's ``get_metadata()``
is the dumped one's (the JAX package pickles the whole object).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

from gordo_tpu_torch.serializer.definition import (  # noqa: F401
    from_definition,
    into_definition,
)

METADATA_FILE = "metadata.json"
DEFINITION_FILE = "definition.json"
ARRAYS_FILE = "arrays.npz"
FITTED_FILE = "fitted.json"

#: fitted attributes carried beside the arrays, by the role of their owner
_DETECTOR_FITTED = ("cv_metadata_", "pad_built_")
_ESTIMATOR_FITTED = ("history_", "fit_seconds_")


def _fitted_owners(model: Any):
    """``{"detector": obj, "estimator": obj}`` of ``model``: the anomaly
    detector (if any) and the final estimator of its (or the model's)
    pipeline."""
    from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_tpu_torch.pipeline import Pipeline

    owners = {}
    base = model
    if isinstance(model, DiffBasedAnomalyDetector):
        owners["detector"] = model
        base = model.base_estimator
    owners["estimator"] = base._final if isinstance(base, Pipeline) else base
    return owners


def _fitted_state(model: Any) -> dict:
    state = {}
    for role, obj in _fitted_owners(model).items():
        names = _DETECTOR_FITTED if role == "detector" else _ESTIMATOR_FITTED
        attrs = {n: getattr(obj, n) for n in names if hasattr(obj, n)}
        if attrs.get("history_") is not None:
            attrs["history_"] = [float(v) for v in attrs["history_"]]
        state[role] = attrs
    return state


def _restore_fitted(model: Any, state: dict) -> None:
    for role, obj in _fitted_owners(model).items():
        for name, value in state.get(role, {}).items():
            if name == "history_" and value is not None:
                value = np.asarray(value, np.float32)
            setattr(obj, name, value)


def dump(model: Any, dest_dir: str, metadata: Optional[dict] = None) -> str:
    """Write ``model`` (and ``metadata``) into ``dest_dir``; returns the dir."""
    os.makedirs(dest_dir, exist_ok=True)
    with open(os.path.join(dest_dir, DEFINITION_FILE), "w") as f:
        json.dump(into_definition(model), f, indent=2)
    np.savez(os.path.join(dest_dir, ARRAYS_FILE), **model.state_arrays())
    with open(os.path.join(dest_dir, FITTED_FILE), "w") as f:
        json.dump(_fitted_state(model), f, indent=2)
    with open(os.path.join(dest_dir, METADATA_FILE), "w") as f:
        json.dump(metadata or {}, f, indent=2, default=str)
    return dest_dir


def is_artifact_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, DEFINITION_FILE)) and os.path.isfile(
        os.path.join(path, ARRAYS_FILE)
    )


def load(source_dir: str) -> Any:
    """Load a model written by :func:`dump`."""
    with open(os.path.join(source_dir, DEFINITION_FILE)) as f:
        model = from_definition(json.load(f))
    with np.load(os.path.join(source_dir, ARRAYS_FILE), allow_pickle=False) as npz:
        state = {k: npz[k] for k in npz.files}
    model = model.load_state_arrays(state)
    fitted = os.path.join(source_dir, FITTED_FILE)
    if os.path.exists(fitted):  # artifacts written before it was carried
        with open(fitted) as f:
            _restore_fitted(model, json.load(f))
    return model


def load_metadata(source_dir: str) -> dict:
    path = os.path.join(source_dir, METADATA_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)
