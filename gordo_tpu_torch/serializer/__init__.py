"""Model artifacts of the port.

Counterpart of ``gordo_tpu/serializer``, without pickle:

``````
<dir>/
  metadata.json     build and dataset metadata
  definition.json   into_definition() of the model
  arrays.npz        the fitted state as named numpy arrays
``````

``load`` rebuilds the model from its definition and loads the arrays by
name (``base_estimator.steps.1.dense_0.weight``, ``scaler.scale``, ...).
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


def dump(model: Any, dest_dir: str, metadata: Optional[dict] = None) -> str:
    """Write ``model`` (and ``metadata``) into ``dest_dir``; returns the dir."""
    os.makedirs(dest_dir, exist_ok=True)
    with open(os.path.join(dest_dir, DEFINITION_FILE), "w") as f:
        json.dump(into_definition(model), f, indent=2)
    np.savez(os.path.join(dest_dir, ARRAYS_FILE), **model.state_arrays())
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
    return model.load_state_arrays(state)


def load_metadata(source_dir: str) -> dict:
    path = os.path.join(source_dir, METADATA_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)
