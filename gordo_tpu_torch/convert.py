"""Carry a model of the JAX package across to the port.

The JAX package's fitted state is given as numpy arrays, so this module
needs neither JAX nor ``gordo_tpu``:

- ``params``: the flax tree ``{"dense_i": {"kernel": (in, out), "bias":
  (out,)}, ..., "out": {...}}``; each kernel is transposed into the
  ``nn.Linear`` weight of the child of the same name;
- ``scaler_stats``: the pipeline's transform steps' ``stats_`` in order;
- ``detector_stats``: the detector scaler's ``stats_``;
- the thresholds, and the definition dict (``gordo_tpu.*`` paths resolve
  through the port's alias table).

The tests feed both packages the same model with it; a JAX-artifact
importer (ROADMAP queue 1 item 4) builds on it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimator import AutoEncoder
from gordo_tpu_torch.pipeline import Pipeline
from gordo_tpu_torch.serializer.definition import from_definition


def flax_to_state_arrays(params: Mapping[str, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """Flax ``Dense`` tree → ``nn.Linear`` state dict (numpy, weights transposed)."""
    out: Dict[str, np.ndarray] = {}
    for name, leaf in params.items():
        out[f"{name}.weight"] = np.ascontiguousarray(
            np.asarray(leaf["kernel"], np.float32).T
        )
        out[f"{name}.bias"] = np.array(leaf["bias"], np.float32)
    return out


def from_reference(
    definition: Any,
    params: Mapping[str, Mapping[str, Any]],
    scaler_stats: Sequence[Mapping[str, Any]] = (),
    detector_stats: Optional[Mapping[str, Any]] = None,
    feature_thresholds: Optional[Any] = None,
    aggregate_threshold: Optional[float] = None,
):
    """The port's model for a JAX model given by its definition and arrays."""
    model = from_definition(definition)
    base = model.base_estimator if isinstance(model, DiffBasedAnomalyDetector) else model
    if isinstance(base, Pipeline):
        transforms = [step for _, step in base.steps[:-1]]
        est = base._final
    else:
        transforms, est = [], base
    if len(transforms) != len(scaler_stats):
        raise ValueError(
            f"definition has {len(transforms)} transform steps, got stats for "
            f"{len(scaler_stats)}"
        )
    if not isinstance(est, AutoEncoder):
        raise TypeError(f"final estimator {type(est).__name__} is not an AutoEncoder")
    for step, stats in zip(transforms, scaler_stats):
        step.load_state_arrays(dict(stats))
    est.load_state_arrays(flax_to_state_arrays(params))
    if isinstance(model, DiffBasedAnomalyDetector):
        if detector_stats is not None:
            model.scaler.load_state_arrays(dict(detector_stats))
        if feature_thresholds is not None:
            model.feature_thresholds_ = np.asarray(feature_thresholds, np.float32)
        if aggregate_threshold is not None:
            model.aggregate_threshold_ = float(aggregate_threshold)
    return model
