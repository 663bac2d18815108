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

Stacked params, with a leading machine axis (the fleet build's layout),
go both ways: :func:`flax_to_layers` turns a stacked flax tree into the
fleet kernels' ``[(kernel (M, in, out), bias (M, out)), ...]`` list (the
tests give the port JAX's initial params so), and :func:`layers_to_flax`
turns the port's stacked layers back into the flax tree (the tests compare
fitted params leaf by leaf so).

The tests feed both packages the same model with it; a JAX-artifact
importer (ROADMAP queue 1 item 4) builds on it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimator import AutoEncoder
from gordo_tpu_torch.models.factories.feedforward import layer_names
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


def flax_to_layers(params: Mapping[str, Mapping[str, Any]]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Flax ``Dense`` tree (any leading axes) → ``[(kernel, bias), ...]``
    in application order, as float32 numpy."""
    names = layer_names(len(params))
    if set(names) != set(params):
        raise ValueError(f"expected layers {names}, got {sorted(params)}")
    return [
        (np.ascontiguousarray(params[n]["kernel"], np.float32),
         np.ascontiguousarray(params[n]["bias"], np.float32))
        for n in names
    ]


def layers_to_flax(layers: Sequence[Tuple[Any, Any]]) -> Dict[str, Dict[str, np.ndarray]]:
    """``[(kernel, bias), ...]`` (numpy or tensors, any leading axes) →
    the flax ``Dense`` tree, as float32 numpy."""
    return {
        name: {"kernel": np.asarray(W, np.float32), "bias": np.asarray(b, np.float32)}
        for name, (W, b) in zip(layer_names(len(layers)), layers)
    }


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
