"""Carry a model of the JAX package across to the port.

The JAX package's fitted state is given as numpy arrays, so this module
needs neither JAX nor ``gordo_tpu``:

- ``params``: the flax tree ``{"dense_i": {"kernel": (in, out), "bias":
  (out,)}, ..., "out": {...}}``; each kernel is transposed into the
  ``nn.Linear`` weight of the child of the same name.  An LSTM's tree is
  ``{"OptimizedLSTMCell_i": {"ii"|"if"|"ig"|"io": {"kernel"}, "hi"|"hf"|
  "hg"|"ho": {"kernel", "bias"}}, ..., "out": {...}}``; each cell's gate
  blocks are concatenated in the order i, f, g, o into the port cell's
  ``kernel_i`` (in, 4H), ``kernel_h`` (H, 4H) and ``bias`` (4H), as
  flax's ``_FusedLSTMCellParams`` concatenates them;
- ``scaler_stats``: the pipeline's transform steps' ``stats_`` in order;
- ``detector_stats``: the detector scaler's ``stats_``;
- the thresholds, and the definition dict (``gordo_tpu.*`` paths resolve
  through the port's alias table).

Stacked params, with a leading machine axis (the fleet build's layout),
go both ways: :func:`flax_to_layers` turns a stacked flax tree into the
fleet kernels' ``[(kernel (M, in, out), bias (M, out)), ...]`` list (the
tests give the port JAX's initial params so), and :func:`layers_to_flax`
turns the port's stacked layers back into the flax tree (the tests compare
fitted params leaf by leaf so).  :func:`flax_to_lstm_layers` and
:func:`lstm_layers_to_flax` do the same for an LSTM tree, with the
``lstm_layer`` kernel's ``[(kernel_i, kernel_h, bias), ...]`` cells and
the ``out`` head.

The tests feed both packages the same model with it; a JAX-artifact
importer (ROADMAP queue 1 item 4) builds on it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from gordo_tpu_torch.anomaly.diff import DiffBasedAnomalyDetector
from gordo_tpu_torch.models.estimator import AutoEncoder, LSTMAutoEncoder
from gordo_tpu_torch.models.factories.feedforward import layer_names
from gordo_tpu_torch.models.factories.lstm import cell_names
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


#: flax's gate order inside each fused LSTM block
GATES = "ifgo"

Cell = Tuple[np.ndarray, np.ndarray, np.ndarray]


def flax_to_lstm_layers(
    params: Mapping[str, Mapping[str, Any]],
) -> Tuple[List[Cell], Tuple[np.ndarray, np.ndarray]]:
    """Flax LSTM tree (any leading axes) → ``([(kernel_i, kernel_h, bias),
    ...], (out kernel, out bias))`` in application order, float32 numpy."""
    names = cell_names(len(params) - 1)
    if set(names) | {"out"} != set(params):
        raise ValueError(f"expected cells {names} and out, got {sorted(params)}")

    def cat(cell, prefix, leaf):
        return np.ascontiguousarray(
            np.concatenate([np.asarray(cell[prefix + g][leaf], np.float32) for g in GATES], -1)
        )

    cells = [
        (cat(params[n], "i", "kernel"), cat(params[n], "h", "kernel"), cat(params[n], "h", "bias"))
        for n in names
    ]
    out = params["out"]
    head = (np.ascontiguousarray(out["kernel"], np.float32),
            np.ascontiguousarray(out["bias"], np.float32))
    return cells, head


def lstm_layers_to_flax(cells: Sequence[Tuple[Any, Any, Any]], head: Tuple[Any, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flax_to_lstm_layers` (numpy or tensors, any
    leading axes) → the flax tree, as float32 numpy."""
    tree: Dict[str, Any] = {}
    for name, (ki, kh, b) in zip(cell_names(len(cells)), cells):
        ki, kh, b = (np.asarray(a, np.float32) for a in (ki, kh, b))
        parts = zip(GATES, np.split(ki, 4, -1), np.split(kh, 4, -1), np.split(b, 4, -1))
        cell: Dict[str, Any] = {}
        for g, kig, khg, bg in parts:
            cell["i" + g] = {"kernel": kig}
            cell["h" + g] = {"kernel": khg, "bias": bg}
        tree[name] = cell
    tree["out"] = {"kernel": np.asarray(head[0], np.float32), "bias": np.asarray(head[1], np.float32)}
    return tree


def flax_lstm_to_state_arrays(params: Mapping[str, Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """Flax LSTM tree → the port module's state dict (numpy)."""
    cells, (kernel, bias) = flax_to_lstm_layers(params)
    out: Dict[str, np.ndarray] = {}
    for name, (ki, kh, b) in zip(cell_names(len(cells)), cells):
        out[f"{name}.kernel_i"], out[f"{name}.kernel_h"], out[f"{name}.bias"] = ki, kh, b
    out["out.weight"] = np.ascontiguousarray(kernel.T)
    out["out.bias"] = bias
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
    if isinstance(est, AutoEncoder):
        state = flax_to_state_arrays(params)
    elif isinstance(est, LSTMAutoEncoder):
        state = flax_lstm_to_state_arrays(params)
    else:
        raise TypeError(
            f"final estimator {type(est).__name__} is not an AutoEncoder or an LSTM"
        )
    for step, stats in zip(transforms, scaler_stats):
        step.load_state_arrays(dict(stats))
    est.load_state_arrays(state)
    if isinstance(model, DiffBasedAnomalyDetector):
        if detector_stats is not None:
            model.scaler.load_state_arrays(dict(detector_stats))
        if feature_thresholds is not None:
            model.feature_thresholds_ = np.asarray(feature_thresholds, np.float32)
        if aggregate_threshold is not None:
            model.aggregate_threshold_ = float(aggregate_threshold)
    return model
