"""Stacked multi-machine serving: many models resident on the card, scored
in one round of kernel launches per bucket.

Counterpart of ``gordo_tpu/serve/fleet_scorer.py``.  Machines whose chains
are structurally identical (widths, activations, mode, lookback, detector
window) share a :class:`_Bucket`: their parameters are stacked along a
leading machine axis and stay on the device.  A bucket scores as the
single-machine scorer does (:class:`~gordo_tpu_torch.serve.scorer._Stack`):
one ``fleet_score`` launch for a feedforward bucket, one ``lstm_layer``
per layer before it for an LSTM bucket, one ``rolling_median`` after it
with a window.  A request for part of a bucket passes the machines' stack
positions to every kernel (``idx``) instead of gathering their
parameters; ragged row counts pass as per-slot row counts (``n_rows``,
windows per slot ``n_rows - offset``) instead of repeat-last padding.
Used by ``POST .../_bulk/anomaly/prediction``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.serve.scorer import (
    CompiledScorer,
    _Stack,
    _extract_chain,
    short_rows_message,
)


def _signature(chain: Dict[str, Any]) -> Optional[Tuple]:
    det = chain["detector"]
    if det is None:
        return None
    if det["feature_thresholds"] is None and det["require_thresholds"]:
        # the per-machine path refuses to serve this model; route it through
        # the fallback so the same per-machine error surfaces here
        return None
    return (
        chain["n_features"],
        chain["mode"],
        chain["lookback"],
        tuple(ki.shape for ki, _, _ in chain["cells"]),
        chain["cell_acts"],
        tuple(W.shape for W, _ in chain["layers"]),
        chain["acts"],
        chain["scale"] is not None,
        det["window"],
        det["feature_thresholds"] is not None,
    )


class _Bucket(_Stack):
    """One structurally identical group of machines, stacked on the device."""

    def __init__(self, names: List[str], chains: List[Dict[str, Any]], device):
        super().__init__(chains, device)
        self.names = names
        self.position = {n: i for i, n in enumerate(names)}


class FleetDispatch:
    """Finished launches whose per-machine slicing is deferred to
    :meth:`assemble` (host arrays only, safe on any thread)."""

    def __init__(self):
        #: results final at dispatch time: per-machine errors, fallbacks
        self.results: Dict[str, Dict[str, Any]] = {}
        #: (host outputs, bucket, [(name, slot, stack_pos, n_valid), ...])
        self._pending: List[Tuple[Dict[str, np.ndarray], _Bucket, List[Tuple]]] = []

    def assemble(self) -> Dict[str, Dict[str, Any]]:
        pending, self._pending = self._pending, []
        for out, bucket, slots in pending:
            for name, slot, stack_pos, n_valid in slots:
                res = {k: v[slot][:n_valid] for k, v in out.items()}
                if bucket.with_thresholds:
                    res["tag-anomaly-thresholds"] = bucket.thresholds_np[stack_pos].copy()
                    res["total-anomaly-threshold"] = float(bucket.agg_thresholds_np[stack_pos])
                self.results[name] = res
        return self.results


class FleetScorer:
    """Serve many machines' anomaly scoring as stacked kernel launches.

    Machines that cannot bucket (no detector, or missing thresholds that
    are required) are served by their own :class:`CompiledScorer`, which
    reports the same per-machine error the single-machine route does.
    """

    def __init__(self, device):
        self.device = device
        self.buckets: List[_Bucket] = []
        self.fallbacks: Dict[str, CompiledScorer] = {}

    @classmethod
    def from_models(cls, models: Dict[str, Any], device=None) -> "FleetScorer":
        self = cls(resolve_device(device))
        groups: Dict[Tuple, Tuple[List[str], List[Dict]]] = {}
        for name, model in sorted(models.items()):
            chain = _extract_chain(model)
            sig = _signature(chain)
            if sig is None:
                self.fallbacks[name] = CompiledScorer(model, device=self.device, machine=name)
                continue
            names, chains = groups.setdefault(sig, ([], []))
            names.append(name)
            chains.append(chain)
        for names, chains in groups.values():
            self.buckets.append(_Bucket(names, chains, self.device))
        return self

    def score_all(self, X_by_name: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
        """Score every machine's rows, one launch per bucket."""
        return self.dispatch_all(X_by_name).assemble()

    def dispatch_all(self, X_by_name: Dict[str, Any]) -> FleetDispatch:
        dispatch = FleetDispatch()
        results = dispatch.results
        for bucket in self.buckets:
            arrays: Dict[str, np.ndarray] = {}
            for name in bucket.names:
                if name not in X_by_name:
                    continue
                arr = np.asarray(X_by_name[name], np.float32)
                # one malformed machine reports in its own slot and must
                # not sink the stacked launch; "client-error" maps to 400
                if arr.ndim != 2:
                    error = f"X must be 2-dimensional, got shape {arr.shape}"
                elif arr.shape[0] <= bucket.offset_rows:
                    error = short_rows_message(bucket.offset_rows, arr.shape[0])
                elif arr.shape[1] != bucket.n_features:
                    error = (
                        f"X has {arr.shape[1]} columns; model expects "
                        f"{bucket.n_features}"
                    )
                else:
                    arrays[name] = arr
                    continue
                results[name] = {"error": error, "client-error": True}
            if not arrays:
                continue
            wanted = list(arrays)
            rows = [arrays[n].shape[0] for n in wanted]
            n = max(rows)
            stacked = np.zeros((len(wanted), n, bucket.n_features), np.float32)
            for i, name in enumerate(wanted):
                stacked[i, : rows[i]] = arrays[name]
            positions = [bucket.position[name] for name in wanted]
            full = positions == list(range(len(bucket.names)))
            out = bucket.score(
                stacked,
                with_anomaly=True,
                idx=None if full else positions,
                n_rows=None if min(rows) == n else rows,
            )
            slots = [
                (name, i, positions[i], rows[i] - bucket.offset_rows)
                for i, name in enumerate(wanted)
            ]
            dispatch._pending.append((out, bucket, slots))

        for name, scorer in self.fallbacks.items():
            if name not in X_by_name:
                continue
            try:
                if scorer.is_anomaly:
                    results[name] = scorer.anomaly_arrays(X_by_name[name])
                else:
                    # non-anomaly model: serve its plain prediction
                    results[name] = {"model-output": scorer.predict(X_by_name[name])}
            except Exception as exc:
                # missing thresholds, malformed rows: report per machine
                # instead of sinking the bulk request
                results[name] = {
                    "error": str(exc),
                    "client-error": isinstance(exc, ValueError),
                }
        return dispatch

