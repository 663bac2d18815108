"""Sequential pipeline container (counterpart of ``gordo_tpu/pipeline.py``).

Transforms are stats + pure-function scalers.  ``fit`` fits each transform
on X and transforms X through it, on the device (the stat kernels, then
``chain_apply``); the final estimator fits on the transformed X against
the **raw** y, as in the JAX package.  The serving scorer folds a chain of
MinMax, Standard and Robust steps into the fused kernel and runs any
other chain through ``chain_apply`` first.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gordo_tpu_torch.ops.scalers import rows_tensor
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args

StepLike = Union[Any, Tuple[str, Any], List]


def _normalize_steps(steps: Sequence[StepLike]) -> List[Tuple[str, Any]]:
    normalized = []
    for i, step in enumerate(steps):
        if isinstance(step, (tuple, list)) and len(step) == 2 and isinstance(step[0], str):
            normalized.append((step[0], step[1]))
        else:
            normalized.append((f"step_{i}", step))
    return normalized


class Pipeline(ParamsMixin):
    """Sequential transform chain ending in an estimator."""

    @capture_args
    def __init__(self, steps: Sequence[StepLike], memory: Optional[str] = None):
        self.steps = _normalize_steps(steps)
        self.memory = memory

    @property
    def _final(self) -> Any:
        return self.steps[-1][1]

    @property
    def offset(self) -> int:
        return getattr(self._final, "offset", 0)

    def _transform_until_final(self, X, device=None) -> torch.Tensor:
        x = rows_tensor(X, device)
        for _, step in self.steps[:-1]:
            x = step.transform(x)
        return x

    def fit(self, X, y=None, device=None, **fit_kwargs):
        """Fit each transform on the previous one's output on ``device``
        (:func:`gordo_tpu_torch.device.resolve_device`), then the final
        estimator on the transformed rows against ``y``."""
        x = rows_tensor(X, device)
        for _, step in self.steps[:-1]:
            x = step.fit_transform(x, y)
        self._final.fit(x.cpu().numpy(), y, device=device, **fit_kwargs)
        return self

    def transform(self, X, device=None):
        """``X`` through every transform step (and the final step's own
        ``transform``, where it has one), as host rows."""
        x = self._transform_until_final(X, device)
        if hasattr(self._final, "transform"):
            x = self._final.transform(x)
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def fit_transform(self, X, y=None, device=None):
        return self.fit(X, y, device=device).transform(X, device=device)

    def get_metadata(self) -> Dict[str, Any]:
        final = self._final
        return final.get_metadata() if hasattr(final, "get_metadata") else {}

    def predict(self, X, device=None) -> np.ndarray:
        """Model output for ``X`` through the fused serving kernel."""
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device, dtype="float32").predict(X)

    def state_arrays(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for i, (_, step) in enumerate(self.steps):
            for k, v in step.state_arrays().items():
                out[f"steps.{i}.{k}"] = v
        return out

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> "Pipeline":
        for i, (_, step) in enumerate(self.steps):
            prefix = f"steps.{i}."
            sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            if sub:
                step.load_state_arrays(sub)
        return self

    def get_params(self, deep: bool = False):
        if all(name == f"step_{i}" for i, (name, _) in enumerate(self.steps)):
            return {"steps": [obj for _, obj in self.steps]}
        return {"steps": [[name, obj] for name, obj in self.steps]}
