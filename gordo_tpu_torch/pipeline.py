"""Sequential pipeline container (counterpart of ``gordo_tpu/pipeline.py``).

Transforms are stats + pure-function scalers that the serving scorer folds
into the fused kernel.  ``fit`` fits each transform on X and transforms X
through it; the final estimator fits on the transformed X against the
**raw** y, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

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

    def fit(self, X, y=None, device=None, **fit_kwargs):
        for _, step in self.steps[:-1]:
            X = step.fit_transform(X, y, device=device)
        self._final.fit(X, y, device=device, **fit_kwargs)
        return self

    def get_metadata(self) -> Dict[str, Any]:
        final = self._final
        return final.get_metadata() if hasattr(final, "get_metadata") else {}

    def predict(self, X, device=None) -> np.ndarray:
        """Model output for ``X`` through the fused serving kernel."""
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).predict(X)

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
