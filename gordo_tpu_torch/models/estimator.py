"""Estimators holding an ``nn.Module`` and its parameters.

Counterpart of ``gordo_tpu/models/estimator.py``.  Construct with
``kind=<registered factory name>`` plus kwargs; the network is built from
the widths of the parameters it is given.  Fitting (K1/K2) belongs to the
training slice, ROADMAP queue 1 item 2.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.registry import lookup_factory
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args


class AutoEncoder(ParamsMixin):
    """Feedforward reconstruction autoencoder (reference: ``KerasAutoEncoder``)."""

    model_type = "AutoEncoder"
    #: rows of the input consumed before the first prediction row
    offset = 0

    @capture_args
    def __init__(self, kind: str = "feedforward_hourglass", **kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.module_: Optional[torch.nn.Module] = None

    def fit(self, X, y=None, **fit_kwargs):
        raise NotImplementedError(
            "AutoEncoder.fit waits for ROADMAP queue 1 item 2 "
            "(training: K1 train step, K2 Adam)"
        )

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> "AutoEncoder":
        """Build the network from the widths of ``state`` (an ``nn.Linear``
        state dict as numpy arrays) and load it."""
        if not state:
            return self
        first = state["dense_0.weight"] if "dense_0.weight" in state else state["out.weight"]
        factory = lookup_factory(self.model_type, self.kind)
        module = factory(
            n_features=int(first.shape[1]),
            n_features_out=int(state["out.weight"].shape[0]),
            **self.kwargs,
        )
        module.load_state_dict(
            {k: torch.from_numpy(np.array(v, np.float32)) for k, v in state.items()}
        )
        self.module_ = module.eval()
        return self

    def state_arrays(self) -> Dict[str, np.ndarray]:
        if self.module_ is None:
            return {}
        return {
            k: v.detach().cpu().numpy() for k, v in self.module_.state_dict().items()
        }

    def predict(self, X, device=None) -> np.ndarray:
        """Model output for ``X`` through the fused serving kernel."""
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).predict(X)


KerasAutoEncoder = AutoEncoder
