"""Estimators holding an ``nn.Module`` and its parameters.

Counterpart of ``gordo_tpu/models/estimator.py``.  Construct with
``kind=<registered factory name>`` plus kwargs; the network is built from
``X.shape`` at fit time, or from the widths of the parameters it is
loaded with.  An ``AutoEncoder`` fit is one launch of the ``fleet_fit``
kernel (K1 + K2) over a fleet of one machine, from the draws of its seed.
``LSTMAutoEncoder`` and ``LSTMForecast`` serve (through the
``lstm_layer`` and ``fleet_score`` kernels) but do not train yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.kernels.fleet_fit import fleet_fit, geometry
from gordo_tpu_torch.models.factories.feedforward import layer_names
from gordo_tpu_torch.ops.scalers import as_float2d
from gordo_tpu_torch.parallel.fleet import Draws, chain_of, fleet_draws, put_draws
from gordo_tpu_torch.registry import lookup_factory
from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args


class _Estimator(ParamsMixin):
    """What the estimators share: construction, metadata, state, predict."""

    model_type = "AutoEncoder"
    #: rows of the input consumed before the first prediction row
    offset = 0

    @capture_args
    def __init__(self, kind: str = "feedforward_hourglass", **kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.module_: Optional[torch.nn.Module] = None
        self.history_: Optional[np.ndarray] = None
        self.fit_seconds_: Optional[float] = None

    def get_metadata(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {
            "model_type": type(self).__name__,
            "kind": self.kind,
            "parameters": {**self.kwargs},
        }
        if self.module_ is not None:
            meta.update({
                "num_params": int(sum(p.numel() for p in self.module_.parameters())),
                "fit_seconds": self.fit_seconds_,
                "history": {
                    "loss": [float(v) for v in ([] if self.history_ is None else self.history_)],
                },
            })
        return meta

    def _load_module(self, n_features: int, n_features_out: int, state: Dict[str, np.ndarray]):
        module = lookup_factory(self.model_type, self.kind)(
            n_features=n_features, n_features_out=n_features_out, **self.kwargs,
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
        """Model output for ``X`` through the serving kernels (``offset``
        fewer rows than ``X``)."""
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device).predict(X)


class AutoEncoder(_Estimator):
    """Feedforward reconstruction autoencoder (reference: ``KerasAutoEncoder``)."""

    def fit(self, X, y=None, device=None, draws: Draws = fleet_draws, **fit_kwargs):
        """Fit on ``X`` (rows × features) against ``y`` (default ``X``).

        ``device`` as :func:`gordo_tpu_torch.device.resolve_device`;
        ``draws`` the source of initial params and permutations
        (:func:`gordo_tpu_torch.parallel.fleet.fleet_draws`); ``fit_kwargs``
        override the constructor's training kwargs."""
        t0 = time.time()
        X = as_float2d(X)
        targets = X if y is None else as_float2d(y)
        merged = {**self.kwargs, **fit_kwargs}
        if merged.get("checkpoint_dir"):
            raise NotImplementedError(
                "checkpoint_dir waits for ROADMAP queue 1 item 6 (train/checkpoint.py)"
            )
        merged.pop("checkpoint_dir", None)
        merged.pop("checkpoint_every", None)
        cfg, factory_kwargs = TrainConfig.from_kwargs(merged)
        hp = adam_hparams(cfg)
        module = lookup_factory(self.model_type, self.kind)(
            n_features=int(X.shape[1]),
            n_features_out=int(targets.shape[1]),
            **factory_kwargs,
        )
        dims, acts = chain_of(module)
        dev = resolve_device(device)
        fits = [geometry(np.arange(X.shape[0]), cfg.batch_size)]
        seed = int(factory_kwargs.get("seed", 0) or 0)
        params0, perms = put_draws(draws, seed, dims, fits, cfg.epochs, dev)
        x = torch.from_numpy(X[None]).to(dev)
        ones = torch.ones((1, 1, X.shape[1]), dtype=torch.float32, device=dev)
        with torch.no_grad():
            layers, history = fleet_fit(
                x, torch.from_numpy(targets[None]).to(dev), fits, ones,
                torch.zeros_like(ones), params0, perms, [0], acts, cfg.epochs, hp,
            )
        state = {}
        for name, (W, b) in zip(layer_names(len(layers)), layers):
            state[f"{name}.weight"] = W[0, 0].T.contiguous().cpu()
            state[f"{name}.bias"] = b[0, 0].cpu()
        module.load_state_dict(state)
        self.module_ = module.eval()
        self.history_ = history[0, 0].cpu().numpy()
        self.fit_seconds_ = time.time() - t0
        return self

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> "AutoEncoder":
        """Build the network from the widths of ``state`` (an ``nn.Linear``
        state dict as numpy arrays) and load it."""
        if not state:
            return self
        first = state["dense_0.weight"] if "dense_0.weight" in state else state["out.weight"]
        return self._load_module(int(first.shape[1]), int(state["out.weight"].shape[0]), state)


class LSTMAutoEncoder(_Estimator):
    """Windowed LSTM reconstruction (reference: ``KerasLSTMAutoEncoder``).

    The model reconstructs each ``lookback_window``-row window's last row,
    so predictions start at row ``lookback_window - 1`` of the input
    (``offset``)."""

    model_type = "LSTMAutoEncoder"

    @capture_args
    def __init__(self, kind: str = "lstm_hourglass", **kwargs):
        super().__init__(kind=kind, **kwargs)

    @property
    def lookback_window(self) -> int:
        return int(self.kwargs.get("lookback_window", 1))

    @property
    def offset(self) -> int:
        return self.lookback_window - 1

    def fit(self, X, y=None, device=None, **fit_kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}.fit waits for ROADMAP queue 1 item 5 "
            "(LSTM training, K6 backward)"
        )

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> "LSTMAutoEncoder":
        """Build the network from the widths of ``state`` (the module's
        state dict as numpy arrays) and load it."""
        if not state:
            return self
        return self._load_module(
            int(state["OptimizedLSTMCell_0.kernel_i"].shape[0]),
            int(state["out.weight"].shape[0]),
            state,
        )


class LSTMForecast(LSTMAutoEncoder):
    """Windowed LSTM one-step-ahead forecast (reference:
    ``KerasLSTMForecast``): the window of rows ``t - L .. t - 1`` predicts
    row ``t``, so predictions start at row ``lookback_window``."""

    @property
    def offset(self) -> int:
        return self.lookback_window


# Parity aliases (reference class names).
KerasAutoEncoder = AutoEncoder
KerasLSTMAutoEncoder = LSTMAutoEncoder
KerasLSTMForecast = LSTMForecast
