"""Estimators holding an ``nn.Module`` and its parameters.

Counterpart of ``gordo_tpu/models/estimator.py``.  Construct with
``kind=<registered factory name>`` plus kwargs; the network is built from
``X.shape`` at fit time, or from the widths of the parameters it is
loaded with.  An ``AutoEncoder`` fit is one launch of the ``fleet_fit``
kernel (K1 + K2) over a fleet of one machine, from the draws of its seed;
an ``LSTMAutoEncoder`` or ``LSTMForecast`` fit is the lockstep LSTM fit
(``gordo_tpu_torch/train/lstm_fit.py``: ``lstm_layer``, ``lstm_head_fit``,
``lstm_layer_bwd``, ``fleet_adam``) over a fleet of one machine.  Both
serve through the ``lstm_layer`` and ``fleet_score`` kernels.  A fit with
``checkpoint_dir`` runs in chunks of ``checkpoint_every`` epochs (default
10), each from the last one's params and Adam state, with a checkpoint
after each (``gordo_tpu_torch/train/checkpoint.py``), and resumes from a
checkpoint of the same fit: bit for bit the uninterrupted fit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gordo_tpu_torch.device import resolve_device
from gordo_tpu_torch.kernels.fleet_fit import FitState, fleet_fit, flat_params, geometry, split_params
from gordo_tpu_torch.models.factories.feedforward import layer_names
from gordo_tpu_torch.models.factories.lstm import cell_names, lstm_state
from gordo_tpu_torch.ops.scalers import as_float2d
from gordo_tpu_torch.parallel.fleet import (
    Draws,
    LSTMDims,
    chain_of,
    fleet_draws,
    lstm_chain_of,
    put_draws,
    put_lstm_draws,
)
from gordo_tpu_torch.registry import lookup_factory
from gordo_tpu_torch.train import checkpoint
from gordo_tpu_torch.train.fit import AdamState, TrainConfig, adam_hparams
from gordo_tpu_torch.train.lstm_fit import lstm_fit, window_fit
from gordo_tpu_torch.utils.args import ParamsMixin, capture_args


def _chain_leaves(dims) -> List[str]:
    """The names of a chain's leaves in the fits' order: each dense
    layer's ``kernel`` (in, out) and ``bias``, or each LSTM cell's
    ``kernel_i``, ``kernel_h``, ``bias`` and the head's ``kernel`` and
    ``bias`` (``dims`` an ``LSTMDims``)."""
    if isinstance(dims, LSTMDims):
        cells = [f"{c}.{k}" for c in cell_names(len(dims) - 2) for k in ("kernel_i", "kernel_h", "bias")]
        return cells + ["out.kernel", "out.bias"]
    return [f"{n}.{k}" for n in layer_names(len(dims) - 1) for k in ("kernel", "bias")]


def _named(part: str, names: List[str], leaves) -> Dict[str, np.ndarray]:
    """One fit's leaves (each with leading axes (1, 1)) as checkpoint arrays."""
    return {f"{part}/{k}": leaf[0, 0].cpu().numpy() for k, leaf in zip(names, leaves)}


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A checkpoint array as one fit's leaf on ``device``: (1, 1, ...)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)[None, None]).to(device)


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

    def _fit_setup(self, X, y, fit_kwargs):
        """``(X, targets, cfg, hp, module, seed, resume)`` of a fit: the
        training config from the constructor's kwargs and ``fit_kwargs``,
        the factory's module for the widths of ``X`` and the targets, and
        ``resume(dims, run_chunk)``, which runs the fit in checkpointed
        chunks (None without a ``checkpoint_dir``)."""
        X = as_float2d(X)
        targets = X if y is None else as_float2d(y)
        merged = {**self.kwargs, **fit_kwargs}
        checkpoint_dir = merged.pop("checkpoint_dir", None)
        checkpoint_every = int(merged.pop("checkpoint_every", 10) or 10)
        cfg, factory_kwargs = TrainConfig.from_kwargs(merged)
        hp = adam_hparams(cfg)
        module = lookup_factory(self.model_type, self.kind)(
            n_features=int(X.shape[1]),
            n_features_out=int(targets.shape[1]),
            **factory_kwargs,
        )
        seed = int(factory_kwargs.get("seed", 0) or 0)
        resume = None
        if checkpoint_dir:
            def resume(dims, run_chunk):
                fingerprint = checkpoint.fit_fingerprint(
                    self.model_type, self.kind, factory_kwargs, dims, cfg, seed, X, targets)
                return checkpoint.fit_checkpointed(
                    run_chunk, fingerprint, checkpoint_dir, cfg.epochs, checkpoint_every)
        return X, targets, cfg, hp, module, seed, resume

    def predict(self, X, device=None) -> np.ndarray:
        """Model output for ``X`` through the serving kernels (``offset``
        fewer rows than ``X``)."""
        from gordo_tpu_torch.serve.scorer import CompiledScorer

        return CompiledScorer(self, device=device, dtype="float32").predict(X)


class AutoEncoder(_Estimator):
    """Feedforward reconstruction autoencoder (reference: ``KerasAutoEncoder``)."""

    def fit(self, X, y=None, device=None, draws: Draws = fleet_draws, **fit_kwargs):
        """Fit on ``X`` (rows × features) against ``y`` (default ``X``).

        ``device`` as :func:`gordo_tpu_torch.device.resolve_device`;
        ``draws`` the source of initial params and permutations
        (:func:`gordo_tpu_torch.parallel.fleet.fleet_draws`); ``fit_kwargs``
        override the constructor's training kwargs (``checkpoint_dir`` and
        ``checkpoint_every`` among them)."""
        t0 = time.time()
        X, targets, cfg, hp, module, seed, resume = self._fit_setup(X, y, fit_kwargs)
        dims, acts = chain_of(module)
        dev = resolve_device(device)
        fits = [geometry(np.arange(X.shape[0]), cfg.batch_size)]
        params0, perms = put_draws(draws, seed, dims, fits, cfg.epochs, dev)
        x = torch.from_numpy(X[None]).to(dev)
        t = torch.from_numpy(targets[None]).to(dev)
        names = _chain_leaves(dims)
        n_total = fits[0].n_total

        def run_chunk(start, e0, e1):
            p0, state = params0, None
            if start is not None:  # one machine's params per fit, its Adam state
                arrays, count = start
                leaves = [_put(arrays[f"params/{k}"], dev) for k in names]
                p0 = [(leaves[2 * i], leaves[2 * i + 1]) for i in range(len(leaves) // 2)]
                state = FitState(
                    *(flat_params([_put(arrays[f"{m}/{k}"], dev) for k in names], 2) for m in ("mu", "nu")),
                    torch.tensor([[int(count)]], dtype=torch.int32, device=dev),
                )
            with torch.no_grad():
                layers, history, state = fleet_fit(
                    x, t, fits, p0, perms[:, e0 * n_total: e1 * n_total].contiguous(), [0], acts, e1 - e0, hp,
                    state=state, return_state=True,
                )
            arrays = _named("params", names, [a for pair in layers for a in pair])
            for m, flat in (("mu", state.mu), ("nu", state.nu)):
                arrays.update(_named(m, names, split_params(flat, dims)))
            return arrays, int(state.count[0, 0]), history[0, 0].cpu().numpy()

        if resume is None:
            arrays, _, history = run_chunk(None, 0, cfg.epochs)
        else:
            arrays, _, history = resume(dims, run_chunk)
        state = {}
        for name in layer_names(len(dims) - 1):
            state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arrays[f"params/{name}.kernel"].T))
            state[f"{name}.bias"] = torch.from_numpy(arrays[f"params/{name}.bias"])
        module.load_state_dict(state)
        self.module_ = module.eval()
        self.history_ = history
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

    def fit(self, X, y=None, device=None, draws: Draws = fleet_draws, **fit_kwargs):
        """Fit on the windows of ``X`` (rows × features) against ``y``
        (default ``X``) from row ``offset`` on: the lockstep LSTM fit with
        one machine and one fit.  Arguments as :meth:`AutoEncoder.fit`."""
        t0 = time.time()
        X, targets, cfg, hp, module, seed, resume = self._fit_setup(X, y, fit_kwargs)
        dims, acts, out_act = lstm_chain_of(module)
        dev = resolve_device(device)
        fits = [window_fit(np.arange(X.shape[0]), cfg.batch_size, self.offset)]
        params0, perms = put_lstm_draws(draws, seed, dims, fits, cfg.epochs, dev)
        x = torch.from_numpy(X[None]).to(dev)
        t = torch.from_numpy(targets[None]).to(dev)
        names = _chain_leaves(dims)

        def run_chunk(start, e0, e1):
            p0, state = params0, None
            if start is not None:  # one machine's params per fit, its Adam state
                arrays, count = start
                leaves = [_put(arrays[f"params/{k}"], dev) for k in names]
                p0 = ([tuple(leaves[3 * i: 3 * i + 3]) for i in range(len(leaves) // 3)],
                      tuple(leaves[-2:]))
                state = AdamState(*([_put(arrays[f"{m}/{k}"], dev) for k in names] for m in ("mu", "nu")),
                                  np.array([[int(count)]]))
            with torch.no_grad():
                cells, head, history, state = lstm_fit(
                    x, t, fits, p0, [p[:, e0:e1] for p in perms], [0],
                    acts, out_act, self.lookback_window, self.offset, e1 - e0, hp,
                    state=state, return_state=True,
                )
            arrays = _named("params", names, [a for cell in cells for a in cell] + list(head))
            arrays.update(_named("mu", names, state.mu))
            arrays.update(_named("nu", names, state.nu))
            return arrays, int(state.count[0, 0]), history[0, 0].cpu().numpy()

        if resume is None:
            arrays, _, history = run_chunk(None, 0, cfg.epochs)
        else:
            arrays, _, history = resume(dims, run_chunk)
        leaves = [arrays[f"params/{k}"] for k in names]
        state = lstm_state([tuple(leaves[3 * i: 3 * i + 3]) for i in range(len(leaves) // 3)],
                           tuple(leaves[-2:]))
        module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        self.module_ = module.eval()
        self.history_ = history
        self.fit_seconds_ = time.time() - t0
        return self

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
