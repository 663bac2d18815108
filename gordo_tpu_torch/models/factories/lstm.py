"""LSTM autoencoder/forecast factories as ``nn.Module``s.

Counterpart of ``gordo_tpu/models/factories/lstm.py``.  Each layer is a
child ``OptimizedLSTMCell_{i}`` holding flax's ``_FusedLSTMCellParams``
(lstm.py:63-90): ``kernel_i`` (in, 4H), ``kernel_h`` (H, 4H) and ``bias``
(4H), gate blocks concatenated in the order i, f, g, o; the head is the
``out`` ``nn.Linear`` on the last layer's final step.  The forward pass is
the chain of ``lstm_layer_plain`` calls (``gordo_tpu_torch/kernels/
lstm_layer.py``) and the head; serving runs the same chain through the
``lstm_layer`` and ``fleet_score`` kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from gordo_tpu_torch.device import resolve_compute_dtype
from gordo_tpu_torch.models.factories.feedforward import _broadcast_funcs, resolve_activation
from gordo_tpu_torch.models.factories.utils import hourglass_calc_dims
from gordo_tpu_torch.registry import register_model_builder


class OptimizedLSTMCell(nn.Module):
    """One layer's parameters under flax's names (never applied directly)."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.hidden = int(hidden)
        self.kernel_i = nn.Parameter(torch.empty(int(n_in), 4 * self.hidden))
        self.kernel_h = nn.Parameter(torch.empty(self.hidden, 4 * self.hidden))
        self.bias = nn.Parameter(torch.empty(4 * self.hidden))


def cell_names(n_layers: int) -> List[str]:
    return [f"OptimizedLSTMCell_{i}" for i in range(n_layers)]


class LSTMAutoEncoderModule(nn.Module):
    """Stacked LSTM layers over the window, final-step dense head.

    Parameters are created uninitialised: a served model's weights always
    come from its artifact.
    """

    def __init__(
        self,
        n_features: int,
        dims: Sequence[int],
        funcs: Sequence[Optional[str]],
        out_dim: int,
        out_func: Optional[str] = "linear",
    ):
        super().__init__()
        for f in list(funcs) + [out_func]:
            resolve_activation(f)
        self.dims = tuple(int(d) for d in dims)
        self.funcs = tuple(funcs)
        self.out_func = out_func
        widths = (int(n_features),) + self.dims
        for i, name in enumerate(cell_names(len(self.dims))):
            self.add_module(name, OptimizedLSTMCell(widths[i], widths[i + 1]))
        self.out = nn.utils.skip_init(nn.Linear, widths[-1], int(out_dim))

    def cells(self) -> List[Tuple[OptimizedLSTMCell, Optional[str]]]:
        """``[(cell, activation name), ...]`` in application order."""
        return [(getattr(self, n), f) for n, f in zip(cell_names(len(self.dims)), self.funcs)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (batch, lookback, n_features) windows → (batch, out_dim)."""
        from gordo_tpu_torch.kernels.lstm_layer import lstm_layer_plain

        squeeze = x.dim() == 2
        h = (x[None] if squeeze else x)[None]  # a bucket of one machine
        cells = self.cells()
        for i, (cell, f) in enumerate(cells):
            h = lstm_layer_plain(
                h, cell.kernel_i[None], cell.kernel_h[None], cell.bias[None],
                lookback=h.shape[2], act=f, last=i == len(cells) - 1,
            )
        out = resolve_activation(self.out_func)(self.out(h[0]))
        return out[0] if squeeze else out


@register_model_builder(type="LSTMAutoEncoder")
def lstm_model(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 1,
    encoding_dim: Sequence[int] = (256, 128, 64),
    encoding_func: Sequence[str] = None,
    decoding_dim: Sequence[int] = (64, 128, 256),
    decoding_func: Sequence[str] = None,
    out_func: str = "linear",
    compute_dtype: str = "auto",
    **_ignored,
) -> nn.Module:
    """Encoder/decoder LSTM stack (reference: ``lstm_autoencoder.lstm_model``).

    ``lookback_window`` is the estimator's (windowing); the module takes
    any window length."""
    resolve_compute_dtype(compute_dtype)
    n_features_out = n_features_out or n_features
    enc = tuple(int(d) for d in encoding_dim)
    dec = tuple(int(d) for d in decoding_dim)
    funcs = _broadcast_funcs(encoding_func, len(enc)) + _broadcast_funcs(
        decoding_func, len(dec)
    )
    return LSTMAutoEncoderModule(
        n_features=int(n_features),
        dims=enc + dec,
        funcs=funcs,
        out_dim=int(n_features_out),
        out_func=out_func,
    )


@register_model_builder(type="LSTMAutoEncoder")
def lstm_symmetric(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 1,
    dims: Sequence[int] = (256, 128, 64),
    funcs: Sequence[str] = None,
    **kwargs,
) -> nn.Module:
    """Symmetric LSTM AE (reference: ``lstm_symmetric``)."""
    if not dims:
        raise ValueError("dims must be non-empty")
    dims = tuple(int(d) for d in dims)
    funcs = _broadcast_funcs(funcs, len(dims))
    return lstm_model(
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        encoding_dim=dims,
        encoding_func=funcs,
        decoding_dim=dims[::-1],
        decoding_func=funcs[::-1],
        **kwargs,
    )


@register_model_builder(type="LSTMAutoEncoder")
def lstm_hourglass(
    n_features: int,
    n_features_out: int = None,
    lookback_window: int = 1,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    **kwargs,
) -> nn.Module:
    """Tapered LSTM AE (reference: ``lstm_autoencoder.lstm_hourglass``)."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return lstm_symmetric(
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        dims=dims,
        funcs=[func] * len(dims),
        **kwargs,
    )
