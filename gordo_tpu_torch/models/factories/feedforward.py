"""Feedforward autoencoder factories as ``nn.Module``s.

Counterpart of ``gordo_tpu/models/factories/feedforward.py``.  Children are
named as the flax module's (``dense_{i}``, ``out``) so a flax param tree
maps onto the state dict by name; they are ``nn.Linear`` layers, whose
weight is the transpose of flax's ``(in, out)`` kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from gordo_tpu_torch.device import resolve_compute_dtype
from gordo_tpu_torch.models.factories.utils import hourglass_calc_dims
from gordo_tpu_torch.registry import register_model_builder

# flax's constants for selu (jax.nn.selu)
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _selu(x: torch.Tensor) -> torch.Tensor:
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus = logaddexp(x, 0); torch's softplus switches to the
    # identity above a threshold instead
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


#: every activation of the reference's table, with flax semantics: gelu is
#: the tanh approximation (flax's default), leaky_relu has slope 0.01,
#: elu has alpha 1
ACTIVATIONS: Dict[Optional[str], Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "selu": _selu,
    "softplus": _softplus,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "linear": _identity,
    None: _identity,
}


def resolve_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return ACTIVATIONS[name]
    except (KeyError, TypeError):
        raise ValueError(
            f"Unknown activation {name!r}; available: "
            f"{sorted(k for k in ACTIVATIONS if isinstance(k, str))}"
        )


def layer_names(n_layers: int) -> List[str]:
    """The children's names (the flax module's) in application order."""
    return [f"dense_{i}" for i in range(n_layers - 1)] + ["out"]


def _broadcast_funcs(funcs, n: int) -> Tuple:
    if funcs is None:
        funcs = "tanh"
    if isinstance(funcs, str):
        return tuple([funcs] * n)
    funcs = tuple(funcs)
    if len(funcs) != n:
        raise ValueError(f"Got {len(funcs)} activation funcs for {n} layers")
    return funcs


class FeedForwardAutoEncoder(nn.Module):
    """Dense stack: encoder dims -> decoder dims -> output head.

    Parameters are created uninitialised: a served model's weights always
    come from its artifact, so nothing is drawn here.
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
        for i, d in enumerate(self.dims):
            self.add_module(
                f"dense_{i}",
                nn.utils.skip_init(nn.Linear, widths[i], d),
            )
        self.out = nn.utils.skip_init(nn.Linear, widths[-1], int(out_dim))

    def layers(self) -> List[Tuple[nn.Linear, Optional[str]]]:
        """``[(linear, activation name), ...]`` in application order."""
        hidden = [
            (getattr(self, f"dense_{i}"), f) for i, f in enumerate(self.funcs)
        ]
        return hidden + [(self.out, self.out_func)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for linear, f in self.layers():
            x = resolve_activation(f)(linear(x))
        return x


@register_model_builder(type="AutoEncoder")
def feedforward_model(
    n_features: int,
    n_features_out: int = None,
    encoding_dim: Sequence[int] = (256, 128, 64),
    encoding_func: Sequence[str] = None,
    decoding_dim: Sequence[int] = (64, 128, 256),
    decoding_func: Sequence[str] = None,
    out_func: str = "linear",
    compute_dtype: str = "auto",
    **_ignored,
) -> nn.Module:
    """Fully parameterised encoder/decoder AE."""
    resolve_compute_dtype(compute_dtype)
    n_features_out = n_features_out or n_features
    enc = tuple(int(d) for d in encoding_dim)
    dec = tuple(int(d) for d in decoding_dim)
    funcs = _broadcast_funcs(encoding_func, len(enc)) + _broadcast_funcs(
        decoding_func, len(dec)
    )
    return FeedForwardAutoEncoder(
        n_features=int(n_features),
        dims=enc + dec,
        funcs=funcs,
        out_dim=int(n_features_out),
        out_func=out_func,
    )


@register_model_builder(type="AutoEncoder")
def feedforward_symmetric(
    n_features: int,
    n_features_out: int = None,
    dims: Sequence[int] = (256, 128, 64),
    funcs: Sequence[str] = None,
    **kwargs,
) -> nn.Module:
    """Symmetric AE: encoder ``dims``, decoder reversed."""
    if not dims:
        raise ValueError("dims must be non-empty")
    dims = tuple(int(d) for d in dims)
    funcs = _broadcast_funcs(funcs, len(dims))
    return feedforward_model(
        n_features,
        n_features_out,
        encoding_dim=dims,
        encoding_func=funcs,
        decoding_dim=dims[::-1],
        decoding_func=funcs[::-1],
        **kwargs,
    )


@register_model_builder(type="AutoEncoder")
def feedforward_hourglass(
    n_features: int,
    n_features_out: int = None,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    **kwargs,
) -> nn.Module:
    """Linearly tapered hourglass AE, the reference's default model."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return feedforward_symmetric(
        n_features, n_features_out, dims=dims, funcs=[func] * len(dims), **kwargs
    )
