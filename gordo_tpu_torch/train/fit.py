"""Model fitting (counterpart of ``gordo_tpu/train/fit.py``).

The JAX package runs a whole fit (every epoch, every minibatch, the
per-epoch shuffle) as one XLA program.  The port runs it as one launch of
the hand-written ``fleet_fit`` kernel (``gordo_tpu_torch/kernels/
fleet_fit.py``), over a whole fleet of machines and fits at once.  This
module holds what both the kernel and its plain version follow:

- :class:`TrainConfig` and :func:`batch_geometry`, as in the JAX package;
- :func:`mse_loss`: padded rows weighted 0, normalised by the batch's
  ``max(sum(w), 1)`` (``make_loss_fn``);
- :func:`adam_update`: ``optax.adam``'s op order;
- :func:`fit_plain`: the multi-epoch fit step for step as
  ``make_epoch_fn`` / ``make_fit_fn``, over a stack of machines.

The initial params and the per-epoch permutations are inputs: the JAX
package draws them from threefry keys, and the tests hand the port the
same draws.  Other losses and optimizers raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS

_ITEM = (
    "ROADMAP queue 1 item 2 (training: the other losses and optimizers; "
    "the port trains mse with adam)"
)
#: optax.adam's defaults
ADAM_DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training config (same fields and defaults as the JAX package's)."""

    epochs: int = 10
    batch_size: int = 256
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    loss: str = "mse"
    shuffle: bool = True
    optimizer_kwargs: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def from_kwargs(cls, kwargs: Dict[str, Any]) -> Tuple["TrainConfig", Dict[str, Any]]:
        """Split estimator kwargs into (train config, factory kwargs)."""
        known = {f.name for f in dataclasses.fields(cls)}
        cfg_kwargs = {}
        rest = {}
        for k, v in kwargs.items():
            if k in known:
                cfg_kwargs[k] = v
            elif k == "optimizer_kwargs" or k == "compile_kwargs":
                cfg_kwargs["optimizer_kwargs"] = tuple(sorted(dict(v).items()))
            else:
                rest[k] = v
        if "optimizer_kwargs" in cfg_kwargs and not isinstance(
            cfg_kwargs["optimizer_kwargs"], tuple
        ):
            cfg_kwargs["optimizer_kwargs"] = tuple(
                sorted(dict(cfg_kwargs["optimizer_kwargs"]).items())
            )
        return cls(**cfg_kwargs), rest


def adam_hparams(cfg: TrainConfig) -> Dict[str, float]:
    """``lr``, ``b1``, ``b2``, ``eps`` of the config's Adam.

    Raises ``NotImplementedError`` for a loss, optimizer, option or
    ``shuffle=False`` the port does not train."""
    if cfg.loss not in ("mse", "mean_squared_error"):
        raise NotImplementedError(f"loss={cfg.loss!r} waits for {_ITEM}")
    if cfg.optimizer.lower() != "adam":
        raise NotImplementedError(f"optimizer={cfg.optimizer!r} waits for {_ITEM}")
    if not cfg.shuffle:
        raise NotImplementedError(f"shuffle=False waits for {_ITEM}")
    kwargs = dict(cfg.optimizer_kwargs)
    lr = kwargs.pop("learning_rate", cfg.learning_rate)
    unknown = sorted(set(kwargs) - set(ADAM_DEFAULTS))
    if unknown:
        raise NotImplementedError(f"adam options {unknown} wait for {_ITEM}")
    return {"lr": float(lr), **ADAM_DEFAULTS, **{k: float(v) for k, v in kwargs.items()}}


def batch_geometry(n: int, batch_size: int) -> Tuple[int, int, int]:
    """``(steps, bs, n_pad)`` for ``n`` rows, as in the JAX package."""
    bs = int(min(batch_size, n))
    steps = -(-n // bs)
    return steps, bs, steps * bs - n


def mse_loss(pred: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-machine weighted mse: ``pred``/``y`` (M, rows, F), ``w`` (M, rows)
    → (M,), each machine's batch normalised by its ``max(sum(w), 1)``."""
    per_row = torch.mean((pred - y) ** 2, dim=-1)
    return torch.sum(per_row * w, dim=-1) / torch.clamp_min(torch.sum(w, dim=-1), 1.0)


def _bias_correction(decay: float, count: int) -> float:
    # optax computes ``1 - decay**count`` in float32
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adam_update(param, grad, mu, nu, count: int, hp: Dict[str, float]):
    """One ``optax.adam`` step on one leaf; ``count`` is the step number
    after the increment (1 on the first step).  Returns
    ``(param, mu, nu)``."""
    b1, b2 = hp["b1"], hp["b2"]
    mu = (1 - b1) * grad + b1 * mu
    nu = (1 - b2) * (grad * grad) + b2 * nu
    mu_hat = mu / _bias_correction(b1, count)
    nu_hat = nu / _bias_correction(b2, count)
    update = mu_hat / (torch.sqrt(nu_hat) + hp["eps"])
    return param + (-hp["lr"]) * update, mu, nu


def forward(layers: Layers, acts: Sequence[Optional[str]], x: torch.Tensor) -> torch.Tensor:
    """Stacked dense chain: ``x`` (M, rows, F) through ``layers``
    ``[(W (M, in, out), b (M, out)), ...]``."""
    h = x
    for (W, b), act in zip(layers, acts):
        h = ACTIVATIONS[act](torch.bmm(h, W) + b[:, None, :])
    return h


def fit_plain(
    layers: Layers,
    acts: Sequence[Optional[str]],
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    perms: torch.Tensor,
    hp: Dict[str, float],
    steps: int,
    bs: int,
) -> Tuple[Layers, torch.Tensor]:
    """The multi-epoch fit of M machines at once, step for step as
    ``make_fit_fn``.

    ``X`` (M, n_total, F) and ``y`` (M, n_total, Fo) are padded to
    ``steps * bs`` rows, ``w`` (n_total,) weighs the padding 0,
    ``perms`` (M, epochs, n_total) are each epoch's row permutations.
    Returns the fitted layers and the (M, epochs) loss history."""
    M = X.shape[0]
    params = [t.detach().clone() for pair in layers for t in pair]
    mus = [torch.zeros_like(p) for p in params]
    nus = [torch.zeros_like(p) for p in params]
    w = w.expand(M, -1)
    history = []
    count = 0
    for e in range(perms.shape[1]):
        perm = perms[:, e].long()
        xb = torch.gather(X, 1, perm[..., None].expand(-1, -1, X.shape[2]))
        yb = torch.gather(y, 1, perm[..., None].expand(-1, -1, y.shape[2]))
        wb = torch.gather(w, 1, perm)
        losses = []
        for s in range(steps):
            rows = slice(s * bs, (s + 1) * bs)
            leaves = [p.requires_grad_(True) for p in params]
            pairs = [(leaves[2 * i], leaves[2 * i + 1]) for i in range(len(leaves) // 2)]
            with torch.enable_grad():
                loss = mse_loss(forward(pairs, acts, xb[:, rows]), yb[:, rows], wb[:, rows])
                grads = torch.autograd.grad(loss.sum(), leaves)
            count += 1
            with torch.no_grad():
                for i, (p, g) in enumerate(zip(leaves, grads)):
                    params[i], mus[i], nus[i] = adam_update(
                        p.detach(), g, mus[i], nus[i], count, hp
                    )
            losses.append(loss.detach() * torch.sum(wb[:, rows], dim=-1))
        history.append(
            torch.sum(torch.stack(losses, dim=-1), dim=-1)
            / torch.clamp_min(torch.sum(w, dim=-1), 1.0)
        )
    fitted = [(params[2 * i], params[2 * i + 1]) for i in range(len(params) // 2)]
    return fitted, torch.stack(history, dim=-1)
