"""Regression metrics (counterpart of ``gordo_tpu/ops/metrics.py``).

sklearn semantics with ``multioutput='uniform_average'``, variances with
ddof=0 and the JAX package's ``_EPS`` floor on denominators.  Each takes
``(n, F)`` (or ``(n,)``) arrays or tensors, or batches ``(..., n, F)``,
and returns one value per leading index, in float32.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _targets(y_true, y_pred):
    y_true = torch.as_tensor(y_true, dtype=torch.float32)
    y_pred = torch.as_tensor(y_pred, dtype=torch.float32, device=y_true.device)
    if y_true.dim() == 1:
        y_true = y_true[:, None]
    if y_pred.dim() == 1:
        y_pred = y_pred[:, None]
    return y_true, y_pred


def _var(a: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - torch.mean(a, dim=-2, keepdim=True)) ** 2, dim=-2)


def _floor(den: torch.Tensor) -> torch.Tensor:
    # jnp.maximum keeps a NaN
    return torch.maximum(den, torch.tensor(_EPS, dtype=den.dtype, device=den.device))


def explained_variance_score(y_true, y_pred) -> torch.Tensor:
    y_true, y_pred = _targets(y_true, y_pred)
    diff = y_true - y_pred
    num = _var(diff - torch.mean(diff, dim=-2, keepdim=True))
    den = _var(y_true - torch.mean(y_true, dim=-2, keepdim=True))
    return torch.mean(1.0 - num / _floor(den), dim=-1)


def r2_score(y_true, y_pred) -> torch.Tensor:
    y_true, y_pred = _targets(y_true, y_pred)
    ss_res = torch.sum((y_true - y_pred) ** 2, dim=-2)
    ss_tot = torch.sum((y_true - torch.mean(y_true, dim=-2, keepdim=True)) ** 2, dim=-2)
    return torch.mean(1.0 - ss_res / _floor(ss_tot), dim=-1)


def mean_squared_error(y_true, y_pred) -> torch.Tensor:
    y_true, y_pred = _targets(y_true, y_pred)
    return torch.mean((y_true - y_pred) ** 2, dim=(-2, -1))


def mean_absolute_error(y_true, y_pred) -> torch.Tensor:
    y_true, y_pred = _targets(y_true, y_pred)
    return torch.mean(torch.abs(y_true - y_pred), dim=(-2, -1))


METRICS = {
    "explained_variance_score": explained_variance_score,
    "r2_score": r2_score,
    "mean_squared_error": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
}
