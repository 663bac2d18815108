"""Sliding windows over rows (counterpart of ``gordo_tpu/ops/windows.py``).

The plain versions of the LSTM kernels build their windows with
:func:`make_windows`; the ``lstm_layer`` kernel never materialises them:
its first layer reads window ``b``, step ``t`` from row ``b + t`` as it
loads (``gordo_tpu_torch/csrc/lstm_layer.cu``).
"""

from __future__ import annotations

import torch


def num_windows(n_rows: int, lookback: int) -> int:
    return max(n_rows - lookback + 1, 0)


def make_windows(X: torch.Tensor, lookback: int) -> torch.Tensor:
    """``(..., N, F)`` → ``(..., N - lookback + 1, lookback, F)``
    overlapping windows, as a copy."""
    n = X.shape[-2]
    if n < lookback:
        raise ValueError(f"Need at least lookback={lookback} rows, got {n}")
    return X.unfold(-2, lookback, 1).transpose(-1, -2).contiguous()
