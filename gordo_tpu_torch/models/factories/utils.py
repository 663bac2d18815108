"""Factory helpers (copy of ``gordo_tpu/models/factories/utils.py``)."""

from __future__ import annotations

from typing import List


def hourglass_calc_dims(compression_factor: float, encoding_layers: int,
                        n_features: int) -> List[int]:
    """Layer sizes tapering linearly from ``n_features`` down to
    ``n_features * compression_factor`` over ``encoding_layers`` steps
    (evenly-sloped taper, smallest layer >= 1)."""
    if not (0 <= compression_factor <= 1):
        raise ValueError("compression_factor must be in [0, 1]")
    if encoding_layers < 1:
        raise ValueError("encoding_layers must be >= 1")
    smallest = max(min(round(n_features * compression_factor), n_features), 1)
    slope = (n_features - smallest) / encoding_layers
    dims = [round(n_features - i * slope) for i in range(1, encoding_layers + 1)]
    return [max(int(d), 1) for d in dims]
