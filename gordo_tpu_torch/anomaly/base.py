"""Anomaly-detector contract (counterpart of ``gordo_tpu/anomaly/base.py``).

The JAX contract returns a DataFrame; the port has none and returns the
anomaly series as a dict of arrays, the shape the server responds with.
"""

from __future__ import annotations

import abc
from typing import Dict

import numpy as np


class AnomalyDetectorBase(abc.ABC):
    @abc.abstractmethod
    def anomaly(self, X, y=None, device=None) -> Dict[str, np.ndarray]:
        """Score ``X`` (optionally against targets ``y``) into the anomaly
        series: model-output, tag-anomaly-scores, total-anomaly-score
        (+ thresholds and anomaly-confidence)."""
