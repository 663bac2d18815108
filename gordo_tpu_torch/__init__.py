"""PyTorch/CUDA port of ``gordo_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package imports ``torch``,
``numpy`` and the standard library only, never ``jax`` or ``gordo_tpu``.
Its device compute runs in kernels written by hand for ``sm_90a``
(``gordo_tpu_torch/csrc``), each with a plain-PyTorch twin that the CPU
tests hold to the JAX package.

Ported so far, for the reference default detector
(``DiffBasedAnomalyDetector(Pipeline[MinMaxScaler, AutoEncoder(
feedforward_hourglass)])``): serving, scored by the fused ``fleet_score``
kernel; and the exact-mode fleet build (and the single-machine
``cross_validate``/``fit``), trained by ``fleet_fit`` with stats from
``scaler_stats`` and thresholds from ``cv_epilogue``.  Serving of LSTM
detectors (``LSTMAutoEncoder``, ``LSTMForecast``) through ``lstm_layer``
and ``fleet_score``, and of detectors with a smoothing ``window`` through
``rolling_median``.  Pipeline and detector scalers may be MinMax,
Standard or Robust, chained: their stats come from ``scaler_stats`` and
``scaler_quantiles``.  Pipelines with ``SimpleImputer``, ``PCA``,
``QuantileTransformer`` or ``FunctionTransformer`` steps build through
the single-machine path and serve one machine at a time, their steps
applied by ``chain_apply``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
