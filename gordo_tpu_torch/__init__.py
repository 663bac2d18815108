"""PyTorch/CUDA port of ``gordo_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package imports ``torch``,
``numpy`` and the standard library only, never ``jax`` or ``gordo_tpu``.
Its device compute runs in kernels written by hand for ``sm_90a``
(``gordo_tpu_torch/csrc``), each with a plain-PyTorch twin that the CPU
tests hold to the JAX package.

Ported so far: the serving path of the reference default detector
(``DiffBasedAnomalyDetector(Pipeline[MinMaxScaler, AutoEncoder(
feedforward_hourglass)])``), scored by the fused ``fleet_score`` kernel.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
