"""Helpers shared by the port's training parity tests.

:func:`jax_draws` draws initial params and epoch permutations exactly as
the JAX package does for a seed (``parallel/fleet.py`` ``fleet_keys`` /
``fleet_init``; ``train/fit.py`` ``make_fit_fn``): the init key and the
fit key are the two halves of ``PRNGKey(seed)``; epoch ``e`` shuffles with
``jax.random.permutation(split(fit_key, epochs)[e], n_total)``.  It has
the signature of ``gordo_tpu_torch.parallel.fleet.fleet_draws``, so the
port trains from the JAX package's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gordo_tpu.models.factories.feedforward import FeedForwardAutoEncoder
from gordo_tpu_torch import convert


def jax_draws(seed, dims, n_totals, epochs):
    module = FeedForwardAutoEncoder(
        dims=tuple(dims[1:-1]),
        funcs=("tanh",) * (len(dims) - 2),
        out_dim=dims[-1],
        compute_dtype=jnp.float32,
    )
    init_key, fit_key = jax.random.split(jax.random.PRNGKey(seed))
    params = module.init(init_key, jnp.zeros((1, dims[0]), jnp.float32))["params"]
    keys = jax.random.split(fit_key, epochs)
    perms = {
        int(n): np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])
        for n in set(n_totals)
    }
    return convert.flax_to_layers(jax.tree.map(np.asarray, params)), perms


def r12(ref, got) -> float:
    """The repo's parity metric: ``max|ref - got| / max|ref|``."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def port_params(estimator):
    """A port AutoEncoder's fitted params as the flax tree (numpy)."""
    return convert.layers_to_flax([
        (lin.weight.detach().numpy().T, lin.bias.detach().numpy())
        for lin, _ in estimator.module_.layers()
    ])


def sine_rows(rng, n, tags, phase=0.0):
    t = np.arange(n)[:, None]
    X = np.sin(0.05 * t * (1 + np.arange(tags)) + phase)
    return (X + 0.1 * rng.standard_normal((n, tags))).astype(np.float32)


def carry(jax_model):
    """The port's model for a fitted JAX detector or pipeline (feedforward
    or LSTM), through ``gordo_tpu_torch.convert.from_reference``."""
    from gordo_tpu import serializer as jax_serializer

    detector = hasattr(jax_model, "base_estimator")
    pipe = jax_model.base_estimator if detector else jax_model
    host = lambda stats: {k: np.asarray(v) for k, v in stats.items()}  # noqa: E731
    kw = {}
    if detector:
        kw = dict(
            detector_stats=host(jax_model.scaler.stats_),
            feature_thresholds=jax_model.feature_thresholds_,
            aggregate_threshold=jax_model.aggregate_threshold_,
        )
    return convert.from_reference(
        jax_serializer.into_definition(jax_model),
        jax.tree.map(np.asarray, pipe._final.params_),
        scaler_stats=[host(step.stats_) for _, step in pipe.steps[:-1]],
        **kw,
    )


def init_estimator(estimator, n_features, rng, seed=0):
    """A JAX estimator given ``module.init`` params (biases and kernels
    nudged by seeded numpy noise, so no bias is zero) instead of a fit:
    a JAX LSTM fit of a shape the suite has not compiled before can crash
    XLA late in the suite (``tests/lstm_detectors.py``)."""
    from gordo_tpu.registry import lookup_factory

    kw = dict(n_features=n_features, n_features_out=n_features,
              **{k: v for k, v in estimator.kwargs.items() if k != "seed"})
    estimator.module_ = lookup_factory(estimator.model_type, estimator.kind)(**kw)
    estimator._factory_kwargs_built = kw
    lookback = getattr(estimator, "lookback_window", None)
    shape = (1, n_features) if lookback is None else (1, lookback, n_features)
    params = estimator.module_.init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))["params"]
    estimator.params_ = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    return estimator


def init_detector(estimator, X, rng, window=None, seed=0):
    """``DiffBasedAnomalyDetector(Pipeline[MinMaxScaler, estimator])`` of
    the JAX package with init params, scalers fitted on ``X`` (a
    reduction, no model fit) and thresholds from ``rng``."""
    from gordo_tpu.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_tpu.ops.scalers import MinMaxScaler
    from gordo_tpu.pipeline import Pipeline

    tags = X.shape[1]
    init_estimator(estimator, tags, rng, seed)
    scaler = MinMaxScaler()
    scaler.fit(X)
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([scaler, estimator]), window=window)
    det.scaler.fit(X)
    det.feature_thresholds_ = rng.uniform(0.05, 0.5, tags).astype(np.float32)
    det.aggregate_threshold_ = float(rng.uniform(0.2, 1.0))
    return det
