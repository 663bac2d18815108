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
