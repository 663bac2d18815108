"""A MinMax step rounds as the JAX package's jitted programs round it.

Every XLA program that applies a MinMax step (``MinMaxScaler.apply``,
``X * scale + offset``) emits the product and the sum in one loop fusion,
and XLA:CPU contracts them into one FMA: the stats of a later chain step
in ``fleet.exact`` and ``fleet.padded``, the fits' scaled rows, the LSTM
fleet build's windows and the LSTM served by ``serve.score`` (their
optimised HLO holds each MinMax product and sum in one fusion; the
machine code of the LSTM build's is a ``vfmadd``).  The port's plain
chain step (``scaler_stats.apply_steps``) and its kernels'
(``csrc/scaler_prefix.cuh``) take it as one FMA.  Here each path's shape
of the computation, jitted, against the plain step, bit for bit, on rows
at a level of 1e4 against a spread of about 1 (where the two roundings of
a product and a sum move a MinMax output by up to ~2e-4 of its [0, 1]
range): per machine (the fleet programs' vmap), on gathered fold rows,
and under the windows' gather (the LSTM's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops.scalers import MinMaxScaler
from gordo_tpu.ops.windows import make_windows as jax_make_windows
from gordo_tpu_torch.kernels import scaler_stats as ss
from gordo_tpu_torch.ops.windows import make_windows
from torch_parity import sine_rows

MACHINES, ROWS, TAGS, LOOKBACK = 3, 200, 5, 6


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(41)
    X = np.stack([sine_rows(rng, ROWS, TAGS, phase=0.3 * i) for i in range(MACHINES)]) + np.float32(1e4)
    stats = [MinMaxScaler.compute_stats(jnp.asarray(x)) for x in X]
    scale = np.stack([np.asarray(s["scale"]) for s in stats])
    offset = np.stack([np.asarray(s["offset"]) for s in stats])
    take = np.sort(rng.permutation(ROWS)[:150])
    return X, scale, offset, take


def _port(X, scale, offset):
    """The plain chain step on (M, n, F) rows, its stats (M, F)."""
    step = [(ss.AFFINE, torch.from_numpy(scale), torch.from_numpy(offset))]
    return ss.apply_steps(torch.from_numpy(X), step, lambda t: t[:, None, :])


def _apply(stats, x):
    return MinMaxScaler.apply(stats, x)


@pytest.mark.parametrize("path", ["per_machine", "fold_rows", "windows"])
def test_minmax_step_rounds_as_the_jitted_reference(rows, path):
    X, scale, offset, take = rows
    stats = {"scale": jnp.asarray(scale), "offset": jnp.asarray(offset)}
    if path == "per_machine":      # a later step's stats, the fits' rows
        want = jax.jit(jax.vmap(_apply))(stats, X)
        got = _port(X, scale, offset)
    elif path == "fold_rows":      # a fold's rows, gathered, then scaled
        want = jax.jit(jax.vmap(lambda s, x: _apply(s, jnp.take(x, take, axis=0))))(stats, X)
        got = _port(np.ascontiguousarray(X[:, take]), scale, offset)
    else:                          # the LSTM's windows of the scaled rows
        want = jax.jit(jax.vmap(lambda s, x: jax_make_windows(_apply(s, x), LOOKBACK)))(stats, X)
        got = torch.stack([make_windows(m, LOOKBACK) for m in _port(X, scale, offset)])
    want = np.asarray(want)
    assert want.shape == tuple(got.shape)
    assert want.tobytes() == got.numpy().tobytes()
    # the level makes the roundings tell: a product and a sum rounded
    # apart differ from the reference somewhere
    twice = (torch.from_numpy(X) * torch.from_numpy(scale)[:, None] + torch.from_numpy(offset)[:, None]).numpy()
    once = _port(X, scale, offset).numpy()
    assert once.tobytes() != twice.tobytes()
