"""The CV epilogue's sums in XLA:CPU's window order, against the JAX
package's metrics.

``fleet.exact`` scores each fold with ``jax.vmap`` of
``gordo_tpu/ops/metrics.py``'s functions inside its jitted program.
XLA:CPU reduces a column of more than 32 rows in windows of 32 (the
tree-reduction rewrite), and a mean is that sum times ``1 / n``; on
targets at a level of 1e4 another order moves the sums of squares of
the level, and with them r2 and explained variance (measured 3.2e-5 and
5.9e-5 on a fold before ``cv_epilogue_plain`` took this order).  Held
here at a level of 1e4, on folds of 40, 144 and 1,000 rows (one fold's
``jnp.mean(y, axis=0)``, jitted and vmapped over slots, as the program
takes it):

- the per-column means, bit for bit (``cv_epilogue.column_mean``);
- explained variance, mse and mae, bit for bit (``fold_metrics``: the
  variances centred again as ``jnp.var`` does, mse and mae in the
  two-dimensional window order);
- r2 within 2 ulp: XLA fuses the last mean over the columns with the
  per-column scores and vectorises its sum, whose order the port does
  not follow (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops import metrics as jmetrics
from gordo_tpu_torch.kernels import cv_epilogue as ce

SLOTS = 12
LEVEL = np.float32(1e4)
SHAPES = [(40, 4), (144, 10), (1000, 3)]


def fold(n, fo, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    y = np.sin(0.05 * t * (1 + np.arange(fo))) + 0.1 * rng.standard_normal((SLOTS, n, fo)) + LEVEL
    pred = 0.5 + 0.2 * rng.standard_normal((SLOTS, n, fo))
    return y.astype(np.float32), pred.astype(np.float32)


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("n,fo", SHAPES)
def test_column_means_are_jax_s(n, fo):
    y, _ = fold(n, fo, n)
    want = np.asarray(jax.jit(jax.vmap(lambda a: jnp.mean(a, axis=0)))(y))
    got = ce.column_mean(torch.from_numpy(y), n, masked=False)
    assert want.tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("n,fo", SHAPES)
def test_fold_metrics_match_jax(n, fo):
    y, pred = fold(n, fo, n + 1)
    got = ce.fold_metrics(torch.from_numpy(y), torch.from_numpy(pred), n, masked=False)
    for name in ce.METRIC_NAMES:
        want = np.asarray(jax.jit(jax.vmap(jmetrics.METRICS[name]))(y, pred))
        if name == "r2_score":
            assert ulps(want, got[name]) <= 2, name
        else:
            assert want.tobytes() == got[name].numpy().tobytes(), name


def test_epilogue_plain_takes_the_window_order():
    """``cv_epilogue_plain``'s scores are ``fold_metrics``' on each slot's
    rows (K4) and over the padded fold (K8), and at a level of 1e4 the
    sums of squares of an in-order sum would differ."""
    n, fo = 144, 10
    y, pred = fold(n, fo, 3)
    tag = np.abs(pred - y).astype(np.float32)
    total = np.sqrt((tag ** 2).sum(-1)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (tag, total, pred, y)]
    counts = np.array([n] * (SLOTS - 3) + [100, 37, 0])
    for masked in (False, True):
        out = ce.cv_epilogue_plain(*args, counts, masked=masked)
        for s, k in enumerate(counts[:-1]):
            L = n if masked else k
            want = ce.fold_metrics(args[3][s:s + 1, :L], args[2][s:s + 1, :L], int(k), masked)
            for name in ce.METRIC_NAMES:
                assert float(out[name][s]) == float(want[name][0]), (masked, s, name)
    torch_r2 = 1 - ((args[3] - args[2]) ** 2).sum(1) / ((args[3] - args[3].mean(1, keepdim=True)) ** 2).sum(1)
    assert not torch.equal(torch_r2.mean(1), ce.fold_metrics(args[3], args[2], n, False)["r2_score"])
