"""The port's scaler statistics (K3) against the JAX package's.

``scaler_stats``' Standard statistic and ``scaler_quantiles``' Robust one
(their plain versions: the CPU has no card) against
``StandardScaler.compute_stats`` and ``RobustScaler.compute_stats`` of
``gordo_tpu/ops/scalers.py``, vmapped per machine as the fleet programs
run them, on 3 machines × 180 rows × 6 tags over two row lists (a fold's
prefix and the full series), with NaN rows, an all-NaN column, a constant
column of 2.0, every option and ``quantile_range`` (10, 90); then chains
of two and three steps against ``_make_scale_chain``, and the fitted
scalers' ``fit`` and ``transform``.  Bound, per output array,
``max|ref - port| / max|ref|`` over its non-NaN entries, NaN where the
reference has NaN: 1e-6 (measured <= 2.2e-7 on the stats, <= 3.6e-7 on a
chain step's output: the sums round in another order than XLA's, and
XLA:CPU may fuse the interpolation's ``v[l] * lw + v[h] * hw`` into one
rounding, as it fuses other multiply-adds).

A constant column that no float32 sum reproduces (0.1 over 180 rows) is
ill-conditioned on both sides: each package's mean is off the constant by
about an ulp, on either side of it (0.09999998 in the reference,
0.10000002 in the port's plain version), and each std is that ulp's
residue (2.2e-8), so the scaled constant differs in sign.  The test holds
the mean to 1e-6 (measured 4.8e-7) and each std below 1e-6 of the mean
(ROADMAP queue 3 records the divergence and its cause).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops import scalers as jscalers
from gordo_tpu.parallel.anomaly import _make_scale_chain
from gordo_tpu_torch.kernels import scaler_quantiles as sq
from gordo_tpu_torch.kernels import scaler_stats as ss
from gordo_tpu_torch.ops import scalers as pscalers
from gordo_tpu_torch.parallel.anomaly import _stats, analyze_definition
from gordo_tpu_torch.serializer import from_definition
from torch_parity import sine_rows

STATS_TOL = 1e-6
MACHINES, ROWS, TAGS = 3, 180, 6
ROW_LISTS = [np.arange(60), np.arange(ROWS)]


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(5)
    X = np.stack([sine_rows(rng, ROWS, TAGS, phase=i) for i in range(MACHINES)])
    X[0, :7, 1] = np.nan          # NaN rows inside the fold's prefix
    X[1, 150:, :] = np.nan        # pad-up padding past a machine's length
    X[2, :, 2] = np.nan           # an all-NaN column
    X[:, :, 3] = 2.0              # a constant column every sum keeps exact
    return X


def r12_nan(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got)), "NaN where the reference has NaN"
    if nan.all():
        return 0.0
    return float(np.abs(ref[~nan] - got[~nan]).max() / max(np.abs(ref[~nan]).max(), 1e-30))


def jax_stats(cls, X, rows, **opts):
    return jax.vmap(lambda xm: cls.compute_stats(jnp.asarray(xm[rows]), **opts))(X)


CASES = [
    ("standard", {}),
    ("standard", {"with_mean": False}),
    ("standard", {"with_std": False}),
    ("robust", {}),
    ("robust", {"with_centering": False}),
    ("robust", {"with_scaling": False}),
    ("robust", {"quantile_range": (10.0, 90.0)}),
]


@pytest.mark.parametrize("stat,opts", CASES, ids=[f"{s}-{sorted(o)}" for s, o in CASES])
def test_plain_stats_match_jax(X, stat, opts):
    x = torch.from_numpy(X)
    if stat == "standard":
        got = ss.scaler_stats(x, ROW_LISTS, stat="standard", **opts)
        cls, keys = jscalers.StandardScaler, ("mean", "std")
    else:
        got = sq.scaler_quantiles(x, ROW_LISTS, **opts)
        cls, keys = jscalers.RobustScaler, ("center", "scale")
    for g, rows in enumerate(ROW_LISTS):
        ref = jax_stats(cls, X, rows, **opts)
        for key, leaf in zip(keys, got):
            assert r12_nan(ref[key], leaf[:, g]) <= STATS_TOL, (key, g)
    # the all-NaN column is NaN in both leaves unless an option fixes it
    centred = opts.get("with_mean", True) and opts.get("with_centering", True)
    assert bool(torch.isnan(got[0][2, :, 2]).all()) == centred


def test_constant_column_is_ill_conditioned_on_both_sides():
    X = np.full((1, ROWS, 2), 0.1, np.float32)
    X[0, :, 1] = np.linspace(-1, 1, ROWS)
    ref = jax_stats(jscalers.StandardScaler, X, np.arange(ROWS))
    mean, std = ss.scaler_stats(torch.from_numpy(X), [np.arange(ROWS)], stat="standard")
    assert r12_nan(ref["mean"], mean[:, 0]) <= STATS_TOL
    ref_std, port_std = float(ref["std"][0, 0]), float(std[0, 0, 0])
    # both stds are rounding residue, far below the column's mean
    assert 0.0 < ref_std < 1e-6 * 0.1 and 0.0 < port_std < 1e-6 * 0.1, (ref_std, port_std)
    # the informative column holds the bound
    assert r12_nan(ref["std"][:, 1], std[:, 0, 1]) <= STATS_TOL


def test_robust_kernel_refuses_long_series_and_prefix_past_its_capacity():
    long = torch.zeros((1, sq.MAX_ROWS + 1, 1))
    with pytest.raises(NotImplementedError, match="queue 1 item 20"):
        sq.scaler_quantiles(long, [np.arange(sq.MAX_ROWS + 1)])
    x = torch.zeros((1, 8, 1))
    one = torch.ones((1, 1, 1))
    with pytest.raises(NotImplementedError, match="at most 4 earlier steps"):
        ss.scaler_stats(x, [np.arange(8)], prefix=[(ss.AFFINE, one, one)] * 5)
    with pytest.raises(ValueError, match="prefix step's stats"):
        sq.scaler_quantiles(x, [np.arange(8)], prefix=[(ss.CENTER, torch.ones(1, 2, 1), one)])


# -- chains: each step's stats on the previous step's output --------------------

CHAINS = {
    "standard-minmax": [("StandardScaler", {}), ("MinMaxScaler", {"feature_range": (0.0, 1.0)})],
    "minmax_reversed-robust": [("MinMaxScaler", {"feature_range": (1.0, -1.0)}),
                               ("RobustScaler", {"quantile_range": (25.0, 75.0)})],
    "robust-standard-minmax": [("RobustScaler", {"quantile_range": (10.0, 90.0), "with_centering": False}),
                               ("StandardScaler", {"with_std": True}),
                               ("MinMaxScaler", {"feature_range": (-1.0, 1.0)})],
}


def chain_definition(chain):
    steps = [{f"gordo_tpu.ops.scalers.{name}": {k: list(v) if isinstance(v, tuple) else v
                                                 for k, v in opts.items()}}
             for name, opts in chain]
    steps.append({"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}})
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": steps}}}}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_stats_match_make_scale_chain(X, name):
    """The kernels' prefix, given the reference's own earlier steps' stats,
    against ``_make_scale_chain`` leaf by leaf; then the port's chain
    (``_stats``, each step on its own earlier steps) through what each
    step does: its output on the reference's input to it (a later step's
    leaves carry the earlier steps' rounding and can be rounding residue,
    ``tests/test_torch_scaler_build.py``)."""
    chain = CHAINS[name]
    opts = [(getattr(jscalers, cls), tuple(sorted(o.items()))) for cls, o in chain]
    spec = analyze_definition(from_definition(chain_definition(chain)))
    # without the constant column: a later step's stats of a constant are
    # ill-conditioned (test_constant_column_is_ill_conditioned_on_both_sides)
    X = np.ascontiguousarray(X[:, :, [0, 1, 2, 4, 5]])
    x = torch.from_numpy(X)
    steps = [(a, b) for _, a, b in _stats(spec, x, x, ROW_LISTS)[0]]
    for g, rows in enumerate(ROW_LISTS):
        ref_steps, _ = _make_scale_chain(opts)(jnp.asarray(X[:, rows]))
        prefix, Z = [], torch.from_numpy(X[:, rows])
        for i, (proto, ref) in enumerate(zip(spec.scaler_protos, ref_steps)):
            # the kernel's prefix on the reference's earlier stats
            got = proto.stats_of(x, ROW_LISTS, prefix=prefix)
            for key, leaf in zip(proto.STAT_KEYS, got):
                assert r12_nan(ref[key], leaf[:, g]) <= STATS_TOL, (i, key, g)
            both = [torch.from_numpy(np.stack([np.asarray(ref[k])] * len(ROW_LISTS), axis=1))
                    for k in proto.STAT_KEYS]
            want = ss.apply_prefix(Z, [(proto.FORM, *both)], g)
            have = ss.apply_prefix(Z, [(proto.FORM, *(t.contiguous() for t in steps[i]))], g)
            assert r12_nan(want, have) <= STATS_TOL, (i, "output", g)
            prefix.append((proto.FORM, *both))
            Z = want


def _fma_rounded_once(x, a, b):
    """``x * a + b`` of float32 tensors, exact in rationals, rounded once
    to the nearest float32 (ties to even): the reference for an FMA."""
    out = []
    for xv, av, bv in zip(*(t.reshape(-1).tolist() for t in (x, a, b))):
        exact = Fraction(xv) * Fraction(av) + Fraction(bv)
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        out.append(min(near, key=lambda c: (abs(Fraction(float(c)) - exact), int(np.float32(c).view(np.int32)) & 1)))
    return torch.from_numpy(np.array(out, np.float32).reshape(tuple(x.shape)))


def test_plain_fma_rounds_once():
    """A plain version's AFFINE step, an FMA (``apply_steps``), is ``x * a
    + b`` rounded once, as ``__fmaf_rn``: on a sum
    that float64 rounds onto a float32 midpoint (where a rounding through
    float64 would go to the other neighbour) and on random values of
    mixed scale."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)
    a = rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)
    b = rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)
    # exact 1 + 2^-23 + 2^-24 - 2^-70: float64 keeps the midpoint, whose tie
    # goes up to 1 + 2^-22; the value rounded once is 1 + 2^-23
    x[0], a[0], b[0] = 2.0 ** -12 * (1 + 2.0 ** -23), 2.0 ** -12 * (1 - 2.0 ** -23), 1 + 2.0 ** -23
    x, a, b = (torch.from_numpy(v.astype(np.float32)) for v in (x, a, b))
    got = ss.apply_steps(x, [(ss.AFFINE, a, b)])
    assert float(got[0]) == 1 + 2.0 ** -23
    assert torch.equal(got, _fma_rounded_once(x, a, b))


def test_fold_of_a_chain_is_its_steps_applied_in_turn(X):
    """The serving kernels' plain versions take a chain's steps, each in
    its own form, and apply them in turn as ``apply_prefix`` does, bit for
    bit: the pipeline's steps before the dense stack, the detector's step
    on the prediction and the target alike; a MinMax step is one FMA there,
    as XLA:CPU fuses the jitted scorer's ``x * scale + offset``."""
    from gordo_tpu_torch.kernels.fleet_score import fleet_score_plain

    chain = CHAINS["robust-standard-minmax"]
    spec = analyze_definition(from_definition(chain_definition(chain)))
    x = torch.from_numpy(np.ascontiguousarray(np.nan_to_num(X[:, :, [0, 1, 4, 5]])))
    steps, (det_form, *det_stats) = _stats(spec, x, x, ROW_LISTS)
    want = ss.apply_steps(x, steps, lambda t: t[:, 1, None, :])
    # the FMA rounds once: x * a + b exact, rounded to float32 once
    minmax = steps[-1]
    assert minmax[0] == ss.AFFINE
    before = ss.apply_prefix(x, steps[:-1], 1)
    once = _fma_rounded_once(*torch.broadcast_tensors(before, minmax[1][:, 1, None], minmax[2][:, 1, None]))
    assert torch.equal(want, once)
    F = int(x.shape[2])
    eye = [(torch.eye(F).expand(MACHINES, F, F).contiguous(), torch.zeros(MACHINES, F))]
    at_fit = [(form, a[:, 1].contiguous(), b[:, 1].contiguous()) for form, a, b in steps]
    det = (det_form,) + tuple(t[:, 0].contiguous() for t in det_stats)
    got = fleet_score_plain(x, eye, [None], chain=at_fit, det=det, y=x)
    assert torch.equal(got["model-output"], want)
    # the default detector scaler, a MinMax: one FMA on each side
    assert det_form == ss.AFFINE
    d = [(det_form,) + tuple(t for t in det_stats)]
    at = lambda t: t[:, 0, None, :]  # noqa: E731
    tag = (ss.apply_steps(want, d, at) - ss.apply_steps(x, d, at)).abs()
    assert torch.equal(got["tag-anomaly-scores"], tag)


@pytest.mark.parametrize("name,opts", [
    ("StandardScaler", {"with_mean": False}),
    ("RobustScaler", {"quantile_range": (10.0, 90.0)}),
    ("MinMaxScaler", {"feature_range": (-1.0, 1.0)}),
])
def test_fitted_scalers_match_jax(X, name, opts):
    data = np.nan_to_num(X[1, :150])
    ref = getattr(jscalers, name)(**opts).fit(data)
    got = getattr(pscalers, name)(**opts).fit(data, device="cpu")
    assert sorted(got.stats_) == sorted(ref.stats_)
    for key, leaf in ref.stats_.items():
        assert r12_nan(leaf, got.stats_[key]) <= STATS_TOL, key
    assert r12_nan(ref.transform(data), got.transform(data)) <= STATS_TOL
    assert r12_nan(data, type(got).invert(got.stats_, got.transform(data))) <= STATS_TOL
    assert got.get_params() == ref.get_params()


def test_ignored_sklearn_kwargs_warn_as_in_jax():
    with pytest.warns(UserWarning, match="ignoring unsupported sklearn kwargs"):
        pscalers.RobustScaler(unit_variance=True)
    with pytest.warns(UserWarning, match="copy"):
        pscalers.StandardScaler(copy=False)
