"""The single-machine transforms of the port against the JAX package's.

``QuantileTransformer``, ``SimpleImputer``, ``PCA`` and
``FunctionTransformer`` (with each of ``ops/transformer_funcs.py``'s
funcs) of ``gordo_tpu_torch/ops/scalers.py`` against their namesakes in
``gordo_tpu/ops/scalers.py``, fitted on the same seeded rows; then the
kernels' plain versions (the CPU has no card): ``chain_apply_plain``
(K12) against the JAX package's step-by-step transforms,
``scaler_quantiles_grid_plain`` against ``jnp.nanpercentile`` and
``jnp.nanmedian`` over machines and row lists and through a chain prefix,
and at the edges its kernel's sort must meet (heavily tied keys, an
all-NaN column, one row, fewer rows than grid entries),
``scaler_stats_plain``'s means against ``jnp.mean`` and ``jnp.nanmean``.
The rows are quantised (a quarter or an eighth), so that the quantile
grids tie, and carry NaN cells; the rows transformed fall partly outside
the grid.

Bounds, ``max|ref - port| / max|ref|`` over the non-NaN values, NaN where
the reference has NaN, or in units in the last place (ulp):

- the grids, the medians and the imputers' fills: 0 (bit for bit: the
  grid's fractions are ``linspace(0, 100, Q) * (1 / 100)`` as XLA:CPU
  computes them, and its interpolation the fused multiply-add XLA:CPU
  makes of ``v[l] * lw + v[h] * hw``); the means 1e-6 (measured 0: they
  sum in XLA:CPU's tree order, ``scaler_stats.xla_sum``);
- uniform quantile outputs and ``multiplier``/``adder``: 0 (``jnp.interp``
  with XLA:CPU's fused ``fp[i-1] + (delta / dx) * df``);
- normal quantile outputs: 8 ulp (measured 5 over 20 seeded draws):
  ``_ndtri``'s central branch is bit for bit; its tails take two logs,
  XLA's against PyTorch's;
- ``log1p`` 4 ulp, ``expm1`` 8 ulp (measured 2 and 4): XLA's own
  approximations against PyTorch's (ROADMAP queue 3, as K11's log1p);
- PCA: the mean 1e-6 (measured 0), the components 1e-5 (measured
  2.9e-6: the two LAPACK calls' roundings, scaled by the gaps between
  singular values; the singular vectors' signs agree), the transformed
  rows 1e-5 (measured 2.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops import scalers as J
from gordo_tpu.ops import transformer_funcs as JF
from gordo_tpu_torch.kernels import chain_apply as ca
from gordo_tpu_torch.kernels import scaler_quantiles as sq
from gordo_tpu_torch.kernels import scaler_stats as ss
from gordo_tpu_torch.ops import scalers as P
from gordo_tpu_torch.ops import transformer_funcs as PF
from gordo_tpu_torch.registry import resolve_alias
from gordo_tpu_torch.serializer import from_definition, into_definition
from gordo_tpu_torch.serializer.definition import import_locate

MEAN_TOL = 1e-6
COMPONENTS_TOL = 1e-5
OUTPUT_TOL = 1e-5
NORMAL_ULP = 8
FUNC_ULP = {"log1p": 4, "expm1": 8, "multiplier": 0, "adder": 0}
ROWS, TAGS = 300, 6


def r12_nan(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got)), "NaN where the reference has NaN"
    if nan.all():
        return 0.0
    return float(np.abs(ref[~nan] - got[~nan]).max() / max(np.abs(ref[~nan]).max(), 1e-30))


def ulp_gap(ref, got) -> int:
    """The largest distance in float32 steps between finite values; the
    non-finite ones must be equal."""
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(np.isnan(ref), np.isnan(got))
    assert np.array_equal(ref[~fin & ~np.isnan(ref)], got[~fin & ~np.isnan(got)])
    if not fin.any():
        return 0

    def ordered(a):
        i = a[fin].view(np.int32).astype(np.int64)
        return np.where(i < 0, -(2 ** 31) - i, i)

    return int(np.abs(ordered(ref) - ordered(got)).max())


def same(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert np.array_equal(np.isnan(ref), np.isnan(got))
    assert np.array_equal(ref[~np.isnan(ref)], got[~np.isnan(got)])


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(12)
    X = (np.round(rng.standard_normal((ROWS, TAGS)) * 4) / 4).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    Y = (1.5 * rng.standard_normal((200, TAGS))).astype(np.float32)
    Y[::9, 2] = np.nan                        # sensor dropouts in the rows transformed
    Y[5] = np.nanmax(X, axis=0) + 1.0         # past the grid's top
    Y[6] = np.nanmin(X, axis=0) - 1.0         # below its bottom
    C = (rng.standard_normal((ROWS, TAGS)) @ rng.standard_normal((TAGS, TAGS))).astype(np.float32)
    return X, Y, C


@pytest.mark.parametrize("num", [1, 2, 7, 100, 101, 1000])
def test_linspaces_are_xla_s(num):
    assert np.array_equal(ca.unit_linspace(num), np.asarray(jnp.linspace(0.0, 1.0, num)))
    grid_fracs = np.asarray(jnp.linspace(0.0, 100.0, num)) * (np.float32(1) / np.float32(100))
    assert np.array_equal(ca.percentile_fractions(num), grid_fracs.astype(np.float32))


@pytest.mark.parametrize("n_quantiles", [100, 1000])
@pytest.mark.parametrize("distribution", ["uniform", "normal"])
def test_quantile_transformer(rows, n_quantiles, distribution):
    X, Y, _ = rows
    ref = J.QuantileTransformer(n_quantiles=n_quantiles, output_distribution=distribution).fit(X)
    got = P.QuantileTransformer(n_quantiles=n_quantiles, output_distribution=distribution).fit(X, device="cpu")
    assert got.stats_["grid"].shape == (n_quantiles, TAGS)
    same(ref.stats_["grid"], got.stats_["grid"])
    assert (np.diff(got.stats_["grid"], axis=0) == 0).any(), "the quantised rows' grid ties"
    want, out = np.asarray(ref.transform(Y)), got.transform(Y)
    if distribution == "uniform":
        same(want, out)
    else:
        assert ulp_gap(want, out) <= NORMAL_ULP
    # the tensor path is the host path
    assert np.array_equal(got.transform(torch.from_numpy(Y)).numpy(), out, equal_nan=True)


def test_quantile_transformer_nan_rows_follow_interp(rows):
    """A NaN row gives ``fp[Q-2]`` where the grid's last two entries tie
    (``jnp.interp``'s rule), NaN elsewhere, on both sides."""
    X, _, _ = rows
    X = X.copy()
    X[:200, 0] = 1.0                      # a column whose top grid entries tie
    nan_rows = np.full((3, TAGS), np.nan, np.float32)
    ref = J.QuantileTransformer(n_quantiles=50).fit(X)
    got = P.QuantileTransformer(n_quantiles=50).fit(X, device="cpu")
    want, out = np.asarray(ref.transform(nan_rows)), got.transform(nan_rows)
    same(want, out)


def test_quantile_inverse_waits_for_item_2(rows):
    """The inverse no longer waits: QuantileTransformer's inverse runs as
    a ``chain_apply`` step (QUANTILE_INV), bit for bit the JAX package's
    ``jnp.interp`` on a uniform output (``test_torch_containers.py`` holds
    the normal output's)."""
    X, Y, _ = rows
    ref = J.QuantileTransformer(n_quantiles=10).fit(X)
    got = P.QuantileTransformer(n_quantiles=10).fit(X, device="cpu")
    U = np.asarray(ref.transform(Y))
    same(np.asarray(ref.inverse_transform(U)), got.inverse_transform(U))


@pytest.mark.parametrize("strategy", ["mean", "median", "constant"])
def test_simple_imputer(rows, strategy):
    X, Y, _ = rows
    ref = J.SimpleImputer(strategy=strategy, fill_value=1.5).fit(X)
    got = P.SimpleImputer(strategy=strategy, fill_value=1.5).fit(X, device="cpu")
    if strategy == "mean":
        assert r12_nan(ref.stats_["fill"], got.stats_["fill"]) <= MEAN_TOL
    else:
        same(ref.stats_["fill"], got.stats_["fill"])
    out = got.transform(Y)
    assert not np.isnan(out).any()
    assert r12_nan(np.asarray(ref.transform(Y)), out) <= MEAN_TOL
    assert np.array_equal(got.inverse_transform(Y), Y, equal_nan=True)


def test_imputer_strategy_is_checked(rows):
    with pytest.raises(ValueError, match="Unknown imputer strategy"):
        P.SimpleImputer(strategy="mode").fit(rows[0], device="cpu")


@pytest.mark.parametrize("n_components", [3, None])
def test_pca(rows, n_components):
    _, _, C = rows
    ref = J.PCA(n_components=n_components).fit(C)
    got = P.PCA(n_components=n_components).fit(C, device="cpu")
    k = n_components or TAGS
    assert got.stats_["components"].shape == (k, TAGS)
    assert r12_nan(ref.stats_["mean"], got.stats_["mean"]) <= MEAN_TOL
    assert r12_nan(ref.stats_["components"], got.stats_["components"]) <= COMPONENTS_TOL
    out = got.transform(C)
    assert out.shape == (ROWS, k)
    assert r12_nan(np.asarray(ref.transform(C)), out) <= OUTPUT_TOL
    assert r12_nan(np.asarray(ref.inverse_transform(np.asarray(ref.transform(C)))),
                   got.inverse_transform(out)) <= OUTPUT_TOL


def test_pca_nan_mean_is_nan(rows):
    """``jnp.mean`` keeps a NaN column's NaN, and the components follow."""
    _, _, C = rows
    C = C.copy()
    C[4, 1] = np.nan
    ref = J.PCA(n_components=2).fit(C)
    got = P.PCA(n_components=2).fit(C, device="cpu")
    assert np.isnan(ref.stats_["mean"][1]) and np.isnan(got.stats_["mean"][1])
    assert r12_nan(ref.stats_["mean"], got.stats_["mean"]) <= MEAN_TOL
    assert np.isnan(ref.stats_["components"]).all() and np.isnan(got.stats_["components"]).all()


@pytest.mark.parametrize("name, kw", [
    ("multiplier", {"factor": 2.7}), ("adder", {"addend": 0.3}), ("log1p", {}), ("expm1", {}),
])
def test_transformer_funcs(rows, name, kw):
    _, _, C = rows
    Z = np.abs(C) if name == "log1p" else C / 3
    want = np.asarray(getattr(JF, name)(Z, **kw))
    assert ulp_gap(want, getattr(PF, name)(Z, **kw)) <= FUNC_ULP[name]
    ref = J.FunctionTransformer(func=getattr(JF, name), kw_args=kw).fit(Z)
    got = P.FunctionTransformer(func=getattr(PF, name), kw_args=kw).fit(Z, device="cpu")
    assert ulp_gap(np.asarray(ref.transform(Z)), got.transform(Z)) <= FUNC_ULP[name]
    assert got.stats_ == {} and got.state_arrays() == {}


def test_function_transformer_round_trips_its_func_paths():
    definition = {"sklearn.preprocessing.FunctionTransformer": {
        "func": "gordo_components.model.transformer_funcs.general.multiplier",
        "inverse_func": "gordo_tpu.ops.transformer_funcs.adder",
        "kw_args": {"factor": 2}, "inv_kw_args": {"addend": -1.0},
    }}
    step = from_definition(definition)
    assert step.func is PF.multiplier and step.inverse_func is PF.adder
    params = into_definition(step)["gordo_tpu_torch.ops.scalers.FunctionTransformer"]
    assert params["func"] == "gordo_tpu_torch.ops.transformer_funcs.multiplier"
    assert params["inverse_func"] == "gordo_tpu_torch.ops.transformer_funcs.adder"
    again = from_definition(into_definition(step))
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(again.transform(X), X * 2)
    np.testing.assert_array_equal(again.inverse_transform(X), X - 1)


def test_unported_func_waits_for_item_2():
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        P.FunctionTransformer(func=np.log)
    with pytest.raises(TypeError, match="unexpected keyword"):
        P.FunctionTransformer(func=PF.multiplier, kw_args={"scale": 2})


@pytest.mark.parametrize("path, name", [
    ("sklearn.preprocessing.QuantileTransformer", "QuantileTransformer"),
    ("sklearn.impute.SimpleImputer", "SimpleImputer"),
    ("sklearn.decomposition.PCA", "PCA"),
    ("sklearn.preprocessing.FunctionTransformer", "FunctionTransformer"),
    ("gordo_tpu.ops.scalers.PCA", "PCA"),
    ("gordo_tpu.ops.transformer_funcs.expm1", "expm1"),
    ("gordo_components.model.transformer_funcs.general.multiplier", "multiplier"),
])
def test_registry_aliases(path, name):
    assert resolve_alias(path).startswith("gordo_tpu_torch.ops.")
    assert resolve_alias(path).endswith("." + name)


@pytest.mark.parametrize("container", [
    "gordo_tpu.pipeline.FeatureUnion", "sklearn.compose.TransformedTargetRegressor",
    "sklearn.multioutput.MultiOutputRegressor",
])
def test_containers_stay_unported(container):
    """The containers are ported now: each path resolves to the port's
    class of the same name."""
    path = resolve_alias(container)
    assert path == "gordo_tpu_torch.pipeline." + container.rsplit(".", 1)[1]
    assert import_locate(container).__module__ == "gordo_tpu_torch.pipeline"


def _jax_chain(X, steps):
    for step in steps:
        X = np.asarray(step.transform(X))
    return X


def test_chain_apply_plain_is_the_reference_chain(rows):
    """Chain A's transform steps fitted by the JAX package, applied by the
    port's plain K12 in one call, against the JAX package's step by step."""
    X, Y, _ = rows
    fit_rows = np.nan_to_num(X, nan=0.5)
    jsteps, psteps, Z = [], [], fit_rows
    for js in (J.SimpleImputer(strategy="median"), J.FunctionTransformer(func=JF.multiplier, kw_args={"factor": 2}),
               J.PCA(n_components=4), J.MinMaxScaler()):
        js.fit(Z)
        Z = np.asarray(js.transform(Z))
        jsteps.append(js)
    for js in jsteps:
        name = type(js).__name__
        if name == "SimpleImputer":
            psteps.append(ca.impute_step(js.stats_["fill"], "cpu"))
        elif name == "FunctionTransformer":
            psteps.append(ca.func_step(ca.MUL, 2))
        elif name == "PCA":
            psteps.append(ca.pca_step(js.stats_["mean"], js.stats_["components"], "cpu"))
        else:
            psteps.append(ca.affine_step(js.stats_["scale"], js.stats_["offset"], "cpu"))
    got = ca.chain_apply(torch.from_numpy(Y), psteps).numpy()
    assert got.shape == (len(Y), 4)
    assert r12_nan(_jax_chain(Y, jsteps), got) <= OUTPUT_TOL


@pytest.mark.parametrize("form", ["center", "expm1_log1p"])
def test_chain_apply_plain_elementwise_forms(rows, form):
    _, _, C = rows
    C = C / 4
    mean, std = np.nanmean(C, 0).astype(np.float32), (np.nanstd(C, 0) + 0.5).astype(np.float32)
    if form == "center":
        steps = [ca.center_step(mean, std, "cpu")]
        want = np.asarray((jnp.asarray(C) - mean) / std)
        same(want, ca.chain_apply(torch.from_numpy(C), steps).numpy())
    else:
        steps = [ca.func_step(ca.EXPM1), ca.func_step(ca.ADD, 1.0), ca.func_step(ca.LOG1P)]
        want = np.asarray(jnp.log1p(jnp.expm1(jnp.asarray(C)) + 1.0))
        assert ulp_gap(want, ca.chain_apply(torch.from_numpy(C), steps).numpy()) <= FUNC_ULP["expm1"]


def test_chain_apply_checks_its_steps():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="components"):
        ca.chain_apply(x, [ca.Step(ca.PCA, torch.zeros(3), torch.zeros((4, 3)))])
    with pytest.raises(ValueError, match="grid"):
        ca.chain_apply(x, [ca.Step(ca.QUANTILE, torch.zeros((5, 2)), torch.zeros(5))])


@pytest.mark.parametrize("midpoint", [False, True])
def test_grid_statistic_against_nanpercentile(rows, midpoint):
    """``scaler_quantiles_grid_plain`` over 2 machines and 2 row lists
    against ``jnp.nanpercentile`` / ``jnp.nanmedian`` of the same rows."""
    X, _, _ = rows
    Xm = np.stack([X, X[::-1] * 0.5])
    lists = [np.arange(120), np.arange(ROWS)]
    if midpoint:
        q = torch.tensor([0.5])
        ref_fn = lambda a: jnp.nanmedian(a, axis=0)[None]  # noqa: E731
    else:
        q = torch.from_numpy(ca.percentile_fractions(100))
        ref_fn = lambda a: jnp.nanpercentile(a, jnp.linspace(0.0, 100.0, 100), axis=0)  # noqa: E731
    got = sq.scaler_quantiles_grid(torch.from_numpy(Xm), lists, q, midpoint=midpoint).numpy()
    assert got.shape == (2, 2, len(q), TAGS)
    for m in range(2):
        for g, r in enumerate(lists):
            same(np.asarray(ref_fn(jnp.asarray(Xm[m][r]))), got[m, g])


def _edge_rows(case: str) -> np.ndarray:
    """Rows for the grid's edges: heavily tied keys (two values and NaN),
    an all-NaN column, one row, and fewer rows than the grid has entries."""
    rng = np.random.default_rng(23)
    n = {"tied": 90, "all_nan_column": 60, "one_row": 1, "q_over_rows": 17}[case]
    X = (np.round(rng.standard_normal((n, TAGS)) * 4) / 4).astype(np.float32)
    if case == "tied":
        X = np.where(X > 0, np.float32(1.5), np.float32(-0.25))
        X[::7, 1] = np.nan
    if case == "all_nan_column":
        X[:, 2] = np.nan
    return X


@pytest.mark.parametrize("midpoint", [False, True])
@pytest.mark.parametrize("case", ["tied", "all_nan_column", "one_row", "q_over_rows"])
def test_grid_statistic_at_the_sorts_edges(case, midpoint):
    """The edges the grid kernel's sort must meet (the card holds the
    kernel to these plain outputs bit for bit): its plain version against
    ``jnp.nanpercentile`` at Q 100 / ``jnp.nanmedian``, bit for bit."""
    X = _edge_rows(case)
    if midpoint:
        q = torch.tensor([0.5])
        ref = jnp.nanmedian(jnp.asarray(X), axis=0)[None]
    else:
        q = torch.from_numpy(ca.percentile_fractions(100))
        ref = jnp.nanpercentile(jnp.asarray(X), jnp.linspace(0.0, 100.0, 100), axis=0)
    got = sq.scaler_quantiles_grid(torch.from_numpy(X[None]), [np.arange(len(X))], q, midpoint=midpoint)
    assert got.shape == (1, 1, len(q), TAGS)
    same(np.asarray(ref), got[0, 0].numpy())
    if case == "all_nan_column":
        assert bool(torch.isnan(got[0, 0, :, 2]).all())


def test_grid_statistic_refuses_long_series():
    with pytest.raises(NotImplementedError, match="item 20"):
        sq.scaler_quantiles_grid(torch.zeros((1, sq.MAX_ROWS + 1, 1)), [np.arange(sq.MAX_ROWS + 1)],
                                 torch.tensor([0.5]))


def test_mean_statistics_row_limit():
    """``MEAN_MAX_ROWS`` is the longest row list whose two levels of
    window sums fit the kernel's ``SS_MEAN_SMEM``; one row more is refused
    naming item 20 before any launch, on the CPU as on the card."""
    import re
    from pathlib import Path

    csrc = Path(ss.__file__).parent.parent / "csrc"
    src = (csrc / "scaler_stats.cu").read_text()
    smem = eval(re.search(r"#define SS_MEAN_SMEM \(([^)]*)\)", src).group(1))  # noqa: S307 (a constant)
    window = int(re.search(r"#define XO_WINDOW (\d+)", (csrc / "xla_order.cuh").read_text()).group(1))
    assert window == ss.XLA_WINDOW

    def floats(n):
        level1 = -(-n // window)
        return level1 + -(-level1 // window)

    assert floats(ss.MEAN_MAX_ROWS) * 4 <= smem < floats(ss.MEAN_MAX_ROWS + 1) * 4
    n = ss.MEAN_MAX_ROWS
    x = torch.ones((1, n + 1, 1))
    mean, count = ss.scaler_stats(x[:, :n].contiguous(), [np.arange(n)], stat="mean")
    assert float(mean) == 1.0 and float(count) == n
    for stat in ("mean", "nanmean"):
        with pytest.raises(NotImplementedError, match="item 20"):
            ss.scaler_stats(x, [np.arange(n + 1)], stat=stat)


@pytest.mark.parametrize("stat", ["mean", "nanmean"])
def test_mean_statistics(rows, stat):
    X, _, C = rows
    Xm = np.stack([C, np.where(np.isnan(X), np.nan, C)])
    lists = [np.arange(100), np.arange(ROWS)]
    got = ss.scaler_stats(torch.from_numpy(Xm), lists, stat=stat)
    fn = jnp.mean if stat == "mean" else jnp.nanmean
    for m in range(2):
        for g, r in enumerate(lists):
            assert r12_nan(np.asarray(fn(jnp.asarray(Xm[m][r]), axis=0)), got[0][m, g].numpy()) <= MEAN_TOL
    with pytest.raises(ValueError, match="no chain prefix"):
        ss.scaler_stats(torch.from_numpy(Xm), lists, stat=stat,
                        prefix=[(ss.AFFINE, torch.ones((2, 2, TAGS)), torch.zeros((2, 2, TAGS)))])
