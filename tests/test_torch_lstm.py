"""The port's LSTM module and ``lstm_layer`` against the JAX package.

Seeded numpy inputs and ``module.init`` params (no JAX LSTM fit) go
through ``gordo_tpu/models/factories/lstm.py`` and its counterpart in the
port.  Tolerance: ``max|ref - port| / max|ref|`` (``r12``) <= 1e-5 in
float32 (measured on the CPU: at most 3.0e-7 for one layer, 2.4e-7 for a
first layer fed rows, 4.0e-7 for the whole six-layer module).  On CPU tensors the ``lstm_layer`` wrapper runs its
plain version, so the two are equal bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.models.factories.lstm import _fused_lstm_layer
from gordo_tpu.ops.windows import make_windows as jax_make_windows
from gordo_tpu.registry import lookup_factory as jax_factory
from gordo_tpu_torch import convert
from gordo_tpu_torch.kernels import lstm_layer as ll
from gordo_tpu_torch.models.estimator import LSTMAutoEncoder, LSTMForecast
from gordo_tpu_torch.ops.windows import make_windows, num_windows
from gordo_tpu_torch.registry import lookup_factory, resolve_alias
from torch_parity import init_estimator, r12

TOL = 1e-5


@pytest.mark.parametrize("kind,tags,kwargs", [
    ("lstm_hourglass", 50, {}),
    ("lstm_hourglass", 10, {"compression_factor": 0.3, "encoding_layers": 2}),
    ("lstm_symmetric", 7, {"dims": (6, 3), "funcs": ["tanh", "relu"]}),
    ("lstm_model", 5, {"encoding_dim": (8,), "decoding_dim": (4, 6), "out_func": "tanh"}),
])
def test_factory_widths_and_param_count_match_jax(kind, tags, kwargs):
    port = lookup_factory("LSTMAutoEncoder", kind)(n_features=tags, lookback_window=12, **kwargs)
    ref = jax_factory("LSTMAutoEncoder", kind)(n_features=tags, lookback_window=12, **kwargs)
    assert port.dims == tuple(ref.dims)
    assert port.funcs == tuple(ref.funcs)
    assert port.out_func == ref.out_func
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.zeros((1, 12, tags)))["params"]
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == n_ref
    if kind == "lstm_hourglass" and tags == 50:
        # BASELINE config 2 at the bench width (bench.py:49-51)
        assert port.dims == (42, 33, 25, 25, 33, 42)
        assert n_ref == 59_362


def _jax_lstm(tags, lookback, rng):
    est = init_estimator(JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=lookback), tags, rng)
    return est.module_, jax.tree.map(np.asarray, est.params_)


def test_convert_round_trips_the_flax_tree():
    rng = np.random.default_rng(0)
    _, params = _jax_lstm(5, 4, rng)
    cells, head = convert.flax_to_lstm_layers(params)
    # hourglass widths at 5 tags: 4, 3, 2, 2, 3, 4
    assert [c[0].shape for c in cells] == [(5, 16), (4, 12), (3, 8), (2, 8), (2, 12), (3, 16)]
    assert [c[1].shape for c in cells] == [(4, 16), (3, 12), (2, 8), (2, 8), (3, 12), (4, 16)]
    # gate blocks i, f, g, o side by side, as _FusedLSTMCellParams has them
    cell = params["OptimizedLSTMCell_1"]
    np.testing.assert_array_equal(cells[1][0][:, 6:9], cell["ig"]["kernel"])
    np.testing.assert_array_equal(cells[1][2][9:], cell["ho"]["bias"])
    back = convert.lstm_layers_to_flax(cells, head)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # stacked along a machine axis, as a bucket holds them
    stacked = jax.tree.map(lambda *a: np.stack(a), params, _jax_lstm(5, 4, rng)[1])
    s_cells, s_head = convert.flax_to_lstm_layers(stacked)
    assert s_cells[0][0].shape == (2, 5, 16) and s_head[0].shape == (2, 4, 5)
    np.testing.assert_array_equal(s_cells[2][1][0], cells[2][1])
    back = convert.lstm_layers_to_flax(s_cells, s_head)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(a, b)
    # and into the port module by name
    module = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(n_features=5)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            convert.flax_lstm_to_state_arrays(params).items()})
    np.testing.assert_array_equal(module.out.weight.detach().numpy(), params["out"]["kernel"].T)


@pytest.mark.parametrize("n_in,hidden,lookback", [(6, 5, 7), (3, 2, 1), (50, 42, 12)])
def test_lstm_layer_plain_matches_fused_lstm_layer(n_in, hidden, lookback):
    rng = np.random.default_rng(n_in)
    x = rng.standard_normal((9, lookback, n_in)).astype(np.float32)
    ki = (rng.standard_normal((n_in, 4 * hidden)) / np.sqrt(n_in)).astype(np.float32)
    kh = (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32)
    b = (0.1 * rng.standard_normal(4 * hidden)).astype(np.float32)
    ref = np.asarray(_fused_lstm_layer(jnp.asarray(x), jnp.asarray(ki), jnp.asarray(kh),
                                       jnp.asarray(b), hidden, jnp.float32))
    t = lambda a: torch.from_numpy(a)[None]  # noqa: E731  a bucket of one machine
    got = ll.lstm_layer_plain(t(x), t(ki), t(kh), t(b), lookback=lookback)[0].numpy()
    assert got.shape == ref.shape == (9, lookback, hidden)
    assert r12(ref, got) <= TOL
    last = ll.lstm_layer_plain(t(x), t(ki), t(kh), t(b), lookback=lookback, act="tanh", last=True)
    assert r12(np.tanh(ref[:, -1]), last[0].numpy()) <= TOL


@pytest.mark.parametrize("tags", [3, 10])
@pytest.mark.parametrize("lookback", [1, 6])
def test_module_matches_jax_apply(tags, lookback):
    rng = np.random.default_rng(tags * 10 + lookback)
    module, params = _jax_lstm(tags, lookback, rng)
    windows = rng.standard_normal((20, lookback, tags)).astype(np.float32)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(windows)))
    port = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(n_features=tags, lookback_window=lookback)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          convert.flax_lstm_to_state_arrays(params).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(windows)).numpy()
        one = port(torch.from_numpy(windows[3])).numpy()
    assert got.shape == ref.shape == (20, tags)
    assert r12(ref, got) <= TOL
    assert r12(ref[3], one) <= TOL


@pytest.mark.parametrize("n,lookback", [(10, 1), (10, 4), (7, 7)])
def test_make_windows_matches_jax(n, lookback):
    X = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    ref = np.asarray(jax_make_windows(jnp.asarray(X), lookback))
    got = make_windows(torch.from_numpy(X), lookback).numpy()
    np.testing.assert_array_equal(got, ref)
    assert num_windows(n, lookback) == len(ref)
    # with leading (machine) axes too
    stacked = make_windows(torch.from_numpy(np.stack([X, -X])), lookback).numpy()
    np.testing.assert_array_equal(stacked[1], -ref)
    with pytest.raises(ValueError, match="at least lookback"):
        make_windows(torch.from_numpy(X), n + 1)


def test_first_layer_windows_and_scales_the_rows():
    """Rows in (m, n, in), MinMax and the forecast's one-fewer windows:
    the same as scaling, windowing ``Xs[:-1]`` and the JAX layer."""
    rng = np.random.default_rng(3)
    m, n, n_in, hidden, lookback = 2, 15, 4, 3, 5
    X = rng.standard_normal((m, n, n_in)).astype(np.float32)
    scale = rng.uniform(0.5, 2, (m, n_in)).astype(np.float32)
    offset = rng.uniform(-1, 1, (m, n_in)).astype(np.float32)
    ki = rng.standard_normal((m, n_in, 4 * hidden)).astype(np.float32)
    kh = rng.standard_normal((m, hidden, 4 * hidden)).astype(np.float32)
    b = rng.standard_normal((m, 4 * hidden)).astype(np.float32)
    t = torch.from_numpy
    got = ll.lstm_layer_plain(t(X), t(ki), t(kh), t(b), lookback=lookback, act="tanh",
                              n_windows=n - lookback, scale=t(scale), offset=t(offset)).numpy()
    for j in range(m):
        Xs = X[j] * scale[j] + offset[j]
        wins = jax_make_windows(jnp.asarray(Xs[:-1]), lookback)
        ref = np.tanh(np.asarray(_fused_lstm_layer(wins, ki[j], kh[j], b[j], hidden, jnp.float32)))
        assert got[j].shape == ref.shape == (n - lookback, lookback, hidden)
        assert r12(ref, got[j]) <= TOL


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    rng = np.random.default_rng(4)
    M, n, n_in, hidden, lookback = 3, 11, 4, 5, 3
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    X = t(rng.standard_normal((2, n, n_in)))
    ki, kh, b = (t(rng.standard_normal(s)) for s in
                 ((M, n_in, 4 * hidden), (M, hidden, 4 * hidden), (M, 4 * hidden)))
    scale, offset = t(rng.uniform(0.5, 2, (M, n_in))), t(rng.uniform(-1, 1, (M, n_in)))
    before = ll.launches
    for kw in (
        dict(idx=[2, 0], scale=scale, offset=offset, slot_windows=[9, 4]),
        dict(idx=[1, 1], last=True, act="tanh", n_windows=n - lookback),
    ):
        got = ll.lstm_layer(X, ki, kh, b, lookback=lookback, **kw)
        kw.pop("slot_windows", None)
        ref = ll.lstm_layer_plain(X, ki, kh, b, lookback=lookback, **kw)
        assert torch.equal(got, ref)
    # a later layer's input: (m, nw, lookback, in)
    h = t(rng.standard_normal((3, 6, lookback, n_in)))
    assert torch.equal(ll.lstm_layer(h, ki, kh, b, lookback=lookback, act="tanh"),
                       ll.lstm_layer_plain(h, ki, kh, b, lookback=lookback, act="tanh"))
    assert ll.launches == before  # the CPU never launches the kernel


def test_launch_plan_fits_the_bench_widths_and_refuses_wide_layers():
    # the 50 -> 42 layer of BASELINE config 2: weights ~65 KB, and up to
    # MAX_THREADS threads (12 groups of 42 units, 48 windows a block)
    plan = ll.launch_plan(50, 42, 4085)
    assert plan.groups * 42 <= ll.MAX_THREADS and plan.groups == 12
    assert plan.in_pad == 52 and plan.h_pad == 44
    assert plan.smem_bytes <= ll.SMEM_LIMIT
    assert ll.launch_plan(3, 2, 1).groups == 1  # no more groups than windows
    with pytest.raises(ValueError, match="wide LSTM layers"):
        ll.launch_plan(256, 128, 100)


def test_estimators_window_offsets_and_refuse_to_fit():
    ae = LSTMAutoEncoder(lookback_window=6)
    forecast = LSTMForecast(kind="lstm_symmetric", lookback_window=6, dims=[4])
    assert (ae.offset, forecast.offset) == (5, 6)
    assert LSTMAutoEncoder().offset == 0
    assert resolve_alias("gordo_components.model.models.KerasLSTMForecast").endswith("LSTMForecast")
    assert resolve_alias("gordo_tpu.models.estimator.KerasLSTMAutoEncoder").endswith("LSTMAutoEncoder")
    with pytest.raises(NotImplementedError, match="LSTM training"):
        ae.fit(np.zeros((20, 3), np.float32), device="cpu")
    assert ae.get_params() == {"kind": "lstm_hourglass", "lookback_window": 6}
