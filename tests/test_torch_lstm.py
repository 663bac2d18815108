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
from gordo_tpu_torch.kernels import lstm_layer_bwd as lb
from gordo_tpu_torch.models.estimator import LSTMAutoEncoder, LSTMForecast
from gordo_tpu_torch.ops.windows import make_windows, num_windows
from gordo_tpu_torch.registry import lookup_factory, resolve_alias
from gordo_tpu_torch.kernels.scaler_stats import AFFINE
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
                              n_windows=n - lookback, chain=[(AFFINE, t(scale), t(offset))]).numpy()
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
        dict(idx=[2, 0], chain=[(AFFINE, scale, offset)], slot_windows=[9, 4]),
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
    # the 50 -> 42 layer of BASELINE config 2 served over 64 machines x 4085
    # windows: eight windows a thread, up to HOIST_GROUPS groups of 42 units
    # sharing one copy of the weights, its input product hoisted out of the
    # steps (xp of the tile's rows), enough blocks to fill the card, within
    # a block's threads (__launch_bounds__: 128 registers a thread) and
    # shared memory
    plan = ll.launch_plan(50, 42, 4085, slots=64, lookback=12)
    assert (plan.wpt, plan.hoist) == (ll.WIDE_WPT, True)
    assert 1 < plan.groups <= ll.HOIST_GROUPS and plan.groups * 42 <= ll.MAX_THREADS
    assert 64 * -(-4085 // plan.tile) >= ll.MIN_BLOCKS
    assert plan.tile_pad >= plan.tile and plan.rows_pad >= plan.tile + 11
    assert plan.smem_bytes <= ll.SMEM_LIMIT
    # the later layers, x_t in the loop
    dims = [50, 42, 33, 25, 25, 33, 42]
    for n_in, h in zip(dims[1:-1], dims[2:]):
        later = ll.launch_plan(n_in, h, 4085, slots=64)
        assert not later.hoist and later.groups <= ll.MAX_GROUPS and later.groups * h <= ll.MAX_THREADS
        assert later.smem_bytes <= ll.SMEM_LIMIT
    # the stream's launch, one machine of 144 windows: two windows a
    # thread, one group, 72 blocks, where the parent's plan (12 groups of
    # four windows) launched 3
    stream = ll.launch_plan(50, 42, 144, slots=1, lookback=12)
    assert (stream.wpt, stream.groups) == (ll.NARROW_WPT, 1) and -(-144 // stream.tile) == 72
    # a lockstep step's minibatches, 256 slots x 64 windows: two even tiles
    # a slot
    train = ll.launch_plan(50, 42, 64, slots=256)
    assert train.tile == 32 and not train.hoist
    # the widest layers the parent took still fit: a square layer of 83
    # units, the first layer of a 92-tag hourglass (without the hoist)
    assert ll.launch_plan(83, 83, 4085, slots=64, lookback=12).smem_bytes <= ll.SMEM_LIMIT
    assert not ll.launch_plan(92, 77, 144, lookback=12).hoist
    assert ll.launch_plan(3, 2, 1).groups == 1  # no more groups than windows
    with pytest.raises(ValueError, match="item 14"):
        ll.launch_plan(256, 128, 100)


def test_bwd_launch_plan_fits_the_bench_widths_and_refuses_wide_layers():
    # one lockstep step of the bench's LSTM build, 256 slots x 64 windows:
    # the recurrence in blocks of four groups (16 windows, 1,024 blocks),
    # the weight gradients a block of every gate column per slot, dx in
    # blocks that stage 32 rows twice; each within a block's shared memory
    # and threads
    dims = [50, 42, 33, 25, 25, 33, 42]
    for i, (n_in, h) in enumerate(zip(dims[:-1], dims[1:])):
        plan = lb.launch_plan(n_in, h, 64, i > 0, slots=256)
        assert plan.groups == lb.RECUR_GROUPS and plan.groups * h <= lb.MAX_THREADS
        assert 256 * -(-64 // (plan.groups * lb.WINDOWS_PER_THREAD)) >= lb.MIN_BLOCKS
        assert max(plan.recur_smem, plan.wgrad_smem, plan.dx_smem) <= lb.SMEM_LIMIT
        assert plan.grad_cols >= 4 * h and plan.k_pad >= n_in + h + 1
        assert (plan.k_pad // 4) * (plan.grad_cols // 8) <= lb.MAX_THREADS
        assert (plan.dx_rows, plan.dx_smem > 0) == ((lb.DX_ROWS, True) if i else (0, False))
    # a few slots: smaller blocks, so that the recurrence still spreads
    assert lb.launch_plan(50, 42, 64, False, slots=4).groups == 1
    # the widths the parent trained still train, and those it refused
    # still wait for item 14 (the 92-tag hourglass's middle and first
    # layers)
    assert lb.launch_plan(46, 46, 64, True, slots=16).dx_smem <= lb.SMEM_LIMIT
    for args in ((92, 77, 64, False), (256, 128, 100, True)):
        with pytest.raises(NotImplementedError, match="item 14"):
            lb.launch_plan(*args)


def test_estimators_window_offsets_and_refuse_to_fit():
    ae = LSTMAutoEncoder(lookback_window=6)
    forecast = LSTMForecast(kind="lstm_symmetric", lookback_window=6, dims=[4])
    assert (ae.offset, forecast.offset) == (5, 6)
    assert LSTMAutoEncoder().offset == 0
    assert resolve_alias("gordo_components.model.models.KerasLSTMForecast").endswith("LSTMForecast")
    assert resolve_alias("gordo_tpu.models.estimator.KerasLSTMAutoEncoder").endswith("LSTMAutoEncoder")
    # LSTM training runs; what it does not train yet still raises, naming
    # its ROADMAP item: the mae loss waits for queue 1 item 2
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        ae.fit(np.zeros((20, 3), np.float32), device="cpu", loss="mae")
    assert ae.get_params() == {"kind": "lstm_hourglass", "lookback_window": 6}
