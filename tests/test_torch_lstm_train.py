"""The port's LSTM training against the JAX package's, on the CPU.

The JAX side runs once per module in a fresh process
(``torch_parity.run_in_fresh_process``): a new XLA:CPU LSTM compile late in
a test worker has crashed the worker (``tests/lstm_detectors.py``).  Inputs
are made from a seed with numpy and handed to both packages.  Bounds, per
output, ``max|ref - port| / max|ref|`` (``torch_parity.r12``):

- one layer's gradients (``lstm_layer_bwd``'s plain version: autograd
  through ``lstm_layer_plain``'s recurrence) against ``jax.vjp`` of
  ``_fused_lstm_layer`` and its tanh: 1e-5 (measured <= 3.0e-7 on the
  CPU; the products sum in another order than XLA's);
- a whole fit, ``LSTMAutoEncoder`` and ``LSTMForecast``, from the JAX
  package's initial params and permutations: params 1e-4 (measured
  <= 8.8e-7), loss history 1e-5 (measured <= 9.1e-8): the feedforward
  fit's bounds against its plain version (``chip_smoke.py``
  ``TRAIN_TOLERANCE``), as Adam amplifies the sum order's rounding where
  gradients are small.

The lockstep loop's own pieces (the step tables, Adam over active slots,
the autograd functions the kernels run behind) are held to their plain
versions exactly.
"""

import json

import numpy as np
import pytest
import torch

from gordo_tpu_torch import convert
from gordo_tpu_torch.kernels import fleet_adam as fa
from gordo_tpu_torch.kernels import lstm_head_fit as hf
from gordo_tpu_torch.kernels import lstm_layer as ll
from gordo_tpu_torch.kernels import lstm_layer_bwd as lb
from gordo_tpu_torch.kernels.lstm_layer import Minibatch
from gordo_tpu_torch.models.estimator import LSTMAutoEncoder, LSTMForecast
from gordo_tpu_torch.parallel.fleet import LSTMDims, fleet_draws, init_lstm_params, put_lstm_draws
from gordo_tpu_torch.train import lstm_fit as lf
from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams, adam_update, bias_corrections
from gordo_tpu_torch.kernels.fleet_init import fma
from gordo_tpu_torch.kernels.scaler_stats import AFFINE
from torch_parity import flatten, r12, recorded_draws, run_in_fresh_process, unflatten

GRAD_TOL = 1e-5
PARAM_TOL = 1e-4
HISTORY_TOL = 1e-5
LOOKBACK = 4
FIT_KWARGS = {"kind": "lstm_hourglass", "lookback_window": LOOKBACK, "epochs": 3, "batch_size": 16}


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def ints(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# -- the cases: one slot each, six window positions, five of them real -------

def _layer_cases():
    rng = np.random.default_rng(41)
    B, n_real, T = 6, 5, LOOKBACK
    cases = {}
    # the first layer: raw rows of machine 1 of 2, a fit's row list that is
    # not a prefix (as KFold's), starting past another fit's list
    rows = np.sort(rng.choice(40, 24, replace=False))
    row_list = np.concatenate([np.arange(7), rows])
    win = np.full((1, B), -1)
    win[0, :n_real] = rng.choice(len(rows) - T + 1, n_real, replace=False)
    X = rng.standard_normal((2, 40, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (1, 3)).astype(np.float32)
    offset = rng.uniform(-0.5, 0.5, (1, 3)).astype(np.float32)
    # the MinMax step one FMA, as the chain takes it (rounded once)
    windows = fma(*(torch.from_numpy(a) for a in (X[1][rows[win[0, :n_real, None] + np.arange(T)]], scale,
                                                    offset))).numpy()
    batch = dict(win=win, n_windows=[n_real], rows=row_list, row_off=[7], x_mach=[1])
    cases["first"] = dict(x=X, windows=windows, H=4, batch=batch, scale=scale, offset=offset, last=False)
    later = dict(win=np.arange(B)[None], n_windows=[n_real], rows=np.arange(1), row_off=[0], x_mach=[0])
    x = rng.standard_normal((1, B, T, 4)).astype(np.float32)
    cases["later"] = dict(x=x, windows=x[0, :n_real], H=3, batch=later, last=False)
    x = rng.standard_normal((1, B, T, 3)).astype(np.float32)
    cases["last"] = dict(x=x, windows=x[0, :n_real], H=4, batch=later, last=True)
    for case in cases.values():
        n_in, H = case["windows"].shape[-1], case["H"]
        case["kernel_i"] = (rng.standard_normal((1, n_in, 4 * H)) / np.sqrt(n_in)).astype(np.float32)
        case["kernel_h"] = (rng.standard_normal((1, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
        case["bias"] = (0.3 * rng.standard_normal((1, 4 * H))).astype(np.float32)
        shape = (1, B, H) if case["last"] else (1, B, T, H)
        case["dout"] = rng.standard_normal(shape).astype(np.float32)
    return cases


CASES = _layer_cases()


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX result this module compares with, from one fresh process."""
    inputs = {}
    for name, case in CASES.items():
        n_real = case["batch"]["n_windows"][0]
        dout = case["dout"][0, :n_real]
        if case["last"]:  # the head reads the last step alone
            full = np.zeros((n_real, LOOKBACK, case["H"]), np.float32)
            full[:, -1] = dout
            dout = full
        inputs.update({f"{name}/x": case["windows"], f"{name}/kernel_i": case["kernel_i"][0],
                       f"{name}/kernel_h": case["kernel_h"][0], f"{name}/bias": case["bias"][0],
                       f"{name}/dout": dout})
    tmp = tmp_path_factory.mktemp("jax_lstm_vjp")
    vjp = run_in_fresh_process("lstm_vjp_reference", inputs, tmp)
    rng = np.random.default_rng(43)
    X = rng.uniform(0, 1, (70, 4)).astype(np.float32)
    fit = run_in_fresh_process(
        "lstm_fit_reference", {"X": X, "config": np.array(json.dumps(FIT_KWARGS))},
        tmp_path_factory.mktemp("jax_lstm_fit"),
    )
    return {"vjp": vjp, "fit": fit, "X": X}


# -- (a) one layer's gradients --------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_gradients_match_jax(jax_refs, name):
    case = CASES[name]
    b = case["batch"]
    batch = Minibatch(ints(b["win"]), ints(b["n_windows"]), ints(b["rows"]), ints(b["row_off"]),
                      ints(b["x_mach"]))
    first = name == "first"
    kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=case["last"])
    if first:
        kw.update(chain=[(AFFINE, t(case["scale"]), t(case["offset"]))])
    weights = [t(case[k]) for k in ("kernel_i", "kernel_h", "bias")]
    # through the wrapper, which takes the plain version on the CPU
    dx, dki, dkh, db = lb.lstm_layer_bwd(
        t(case["x"]), *weights, None, None, t(case["dout"]), **kw, want_dx=not first
    )
    assert lb.launches == 0
    n_real = b["n_windows"][0]
    ref = {k: jax_refs["vjp"][f"{name}/{k}"] for k in ("dx", "dkernel_i", "dkernel_h", "dbias")}
    assert r12(ref["dkernel_i"], dki[0]) <= GRAD_TOL
    assert r12(ref["dkernel_h"], dkh[0]) <= GRAD_TOL
    assert r12(ref["dbias"], db[0]) <= GRAD_TOL
    if first:
        assert dx is None  # nothing flows into the rows
    else:
        assert r12(ref["dx"], dx[0, :n_real]) <= GRAD_TOL
    # the forward's saves are what the recurrence computed, and its output
    # equals the serving layer's on the same windows
    out, gates, cell = ll.lstm_layer_train(t(case["x"]), *weights, **{k: v for k, v in kw.items()})
    assert gates.shape == (1, 6, LOOKBACK, 4 * case["H"]) and cell.shape == (1, 6, LOOKBACK, case["H"])
    serve = ll.lstm_layer_plain(t(case["windows"][None]), *weights, lookback=LOOKBACK, act="tanh",
                                last=case["last"])
    torch.testing.assert_close(out[0, :n_real], serve[0], rtol=0, atol=0)


# -- (b) a whole fit -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ae", "forecast"])
def test_lstm_fit_matches_jax(jax_refs, mode):
    fit = jax_refs["fit"]
    cls = LSTMAutoEncoder if mode == "ae" else LSTMForecast
    est = cls(**FIT_KWARGS).fit(jax_refs["X"], device="cpu", draws=recorded_draws(fit, f"{mode}/draws"))
    module = est.module_
    cells = [(c.kernel_i.detach().numpy(), c.kernel_h.detach().numpy(), c.bias.detach().numpy())
             for c, _ in module.cells()]
    got = convert.lstm_layers_to_flax(cells, (module.out.weight.detach().numpy().T,
                                              module.out.bias.detach().numpy()))
    ref, got = flatten(unflatten(fit, f"{mode}/params")), flatten(got)
    assert set(ref) == set(got)
    for key, want in ref.items():
        if np.any(want):
            assert r12(want, got[key]) <= PARAM_TOL, (mode, key)
    assert r12(fit[f"{mode}/history"], est.history_) <= HISTORY_TOL
    assert est.get_metadata()["history"]["loss"] == [float(v) for v in est.history_]
    # the fitted module scores through the serving path
    assert est.predict(jax_refs["X"][:20], device="cpu").shape == (20 - est.offset, 4)


def test_flax_round_trip_of_fitted_lstm_is_exact(jax_refs):
    tree = unflatten(jax_refs["fit"], "ae/params")
    cells, head = convert.flax_to_lstm_layers(tree)
    want, got = flatten(tree), flatten(convert.lstm_layers_to_flax(cells, head))
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value)


# -- (c) the lockstep loop's own pieces ------------------------------------------

def _fits():
    return [lf.window_fit(np.arange(30), 8, 3), lf.window_fit(np.arange(45), 8, 3),
            lf.window_fit(np.arange(60), 16, 3)]


def test_step_tables_pack_each_minibatch_real_windows_first():
    fits = _fits()
    hp = adam_hparams(TrainConfig())
    M, epochs = 2, 2
    dims = LSTMDims((4, 3, 2, 4))
    _, perms = put_lstm_draws(fleet_draws, 5, dims, fits, epochs, "cpu")
    steps = lf.plan_steps(fits, M, perms, [0, 0], epochs, hp, "cpu")
    G = len(fits)
    assert tuple(steps.win.shape) == (epochs, max(f.steps for f in fits), M * G, 16)
    for e in range(epochs):
        for s in range(int(steps.win.shape[1])):
            for slot in range(M * G):
                fg = fits[slot % G]
                win = steps.win[e, s, slot].numpy()
                n = int(steps.n_windows[e, s, slot])
                if s >= fg.steps:  # the fit has no such step: inactive
                    assert n == 0 and int(steps.count[e, s, slot]) == 0
                    continue
                ids = perms[slot % G][0][e, s * fg.bs:(s + 1) * fg.bs]
                real = ids[ids < fg.n_windows]
                np.testing.assert_array_equal(win[:n], real)  # in permutation order
                assert (win[n:] == -1).all()
                assert int(steps.count[e, s, slot]) == e * fg.steps + s + 1
    np.testing.assert_array_equal(steps.bc.numpy(), bias_corrections(steps.count.numpy(), hp))
    assert steps.row_off.tolist() == [0, 30, 75] * M
    assert steps.x_mach.tolist() == [0, 0, 0, 1, 1, 1]


def test_lockstep_adam_leaves_inactive_slots_alone():
    rng = np.random.default_rng(47)
    hp = adam_hparams(TrainConfig())
    shapes = [(4, 3, 8), (4, 8), (4, 2, 5)]
    params = [t(rng.standard_normal(s)) for s in shapes]
    grads = [t(rng.standard_normal(s)) for s in shapes]
    mus = [t(0.1 * rng.standard_normal(s)) for s in shapes]
    nus = [t(rng.uniform(0, 0.01, s)) for s in shapes]
    count = ints([3, 0, 1, 0])
    bc = t(bias_corrections(count.numpy(), hp))
    before = [[a.clone() for a in group] for group in (params, mus, nus)]
    fa.fleet_adam(params, grads, mus, nus, count, bc, hp)
    assert fa.launches == 0
    for group, group0 in zip((params, mus, nus), before):
        for a, a0 in zip(group, group0):
            for slot in (1, 3):  # inactive: bit for bit
                assert torch.equal(a[slot], a0[slot])
    for i in range(len(shapes)):
        for slot, c in ((0, 3), (2, 1)):  # active: optax's step of its own count
            p, mu, nu = adam_update(before[0][i][slot], grads[i][slot], before[1][i][slot],
                                    before[2][i][slot], c, hp)
            assert torch.equal(params[i][slot], p)
            assert torch.equal(mus[i][slot], mu) and torch.equal(nus[i][slot], nu)


def test_autograd_functions_give_the_plain_fit():
    # the kernels' route runs the layers and the head behind autograd
    # functions whose backward is lstm_layer_bwd / lstm_head_fit; on the
    # CPU those run their plain versions, so the two routes agree exactly
    rng = np.random.default_rng(53)
    M, N, F = 2, 60, 4
    X = t(rng.standard_normal((M, N, F)))
    y = t(rng.standard_normal((M, N, 3)))
    fits = _fits()
    G = len(fits)
    scale = t(rng.uniform(0.5, 1.5, (M, G, F)))
    offset = t(rng.uniform(-0.1, 0.1, (M, G, F)))
    dims = LSTMDims((F, 3, 2, 3))
    params0, perms = put_lstm_draws(fleet_draws, 0, dims, fits, 2, "cpu")
    hp = adam_hparams(TrainConfig())
    runs = {
        route: lf.lstm_fit(X, y, fits, params0, perms, [0, 0], ["tanh", "tanh"], "linear", LOOKBACK, 3, 2,
                           hp, route=route, chain=[(AFFINE, scale, offset)])
        for route in ("plain", "kernels")
    }
    (cells_a, head_a, hist_a), (cells_b, head_b, hist_b) = runs["plain"], runs["kernels"]
    for a, b in zip([x for c in cells_a for x in c] + list(head_a),
                    [x for c in cells_b for x in c] + list(head_b)):
        assert a.shape[:2] == (M, G)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(hist_a, hist_b, rtol=0, atol=0)
    assert hist_a.shape == (M, G, 2) and torch.isfinite(hist_a).all()
    assert ll.train_launches == 0 and lb.launches == 0 and hf.launches == 0


def test_head_gradient_matches_autograd_of_the_loss():
    rng = np.random.default_rng(59)
    S, B, H, Fo = 3, 5, 4, 3
    batch = Minibatch(ints([[0, 2, 1, -1, -1], [3, 0, -1, -1, -1], [-1] * 5]), ints([3, 2, 0]),
                      ints(np.arange(10)), ints([0, 0, 2]), ints([0, 1, 1]))
    h, W, b = t(rng.standard_normal((S, B, H))), t(rng.standard_normal((S, H, Fo))), t(rng.standard_normal((S, Fo)))
    y = t(rng.standard_normal((2, 10, Fo)))
    loss, dW, db, dh = hf.lstm_head_fit(h, W, b, y, batch=batch, shift=2, act="tanh")
    assert float(loss[2]) == 0.0 and not dW[2].any()  # a slot with no real window
    for s in range(2):
        n = int(batch.n_windows[s])
        rows = batch.row_off[s] + batch.win[s, :n] + 2
        pred = torch.tanh(h[s, :n] @ W[s] + b[s])
        want = ((pred - y[int(batch.x_mach[s]), rows.long()]) ** 2).mean(dim=-1).sum() / n
        torch.testing.assert_close(loss[s], want, rtol=1e-6, atol=0)


def test_lstm_draws_follow_flax_initialisers():
    dims = LSTMDims((50, 42, 33, 50))
    cells, (W, b) = init_lstm_params(dims, seed=7)
    again, _ = init_lstm_params(dims, seed=7)
    for (ki, kh, bias), (n_in, H) in zip(cells, [(50, 42), (42, 33)]):
        assert ki.shape == (n_in, 4 * H) and kh.shape == (H, 4 * H) and not bias.any()
        for g in range(4):  # each gate's recurrent kernel is orthogonal
            q = kh[:, g * H:(g + 1) * H]
            np.testing.assert_allclose(q.T @ q, np.eye(H), atol=1e-5)
        # lecun-normal: a normal of variance 1 / fan_in truncated at 2 sigma
        assert abs(ki.std() * np.sqrt(n_in) - 1.0) < 0.1 and np.abs(ki).max() <= 2 / 0.8796 / np.sqrt(n_in)
    assert W.shape == (33, 50) and not b.any()
    np.testing.assert_array_equal(again[0][1], cells[0][1])  # a seed's draws are its own


def test_lstm_fits_the_kernels_cannot_take_are_refused():
    X = np.zeros((40, 3), np.float32)
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        LSTMAutoEncoder(kind="lstm_model", lookback_window=3, epochs=1).fit(X, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        LSTMAutoEncoder(kind="lstm_hourglass", lookback_window=3, func="relu").fit(X, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        LSTMForecast(lookback_window=3, optimizer="sgd").fit(X, device="cpu")
    with pytest.raises(ValueError, match="no window"):
        LSTMForecast(lookback_window=40).fit(X, device="cpu")
    if not torch.cuda.is_available():  # without a card only the CPU, asked for by name
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LSTMAutoEncoder(lookback_window=3).fit(X)
