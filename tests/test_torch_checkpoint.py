"""Resumable fits (``train.stateful_fit``): the port's checkpointed fits
against their uninterrupted selves and against the JAX package, on the CPU.

The port's own contracts are held exactly: a fit run as chunks of
``checkpoint_every`` epochs, or interrupted and resumed, gives the
uninterrupted fit's params, Adam state and history bit for bit.  Against
the JAX package (its fits run once per module in a fresh process,
``torch_parity.run_in_fresh_process``; the port trains from the JAX
package's draws), per output ``max|ref - port| / max|ref|``
(``torch_parity.r12``):

- ``fit_checkpointed`` of an ``AutoEncoder``: params 1e-5 (measured
  1.2e-7 on the CPU), history 1e-5 (measured 8.7e-8); of an
  ``LSTMAutoEncoder``: params 1e-4 (measured 8.4e-7), history 1e-5
  (measured 9.4e-8): the bounds of the uninterrupted fits
  (``tests/test_torch_train.py``, ``tests/test_torch_lstm_train.py``);
- one chunk of ``make_stateful_fit_fn`` (two epochs) from a mid-fit JAX
  state carried across by ``convert.flax_adam_to_state``: params and
  history as above (measured: feedforward params 1.8e-7, history 0; LSTM
  params 3.4e-7, history 9.7e-8), Adam's moments 1e-4 (measured:
  feedforward mu 4.5e-7, nu 3.2e-7; LSTM mu 2.1e-6, nu 1.0e-6; a moment
  is a running sum of gradients and carries their rounding, the bound
  of the LSTM params), the count exactly.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from gordo_tpu_torch import convert
from gordo_tpu_torch.kernels import fleet_fit as ff
from gordo_tpu_torch.models.estimator import AutoEncoder, LSTMAutoEncoder
from gordo_tpu_torch.parallel.fleet import LSTMDims
from gordo_tpu_torch.train import checkpoint
from gordo_tpu_torch.train.fit import AdamState, TrainConfig, adam_hparams
from gordo_tpu_torch.train.lstm_fit import lstm_fit, window_fit
from torch_parity import flatten, jax_draws, port_params, r12, recorded_draws, run_in_fresh_process, unflatten

PARAM_TOL = {"ff": 1e-5, "lstm": 1e-4}
HISTORY_TOL = 1e-5
MOMENT_TOL = 1e-4
TAGS = 4
ROWS = 64
KWARGS = {
    "ff": {"kind": "feedforward_hourglass", "epochs": 4, "batch_size": 16},
    "lstm": {"kind": "lstm_hourglass", "lookback_window": 4, "encoding_layers": 1, "epochs": 4,
             "batch_size": 16},
}
CLASSES = {"ff": AutoEncoder, "lstm": LSTMAutoEncoder}


def _rows(seed=5, n=ROWS):
    return np.random.default_rng(seed).uniform(0, 1, (n, TAGS)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    X = _rows()
    inputs = {"X": X, **{f"{m}/config": np.array(json.dumps(kw)) for m, kw in KWARGS.items()}}
    return {"X": X, "ref": run_in_fresh_process(
        "checkpoint_reference", inputs, tmp_path_factory.mktemp("jax_checkpoint"))}


def _draws(refs, mode):
    return jax_draws if mode == "ff" else recorded_draws(refs["ref"], "lstm/draws")


def _equal(a, b):
    assert a.state_arrays().keys() == b.state_arrays().keys()
    for k, v in a.state_arrays().items():
        np.testing.assert_array_equal(v, b.state_arrays()[k], err_msg=k)
    np.testing.assert_array_equal(a.history_, b.history_)


def _fit(mode, X=None, **kw):
    X = _rows() if X is None else X
    return CLASSES[mode](**{**KWARGS[mode], "epochs": 6, **kw}).fit(X, device="cpu")


# -- the port against itself: bit for bit ----------------------------------------

@pytest.mark.parametrize("every", [1, 2, 3])
@pytest.mark.parametrize("mode", ["ff", "lstm"])
def test_chunked_fit_is_the_uninterrupted_fit_bit_for_bit(mode, every, tmp_path):
    ref = _fit(mode)
    got = _fit(mode, checkpoint_dir=str(tmp_path), checkpoint_every=every)
    _equal(ref, got)
    with open(tmp_path / "ckpt" / "state.json") as f:
        state = json.load(f)
    assert state["epochs_done"] == 6 and state["format"] == checkpoint.FORMAT
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


@pytest.mark.parametrize("mode", ["ff", "lstm"])
def test_interrupted_then_resumed_fit_is_bit_for_bit(mode, tmp_path, caplog):
    ref = _fit(mode)
    _fit(mode, epochs=4, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert checkpoint.load_checkpoint(str(tmp_path)).epochs_done == 4
    with caplog.at_level(logging.INFO, logger=checkpoint.__name__):
        got = _fit(mode, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert "Resuming fit at epoch 4" in caplog.text
    _equal(ref, got)


def test_adam_state_of_a_chunked_plain_fit_is_the_single_calls():
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((3, 40, TAGS)).astype(np.float32))
    dims, acts = [TAGS, 3, TAGS], ["tanh", None]
    fits = [ff.geometry(np.arange(25), 8), ff.geometry(np.arange(40), 8)]
    perms = [np.stack([rng.permutation(fg.n_total) for _ in range(5)])[None] for fg in fits]
    params0 = [(torch.from_numpy(rng.standard_normal((1, a, b)).astype(np.float32)),
                torch.zeros((1, b))) for a, b in zip(dims[:-1], dims[1:])]
    hp = adam_hparams(TrainConfig())
    w = torch.from_numpy(rng.uniform(0, 2, (3, 40)).astype(np.float32))
    args = (X, X, fits)
    whole = ff.fleet_fit(*args, params0, torch.from_numpy(ff.pack_perms(perms)), [0, 0, 0], acts, 5,
                         hp, w=w, return_state=True)
    params, state, hists, e0 = params0, None, [], 0
    for chunk in (2, 2, 1):
        part = torch.from_numpy(ff.pack_perms([p[:, e0:e0 + chunk] for p in perms]))
        params, hist, state = ff.fleet_fit(
            *args, params, part, [0, 0, 0] if state is None else np.arange(3), acts, chunk, hp,
            perm_draw=[0, 0, 0], w=w, state=state, return_state=True)
        hists.append(hist)
        e0 += chunk
    for (W, b), (W2, b2) in zip(whole[0], params):
        assert torch.equal(W, W2) and torch.equal(b, b2)
    assert torch.equal(whole[1], torch.cat(hists, dim=-1))
    for a, b in zip(whole[2], state):
        assert torch.equal(a, b)
    assert state.count.tolist() == [[5 * 4, 5 * 5]] * 3


# -- against the JAX package ----------------------------------------------------

def _port_tree(mode, est):
    if mode == "ff":
        return port_params(est)
    cells = [(c.kernel_i.detach().numpy(), c.kernel_h.detach().numpy(), c.bias.detach().numpy())
             for c, _ in est.module_.cells()]
    head = (est.module_.out.weight.detach().numpy().T, est.module_.out.bias.detach().numpy())
    return convert.lstm_layers_to_flax(cells, head)


@pytest.mark.parametrize("mode", ["ff", "lstm"])
def test_checkpointed_fit_matches_jax(jax_refs, mode, tmp_path):
    ref = jax_refs["ref"]
    est = CLASSES[mode](**KWARGS[mode]).fit(
        jax_refs["X"], device="cpu", draws=_draws(jax_refs, mode),
        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    want, got = flatten(unflatten(ref, f"{mode}/params")), flatten(_port_tree(mode, est))
    assert set(want) == set(got)
    for key, v in want.items():
        if np.any(v):
            assert r12(v, got[key]) <= PARAM_TOL[mode], (mode, key)
    assert r12(ref[f"{mode}/history"], est.history_) <= HISTORY_TOL


def _check_chunk(ref, prefix, params, mu, nu, count, history, tol):
    want = flatten(unflatten(ref, f"{prefix}/params"))
    for key, v in flatten(params).items():
        if np.any(want[key]):
            assert r12(want[key], v) <= tol, key
    for name, got in (("mu", mu), ("nu", nu)):
        want = flatten(unflatten(ref, f"{prefix}/{name}"))
        for key, v in flatten(got).items():
            if np.any(want[key]):
                assert r12(want[key], v) <= MOMENT_TOL, (name, key)
    assert int(count) == int(ref[f"{prefix}/count"])
    assert r12(ref[f"{prefix}/history"], history) <= HISTORY_TOL


@pytest.mark.parametrize("mode", ["ff", "lstm"])
def test_one_chunk_from_a_mid_fit_jax_state_matches_jax(jax_refs, mode):
    """The JAX package's state after two epochs, carried across by
    ``convert.flax_adam_to_state``, then the next two epochs in each."""
    ref, X = jax_refs["ref"], jax_refs["X"]
    cfg = TrainConfig(epochs=4, batch_size=16)
    hp = adam_hparams(cfg)
    mid = unflatten(ref, f"{mode}/mid/params")
    mu, nu, count = convert.flax_adam_to_state(
        ref[f"{mode}/mid/count"], unflatten(ref, f"{mode}/mid/mu"), unflatten(ref, f"{mode}/mid/nu"))
    assert int(count) == 2 * 4
    x = torch.from_numpy(X[None])
    if mode == "ff":
        layers = convert.flax_to_layers(mid)
        dims = [TAGS] + [W.shape[1] for W, _ in layers]
        fits = [ff.geometry(np.arange(ROWS), cfg.batch_size)]
        _, perms = jax_draws(0, dims, [fits[0].n_total], 4)
        params0 = [(torch.from_numpy(W)[None, None], torch.from_numpy(b)[None, None]) for W, b in layers]
        state = ff.FitState(torch.from_numpy(mu)[None, None], torch.from_numpy(nu)[None, None],
                            torch.tensor([[int(count)]], dtype=torch.int32))
        out, hist, state = ff.fleet_fit(
            x, x, fits, params0,
            torch.from_numpy(ff.pack_perms([perms[fits[0].n_total][None, 2:4]])), [0],
            ["tanh"] * (len(dims) - 2) + [None], 2, hp, state=state, return_state=True)
        params = convert.layers_to_flax([(W[0, 0], b[0, 0]) for W, b in out])
        count_, tree_mu, tree_nu = convert.state_to_flax_adam(state.mu[0, 0], state.nu[0, 0],
                                                              state.count[0, 0], dims)
        _check_chunk(ref, "ff/end", params, tree_mu, tree_nu, count_, hist[0, 0].numpy(), PARAM_TOL[mode])
        return
    cells, head = convert.flax_to_lstm_layers(mid)
    dims = LSTMDims([TAGS] + [kh.shape[0] for _, kh, _ in cells] + [head[0].shape[1]])
    L = KWARGS["lstm"]["lookback_window"]
    fits = [window_fit(np.arange(ROWS), cfg.batch_size, L - 1)]
    (_, _), perms = recorded_draws(ref, "lstm/draws")(0, dims, [fits[0].n_total], 4)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None, None]  # noqa: E731
    params0 = ([tuple(put(a) for a in cell) for cell in cells], tuple(put(a) for a in head))
    state = AdamState([put(a) for a in mu], [put(a) for a in nu], np.array([[int(count)]]))
    c, h, hist, state = lstm_fit(
        x, x, fits, params0, [perms[fits[0].n_total][None, 2:4]], [0],
        ("tanh",) * len(cells), None, L, L - 1, 2, hp, state=state, return_state=True)
    params = convert.lstm_layers_to_flax([tuple(t[0, 0] for t in cell) for cell in c], (h[0][0, 0], h[1][0, 0]))
    count_, tree_mu, tree_nu = convert.state_to_flax_adam(
        [t[0, 0] for t in state.mu], [t[0, 0] for t in state.nu], state.count[0, 0], dims)
    _check_chunk(ref, "lstm/end", params, tree_mu, tree_nu, count_, hist[0, 0].numpy(), PARAM_TOL[mode])


@pytest.mark.parametrize("mode", ["ff", "lstm"])
def test_adam_state_round_trips_through_convert(jax_refs, mode):
    ref = jax_refs["ref"]
    mu, nu = unflatten(ref, f"{mode}/mid/mu"), unflatten(ref, f"{mode}/mid/nu")
    pmu, pnu, count = convert.flax_adam_to_state(ref[f"{mode}/mid/count"], mu, nu)
    if mode == "ff":
        dims = [TAGS] + [W.shape[1] for W, _ in convert.flax_to_layers(mu)]
        assert pmu.shape == (ff.n_params(dims),)
    else:
        cells, head = convert.flax_to_lstm_layers(mu)
        dims = LSTMDims([TAGS] + [kh.shape[0] for _, kh, _ in cells] + [head[0].shape[1]])
    count2, mu2, nu2 = convert.state_to_flax_adam(pmu, pnu, count, dims)
    assert int(count2) == int(ref[f"{mode}/mid/count"])
    for a, b in ((mu, mu2), (nu, nu2)):
        fa, fb = flatten(a), flatten(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


# -- what a checkpoint holds, and what is not resumed -------------------------

@pytest.mark.parametrize("change", ["data", "seed", "config"])
def test_a_stale_checkpoint_is_ignored(change, tmp_path, caplog):
    X = _rows()
    _fit("ff", X, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    other = {"data": dict(X=_rows(seed=6)), "seed": dict(seed=3), "config": dict(learning_rate=3e-3)}[change]
    X2 = other.pop("X", X)
    ref = _fit("ff", X2, **other)
    with caplog.at_level(logging.WARNING, logger=checkpoint.__name__):
        got = _fit("ff", X2, checkpoint_dir=str(tmp_path), checkpoint_every=2, **other)
    assert "belongs to a different fit" in caplog.text
    _equal(ref, got)


def test_an_over_trained_checkpoint_is_discarded(tmp_path, caplog):
    _fit("ff", checkpoint_dir=str(tmp_path), checkpoint_every=3)
    ref = _fit("ff", epochs=4)
    with caplog.at_level(logging.WARNING, logger=checkpoint.__name__):
        got = _fit("ff", epochs=4, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert "6 epochs done > budget 4" in caplog.text
    _equal(ref, got)
    assert checkpoint.load_checkpoint(str(tmp_path)).epochs_done == 4


def test_a_crash_between_the_renames_resumes_from_the_old_payload(tmp_path):
    ref = _fit("lstm")
    _fit("lstm", epochs=4, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    # the save of a next checkpoint moved the payload aside and died
    os.replace(tmp_path / "ckpt", tmp_path / "ckpt.old")
    (tmp_path / "ckpt.tmp").mkdir()
    resumed = checkpoint.load_checkpoint(str(tmp_path))
    assert resumed is not None and resumed.epochs_done == 4 and resumed.count == 4 * 4
    got = _fit("lstm", checkpoint_dir=str(tmp_path), checkpoint_every=2)
    _equal(ref, got)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_a_jax_checkpoint_directory_reads_as_empty(tmp_path):
    from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder

    JaxAutoEncoder(**{**KWARGS["ff"], "epochs": 2}).fit(
        _rows(), checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert os.path.exists(tmp_path / "ckpt" / "state.json")
    assert checkpoint.load_checkpoint(str(tmp_path)) is None
    ref = _fit("ff", epochs=2)
    _equal(ref, _fit("ff", epochs=2, checkpoint_dir=str(tmp_path), checkpoint_every=1))


@pytest.mark.parametrize("every", [0, -1])
def test_checkpoint_every_below_one_raises(every, tmp_path):
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        checkpoint.fit_checkpointed(lambda *a: None, "f", str(tmp_path), 4, checkpoint_every=every)
    if every < 0:  # the estimator reads 0 as the default 10, as the JAX package does
        with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
            _fit("ff", checkpoint_dir=str(tmp_path), checkpoint_every=every)


def test_the_fingerprint_excludes_epochs_only():
    X = _rows()
    base = ("AutoEncoder", "feedforward_hourglass", {}, [4, 2, 4], TrainConfig(epochs=4), 0, X, X)
    fp = checkpoint.fit_fingerprint(*base)
    assert checkpoint.fit_fingerprint(*base[:4], TrainConfig(epochs=9), *base[5:]) == fp
    for i, other in ((1, "feedforward_model"), (2, {"func": "relu"}), (3, [4, 3, 4]),
                     (4, TrainConfig(epochs=4, batch_size=8)), (5, 1), (6, X + 1)):
        assert checkpoint.fit_fingerprint(*base[:i], other, *base[i + 1:]) != fp
