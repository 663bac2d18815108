"""The port's pad-up and warm fleet builds of LSTM detectors against the
JAX package's.

Five ``LSTMAutoEncoder`` machines of 4 tags (``lstm_hourglass`` with one
encoding layer: two LSTM layers, so that the JAX package's six programs
compile in about a minute; lookback 4, 2 epochs, batch 32) at 90, 110,
124, 150 and 170 rows are built with ``pad_lengths=64``
by ``gordo_tpu.parallel.anomaly.FleetDiffBuilder`` in a fresh process
(``torch_parity.run_in_fresh_process``; a new XLA:CPU LSTM compile late in
a test worker has crashed the worker), then warm from those detectors'
params, and by the port's on the CPU (the kernels' plain versions) from
the JAX package's initial params and permutations.  That makes two padded
groups (128 rows: 110, 124; 192 rows: 150, 170) and demotes the 90-row
machine to the exact path (at 128 rows the last test block starts at row
96, and the model's offset is 3).  Within a padded group a machine's
windows whose target row lies past its length weigh 0, so some lockstep
steps of the shorter machines' fits have no real window.  Bounds, per
machine and output series, ``max|ref - port| / max|ref|``, those of
``tests/test_torch_lstm_fleet_build.py``: stats 1e-6 (measured 0),
params 1e-4 (measured on the CPU, cold and warm, <= 7.0e-7),
history 1e-5 (<= 1.2e-7), thresholds 1e-4 (<= 1.5e-7), CV scores 1e-3
(<= 2.6e-6).
"""

import json

import numpy as np
import pytest
import torch

from gordo_tpu_torch import convert
from gordo_tpu_torch.kernels import fleet_adam as fa
from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
from gordo_tpu_torch.parallel.fleet import LSTMDims, init_lstm_params
from gordo_tpu_torch.serializer import from_definition
from gordo_tpu_torch.train import fit as tfit
from gordo_tpu_torch.train import lstm_fit as lf
from test_torch_lstm_fleet_build import TAGS, assert_same_detector
from test_torch_lstm_fleet_build import definition as lstm_definition
from torch_parity import recorded_draws, run_in_fresh_process, sine_rows, unflatten

LENGTHS = (90, 110, 124, 150, 170)
PAD = 64
DEMOTED = 0


def definition():
    d = lstm_definition()
    d["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"]["gordo_tpu.pipeline.Pipeline"][
        "steps"][1]["gordo_tpu.models.estimator.LSTMAutoEncoder"]["encoding_layers"] = 1
    return d


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(67)
    return [sine_rows(rng, n, TAGS, phase=0.4 * i) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def jax_builds(inputs, tmp_path_factory):
    arrays = {f"X/{i}": X for i, X in enumerate(inputs)}
    arrays["definition"] = np.array(json.dumps(definition()))
    arrays["pad_lengths"] = np.array(PAD)
    return run_in_fresh_process("lstm_padded_build_reference", arrays,
                                tmp_path_factory.mktemp("jax_lstm_padded_build"))


@pytest.fixture(scope="module")
def port_builds(inputs, jax_builds):
    spec = analyze_definition(from_definition(definition()))
    draws = recorded_draws(jax_builds, "draws")
    cold = FleetDiffBuilder(spec, pad_lengths=PAD, device="cpu", draws=draws).build(inputs)
    warm_params = [convert.flax_lstm_to_state_arrays(unflatten(jax_builds, f"cold/m{i}/params"))
                   for i in range(len(inputs))]
    warm = FleetDiffBuilder(spec, pad_lengths=PAD, device="cpu", draws=draws).build(
        inputs, warm_params=warm_params)
    return {"cold": cold, "warm": warm}


def _sub(flat, prefix):
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("kind,machine", [(k, i) for k in ("cold", "warm") for i in range(len(LENGTHS))])
def test_lstm_padded_build_matches_jax(jax_builds, port_builds, kind, machine):
    ref = _sub(jax_builds, kind)
    got = port_builds[kind][machine]
    assert bool(ref[f"m{machine}/pad_built"]) == (machine != DEMOTED)
    assert getattr(got, "pad_built_", False) == (machine != DEMOTED)
    assert np.isfinite(got.feature_thresholds_).all()
    assert_same_detector(ref, machine, got, f"{kind} machine {machine}")


def test_lstm_warm_leaf_signature_is_checked(inputs, port_builds):
    spec = analyze_definition(from_definition(definition()))
    states = [d.base_estimator._final.state_arrays() for d in port_builds["cold"]]
    states[1] = {k: v for k, v in states[1].items() if k != "out.bias"}
    with pytest.raises(ValueError, match="leaf signature"):
        FleetDiffBuilder(spec, pad_lengths=PAD, device="cpu").build(inputs, warm_params=states)


def test_step_without_real_windows_takes_a_zero_gradient_adam_step(monkeypatch):
    # machine 1 has 3 real windows of the fit's 11: with batches of 4 and
    # the identity permutation its second and third steps have none, yet
    # stay active, and Adam moves its params on a zero gradient
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    dims = LSTMDims([3, 2, 3])
    cells, head = init_lstm_params(dims, 0)
    put = lambda a: torch.from_numpy(np.asarray(a)[None].copy())  # noqa: E731
    params0 = ([tuple(put(a) for a in c) for c in cells], (put(head[0]), put(head[1])))
    fits = [lf.window_fit(np.arange(12), 4, 1)]
    perms = [np.arange(12)[None, None]]
    hp = tfit.adam_hparams(tfit.TrainConfig())
    steps = []

    def recording(params, grads, mus, nus, count, bc, hp_):
        before = [[t.clone() for t in ts] for ts in (params, mus, nus)]
        fa.fleet_adam(params, grads, mus, nus, count, bc, hp_)
        steps.append((before, [g.clone() for g in grads], bc.clone(), count.clone(),
                      [p.clone() for p in params]))

    monkeypatch.setattr(lf, "fleet_adam", recording)
    _, _, history = lf.lstm_fit(X, X, fits, params0, perms, [0, 0], ("tanh",), "linear", 2, 1, 1, hp,
                                route="kernels", counts=[[11], [3]])
    assert len(steps) == 3
    for s, ((params, mus, nus), grads, bc, count, after) in enumerate(steps):
        assert int(count[1]) == s + 1
        if s == 0:
            continue
        for p, g, mu, nu, new in zip(params, grads, mus, nus, after):
            assert not g[1].any()
            want, _, _ = tfit.adam_step(p[1], torch.zeros_like(p[1]), mu[1], nu[1], bc[1, 0], bc[1, 1], hp)
            torch.testing.assert_close(new[1], want, rtol=0, atol=0)
        assert any(not torch.equal(new[1], p[1]) for p, new in zip(params, after))
    assert torch.isfinite(history).all() and history[1, 0, 0] > 0
