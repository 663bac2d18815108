"""Detectors with SimpleImputer, PCA and scaler steps served as the JAX
package serves them fused, on the CPU.

Chain C is ``SimpleImputer(median) → PCA(4) → MinMaxScaler`` in front of a
feedforward ``AutoEncoder`` (or an ``LSTMAutoEncoder``); the JAX package
serves it inside ``serve.score``, ``serve.fleet``/``serve.fleet_subset``
and ``serve.stream_step``.  The port stacks its steps into the fleet
scorer's buckets (one stacked ``chain_apply``, then ``fleet_score``),
casts their stats leaves at bf16 and int8, streams it and serves it behind
an LSTM.  A chain with a ``QuantileTransformer`` or ``FunctionTransformer``
step has no fused program: both packages serve it at float32 whatever the
dtype, one machine at a time, and refuse to stream it.

JAX detectors are built by hand (the steps fitted on NaN-free correlated
rows, the estimator's ``module.init`` params, thresholds from a seed) and
carried across with ``gordo_tpu_torch.convert``; requests carry NaN cells.
Sizes: 5 machines × 64 rows × 6 tags, PCA k = 4; an LSTM of lookback 3.

Bounds, ``max|ref - port| / max|ref|`` per output over the non-NaN values
(NaN where the reference has NaN), each stated beside its test: the
serving bound 1e-5 at f32 (bulk, subset, per machine, the stream and the
LSTM); bf16 3% (model output) and 10% (scores), int8 25%, against the JAX
package at f32, as ``tests/test_torch_precision.py`` holds them; the CV
bounds 1e-3 (explained variance 1e-4) for the cross-validated LSTMs,
whose fits the two packages run from the same draws.  Measured on the
CPU: stacked and per machine 6.1e-7, the stream 1.7e-7; bf16 1.1e-2
(model output) and 5.2e-3 (scores), int8 4.3e-2 and 1.5e-2; the LSTMs
served 2.4e-7, their bucket 1.3e-7 and stream 1.0e-7; cross-validated
thresholds 1.5e-7, CV scores 8.9e-8 (explained variance 7.6e-7),
out-of-fold predictions 1.0e-6.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.anomaly.diff import DiffBasedAnomalyDetector as JaxDetector
from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.ops import scalers as jax_scalers
from gordo_tpu.ops.transformer_funcs import multiplier
from gordo_tpu.pipeline import Pipeline as JaxPipeline
from gordo_tpu.registry import lookup_factory
from gordo_tpu.serve import precision as jax_precision
from gordo_tpu.serve.fleet_scorer import FleetScorer as JaxFleetScorer
from gordo_tpu.serve.fleet_scorer import _signature as jax_signature
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.serve.scorer import _extract_chain as jax_extract_chain
from gordo_tpu.serve.stream import MachineStream as JaxMachineStream
from gordo_tpu.serve.stream import StreamUnsupported as JaxStreamUnsupported
from gordo_tpu_torch import serializer
from gordo_tpu_torch.kernels import chain_apply as ca
from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.server import ModelCollection
from gordo_tpu_torch.serve.stream import MachineStream, StreamUnsupported, reference_verdict
from torch_parity import carry, r12, run_in_fresh_process, sine_rows

TAGS, K, ROWS, MACHINES = 6, 4, 64, 5
TOL = 1e-5
CV_TOL, EV_TOL = 1e-3, 1e-4
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")
#: the r12 bounds of tests/test_torch_precision.py
BOUNDS = {
    "bfloat16": {"model-output": 0.03, "tag-anomaly-scores": 0.10,
                 "total-anomaly-score": 0.10, "anomaly-confidence": 0.10},
    "int8": {k: 0.25 for k in OUTPUTS},
}


def r12_nan(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got)), "NaN where the reference has NaN"
    return r12(ref[~nan], got[~nan]) if (~nan).any() else 0.0


def correlated_rows(rng, n, tags=TAGS):
    """Tags mixing latent signals of decreasing strength: PCA's leading
    singular values well apart (``test_torch_transform_build.py``)."""
    latent = sine_rows(rng, n, tags) * (0.6 ** np.arange(tags))
    mix, _ = np.linalg.qr(rng.standard_normal((tags, tags)))
    return (latent @ mix.T).astype(np.float32)


def with_nan(X, rng, cells=3):
    Q = X.copy()
    Q[rng.integers(0, len(Q), cells), rng.integers(0, Q.shape[1], cells)] = np.nan
    return Q


def init_params(est, n_in, n_out, rng, seed):
    """The JAX estimator's ``module.init`` params (nudged by seeded noise),
    ``n_in`` features in and ``n_out`` out."""
    kw = dict(n_features=n_in, n_features_out=n_out, **{k: v for k, v in est.kwargs.items() if k != "seed"})
    est.module_ = lookup_factory(est.model_type, est.kind)(**kw)
    est._factory_kwargs_built = kw
    lookback = getattr(est, "lookback_window", None)
    shape = (1, n_in) if lookback is None else (1, lookback, n_in)
    params = est.module_.init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))["params"]
    est.params_ = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                               params)
    return est


def jax_detector(X, steps, est, rng, seed, window=None):
    """A JAX ``DiffBasedAnomalyDetector`` of ``steps`` (unfitted JAX
    transforms, fitted here in turn on ``X``) before ``est`` (init
    params), its MinMax detector scaler fitted on ``X``, thresholds from
    ``rng``."""
    Z = X
    for step in steps:
        Z = step.fit(Z).transform(Z)
    init_params(est, Z.shape[1], X.shape[1], rng, seed)
    det = JaxDetector(base_estimator=JaxPipeline([*steps, est]), window=window)
    det.scaler.fit(X)
    det.feature_thresholds_ = rng.uniform(0.05, 0.5, X.shape[1]).astype(np.float32)
    det.aggregate_threshold_ = float(rng.uniform(0.2, 1.0))
    return det


def chain_c(k=K):
    return [jax_scalers.SimpleImputer(strategy="median"), jax_scalers.PCA(n_components=k),
            jax_scalers.MinMaxScaler()]


def chain_a():
    """Chain A of ``test_torch_transform_build.py``: a ``multiplier`` step,
    so no fused chain."""
    return [jax_scalers.SimpleImputer(strategy="median"),
            jax_scalers.FunctionTransformer(func=multiplier, kw_args={"factor": 2}),
            jax_scalers.PCA(n_components=K), jax_scalers.MinMaxScaler()]


def chain_b():
    return [jax_scalers.QuantileTransformer(n_quantiles=20, output_distribution="normal")]


def names(n, prefix="c"):
    return [f"{prefix}{i}" for i in range(n)]


@pytest.fixture(scope="module")
def fleet():
    """MACHINES chain-C detectors (JAX and carried), their requests with
    NaN cells, and the JAX package's results at f32: per machine, the full
    bucket and a subset of two."""
    rng = np.random.default_rng(13)
    jax_models, port, requests = {}, {}, {}
    for i, name in enumerate(names(MACHINES)):
        X = correlated_rows(rng, ROWS)
        jax_models[name] = jax_detector(X, chain_c(), JaxAutoEncoder(kind="feedforward_hourglass"), rng, i)
        port[name] = carry(jax_models[name])
        requests[name] = with_nan(correlated_rows(rng, 40), rng)
    ref_fleet = JaxFleetScorer.from_models(jax_models, dtype="float32")
    subset = {n: requests[n] for n in names(MACHINES)[1::3]}
    return {
        "jax": jax_models, "port": port, "X": requests, "subset": subset,
        "jax_fleet": ref_fleet,
        "ref": {
            "machine": {n: JaxScorer(m, dtype="float32").anomaly_arrays(requests[n]) for n, m in jax_models.items()},
            "bucket": ref_fleet.score_all(requests),
            "subset": ref_fleet.score_all(subset),
        },
    }


@pytest.fixture
def int8_opt_in(monkeypatch):
    monkeypatch.setenv("GORDO_SERVE_INT8", "1")


# -- the stacked kernel's plain version ----------------------------------------

@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_stacked_chain_apply_plain_is_per_machine_bit_for_bit(storage):
    """Stacked steps over (m, n, F) rows are each slot's machine's own chain,
    bit for bit: every step form, the full bucket and a subset through
    ``idx`` with ragged ``n_rows``, rows and stats stored at ``storage``
    and the output at f32 and at ``storage``."""
    rng = np.random.default_rng(5)
    M, n, F, k, Q = 4, 24, 6, 3, 16
    per = []
    for _ in range(M):
        grid = np.sort(rng.standard_normal((Q, k)), axis=0)
        per.append([
            ca.impute_step(rng.standard_normal(F), "cpu"),
            ca.center_step(rng.standard_normal(F), rng.uniform(0.5, 2, F), "cpu"),
            ca.func_step(ca.MUL, 0.5), ca.func_step(ca.EXPM1), ca.func_step(ca.ADD, 1.0), ca.func_step(ca.LOG1P),
            ca.pca_step(rng.standard_normal(F), np.linalg.qr(rng.standard_normal((F, F)))[0][:k], "cpu"),
            ca.quantile_step(grid, True, "cpu"),
        ])
    per = [[ca.Step(s.form, None if s.a is None else s.a.to(storage), None if s.b is None else s.b.to(storage),
                    s.c, s.normal) for s in chain] for chain in per]
    stacked = ca.stack_steps(per)
    assert ca.machines_of(stacked) == M and all(s.stacked for s in stacked)
    X = rng.standard_normal((M, n, F)).astype(np.float32)
    X[rng.random((M, n, F)) < 0.05] = np.nan
    x = torch.from_numpy(X).to(storage)
    for out_dtype in {torch.float32, storage}:
        full = ca.chain_apply(x, stacked, out_dtype=out_dtype)
        assert full.dtype == out_dtype and tuple(full.shape) == (M, n, k)
        for i in range(M):
            np.testing.assert_array_equal(full[i].float().numpy(),
                                          ca.chain_apply(x[i], per[i], out_dtype=out_dtype).float().numpy())
        idx, rows = [3, 0, 3], [n, 7, 1]
        sub = ca.chain_apply(x[idx], stacked, idx=idx, n_rows=rows, out_dtype=out_dtype)
        for slot, (i, r) in enumerate(zip(idx, rows)):
            np.testing.assert_array_equal(sub[slot, :r].float().numpy(), full[i, :r].float().numpy())


def test_stacked_steps_refuse_a_mismatch():
    a = [ca.impute_step(np.zeros(3), "cpu"), ca.pca_step(np.zeros(3), np.eye(3)[:2], "cpu")]
    b = [ca.impute_step(np.zeros(3), "cpu"), ca.pca_step(np.zeros(3), np.eye(3), "cpu")]
    with pytest.raises(ValueError, match="differs between the stacked machines"):
        ca.stack_steps([a, b])
    stacked = ca.stack_steps([a, a])
    x = torch.zeros(3, 5, 3)
    with pytest.raises(ValueError, match="one slot per machine"):
        ca.chain_apply(x, stacked)
    with pytest.raises(ValueError, match="idx and n_rows need stacked steps"):
        ca.chain_apply(x[0], a, idx=[0])


def test_chain_apply_refuses_mixed_storage():
    """Rows and stats share one storage type, and a bfloat16 output comes
    only from bfloat16 storage: the kernel's three instantiations."""
    f32 = [ca.impute_step(np.zeros(3), "cpu"), ca.pca_step(np.zeros(3), np.eye(3)[:2], "cpu")]
    bf16 = [ca.Step(s.form, s.a.to(torch.bfloat16), s.b if s.b is None else s.b.to(torch.bfloat16)) for s in f32]
    x = torch.zeros(5, 3)
    with pytest.raises(TypeError, match="one type"):
        ca.chain_apply(x, bf16)
    with pytest.raises(TypeError, match="one type"):
        ca.chain_apply(x.to(torch.bfloat16), f32)
    with pytest.raises(TypeError, match="bfloat16 only from"):
        ca.chain_apply(x, f32, out_dtype=torch.bfloat16)
    assert ca.chain_apply(x.to(torch.bfloat16), bf16, out_dtype=torch.bfloat16).dtype == torch.bfloat16


# -- stacked serving -----------------------------------------------------------

@pytest.mark.parametrize("route", ["bucket", "subset"])
def test_stacked_serving_matches_jax(fleet, route):
    """Chain C stacks into one bucket of each package (the JAX package's
    ``serve.fleet`` and ``serve.fleet_subset``); the port's bulk and subset
    results within 1e-5 of the JAX package's at f32."""
    assert len(fleet["jax_fleet"].buckets) == 1 and not fleet["jax_fleet"].fallbacks
    scorer = FleetScorer.from_models(fleet["port"], device="cpu", dtype="float32")
    (bucket,) = scorer.buckets
    assert not scorer.fallbacks and sorted(bucket.names) == sorted(fleet["port"])
    assert [s.form for s in bucket.transform_steps] == [ca.IMPUTE, ca.PCA, ca.AFFINE]
    assert all(s.stacked and s.a.shape[0] == MACHINES for s in bucket.transform_steps)
    requests = fleet["X"] if route == "bucket" else fleet["subset"]
    got = scorer.score_all(requests)
    for name in requests:
        for key in OUTPUTS:
            assert r12_nan(fleet["ref"][route][name][key], got[name][key]) <= TOL, (name, key)
        np.testing.assert_array_equal(got[name]["tag-anomaly-thresholds"],
                                      fleet["ref"][route][name]["tag-anomaly-thresholds"])


def test_per_machine_serving_matches_jax(fleet):
    """``serve.score`` over chain C: the port's per-machine scorer within
    1e-5 at f32."""
    for name, model in fleet["port"].items():
        got = CompiledScorer(model, device="cpu", dtype="float32").anomaly_arrays(fleet["X"][name])
        for key in OUTPUTS:
            assert r12_nan(fleet["ref"]["machine"][name][key], got[key]) <= TOL, (name, key)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("route", ["machine", "bucket", "subset"])
def test_reduced_precision_within_bounds_of_jax(fleet, dtype, route, int8_opt_in):
    """bf16 (3% model output, 10% scores) and int8 (25%) against the JAX
    package at f32: the chain's stats leaves stored in bf16 (int8: fake-
    quantised), per machine, full bucket and subset."""
    if route == "machine":
        got = {n: CompiledScorer(m, device="cpu", dtype=dtype).anomaly_arrays(fleet["X"][n])
               for n, m in fleet["port"].items()}
    else:
        scorer = FleetScorer.from_models(fleet["port"], device="cpu", dtype=dtype)
        (bucket,) = scorer.buckets
        assert {t.dtype for s in bucket.transform_steps for t in (s.a, s.b) if t is not None} == {torch.bfloat16}
        got = scorer.score_all(fleet["X"] if route == "bucket" else fleet["subset"])
    for name, out in got.items():
        for key, tol in BOUNDS[dtype].items():
            assert out[key].dtype == np.float32
            assert r12_nan(fleet["ref"][route][name][key], out[key]) <= tol, (name, key)


def test_bucket_residency_halves_at_bf16(fleet):
    """The chain's stacked stats with the weights: half the bytes at bf16
    (the f32 aggregate thresholds aside)."""
    sizes = {}
    for dtype in ("float32", "bfloat16"):
        (bucket,) = FleetScorer.from_models(fleet["port"], device="cpu", dtype=dtype).buckets
        sizes[dtype] = bucket.resident_bytes() - 4 * bucket.agg_thr.numel()
    assert sizes["bfloat16"] * 2 == sizes["float32"]


def test_bucket_int8_quantises_each_stats_leaf_across_the_bucket(fleet, int8_opt_in):
    """At int8 each stacked stats leaf takes one max-abs scale across the
    bucket, bit for bit the reference's ``_fake_quant_int8`` of the
    stacked bf16 leaf (PCA's components are stored transposed); the
    per-machine scorer quantises its own leaf."""
    (bucket,) = FleetScorer.from_models(fleet["port"], device="cpu", dtype="int8").buckets
    steps = [m.base_estimator.steps[:-1] for m in (fleet["jax"][n] for n in bucket.names)]

    def ref(i, key):
        leaf = jnp.stack([jnp.asarray(s[i][1].stats_[key]) for s in steps]).astype(jnp.bfloat16)
        return np.asarray(jax_precision._fake_quant_int8(leaf).astype(jnp.float32))

    imp, pca, mm = bucket.transform_steps
    np.testing.assert_array_equal(imp.a.float().numpy(), ref(0, "fill"))
    np.testing.assert_array_equal(pca.a.float().numpy(), ref(1, "mean"))
    np.testing.assert_array_equal(pca.b.float().numpy(), ref(1, "components").transpose(0, 2, 1))
    np.testing.assert_array_equal(mm.a.float().numpy(), ref(2, "scale"))
    name = bucket.names[0]
    one = CompiledScorer(fleet["port"][name], device="cpu", dtype="int8")._stack.transform_steps[1].b
    comps = jnp.asarray(fleet["jax"][name].base_estimator.steps[1][1].stats_["components"])
    np.testing.assert_array_equal(one[0].float().numpy(),
                                  np.asarray(jax_precision._fake_quant_int8(comps).astype(jnp.float32)).T)


def test_pca_widths_bucket_apart(fleet):
    """Two machines with PCA k = 4 and k = 3 behind the same output width:
    the JAX package's ``_signature`` (its flax module carries the input
    width k) and the port's (PCA's stats shapes) both bucket them apart,
    and each serves as alone."""
    rng = np.random.default_rng(29)
    X = correlated_rows(rng, ROWS)
    jax_k3 = jax_detector(X, chain_c(3), JaxAutoEncoder(kind="feedforward_hourglass"), rng, 9)
    name = names(MACHINES)[0]
    assert jax_signature(jax_extract_chain(jax_k3)) != jax_signature(jax_extract_chain(fleet["jax"][name]))
    models = {name: fleet["port"][name], "k3": carry(jax_k3)}
    scorer = FleetScorer.from_models(models, device="cpu", dtype="float32")
    assert sorted(len(b.names) for b in scorer.buckets) == [1, 1] and not scorer.fallbacks
    Q = with_nan(correlated_rows(rng, 30), rng)
    got = scorer.score_all({name: fleet["X"][name], "k3": Q})
    want = JaxScorer(jax_k3, dtype="float32").anomaly_arrays(Q)
    for key in OUTPUTS:
        assert r12_nan(fleet["ref"]["machine"][name][key], got[name][key]) <= TOL, key
        assert r12_nan(want[key], got["k3"][key]) <= TOL, key


# -- the stream ----------------------------------------------------------------

@pytest.fixture(scope="module")
def smoothed():
    """A chain-C detector with a window of 5 rows, JAX and carried, and 60
    rows to stream (NaN cells in a few)."""
    rng = np.random.default_rng(23)
    X = correlated_rows(rng, ROWS)
    det = jax_detector(X, chain_c(), JaxAutoEncoder(kind="feedforward_hourglass"), rng, 3, window=5)
    return det, carry(det), with_nan(correlated_rows(rng, 60), rng, cells=4)


def test_stream_matches_jax_machine_stream(smoothed):
    """The port's stream of a chain-C detector within 1e-5 of the JAX
    package's ``MachineStream`` (``serve.stream_step`` over the chain)."""
    jax_det, det, rows = smoothed
    jax_ms = JaxMachineStream("c", JaxScorer(jax_det))
    ms = MachineStream("c", CompiledScorer(det, device="cpu"))
    assert (ms.offset, ms.state_rows) == (jax_ms.offset, jax_ms.state_rows) == (0, 5)
    refs, gots = [], []
    for row in rows:
        ref, got = jax_ms.ingest(row), ms.ingest(row)
        assert (ref is None) == (got is None)
        if ref is not None:
            refs.append(ref)
            gots.append(got)
    for key in refs[0]:
        ref = np.stack([np.atleast_1d(r[key]) for r in refs])
        got = np.stack([np.atleast_1d(g[key]) for g in gots])
        assert r12_nan(ref, got) <= TOL, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_stream_is_its_request_path_bit_for_bit(smoothed, dtype, int8_opt_in):
    """Every steady-state verdict of the stream (ring shift, ``chain_apply``
    over the ring, ``stream_step`` over its output) is the request path's
    (``chain_apply``, ``fleet_score``, ``rolling_median``) over the same
    trailing rows, bit for bit, at every serving precision."""
    _, det, rows = smoothed
    scorer = CompiledScorer(det, device="cpu", dtype=dtype)
    ms = MachineStream("c", scorer)
    checked = 0
    for t, row in enumerate(rows, 1):
        got = ms.ingest(row)
        if t >= ms.state_rows:
            want = reference_verdict(scorer, rows[t - ms.state_rows: t])
            for key, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(v), err_msg=f"{key} at {t}")
            checked += 1
    assert checked == len(rows) - ms.state_rows + 1


# -- an LSTM behind a transform chain ------------------------------------------

LOOKBACK = 3


@pytest.fixture(scope="module")
def lstms():
    """An ``LSTMAutoEncoder`` behind chain C (two machines, for a bucket)
    and one behind a QuantileTransformer chain: JAX (init params) and
    carried, with requests."""
    rng = np.random.default_rng(31)
    out = {}
    for name, steps in (("c0", chain_c()), ("c1", chain_c()), ("b", chain_b())):
        X = correlated_rows(rng, ROWS)
        est = JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=LOOKBACK)
        det = jax_detector(X, steps, est, rng, len(out))
        out[name] = (det, carry(det), with_nan(correlated_rows(rng, 30), rng))
    return out


@pytest.mark.parametrize("name", ["c0", "b"])
def test_lstm_behind_a_chain_serves_as_jax(lstms, name):
    """Behind chain C the JAX package serves the LSTM in ``serve.score``,
    behind a QuantileTransformer through the model's own path; the port
    runs ``chain_apply``, ``lstm_layer`` per layer and ``fleet_score``,
    within 1e-5 of either."""
    jax_det, det, Q = lstms[name]
    assert JaxScorer(jax_det).fused == (name != "b")
    want = JaxScorer(jax_det, dtype="float32").anomaly_arrays(Q)
    got = CompiledScorer(det, device="cpu").anomaly_arrays(Q)
    assert got["model-output"].shape == (len(Q) - LOOKBACK + 1, TAGS)
    for key in OUTPUTS:
        assert r12_nan(want[key], got[key]) <= TOL, key


def test_lstm_chain_buckets_and_streams_as_jax(lstms):
    """Two LSTMs behind chain C stack into one bucket of each package
    (within 1e-5 at f32); one streams within 1e-5 of the JAX package's
    ``MachineStream`` and bit for bit its own request path."""
    jax_models = {n: lstms[n][0] for n in ("c0", "c1")}
    requests = {n: lstms[n][2] for n in jax_models}
    ref = JaxFleetScorer.from_models(jax_models, dtype="float32")
    assert len(ref.buckets) == 1 and not ref.fallbacks
    scorer = FleetScorer.from_models({n: lstms[n][1] for n in jax_models}, device="cpu", dtype="float32")
    assert len(scorer.buckets) == 1 and not scorer.fallbacks
    want, got = ref.score_all(requests), scorer.score_all(requests)
    for n in jax_models:
        for key in OUTPUTS:
            assert r12_nan(want[n][key], got[n][key]) <= TOL, (n, key)
    jax_det, det, _ = lstms["c0"]
    rows = with_nan(correlated_rows(np.random.default_rng(3), 20), np.random.default_rng(4))
    jax_ms = JaxMachineStream("c0", JaxScorer(jax_det))
    port_scorer = CompiledScorer(det, device="cpu")
    ms = MachineStream("c0", port_scorer)
    assert (ms.offset, ms.state_rows) == (jax_ms.offset, jax_ms.state_rows) == (LOOKBACK - 1, LOOKBACK)
    refs, gots = [], []
    for t, row in enumerate(rows, 1):
        r, g = jax_ms.ingest(row), ms.ingest(row)
        assert (r is None) == (g is None)
        if r is not None:
            refs.append(r)
            gots.append(g)
        if t >= ms.state_rows:
            v = reference_verdict(port_scorer, rows[t - ms.state_rows: t])
            np.testing.assert_array_equal(g["tag-anomaly-scores"], v["tag-anomaly-scores"])
            np.testing.assert_array_equal(g["total-anomaly-score"], v["total-anomaly-score"])
    for key in refs[0]:
        assert r12_nan(np.stack([np.atleast_1d(r[key]) for r in refs]),
                       np.stack([np.atleast_1d(g[key]) for g in gots])) <= TOL, key


def _definition(steps):
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            *steps,
            {"gordo_tpu.models.estimator.LSTMAutoEncoder": {
                "kind": "lstm_symmetric", "dims": [2], "lookback_window": LOOKBACK, "epochs": 1}},
        ]}}}}


LSTM_CHAINS = {
    "chain_c": _definition([{"gordo_tpu.ops.scalers.SimpleImputer": {"strategy": "median"}},
                            {"gordo_tpu.ops.scalers.PCA": {"n_components": K}},
                            "gordo_tpu.ops.scalers.MinMaxScaler"]),
    "chain_b": _definition([{"gordo_tpu.ops.scalers.QuantileTransformer": {
        "n_quantiles": 20, "output_distribution": "normal"}}]),
}


def test_lstm_behind_a_chain_cross_validates_as_jax(tmp_path):
    """The fold loop (the fleet engine takes neither chain): each fold's
    LSTM fitted on the transformed rows from the JAX package's draws and
    scored through the scorer; thresholds and CV scores within the CV
    bounds (1e-3, explained variance 1e-4) of the JAX package's, which runs
    in a process of its own (a new XLA:CPU LSTM fit late in a worker has
    crashed it)."""
    from gordo_tpu_torch.serializer import from_definition

    X = correlated_rows(np.random.default_rng(37), 90)
    ref = run_in_fresh_process("lstm_chain_cv_reference", {
        "X": X, **{f"definition/{n}": np.array(json.dumps(d)) for n, d in LSTM_CHAINS.items()}}, tmp_path)
    for name, definition in LSTM_CHAINS.items():
        det = from_definition(copy.deepcopy(definition))
        cv = det.cross_validate(X, device="cpu")
        assert r12(ref[f"{name}/thresholds"], det.feature_thresholds_) <= CV_TOL, name
        assert r12(ref[f"{name}/aggregate"], det.aggregate_threshold_) <= CV_TOL, name
        for metric, score in cv["scores"].items():
            bound = EV_TOL if metric == "explained_variance_score" else CV_TOL
            assert r12(ref[f"{name}/scores/{metric}"], score["folds"]) <= bound, (name, metric)
        for i, (_, _, pred) in enumerate(cv["predictions"]):
            assert r12(ref[f"{name}/predictions/{i}"], pred) <= CV_TOL, (name, i)


# -- chains without a fused program --------------------------------------------

@pytest.fixture(scope="module")
def unfused():
    """Chain A and a QuantileTransformer chain before a feedforward
    ``AutoEncoder``: JAX (init params) and carried, with requests."""
    rng = np.random.default_rng(41)
    out = {}
    for name, steps in (("a", chain_a()), ("b", chain_b())):
        X = correlated_rows(rng, ROWS)
        det = jax_detector(X, steps, JaxAutoEncoder(kind="feedforward_hourglass"), rng, 11 + len(out))
        out[name] = (det, carry(det), with_nan(correlated_rows(rng, 30), rng))
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mixed_collection_serves_unfused_chains_at_float32(fleet, unfused, dtype, tmp_path, monkeypatch,
                                                           int8_opt_in):
    """A collection of chain-C machines with a chain A and a chain B
    machine, at ``dtype``: chain C stacks into one bucket at ``dtype``;
    chains A and B are fallbacks served at float32 (the JAX package's
    fallback, the model's own f32 path), equal to the port's f32 scorer
    bit for bit and within 1e-5 of the JAX fallback; their streams are
    refused for want of a fused chain, as the JAX package refuses them."""
    for name, model in fleet["port"].items():
        serializer.dump(model, str(tmp_path / name))
    for name, (_, model, _) in unfused.items():
        serializer.dump(model, str(tmp_path / name))
    monkeypatch.setenv("GORDO_SERVE_DTYPE", dtype)
    collection = ModelCollection.from_directory(str(tmp_path), device="cpu")
    scorer = collection.fleet_scorer
    assert scorer.dtype == dtype and len(scorer.buckets) == 1 and sorted(scorer.fallbacks) == ["a", "b"]
    assert scorer.buckets[0].dtype == dtype
    requests = {**fleet["X"], **{n: Q for n, (_, _, Q) in unfused.items()}}
    got = scorer.score_all(requests)
    for name, (jax_det, model, Q) in unfused.items():
        assert scorer.fallbacks[name]._stack.dtype == "float32"
        assert collection.entries[name].scorer._stack.dtype == "float32"
        assert not JaxScorer(jax_det, dtype=dtype).fused
        want = JaxScorer(jax_det, dtype=dtype).anomaly_arrays(Q)
        f32 = CompiledScorer(model, device="cpu", dtype="float32").anomaly_arrays(Q)
        for key in OUTPUTS:
            np.testing.assert_array_equal(got[name][key], f32[key])
            assert r12_nan(want[key], got[name][key]) <= TOL, (name, key)
        with pytest.raises(JaxStreamUnsupported, match="no fused anomaly chain"):
            JaxMachineStream(name, JaxScorer(jax_det))
        with pytest.raises(StreamUnsupported, match="no fused anomaly chain"):
            collection.stream_hub.ingest_rows(name, collection.entries[name].scorer, Q[:2], dtype=dtype)
    for name in fleet["port"]:
        for key, tol in BOUNDS[dtype].items():
            assert r12_nan(fleet["ref"]["bucket"][name][key], got[name][key]) <= tol, (name, key)


# ---------------------------------------------------------------------------
# chain_apply's launch plans (the kernel's paths; checked without a card)
# ---------------------------------------------------------------------------

_CHAIN_C_FORMS = [ca.IMPUTE, ca.PCA, ca.AFFINE]


@pytest.mark.parametrize("forms, ws, path", [
    (_CHAIN_C_FORMS, [10, 10, 8, 8], ca.PATH_ROWS),                       # chain C
    ([ca.IMPUTE, ca.MUL, ca.PCA, ca.AFFINE], [10, 10, 10, 8, 8], ca.PATH_ROWS),  # chain A
    ([ca.PCA_INV], [8, 10], ca.PATH_ROWS),
    ([ca.PCA], [16, 16], ca.PATH_ROWS),
    ([ca.PCA], [17, 16], ca.PATH_TILE),                                    # past the row path's width
    ([ca.PCA_INV], [128, 128], ca.PATH_TILE),
    ([ca.IMPUTE, ca.QUANTILE], [10, 10, 10], ca.PATH_TILE),
    ([ca.QUANTILE_INV], [10, 10], ca.PATH_TILE),
    ([ca.PCA, ca.QUANTILE], [10, 4, 4], ca.PATH_TILE),
    ([ca.CENTER, ca.MUL, ca.EXPM1, ca.ADD, ca.LOG1P, ca.IMPUTE], [10] * 7, ca.PATH_ELEMENTWISE),
    ([ca.AFFINE], [128, 128], ca.PATH_ELEMENTWISE),
])
def test_chain_apply_plan_path(forms, ws, path):
    assert ca.launch_plan(forms, ws, 512, 2048, 132).path == path


@pytest.mark.parametrize("scaler", ["MinMaxScaler", "StandardScaler", "RobustScaler"])
@pytest.mark.parametrize("m, n, tags", [(1, 2048, 10), (512, 2048, 10), (1, 4096, 128), (1, 1, 3)])
def test_every_affine_inverse_takes_the_elementwise_path(scaler, m, n, tags):
    """A TransformedTargetRegressor's target inverse (MinMax as CENTER,
    Standard and Robust as AFFINE) runs on the elementwise path, in tiles
    of about EW_TILE_VALUES values, a block a tile."""
    from gordo_tpu_torch.ops import scalers as port_scalers

    X = np.random.default_rng(3).normal(size=(40, tags)).astype(np.float32)
    steps = getattr(port_scalers, scaler)().fit(X, device="cpu").inverse_steps("cpu")
    assert [s.form for s in steps] in ([ca.CENTER], [ca.AFFINE]) and all(s.inverse for s in steps)
    plan = ca.launch_plan([s.form for s in steps], ca.widths(steps, tags), m, n, 132)
    assert plan.path == ca.PATH_ELEMENTWISE
    assert plan.blocks_per_slot == -(-n // plan.rows_per_tile)
    assert plan.rows_per_tile * tags <= max(ca.EW_TILE_VALUES + tags, tags)


@pytest.mark.parametrize("m, n, f, elem", [(512, 2048, 10, 4), (512, 2048, 10, 2), (1, 576, 10, 4),
                                           (1, 1, 16, 4), (64, 99_234, 16, 4)])
def test_chain_apply_row_plan_fits_a_block(m, n, f, elem):
    """The row path's tiles: whole warps of rows, at most a block's
    threads, a run of tiles a block (ROW_BLOCKS_PER_SM blocks an SM in
    all); its shared memory (the stats, the rows, two raw tiles, as
    ``rows_smem`` counts it) within 232,448 bytes."""
    plan = ca.launch_plan(_CHAIN_C_FORMS, [f, f, 8, 8], m, n, 132)
    assert plan.path == ca.PATH_ROWS
    R = plan.rows_per_tile
    assert R % 32 == 0 and ca.ROW_THREADS_MIN <= R <= ca.THREADS
    tiles = -(-n // R)
    assert plan.blocks_per_slot == min(tiles, max(1, ca.ROW_BLOCKS_PER_SM * 132 // m))
    stats = 4 * ca.MAX_STEPS * ca.NARROW_MAX * (ca.NARROW_MAX + 1)
    smem = stats + 4 * R * (ca.NARROW_MAX + 1) + 2 * (-(-R * f * elem // 16) * 16)
    assert smem <= 232_448

