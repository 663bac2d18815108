"""Reduced-precision serving (K10) of the port against the JAX package.

- The dtype policy (``canonical``, ``serve_dtype``, the int8 opt-in) is
  the JAX module's, error texts included.
- ``fake_quant_plain`` is ``_fake_quant_int8`` bit for bit, on float32 and
  on bfloat16 leaves (the JAX function rounds every bf16 operation).
- The port serving at bf16 and at int8 is held to the JAX package at f32
  and at the same dtype, with the r12 bounds of
  ``tests/test_serving_precision.py`` (max |ref - port| / max |ref| per
  machine and output: model output 3%, scores 10%; int8 25%), per machine
  (``CompiledScorer``), full bucket and one-machine subset
  (``FleetScorer``), for feedforward, smoothed and LSTM detectors.
  Measured on the CPU (the kernels' plain versions), the worst over every
  machine, route and output: bf16 against JAX f32 6.5e-3 (model output)
  and 4.9e-3 (scores), against JAX bf16 1.1e-3 and 3.4e-3; int8 against
  JAX f32 1.9e-2 and 1.0e-2, against JAX int8 1.5e-2 and 8.4e-3.  The port
  stores bf16 and computes in f32; the JAX package computes its scaler
  and detector arithmetic in bf16.
- A bucket's int8 scale spans its stacked leaf, as the reference's bucket
  program's does; the per-machine scorer's spans the machine's leaf.

JAX models are ``module.init`` params with MinMax stats fitted by hand
(``tests/torch_parity.py::init_detector``), carried across with
``gordo_tpu_torch.convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.serve import precision as jax_precision
from gordo_tpu.serve.fleet_scorer import FleetScorer as JaxFleetScorer
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu_torch import serializer
from gordo_tpu_torch.kernels import fake_quant as fq
from gordo_tpu_torch.serve import precision
from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
from gordo_tpu_torch.serve.scorer import CompiledScorer, _extract_chain
from gordo_tpu_torch.serve.server import ModelCollection
from torch_parity import carry, init_detector

TAGS = 3
ROWS = 40
#: the r12 bounds (tests/test_serving_precision.py:100-105, :295)
BOUNDS = {
    "bfloat16": {"model-output": 0.03, "tag-anomaly-scores": 0.10,
                 "total-anomaly-score": 0.10, "anomaly-confidence": 0.10},
    "int8": {k: 0.25 for k in ("model-output", "tag-anomaly-scores",
                              "total-anomaly-score", "anomaly-confidence")},
}
KINDS = ("feedforward", "smoothed", "lstm")


def _bf16_bits(a) -> np.ndarray:
    """The raw 16 bits of a bf16 array (JAX) or tensor (torch)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def assert_within(ref: dict, got: dict, bounds: dict, label: str):
    for k, tol in bounds.items():
        if k not in ref:
            continue
        r, g = np.asarray(ref[k], np.float64), np.asarray(got[k])
        assert g.dtype == np.float32, (label, k, g.dtype)
        assert r.shape == g.shape, (label, k)
        err = float(np.abs(r - g).max() / max(np.abs(r).max(), 1e-6))
        assert err <= tol, f"{label} {k}: {err:.4%} over {tol:.0%}"


# -- the dtype policy ----------------------------------------------------------

@pytest.mark.parametrize("name", ["float32", "fp32", "F32", "bfloat16", " bf16 ", "int8", "i8",
                                  "float8", "fp16", ""])
def test_canonical_is_the_jax_modules(name):
    try:
        ref = jax_precision.canonical(name)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            precision.canonical(name)
        assert str(got.value) == str(exc)
    else:
        assert precision.canonical(name) == ref


@pytest.mark.parametrize("env,default,opt_in", [
    (None, None, None), (None, "bf16", None), ("fp32", "bfloat16", None), ("bf16", None, None),
    ("float8", None, None), ("int8", None, None), ("int8", None, "1"), ("int8", None, "yes"),
    (None, "i8", None), (None, "i8", "on"), ("", "int8", "0"),
])
def test_serve_dtype_resolves_as_the_jax_module(monkeypatch, env, default, opt_in):
    for key, value in (("GORDO_SERVE_DTYPE", env), ("GORDO_SERVE_INT8", opt_in)):
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, value)
    try:
        ref = jax_precision.serve_dtype(default)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            precision.serve_dtype(default)
        assert str(got.value) == str(exc)
    else:
        assert precision.serve_dtype(default) == ref


def test_storage_dtype_is_the_jax_modules():
    for name in precision.SUPPORTED:
        ref = jax_precision.storage_np_dtype(name)
        got = precision.storage_dtype(name)
        assert (ref is None) == (got is None)
        if got is not None:
            assert got == torch.bfloat16 and ref.name == "bfloat16"


# -- fake_quant ----------------------------------------------------------------

def _leaves(rng):
    yield rng.standard_normal((7,)).astype(np.float32)
    yield (3.0 * rng.standard_normal((4, 6, 8))).astype(np.float32)
    yield (1e-3 * rng.standard_normal((2, 5))).astype(np.float32)
    yield np.zeros((3, 2), np.float32)
    yield rng.uniform(-1, 1, (64, 10, 5)).astype(np.float32)  # a stacked bucket leaf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_plain_is_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    for a in _leaves(rng):
        x = jnp.asarray(a) if dtype == "float32" else jnp.asarray(a).astype(jnp.bfloat16)
        ref = _bf16_bits(jax_precision._fake_quant_int8(x))
        t = torch.from_numpy(np.array(x.astype(jnp.float32)))
        if dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        got = fq.fake_quant_plain(t)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == a.shape
        np.testing.assert_array_equal(_bf16_bits(got), ref)
        # and through the wrapper, which takes the plain version on the CPU
        np.testing.assert_array_equal(_bf16_bits(fq.fake_quant(t)), ref)


def test_fake_quant_groups_are_separate_leaves():
    """An LSTM's four gate blocks are separate leaves of the reference."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 5, 4 * 6)).astype(np.float32)
    a[..., 6:12] *= 10.0  # gate blocks of different ranges
    ref = np.concatenate([_bf16_bits(jax_precision._fake_quant_int8(jnp.asarray(g)))
                          for g in np.split(a, 4, axis=-1)], axis=-1)
    got = fq.fake_quant_plain(torch.from_numpy(a), groups=4)
    np.testing.assert_array_equal(_bf16_bits(got), ref)
    assert not np.array_equal(_bf16_bits(fq.fake_quant_plain(torch.from_numpy(a))), ref)
    with pytest.raises(ValueError, match="groups"):
        fq.fake_quant_plain(torch.from_numpy(a), groups=5)


def test_fake_quant_keeps_nan_as_jax_does():
    a = np.array([1.0, np.nan, -2.0], np.float32)
    ref = np.asarray(jax_precision._fake_quant_int8(jnp.asarray(a)).astype(jnp.float32))
    got = fq.fake_quant_plain(torch.from_numpy(a)).float().numpy()
    assert np.isnan(ref).all() and np.isnan(got).all()


def _jax_leaf_bits(a: np.ndarray, bf16: bool, groups: int = 1) -> np.ndarray:
    """``_fake_quant_int8`` of each of a leaf's ``groups`` column blocks."""
    x = jnp.asarray(a)
    if bf16:
        x = x.astype(jnp.bfloat16)
    return np.concatenate([_bf16_bits(jax_precision._fake_quant_int8(g))
                           for g in jnp.split(x, groups, axis=-1)], axis=-1)


def test_fake_quant_many_is_jax_leaf_by_leaf():
    """One call over a load's leaves (f32 and bf16, four gate blocks, an
    all-zero leaf at the 1e-12 floor, one element, a NaN) gives each leaf
    ``_fake_quant_int8``'s bits (NaN by place), into given outputs too."""
    rng = np.random.default_rng(5)
    gates = rng.standard_normal((4, 6, 4 * 5)).astype(np.float32)
    gates[..., 5:10] *= 20.0
    nan_leaf = rng.standard_normal((3, 7)).astype(np.float32)
    nan_leaf[1, 2] = np.nan
    cases = [  # (leaf, bf16, groups)
        (rng.standard_normal((64, 10, 8)).astype(np.float32), False, 1),
        ((1e-3 * rng.standard_normal((64, 8))).astype(np.float32), True, 1),
        (gates, False, 4),
        (gates, True, 4),
        (np.zeros((5, 3), np.float32), False, 1),
        (np.zeros((5, 3), np.float32), True, 1),
        (np.array([0.37], np.float32), False, 1),
        (nan_leaf, True, 1),
    ]
    leaves = []
    for a, bf16, _ in cases:
        t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) if bf16 else a)
        leaves.append(t.to(torch.bfloat16) if bf16 else t)
    groups = [g for _, _, g in cases]
    got = fq.fake_quant_many(leaves, groups)
    outs = [torch.empty(t.shape, dtype=torch.bfloat16) for t in leaves]
    assert fq.fake_quant_many(leaves, groups, out=outs) == outs
    def nan(bits):  # a bf16 NaN: every exponent bit set, a mantissa bit set
        return ((bits & 0x7F80) == 0x7F80) & ((bits & 0x7F) != 0)

    for (a, bf16, g), t, o in zip(cases, got, outs):
        want = _jax_leaf_bits(a, bf16, g)
        for bits in (_bf16_bits(t), _bf16_bits(o)):
            np.testing.assert_array_equal(nan(bits), nan(want))
            np.testing.assert_array_equal(bits[~nan(bits)], want[~nan(want)])
    assert np.isnan(got[-1].float().numpy()).all()  # a NaN spreads to every output
    assert not got[4].float().any()
    assert fq.fake_quant_many([]) == []
    with pytest.raises(ValueError, match="one groups count"):
        fq.fake_quant_many(leaves[:2], [1])


def test_launch_units_cut_at_the_kernels_limits():
    """A load's units go big first (a cluster each), then the rest, in as
    few launches as MAX_UNITS and MAX_LEAVES allow: one for a bucket."""
    units = [(0, fq.BIG + 1), (1, 10), (2, fq.BIG), (3, 4 * fq.BIG)]
    assert fq.launch_units(units) == [[0, 3, 1, 2]]
    assert [len(s) for s in fq.launch_units([(i, 10) for i in range(fq.MAX_LEAVES + 2)])] == [fq.MAX_LEAVES, 2]
    assert [len(s) for s in fq.launch_units([(i // 4, 10) for i in range(fq.MAX_UNITS + 1)])] == [fq.MAX_UNITS, 1]


@pytest.mark.parametrize("kind", ["feedforward", "lstm"])
def test_stack_quantises_its_leaves_in_one_call(models, kind, monkeypatch, int8_opt_in):
    """A stack (a bucket, and each machine's scorer) quantises all its float
    leaves (layers or cells with their gates, head, scaler and detector
    stats) in one ``fake_quant_many`` call, each leaf as ``fake_quant``."""
    calls = []

    def counted(leaves, groups=None, out=None):
        calls.append((len(leaves), list(groups)))
        return real(leaves, groups, out=out)

    real = fq.fake_quant_many
    monkeypatch.setattr(fq, "fake_quant_many", counted)
    ms = models["port"][kind]
    fleet = FleetScorer.from_models(dict(zip(_names(kind, len(ms)), ms)), device="cpu", dtype="int8")
    (bucket,) = fleet.buckets
    assert len(calls) == 1
    n_leaves, groups = calls[0]
    if kind == "lstm":
        assert groups[:3 * len(bucket.cells)] == [4] * (3 * len(bucket.cells))
        first = bucket.cells[0][0]
    else:
        assert n_leaves == 2 * len(bucket.layers) + 4 and set(groups) == {1}
        first = bucket.layers[0][0]
    chains = [_extract_chain(m) for m in ms]
    stacked = np.stack([c["cells"][0][0] if kind == "lstm" else c["layers"][0][0] for c in chains])
    want = fq.fake_quant(torch.from_numpy(stacked.astype(np.float32)).to(torch.bfloat16),
                         4 if kind == "lstm" else 1)
    assert torch.equal(first.view(torch.int16), want.view(torch.int16))
    calls.clear()
    CompiledScorer(ms[0], device="cpu", dtype="int8")
    assert len(calls) == 1 and calls[0][0] == n_leaves
    calls.clear()
    CompiledScorer(ms[0], device="cpu", dtype="bfloat16")
    assert not calls


# -- serving at reduced precision ----------------------------------------------

@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(17)
    X = rng.standard_normal((200, TAGS)).astype(np.float32)
    jax_models = {
        "feedforward": [init_detector(JaxAutoEncoder(kind="feedforward_hourglass"), X, rng, seed=s)
                        for s in (1, 2, 3)],
        "smoothed": [init_detector(JaxAutoEncoder(kind="feedforward_hourglass"), X, rng, window=5, seed=s)
                     for s in (4, 5)],
        "lstm": [init_detector(JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=4), X, rng, seed=s)
                 for s in (6, 7)],
    }
    port = {kind: [carry(m) for m in ms] for kind, ms in jax_models.items()}
    inputs = {kind: [rng.standard_normal((ROWS, TAGS)).astype(np.float32) for _ in ms]
              for kind, ms in jax_models.items()}
    return {"jax": jax_models, "port": port, "X": inputs}


def _names(kind, n):
    return [f"{kind}-{i}" for i in range(n)]


@pytest.fixture(scope="module")
def jax_results(models):
    """The JAX package's per-machine, bucket and subset results at every
    dtype, per kind."""
    out = {}
    for kind in KINDS:
        ms, Xs = models["jax"][kind], models["X"][kind]
        names = _names(kind, len(ms))
        for dtype in precision.SUPPORTED:
            fleet = JaxFleetScorer.from_models(dict(zip(names, ms)), dtype=dtype)
            out[kind, dtype] = {
                "machine": [JaxScorer(m, dtype=dtype).anomaly_arrays(X) for m, X in zip(ms, Xs)],
                "bucket": fleet.score_all(dict(zip(names, Xs))),
                "subset": fleet.score_all({names[-1]: Xs[-1]}),
            }
    return out


@pytest.fixture
def int8_opt_in(monkeypatch):
    monkeypatch.setenv("GORDO_SERVE_INT8", "1")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reduced_precision_within_bounds_of_jax(models, jax_results, kind, dtype, int8_opt_in):
    ms, Xs = models["port"][kind], models["X"][kind]
    names = _names(kind, len(ms))
    fleet = FleetScorer.from_models(dict(zip(names, ms)), device="cpu", dtype=dtype)
    assert fleet.dtype == dtype and not fleet.fallbacks
    (bucket,) = fleet.buckets
    assert {t.dtype for layer in bucket.layers for t in layer} == {torch.bfloat16}
    got = {
        "machine": [CompiledScorer(m, device="cpu", dtype=dtype).anomaly_arrays(X) for m, X in zip(ms, Xs)],
        "bucket": fleet.score_all(dict(zip(names, Xs))),
        "subset": fleet.score_all({names[-1]: Xs[-1]}),
    }
    for ref_dtype in ("float32", dtype):
        ref = jax_results[kind, ref_dtype]
        for i in range(len(ms)):
            assert_within(ref["machine"][i], got["machine"][i], BOUNDS[dtype], f"{kind} machine {i} vs jax {ref_dtype}")
            assert_within(ref["bucket"][names[i]], got["bucket"][names[i]], BOUNDS[dtype],
                          f"{kind} bucket {i} vs jax {ref_dtype}")
        assert_within(ref["subset"][names[-1]], got["subset"][names[-1]], BOUNDS[dtype],
                      f"{kind} subset vs jax {ref_dtype}")


@pytest.mark.parametrize("kind", KINDS)
def test_float32_serving_is_unchanged(models, kind):
    """At f32 the stack is float32 and the scores are those of a scorer
    made without a dtype (the default resolves to float32)."""
    for m, X in zip(models["port"][kind], models["X"][kind]):
        ref = CompiledScorer(m, device="cpu").anomaly_arrays(X)
        scorer = CompiledScorer(m, device="cpu", dtype="float32")
        assert scorer.dtype == "float32" and scorer._stack.layers[0][0].dtype == torch.float32
        got = scorer.anomaly_arrays(X)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_bucket_int8_scale_spans_the_stacked_leaf(models, int8_opt_in):
    """The bucket quantises each stacked leaf (stored bf16 first) with one
    scale across its machines, bit for bit the reference's bucket leaves;
    the per-machine scorer quantises each machine's f32 leaf."""
    for kind in ("feedforward", "lstm"):
        jax_ms, ms = models["jax"][kind], models["port"][kind]
        fleet = FleetScorer.from_models(dict(zip(_names(kind, len(ms)), ms)), device="cpu", dtype="int8")
        (bucket,) = fleet.buckets
        params = [m.base_estimator._final.params_ for m in jax_ms]
        if kind == "feedforward":
            leaf = jnp.stack([jnp.asarray(p["dense_0"]["kernel"]) for p in params])
            ref = _bf16_bits(jax_precision._fake_quant_int8(leaf.astype(jnp.bfloat16)))
            got = bucket.layers[0][0]
            machine = lambda i: CompiledScorer(ms[i], device="cpu", dtype="int8")._stack.layers[0][0]  # noqa: E731
            one = _bf16_bits(jax_precision._fake_quant_int8(jnp.asarray(params[0]["dense_0"]["kernel"])))
        else:
            cell = "OptimizedLSTMCell_0"
            ref = np.concatenate([
                _bf16_bits(jax_precision._fake_quant_int8(
                    jnp.stack([jnp.asarray(p[cell][f"i{g}"]["kernel"]) for p in params]).astype(jnp.bfloat16)))
                for g in "ifgo"], axis=-1)
            got = bucket.cells[0][0]
            machine = lambda i: CompiledScorer(ms[i], device="cpu", dtype="int8")._stack.cells[0][0]  # noqa: E731
            one = np.concatenate([_bf16_bits(jax_precision._fake_quant_int8(jnp.asarray(params[0][cell][f"i{g}"]["kernel"])))
                                  for g in "ifgo"], axis=-1)
        np.testing.assert_array_equal(_bf16_bits(got), ref)
        np.testing.assert_array_equal(_bf16_bits(machine(0))[0], one)
        assert not np.array_equal(_bf16_bits(machine(0))[0], ref[0])


def test_collection_serves_at_one_precision(models, tmp_path, monkeypatch):
    names = []
    for kind in KINDS:
        for i, m in enumerate(models["port"][kind]):
            serializer.dump(m, str(tmp_path / f"{kind}-{i}"))
            names.append(f"{kind}-{i}")
    monkeypatch.setenv("GORDO_SERVE_DTYPE", "bf16")
    collection = ModelCollection.from_directory(str(tmp_path), device="cpu")
    assert collection.serve_dtype == "bfloat16"
    assert {e.scorer.dtype for e in collection.entries.values()} == {"bfloat16"}
    fleet = collection.fleet_scorer
    assert fleet.dtype == "bfloat16" and len(fleet.buckets) == len(KINDS)
    f32 = FleetScorer.from_models({n: e.model for n, e in collection.entries.items()}, device="cpu",
                                  dtype="float32")
    for b16, b32 in zip(fleet.buckets, f32.buckets):
        # halved residency, but for the f32 thresholds
        thr = 4 * b32.agg_thr.numel()
        assert b16.resident_bytes() - thr == (b32.resident_bytes() - thr) // 2
    # an explicit dtype beats the environment; int8 needs the opt-in
    assert ModelCollection.from_directory(str(tmp_path), device="cpu", serve_dtype="float32").serve_dtype == "float32"
    monkeypatch.setenv("GORDO_SERVE_DTYPE", "int8")
    monkeypatch.delenv("GORDO_SERVE_INT8", raising=False)
    with pytest.raises(ValueError, match="opt-in"):
        ModelCollection.from_directory(str(tmp_path), device="cpu")


def test_model_methods_stay_float32(models, monkeypatch):
    """``detector.anomaly`` is the model's own f32 computation, whatever the
    serving dtype in the environment."""
    monkeypatch.setenv("GORDO_SERVE_DTYPE", "bfloat16")
    m, X = models["port"]["feedforward"][0], models["X"]["feedforward"][0]
    ref = CompiledScorer(m, device="cpu", dtype="float32").anomaly_arrays(X)
    got = m.anomaly(X, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_consecutive_scalers_fold_after_their_cast(dtype, int8_opt_in):
    """Two pipeline scalers: each one's stats are cast (quantised) as the
    reference casts each leaf, then applied in turn as the kernel loads
    each value, each step in its own form (no fold); at f32 the
    scores are the JAX package's within the serving bound (1e-5), at
    reduced precision within the r12 bounds of JAX at f32 and at ``dtype``."""
    from gordo_tpu.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_tpu.ops.scalers import MinMaxScaler
    from gordo_tpu.pipeline import Pipeline
    from torch_parity import init_estimator, r12

    rng = np.random.default_rng(31)
    X = rng.standard_normal((200, TAGS)).astype(np.float32)
    first, second = MinMaxScaler(), MinMaxScaler()
    first.fit(X)
    second.fit(np.asarray(first.transform(X)) * 3.0 - 1.0)
    est = init_estimator(JaxAutoEncoder(kind="feedforward_hourglass"), TAGS, rng, seed=8)
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([first, second, est]))
    det.scaler.fit(X)
    det.feature_thresholds_ = rng.uniform(0.05, 0.5, TAGS).astype(np.float32)
    det.aggregate_threshold_ = 0.4
    port = carry(det)
    rows = rng.standard_normal((ROWS, TAGS)).astype(np.float32)
    got = CompiledScorer(port, device="cpu", dtype=dtype).anomaly_arrays(rows)
    if dtype == "float32":
        ref = JaxScorer(det, dtype="float32").anomaly_arrays(rows)
        for k in ref:
            assert r12(ref[k], got[k]) <= 1e-5, k
        return
    for ref_dtype in ("float32", dtype):
        assert_within(JaxScorer(det, dtype=ref_dtype).anomaly_arrays(rows), got, BOUNDS[dtype],
                      f"two scalers vs jax {ref_dtype}")
