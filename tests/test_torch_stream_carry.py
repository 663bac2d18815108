"""The stream's carried tag scores (K9, ``gordo_tpu_torch/serve/stream.py``,
``kernels/stream_step.py``).

A stream carries the tag scores of its W scored rows beside the ring, so
that a step scores its new row (or an LSTM's newest window) alone; the
first step after the stream binds or rebinds scores every row and primes
them.  Here, on the CPU (plain versions), for a windowed feedforward and
an LSTM ``ae`` detector at f32 and bf16 storage:

- a stream's carried verdicts and tag scores are, at every row (warm-up,
  the first valid row, steady state), bit for bit those of a twin that
  scores every row at every step (the full-window mode), also across a
  precision rebind, a geometry change re-primed from the host mirror and
  a generation flip that keeps the ring;
- the port's stream is within 1e-5 of the JAX package's ``MachineStream``
  (f32, as ``tests/test_torch_stream.py`` bounds it);
- the kernel's median, a bitonic network over each series (in registers,
  or in shared memory past 1,024 values, the values past W taken as
  +inf), emulated step for step in numpy, is ``masked_nanmedian``'s bit
  for bit on series with NaNs, ties and every value masked, for windows
  up to the largest the step takes.
"""

import numpy as np
import pytest
import torch

from gordo_tpu.models.estimator import AutoEncoder as JaxAutoEncoder
from gordo_tpu.models.estimator import LSTMAutoEncoder as JaxLSTMAutoEncoder
from gordo_tpu.serve.scorer import CompiledScorer as JaxScorer
from gordo_tpu.serve.stream import MachineStream as JaxMachineStream
from gordo_tpu_torch.kernels import stream_step as sk
from gordo_tpu_torch.serve.scorer import CompiledScorer
from gordo_tpu_torch.serve.stream import MachineStream, StreamHub
from torch_parity import carry, init_detector, r12

TAGS = 3
TOL = 1e-5
DETECTORS = {
    "ff": (lambda: JaxAutoEncoder(kind="feedforward_hourglass"), 5),
    "lstm-ae": (lambda: JaxLSTMAutoEncoder(kind="lstm_hourglass", lookback_window=4), 5),
}
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(29)
    X = rng.standard_normal((200, TAGS)).astype(np.float32)
    jax_models = {name: init_detector(make(), X, rng, window=window, seed=i)
                  for i, (name, (make, window)) in enumerate(DETECTORS.items())}
    # a second generation of each (same window geometry), and a feedforward
    # detector with another window
    for i, (name, (make, window)) in enumerate(DETECTORS.items()):
        jax_models[f"{name}-b"] = init_detector(make(), X, rng, window=window, seed=20 + i)
    jax_models["ff-window-8"] = init_detector(JaxAutoEncoder(kind="feedforward_hourglass"), X, rng,
                                              window=8, seed=31)
    rows = (np.sin(0.2 * np.arange(40))[:, None] + 0.3 * rng.standard_normal((40, TAGS))).astype(np.float32)
    rows[17, 1] = np.nan  # a NaN tag score in the window for a while
    return {"jax": jax_models, "port": {k: carry(m) for k, m in jax_models.items()}, "rows": rows}


def _scorer(models, name, dtype):
    return CompiledScorer(models["port"][name], device="cpu", dtype=dtype)


def _same(a, b) -> bool:
    return np.asarray(a, np.float32).tobytes() == np.asarray(b, np.float32).tobytes()


def _same_numbers(a, b) -> bool:
    """Bit for bit where a value is a number, NaN where the other is NaN (a
    NaN's payload is not a result: the plain versions' vector and scalar
    paths may carry different ones)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))) and _same(a[~nan], b[~nan])


def _step_both(carried: MachineStream, full: MachineStream, row: np.ndarray):
    """One row into the carried stream and into its twin forced to score
    every row; both verdicts (None in warm-up) and carried tags compared."""
    full._primed = False
    got, want = carried.ingest(row), full.ingest(row)
    assert (got is None) == (want is None)
    if got is not None:
        assert set(got) == set(want)
        for k in want:
            assert _same(got[k], want[k]), k
    assert _same_numbers(carried._tags[carried._cur].numpy(), full._tags[full._cur].numpy())
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(DETECTORS))
def test_carried_steps_are_the_full_window_bit_for_bit(models, name, dtype):
    scorer = _scorer(models, name, dtype)
    carried, full = MachineStream("carried", scorer), MachineStream("full", scorer)
    offset, H = carried.offset, carried.state_rows
    seen = {"warm_up": 0, "first_valid": 0, "steady": 0}
    for t, row in enumerate(models["rows"], start=1):
        verdict = _step_both(carried, full, row)
        if t <= offset:
            assert verdict is None
            seen["warm_up"] += 1
        elif t == offset + 1:
            seen["first_valid"] += 1
        elif t >= H:
            seen["steady"] += 1
    assert carried._primed and seen["first_valid"] == 1 and seen["steady"] >= 20
    assert seen["warm_up"] == offset


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(DETECTORS))
def test_carried_steps_after_a_rebind_are_the_full_window(models, name, dtype):
    """A generation flip (same geometry, the ring kept), a precision
    rebind and, for the feedforward detector, a geometry change re-primed
    from the mirror: each primes the tags again at the next step."""
    X = models["rows"]
    first, second = _scorer(models, name, dtype), _scorer(models, f"{name}-b", dtype)
    other = "bfloat16" if dtype == "float32" else "float32"
    carried, full = MachineStream("carried", first), MachineStream("full", first)
    rebinds = [(10, second, None), (18, _scorer(models, f"{name}-b", other), None)]
    if name == "ff":
        rebinds.append((26, _scorer(models, "ff-window-8", dtype), None))
    at = dict((t, (scorer, d)) for t, scorer, d in rebinds)
    for t, row in enumerate(X, start=1):
        if t in at:
            scorer, d = at[t]
            for ms in (carried, full):
                ms.rebind(scorer, d)
            assert not carried._primed
        _step_both(carried, full, row)
        assert carried._primed
    assert carried.scorer is rebinds[-1][1]


def test_a_hub_stream_primes_once_then_carries(models):
    """Through the hub: one full-window step when the stream binds, then
    carried steps; a new scorer object (a generation flip) primes again."""
    hub = StreamHub()
    first, second = _scorer(models, "ff", "float32"), _scorer(models, "ff-b", "float32")
    X = models["rows"]
    primed = []
    for t, row in enumerate(X[:12], start=1):
        scorer = first if t <= 6 else second
        ms = hub.stream_for("m", scorer)
        primed.append(ms._primed)
        hub.ingest_rows("m", scorer, row)
    assert primed == [False] + [True] * 5 + [False] + [True] * 5


@pytest.mark.parametrize("name", list(DETECTORS))
def test_carried_stream_matches_jax_machine_stream(models, name):
    jax_ms = JaxMachineStream("parity", JaxScorer(models["jax"][name]))
    ms = MachineStream("parity", _scorer(models, name, "float32"))
    refs, gots = [], []
    for row in models["rows"]:
        ref, got = jax_ms.ingest(row), ms.ingest(row)
        assert (ref is None) == (got is None)
        if ref is not None:
            refs.append(ref)
            gots.append(got)
    assert ms._primed and len(refs) >= 30
    for k in refs[0]:
        ref = np.stack([np.atleast_1d(r[k]) for r in refs])
        got = np.stack([np.atleast_1d(g[k]) for g in gots])
        assert r12(ref, got) <= TOL, (k, r12(ref, got))


# -- the kernel's sorted median, emulated --------------------------------------

def _sort_values(series: np.ndarray, first: int):
    """The kernel's `sort_value`: masked (before `first`) and NaN values
    as +inf, and the count of the others."""
    v = series.astype(np.float32).copy()
    masked = np.arange(len(v)) < first
    v[masked | np.isnan(v)] = np.inf
    return v, int(np.sum(~masked & ~np.isnan(series)))


def _network_in_registers(v: np.ndarray, k_lane: int) -> np.ndarray:
    """``median_in_registers<K>``'s network on the series padded with +inf
    to 32 K values: stage k pairs e with e ^ (k - 1), then e with e ^ j
    for j = k / 4 .. 1, the smaller value to the lower index."""
    P = 32 * k_lane
    s = np.full(P, np.inf, np.float32)
    s[: len(v)] = v
    e = np.arange(P)
    k = 2
    while k <= P:
        partner = e ^ (k - 1)
        lower = (e & (k >> 1)) == 0
        s = np.where(lower, np.minimum(s, s[partner]), np.maximum(s, s[partner]))
        j = k >> 2
        while j >= 1:
            partner = e ^ j
            lower = (e & j) == 0
            s = np.where(lower, np.minimum(s, s[partner]), np.maximum(s, s[partner]))
            j >>= 1
        k <<= 1
    return s


def _network_in_shared(v: np.ndarray) -> np.ndarray:
    """``median_in_shared``'s network in place on W values: each step's
    pairs (i, q), i = the p-th index with bit j clear, q = i ^ (k - 1) on a
    stage's first step, else i + j; a pair with q >= W left as it is."""
    s = v.copy()
    W = len(s)
    P = 1
    while P < W:
        P <<= 1
    k = 2
    while k <= P:
        j = k >> 1
        while j >= 1:
            p = np.arange(P // 2)
            i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
            q = i ^ (k - 1) if j == (k >> 1) else i + j
            keep = q < W
            i, q = i[keep], q[keep]
            lo, hi = np.minimum(s[i], s[q]), np.maximum(s[i], s[q])
            s[i], s[q] = lo, hi
            j >>= 1
        k <<= 1
    return s


def _kernel_median(series: np.ndarray, n_valid: int) -> np.float32:
    W = len(series)
    first = W - n_valid
    v, n = _sort_values(series, first)
    if n == 0:
        return np.float32(np.nan)
    k_lane = sk.sort_k(W)
    s = _network_in_registers(v, k_lane) if k_lane else _network_in_shared(v)
    return np.float32((s[(n - 1) >> 1] + s[n >> 1]) * np.float32(0.5))


def _largest_window(dims) -> int:
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            sk.launch_plan(dims, mid)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


WINDOWS = [1, 2, 5, 31, 32, 33, 144, 513, 1024, 1025, "largest"]


@pytest.mark.parametrize("window", WINDOWS)
def test_sorted_median_is_masked_nanmedian_bit_for_bit(window):
    dims = [10, 8, 7, 5, 5, 7, 8, 10]
    W = _largest_window(dims) if window == "largest" else window
    if window == "largest":
        assert W > 32 * sk.MAX_SORT_K and sk.sort_k(W) == 0
        with pytest.raises(ValueError):
            sk.launch_plan(dims, W + 1)
    rng = np.random.default_rng(W)
    series = []
    for kind in ("plain", "ties", "nan", "all_nan"):
        s = rng.standard_normal(W).astype(np.float32)
        if kind == "ties":
            s = np.round(s * 2).astype(np.float32) / 2  # few distinct values, many equal
        elif kind == "nan":
            s[rng.uniform(size=W) < 0.3] = np.nan
        elif kind == "all_nan":
            s[:] = np.nan
        series.append(np.abs(s))  # tag scores and totals are never negative
    raw = np.stack(series, axis=1)
    for n_valid in sorted({0, 1, 2, W // 2, max(W - 1, 0), W}):
        want = sk.masked_nanmedian(torch.from_numpy(raw), n_valid).numpy()
        got = np.array([_kernel_median(raw[:, c], n_valid) for c in range(raw.shape[1])], np.float32)
        assert _same(got, want), (W, n_valid, got, want)
