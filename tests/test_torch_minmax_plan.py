"""The MinMax statistic's launch plan, its partition of rows, and its plain
version against the JAX package's, on the CPU.

``scaler_stats.launch_plan`` picks the nested path (a block a machine, one
pass over the longest range in segments between the lists' ends) only for
row lists that are ranges from one row with no chain prefix, the list
path (a block a list and machine) for a prefix, index lists or ranges from
different rows, and the split path (blocks of ``chunk_rows`` positions)
past ``ONE_BLOCK_ROWS`` rows.  The kernel's loads
(``mm_scan`` in ``csrc/scaler_stats.cu``: float4s at ``4 t + k * 4 *
active`` of a range's values, or column ``t % cw`` of rows ``t / cw + k *
active / cw``) are emulated here: every (position, column) of every row
list is read by exactly one lane, and a lane's values keep their columns.
``scaler_stats_plain`` is bit for bit ``MinMaxScaler.compute_stats``:
eager (two roundings of the offset) and as ``_make_scale_chain`` runs it
under ``jax.jit`` (the offset one FMA, ``offset_fma``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.ops.scalers import MinMaxScaler
from gordo_tpu.parallel.anomaly import _make_scale_chain
from gordo_tpu_torch.kernels import scaler_stats as ss
from gordo_tpu_torch.train.cv import TimeSeriesSplit

YEAR = 52_560


def build_lists(rows: int):
    """TimeSeriesSplit(3)'s training folds and the whole series: nested
    ranges from row 0."""
    return [tr for tr, _ in TimeSeriesSplit(3).split(np.empty((rows, 1)))] + [np.arange(rows)]


def uneven(rows: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [np.arange(rows), np.arange(rows // 2 + 7), np.sort(rng.permutation(rows)[: 3 * rows // 4]),
            np.arange(ss.ONE_BLOCK_ROWS + 1)]


PLANS = [
    # name, shape, row lists, prefix steps, path, vec
    ("build", (512, 576, 10), build_lists(576), 0, ss.NESTED, 4),
    ("build_after_a_step", (512, 576, 10), build_lists(576), 1, ss.LIST, 4),
    ("detector", (512, 576, 10), [np.arange(576)], 0, ss.NESTED, 4),
    ("index_lists", (512, 576, 10), [np.sort(np.random.default_rng(1).permutation(576)[:300]), np.arange(576)],
     0, ss.LIST, 1),
    ("ranges_from_other_rows", (4, 576, 10), [np.arange(100, 400), np.arange(576)], 0, ss.LIST, 4),
    ("odd_tags", (4, 200, 7), [np.arange(50), np.arange(200)], 0, ss.NESTED, 1),
    ("wide", (2, 40, 300), [np.arange(13), np.arange(40)], 0, ss.NESTED, 1),
    ("a_year", (1, YEAR, 10), [np.arange(YEAR)], 0, ss.SPLIT, 4),
    ("a_year_after_a_step", (1, YEAR, 10), [np.arange(YEAR)], 1, ss.SPLIT, 4),
    ("uneven_index_lists", (2, 57_344, 10), uneven(57_344), 0, ss.SPLIT, 1),
    ("one_block", (1, ss.ONE_BLOCK_ROWS, 10), [np.arange(ss.ONE_BLOCK_ROWS)], 0, ss.NESTED, 4),
    ("past_one_block", (1, ss.ONE_BLOCK_ROWS + 1, 10), [np.arange(ss.ONE_BLOCK_ROWS + 1)], 0, ss.SPLIT, 4),
]


@pytest.mark.parametrize("name, shape, lists, steps, path, vec", PLANS, ids=[p[0] for p in PLANS])
def test_plan_picks_the_path(name, shape, lists, steps, path, vec):
    plan = ss.launch_plan(shape, lists, steps)
    assert (plan.path, plan.vec) == (path, vec)
    M, N, F = shape
    assert plan.active % plan.period == 0 and plan.active <= plan.threads <= ss.THREADS
    assert plan.threads % 32 == 0 and (plan.vec == 4 or plan.cw <= plan.active)
    if plan.vec == 4:
        assert plan.cw == F and 4 * plan.period % F == 0 and plan.period == F // math.gcd(F, 4)
    else:
        assert plan.cw == plan.period == min(F, ss.THREADS)
    if path == ss.NESTED:
        sizes = [len(r) for r in lists]
        assert plan.segments == tuple(sorted(set(sizes))) and plan.grid == (M, 1, 1)
        assert [plan.segments[k] for k in plan.list_segment] == sizes
    elif path == ss.LIST:
        assert plan.grid == (len(lists), M, 1)
    else:
        assert plan.grid == (-(-max(len(r) for r in lists) // plan.chunk_rows), M, len(lists))
        assert plan.chunk_rows % 32 == 0


def test_float4_loads_need_aligned_ranges():
    lists = build_lists(576)
    assert ss.launch_plan((8, 576, 10), lists, aligned=False).vec == 1
    # a machine's rows that start off 16 bytes (577 x 10 values a machine)
    assert ss.launch_plan((8, 577, 10), [np.arange(577)]).vec == 1
    assert ss.launch_plan((1, 577, 10), [np.arange(577)]).vec == 4
    # a segment that starts off 16 bytes (50 x 7 values before it)
    assert ss.launch_plan((4, 200, 7), [np.arange(50), np.arange(200)]).vec == 1
    assert ss.launch_plan((4, 200, 8), [np.arange(50), np.arange(200)]).vec == 4


def _blocks(plan, M, lists):
    """Each block's (machine, row list, range start, [(p0, p1), ...])."""
    sizes = [len(r) for r in lists]
    if plan.path == ss.NESTED:
        ends = plan.segments
        segs = [(ends[k - 1] if k else 0, ends[k]) for k in range(len(ends))]
        return [(m, 0, segs) for m in range(M)]
    if plan.path == ss.LIST:
        return [(m, g, [(0, sizes[g])]) for m in range(M) for g in range(len(lists))]
    out = []
    for m in range(M):
        for g, n in enumerate(sizes):
            for c in range(plan.grid[0]):
                p0 = c * plan.chunk_rows
                if p0 < n:
                    out.append((m, g, [(p0, min(n, p0 + plan.chunk_rows))]))
    return out


def _lane_reads(plan, F, p0, p1):
    """The (position, column) pairs each thread reads over positions [p0,
    p1), as ``mm_scan`` takes them, with the column ``mm_column`` gives the
    lane: ``(positions, columns, lane columns)``."""
    t = np.arange(plan.active)
    if plan.vec == 4:
        steps = -(-((p1 - p0) * F) // (4 * plan.active)) + 1
        e = p0 * F + 4 * t[:, None, None] + 4 * plan.active * np.arange(steps)[None, :, None] \
            + np.arange(4)[None, None, :]
        lane_col = np.broadcast_to((4 * t[:, None, None] + np.arange(4)[None, None, :]) % F, e.shape)
        keep = e < p1 * F
        return e[keep] // F, e[keep] % F, lane_col[keep]
    pos, cols = [], []
    step = plan.active // plan.cw
    for col0 in range(0, F, plan.cw):
        col = col0 + t % plan.cw
        first = p0 + t // plan.cw
        for k in range(-(-(p1 - p0) // step) + 1):
            i = first + k * step
            keep = (i < p1) & (col < F)
            pos.append(i[keep])
            cols.append(col[keep])
    pos, cols = np.concatenate(pos), np.concatenate(cols)
    return pos, cols, cols


@pytest.mark.parametrize("name, shape, lists, steps, path, vec", PLANS, ids=[p[0] for p in PLANS])
def test_every_value_is_read_by_one_lane(name, shape, lists, steps, path, vec):
    M, N, F = shape
    M = min(M, 2)  # machines are alike: each block reads its own machine's rows
    plan = ss.launch_plan(shape, lists, steps)
    sizes = [len(r) for r in lists]
    counts = {}
    for m, g, segs in _blocks(plan, M, lists):
        for p0, p1 in segs:
            pos, cols, lane_cols = _lane_reads(plan, F, p0, p1)
            assert np.array_equal(cols, lane_cols), "a lane's value keeps its column"
            key = (m, g)
            if key not in counts:
                counts[key] = np.zeros((max(sizes), F), np.int64)
            np.add.at(counts[key], (pos, cols), 1)
    for (m, g), c in counts.items():
        n = max(sizes) if plan.path == ss.NESTED else sizes[g]
        assert (c[:n] == 1).all() and (c[n:] == 0).all(), (m, g)
    if plan.path == ss.NESTED:
        # each row list's stats combine the segments up to its end: its rows
        for g, n in enumerate(sizes):
            assert plan.segments[plan.list_segment[g]] == n
    assert len(counts) == M * (1 if plan.path == ss.NESTED else len(lists))


# -- the plain version against the JAX package's -------------------------------

def _jax_fused(X, rows, feature_range):
    """``_make_scale_chain``'s MinMax step under ``jax.jit``, as the fleet
    programs run it: the offset one FMA."""
    opts = [(MinMaxScaler, (("feature_range", tuple(feature_range)),))]
    return jax.jit(lambda x: _make_scale_chain(opts)(x)[0][0])(jnp.asarray(X[:, rows]))


def _jax_eager(X, rows, feature_range):
    return jax.vmap(lambda xm: MinMaxScaler.compute_stats(xm, tuple(feature_range)))(jnp.asarray(X[:, rows]))


def _differing(ref, got) -> int:
    ref = np.asarray(ref, np.float32) + np.float32(0.0)
    got = np.asarray(got, np.float32) + np.float32(0.0)
    both = np.isnan(ref) & np.isnan(got)
    return int(((ref.view(np.int32) != got.view(np.int32)) & ~both).sum())


def _fleet(seed, machines, rows, tags, level=100.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((machines, rows, tags)) * 3 + level).astype(np.float32)


def _nan_padded():
    X = _fleet(11, 4, 576, 6)
    for i, n in enumerate((576, 449, 500, 100)):
        X[i, n:] = np.nan  # pad-up padding past each machine's length
    X[2, :, 3] = np.nan    # an all-NaN column
    X[0, 3, :] = -0.0      # signed zeros among the values
    X[0, 4, :] = 0.0
    X[1, :, 5] = -0.0      # a column of -0 and +0 alone
    X[1, ::2, 5] = 0.0
    return X, build_lists(576)


def _year():
    X = _fleet(12, 1, YEAR, 4, level=0.0)
    X[0, YEAR - 4_000:] = np.nan
    return X, [np.arange(YEAR)]


@pytest.mark.parametrize("feature_range", [(0.0, 1.0), (1.0, -1.0), (-1.0, 1.0)])
@pytest.mark.parametrize("make", [_nan_padded, _year], ids=["nested_nan_padded", "a_year"])
def test_plain_is_jax_bit_for_bit(make, feature_range):
    X, lists = make()
    x = torch.from_numpy(X)
    fused = ss.scaler_stats_plain(x, lists, feature_range, offset_fma=True)
    eager = ss.scaler_stats_plain(x, lists, feature_range)
    for g, rows in enumerate(lists):
        for ref, got in ((_jax_fused(X, rows, feature_range), fused), (_jax_eager(X, rows, feature_range), eager)):
            assert _differing(ref["scale"], got[0][:, g]) == 0, g
            assert _differing(ref["offset"], got[1][:, g]) == 0, g
    # the all-NaN column is NaN in both stats; the signed zeros' column
    # spans 0, floored to 1e-12
    if make is _nan_padded:
        assert bool(torch.isnan(fused[0][2, :, 3]).all()) and bool(torch.isnan(fused[1][2, :, 3]).all())
        assert float(fused[0][1, -1, 5]) == np.float32(feature_range[1] - feature_range[0]) / np.float32(1e-12)


def test_the_fused_and_eager_offsets_differ_somewhere():
    """The two references are not one: on these rows at least one offset
    rounds differently once and twice, so the test above holds both."""
    X, lists = _nan_padded()
    differ = sum(_differing(_jax_fused(X, r, (1.0, -1.0))["offset"], _jax_eager(X, r, (1.0, -1.0))["offset"])
                 for r in lists)
    assert differ > 0
