"""The port's ``rolling_median`` against the JAX package's smoothing.

``rolling_median_plain`` is held bitwise to ``_rolling_median`` and
``_rolling_median_blocked`` (``gordo_tpu/serve/scorer.py:165,178``): both
drop NaNs and take ``(lo + hi) * 0.5`` of the two middle values in
float32, so there is nothing to round differently.  On CPU tensors the
``rolling_median`` wrapper runs its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.serve.scorer import _rolling_median, _rolling_median_blocked
from gordo_tpu_torch.kernels import rolling_median as rm

ROWS = 23


def _scores(seed, rows=ROWS, tags=4):
    rng = np.random.default_rng(seed)
    tag = rng.standard_normal((rows, tags)).astype(np.float32)
    tag[rng.random((rows, tags)) < 0.25] = np.nan  # NaN entries
    tag[:, 1] = np.nan  # an all-NaN column
    tag[5:9, 2] = np.nan  # a run of NaNs longer than the small windows
    total = np.abs(rng.standard_normal(rows)).astype(np.float32)
    total[[0, 7, 8]] = np.nan
    return tag, total


def _jax(a, window, blocked):
    if blocked:
        return np.asarray(_rolling_median_blocked(jnp.asarray(a), window, 5))
    return np.asarray(_rolling_median(jnp.asarray(a), window))


@pytest.mark.parametrize("blocked", [False, True], ids=["one-shot", "blocked"])
@pytest.mark.parametrize("window", [1, 2, 5, 6, ROWS + 7])
def test_plain_equals_jax_bitwise(window, blocked):
    tag, total = _scores(window)
    out = rm.rolling_median_plain(torch.from_numpy(tag[None]), torch.from_numpy(total[None]), window)
    np.testing.assert_array_equal(out["tag-anomaly-scores"][0].numpy(), _jax(tag, window, blocked))
    np.testing.assert_array_equal(out["total-anomaly-score"][0].numpy(), _jax(total, window, blocked))
    # the all-NaN column stays NaN; an all-NaN window (rows 5..8 of tag 2
    # with window <= 4) gives NaN; other windows take what is there
    assert np.isnan(out["tag-anomaly-scores"][0, :, 1].numpy()).all()
    if window <= 4:
        assert np.isnan(out["tag-anomaly-scores"][0, 8, 2].item())


def test_even_counts_take_the_float32_midpoint():
    # 2 values: (lo + hi) * 0.5, not lo + 0.5 * (hi - lo) (which rounds
    # differently) and not the lower middle value (torch.median)
    lo, hi = np.float32(1.0000001), np.float32(3.0000005)
    tag = np.array([[lo], [hi], [np.nan]], np.float32)
    total = np.array([lo, hi, np.nan], np.float32)
    out = rm.rolling_median_plain(torch.from_numpy(tag[None]), torch.from_numpy(total[None]), 2)
    want = np.float32((lo + hi) * np.float32(0.5))
    assert out["total-anomaly-score"][0, 1].item() == want
    assert out["total-anomaly-score"][0, 2].item() == hi  # NaN dropped
    np.testing.assert_array_equal(out["total-anomaly-score"][0].numpy(), _jax(total, 2, False))


def test_ragged_slots_confidence_and_subsets():
    """Slots of a bucket with their own valid rows, a subset of its
    machines by stack position, and the confidence of the smoothed total:
    each slot's valid rows equal JAX on that slot's rows alone."""
    window, n = 6, ROWS
    rows = [ROWS, 9, 1]
    slots = [_scores(s, n) for s in range(3)]
    tag = np.stack([t for t, _ in slots])
    total = np.stack([tt for _, tt in slots])
    thr = np.array([0.5, 2.0, 1e-15, 0.25], np.float32)  # 4 machines; one below the clamp
    idx = [3, 0, 2]
    before = rm.launches
    out = rm.rolling_median(torch.from_numpy(tag), torch.from_numpy(total), window,
                            agg_thr=torch.from_numpy(thr), idx=idx, n_rows=rows)
    assert rm.launches == before  # the CPU never launches the kernel
    for s, r in enumerate(rows):
        ref_tag = _jax(tag[s, :r], window, False)
        ref_total = _jax(total[s, :r], window, False)
        np.testing.assert_array_equal(out["tag-anomaly-scores"][s, :r].numpy(), ref_tag)
        np.testing.assert_array_equal(out["total-anomaly-score"][s, :r].numpy(), ref_total)
        # JAX's program: total / jnp.maximum(threshold, 1e-12)
        conf = np.asarray(jnp.asarray(ref_total) / jnp.maximum(jnp.float32(thr[idx[s]]), 1e-12))
        np.testing.assert_array_equal(out["anomaly-confidence"][s, :r].numpy(), conf)


def test_wrapper_checks_before_it_launches():
    tag = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rm.rolling_median(tag.to("meta"), torch.zeros((1, 4)).to("meta"), 3)
    assert rm.MAX_WINDOW == rm.SMEM_LIMIT // (4 * rm.LANES)


# -- the kernel's schedule, emulated in numpy ---------------------------------
#
# ``csrc/rolling_median.cu``: a warp takes one series of one slot over a
# chunk of 32 E output rows (E a lane); it sorts the chunk's window - 1
# earlier rows and its own as unique keys (orderable float bits << 32 |
# local row; NaN and rows before 0 last), keeps each sorted position's row
# and value, each row's position and the prefix counts of rows with a
# value; each lane walks the sorted rows eight at a time to its first
# row's middle key, then slides down its rows.  Any sorting network gives
# the order np.sort gives unique keys, so the emulation sorts with numpy
# and walks as the kernel walks.

NONE = 0xFFFF


def _order_keys(v):
    u = v.view(np.uint32)
    k = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), k)


def _key_values(k):
    k = np.asarray(k, np.uint32)
    return np.where(k & np.uint32(0x80000000), k ^ np.uint32(0x80000000), ~k).astype(np.uint32).view(np.float32)


def _nth_bit(m, n):
    at = 0
    for half in (4, 2, 1):
        c = bin(m & ((1 << half) - 1)).count("1")
        if n >= c:
            n, at, m = n - c, at + half, m >> half
    return at


def kernel_schedule(x, window, n_valid=None):
    """One slot's series ``x`` (n, c) smoothed as the kernel schedules it;
    rows from ``n_valid`` on stay NaN (the kernel leaves them unwritten)."""
    n, c = x.shape
    n_valid = n if n_valid is None else n_valid
    plan = rm.launch_plan(n, c, window)
    E, P = plan.lane_rows, plan.keys
    out = np.full((n, c), np.nan, np.float32)
    for s in range(c):
        for r0 in range(0, n_valid, 32 * E):
            r_end = min(r0 + 32 * E, n_valid)
            nk = r_end - r0 + window - 1
            assert nk <= P
            g = r0 - window + 1 + np.arange(nk)
            val = np.full(nk, np.nan, np.float32)
            inside = (g >= 0) & (g < r_end)
            val[inside] = x[g[inside], s]
            keys = np.full(P, np.iinfo(np.uint64).max, np.uint64)
            keys[:nk] = (_order_keys(val).astype(np.uint64) << np.uint64(32)) | np.arange(nk, dtype=np.uint64)
            keys = np.sort(keys)
            hi, lo = (keys >> np.uint64(32)).astype(np.uint32), (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
            has = hi != np.uint32(0xFFFFFFFF)
            row = np.where(has, lo, NONE)
            sval = _key_values(hi)
            pos = np.full(P, NONE, np.int64)
            pos[lo[has]] = np.nonzero(has)[0]
            pre = np.concatenate([[0], np.cumsum(pos[:nk] != NONE)])

            def bits(gr, lo_row):
                return sum(1 << b for b in range(8) if (int(row[8 * gr + b]) - lo_row) % 2 ** 32 < window)

            for lane in range(32):
                gr = below = cnt = 0
                for i in range(E):
                    j = lane * E + i
                    if j >= r_end - r0:
                        break
                    rho = j + window - 1
                    if i == 0:
                        cnt = int(pre[rho + 1] - pre[rho + 1 - window])
                    else:
                        for q, d in ((pos[rho - window], -1), (pos[rho], 1)):
                            if q != NONE:
                                cnt += d
                                below += d * int(q < 8 * gr)
                    lo_row = rho - window + 1
                    med = np.float32(np.nan)
                    if cnt > 0:
                        t = (cnt - 1) >> 1
                        if below > t:
                            while below > t:
                                gr -= 1
                                m = bits(gr, lo_row)
                                below -= bin(m).count("1")
                        else:
                            m = bits(gr, lo_row)
                        while below + bin(m).count("1") <= t:
                            below += bin(m).count("1")
                            gr += 1
                            m = bits(gr, lo_row)
                        lo_v = sval[8 * gr + _nth_bit(m, t - below)]
                        hi_v = lo_v
                        if not cnt & 1:
                            gh, bh, mh = gr, below, m
                            while bh + bin(mh).count("1") <= t + 1:
                                bh += bin(mh).count("1")
                                gh += 1
                                mh = bits(gh, lo_row)
                            hi_v = sval[8 * gh + _nth_bit(mh, t + 1 - bh)]
                        med = (lo_v + hi_v) * np.float32(0.5)
                    out[r0 + j, s] = med
    return out


def _series(seed, rows, window, cols=3):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((rows, cols))).astype(np.float32)
    x[rng.random(x.shape) < 0.25] = np.nan
    x[:, 2] = np.nan  # an all-NaN series
    x[rows // 3: rows // 3 + window + 5, 1] = np.nan  # all-NaN windows past the first rows
    x[::7, 0] = np.round(x[::7, 0])  # ties
    return x


@pytest.mark.parametrize("window, rows", [
    (1, 40), (2, 70), (3, 35),
    (144, 100),  # shorter than the window
    (144, 351), (144, 352), (144, 353),  # one chunk short, one chunk, one row past it
    (1816, 300), (1816, 1025),  # the longest window: 4,096 keys, chunks of 1,024 rows
])
def test_kernel_schedule_equals_jax_bitwise(window, rows):
    x = _series(window + rows, rows, window)
    if window == 144 and rows > 350:
        assert 32 * rm.launch_plan(rows, x.shape[1], window).lane_rows == 352
    np.testing.assert_array_equal(kernel_schedule(x, window), _jax(x, window, False))


def test_kernel_schedule_ragged_rows_equal_jax_on_the_valid_rows():
    window, rows = 144, 800
    x = _series(5, rows, window)
    for n_valid in (1, 352, 353, 700):
        got = kernel_schedule(x, window, n_valid)
        np.testing.assert_array_equal(got[:n_valid], _jax(x[:n_valid], window, False))
        assert np.isnan(got[n_valid:]).all()


@pytest.mark.parametrize("n, series, window, want", [
    (4085, 51, 144, dict(lane_rows=11, keys=512, warps=4, groups=13, chunks=12)),  # the LSTM bucket
    (2048, 11, 144, dict(lane_rows=11, keys=512, warps=4, groups=3, chunks=6)),  # the stacked default bucket
    (4085, 51, 1816, dict(lane_rows=32, keys=4096, warps=3, groups=17, chunks=4)),  # the longest window
    (12, 51, 144, dict(lane_rows=1, keys=256, warps=4, groups=13, chunks=1)),  # a short request
])
def test_launch_plan_at_the_smokes_shapes(n, series, window, want):
    plan = rm.launch_plan(n, series, window)
    assert {k: getattr(plan, k) for k in want} == want
    assert plan.smem_bytes == plan.warps * rm.warp_bytes(plan.keys) <= rm.SMEM_LIMIT
    assert plan.groups * plan.warps >= series > (plan.groups - 1) * plan.warps
    assert plan.chunks * 32 * plan.lane_rows >= n


def test_launch_plan_holds_every_window_in_shared_memory():
    for window in range(1, rm.MAX_WINDOW + 1):
        for n in (1, 31, 352, 4085):
            plan = rm.launch_plan(n, 11, window)
            keys = plan.keys
            assert keys & (keys - 1) == 0 and 32 * plan.lane_rows + window - 1 <= keys
            assert plan.smem_bytes <= rm.SMEM_LIMIT and plan.warps >= 1
    with pytest.raises(ValueError, match="windows of 1..1816"):
        rm.launch_plan(100, 3, rm.MAX_WINDOW + 1)
