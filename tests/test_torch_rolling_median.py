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
