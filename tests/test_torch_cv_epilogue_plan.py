"""``cv_epilogue``'s launch plan and its warp path's partition of the
slot, on the CPU.

At the build bench's 1,536 slots of 144 rows × 10 tags, K4 and K8 take the
warp path and every slot is resident at once: the plan's shared memory
and registers a block, against the 227 KB and 65,536 registers of an SM.
Every (nt, fo) the first design took (its ``ce_chunk``, mirrored here from
``csrc/cv_epilogue.cu`` as it stood before the warp path) is still taken,
by the warp path or by that design, with its chunk and staging; where it
refused, the plan refuses.  The warp path's lanes (``cw_window``,
``cw_sum2``, ``cw_maxima``) are emulated here: in each pass of the metrics,
in K4's mse and mae windows and in the maxima every (row, column) of a
slot is read by exactly one lane, in the sums' order, and the padding
after every 32 staged rows leaves at most two lanes of a pass on one bank.
"""

import numpy as np
import pytest

from gordo_tpu_torch.kernels import cv_epilogue as ce

BENCH = (1536, 144, 10)
SM_COUNT = 132


# -- the first design's shared memory, as csrc/cv_epilogue.cu computed it ------

def _win(n):
    return (n + 31) // 32


def _xo_part(nc, k, n):
    return nc * k * (_win(n) + _win(_win(n)))


def _xo_sum2_part(n, f, k):
    dim = lambda m: _win(m) if m > 32 else 1  # noqa: E731
    return k * (dim(n) * dim(f) + dim(dim(n)) * dim(dim(f)))


def _parent_smem_floats(nt, fo, chunk, staged, masked):
    part = max(_xo_part(chunk, 4, nt), _xo_sum2_part(nt, fo, 2), _xo_part(1, 4, fo))
    return (part + 4 * chunk + 8 * chunk + 4 * fo + 4 + _xo_sum2_part(nt, fo, 2)
            + (((3 if masked else 4) * nt * fo + nt) if staged else 0))


def _parent_launch(nt, fo, masked):
    """``(staged, chunk)`` of the first design's launcher; chunk 0 where
    it refused."""
    staged = 4 * _parent_smem_floats(nt, fo, fo, 1, masked) <= 48 * 1024
    chunk = fo
    while chunk > 0 and 4 * _parent_smem_floats(nt, fo, chunk, staged, masked) > 200 * 1024:
        chunk -= 1
    return int(staged), chunk


@pytest.mark.parametrize("masked", [False, True], ids=["K4", "K8"])
def test_the_bench_shape_is_one_wave(masked):
    S, nt, fo = BENCH
    plan = ce.launch_plan(nt, fo, ce.SMOOTHING_WINDOW, masked)
    assert plan.path == ce.PATH_WARP and plan.threads == 64
    assert plan.smem_bytes <= 18 * 1024 and plan.threads * plan.regs <= 5400
    # an SM's blocks by its 227 KB of shared memory (each block also holds
    # 1 KB the system reserves), its 65,536 registers, its 2,048 threads
    # and its 32 blocks
    by_smem = 227 * 1024 // (plan.smem_bytes + 1024)
    by_regs = 65536 // (plan.threads * plan.regs)
    per_sm = min(by_smem, by_regs, 2048 // plan.threads, 32)
    assert per_sm >= 12 and per_sm * SM_COUNT >= S
    # the first design held 8 (K4) and 11 (K8) slots an SM: two waves
    assert ce.launch_plan(nt, 33, ce.SMOOTHING_WINDOW, masked).path == ce.PATH_BLOCK


NTS = (1, 7, 32, 33, 133, 144, 576, 1024, 1025, 4096, 52_560, 400_000, 1_600_000, 3_000_000)
FOS = (1, 3, 10, 32, 33, 50, 128, 1000)


@pytest.mark.parametrize("masked", [False, True], ids=["K4", "K8"])
def test_every_shape_the_first_design_took_is_taken(masked):
    taken = refused = 0
    for nt in NTS:
        for fo in FOS:
            staged, chunk = _parent_launch(nt, fo, masked)
            if chunk < 1:
                with pytest.raises(NotImplementedError, match="shared memory"):
                    ce.launch_plan(nt, fo, ce.SMOOTHING_WINDOW, masked)
                refused += 1
                continue
            plan = ce.launch_plan(nt, fo, ce.SMOOTHING_WINDOW, masked)
            taken += 1
            if plan.path == ce.PATH_BLOCK:
                assert (plan.staged, plan.chunk) == (staged, chunk), (nt, fo)
                assert plan.smem_bytes == 4 * _parent_smem_floats(nt, fo, chunk, staged, masked)
            else:
                assert fo <= 32 and nt <= 1024 and plan.smem_bytes <= 48 * 1024
    assert taken > 80 and refused > 5


def test_windows_past_eight_rows_take_the_block_path():
    assert ce.launch_plan(144, 10, 9).path == ce.PATH_BLOCK
    assert ce.launch_plan(144, 10, 8).path == ce.PATH_WARP


# -- the warp path's lanes ------------------------------------------------------

def _at(r, fo):
    """``cw_at``: row r's first staged value (4 floats after every 32 rows)."""
    return r * fo + ce.WARP_PAD * (r >> 5)


def _layout(n, L):
    l1 = _win(L)
    return l1, (32 * l1 - L) // 2


def _pass_reads(n, L, fo):
    """Per lane and round of a pass (``cw_passes``, ``cw_window``): the
    (row, column) it reads, in order, with each read's staged index and
    its loop (the rows before the staging's 32-row boundary, then those
    after) and step in that loop."""
    l1, lo = _layout(n, L)
    cols = 32 // l1
    reads = []
    for j0 in range(0, fo, cols):
        for lane in range(32):
            cl, w = divmod(lane, l1)
            j = j0 + cl
            if not (cl < cols and j < fo):
                continue
            ra, rb, re = 32 * w - lo, min(n, 32 * w), min(n, 32 * w - lo + 32)
            first = range(max(ra, 0), rb)
            second = range(max(rb, max(ra, 0)), re)
            reads.append((j0, lane, [(r, j, _at(r, fo) + j, 0, k) for k, r in enumerate(first)]
                          + [(r, j, _at(r, fo) + j, 1, k) for k, r in enumerate(second)]))
    return reads


SHAPES = [(144, 144, 10), (100, 144, 10), (1, 144, 10), (144, 144, 3), (133, 133, 7), (20, 20, 32), (1024, 1024, 1),
          (300, 300, 12), (33, 33, 10), (32, 32, 10)]


@pytest.mark.parametrize("n, L, fo", SHAPES)
def test_each_pass_reads_every_value_once_in_order(n, L, fo):
    counts = np.zeros((n, fo), np.int64)
    staged = set()
    l1, lo = _layout(n, L)
    for _, lane, rows in _pass_reads(n, L, fo):
        w = lane % l1
        r_list = [r for r, *_ in rows]
        assert r_list == sorted(r_list) and all(32 * w - lo <= r < 32 * w - lo + 32 for r in r_list)
        for r, j, at, _, _ in rows:
            counts[r, j] += 1
            staged.add(at)
    assert (counts == 1).all()
    assert len(staged) == n * fo and max(staged) < ce.warp_smem_floats(L, fo)


def test_the_padding_spreads_a_pass_over_the_banks():
    """The lanes of a round read in step, loop by loop: at the bench's
    slots no bank serves more than two of them at once (without the
    padding, the five windows of a column would meet on one bank)."""
    n, L, fo = 144, 144, 10
    for j0 in (0, 6):
        step_banks = {}
        for r0, _, rows in _pass_reads(n, L, fo):
            if r0 == j0:
                for _, _, at, loop, k in rows:
                    step_banks.setdefault((loop, k), []).append(at % 32)
        assert len(step_banks) == 32  # 8 rows before the boundary, 24 after
        assert max(max(np.bincount(b)) for b in step_banks.values()) <= 2
        unpadded = [(r * fo + j) % 32 for r0, _, rows in _pass_reads(n, L, fo) if r0 == j0
                    for r, j, _, loop, k in rows if (loop, k) == (1, 0)]
        assert max(np.bincount(unpadded)) >= 4


@pytest.mark.parametrize("n, L, fo", [s for s in SHAPES if s[0] == s[1]])
def test_k4_windows_read_every_value_once_row_major(n, L, fo):
    """``cw_sum2``: lane w sums window w's rows, every column, row-major, in
    runs within one 32-row block of the staging."""
    l1, lo = _layout(n, L)
    counts = np.zeros((n, fo), np.int64)
    for lane in range(l1):
        order = []
        r, r1 = max(0, 32 * lane - lo), min(n, 32 * lane - lo + 32)
        while r < r1:
            rb = min(r1, (r | 31) + 1)
            base = _at(r, fo)
            run = [base + k for k in range((rb - r) * fo)]
            # a run is contiguous in the staging: its values are row-major
            assert [_at(q, fo) + c for q in range(r, rb) for c in range(fo)] == run
            order += [(q, c) for q in range(r, rb) for c in range(fo)]
            r = rb
        assert order == sorted(order)
        for q, c in order:
            counts[q, c] += 1
    assert (counts == 1).all()


@pytest.mark.parametrize("n, fo", [(144, 10), (60, 10), (1, 10), (144, 3), (133, 50), (7, 31), (1024, 1)])
def test_the_maxima_end_one_window_at_every_row(n, fo):
    """``cw_maxima``: lane (s, c) takes column j0 + c over its run s of
    rows (a multiple of 8 rows from a multiple of 8), every column (the
    tags and the total) over every row exactly once."""
    ncol = fo + 1
    cols = min(ncol, 32)
    runs = 32 // cols
    size = (-(-n // runs) + 7) // 8 * 8
    counts = np.zeros((n, ncol), np.int64)
    for j0 in range(0, ncol, cols):
        for lane in range(32):
            s, c = divmod(lane, cols)
            j = j0 + c
            r0 = min(n, s * size)
            r1 = min(n, r0 + size)
            if s < runs and j < ncol:
                assert r0 % 8 == 0 or r0 == r1
                counts[r0:r1, j] += 1
    assert (counts == 1).all()
