"""``lstm_head_fit``'s launch plan and its kernel's tiling, on the CPU.

The plan takes every head and batch the first design took (its shared
memory, ``smem_bytes``, within a block's) and refuses the rest naming
ROADMAP item 14; it pads rows to 16 bytes where they fit.  The kernel's
items (``tile_of``, ``spread4`` in ``csrc/lstm_head_fit.cu``) are emulated
here: each output of each phase is written by exactly one item.
"""

import itertools

import pytest

from gordo_tpu_torch.kernels import lstm_head_fit as hf
from gordo_tpu_torch.kernels.fleet_score import SMEM_LIMIT


def first_design_bytes(hidden, fo, windows):
    return 4 * (hidden * (fo | 1) + windows * (hidden + 2 * fo + 1))


@pytest.mark.parametrize("hidden, fo, windows, vec, smem", [
    (42, 50, 64, 4, 4 * (42 * 52 + 64 * (44 + 52 + 50 + 1))),  # the bench's lockstep step (256 slots)
    (42, 50, 256, 4, 4 * (42 * 52 + 256 * (44 + 52 + 50 + 1))),  # the default TrainConfig's batch (16 slots)
    (42, 85, 256, 1, first_design_bytes(42, 85, 256)),  # padded rows do not fit: the first layout (4 slots)
])
def test_plan_at_the_smokes_shapes(hidden, fo, windows, vec, smem):
    plan = hf.launch_plan(hidden, fo, windows)
    assert plan == hf.Plan(smem, vec)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_plan_takes_the_first_designs_heads_and_refuses_the_rest():
    taken = 0
    for hidden, fo, windows in itertools.product((1, 7, 42, 64, 128, 255), (1, 3, 50, 85, 100, 200),
                                                 (1, 16, 64, 256, 512)):
        if first_design_bytes(hidden, fo, windows) > SMEM_LIMIT:
            with pytest.raises(NotImplementedError, match="item 14"):
                hf.launch_plan(hidden, fo, windows)
            continue
        plan = hf.launch_plan(hidden, fo, windows)
        taken += 1
        assert plan.smem_bytes <= SMEM_LIMIT
        if plan.vec == 1:
            assert plan.smem_bytes == first_design_bytes(hidden, fo, windows)
    assert taken > 50


def _tile_of(t, a, b):
    """``tile_of``: item t of a phase over a x b tiles, a warp's 32 items 4
    tiles along a by 8 along b."""
    lane, g, gb = t & 31, t >> 5, (b + 7) >> 3
    ta, tb = (g // gb) * 4 + (lane >> 3), (g % gb) * 8 + (lane & 7)
    return (ta, tb) if ta < a and tb < b else None


def _items(a, b):
    return 32 * ((a + 3) >> 2) * ((b + 7) >> 3)


@pytest.mark.parametrize("nreal, hidden, fo", [(64, 42, 50), (256, 42, 50), (61, 42, 85), (5, 3, 1), (1, 1, 1),
                                                (0, 42, 50)])
def test_every_output_is_one_items(nreal, hidden, fo):
    wt_n, kt_n, ot_n = (nreal + 3) >> 2, (hidden + 3) >> 2, (fo + 3) >> 2
    written = {"pred": [], "dw": [], "dh": []}
    for t in range(_items(wt_n, ot_n)):  # predictions: windows a quarter apart, 4 outputs in a row
        tile = _tile_of(t, wt_n, ot_n)
        if tile:
            wt, ot = tile
            written["pred"] += [(wt + i * wt_n, 4 * ot + j) for i in range(4) for j in range(4)
                                if wt + i * wt_n < nreal and 4 * ot + j < fo]
    for t in range(_items(kt_n, ot_n)):  # dW: 4 units and 4 outputs in a row
        tile = _tile_of(t, kt_n, ot_n)
        if tile:
            kt, ot = tile
            written["dw"] += [(4 * kt + i, 4 * ot + j) for i in range(4) for j in range(4)
                              if 4 * kt + i < hidden and 4 * ot + j < fo]
    for t in range(_items(wt_n, kt_n)):  # dh: windows and units a quarter apart
        tile = _tile_of(t, wt_n, kt_n)
        if tile:
            wt, kt = tile
            written["dh"] += [(wt + i * wt_n, kt + j * kt_n) for i in range(4) for j in range(4)
                              if wt + i * wt_n < nreal and kt + j * kt_n < hidden]
    want = {"pred": (nreal, fo), "dw": (hidden, fo), "dh": (nreal, hidden)}
    for phase, (a, b) in want.items():
        assert sorted(written[phase]) == [(i, j) for i in range(a) for j in range(b)], phase
