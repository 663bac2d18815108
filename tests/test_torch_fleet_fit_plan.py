"""``fleet_fit``'s launch plan (K1, ``gordo_tpu_torch/kernels/fleet_fit.py``).

The kernel keeps a minibatch feature-major (a column of ``row_stride``
floats a feature, float4 groups of rows, each warp 32 rows of it) and
keeps each warp's partial sums of every gradient, or, where those do not
fit, every layer's deltas.  The widths and minibatch sizes it takes stay
the ones it has always taken: a machine's weights, two Adam moments and a
minibatch's activations and deltas at a thread a row, an odd stride, in
one block.  Here, over widths and batch sizes:

- every case that rule takes is taken, with the same threads, and the
  kernel's shared memory (its layout counted here from the source's
  description) fits a block, the warps' partial sums and padded columns
  wherever they fit;
- every case it refuses raises ``NotImplementedError`` naming item 13.
"""

import pytest

from gordo_tpu_torch.kernels import fleet_fit as ff

WIDTHS = {
    "default-10": [10, 8, 7, 5, 5, 7, 8, 10],
    "hourglass-4": [4, 3, 3, 2, 2, 3, 3, 4],
    "hourglass-50": [50, 42, 33, 25, 25, 33, 42, 50],
    "hourglass-56": [56, 47, 37, 28, 28, 37, 47, 56],
    "hourglass-128": [128, 107, 85, 64, 64, 85, 107, 128],
    "one-layer": [6, 6],
    "two-layers": [100, 50, 100],
    "narrow-wide": [4, 600, 4],
    "deep-64": [64] * 9,
}
BATCHES = [1, 7, 25, 32, 64, 144, 256, 512, 1024, 1025]


def _always_taken(dims, bs) -> bool:
    """The rule the plan has always applied: one thread a row, an odd row
    stride of every layer's input and output, three copies of the params."""
    P = ff.n_params(dims)
    threads = -(-bs // 32) * 32
    stride = (sum(dims[:-1]) + sum(dims[1:])) | 1
    return threads <= ff.MAX_THREADS and 4 * (3 * P + 96 + threads * stride) <= ff.SMEM_LIMIT


def _kernel_floats(dims, stride, partials, warps) -> int:
    """The kernel's shared memory: each layer's input column and, with the
    warps' partial sums, two delta buffers (the widest even and odd layer
    outputs) and ``warps`` partial sums of the P params, else every layer's
    output deltas; ``stride`` floats a column; the params and their two
    moments; three 32-entry warp arrays."""
    P = ff.n_params(dims)
    deltas = max(dims[1::2]) + max(dims[2::2], default=0) if partials else sum(dims[1:])
    return stride * (sum(dims[:-1]) + deltas) + (warps * P if partials else 0) + 3 * P + 96


@pytest.mark.parametrize("bs", BATCHES)
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_the_plan_takes_what_it_took_and_refuses_the_rest(widths, bs):
    dims = WIDTHS[widths]
    if not _always_taken(dims, bs):
        with pytest.raises(NotImplementedError, match="item 13"):
            ff.launch_plan(dims, bs)
        return
    plan = ff.launch_plan(dims, bs)
    warps = plan.threads // 32
    assert plan.threads == -(-bs // 32) * 32
    rows = -(-bs // 4) * 4
    padded = rows + (4 - rows) % 32
    assert padded % 32 == 4 and 0 <= padded - rows < 32
    assert plan.smem_bytes == 4 * _kernel_floats(dims, plan.row_stride, plan.warp_partials, warps)
    assert plan.smem_bytes <= ff.SMEM_LIMIT
    # the first layout that fits, in the order: partial sums, then padding
    fits = [(p, s) for p in (True, False) for s in (padded, rows)
            if 4 * _kernel_floats(dims, s, p, warps) <= ff.SMEM_LIMIT]
    assert (plan.warp_partials, plan.row_stride) == fits[0]


def test_the_default_fits_keep_the_warps_partial_sums():
    """The default hourglass at TrainConfig's 256-row minibatches: eight
    warps' partial sums and padded columns."""
    plan = ff.launch_plan(WIDTHS["default-10"], 256)
    assert plan.warp_partials and plan.threads == 256 and plan.row_stride == 260


def test_some_taken_widths_keep_every_layers_deltas_instead():
    """A wide hourglass at small minibatches: the warps' partial sums do not
    fit beside the columns, every layer's deltas do."""
    plan = ff.launch_plan(WIDTHS["hourglass-56"], 25)
    assert not plan.warp_partials
