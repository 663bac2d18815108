"""``fleet_score`` (CPU path and plain version) against the JAX programs
it replaces: ``_fleet_score_core`` (``serve.fleet``),
``_fleet_score_subset_core`` (``serve.fleet_subset``) and
``_score_program_fn`` (``serve.score``).

Inputs come from seeded numpy.  Tolerance: ``max|ref - port| / max|ref|``
per output series, <= 1e-5 in float32 (the ROADMAP parity metric; the two
sides sum each dense layer in different orders).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.anomaly.diff import scores_fn
from gordo_tpu.models.factories.feedforward import feedforward_hourglass
from gordo_tpu.ops.scalers import MinMaxScaler
from gordo_tpu.serve.fleet_scorer import _fleet_score_core, _fleet_score_subset_core
from gordo_tpu.serve.scorer import _score_program_fn
from gordo_tpu_torch.kernels import fleet_score as fs
from gordo_tpu_torch.kernels.scaler_stats import AFFINE

TOL = 1e-5
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")
ENTRY_POINTS = {"wrapper": fs.fleet_score, "plain": fs.fleet_score_plain}


def max_norm_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


class Bucket:
    """M default detectors at F tags as stacked numpy arrays, in the flax
    layout the JAX programs take and the (W, b) layout the port takes."""

    def __init__(self, machines=3, tags=6, seed=0):
        rng = np.random.default_rng(seed)
        self.module = feedforward_hourglass(tags, compute_dtype="float32")
        dims = [tags] + list(self.module.dims) + [tags]
        names = [f"dense_{i}" for i in range(len(dims) - 2)] + ["out"]
        self.params = {}
        for name, din, dout in zip(names, dims[:-1], dims[1:]):
            self.params[name] = {
                "kernel": (rng.standard_normal((machines, din, dout)) / math.sqrt(din)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal((machines, dout))).astype(np.float32),
            }
        self.acts = list(self.module.funcs) + [self.module.out_func]

        def minmax():
            lo = rng.uniform(-3, -1, (machines, tags))
            scale = (1.0 / (rng.uniform(1, 3, (machines, tags)) - lo)).astype(np.float32)
            return {"scale": scale, "offset": (-lo * scale).astype(np.float32)}

        self.stats = minmax()
        self.det = minmax()
        self.agg = rng.uniform(0.2, 1.0, machines).astype(np.float32)
        self.rng = rng
        self.tags = tags

    def X(self, m, n):
        return (1.5 * self.rng.standard_normal((m, n, self.tags))).astype(np.float32)

    def port_kwargs(self, with_thresholds=True):
        t = torch.from_numpy
        return dict(
            layers=[(t(p["kernel"]), t(p["bias"])) for p in self.params.values()],
            acts=self.acts,
            chain=[(AFFINE, t(self.stats["scale"]), t(self.stats["offset"]))],
            det=(AFFINE, t(self.det["scale"]), t(self.det["offset"])),
            agg_thr=t(self.agg) if with_thresholds else None,
        )

    def jax_prefix(self, with_thresholds=True):
        return (
            self.module, (MinMaxScaler,), "none", 1, MinMaxScaler,
            with_thresholds, 0, "float32",
            (self.stats,), self.params, self.det,
            jnp.asarray(self.agg) if with_thresholds else None,
        )


def _score(fn, bucket, X, with_thresholds=True, **kw):
    args = bucket.port_kwargs(with_thresholds)
    return fn(torch.from_numpy(X), args.pop("layers"), args.pop("acts"), **args, **kw)


def _assert_close(ref, got, rows=None):
    assert set(got) == set(ref)
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, k
        if rows is not None:
            r = np.concatenate([r[i, :n] for i, n in enumerate(rows)])
            g = np.concatenate([g[i, :n] for i, n in enumerate(rows)])
        assert max_norm_err(r, g) <= TOL, k


@pytest.mark.parametrize("entry", ENTRY_POINTS)
@pytest.mark.parametrize("with_thresholds", [True, False])
def test_matches_fleet_score_core(entry, with_thresholds):
    bucket = Bucket()
    X = bucket.X(3, 40)
    ref = _fleet_score_core(*bucket.jax_prefix(with_thresholds), jnp.asarray(X))
    got = _score(ENTRY_POINTS[entry], bucket, X, with_thresholds)
    _assert_close(ref, got)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_matches_fleet_score_subset_core(entry):
    bucket = Bucket(machines=4, seed=1)
    idx = np.array([2, 0, 2], np.int32)  # unordered, with a repeat
    X = bucket.X(3, 33)
    ref = _fleet_score_subset_core(
        *bucket.jax_prefix(), jnp.asarray(idx), jnp.asarray(X)
    )
    got = _score(ENTRY_POINTS[entry], bucket, X, idx=idx)
    _assert_close(ref, got)


def test_ragged_rows_leave_the_valid_rows_unchanged():
    bucket = Bucket(seed=2)
    X = bucket.X(3, 25)
    rows = [25, 7, 1]
    ref = _fleet_score_core(*bucket.jax_prefix(), jnp.asarray(X))
    got = _score(fs.fleet_score, bucket, X, n_rows=rows)
    _assert_close(ref, got, rows)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
@pytest.mark.parametrize("with_confidence", [True, False])
def test_matches_score_program_fn_single_machine(entry, with_confidence):
    bucket = Bucket(machines=1, tags=5, seed=3)
    X = bucket.X(1, 50)
    one = lambda tree: {k: v[0] for k, v in tree.items()}  # noqa: E731
    ref = _score_program_fn(
        bucket.module, (MinMaxScaler,), "none", 1, MinMaxScaler, True, 0,
        "float32", with_confidence, (one(bucket.stats),),
        {k: one(v) for k, v in bucket.params.items()}, one(bucket.det),
        np.float32(bucket.agg[0]) if with_confidence else None,
        jnp.asarray(X[0]),
    )
    got = _score(ENTRY_POINTS[entry], bucket, X, with_confidence)
    _assert_close({k: np.asarray(v)[None] for k, v in ref.items()}, got)


def test_targets_other_than_x_match_scores_fn():
    bucket = Bucket(machines=1, seed=4)
    X, Y = bucket.X(1, 30), bucket.X(1, 30)
    got = _score(fs.fleet_score, bucket, X, y=torch.from_numpy(Y))
    det = {k: v[0] for k, v in bucket.det.items()}
    tag, total = scores_fn(
        MinMaxScaler, det, jnp.asarray(Y[0]), jnp.asarray(got["model-output"][0].numpy())
    )
    assert max_norm_err(tag, got["tag-anomaly-scores"][0].numpy()) <= TOL
    assert max_norm_err(total, got["total-anomaly-score"][0].numpy()) <= TOL


def test_prediction_only_without_the_detector_scaler():
    bucket = Bucket(seed=5)
    X = bucket.X(3, 10)
    args = bucket.port_kwargs(with_thresholds=False)
    for k in ("det", "agg_thr"):
        args.pop(k)
    got = fs.fleet_score(torch.from_numpy(X), args.pop("layers"), args.pop("acts"), **args)
    ref = _fleet_score_core(*bucket.jax_prefix(False), jnp.asarray(X))
    assert list(got) == ["model-output"]
    assert max_norm_err(ref["model-output"], got["model-output"].numpy()) <= TOL


def test_cpu_path_never_counts_a_launch():
    bucket = Bucket()
    before = fs.launches
    _score(fs.fleet_score, bucket, bucket.X(3, 8))
    _score(fs.fleet_score, bucket, bucket.X(2, 8), idx=[1, 2], n_rows=[8, 3])
    assert fs.launches == before


def test_other_devices_are_refused():
    bucket = Bucket()
    args = bucket.port_kwargs()
    x = torch.empty((3, 4, bucket.tags), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.fleet_score(x, args.pop("layers"), args.pop("acts"), **args)


def test_launch_plan_fits_shared_memory_or_raises():
    # the default width: the row path, all 367 weights resident (each
    # layer's rows padded to four columns), tiles of 256 rows
    plan = fs.launch_plan([10, 8, 7, 5, 5, 7, 8, 10], m=512, n=2048, sm_count=132)
    assert plan.path == fs.PATH_ROWS and plan.weights_resident and plan.wbuf_floats == 492
    assert plan.rows_per_block == 256 and plan.smem_bytes <= fs.SMEM_LIMIT
    # the 128-tag hourglass: the tile path, 242 KB of weights in all,
    # streamed a layer at a time through a buffer of the largest padded
    # one (128 x 108 + 108 floats)
    dims = [128, 107, 85, 64, 64, 85, 107, 128]
    plan = fs.launch_plan(dims, m=1, n=4096, sm_count=132)
    assert plan.path == fs.PATH_TILE and not plan.weights_resident and plan.wbuf_floats == 128 * 108 + 108
    assert plan.rows_per_block % fs.TILE_RT == 0
    assert 48 * 1024 < plan.smem_bytes <= fs.SMEM_LIMIT
    # a large grid keeps the largest tile that leaves two blocks an SM (32
    # rows at this width); a small one spreads its rows over the SMs
    big = fs.launch_plan(dims, m=64, n=4096, sm_count=132)
    assert big.rows_per_block == 32 and 2 * big.smem_bytes <= fs.SMEM_LIMIT
    assert plan.rows_per_block <= 32
    with pytest.raises(ValueError, match="cannot take widths"):
        fs.launch_plan([256, 250, 256], m=1, n=10, sm_count=132)


@pytest.mark.parametrize("dims, path", [
    ([10, 8, 7, 5, 5, 7, 8, 10], fs.PATH_ROWS),   # the default hourglass
    ([8, 6, 5, 4, 4, 5, 6, 10], fs.PATH_ROWS),    # chain C's model: PCA(8) in, 10 tags out
    ([10], fs.PATH_ROWS),                        # the epilogue alone at 10 tags
    ([16, 16, 16], fs.PATH_ROWS),                # the row path's widest
    ([16, 17, 16], fs.PATH_TILE),
    ([42, 50], fs.PATH_TILE),                    # the LSTM head
    ([128], fs.PATH_TILE),                       # the epilogue alone at 128 tags
    ([128, 107, 85, 64, 64, 85, 107, 128], fs.PATH_TILE),
])
def test_launch_plan_path_by_width(dims, path):
    assert fs.launch_plan(dims, m=512, n=2048, sm_count=132).path == path


def test_row_path_width_limit_raises():
    assert fs.row_plan([fs.NARROW_MAX] * 3, m=8, n=100, sm_count=132).path == fs.PATH_ROWS
    with pytest.raises(ValueError, match=f"row path takes widths up to {fs.NARROW_MAX}"):
        fs.row_plan([10, fs.NARROW_MAX + 1, 10], m=8, n=100, sm_count=132)


@pytest.mark.parametrize("dims, m, n, x_bytes, store_bytes, targets", [
    ([10, 8, 7, 5, 5, 7, 8, 10], 512, 2048, 4, 4, False),
    ([10, 8, 7, 5, 5, 7, 8, 10], 512, 2048, 2, 2, False),    # bf16 storage
    ([10], 512, 2048, 4, 4, True),                           # the epilogue alone
    ([16] * 17, 1, 1, 4, 4, True),                            # the row path's most shared memory
    ([16] * 17, 65535, 100_000, 4, 4, True),
    ([128, 107, 85, 64, 64, 85, 107, 128], 1, 4096, 4, 4, False),
    ([42, 50], 64, 4085, 4, 2, True),                        # the LSTM head over bf16 storage
    ([128] * 17, 3, 7, 4, 4, True),
])
def test_launch_plan_shared_memory_within_a_block(dims, m, n, x_bytes, store_bytes, targets):
    plan = fs.launch_plan(dims, m, n, 132, x_bytes=x_bytes, store_bytes=store_bytes, targets=targets)
    assert plan.smem_bytes <= fs.SMEM_LIMIT == 232_448
    assert 1 <= plan.blocks_per_slot <= math.ceil(n / plan.rows_per_block)
    if plan.path == fs.PATH_ROWS:
        # every tile's rows row_rpt a thread, in whole warps
        assert plan.row_rpt in (1, fs.ROW_RPT)
        assert plan.rows_per_block % (32 * plan.row_rpt) == 0
        assert plan.rows_per_block <= plan.row_rpt * fs.ROW_THREADS_MAX
    else:
        assert plan.blocks_per_slot == math.ceil(n / plan.rows_per_block)


def test_wide_grid_fills_the_card():
    """1 x 4096 x 128 spreads its rows over the card's 132 SMs: 32 rows
    an SM (4096 / 132 up to the tile's four rows), one wave of 128 blocks
    that gives no SM a second."""
    plan = fs.launch_plan([128, 107, 85, 64, 64, 85, 107, 128], m=1, n=4096, sm_count=132)
    assert plan.path == fs.PATH_TILE
    assert plan.rows_per_block == math.ceil(4096 / 132 / fs.TILE_RT) * fs.TILE_RT == 32
    assert plan.blocks_per_slot == 128 <= 132
    # the LSTM head's bucket fills the card many times over
    head = fs.launch_plan([42, 50], m=64, n=4085, sm_count=132)
    assert 64 * head.blocks_per_slot >= 132


@pytest.mark.parametrize("dims, m, n, rpt", [
    ([10, 8, 7, 5, 5, 7, 8, 10], 512, 2048, 2),   # the bench's bucket: two rows a thread
    ([10, 8, 7, 5, 5, 7, 8, 10], 64, 576, 2),
    ([10, 8, 7, 5, 5, 7, 8, 10], 1, 2048, 1),     # a short request: one, more blocks
    ([10, 8, 7, 5, 5, 7, 8, 10], 1, 1, 1),
    ([10], 512, 2048, 1),                        # the epilogue alone: one
])
def test_row_plan_runs_each_slot_in_a_few_blocks(dims, m, n, rpt):
    """The row path's blocks walk runs of their slot's tiles: about
    ROW_BLOCKS_PER_SM blocks an SM in all, at most a tile each; two rows
    a thread where the grid fills the SMs and there are layers."""
    plan = fs.row_plan(dims, m, n, 132)
    tiles = math.ceil(n / plan.rows_per_block)
    assert plan.row_rpt == rpt
    assert plan.blocks_per_slot == min(tiles, max(1, fs.ROW_BLOCKS_PER_SM * 132 // m))
    if m * tiles < 132:
        assert plan.rows_per_block == 32
