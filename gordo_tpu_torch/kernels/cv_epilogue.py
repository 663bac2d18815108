"""``cv_epilogue``: thresholds and CV metrics of each (machine, fold) (K4,
and K8 with row counts).

Replaces the fold epilogue of the XLA program ``fleet.exact``
(``gordo_tpu/parallel/anomaly.py:1155-1170``): ``_smoothed_max`` over
``_trailing_rolling_min`` (``:175``, ``:162``) of the detector-scaled tag
errors and of their L2 total, and the four metrics of
``gordo_tpu/ops/metrics.py``; and that of ``fleet.padded`` (K8,
``:1380-1390``): ``_masked_smoothed_max`` (``:185``) and the row-weighted
metrics under a row mask.  The pad-up build's masks are suffixes, so K8 is
this function over each slot's first ``n`` rows, ``n`` from 0 to ``nt``;
with ``n = 0`` the maxima are 0, explained variance and r2 1, mse and mae
0, and the slot's ``has`` flag 0.  The kernel is CUDA C++ for ``sm_90a``
(``gordo_tpu_torch/csrc/cv_epilogue.cu``, whose header gives its bound and
design); :func:`cv_epilogue_plain` is the same function in plain PyTorch.

The inputs are ``fleet_score``'s outputs over each slot's out-of-fold rows
(tag errors, totals, predictions) and the raw targets.

:func:`launch_plan` chooses the kernel's path on the host: the warp path
(a slot two warps, staged by cp.async, one wave of slots at the build's
shapes) where the slot fits it, else the block path (the first design,
which takes every shape whose one column of sums fits a block's shared
memory); :func:`launch_args` fills the launch arguments from it.

:func:`cv_epilogue` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.scaler_stats import XLA_WINDOW, _in_order, xla_sum
from gordo_tpu_torch.train.cv import METRIC_NAMES

SOURCE = "gordo_tpu_torch/csrc/cv_epilogue.cu"
REPLACES = "gordo_tpu/parallel/anomaly.py:175"

#: rolling-min window of the thresholds (the JAX package's SMOOTHING_WINDOW)
SMOOTHING_WINDOW = 6
MAX_SLOTS = 2 ** 31 - 1
_EPS = 1e-12
#: the metrics that are 1 (not 0) on a slot with no row, as the weighted
#: forms give them
EMPTY_ONE = ("explained_variance_score", "r2_score")

#: the two paths (``CE_PATH_WARP``, ``CE_PATH_BLOCK``)
PATH_WARP, PATH_BLOCK = 0, 1
#: the warp path: two warps a slot, twelve slots an SM (the launch bound),
#: 4 floats of padding after every 32 staged rows, and what it takes
WARP_THREADS = 64
WARP_MIN_BLOCKS = 12
WARP_PAD = 4
WARP_MAX_WINDOW = 8
WARP_MAX_ROWS = 1024
WARP_MAX_COLS = 32
WARP_MAX_SMEM = 48 * 1024
#: the block path (the first design): 128 threads a slot, its launch bound
#: (blocks an SM) by form, the slot staged up to ``BLOCK_STAGE_SMEM`` and
#: the sums' shared memory at most ``BLOCK_MAX_SMEM``
BLOCK_THREADS = 128
BLOCK_MIN_BLOCKS = {False: 8, True: 12}
BLOCK_STAGE_SMEM = 48 * 1024
BLOCK_MAX_SMEM = 200 * 1024
#: an SM's registers
SM_REGISTERS = 65536

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct CvEpilogueArgs`` in the CUDA source."""

    _fields_ = [
        ("tag", ctypes.c_void_p),
        ("total", ctypes.c_void_p),
        ("pred", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("n_rows", ctypes.c_void_p),
        ("feat_max", ctypes.c_void_p),
        ("total_max", ctypes.c_void_p),
        ("metrics", ctypes.c_void_p),
        ("has", ctypes.c_void_p),
        ("s", ctypes.c_int),
        ("nt", ctypes.c_int),
        ("fo", ctypes.c_int),
        ("window", ctypes.c_int),
        ("masked", ctypes.c_int),
        ("chunk", ctypes.c_int),
        ("staged", ctypes.c_int),
        ("path", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("stage16", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


class Plan(NamedTuple):
    """A launch, one block a slot: ``path`` (:data:`PATH_WARP` or
    :data:`PATH_BLOCK`), ``threads`` and ``smem_bytes`` a block, ``regs``
    the most registers a thread takes under the launch bound; the warp
    path's ``vec`` (floats a load of K4's mse and mae windows), the block
    path's ``chunk`` (columns a pass of the metrics) and ``staged`` (the
    slot held in shared memory)."""

    path: int
    threads: int
    smem_bytes: int
    regs: int
    vec: int = 1
    chunk: int = 0
    staged: int = 0


def _windows_of(n: int) -> int:
    return -(-n // XLA_WINDOW)


def _part_floats(nc: int, k: int, n: int) -> int:
    """``xo_part_floats``: the window sums of ``nc`` columns of ``n``
    values, ``k`` sums each, and the level above."""
    level1 = _windows_of(n)
    return nc * k * (level1 + _windows_of(level1))


def _sum2_part_floats(n: int, f: int, k: int) -> int:
    """``xo_sum2_part_floats``: the 2-D window sums of an n x f array."""
    dim = lambda m: _windows_of(m) if m > XLA_WINDOW else 1  # noqa: E731
    r1, c1 = dim(n), dim(f)
    return k * (r1 * c1 + dim(r1) * dim(c1))


def block_smem_floats(nt: int, fo: int, chunk: int, staged: bool, masked: bool) -> int:
    """``ce_smem_floats``: the block path's shared memory in floats."""
    part = max(_part_floats(chunk, 4, nt), _sum2_part_floats(nt, fo, 2), _part_floats(1, 4, fo))
    stage = ((3 if masked else 4) * nt * fo + nt) if staged else 0
    return part + 12 * chunk + 4 * fo + 4 + _sum2_part_floats(nt, fo, 2) + stage


def warp_smem_floats(nt: int, fo: int) -> int:
    """``cw_smem_floats``: the warp path's staged y and pred (4 floats of
    padding after every 32 rows), scores, totals and per-column scores."""
    r4 = lambda v: -(-v // 4) * 4  # noqa: E731
    rows = r4(nt * fo + WARP_PAD * -(-nt // 32))
    return 2 * rows + r4(nt * fo) + r4(nt) + 4 * fo


def _regs(threads: int, min_blocks: int) -> int:
    """The registers a thread may take under ``__launch_bounds__(threads,
    min_blocks)`` (allocated 8 at a time)."""
    return SM_REGISTERS // (threads * min_blocks) // 8 * 8


def launch_plan(nt: int, fo: int, window: int = SMOOTHING_WINDOW, masked: bool = False) -> Plan:
    """The launch for slots of ``nt`` rows of ``fo`` columns: the warp path
    where fo <= 32, nt <= 1,024, the window at most 8 rows and the staged
    slot within 48 KB; else the block path, the slot staged where every
    column's sums fit beside it within 48 KB, its columns in chunks that
    fit 200 KB.  Raises ``NotImplementedError`` where one column's sums do
    not fit (the block path's refusal)."""
    if fo <= WARP_MAX_COLS and nt <= WARP_MAX_ROWS and 1 <= window <= WARP_MAX_WINDOW:
        smem = 4 * warp_smem_floats(nt, fo)
        if smem <= WARP_MAX_SMEM:
            vec = 4 if fo % 4 == 0 else 2 if fo % 2 == 0 else 1
            return Plan(PATH_WARP, WARP_THREADS, smem, _regs(WARP_THREADS, WARP_MIN_BLOCKS), vec=vec)
    staged = 4 * block_smem_floats(nt, fo, fo, True, masked) <= BLOCK_STAGE_SMEM
    chunk = fo
    while chunk > 0 and 4 * block_smem_floats(nt, fo, chunk, staged, masked) > BLOCK_MAX_SMEM:
        chunk -= 1
    if chunk < 1:
        raise NotImplementedError(
            f"cv_epilogue cannot take slots of {nt} rows x {fo} columns: one column's sums "
            f"need more than {BLOCK_MAX_SMEM} bytes of shared memory"
        )
    return Plan(PATH_BLOCK, BLOCK_THREADS, 4 * block_smem_floats(nt, fo, chunk, staged, masked),
                _regs(BLOCK_THREADS, BLOCK_MIN_BLOCKS[bool(masked)]), chunk=chunk, staged=int(staged))



_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("cv_epilogue")
            lib.cv_epilogue_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.cv_epilogue_launch.restype = ctypes.c_int
            lib.cv_epilogue_error_string.argtypes = [ctypes.c_int]
            lib.cv_epilogue_error_string.restype = ctypes.c_char_p
            lib.cv_epilogue_args_size.argtypes = []
            lib.cv_epilogue_args_size.restype = ctypes.c_int
            if lib.cv_epilogue_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"cv_epilogue: CvEpilogueArgs is {lib.cv_epilogue_args_size()} "
                    f"bytes in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


def _validate(tag, total, pred, y, n_rows) -> np.ndarray:
    if tag.dim() != 3:
        raise ValueError(f"tag must be (S, nt, fo), got shape {tuple(tag.shape)}")
    S, nt, fo = (int(s) for s in tag.shape)
    for name, t, shape in (
        ("tag", tag, (S, nt, fo)), ("total", total, (S, nt)),
        ("pred", pred, (S, nt, fo)), ("y", y, (S, nt, fo)),
    ):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != tag.device:
            raise ValueError(f"{name} is on {t.device}, tag on {tag.device}")
    if not 1 <= S <= MAX_SLOTS or fo < 1:
        raise ValueError(f"need >= 1 slot and >= 1 column, got {tuple(tag.shape)}")
    rows = np.full(S, nt, np.int64) if n_rows is None else np.asarray(n_rows, np.int64)
    if rows.shape != (S,) or rows.min() < 0 or rows.max() > nt:
        raise ValueError(f"n_rows must be (S,) = ({S},) ints in [0, {nt}]")
    return rows


def cv_epilogue(
    tag: torch.Tensor,
    total: torch.Tensor,
    pred: torch.Tensor,
    y: torch.Tensor,
    n_rows=None,
    window: int = SMOOTHING_WINDOW,
    masked: bool = False,
) -> Dict[str, torch.Tensor]:
    """Per slot: ``feature_max`` (S, fo) and ``total_max`` (S,), the
    smoothed maxima of ``tag`` (S, nt, fo) and ``total`` (S, nt), and the
    four metrics (S,) of ``pred`` against ``y`` (S, nt, fo), over the
    first ``n_rows[s]`` rows of each slot (host ints in [0, nt]; default
    nt), and ``has`` (S,), 1 where a slot has a row and 0 where it has
    none (whose maxima are 0, explained variance and r2 1, mse and mae 0).
    ``masked``: the pad-up build's epilogue (K8), which maps a maximum that
    is not finite to 0, as ``_masked_smoothed_max`` does; the exact one
    (K4) keeps NaN and inf."""
    if tag.device.type == "cpu":
        return cv_epilogue_plain(tag, total, pred, y, n_rows, window, masked)
    if tag.device.type != "cuda":
        raise ValueError(f"cv_epilogue runs on cuda or cpu tensors, got {tag.device}")
    args, out, keep = launch_args(tag, total, pred, y, n_rows, window, masked)  # noqa: F841 (keep: alive past the launch)
    device = tag.device
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cv_epilogue_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"cv_epilogue launch failed: {lib.cv_epilogue_error_string(rc).decode()}"
        )
    global launches
    with _launches_lock:
        launches += 1
    return out


def launch_args(tag, total, pred, y, n_rows=None, window: int = SMOOTHING_WINDOW, masked: bool = False):
    """The kernel's arguments for one launch (no launch): ``(_Args, the
    outputs as :func:`cv_epilogue` returns them, the device row counts or
    None where every slot has all nt rows)``,
    the path and shape from :func:`launch_plan`, rows staged 16 bytes a
    copy where every slot's rows (and, apart, its totals) start 16-byte
    aligned."""
    rows = _validate(tag, total, pred, y, n_rows)
    S, nt, fo = (int(s) for s in tag.shape)
    plan = launch_plan(nt, fo, int(window), masked)
    device = tag.device
    # every slot full (an exact group's equal folds): no counts uploaded
    rows_dev = None if rows.min() == nt else to_device(rows.astype(np.int32), device)
    feat_max = torch.empty((S, fo), dtype=torch.float32, device=device)
    total_max = torch.empty((S,), dtype=torch.float32, device=device)
    metrics = torch.empty((S, 4), dtype=torch.float32, device=device)
    has = torch.empty((S,), dtype=torch.float32, device=device)
    args = _Args()
    args.tag, args.total, args.pred, args.y = (
        tag.data_ptr(), total.data_ptr(), pred.data_ptr(), y.data_ptr()
    )
    args.n_rows = None if rows_dev is None else rows_dev.data_ptr()
    args.feat_max, args.total_max, args.metrics = (
        feat_max.data_ptr(), total_max.data_ptr(), metrics.data_ptr()
    )
    args.has = has.data_ptr()
    args.s, args.nt, args.fo, args.window = S, nt, fo, int(window)
    args.masked = int(masked)
    args.path, args.vec, args.chunk, args.staged = plan.path, plan.vec, plan.chunk, plan.staged
    args.smem_bytes = plan.smem_bytes
    aligned = lambda t: t.data_ptr() % 16 == 0  # noqa: E731
    args.stage16 = (int(nt * fo % 4 == 0 and all(aligned(t) for t in (tag, pred, y)))
                    | 2 * int(nt % 4 == 0 and aligned(total)))
    out = {"feature_max": feat_max, "total_max": total_max, "has": has}
    out.update({name: metrics[:, i] for i, name in enumerate(METRIC_NAMES)})
    return args, out, rows_dev


def smoothed_max(err: torch.Tensor, window: int = SMOOTHING_WINDOW) -> torch.Tensor:
    """Max over rows of the trailing rolling min (``min_periods=1``) of
    ``err`` (..., n, F) → (..., F), propagating NaN as XLA's reductions do."""
    pad = err.new_full(err.shape[:-2] + (window - 1, err.shape[-1]), torch.inf)
    windows = torch.cat([pad, err], dim=-2).unfold(-2, window, 1)
    return windows.amin(dim=-1).amax(dim=-2)


def xla_sum2(a: torch.Tensor) -> torch.Tensor:
    """The float32 sum of ``a`` (S, n, F) over its last two dimensions in
    XLA:CPU's order: each dimension longer than :data:`XLA_WINDOW` is cut
    into windows of it (padded with zeros, half in front), a shorter one
    is one window; each window is summed row-major in order, and the grid
    of window sums is reduced the same way until no dimension is longer,
    then row-major in order (``csrc/xla_order.cuh``)."""
    S, n, F = a.shape
    if n <= XLA_WINDOW and F <= XLA_WINDOW:
        return _in_order(a.reshape(S, n * F), 1)
    (wr, lr, nr), (wc, lc, nc) = _windows(n), _windows(F)
    pad = a.new_zeros((S, nr * wr, nc * wc))
    pad[:, lr: lr + n, lc: lc + F] = a
    blocks = pad.reshape(S, nr, wr, nc, wc).permute(0, 1, 3, 2, 4).reshape(S, nr, nc, wr * wc)
    return xla_sum2(_in_order(blocks, 3))


def _windows(n: int):
    """``(width, padding in front, windows)`` of a dimension of ``n``."""
    if n <= XLA_WINDOW:
        return n, 0, 1
    m = -(-n // XLA_WINDOW) * XLA_WINDOW
    return XLA_WINDOW, (m - n) // 2, m // XLA_WINDOW


def column_mean(a: torch.Tensor, n: int, masked: bool) -> torch.Tensor:
    """Each column's mean of slots ``a`` (s, L, fo) whose first ``n`` rows
    are real, (s, fo), as the CV metrics take it: ``jnp.mean(a, axis=0)``,
    the sum in XLA:CPU's window order times ``1 / n``, or (``masked``)
    the weighted mean ``sum(a * w) / sum(w)`` over the L rows, the rows
    past ``n`` adding 0."""
    if not masked:
        return xla_sum(a) * (torch.tensor(1.0, device=a.device) / float(n))
    real = (torch.arange(a.shape[1], device=a.device) < n)[None, :, None]
    return xla_sum(torch.where(real, a, torch.zeros_like(a))) / torch.tensor(float(n), device=a.device)


def fold_metrics(y: torch.Tensor, pred: torch.Tensor, n: int, masked: bool) -> Dict[str, torch.Tensor]:
    """The four CV metrics of slots ``y``, ``pred`` (s, L, fo) whose first
    ``n`` rows are real, as the JAX programs sum them (XLA:CPU's window
    order, :func:`xla_sum`), each (s,).  Exact (K4, ``gordo_tpu/ops/
    metrics.py:26-52``): ``L == n``; a mean is the sum times ``1 / n``;
    ``jnp.var`` centres again (three passes); mse and mae are whole-array
    means (:func:`xla_sum2`).  Masked (K8, ``:67-104``): the sums run over
    the L rows of the padded fold, the rows past ``n`` adding 0; a
    weighted mean divides by ``n``; mse and mae are column means."""
    L, fo = int(y.shape[1]), int(y.shape[2])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=y.device)  # noqa: E731
    real = (torch.arange(L, device=y.device) < n)[None, :, None]
    zero = lambda a: torch.where(real, a, torch.zeros_like(a))  # noqa: E731
    eps = f32(_EPS)
    nf = f32(float(n))
    mean = lambda a: column_mean(a, n, masked)  # noqa: E731
    d = y - pred
    my, md = mean(y), mean(d)
    cy, cd = y - my[:, None], d - md[:, None]
    if masked:
        den, num = mean(cy * cy), mean(cd * cd)
    else:
        ey, ed = cy - mean(cy)[:, None], cd - mean(cd)[:, None]
        den, num = mean(ey * ey), mean(ed * ed)
    ss_res, ss_tot = xla_sum(zero(d * d)), xla_sum(zero(cy * cy))
    inv_fo = f32(1.0) / f32(float(fo))
    per = lambda a: xla_sum(a) * inv_fo  # noqa: E731
    out = {
        "explained_variance_score": per(1.0 - num / torch.maximum(den, eps)),
        "r2_score": per(1.0 - ss_res / torch.maximum(ss_tot, eps)),
    }
    if masked:
        out["mean_squared_error"] = per(xla_sum(zero(d * d)) / nf)
        out["mean_absolute_error"] = per(xla_sum(zero(d.abs())) / nf)
    else:
        inv_all = f32(1.0) / f32(float(n * fo))
        out["mean_squared_error"] = xla_sum2(d * d) * inv_all
        out["mean_absolute_error"] = xla_sum2(d.abs()) * inv_all
    return out


def cv_epilogue_plain(
    tag: torch.Tensor,
    total: torch.Tensor,
    pred: torch.Tensor,
    y: torch.Tensor,
    n_rows=None,
    window: int = SMOOTHING_WINDOW,
    masked: bool = False,
) -> Dict[str, torch.Tensor]:
    """:func:`cv_epilogue` in plain PyTorch (:func:`fold_metrics` for the
    metrics); slots of equal row counts go together."""
    rows = _validate(tag, total, pred, y, n_rows)
    S, nt, fo = tag.shape
    out = {
        "feature_max": tag.new_zeros((S, fo)),
        "total_max": tag.new_zeros((S,)),
        "has": torch.as_tensor(rows > 0, dtype=torch.float32, device=tag.device),
        **{name: tag.new_full((S,), float(name in EMPTY_ONE)) for name in METRIC_NAMES},
    }
    for n in np.unique(rows[rows > 0]):
        sel = torch.as_tensor(np.flatnonzero(rows == n), device=tag.device)
        pick = lambda t: t.index_select(0, sel)[:, :n]  # noqa: E731
        out["feature_max"][sel] = smoothed_max(pick(tag), window)
        out["total_max"][sel] = smoothed_max(pick(total)[..., None], window)[:, 0]
        layout = nt if masked else int(n)
        metrics = fold_metrics(y.index_select(0, sel)[:, :layout], pred.index_select(0, sel)[:, :layout],
                               int(n), masked)
        for name in METRIC_NAMES:
            out[name][sel] = metrics[name]
    if masked:
        for key in ("feature_max", "total_max"):
            v = out[key]
            out[key] = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    return out
