"""``scaler_stats``: MinMax and Standard stats of many machines over many
row lists, through a chain's earlier steps (K3).

Replaces ``MinMaxScaler.compute_stats`` (``gordo_tpu/ops/scalers.py:139``)
and ``StandardScaler.compute_stats`` (``:169-177``) as the XLA programs
``fleet.exact`` and ``fleet.padded`` run them per machine, on every fold's
rows, the full series and (for the detector scaler) the targets, each
pipeline step on the previous step's output
(``gordo_tpu/parallel/anomaly.py:196-214,1124,1327``).  The kernel is CUDA
C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/scaler_stats.cu``, whose header
gives its bound and design); :func:`scaler_stats_plain` is the same
function in plain PyTorch.

The ``"mean"`` and ``"nanmean"`` statistics serve the single-machine
transforms: ``PCA.fit``'s ``jnp.mean`` (``gordo_tpu/ops/scalers.py:331``:
a NaN gives a NaN mean) and ``SimpleImputer(strategy="mean")``'s
``jnp.nanmean`` (``:291``).  They sum in XLA:CPU's tree order
(:func:`xla_sum`), so that they are the JAX package's bit for bit; they
take no prefix, a row list of at most :data:`MEAN_MAX_ROWS` rows, and
their launches also count in :data:`mean_launches`.  The ``"standard"``
statistic sums its mean and its squared deviations in the same order
(its mean the JAX package's bit for bit: on a column far from zero
against its spread another order moves it by ulps of the level), within
the same row limit.

A chain prefix (``prefix``) is a sequence of ``(form, a, b)``: an earlier
step's map with its stats ``a``, ``b`` (M, G, F), applied to every value
as it loads, ``x * a + b`` for :data:`AFFINE` (MinMax), ``(x - a) / b``
for :data:`CENTER` (Standard, Robust).  ``scaler_quantiles`` takes the
same prefixes.  The kernels that load scaled rows (``fleet_fit``,
``fleet_score``, ``stream_step``, ``lstm_layer`` and ``lstm_layer_bwd``)
take a whole chain in the same form, :class:`ScalerChain` in their launch
arguments (``csrc/scaler_prefix.cuh``), and the detector scaler as a chain
of one step (none: the identity); :func:`apply_steps` is the chain in
plain PyTorch.

:func:`scaler_stats` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_init import fma as fused

SOURCE = "gordo_tpu_torch/csrc/scaler_stats.cu"
REPLACES = "gordo_tpu/ops/scalers.py:139"
#: the Standard statistic's TPU program (the ``standard`` stat)
REPLACES_STANDARD = "gordo_tpu/ops/scalers.py:169"
#: the mean statistics' (PCA.fit's mean; SimpleImputer's nanmean)
REPLACES_MEAN = "gordo_tpu/ops/scalers.py:331"

MAX_FITS = 16
MAX_MACHINES = 65535
#: the steps a chain holds (``SP_MAX_STEPS``), and the earlier ones a stat
#: launch applies (``SP_MAX_PREFIX``)
MAX_STEPS = 5
MAX_PREFIX = MAX_STEPS - 1
#: the two forms of a chain step's map (``scaler_prefix.cuh``)
AFFINE, CENTER = 0, 1
#: XLA:CPU's reduction window (``SS_WINDOW``) and the longest row list the
#: means' window sums fit (``SS_MEAN_SMEM`` of shared memory:
#: ``scaler_stats_mean_max_rows``)
XLA_WINDOW = 32
MEAN_MAX_ROWS = 1_588_736
#: the longest row list one block sums (``SS_THREADS`` windows); past it a
#: block per 1,024 rows (a level-2 window) and a scratch of their sums
ONE_BLOCK_ROWS = 8_192
STATS = ("minmax", "standard", "mean", "nanmean")
#: the MinMax statistic's paths (``MM_NESTED``, ``MM_LIST``, ``MM_SPLIT``),
#: a block's threads, and the values a block of the split path reads
NESTED, LIST, SPLIT = 0, 1, 2
PATH_NAMES = ("nested", "list", "split")
THREADS = 256
SPLIT_VALUES = 4096
#: a block's threads on the nested and list paths' float4 loads (measured
#: faster than THREADS there, slower on the split path's and row loads)
RANGE_THREADS = 128
_EPS = 1e-12

#: kernel launches so far, and those of the Standard and the mean
#: statistics among them (the CPU path never counts)
launches = 0
standard_launches = 0
mean_launches = 0
_launches_lock = threading.Lock()

#: a scaler chain's steps in order, each ``(form, a, b)``
Prefix = Sequence[Tuple[int, torch.Tensor, torch.Tensor]]


class ScalerChain(ctypes.Structure):
    """Mirror of ``struct ScalerPrefix`` in ``csrc/scaler_prefix.cuh``."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("form", ctypes.c_int * MAX_STEPS),
        ("a", ctypes.c_void_p * MAX_STEPS),
        ("b", ctypes.c_void_p * MAX_STEPS),
    ]

    def fill(self, steps: Prefix) -> None:
        self.n = len(steps)
        for i, (form, a, b) in enumerate(steps):
            self.form[i] = int(form)
            self.a[i], self.b[i] = a.data_ptr(), b.data_ptr()


def check_steps(steps: Prefix, shape, device, dtypes, what: str, max_steps: int = MAX_STEPS) -> None:
    """Raise for a chain a kernel does not take: more than ``max_steps``
    steps, forms other than :data:`AFFINE` and :data:`CENTER`, stats not
    contiguous of ``shape`` at one of ``dtypes`` on ``device``."""
    if len(steps) > max_steps:
        raise NotImplementedError(
            f"a {what} of {len(steps)} steps: the kernels take at most {max_steps}"
        )
    for form, a, b in steps:
        if form not in (AFFINE, CENTER):
            raise ValueError(f"a {what} step's form must be AFFINE or CENTER, got {form!r}")
        for t in (a, b):
            if (tuple(t.shape) != tuple(shape) or t.dtype not in dtypes
                    or t.device != device or not t.is_contiguous()):
                raise ValueError(
                    f"a {what} step's stats must be contiguous {tuple(shape)} of "
                    f"{' or '.join(str(d).replace('torch.', '') for d in dtypes)} on {device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )


def apply_steps(x: torch.Tensor, steps: Prefix, view=lambda t: t) -> torch.Tensor:
    """``x`` through the chain's steps in plain PyTorch, each in the
    reference's form, its stats widened to float32 and shaped by ``view``
    to broadcast against ``x``: an :data:`AFFINE` step one FMA, rounded
    once as every XLA program that applies a MinMax step fuses it
    (``fleet_init.fma``), a :data:`CENTER` step a difference and a
    quotient, each rounded."""
    for form, a, b in steps:
        pa, pb = view(a.float()), view(b.float())
        x = fused(x, pa, pb) if form == AFFINE else (x - pa) / pb
    return x


class _Args(ctypes.Structure):
    """Mirror of ``struct ScalerStatsArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("out0", ctypes.c_void_p),
        ("out1", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("g", ctypes.c_int),
        ("fit_rows", ctypes.c_int * MAX_FITS),
        ("fit_row_off", ctypes.c_int * MAX_FITS),
        ("stat", ctypes.c_int),
        ("range_lo", ctypes.c_float),
        ("range_span", ctypes.c_float),
        ("offset_fma", ctypes.c_int),
        ("with_mean", ctypes.c_int),
        ("with_std", ctypes.c_int),
        ("prefix", ScalerChain),
        ("part2", ctypes.c_void_p),
        ("ints", ctypes.c_void_p),
        ("mm_path", ctypes.c_int),
        ("mm_vec", ctypes.c_int),
        ("mm_active", ctypes.c_int),
        ("mm_cw", ctypes.c_int),
        ("mm_period", ctypes.c_int),
        ("mm_nseg", ctypes.c_int),
        ("mm_chunk_rows", ctypes.c_int),
        ("mm_threads", ctypes.c_int),
        ("mm_seg_end", ctypes.c_int * MAX_FITS),
        ("mm_list_seg", ctypes.c_int * MAX_FITS),
    ]


class MinMaxPlan(NamedTuple):
    """The MinMax statistic's launch: ``path`` (:data:`NESTED`,
    :data:`LIST` or :data:`SPLIT`), ``vec`` (4: float4 loads along a range,
    a thread's four values at ``(4 t + v) % F``; 1: column ``t % cw`` of a
    row), ``threads`` a block and the ``active`` ones that load, ``cw``
    columns a group, ``period`` lanes after which a warp's columns repeat;
    the nested path's segments (``segments``: each one's end position,
    ascending; ``list_segment``: each row list's last) and the split
    path's ``chunk_rows`` positions a block; ``grid`` the blocks."""

    path: int
    vec: int
    threads: int
    active: int
    cw: int
    period: int
    segments: Tuple[int, ...]
    list_segment: Tuple[int, ...]
    chunk_rows: int
    grid: Tuple[int, int, int]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("scaler_stats")
            lib.scaler_stats_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.scaler_stats_launch.restype = ctypes.c_int
            lib.scaler_stats_error_string.argtypes = [ctypes.c_int]
            lib.scaler_stats_error_string.restype = ctypes.c_char_p
            for name in ("scaler_stats_args_size", "scaler_stats_mean_max_rows"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_int
            if lib.scaler_stats_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"scaler_stats: ScalerStatsArgs is {lib.scaler_stats_args_size()} "
                    f"bytes in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            if lib.scaler_stats_mean_max_rows() != MEAN_MAX_ROWS:
                raise RuntimeError("scaler_stats: scaler_stats_mean_max_rows() differs from MEAN_MAX_ROWS")
            _lib = lib
        return _lib


def validate(x: torch.Tensor, row_lists, prefix: Prefix = ()) -> Tuple[int, int, int, list]:
    """Check the stat kernels' common arguments; returns ``(M, N, F,
    row lists as int64 arrays)``."""
    if x.dim() != 3:
        raise ValueError(f"x must be (M, N, F), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("x must be contiguous float32")
    M, N, F = (int(s) for s in x.shape)
    if not 1 <= M <= MAX_MACHINES or F < 1:
        raise ValueError(f"x must have 1..{MAX_MACHINES} machines and >= 1 column")
    if not 1 <= len(row_lists) <= MAX_FITS:
        raise ValueError(f"need 1..{MAX_FITS} row lists, got {len(row_lists)}")
    lists = []
    for rows in row_lists:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim != 1 or rows.size < 1 or rows.min() < 0 or rows.max() >= N:
            raise ValueError(f"each row list must be non-empty, 1-D and lie in [0, {N})")
        lists.append(rows)
    if len(prefix) > MAX_PREFIX:
        raise NotImplementedError(
            f"a chain of {len(prefix) + 1} scaler steps: the stat kernels apply at most "
            f"{MAX_PREFIX} earlier steps"
        )
    check_steps(prefix, (M, len(lists), F), x.device, (torch.float32,), "prefix")
    return M, N, F, lists


def fill_launch(args, x: torch.Tensor, lists, prefix: Prefix = ()) -> Optional[torch.Tensor]:
    """Set the launch fields the stat kernels share (``x``, ``rows``,
    shapes, row lists, and a prefix where there is one) in ``args``;
    returns the device row index tensor, which must live until the launch
    is enqueued.  Where every row list is a range of consecutive rows
    (TimeSeriesSplit's folds, the whole series) no index is uploaded: the
    kernels take row ``start + i`` (``RowList`` in
    ``csrc/scaler_prefix.cuh``), ``fit_row_off`` each range's start."""
    M, N, F = (int(s) for s in x.shape)
    args.x = x.data_ptr()
    args.m, args.n, args.f, args.g = M, N, F, len(lists)
    ranges = _ranges(lists)
    rows, off = None, 0
    if not ranges:
        rows = to_device(np.concatenate(lists).astype(np.int32), x.device)
    args.rows = None if rows is None else rows.data_ptr()
    for i, r in enumerate(lists):
        args.fit_rows[i] = int(r.size)
        args.fit_row_off[i] = int(r[0]) if ranges else off
        off += int(r.size)
    if prefix:
        args.prefix.fill(prefix)
    return rows


def _ranges(lists) -> bool:
    """Every row list a range of consecutive rows."""
    return all(r[-1] - r[0] == r.size - 1 and bool(np.all(np.diff(r) == 1)) for r in lists)


def launch_plan(shape, row_lists, prefix_steps: int = 0, aligned: bool = True) -> MinMaxPlan:
    """The MinMax statistic's launch for ``x`` of ``shape`` (M, N, F) over
    ``row_lists``, after ``prefix_steps`` chain steps, ``aligned`` where
    ``x`` starts 16-byte aligned.  Past :data:`ONE_BLOCK_ROWS` positions in
    a row list, the split path; else, every list a range from one row and
    no prefix, the nested path; else the list path.  Float4 loads where
    every list is a range, F <= 256 and every range a block starts at
    begins 16-byte aligned (every machine's rows too); else a row's
    columns on consecutive threads."""
    M, N, F = (int(v) for v in shape)
    lists = [np.asarray(r, np.int64) for r in row_lists]
    sizes = [int(r.size) for r in lists]
    ranges = _ranges(lists)
    starts = [int(r[0]) for r in lists]
    longest = max(sizes)
    segments, list_segment, chunk_rows = (), (), 0
    if longest > ONE_BLOCK_ROWS:
        path = SPLIT
        chunk_rows = -(-max(32, SPLIT_VALUES // F) // 32) * 32
        grid = (-(-longest // chunk_rows), M, len(lists))
        firsts = [s + k for s in starts for k in range(0, longest, chunk_rows)]
    elif ranges and not prefix_steps and len(set(starts)) == 1:
        path = NESTED
        segments = tuple(sorted(set(sizes)))
        list_segment = tuple(segments.index(n) for n in sizes)
        grid = (M, 1, 1)
        firsts = [starts[0] + b for b in (0,) + segments[:-1]]
    else:
        path = LIST
        grid = (len(lists), M, 1)
        firsts = starts
    vec4 = (ranges and F <= THREADS and aligned and (M == 1 or N * F % 4 == 0)
            and all(f * F % 4 == 0 for f in firsts))
    if vec4:
        period = F // math.gcd(F, 4)
        threads = RANGE_THREADS if path != SPLIT and period <= RANGE_THREADS else THREADS
        return MinMaxPlan(path, 4, threads, threads // period * period, F, period, segments, list_segment,
                          chunk_rows, grid)
    cw = min(F, THREADS)
    return MinMaxPlan(path, 1, THREADS, THREADS // cw * cw, cw, cw, segments, list_segment, chunk_rows, grid)


def fill_minmax(args, plan: MinMaxPlan) -> None:
    """The plan's fields of the launch arguments."""
    args.mm_path, args.mm_vec, args.mm_active = plan.path, plan.vec, plan.active
    args.mm_cw, args.mm_period, args.mm_chunk_rows = plan.cw, plan.period, plan.chunk_rows
    args.mm_nseg = max(1, len(plan.segments))
    args.mm_threads = plan.threads
    for i, end in enumerate(plan.segments):
        args.mm_seg_end[i] = end
    for i, k in enumerate(plan.list_segment):
        args.mm_list_seg[i] = k


def scaler_stats(
    x: torch.Tensor,
    row_lists: Sequence,
    feature_range=(0.0, 1.0),
    stat: str = "minmax",
    with_mean: bool = True,
    with_std: bool = True,
    prefix: Prefix = (),
    offset_fma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``stat`` of each machine of ``x`` (M, N, F) over each of the
    ``G`` host row lists in ``row_lists``, each value first taken through
    ``prefix``: ``"minmax"`` gives MinMax ``(scale, offset)`` for
    ``feature_range``, ``"standard"`` gives ``(mean, std)``, ``"mean"``
    and ``"nanmean"`` give ``(mean, values summed)``; each (M, G, F).
    ``offset_fma``: the MinMax offset ``a - lo * scale`` rounded once, as
    the fleet programs' XLA fusions compute it (``fleet.exact`` and
    ``fleet.padded``, after any step or none); the reference's eager
    ``fit`` rounds the product and the difference apart."""
    if stat not in STATS:
        raise ValueError(f"stat must be one of {STATS}, got {stat!r}")
    if prefix and stat in ("mean", "nanmean"):
        raise ValueError(f"the {stat} statistic takes no chain prefix")
    if x.device.type == "cpu":
        return scaler_stats_plain(x, row_lists, feature_range, stat, with_mean, with_std, prefix,
                                  offset_fma)
    if x.device.type != "cuda":
        raise ValueError(f"scaler_stats runs on cuda or cpu tensors, got {x.device}")
    M, N, F, lists = validate(x, row_lists, prefix)
    if stat != "minmax":
        _check_mean_rows(lists)
    out0 = torch.empty((M, len(lists), F), dtype=torch.float32, device=x.device)
    out1 = torch.empty_like(out0)
    a, b = feature_range
    args = _Args()
    rows = fill_launch(args, x, lists, prefix)  # noqa: F841 (kept alive past the launch)
    args.out0, args.out1 = out0.data_ptr(), out1.data_ptr()
    args.stat = STATS.index(stat)
    args.range_lo, args.range_span = float(a), float(b - a)
    args.offset_fma = int(bool(offset_fma))
    args.with_mean, args.with_std = int(bool(with_mean)), int(bool(with_std))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part2 = None
        longest = max(int(r.size) for r in lists)
        if stat == "minmax":
            plan = launch_plan(x.shape, lists, len(prefix), x.data_ptr() % 16 == 0)
            fill_minmax(args, plan)
            if plan.path == SPLIT:
                args.ints = _zeroed_ints(x.device, stream, (2 * F + 1) * M * len(lists)).data_ptr()
        elif longest > ONE_BLOCK_ROWS:
            level1 = -(-longest // XLA_WINDOW)
            level2 = -(-level1 // XLA_WINDOW) if level1 > XLA_WINDOW else 1
            part2 = torch.empty(M * len(lists) * F * level2, dtype=torch.float32, device=x.device)
            args.part2 = part2.data_ptr()
            args.ints = _zeroed_ints(x.device, stream, 2 * M * len(lists) * F).data_ptr()
        rc = lib.scaler_stats_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"scaler_stats launch failed: {lib.scaler_stats_error_string(rc).decode()}"
        )
    global launches, standard_launches, mean_launches
    with _launches_lock:
        launches += 1
        standard_launches += stat == "standard"
        mean_launches += stat in ("mean", "nanmean")
    return out0, out1


_zeroed: dict = {}
_zeroed_lock = threading.Lock()


def _zeroed_ints(device, stream: int, n: int) -> torch.Tensor:
    """A scratch of at least ``n`` int32 zeros for launches on ``stream``
    (each launch leaves it zero again: its counts and tickets), kept per
    device and stream."""
    key = (device.index, stream)
    with _zeroed_lock:
        buf = _zeroed.get(key)
        if buf is None or buf.numel() < n:
            buf = _zeroed[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        return buf


def _check_mean_rows(lists) -> None:
    longest = max(int(r.size) for r in lists)
    if longest > MEAN_MAX_ROWS:
        raise NotImplementedError(
            f"the mean of a {longest}-row series waits for ROADMAP queue 1 item 20 (long series): "
            f"scaler_stats' means take at most {MEAN_MAX_ROWS} rows a row list"
        )


def xla_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The float32 sum over ``dim`` in XLA:CPU's order: more than
    :data:`XLA_WINDOW` values are padded with zeros to a multiple of it
    (half the padding in front), summed window by window in order, and
    the window sums reduced the same way."""
    x = x.movedim(dim, 0)
    while x.shape[0] > XLA_WINDOW:
        n = int(x.shape[0])
        m = -(-n // XLA_WINDOW) * XLA_WINDOW
        lo = (m - n) // 2
        pad = x.new_zeros((m,) + tuple(x.shape[1:]))
        pad[lo: lo + n] = x
        x = _in_order(pad.reshape((m // XLA_WINDOW, XLA_WINDOW) + tuple(x.shape[1:])), 1)
    return _in_order(x, 0)


def _in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = torch.zeros_like(x.select(dim, 0))
    for i in range(int(x.shape[dim])):
        s = s + x.select(dim, i)
    return s


def apply_prefix(xs: torch.Tensor, prefix: Prefix, g: int) -> torch.Tensor:
    """Row list ``g``'s rows ``xs`` (M, n, F) through the prefix's steps,
    each in the reference's form (:func:`apply_steps`)."""
    return apply_steps(xs, prefix, lambda t: t[:, g, None, :])


def scaler_stats_plain(
    x: torch.Tensor,
    row_lists: Sequence,
    feature_range=(0.0, 1.0),
    stat: str = "minmax",
    with_mean: bool = True,
    with_std: bool = True,
    prefix: Prefix = (),
    offset_fma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scaler_stats` in plain PyTorch, with ``jnp.nanmin``/
    ``jnp.nanmax`` and ``jnp.nanmean``/``jnp.nanstd`` (ddof 0) semantics:
    NaN skipped, an all-NaN column NaN; ``jnp.mean`` for ``"mean"``."""
    if stat not in STATS:
        raise ValueError(f"stat must be one of {STATS}, got {stat!r}")
    if prefix and stat in ("mean", "nanmean"):
        raise ValueError(f"the {stat} statistic takes no chain prefix")
    _, _, _, lists = validate(x, row_lists, prefix)
    eps = torch.tensor(_EPS, device=x.device)
    outs0, outs1 = [], []
    for g, rows in enumerate(lists):
        xs = apply_prefix(x.index_select(1, torch.as_tensor(rows, device=x.device)), prefix, g)
        nan = torch.isnan(xs)
        if stat == "minmax":
            a, b = feature_range
            lo = torch.where(nan, torch.inf, xs).amin(dim=1)
            hi = torch.where(nan, -torch.inf, xs).amax(dim=1)
            empty = nan.all(dim=1)
            lo = torch.where(empty, torch.nan, lo)
            hi = torch.where(empty, torch.nan, hi)
            # torch.maximum keeps a NaN, as jnp.maximum does
            scale = (b - a) / torch.maximum(hi - lo, eps)
            outs0.append(scale)
            if offset_fma:
                outs1.append(fused(-lo, scale, torch.tensor(float(a), device=x.device)))
            else:
                outs1.append(a - lo * scale)
            continue
        if stat in ("mean", "nanmean"):
            _check_mean_rows([rows])
            if stat == "mean":
                count = torch.full_like(xs[:, 0], float(xs.shape[1]))
                outs0.append(xla_sum(xs) * (1.0 / count))
            else:
                count = (~nan).sum(dim=1).to(torch.float32)
                outs0.append(xla_sum(torch.where(nan, 0.0, xs)) / count)
            outs1.append(count)
            continue
        _check_mean_rows([rows])
        count = (~nan).sum(dim=1).to(torch.float32)
        mean = xla_sum(torch.where(nan, 0.0, xs)) / count
        dev = torch.where(nan, 0.0, xs - mean[:, None])
        std = torch.maximum(torch.sqrt(xla_sum(dev * dev) / count), eps)
        outs0.append(mean if with_mean else torch.zeros_like(mean))
        outs1.append(std if with_std else torch.ones_like(std))
    return torch.stack(outs0, dim=1), torch.stack(outs1, dim=1)
