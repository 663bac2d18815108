"""``stream_step``: one arriving row of one machine's stream, scored (K9).

Replaces the XLA program ``serve.stream_step``
(``gordo_tpu/serve/stream.py:175`` ``_stream_step_fn``, registered at
``:275``).  :func:`stream_step` shifts the ring (into the other half of
a double buffer) and scores the newest row: its dense stack (or an LSTM's
last-layer state of the newest window through its ``out`` head) and the
detector's tag scores, carried with the W rows' earlier tag scores
(``tags_in`` → ``tags_out``, another double buffer), every row's L2 total
at its position, the masked nanmedian over the W raw scores (each series
sorted), validity and confidence, into one (fo + 3) verdict.  Without
``tags_in`` it scores all W rows: the mode that primes the carried tags.
For an LSTM chain :func:`stream_shift` shifts the ring first,
``lstm_layer`` runs over the shifted ring's newest window (all W when
priming), and :func:`stream_step` scores (``h``).  The kernel is CUDA C++
for ``sm_90a`` (``gordo_tpu_torch/csrc/stream_step.cu``, whose header
gives its bound and design); :func:`stream_step_plain` and
:func:`stream_shift_plain` are the same functions in plain PyTorch,
through ``fleet_score_plain``.

Both wrappers take the plain version only for tensors on the CPU.  For
CUDA tensors they launch the kernel or raise, and add one per launch to
:data:`launches` (scoring) or :data:`shift_launches` (shift alone).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_score import (
    RESIDENT_WEIGHT_BYTES,
    SMEM_LIMIT,
    DenseChain,
    Layers,
    Step,
    _check,
    _ptr,
    fleet_score_plain,
    storage_of,
)
from gordo_tpu_torch.kernels.scaler_stats import Prefix, ScalerChain, check_steps

SOURCE = "gordo_tpu_torch/csrc/stream_step.cu"
REPLACES = "gordo_tpu/serve/stream.py:175"

#: row tiles of the full window's pass (a multiple of the rows each thread
#: computes, DR_RPT in ``csrc/dense_rows.cuh``)
_ROW_TILES = (256, 128, 64, 32, 16, 8)


def weight_buffer(dims: Sequence[int]):
    """``(resident, wbuf_floats, layer_sizes)`` of a dense chain of widths
    ``dims`` in shared memory (``csrc/dense_rows.cuh``): all layers at once
    when they take at most ``RESIDENT_WEIGHT_BYTES``, else one at a time."""
    sizes = [dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1)]
    resident = 4 * sum(sizes) <= RESIDENT_WEIGHT_BYTES
    return resident, sum(sizes) if resident else max(sizes), sizes

#: kernel launches so far (the CPU path never counts): scoring steps, and
#: ring shifts alone (an LSTM stream's first launch of a row)
launches = 0
shift_launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct StreamStepArgs`` in the CUDA source."""

    _fields_ = [
        ("ring_in", ctypes.c_void_p),
        ("x", ctypes.c_void_p),
        ("ring_out", ctypes.c_void_p),
        ("count", ctypes.c_void_p),
        ("h", ctypes.c_void_p),
        ("scalers", ScalerChain),
        ("chain", DenseChain),
        ("det", ScalerChain),
        ("agg_thr", ctypes.c_void_p),
        ("tags_in", ctypes.c_void_p),
        ("tags_out", ctypes.c_void_p),
        ("verdict", ctypes.c_void_p),
        ("H", ctypes.c_int),
        ("F", ctypes.c_int),
        ("W", ctypes.c_int),
        ("mode_offset", ctypes.c_int),
        ("score", ctypes.c_int),
        ("h_first", ctypes.c_int),
        ("rows_per_tile", ctypes.c_int),
        ("max_dim", ctypes.c_int),
        ("wbuf_floats", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("sort_k", ctypes.c_int),
        ("bf16", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("stream_step")
            lib.stream_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.stream_step_launch.restype = ctypes.c_int
            lib.stream_step_error_string.argtypes = [ctypes.c_int]
            lib.stream_step_error_string.restype = ctypes.c_char_p
            lib.stream_step_empty_launch.argtypes = [ctypes.c_void_p]
            lib.stream_step_empty_launch.restype = ctypes.c_int
            lib.stream_step_args_size.argtypes = []
            lib.stream_step_args_size.restype = ctypes.c_int
            if lib.stream_step_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"stream_step: StreamStepArgs is {lib.stream_step_args_size()} bytes "
                    f"in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


class LaunchPlan(NamedTuple):
    rows_per_tile: int
    smem_bytes: int
    weights_resident: bool
    wbuf_floats: int
    one_row_smem_bytes: int
    sort_k: int


#: a lane of the median's sort holds up to this many values in registers
#: (32 of them a warp); longer windows sort in shared memory
MAX_SORT_K = 32
#: rows a thread of the dense stack computes (``csrc/dense_rows.cuh``)
ROWS_PER_THREAD = 4


def sort_k(window: int) -> int:
    """Values a lane sorts for a series of ``window`` values: the least
    power of two K with 32 K >= window, or 0 (the shared-memory sort) past
    ``32 * MAX_SORT_K``."""
    k = 1
    while 32 * k < window:
        k *= 2
    return k if k <= MAX_SORT_K else 0


def launch_plan(dims: Sequence[int], window: int) -> LaunchPlan:
    """Row tile and shared memory of one step: the (fo + 1) x W raw scores
    stay in shared memory; priming, the tile is the window (rounded up to
    the kernel's 4 rows a thread) when it fits, else the largest of
    fleet_score's tiles that does; a carried step scores one tile of 4
    rows.  Raises ``ValueError`` when none fits."""
    resident, wbuf, _ = weight_buffer(dims)
    fo, ns = dims[-1], dims[-1] + 1
    fixed = wbuf + 2 * fo + window * ns
    per_row = fo + 2 * max(dims)
    whole = -(-window // ROWS_PER_THREAD) * ROWS_PER_THREAD
    for rows in [whole] + [r for r in _ROW_TILES if r < whole]:
        smem = 4 * (fixed + rows * per_row)
        if smem <= SMEM_LIMIT:
            one_row = 4 * (fixed + ROWS_PER_THREAD * per_row)
            return LaunchPlan(rows, smem, resident, wbuf, one_row, sort_k(window))
    raise ValueError(
        f"stream_step cannot take widths {list(dims)} with a window of {window} rows: "
        f"they need {smem} bytes of shared memory, over the {SMEM_LIMIT} a block has"
    )


def _launch(args: _Args, device) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.stream_step_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"stream_step launch failed: {lib.stream_step_error_string(rc).decode()}")
    global launches, shift_launches
    with _launches_lock:
        if args.score:
            launches += 1
        else:
            shift_launches += 1


def empty_launch(device) -> None:
    """One launch of an empty kernel from the step's library on ``device``'s
    current stream: the card's launch floor, for timing beside a step
    (counted in neither :data:`launches` nor :data:`shift_launches`)."""
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.stream_step_empty_launch(ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"stream_step's empty launch failed: {lib.stream_step_error_string(rc).decode()}")


def _check_ring(ring_in, ring_out, count, x):
    if ring_in.dim() != 2:
        raise ValueError(f"the ring must be (H, F), got {tuple(ring_in.shape)}")
    H, F = (int(s) for s in ring_in.shape)
    store = storage_of(ring_in)
    _check(ring_in, "ring_in", (H, F), ring_in.device, store)
    if x is not None:
        _check(ring_out, "ring_out", (H, F), ring_in.device, store)
        _check(x, "x", (F,), ring_in.device, store)
    if count.dtype != torch.int32 or tuple(count.shape) != (1,) or count.device != ring_in.device:
        raise ValueError(f"count must be a (1,) int32 tensor on {ring_in.device}")
    return H, F, store


def stream_shift(ring_in: torch.Tensor, ring_out: torch.Tensor, count: torch.Tensor,
                 x: torch.Tensor) -> None:
    """``ring_out = ring_in[1:] ++ [x]`` and ``count += 1``, alone (an LSTM
    stream's first launch of a row)."""
    if ring_in.device.type == "cpu":
        return stream_shift_plain(ring_in, ring_out, count, x)
    if ring_in.device.type != "cuda":
        raise ValueError(f"stream_shift runs on cuda or cpu tensors, got {ring_in.device}")
    H, F, store = _check_ring(ring_in, ring_out, count, x)
    args = _Args()
    args.ring_in, args.x, args.ring_out, args.count = (
        ring_in.data_ptr(), x.data_ptr(), ring_out.data_ptr(), count.data_ptr()
    )
    args.H, args.F, args.score = H, F, 0
    args.bf16 = int(store == torch.bfloat16)
    _launch(args, ring_in.device)


def stream_step(
    ring_in: torch.Tensor,
    count: torch.Tensor,
    layers: Layers,
    acts: Sequence[Optional[str]],
    *,
    window: int,
    mode_offset: int,
    det: Optional[Step] = None,
    chain: Optional[Prefix] = None,
    agg_thr: Optional[torch.Tensor] = None,
    x: Optional[torch.Tensor] = None,
    ring_out: Optional[torch.Tensor] = None,
    h: Optional[torch.Tensor] = None,
    tags_in: Optional[torch.Tensor] = None,
    tags_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Score the newest row of a machine's ring; returns the verdict (fo + 3,)
    float32: the W-row nanmedian of each tag score, of the total, the
    confidence (NaN without ``agg_thr``) and validity (1.0 when ``count >
    mode_offset``).

    ``ring_in`` (H, F), H = ``mode_offset + window``, and ``x`` (F,) at
    the storage type (float32 or bfloat16, as the chain); with ``x`` the
    ring is first shifted into ``ring_out`` and ``count`` (1,) int32 goes
    up by one, else ``ring_in`` is the shifted ring.  ``layers``/``acts``:
    the chain's dense stack of one machine (``(W (1, in, out), b (1,
    out))``), fed the ring rows from ``mode_offset`` on through the
    pipeline's scaler steps (``chain``, stats (1, F), ``fleet_score``'s
    form) or ``h`` float32: an LSTM's last-layer state of the ring's
    windows, or a transform chain's output for the ring's scored rows,
    (W, f_in), or with ``tags_in`` (1, f_in), the newest one only.
    Targets: the ring rows from ``mode_offset`` on.  ``det`` the detector
    scaler's step, stats (1, fo); ``agg_thr`` (1,) float32.

    ``tags_in`` (W, fo) float32: the carried tag scores of the W scored
    rows before this step; the step then scores the newest row alone and
    carries the others one position older.  Without it every row is
    scored.  ``tags_out`` (W, fo) float32 (not ``tags_in``) receives the
    W rows' tag scores after the step.  Both modes give the same bits."""
    steps = list(chain or ())
    dets = [] if det is None else [det]
    if not dets:
        raise ValueError("stream_step needs the detector scaler")
    if ring_in.device.type == "cpu":
        return stream_step_plain(
            ring_in, count, layers, acts, window=window, mode_offset=mode_offset,
            det=det, chain=steps, agg_thr=agg_thr, x=x, ring_out=ring_out, h=h,
            tags_in=tags_in, tags_out=tags_out,
        )
    if ring_in.device.type != "cuda":
        raise ValueError(f"stream_step runs on cuda or cpu tensors, got {ring_in.device}")
    device = ring_in.device
    H, F, store = _check_ring(ring_in, ring_out, count, x)
    if window < 1 or H != mode_offset + window:
        raise ValueError(f"the ring has {H} rows; mode_offset + window is {mode_offset + window}")
    dims = [int(layers[0][0].shape[1])] + [int(W.shape[2]) for W, _ in layers]
    for i, (W, b) in enumerate(layers):
        _check(W, f"layer {i} weight", (1, dims[i], dims[i + 1]), device, store)
        _check(b, f"layer {i} bias", (1, dims[i + 1]), device, store)
    fo = dims[-1]
    if fo != F:
        raise ValueError(f"the chain has {fo} outputs and the ring {F} tags")
    if h is None and dims[0] != F:
        raise ValueError(f"the chain takes {dims[0]} inputs and the ring has {F} tags")
    if h is not None and steps:
        raise ValueError("an LSTM's state takes no pipeline scaler")
    h_rows = window
    if h is not None and tags_in is not None and h.dim() == 2 and int(h.shape[0]) == 1:
        h_rows = 1
    _check(h, "h", (h_rows, dims[0]), device)
    _check(tags_in, "tags_in", (window, fo), device)
    _check(tags_out, "tags_out", (window, fo), device)
    if tags_in is not None and tags_out is not None and tags_in.data_ptr() == tags_out.data_ptr():
        raise ValueError("tags_out must be another buffer than tags_in")
    check_steps(steps, (1, F), device, (store,), "pipeline scaler")
    check_steps(dets, (1, fo), device, (store,), "detector scaler")
    _check(agg_thr, "agg_thr", (1,), device)
    plan = launch_plan(dims, window)
    verdict = torch.empty(fo + 3, dtype=torch.float32, device=device)
    args = _Args()
    args.ring_in, args.x, args.ring_out, args.count = (
        ring_in.data_ptr(), _ptr(x), _ptr(ring_out), count.data_ptr()
    )
    args.h = _ptr(h)
    args.scalers.fill(steps)
    args.chain.fill(layers, acts, dims, plan.weights_resident)
    args.det.fill(dets)
    args.agg_thr = _ptr(agg_thr)
    args.tags_in, args.tags_out = _ptr(tags_in), _ptr(tags_out)
    args.verdict = verdict.data_ptr()
    args.H, args.F, args.W, args.mode_offset, args.score = H, F, window, mode_offset, 1
    args.h_first = window - h_rows
    if tags_in is None:
        args.rows_per_tile, args.smem_bytes = plan.rows_per_tile, plan.smem_bytes
    else:
        args.rows_per_tile, args.smem_bytes = ROWS_PER_THREAD, plan.one_row_smem_bytes
    args.max_dim, args.wbuf_floats, args.sort_k = max(dims), plan.wbuf_floats, plan.sort_k
    args.bf16 = int(store == torch.bfloat16)
    _launch(args, device)
    return verdict


def stream_shift_plain(ring_in, ring_out, count, x) -> None:
    """:func:`stream_shift` in plain PyTorch."""
    ring_out[:-1] = ring_in[1:]
    ring_out[-1] = x
    count += 1


def masked_nanmedian(raw: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Nanmedian over rows of ``raw`` (W, c) whose older ``W - n_valid`` rows
    are masked to NaN, as ``jnp.nanmedian`` takes it: (lo + hi) * 0.5 of the
    middle non-NaN values; NaN where none is left."""
    W = raw.shape[0]
    vals = torch.where(torch.arange(W, device=raw.device)[:, None] >= W - n_valid, raw, torch.full_like(raw, float("nan")))
    valid = ~torch.isnan(vals)
    c = valid.sum(0, keepdim=True)
    ordered = torch.sort(torch.where(valid, vals, torch.inf), dim=0).values
    lo = torch.gather(ordered, 0, (c - 1).clamp_min(0) // 2)
    hi = torch.gather(ordered, 0, c // 2)
    med = ((lo + hi) * 0.5)[0]
    return torch.where(c[0] > 0, med, torch.full_like(med, float("nan")))


def stream_step_plain(
    ring_in, count, layers, acts, *, window, mode_offset, det=None, chain=None, agg_thr=None,
    x=None, ring_out=None, h=None, tags_in=None, tags_out=None,
) -> torch.Tensor:
    """:func:`stream_step` in plain PyTorch: ``fleet_score_plain`` over the
    W scored rows (one slot; a one-row ``h`` alone), the newest row's tag
    scores after ``tags_in``'s older ones, each row's total from its tag
    scores, then the masked nanmedian.  The plain matrix products pick
    their kernel by the number of rows, so the ring's rows and a W-row
    ``h`` are scored at the full mode's shape and the newest row kept:
    the carried verdicts are then the full mode's bit for bit."""
    ring = ring_in
    if x is not None:
        stream_shift_plain(ring_in, ring_out, count, x)
        ring = ring_out
    n = int(count[0])
    y = ring[mode_offset:][None]
    if h is None:
        scored = fleet_score_plain(y, layers, acts, chain=chain, det=det)
    else:
        scored = fleet_score_plain(h[None], layers, acts, y=y[:, y.shape[1] - h.shape[0]:], det=det)
    tags = scored["tag-anomaly-scores"][0]
    if tags_in is not None:
        tags = torch.cat([tags_in[1:], tags[-1:]])
    if tags_out is not None:
        tags_out.copy_(tags)
    # the total of each row from its tag scores, as fleet_score_plain sums
    # them (the same shape, so the same reduction)
    sq = tags[None] * tags[None]
    total = torch.sqrt(torch.sum(sq, dim=-1))[0]
    raw = torch.cat([tags, total[:, None]], 1)
    med = masked_nanmedian(raw, min(max(n - mode_offset, 0), window))
    conf = (med[-1:] / torch.clamp_min(agg_thr, 1e-12) if agg_thr is not None
            else med.new_full((1,), float("nan")))
    return torch.cat([med, conf, med.new_full((1,), float(n > mode_offset))])
