"""``fleet_score``: fused anomaly scoring of a bucket of feedforward detectors.

Replaces the XLA programs ``serve.fleet`` / ``serve.fleet_subset``
(``gordo_tpu/serve/fleet_scorer.py:51`` ``_fleet_score_core``, ``:120``
``_fleet_score_subset_core``) and ``serve.score``
(``gordo_tpu/serve/scorer.py:211`` ``_score_program_fn``) for the
feedforward / MinMax chain; for an LSTM detector it is the ``out`` head
and the detector epilogue after the ``lstm_layer`` launches, and with a
detector window ``rolling_median`` smooths its scores and takes the
confidence.  With no layers it is that epilogue alone, ``anomaly.scores``
(``gordo_tpu/anomaly/diff.py:41``) on a prediction already computed: a
``TransformedTargetRegressor``'s after its target's inverse, a
``MultiOutputRegressor``'s after its columns' model launch.  The kernel
is CUDA C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/fleet_score.cu``,
whose header gives its bound and design); :func:`fleet_score_plain` is the
same function in plain PyTorch.

:func:`fleet_score` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch (and to :data:`bf16_launches` for one over
bf16 storage).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.scaler_stats import MAX_STEPS as SCALER_STEPS
from gordo_tpu_torch.kernels.scaler_stats import Prefix, ScalerChain, apply_steps, check_steps
from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS

SOURCE = "gordo_tpu_torch/csrc/fleet_score.cu"
REPLACES = "gordo_tpu/serve/fleet_scorer.py:51"

#: activation codes of the kernel's ``act_fn``
ACT_CODES = {
    None: 0, "linear": 0, "tanh": 1, "relu": 2, "sigmoid": 3, "elu": 4,
    "selu": 5, "softplus": 6, "leaky_relu": 7, "gelu": 8,
}
MAX_LAYERS = 16
#: shared memory one block may use on sm_90
SMEM_LIMIT = 232448
#: all layers' weights are loaded at once (one round of global loads)
#: when they take at most this much shared memory; wider models stream
#: one layer at a time (the tile path, and stream_step's)
RESIDENT_WEIGHT_BYTES = 32 * 1024
#: the kernel's paths (``FS_PATH_TILE``, ``FS_PATH_ROWS``)
PATH_TILE, PATH_ROWS = 0, 1
PATH_NAMES = ("tile", "rows")
#: the row path's widest layer (``FS_NARROW_MAX``), largest block
#: (``FS_ROW_THREADS``) and most rows a thread (``FS_ROW_RPT``); its
#: planned tile at ``ROW_RPT`` rows a thread (at one, half as many rows)
NARROW_MAX = 16
ROW_THREADS_MAX = 256
ROW_RPT = 2
ROW_TILE = 256
#: floats a row takes in the row path's shared memory (``FS_ROW_STRIDE``)
ROW_STRIDE = NARROW_MAX + 1
#: the row path's resident blocks an SM that its plan aims at: each block
#: walks a run of its slot's tiles, the next tile's rows loading while it
#: scores one
ROW_BLOCKS_PER_SM = 8
#: the tile path's rows a thread's register tile takes (``FS_RT``), and its
#: row tiles, largest first (at most 64, so that two blocks share an SM)
TILE_RT = 4
_TILE_ROWS = (64, 32, 16, 8)
#: the tile path's smallest row tile (a grid short of SMs takes smaller ones)
TILE_MIN_ROWS = 8
#: grid rows are ``blockIdx.y``
MAX_SLOTS = 65535

#: kernel launches so far (the CPU path never counts), and those of them
#: over bf16 storage and those of the epilogue alone (no layers)
launches = 0
bf16_launches = 0
epilogue_launches = 0
_launches_lock = threading.Lock()

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]
#: one scaler step ``(form, a, b)`` (``scaler_stats.AFFINE`` or ``CENTER``)
Step = Tuple[int, torch.Tensor, torch.Tensor]


class DenseChain(ctypes.Structure):
    """Mirror of ``struct DenseChain`` in ``csrc/dense_rows.cuh``."""

    _fields_ = [
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("act", ctypes.c_int * MAX_LAYERS),
        ("weights_resident", ctypes.c_int),
    ]

    def fill(self, layers: "Layers", acts: Sequence[Optional[str]], dims: Sequence[int],
             resident: bool) -> None:
        for i, (W, b) in enumerate(layers):
            self.w[i], self.b[i] = W.data_ptr(), b.data_ptr()
        self.n_layers = len(layers)
        for i, d in enumerate(dims):
            self.dims[i] = d
        for i, a in enumerate(acts):
            self.act[i] = ACT_CODES[a]
        self.weights_resident = int(resident)


class _Args(ctypes.Structure):
    """Mirror of ``struct FleetScoreArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_rows", ctypes.c_void_p),
        ("scalers", ScalerChain),
        ("chain", DenseChain),
        ("det", ScalerChain),
        ("agg_thr", ctypes.c_void_p),
        ("pred", ctypes.c_void_p),
        ("tag", ctypes.c_void_p),
        ("total", ctypes.c_void_p),
        ("conf", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("y_n", ctypes.c_int),
        ("y_row0", ctypes.c_int),
        ("rows_per_block", ctypes.c_int),
        ("max_dim", ctypes.c_int),
        ("wbuf_floats", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("x_bf16", ctypes.c_int),
        ("bf16", ctypes.c_int),
        ("path", ctypes.c_int),
        ("blocks_per_slot", ctypes.c_int),
        ("row_rpt", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fleet_score")
            lib.fleet_score_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.fleet_score_launch.restype = ctypes.c_int
            lib.fleet_score_error_string.argtypes = [ctypes.c_int]
            lib.fleet_score_error_string.restype = ctypes.c_char_p
            lib.fleet_score_args_size.argtypes = []
            lib.fleet_score_args_size.restype = ctypes.c_int
            lib.fleet_score_limits.argtypes = [ctypes.c_void_p]
            lib.fleet_score_limits.restype = ctypes.c_int
            if lib.fleet_score_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "fleet_score: FleetScoreArgs is "
                    f"{lib.fleet_score_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            limits = (ctypes.c_int * 4)()
            lib.fleet_score_limits(limits)
            if tuple(limits) != (NARROW_MAX, ROW_THREADS_MAX, ROW_RPT, TILE_RT):
                raise RuntimeError("fleet_score: the kernel's limits differ from the wrapper's")
            _lib = lib
        return _lib


class LaunchPlan(NamedTuple):
    path: int
    rows_per_block: int
    smem_bytes: int
    weights_resident: bool
    wbuf_floats: int
    blocks_per_slot: int
    row_rpt: int = 1


def _pad4(v: int) -> int:
    return -(-v // 4) * 4


def padded_layers(dims: Sequence[int]):
    """Floats of each layer in ``fleet_score``'s shared memory: W's rows
    and b padded to a multiple of four columns (``load_layer_padded``)."""
    return [(dims[i] + 1) * _pad4(dims[i + 1]) for i in range(len(dims) - 1)]


def _ceil16(v: int) -> int:
    return -(-v // 16) * 16


def row_plan(dims: Sequence[int], m: int, n: int, sm_count: int, with_detector: bool = True, x_bytes: int = 4,
             store_bytes: int = 4, targets: bool = False) -> LaunchPlan:
    """The row path's plan: ``ROW_RPT`` rows a thread in tiles of
    ``ROW_TILE`` rows where the grid fills the SMs and there are layers
    (each float4 of weights feeds ``ROW_RPT`` rows), else one row a thread
    in tiles of ``ROW_TILE // ROW_RPT`` rows halved (down to a warp) while
    the grid has fewer tiles than SMs; as many blocks a slot as leave
    ``ROW_BLOCKS_PER_SM`` an SM (at least one, at most a tile each), each
    walking a run of the slot's tiles.  Shared memory: every layer
    resident, the detector's and scaler steps' stats, the rows'
    activations and tag scores, and two tiles of raw rows (``x_bytes`` a
    value) and, with ``targets``, raw targets (``store_bytes`` a value).
    Raises ``ValueError`` for a width over ``NARROW_MAX``."""
    if max(dims) > NARROW_MAX:
        raise ValueError(f"fleet_score's row path takes widths up to {NARROW_MAX}, got {list(dims)}")
    rpt = ROW_RPT if len(dims) > 1 and m * math.ceil(n / ROW_TILE) >= sm_count else 1
    rows = ROW_TILE if rpt > 1 else ROW_TILE // ROW_RPT
    while rows > 32 * rpt and m * math.ceil(n / rows) < sm_count:
        rows //= 2
    tiles = math.ceil(n / rows)
    blocks = min(tiles, max(1, ROW_BLOCKS_PER_SM * sm_count // m))
    wbuf = sum(padded_layers(dims))
    f, fo = dims[0], dims[-1]
    floats = (wbuf + 2 * NARROW_MAX * (1 + SCALER_STEPS) + rows * ROW_STRIDE
              + (_pad4(rows * fo) if with_detector else 0))
    raw = 2 * (_ceil16(rows * f * x_bytes) + (_ceil16(rows * fo * store_bytes) if targets else 0))
    return LaunchPlan(PATH_ROWS, rows, 4 * floats + raw, True, wbuf, blocks, rpt)


def tile_plan(dims: Sequence[int], m: int, n: int, sm_count: int, with_detector: bool = True) -> LaunchPlan:
    """The tile path's plan: weights resident when all padded layers fit
    in ``RESIDENT_WEIGHT_BYTES``, else streamed a layer at a time; the
    row tile the largest of ``_TILE_ROWS`` that leaves two blocks an SM
    (else the largest that fits one), or, where that grid has fewer
    blocks than SMs, the rows an SM takes when they are spread over every
    SM, up to a multiple of ``TILE_RT`` (``TILE_MIN_ROWS`` at least): one
    wave of blocks, none an SM's second (at 1 × 4096 rows, 128 blocks of
    32 rows on 132 SMs ran faster than 256 of 16 and 147 of 28, PERF.md).
    Raises ``ValueError`` for widths whose largest layer does not fit."""
    sizes = padded_layers(dims)
    resident = 4 * sum(sizes) <= RESIDENT_WEIGHT_BYTES
    wbuf = sum(sizes) if resident else max(sizes)
    fixed = wbuf + 2 * dims[-1]
    per_row = 2 * max(dims) + (dims[-1] if with_detector else 0)
    fits = [r for r in _TILE_ROWS if 4 * (fixed + r * per_row) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"fleet_score cannot take widths {list(dims)}: its largest layer "
            f"({max(sizes)} floats) and an {_TILE_ROWS[-1]}-row tile need "
            f"{4 * (fixed + _TILE_ROWS[-1] * per_row)} bytes of shared memory, over the "
            f"{SMEM_LIMIT} a block has"
        )
    rows = next((r for r in fits if 8 * (fixed + r * per_row) <= SMEM_LIMIT), fits[0])
    if m * math.ceil(n / rows) < sm_count:
        rows = max(TILE_MIN_ROWS, min(rows, math.ceil(m * n / sm_count / TILE_RT) * TILE_RT))
    return LaunchPlan(PATH_TILE, rows, 4 * (fixed + rows * per_row), resident, wbuf, math.ceil(n / rows))


def launch_plan(dims: Sequence[int], m: int, n: int, sm_count: int, with_detector: bool = True, x_bytes: int = 4,
                store_bytes: int = 4, targets: bool = False) -> LaunchPlan:
    """The kernel's path and its plan for a chain of widths ``dims``: the
    row path (:func:`row_plan`) when no width passes ``NARROW_MAX``, else
    the tile path (:func:`tile_plan`)."""
    if max(dims) <= NARROW_MAX:
        return row_plan(dims, m, n, sm_count, with_detector, x_bytes, store_bytes, targets)
    return tile_plan(dims, m, n, sm_count, with_detector)


def _host_ints(values, name: str, lo: int, hi: int) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.int64))
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {arr.shape}")
    if arr.size and (arr.min() < lo or arr.max() > hi):
        raise ValueError(f"{name} values must lie in [{lo}, {hi}]")
    return arr.astype(np.int32)


def slot_ints(values, name: str, lo: int, hi: int, device) -> torch.Tensor:
    """Per-slot ints (``idx``, row or window counts) as an int32 tensor on
    ``device``, checked against ``[lo, hi]`` on the host.  An int32 tensor
    already on ``device`` passes as it is, unchecked: its maker checked it,
    so a caller that feeds several kernels the same counts copies them to
    the card once."""
    if isinstance(values, torch.Tensor) and values.device == torch.device(device):
        if values.dtype != torch.int32 or values.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got {values.dtype} {tuple(values.shape)}")
        return values
    return to_device(_host_ints(values, name, lo, hi), device)


#: the storage types the serving kernels take (float32, and bfloat16 for
#: reduced-precision serving)
STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def storage_of(t: torch.Tensor) -> torch.dtype:
    """The storage type of a chain's stacked leaf ``t``; raises for others."""
    if t.dtype not in STORAGE_DTYPES:
        raise TypeError(f"serving tensors are float32 or bfloat16, got {t.dtype}")
    return t.dtype


def _check(
    t: Optional[torch.Tensor], name: str, shape: Tuple[int, ...], device,
    dtype: Union[torch.dtype, Tuple[torch.dtype, ...]] = torch.float32,
) -> None:
    if t is None:
        return
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        names = " or ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fleet_score(
    x: torch.Tensor,
    layers: Layers,
    acts: Sequence[Optional[str]],
    *,
    chain: Optional[Prefix] = None,
    det: Optional[Step] = None,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
    y: Optional[torch.Tensor] = None,
    y_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Score ``x`` (m, n, f) through the stacked chains of M machines.

    ``layers``: ``[(W (M, in, out), b (M, out)), ...]`` with one activation
    name per layer in ``acts`` (the last is the output head's).
    ``chain``: the pipeline's scaler steps ``[(form, a (M, f), b (M, f)),
    ...]`` (``scaler_stats.AFFINE`` or ``CENTER`` each; none: no scaler).
    ``det``: the detector scaler's step ``(form, a (M, f), b (M, f))``;
    without it only ``model-output`` is computed.  ``agg_thr`` (M,): aggregate
    thresholds, adding ``anomaly-confidence``.  ``idx`` (m,) host ints:
    the stacked machine each slot of ``x`` is scored by (default: slot i
    is machine i, m == M).  ``n_rows`` (m,) host ints: valid rows of each
    slot (default n); output rows past them are unspecified.  ``y``
    (m, n_y, f_out): targets of the detector, output row ``r`` against
    ``y`` row ``y_offset + r`` (default ``x``, which then needs f_out ==
    f).  The LSTM detectors pass their last layer's final states as ``x``
    and the raw request rows as ``y``, from the model's offset on.

    No ``layers`` (and no ``acts``): the epilogue alone, ``x`` the
    prediction (float32), which comes back as ``model-output`` unwritten;
    it needs the detector scaler (M from its stats) and no pipeline
    scaler.

    Storage: the layers, the stats and ``y`` are all float32, or all
    bfloat16 (reduced-precision serving; ``x`` is then bfloat16 rows, or
    an LSTM head's float32 states); ``agg_thr`` is float32.  Outputs are
    float32 either way.
    """
    steps = list(chain or ())
    if x.device.type == "cpu":
        return fleet_score_plain(
            x, layers, acts, chain=steps, det=det, agg_thr=agg_thr,
            idx=idx, n_rows=n_rows, y=y, y_offset=y_offset,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fleet_score runs on cuda or cpu tensors, got {x.device}")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    args, result = launch_args(x, layers, acts, steps, det, agg_thr, idx, n_rows, y, y_offset, sm_count)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fleet_score_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fleet_score launch failed: {lib.fleet_score_error_string(rc).decode()}"
        )
    global launches, bf16_launches, epilogue_launches
    with _launches_lock:
        launches += 1
        bf16_launches += args.bf16
        epilogue_launches += int(not layers)
    return result


def launch_args(x: torch.Tensor, layers: Layers, acts, steps: Prefix, det: Optional[Step], agg_thr, idx, n_rows,
                y: Optional[torch.Tensor], y_offset: int, sm_count: int):
    """``(args, result)``: :func:`fleet_score`'s checked arguments for the
    kernel, planned for ``sm_count`` SMs, and its output tensors (on ``x``'s
    device, not yet written)."""
    dets = [] if det is None else [det]
    device = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (m, n, f), got shape {tuple(x.shape)}")
    m, n, f = (int(s) for s in x.shape)
    if not 1 <= m <= MAX_SLOTS or n < 1:
        raise ValueError(f"x must have 1..{MAX_SLOTS} slots and >= 1 row, got {tuple(x.shape)}")
    M, store = _epilogue_only_check(layers, acts, steps, dets)
    if M is None:
        M, store = int(layers[0][0].shape[0]), storage_of(layers[0][0])
    dims = [f]
    for i, (W, b) in enumerate(layers):
        if W.dim() != 3:
            raise ValueError(f"layer {i} weight must be (M, in, out), got {tuple(W.shape)}")
        _check(W, f"layer {i} weight", (M, dims[-1], int(W.shape[2])), device, store)
        _check(b, f"layer {i} bias", (M, int(W.shape[2])), device, store)
        dims.append(int(W.shape[2]))
    if min(dims) < 1:
        raise ValueError(f"every layer needs a width >= 1, got {dims}")
    fo = dims[-1]
    _check(x, "x", (m, n, f), device, (torch.float32, store))
    check_steps(steps, (M, f), device, (store,), "pipeline scaler")
    if not dets and (agg_thr is not None or y is not None):
        raise ValueError("agg_thr and y need the detector scaler")
    if dets and y is None and fo != f:
        raise ValueError(
            f"anomaly scoring against x needs as many outputs as inputs ({fo} != {f})"
        )
    check_steps(dets, (M, fo), device, (store,), "detector scaler")
    _check(agg_thr, "agg_thr", (M,), device)
    y_n = n
    if y is not None:
        y_n = int(y.shape[1]) if y.dim() == 3 else -1
        if y_offset < 0 or y_n < y_offset + n:
            raise ValueError(
                f"y needs rows {y_offset}..{y_offset + n - 1} of each slot, got "
                f"shape {tuple(y.shape)}"
            )
        _check(y, "y", (m, y_n, fo), device, store)
    if idx is None:
        if m != M:
            raise ValueError(f"without idx, x needs one slot per machine ({m} != {M})")
        idx_dev = None
    else:
        idx_dev = slot_ints(idx, "idx", 0, M - 1, device)
        if idx_dev.numel() != m:
            raise ValueError(f"idx needs one entry per slot ({idx_dev.numel()} != {m})")
    if n_rows is None:
        rows_dev = None
    else:
        rows_dev = slot_ints(n_rows, "n_rows", 1, n, device)
        if rows_dev.numel() != m:
            raise ValueError(f"n_rows needs one entry per slot ({rows_dev.numel()} != {m})")

    plan = launch_plan(dims, m, n, sm_count, with_detector=bool(dets), x_bytes=x.element_size(),
                       store_bytes=torch.finfo(store).bits // 8, targets=y is not None)
    pred = torch.empty((m, n, fo), dtype=torch.float32, device=device) if layers else None
    result = {"model-output": x if pred is None else pred}
    tag = total = conf = None
    if dets:
        tag = result["tag-anomaly-scores"] = torch.empty((m, n, fo), dtype=torch.float32, device=device)
        total = result["total-anomaly-score"] = torch.empty((m, n), dtype=torch.float32, device=device)
        if agg_thr is not None:
            conf = result["anomaly-confidence"] = torch.empty_like(total)

    args = _Args()
    args.x, args.y = _ptr(x), _ptr(y)
    args.idx, args.n_rows = _ptr(idx_dev), _ptr(rows_dev)
    args.scalers.fill(steps)
    args.chain.fill(layers, acts, dims, plan.weights_resident)
    args.det.fill(dets)
    args.agg_thr = _ptr(agg_thr)
    args.pred, args.tag, args.total, args.conf = (
        _ptr(pred), _ptr(tag), _ptr(total), _ptr(conf)
    )
    args.m, args.n, args.f = m, n, f
    args.y_n, args.y_row0 = y_n, y_offset
    args.rows_per_block = plan.rows_per_block
    args.max_dim = max(dims)
    args.wbuf_floats = plan.wbuf_floats
    args.smem_bytes = plan.smem_bytes
    args.x_bf16 = int(x.dtype == torch.bfloat16)
    args.bf16 = int(store == torch.bfloat16)
    args.path = plan.path
    args.blocks_per_slot = plan.blocks_per_slot
    args.row_rpt = plan.row_rpt
    args.inputs = (idx_dev, rows_dev)  # alive until the launch is enqueued
    return args, result


def _epilogue_only_check(layers: Layers, acts, steps: Prefix, dets: Prefix) -> Tuple[Optional[int], Optional[torch.dtype]]:
    """``(M, storage)`` of an epilogue-only call (no layers), checked;
    ``(None, None)`` for a call with layers, whose count is checked."""
    if layers or acts:
        if not 1 <= len(layers) <= MAX_LAYERS or len(acts) != len(layers):
            raise ValueError(
                f"need 1..{MAX_LAYERS} layers with one activation each, got "
                f"{len(layers)} layers and {len(acts)} activations"
            )
        for a in acts:
            if a not in ACT_CODES:
                raise ValueError(f"activation {a!r} has no kernel code")
        return None, None
    if not dets or steps:
        raise ValueError("an epilogue-only fleet_score (no layers) needs the detector scaler, "
                         "and takes no pipeline scaler")
    return int(dets[0][1].shape[0]), storage_of(dets[0][1])


def fleet_score_plain(
    x: torch.Tensor,
    layers: Layers,
    acts: Sequence[Optional[str]],
    *,
    chain: Optional[Prefix] = None,
    det: Optional[Step] = None,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
    y: Optional[torch.Tensor] = None,
    y_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """:func:`fleet_score` in plain PyTorch, in the JAX program's op order.

    ``n_rows`` only marks which output rows are meaningful; every row is
    computed.  bfloat16 inputs are widened to float32 first, as the kernel
    widens them as it loads.  A MinMax step is one FMA, as in the kernel
    and in the JAX package's jitted scorer (XLA:CPU fuses ``x * scale +
    offset``)."""
    steps = list(chain or ())
    dets = [] if det is None else [det]
    if not layers:
        _epilogue_only_check(layers, acts, steps, dets)
    wide = lambda t: None if t is None else t.float()  # noqa: E731
    x, y = wide(x), wide(y)
    layers = [(W.float(), b.float()) for W, b in layers]
    view = lambda t: t[:, None, :]  # noqa: E731
    if idx is not None:
        take = torch.as_tensor(idx.cpu() if isinstance(idx, torch.Tensor) else np.asarray(idx, np.int64),
                               dtype=torch.int64, device=x.device)

        def pick(t):
            return None if t is None else t.index_select(0, take)

        layers = [(pick(W), pick(b)) for W, b in layers]
        agg_thr = pick(agg_thr)
        view = lambda t: pick(t)[:, None, :]  # noqa: E731
    h = apply_steps(x, steps, view)
    for (W, b), act in zip(layers, acts):
        h = ACTIVATIONS[act](torch.bmm(h, W) + b[:, None, :])
    result = {"model-output": h}
    if dets:
        target = x if y is None else y[:, y_offset: y_offset + x.shape[1]]
        tag = torch.abs(apply_steps(h, dets, view) - apply_steps(target, dets, view))
        total = torch.sqrt(torch.sum(tag * tag, dim=-1))
        result["tag-anomaly-scores"] = tag
        result["total-anomaly-score"] = total
        if agg_thr is not None:
            result["anomaly-confidence"] = total / torch.clamp_min(agg_thr, 1e-12)[:, None]
    return result
