"""``fleet_score``: fused anomaly scoring of a bucket of feedforward detectors.

Replaces the XLA programs ``serve.fleet`` / ``serve.fleet_subset``
(``gordo_tpu/serve/fleet_scorer.py:51`` ``_fleet_score_core``, ``:120``
``_fleet_score_subset_core``) and ``serve.score``
(``gordo_tpu/serve/scorer.py:211`` ``_score_program_fn``) for the
feedforward / MinMax chain; for an LSTM detector it is the ``out`` head
and the detector epilogue after the ``lstm_layer`` launches, and with a
detector window ``rolling_median`` smooths its scores and takes the
confidence.  The kernel is CUDA C++ for
``sm_90a`` (``gordo_tpu_torch/csrc/fleet_score.cu``, whose header gives
its bound and design); :func:`fleet_score_plain` is the same function in
plain PyTorch.

:func:`fleet_score` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS

SOURCE = "gordo_tpu_torch/csrc/fleet_score.cu"
REPLACES = "gordo_tpu/serve/fleet_scorer.py:51"

#: activation codes of the kernel's ``act_fn``
ACT_CODES = {
    None: 0, "linear": 0, "tanh": 1, "relu": 2, "sigmoid": 3, "elu": 4,
    "selu": 5, "softplus": 6, "leaky_relu": 7, "gelu": 8,
}
MAX_LAYERS = 16
#: rows of a tile are a multiple of the rows each thread computes (FS_RPT)
_ROW_TILES = (256, 128, 64, 32, 16, 8)
#: shared memory one block may use on sm_90
SMEM_LIMIT = 232448
#: all layers' weights are loaded at once (one round of global loads)
#: when they take at most this much shared memory; wider models stream
#: one layer at a time
RESIDENT_WEIGHT_BYTES = 32 * 1024
#: grid rows are ``blockIdx.y``
MAX_SLOTS = 65535

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


class _Args(ctypes.Structure):
    """Mirror of ``struct FleetScoreArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_rows", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("offset", ctypes.c_void_p),
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
        ("det_scale", ctypes.c_void_p),
        ("det_offset", ctypes.c_void_p),
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
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("act", ctypes.c_int * MAX_LAYERS),
        ("rows_per_block", ctypes.c_int),
        ("max_dim", ctypes.c_int),
        ("weights_resident", ctypes.c_int),
        ("wbuf_floats", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
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
            if lib.fleet_score_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "fleet_score: FleetScoreArgs is "
                    f"{lib.fleet_score_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


class LaunchPlan(NamedTuple):
    rows_per_block: int
    smem_bytes: int
    weights_resident: bool
    wbuf_floats: int


def launch_plan(
    dims: Sequence[int], m: int, n: int, sm_count: int, with_detector: bool = True
) -> LaunchPlan:
    """Row tile and shared memory for a chain of widths ``dims``.

    Weights are resident when all layers fit in ``RESIDENT_WEIGHT_BYTES``,
    else streamed one layer at a time.  The row tile is the largest whose
    shared memory fits, halved (down to 16 rows) while the grid has fewer
    blocks than SMs.  Raises ``ValueError`` for widths whose largest layer
    does not fit."""
    sizes = [dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1)]
    resident = 4 * sum(sizes) <= RESIDENT_WEIGHT_BYTES
    wbuf = sum(sizes) if resident else max(sizes)
    fixed = wbuf + 2 * dims[-1]
    per_row = 2 * max(dims) + (dims[-1] if with_detector else 0)
    for rows in _ROW_TILES:
        smem = 4 * (fixed + rows * per_row)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"fleet_score cannot take widths {list(dims)}: its largest layer "
            f"({max(sizes)} floats) and an {_ROW_TILES[-1]}-row tile need "
            f"{smem} bytes of shared memory, over the {SMEM_LIMIT} a block has"
        )
    while rows > 16 and m * math.ceil(n / rows) < sm_count:
        rows //= 2
    return LaunchPlan(rows, 4 * (fixed + rows * per_row), resident, wbuf)


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


def _check(t: Optional[torch.Tensor], name: str, shape: Tuple[int, ...], device) -> None:
    if t is None:
        return
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    det_scale: Optional[torch.Tensor] = None,
    det_offset: Optional[torch.Tensor] = None,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
    y: Optional[torch.Tensor] = None,
    y_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Score ``x`` (m, n, f) through the stacked chains of M machines.

    ``layers``: ``[(W (M, in, out), b (M, out)), ...]`` with one activation
    name per layer in ``acts`` (the last is the output head's).
    ``scale``/``offset`` (M, f): the pipeline's MinMax (None: no scaler).
    ``det_scale``/``det_offset`` (M, f): the detector's MinMax; without
    them only ``model-output`` is computed.  ``agg_thr`` (M,): aggregate
    thresholds, adding ``anomaly-confidence``.  ``idx`` (m,) host ints:
    the stacked machine each slot of ``x`` is scored by (default: slot i
    is machine i, m == M).  ``n_rows`` (m,) host ints: valid rows of each
    slot (default n); output rows past them are unspecified.  ``y``
    (m, n_y, f_out): targets of the detector, output row ``r`` against
    ``y`` row ``y_offset + r`` (default ``x``, which then needs f_out ==
    f).  The LSTM detectors pass their last layer's final states as ``x``
    and the raw request rows as ``y``, from the model's offset on.
    """
    if x.device.type == "cpu":
        return fleet_score_plain(
            x, layers, acts, scale=scale, offset=offset, det_scale=det_scale,
            det_offset=det_offset, agg_thr=agg_thr, idx=idx, n_rows=n_rows, y=y,
            y_offset=y_offset,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fleet_score runs on cuda or cpu tensors, got {x.device}")
    device = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (m, n, f), got shape {tuple(x.shape)}")
    m, n, f = (int(s) for s in x.shape)
    if not 1 <= m <= MAX_SLOTS or n < 1:
        raise ValueError(f"x must have 1..{MAX_SLOTS} slots and >= 1 row, got {tuple(x.shape)}")
    if not 1 <= len(layers) <= MAX_LAYERS or len(acts) != len(layers):
        raise ValueError(
            f"need 1..{MAX_LAYERS} layers with one activation each, got "
            f"{len(layers)} layers and {len(acts)} activations"
        )
    for a in acts:
        if a not in ACT_CODES:
            raise ValueError(f"activation {a!r} has no kernel code")
    M = int(layers[0][0].shape[0])
    dims = [f]
    for i, (W, b) in enumerate(layers):
        if W.dim() != 3:
            raise ValueError(f"layer {i} weight must be (M, in, out), got {tuple(W.shape)}")
        _check(W, f"layer {i} weight", (M, dims[-1], int(W.shape[2])), device)
        _check(b, f"layer {i} bias", (M, int(W.shape[2])), device)
        dims.append(int(W.shape[2]))
    if min(dims) < 1:
        raise ValueError(f"every layer needs a width >= 1, got {dims}")
    fo = dims[-1]
    _check(x, "x", (m, n, f), device)
    if (scale is None) != (offset is None):
        raise ValueError("scale and offset come together")
    _check(scale, "scale", (M, f), device)
    _check(offset, "offset", (M, f), device)
    if (det_scale is None) != (det_offset is None):
        raise ValueError("det_scale and det_offset come together")
    if det_scale is None and (agg_thr is not None or y is not None):
        raise ValueError("agg_thr and y need the detector scaler")
    if det_scale is not None and y is None and fo != f:
        raise ValueError(
            f"anomaly scoring against x needs as many outputs as inputs ({fo} != {f})"
        )
    _check(det_scale, "det_scale", (M, fo), device)
    _check(det_offset, "det_offset", (M, fo), device)
    _check(agg_thr, "agg_thr", (M,), device)
    y_n = n
    if y is not None:
        y_n = int(y.shape[1]) if y.dim() == 3 else -1
        if y_offset < 0 or y_n < y_offset + n:
            raise ValueError(
                f"y needs rows {y_offset}..{y_offset + n - 1} of each slot, got "
                f"shape {tuple(y.shape)}"
            )
        _check(y, "y", (m, y_n, fo), device)
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

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    plan = launch_plan(dims, m, n, sm_count, with_detector=det_scale is not None)
    pred = torch.empty((m, n, fo), dtype=torch.float32, device=device)
    out = {"model-output": pred}
    tag = total = conf = None
    if det_scale is not None:
        tag = out["tag-anomaly-scores"] = torch.empty_like(pred)
        total = out["total-anomaly-score"] = torch.empty((m, n), dtype=torch.float32, device=device)
        if agg_thr is not None:
            conf = out["anomaly-confidence"] = torch.empty_like(total)

    args = _Args()
    args.x, args.y = _ptr(x), _ptr(y)
    args.idx, args.n_rows = _ptr(idx_dev), _ptr(rows_dev)
    args.scale, args.offset = _ptr(scale), _ptr(offset)
    for i, (W, b) in enumerate(layers):
        args.w[i], args.b[i] = W.data_ptr(), b.data_ptr()
    args.det_scale, args.det_offset = _ptr(det_scale), _ptr(det_offset)
    args.agg_thr = _ptr(agg_thr)
    args.pred, args.tag, args.total, args.conf = (
        _ptr(pred), _ptr(tag), _ptr(total), _ptr(conf)
    )
    args.m, args.n, args.f, args.n_layers = m, n, f, len(layers)
    args.y_n, args.y_row0 = y_n, y_offset
    for i, d in enumerate(dims):
        args.dims[i] = d
    for i, a in enumerate(acts):
        args.act[i] = ACT_CODES[a]
    args.rows_per_block = plan.rows_per_block
    args.max_dim = max(dims)
    args.weights_resident = int(plan.weights_resident)
    args.wbuf_floats = plan.wbuf_floats
    args.smem_bytes = plan.smem_bytes

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fleet_score_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fleet_score launch failed: {lib.fleet_score_error_string(rc).decode()}"
        )
    global launches
    with _launches_lock:
        launches += 1
    return out


def fleet_score_plain(
    x: torch.Tensor,
    layers: Layers,
    acts: Sequence[Optional[str]],
    *,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    det_scale: Optional[torch.Tensor] = None,
    det_offset: Optional[torch.Tensor] = None,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
    y: Optional[torch.Tensor] = None,
    y_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """:func:`fleet_score` in plain PyTorch, in the JAX program's op order.

    ``n_rows`` only marks which output rows are meaningful; every row is
    computed."""
    if idx is not None:
        take = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)

        def pick(t):
            return None if t is None else t.index_select(0, take)

        layers = [(pick(W), pick(b)) for W, b in layers]
        scale, offset = pick(scale), pick(offset)
        det_scale, det_offset, agg_thr = pick(det_scale), pick(det_offset), pick(agg_thr)
    h = x if scale is None else x * scale[:, None, :] + offset[:, None, :]
    for (W, b), act in zip(layers, acts):
        h = ACTIVATIONS[act](torch.bmm(h, W) + b[:, None, :])
    out = {"model-output": h}
    if det_scale is not None:
        target = x if y is None else y[:, y_offset: y_offset + x.shape[1]]
        ds, do = det_scale[:, None, :], det_offset[:, None, :]
        tag = torch.abs((h * ds + do) - (target * ds + do))
        total = torch.sqrt(torch.sum(tag * tag, dim=-1))
        out["tag-anomaly-scores"] = tag
        out["total-anomaly-score"] = total
        if agg_thr is not None:
            out["anomaly-confidence"] = total / torch.clamp_min(agg_thr, 1e-12)[:, None]
    return out
