"""``cv_epilogue``: thresholds and CV metrics of each (machine, fold) (K4).

Replaces the fold epilogue of the XLA program ``fleet.exact``
(``gordo_tpu/parallel/anomaly.py:1155-1170``): ``_smoothed_max`` over
``_trailing_rolling_min`` (``:175``, ``:162``) of the detector-scaled tag
errors and of their L2 total, and the four metrics of
``gordo_tpu/ops/metrics.py``.  The kernel is CUDA C++ for ``sm_90a``
(``gordo_tpu_torch/csrc/cv_epilogue.cu``, whose header gives its bound and
design); :func:`cv_epilogue_plain` is the same function in plain PyTorch.

The inputs are ``fleet_score``'s outputs over each slot's out-of-fold rows
(tag errors, totals, predictions) and the raw targets.

:func:`cv_epilogue` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.ops import metrics as tmetrics
from gordo_tpu_torch.train.cv import METRIC_NAMES

SOURCE = "gordo_tpu_torch/csrc/cv_epilogue.cu"
REPLACES = "gordo_tpu/parallel/anomaly.py:175"

#: rolling-min window of the thresholds (the JAX package's SMOOTHING_WINDOW)
SMOOTHING_WINDOW = 6
MAX_SLOTS = 2 ** 31 - 1

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
        ("s", ctypes.c_int),
        ("nt", ctypes.c_int),
        ("fo", ctypes.c_int),
        ("window", ctypes.c_int),
    ]


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
    if rows.shape != (S,) or rows.min() < 1 or rows.max() > nt:
        raise ValueError(f"n_rows must be (S,) = ({S},) ints in [1, {nt}]")
    return rows


def cv_epilogue(
    tag: torch.Tensor,
    total: torch.Tensor,
    pred: torch.Tensor,
    y: torch.Tensor,
    n_rows=None,
    window: int = SMOOTHING_WINDOW,
) -> Dict[str, torch.Tensor]:
    """Per slot: ``feature_max`` (S, fo) and ``total_max`` (S,), the
    smoothed maxima of ``tag`` (S, nt, fo) and ``total`` (S, nt), and the
    four metrics (S,) of ``pred`` against ``y`` (S, nt, fo), over the
    first ``n_rows[s]`` rows of each slot (host ints; default nt)."""
    if tag.device.type == "cpu":
        return cv_epilogue_plain(tag, total, pred, y, n_rows, window)
    if tag.device.type != "cuda":
        raise ValueError(f"cv_epilogue runs on cuda or cpu tensors, got {tag.device}")
    rows = _validate(tag, total, pred, y, n_rows)
    S, nt, fo = (int(s) for s in tag.shape)
    device = tag.device
    rows_dev = to_device(rows.astype(np.int32), device)
    feat_max = torch.empty((S, fo), dtype=torch.float32, device=device)
    total_max = torch.empty((S,), dtype=torch.float32, device=device)
    metrics = torch.empty((S, 4), dtype=torch.float32, device=device)
    args = _Args()
    args.tag, args.total, args.pred, args.y = (
        tag.data_ptr(), total.data_ptr(), pred.data_ptr(), y.data_ptr()
    )
    args.n_rows = rows_dev.data_ptr()
    args.feat_max, args.total_max, args.metrics = (
        feat_max.data_ptr(), total_max.data_ptr(), metrics.data_ptr()
    )
    args.s, args.nt, args.fo, args.window = S, nt, fo, int(window)
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
    out = {"feature_max": feat_max, "total_max": total_max}
    out.update({name: metrics[:, i] for i, name in enumerate(METRIC_NAMES)})
    return out


def smoothed_max(err: torch.Tensor, window: int = SMOOTHING_WINDOW) -> torch.Tensor:
    """Max over rows of the trailing rolling min (``min_periods=1``) of
    ``err`` (..., n, F) → (..., F), propagating NaN as XLA's reductions do."""
    pad = err.new_full(err.shape[:-2] + (window - 1, err.shape[-1]), torch.inf)
    windows = torch.cat([pad, err], dim=-2).unfold(-2, window, 1)
    return windows.amin(dim=-1).amax(dim=-2)


def cv_epilogue_plain(
    tag: torch.Tensor,
    total: torch.Tensor,
    pred: torch.Tensor,
    y: torch.Tensor,
    n_rows=None,
    window: int = SMOOTHING_WINDOW,
) -> Dict[str, torch.Tensor]:
    """:func:`cv_epilogue` in plain PyTorch (``gordo_tpu_torch.ops.metrics``
    for the metrics); slots of equal row counts go together."""
    rows = _validate(tag, total, pred, y, n_rows)
    S, _, fo = tag.shape
    out = {
        "feature_max": tag.new_empty((S, fo)),
        "total_max": tag.new_empty((S,)),
        **{name: tag.new_empty((S,)) for name in METRIC_NAMES},
    }
    for n in np.unique(rows):
        sel = torch.as_tensor(np.flatnonzero(rows == n), device=tag.device)
        pick = lambda t: t.index_select(0, sel)[:, :n]  # noqa: E731
        out["feature_max"][sel] = smoothed_max(pick(tag), window)
        out["total_max"][sel] = smoothed_max(pick(total)[..., None], window)[:, 0]
        for name in METRIC_NAMES:
            out[name][sel] = getattr(tmetrics, name)(pick(y), pick(pred))
    return out
