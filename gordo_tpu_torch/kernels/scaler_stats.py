"""``scaler_stats``: MinMax stats of many machines over many row lists (K3).

Replaces ``MinMaxScaler.compute_stats`` (``gordo_tpu/ops/scalers.py:139``)
as the XLA program ``fleet.exact`` runs it per machine, on every fold's
rows, the full series and (for the detector scaler) the targets
(``gordo_tpu/parallel/anomaly.py:196,1124``).  The kernel is CUDA C++ for
``sm_90a`` (``gordo_tpu_torch/csrc/scaler_stats.cu``, whose header gives
its bound and design); :func:`scaler_stats_plain` is the same function in
plain PyTorch.

:func:`scaler_stats` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build

SOURCE = "gordo_tpu_torch/csrc/scaler_stats.cu"
REPLACES = "gordo_tpu/ops/scalers.py:139"

MAX_FITS = 16
MAX_MACHINES = 65535
_EPS = 1e-12

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct ScalerStatsArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("offset", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("g", ctypes.c_int),
        ("fit_rows", ctypes.c_int * MAX_FITS),
        ("fit_row_off", ctypes.c_int * MAX_FITS),
        ("range_lo", ctypes.c_float),
        ("range_span", ctypes.c_float),
    ]


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
            lib.scaler_stats_args_size.argtypes = []
            lib.scaler_stats_args_size.restype = ctypes.c_int
            if lib.scaler_stats_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"scaler_stats: ScalerStatsArgs is {lib.scaler_stats_args_size()} "
                    f"bytes in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


def _validate(x: torch.Tensor, row_lists) -> Tuple[int, int, int, list]:
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
    return M, N, F, lists


def scaler_stats(
    x: torch.Tensor,
    row_lists: Sequence,
    feature_range=(0.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MinMax ``(scale, offset)``, each (M, G, F), of each machine of ``x``
    (M, N, F) over each of the ``G`` host row lists in ``row_lists``."""
    if x.device.type == "cpu":
        return scaler_stats_plain(x, row_lists, feature_range)
    if x.device.type != "cuda":
        raise ValueError(f"scaler_stats runs on cuda or cpu tensors, got {x.device}")
    M, N, F, lists = _validate(x, row_lists)
    G = len(lists)
    device = x.device
    rows = to_device(np.concatenate(lists).astype(np.int32), device)
    scale = torch.empty((M, G, F), dtype=torch.float32, device=device)
    offset = torch.empty_like(scale)
    a, b = feature_range
    args = _Args()
    args.x, args.rows = x.data_ptr(), rows.data_ptr()
    args.scale, args.offset = scale.data_ptr(), offset.data_ptr()
    args.m, args.n, args.f, args.g = M, N, F, G
    off = 0
    for i, r in enumerate(lists):
        args.fit_rows[i], args.fit_row_off[i] = int(r.size), off
        off += int(r.size)
    args.range_lo, args.range_span = float(a), float(b - a)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.scaler_stats_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"scaler_stats launch failed: {lib.scaler_stats_error_string(rc).decode()}"
        )
    global launches
    with _launches_lock:
        launches += 1
    return scale, offset


def scaler_stats_plain(
    x: torch.Tensor,
    row_lists: Sequence,
    feature_range=(0.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scaler_stats` in plain PyTorch, with ``jnp.nanmin``/
    ``jnp.nanmax`` semantics (NaN skipped, an all-NaN column is NaN)."""
    _, _, _, lists = _validate(x, row_lists)
    a, b = feature_range
    scales, offsets = [], []
    for rows in lists:
        xs = x.index_select(1, torch.as_tensor(rows, device=x.device))
        nan = torch.isnan(xs)
        lo = torch.where(nan, torch.inf, xs).amin(dim=1)
        hi = torch.where(nan, -torch.inf, xs).amax(dim=1)
        empty = nan.all(dim=1)
        lo = torch.where(empty, torch.nan, lo)
        hi = torch.where(empty, torch.nan, hi)
        # torch.maximum keeps a NaN, as jnp.maximum does
        scale = (b - a) / torch.maximum(hi - lo, torch.tensor(_EPS, device=x.device))
        scales.append(scale)
        offsets.append(a - lo * scale)
    return torch.stack(scales, dim=1), torch.stack(offsets, dim=1)
