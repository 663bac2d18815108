"""``rolling_median``: the detector's smoothing of a bucket's scores.

Replaces ``_rolling_median`` and ``_rolling_median_blocked``
(``gordo_tpu/serve/scorer.py:165,178``) on the tag scores and the total
score of every slot, and the confidence of the smoothed total
(``scorer.py:272``), which ``fleet_score`` then leaves out.  The kernel is
CUDA C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/rolling_median.cu``, whose
header gives its bound and design); :func:`rolling_median_plain` is the
same function in plain PyTorch.

:func:`rolling_median` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_score import MAX_SLOTS, SMEM_LIMIT, _check, _ptr, slot_ints

SOURCE = "gordo_tpu_torch/csrc/rolling_median.cu"
REPLACES = "gordo_tpu/serve/scorer.py:165"

#: series per block (RM_LANES in the source), and rows each thread slides over
LANES = 32
CHUNK_ROWS = 128
#: longest window whose sorted buffers fit a block's shared memory
MAX_WINDOW = SMEM_LIMIT // (4 * LANES)

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct RollingMedianArgs`` in the CUDA source."""

    _fields_ = [
        ("tag", ctypes.c_void_p),
        ("total", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_rows", ctypes.c_void_p),
        ("agg_thr", ctypes.c_void_p),
        ("tag_out", ctypes.c_void_p),
        ("total_out", ctypes.c_void_p),
        ("conf", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("window", ctypes.c_int),
        ("chunk_rows", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rolling_median")
            lib.rolling_median_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.rolling_median_launch.restype = ctypes.c_int
            lib.rolling_median_error_string.argtypes = [ctypes.c_int]
            lib.rolling_median_error_string.restype = ctypes.c_char_p
            lib.rolling_median_args_size.argtypes = []
            lib.rolling_median_args_size.restype = ctypes.c_int
            if lib.rolling_median_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "rolling_median: RollingMedianArgs is "
                    f"{lib.rolling_median_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


def rolling_median(
    tag: torch.Tensor,
    total: torch.Tensor,
    window: int,
    *,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
) -> Dict[str, torch.Tensor]:
    """Trailing rolling nanmedian of ``window`` rows (``min_periods=1``)
    over ``tag`` (m, n, f) and ``total`` (m, n) per slot.

    ``agg_thr`` (M,): aggregate thresholds, adding ``anomaly-confidence``
    of the smoothed total.  ``idx`` (m,) host ints: the stacked machine of
    each slot (default slot i is machine i).  ``n_rows`` (m,) host ints:
    valid rows of each slot (default n); output rows past them are
    unspecified.  Returns ``tag-anomaly-scores``, ``total-anomaly-score``
    (and ``anomaly-confidence``).
    """
    if tag.device.type == "cpu":
        return rolling_median_plain(tag, total, window, agg_thr=agg_thr, idx=idx)
    if tag.device.type != "cuda":
        raise ValueError(f"rolling_median runs on cuda or cpu tensors, got {tag.device}")
    device = tag.device
    if tag.dim() != 3:
        raise ValueError(f"tag must be (m, n, f), got shape {tuple(tag.shape)}")
    m, n, f = (int(s) for s in tag.shape)
    if not 1 <= m <= MAX_SLOTS or n < 1:
        raise ValueError(f"tag must have 1..{MAX_SLOTS} slots and >= 1 row, got {tuple(tag.shape)}")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"rolling_median takes windows of 1..{MAX_WINDOW} rows, got {window}")
    _check(tag, "tag", (m, n, f), device)
    _check(total, "total", (m, n), device)
    if agg_thr is not None and agg_thr.dim() != 1:
        raise ValueError(f"agg_thr must be (M,), got shape {tuple(agg_thr.shape)}")
    M = m if agg_thr is None else int(agg_thr.shape[0])
    _check(agg_thr, "agg_thr", (M,), device)
    if idx is None:
        if agg_thr is not None and m != M:
            raise ValueError(f"without idx, tag needs one slot per machine ({m} != {M})")
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

    out = {
        "tag-anomaly-scores": torch.empty_like(tag),
        "total-anomaly-score": torch.empty_like(total),
    }
    if agg_thr is not None:
        out["anomaly-confidence"] = torch.empty_like(total)
    args = _Args()
    args.tag, args.total = _ptr(tag), _ptr(total)
    args.idx, args.n_rows, args.agg_thr = _ptr(idx_dev), _ptr(rows_dev), _ptr(agg_thr)
    args.tag_out = _ptr(out["tag-anomaly-scores"])
    args.total_out = _ptr(out["total-anomaly-score"])
    args.conf = _ptr(out.get("anomaly-confidence"))
    args.m, args.n, args.f, args.window = m, n, f, window
    args.chunk_rows = CHUNK_ROWS
    args.smem_bytes = 4 * LANES * window

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.rolling_median_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"rolling_median launch failed: {lib.rolling_median_error_string(rc).decode()}"
        )
    global launches
    with _launches_lock:
        launches += 1
    return out


def _nanmedian_windows(a: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing nanmedian of ``a`` (n, c) along rows, as ``jnp.nanmedian``
    takes it: NaNs dropped, ``(lo + hi) * 0.5`` of the middle values."""
    pad = a.new_full((window - 1, a.shape[1]), float("nan"))
    wins = torch.cat([pad, a]).unfold(0, window, 1)  # (n, c, window)
    valid = ~torch.isnan(wins)
    count = valid.sum(-1, keepdim=True)
    # NaNs sort last; the middle values sit at (count-1)//2 and count//2
    ordered = torch.sort(torch.where(valid, wins, torch.inf), dim=-1).values
    lo = torch.gather(ordered, -1, ((count - 1).clamp_min(0)) // 2)
    hi = torch.gather(ordered, -1, count // 2)
    med = ((lo + hi) * 0.5).squeeze(-1)
    return torch.where(count.squeeze(-1) > 0, med, torch.full_like(med, float("nan")))


def rolling_median_plain(
    tag: torch.Tensor,
    total: torch.Tensor,
    window: int,
    *,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
) -> Dict[str, torch.Tensor]:
    """:func:`rolling_median` in plain PyTorch, one slot at a time (the
    windows of a slot are sorted whole).  Every row is computed."""
    f = tag.shape[-1]
    smoothed = torch.stack([
        _nanmedian_windows(torch.cat([tag[s], total[s][:, None]], dim=1), window)
        for s in range(tag.shape[0])
    ])
    out = {
        "tag-anomaly-scores": smoothed[..., :f].contiguous(),
        "total-anomaly-score": smoothed[..., f].contiguous(),
    }
    if agg_thr is not None:
        thr = agg_thr
        if idx is not None:
            thr = thr.index_select(0, torch.as_tensor(np.asarray(idx, np.int64), device=thr.device))
        out["anomaly-confidence"] = out["total-anomaly-score"] / torch.clamp_min(thr, 1e-12)[:, None]
    return out
