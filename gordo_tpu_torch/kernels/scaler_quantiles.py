"""``scaler_quantiles``: RobustScaler stats of many machines over many row
lists, through a chain's earlier steps (K3).

Replaces ``RobustScaler.compute_stats`` (``gordo_tpu/ops/scalers.py:207-217``)
as the XLA programs ``fleet.exact`` and ``fleet.padded`` run it per machine
(``gordo_tpu/parallel/anomaly.py:196-214,1124,1327``): per machine, row
list and column, the NaN-aware linear percentiles at ``quantile_range``
(lo, 50, hi) with ``jnp.nanpercentile``'s own interpolation, then ``center
= q50`` and ``scale = max(q_hi - q_lo, 1e-12)``.  The kernel is CUDA C++
for ``sm_90a`` (``gordo_tpu_torch/csrc/scaler_quantiles.cu``, whose header
gives its bound and design: a radix selection in shared memory, and past
:data:`ROBUST_SORT_ABOVE` rows the grid's sort over a thread-block
cluster);
:func:`scaler_quantiles_plain` is the same function in plain PyTorch
(``torch.sort`` and the reference's formula step by step;
``torch.nanquantile`` interpolates with ``lerp``, another rounding).

:func:`scaler_quantiles_grid` is the kernel's grid variant: every
quantile of a grid of Q fractions, ``jnp.nanpercentile`` at
``jnp.linspace(0, 100, Q)`` for ``QuantileTransformer.fit``
(``gordo_tpu/ops/scalers.py:240-246``) and ``jnp.nanmedian`` for
``SimpleImputer(strategy="median")`` (``:288-299``, method "midpoint");
its launches count in :data:`grid_launches`, not in :data:`launches`.

A series longer than :data:`MAX_ROWS` rows (the keys one block's shared
memory holds) raises ``NotImplementedError`` naming ROADMAP queue 1 item
20; nothing falls back to the plain version.  :func:`scaler_quantiles`
takes the plain version only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises, and adds one to :data:`launches` per
launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_init import fma
from gordo_tpu_torch.kernels.scaler_stats import (
    MAX_FITS,
    Prefix,
    ScalerChain,
    apply_prefix,
    fill_launch,
    validate,
)

SOURCE = "gordo_tpu_torch/csrc/scaler_quantiles.cu"
REPLACES = "gordo_tpu/ops/scalers.py:207"
#: the grid variant's TPU code (QuantileTransformer.fit)
REPLACES_GRID = "gordo_tpu/ops/scalers.py:240"

#: the longest row list a launch takes (``QS_MAX_ROWS``: 224 KiB of keys)
MAX_ROWS = 57_344
#: Robust's row lists past this many rows sort each column once (the
#: grid's cluster sort, ``QS_SORT_CHUNK`` keys a block); up to it, the
#: radix selection
ROBUST_SORT_ABOVE = 8_192
LONG_SERIES_ITEM = "ROADMAP queue 1 item 20 (long-series robust stats)"
_EPS = 1e-12

#: kernel launches so far, Robust's and the grid variant's (the CPU path
#: never counts)
launches = 0
grid_launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct ScalerQuantilesArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("center", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("g", ctypes.c_int),
        ("fit_rows", ctypes.c_int * MAX_FITS),
        ("fit_row_off", ctypes.c_int * MAX_FITS),
        ("q", ctypes.c_float * 3),
        ("with_centering", ctypes.c_int),
        ("with_scaling", ctypes.c_int),
        ("prefix", ScalerChain),
    ]


class _GridArgs(ctypes.Structure):
    """Mirror of ``struct ScalerGridArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("q", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("g", ctypes.c_int),
        ("fit_rows", ctypes.c_int * MAX_FITS),
        ("fit_row_off", ctypes.c_int * MAX_FITS),
        ("nq", ctypes.c_int),
        ("midpoint", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("scaler_quantiles")
            lib.scaler_quantiles_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.scaler_quantiles_launch.restype = ctypes.c_int
            lib.scaler_quantiles_grid_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.scaler_quantiles_grid_launch.restype = ctypes.c_int
            lib.scaler_quantiles_error_string.argtypes = [ctypes.c_int]
            lib.scaler_quantiles_error_string.restype = ctypes.c_char_p
            for name in ("scaler_quantiles_args_size", "scaler_quantiles_grid_args_size",
                         "scaler_quantiles_max_rows"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_int
            if lib.scaler_quantiles_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"scaler_quantiles: ScalerQuantilesArgs is {lib.scaler_quantiles_args_size()} "
                    f"bytes in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            if lib.scaler_quantiles_grid_args_size() != ctypes.sizeof(_GridArgs):
                raise RuntimeError("scaler_quantiles: ScalerGridArgs differs from _GridArgs")
            if lib.scaler_quantiles_max_rows() != MAX_ROWS:
                raise RuntimeError("scaler_quantiles: QS_MAX_ROWS differs from MAX_ROWS")
            _lib = lib
        return _lib


def fractions(quantile_range) -> np.ndarray:
    """``(lo, 50, hi) / 100`` in float32, as ``jnp.nanpercentile`` takes
    them: the percentiles as f32, divided in f32 (0.1 is inexact)."""
    lo, hi = quantile_range
    return np.array([lo, 50.0, hi], np.float32) / np.float32(100)


def _check_rows(lists) -> int:
    longest = max(int(r.size) for r in lists)
    if longest > MAX_ROWS:
        raise NotImplementedError(
            f"robust stats of a {longest}-row series wait for {LONG_SERIES_ITEM}: "
            f"scaler_quantiles takes at most {MAX_ROWS} rows a row list"
        )
    return longest


def scaler_quantiles(
    x: torch.Tensor,
    row_lists: Sequence,
    quantile_range=(25.0, 75.0),
    with_centering: bool = True,
    with_scaling: bool = True,
    prefix: Prefix = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RobustScaler ``(center, scale)``, each (M, G, F), of each machine of
    ``x`` (M, N, F) over each of the ``G`` host row lists in ``row_lists``,
    each value first taken through ``prefix`` (``scaler_stats``'s)."""
    if x.device.type == "cpu":
        return scaler_quantiles_plain(x, row_lists, quantile_range, with_centering, with_scaling, prefix)
    if x.device.type != "cuda":
        raise ValueError(f"scaler_quantiles runs on cuda or cpu tensors, got {x.device}")
    M, N, F, lists = validate(x, row_lists, prefix)
    longest = _check_rows(lists)
    center = torch.empty((M, len(lists), F), dtype=torch.float32, device=x.device)
    scale = torch.empty_like(center)
    args = _Args()
    rows = fill_launch(args, x, lists, prefix)  # noqa: F841 (kept alive past the launch)
    args.center, args.scale = center.data_ptr(), scale.data_ptr()
    for i, q in enumerate(fractions(quantile_range)):
        args.q[i] = float(q)
    args.with_centering, args.with_scaling = int(bool(with_centering)), int(bool(with_scaling))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.scaler_quantiles_launch(ctypes.byref(args), longest, ROBUST_SORT_ABOVE, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"scaler_quantiles launch failed: {lib.scaler_quantiles_error_string(rc).decode()}"
        )
    global launches
    with _launches_lock:
        launches += 1
    return center, scale


def scaler_quantiles_plain(
    x: torch.Tensor,
    row_lists: Sequence,
    quantile_range=(25.0, 75.0),
    with_centering: bool = True,
    with_scaling: bool = True,
    prefix: Prefix = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scaler_quantiles` in plain PyTorch: a sort with NaN last and
    ``jax._src.numpy.reductions._quantile``'s linear interpolation
    (``squash_nans=True``) in float32, each operation rounded on its own."""
    _, _, _, lists = validate(x, row_lists, prefix)
    _check_rows(lists)
    q = torch.from_numpy(fractions(quantile_range)).to(x.device)[:, None, None]
    eps = torch.tensor(_EPS, device=x.device)
    centers, scales = [], []
    for g, rows in enumerate(lists):
        xs = apply_prefix(x.index_select(1, torch.as_tensor(rows, device=x.device)), prefix, g)
        # NaN sorts last in torch.sort, and -0.0 with 0.0 keeps either value
        v = torch.sort(xs, dim=1).values
        cm1 = (~torch.isnan(xs)).sum(dim=1).to(torch.float32) - 1.0     # (M, F)
        pos = q * cm1[None]                                             # (3, M, F)
        lo, hi = torch.floor(pos), torch.ceil(pos)
        hw = pos - lo
        lw = 1.0 - hw
        zero = torch.zeros_like(pos)
        lo = torch.maximum(zero, torch.minimum(lo, cm1[None])).long()
        hi = torch.maximum(zero, torch.minimum(hi, cm1[None])).long()
        vt = v.permute(1, 0, 2)[None].expand(3, -1, -1, -1)             # (3, n, M, F)
        v_lo = torch.gather(vt, 1, lo[:, None]).squeeze(1)
        v_hi = torch.gather(vt, 1, hi[:, None]).squeeze(1)
        # fma(v[h], hw, v[l] * lw), as XLA:CPU fuses it, rounded once
        quant = fma(v_hi, hw, v_lo * lw)
        center = quant[1]
        scale = torch.maximum(quant[2] - quant[0], eps)
        centers.append(center if with_centering else torch.zeros_like(center))
        scales.append(scale if with_scaling else torch.ones_like(scale))
    return torch.stack(centers, dim=1), torch.stack(scales, dim=1)


def _check_grid(q: torch.Tensor, device) -> int:
    if q.dim() != 1 or q.numel() < 1 or q.dtype != torch.float32 or q.device != device:
        raise ValueError(f"q must be a non-empty float32 (Q,) tensor on {device}")
    return int(q.numel())


def scaler_quantiles_grid(
    x: torch.Tensor,
    row_lists: Sequence,
    q: torch.Tensor,
    midpoint: bool = False,
) -> torch.Tensor:
    """The NaN-aware quantiles at the fractions ``q`` (Q,) float32 on
    ``x``'s device (ascending) of each machine of ``x`` (M, N, F) over each
    host row list: (M, G, Q, F).  ``midpoint``: ``jnp.nanmedian``'s
    ``(v[l] + v[h]) * 0.5`` instead of the linear interpolation."""
    if x.device.type == "cpu":
        return scaler_quantiles_grid_plain(x, row_lists, q, midpoint)
    if x.device.type != "cuda":
        raise ValueError(f"scaler_quantiles_grid runs on cuda or cpu tensors, got {x.device}")
    M, N, F, lists = validate(x, row_lists, ())
    longest = _check_rows(lists)
    nq = _check_grid(q, x.device)
    q = q.contiguous()
    out = torch.empty((M, len(lists), nq, F), dtype=torch.float32, device=x.device)
    args = _GridArgs()
    rows = fill_launch(args, x, lists)  # noqa: F841 (kept alive past the launch)
    args.q, args.out = q.data_ptr(), out.data_ptr()
    args.nq, args.midpoint = nq, int(bool(midpoint))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.scaler_quantiles_grid_launch(ctypes.byref(args), longest, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"scaler_quantiles_grid launch failed: {lib.scaler_quantiles_error_string(rc).decode()}"
        )
    global grid_launches
    with _launches_lock:
        grid_launches += 1
    return out


def scaler_quantiles_grid_plain(
    x: torch.Tensor,
    row_lists: Sequence,
    q: torch.Tensor,
    midpoint: bool = False,
) -> torch.Tensor:
    """:func:`scaler_quantiles_grid` in plain PyTorch: ``_quantile`` with
    ``squash_nans=True`` step by step, the linear interpolation's
    ``fma(v[h], hw, v[l] * lw)`` rounded once (``fleet_init.fma``)."""
    _, _, _, lists = validate(x, row_lists, ())
    _check_rows(lists)
    _check_grid(q, x.device)
    qq = q[:, None, None]
    out = []
    for rows in lists:
        xs = x.index_select(1, torch.as_tensor(rows, device=x.device))
        v = torch.sort(xs, dim=1).values
        cm1 = (~torch.isnan(xs)).sum(dim=1).to(torch.float32) - 1.0     # (M, F)
        pos = qq * cm1[None]                                            # (Q, M, F)
        lo, hi = torch.floor(pos), torch.ceil(pos)
        hw = pos - lo
        lw = 1.0 - hw
        zero = torch.zeros_like(pos)
        lo = torch.maximum(zero, torch.minimum(lo, cm1[None])).long()
        hi = torch.maximum(zero, torch.minimum(hi, cm1[None])).long()
        vt = v.permute(1, 0, 2)                                         # (n, M, F)
        v_lo = torch.stack([torch.gather(vt, 0, lo[k][None])[0] for k in range(lo.shape[0])])
        v_hi = torch.stack([torch.gather(vt, 0, hi[k][None])[0] for k in range(hi.shape[0])])
        if midpoint:
            quant = (v_lo + v_hi) * 0.5
        else:
            quant = fma(v_hi, hw, v_lo * lw)
        out.append(quant.permute(1, 0, 2))                              # (M, Q, F)
    return torch.stack(out, dim=1)
