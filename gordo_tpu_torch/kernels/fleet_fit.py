"""``fleet_fit``: every fit of a fleet build in one launch (K1 train step
and K2 Adam).

Replaces the training half of the XLA program ``fleet.exact``
(``gordo_tpu/parallel/anomaly.py:1093`` ``one_fit``, vmapped over
machines), i.e. ``make_fit_fn`` / ``make_epoch_fn``
(``gordo_tpu/train/fit.py:217,160``) with ``optax.adam`` inside.  The
kernel is CUDA C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/fleet_fit.cu``,
whose header gives its bound and design); :func:`fleet_fit_plain` is the
same function in plain PyTorch, built on
:func:`gordo_tpu_torch.train.fit.fit_plain`.

A call trains ``G`` fits of each of ``M`` machines.  Fit ``g`` trains on
the rows ``fits[g]`` of each machine's ``X``/``y`` (a fold's train rows,
or every row), scaled by that machine's ``scale[:, g]``/``offset[:, g]``
as they are loaded, from the initial params and epoch permutations of
draw ``draw[i]``.

:func:`fleet_fit` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.train.fit import batch_geometry, fit_plain

SOURCE = "gordo_tpu_torch/csrc/fleet_fit.cu"
REPLACES = "gordo_tpu/train/fit.py:160"

#: activation codes of the kernel's ``act_fn``
ACT_CODES = {None: 0, "linear": 0, "tanh": 1}
MAX_LAYERS = 16
MAX_FITS = 16
MAX_THREADS = 1024
#: shared memory one block may use on sm_90
SMEM_LIMIT = 232448
MAX_MACHINES = 65535
WIDE_ITEM = "ROADMAP queue 1 item 13 (wide fleet fit)"
ACT_ITEM = "ROADMAP queue 1 item 2 (training: activations other than tanh/linear)"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


class _Args(ctypes.Structure):
    """Mirror of ``struct FleetFitArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("offset", ctypes.c_void_p),
        ("perms", ctypes.c_void_p),
        ("draw", ctypes.c_void_p),
        ("w0", ctypes.c_void_p * MAX_LAYERS),
        ("b0", ctypes.c_void_p * MAX_LAYERS),
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
        ("history", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("g", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("epochs", ctypes.c_int),
        ("perm_len", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("act", ctypes.c_int * MAX_LAYERS),
        ("fit_rows", ctypes.c_int * MAX_FITS),
        ("fit_bs", ctypes.c_int * MAX_FITS),
        ("fit_steps", ctypes.c_int * MAX_FITS),
        ("fit_row_off", ctypes.c_int * MAX_FITS),
        ("fit_perm_off", ctypes.c_int * MAX_FITS),
        ("lr", ctypes.c_float),
        ("b1", ctypes.c_float),
        ("b2", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("one_b1", ctypes.c_float),
        ("one_b2", ctypes.c_float),
        ("n_params", ctypes.c_int),
        ("row_stride", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fleet_fit")
            lib.fleet_fit_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.fleet_fit_launch.restype = ctypes.c_int
            lib.fleet_fit_error_string.argtypes = [ctypes.c_int]
            lib.fleet_fit_error_string.restype = ctypes.c_char_p
            lib.fleet_fit_args_size.argtypes = []
            lib.fleet_fit_args_size.restype = ctypes.c_int
            if lib.fleet_fit_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"fleet_fit: FleetFitArgs is {lib.fleet_fit_args_size()} bytes "
                    f"in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


class FitGeometry(NamedTuple):
    """One fit's rows and minibatch geometry."""

    rows: np.ndarray  # (n,) int row indices into X / y
    steps: int
    bs: int

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_total(self) -> int:
        return self.steps * self.bs


def geometry(rows, batch_size: int) -> FitGeometry:
    rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
    steps, bs, _ = batch_geometry(int(rows.shape[0]), batch_size)
    return FitGeometry(rows, steps, bs)


def pack_perms(per_fit: Sequence[np.ndarray]) -> np.ndarray:
    """``[(D, epochs, n_total_g), ...]`` → (D, sum_g epochs * n_total_g) int32,
    the kernel's layout of one draw's permutations."""
    return np.ascontiguousarray(
        np.concatenate([np.asarray(p).reshape(p.shape[0], -1) for p in per_fit], axis=1),
        dtype=np.int32,
    )


def unpack_perms(perms: torch.Tensor, fits: Sequence[FitGeometry], epochs: int) -> List[torch.Tensor]:
    out, off = [], 0
    for fg in fits:
        size = epochs * fg.n_total
        out.append(perms[:, off: off + size].reshape(-1, epochs, fg.n_total))
        off += size
    return out


class LaunchPlan(NamedTuple):
    threads: int
    row_stride: int
    smem_bytes: int


def launch_plan(dims: Sequence[int], max_bs: int) -> LaunchPlan:
    """Block size and shared memory for widths ``dims`` and minibatches of
    up to ``max_bs`` rows.  Raises ``NotImplementedError`` (wide fleet fit)
    when one machine's weights, Adam moments and a minibatch's rows do not
    fit one block."""
    n_params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    threads = -(-max_bs // 32) * 32
    per_row = sum(dims[:-1]) + sum(dims[1:])
    stride = per_row | 1
    smem = 4 * (3 * n_params + 2 * 32 + threads * stride)
    if threads > MAX_THREADS or smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"fleet_fit cannot take widths {list(dims)} with {max_bs}-row batches: "
            f"{n_params} params, their Adam moments and the batch's rows need "
            f"{smem} bytes of shared memory and {threads} threads, over a "
            f"block's {SMEM_LIMIT} and {MAX_THREADS}; that waits for {WIDE_ITEM}"
        )
    return LaunchPlan(threads, stride, smem)


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(X, y, fits, scale, offset, params0, perms, draw, acts, epochs):
    if X.dim() != 3 or y.dim() != 3 or y.shape[:2] != X.shape[:2]:
        raise ValueError(f"X (M, N, F) and y (M, N, Fo) must agree, got {tuple(X.shape)}, {tuple(y.shape)}")
    M, N, F = (int(s) for s in X.shape)
    G = len(fits)
    if not 1 <= G <= MAX_FITS:
        raise ValueError(f"need 1..{MAX_FITS} fits, got {G}")
    if not 1 <= M <= MAX_MACHINES:
        raise ValueError(f"need 1..{MAX_MACHINES} machines, got {M}")
    if not 1 <= len(params0) <= MAX_LAYERS or len(acts) != len(params0):
        raise ValueError(
            f"need 1..{MAX_LAYERS} layers with one activation each, got "
            f"{len(params0)} layers and {len(acts)} activations"
        )
    for a in acts:
        if a not in ACT_CODES:
            raise NotImplementedError(f"activation {a!r} in a fit waits for {ACT_ITEM}")
    D = int(params0[0][0].shape[0])
    dims = [F]
    for i, (W, b) in enumerate(params0):
        _check(W, f"params0 layer {i} kernel", (D, dims[-1], W.shape[2]), torch.float32, X.device)
        _check(b, f"params0 layer {i} bias", (D, W.shape[2]), torch.float32, X.device)
        dims.append(int(W.shape[2]))
    if dims[-1] != y.shape[2]:
        raise ValueError(f"the last layer has {dims[-1]} outputs, y {y.shape[2]} columns")
    for name, t in (("X", X), ("y", y)):
        _check(t, name, t.shape, torch.float32, X.device)
    _check(scale, "scale", (M, G, F), torch.float32, X.device)
    _check(offset, "offset", (M, G, F), torch.float32, X.device)
    perm_len = sum(epochs * fg.n_total for fg in fits)
    _check(perms, "perms", (D, perm_len), torch.int32, X.device)
    draw = np.asarray(draw, dtype=np.int64)
    if draw.shape != (M,) or (M and (draw.min() < 0 or draw.max() >= D)):
        raise ValueError(f"draw must be (M,) = ({M},) ints in [0, {D})")
    for fg in fits:
        if fg.n < 1 or fg.rows.min() < 0 or fg.rows.max() >= N:
            raise ValueError(f"a fit's rows must be non-empty and lie in [0, {N})")
    return M, N, F, G, D, dims, draw


def fleet_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    fits: Sequence[FitGeometry],
    scale: torch.Tensor,
    offset: torch.Tensor,
    params0: Layers,
    perms: torch.Tensor,
    draw,
    acts: Sequence[Optional[str]],
    epochs: int,
    hp,
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """Train ``len(fits)`` fits of each machine.

    ``X`` (M, N, F), ``y`` (M, N, Fo) raw rows; ``fits`` each fit's rows
    and geometry (:func:`geometry`); ``scale``/``offset`` (M, G, F) each
    fit's MinMax; ``params0`` ``[(W (D, in, out), b (D, out)), ...]`` and
    ``perms`` (D, perm_len) int32 (:func:`pack_perms`) the draws, of which
    machine ``i`` uses ``draw[i]``; ``acts`` one activation per layer;
    ``hp`` the Adam hyperparameters (``train.fit.adam_hparams``).

    Returns ``([(W (M, G, in, out), b (M, G, out)), ...], history (M, G,
    epochs))``."""
    if X.device.type == "cpu":
        return fleet_fit_plain(X, y, fits, scale, offset, params0, perms, draw, acts, epochs, hp)
    if X.device.type != "cuda":
        raise ValueError(f"fleet_fit runs on cuda or cpu tensors, got {X.device}")
    M, N, F, G, D, dims, draw = _validate(
        X, y, fits, scale, offset, params0, perms, draw, acts, epochs
    )
    device = X.device
    plan = launch_plan(dims, max(fg.bs for fg in fits))
    rows = to_device(np.concatenate([fg.rows for fg in fits]).astype(np.int32), device)
    draw_dev = to_device(draw.astype(np.int32), device)
    out = [
        (torch.empty((M, G, dims[i], dims[i + 1]), dtype=torch.float32, device=device),
         torch.empty((M, G, dims[i + 1]), dtype=torch.float32, device=device))
        for i in range(len(dims) - 1)
    ]
    history = torch.empty((M, G, epochs), dtype=torch.float32, device=device)

    args = _Args()
    args.x, args.y, args.rows = X.data_ptr(), y.data_ptr(), rows.data_ptr()
    args.scale, args.offset = scale.data_ptr(), offset.data_ptr()
    args.perms, args.draw = perms.data_ptr(), draw_dev.data_ptr()
    for i, ((W0, b0), (W, b)) in enumerate(zip(params0, out)):
        args.w0[i], args.b0[i] = W0.data_ptr(), b0.data_ptr()
        args.w[i], args.b[i] = W.data_ptr(), b.data_ptr()
    args.history = history.data_ptr()
    args.m, args.n, args.g, args.n_layers = M, N, G, len(params0)
    args.epochs, args.perm_len = epochs, int(perms.shape[1])
    for i, d in enumerate(dims):
        args.dims[i] = d
    for i, a in enumerate(acts):
        args.act[i] = ACT_CODES[a]
    row_off = perm_off = 0
    for i, fg in enumerate(fits):
        args.fit_rows[i], args.fit_bs[i], args.fit_steps[i] = fg.n, fg.bs, fg.steps
        args.fit_row_off[i], args.fit_perm_off[i] = row_off, perm_off
        row_off += fg.n
        perm_off += epochs * fg.n_total
    args.lr, args.b1, args.b2, args.eps = hp["lr"], hp["b1"], hp["b2"], hp["eps"]
    args.one_b1, args.one_b2 = 1 - hp["b1"], 1 - hp["b2"]
    args.n_params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    args.row_stride = plan.row_stride
    args.smem_bytes = plan.smem_bytes

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fleet_fit_launch(ctypes.byref(args), plan.threads, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fleet_fit launch failed: {lib.fleet_fit_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return out, history


def fleet_fit_plain(
    X: torch.Tensor,
    y: torch.Tensor,
    fits: Sequence[FitGeometry],
    scale: torch.Tensor,
    offset: torch.Tensor,
    params0: Layers,
    perms: torch.Tensor,
    draw,
    acts: Sequence[Optional[str]],
    epochs: int,
    hp,
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """:func:`fleet_fit` in plain PyTorch: each fit's rows gathered, scaled,
    padded to ``steps * bs`` and fitted step for step as ``make_fit_fn``."""
    M, N, F, G, D, dims, draw = _validate(
        X, y, fits, scale, offset, params0, perms, draw, acts, epochs
    )
    take = torch.as_tensor(draw, device=X.device)
    start = [(W.index_select(0, take), b.index_select(0, take)) for W, b in params0]
    outs, hists = [], []
    for g, (fg, perm) in enumerate(zip(fits, unpack_perms(perms, fits, epochs))):
        rows = torch.as_tensor(fg.rows, device=X.device)
        pad = fg.n_total - fg.n
        xg = X.index_select(1, rows) * scale[:, g, None, :] + offset[:, g, None, :]
        yg = y.index_select(1, rows)
        xg = torch.cat([xg, xg.new_zeros((M, pad, F))], dim=1)
        yg = torch.cat([yg, yg.new_zeros((M, pad, yg.shape[2]))], dim=1)
        w = torch.cat([X.new_ones(fg.n), X.new_zeros(pad)])
        layers, hist = fit_plain(
            start, acts, xg, yg, w, perm.index_select(0, take), hp, fg.steps, fg.bs
        )
        outs.append(layers)
        hists.append(hist)
    stacked = [
        (torch.stack([o[i][0] for o in outs], dim=1), torch.stack([o[i][1] for o in outs], dim=1))
        for i in range(len(params0))
    ]
    return stacked, torch.stack(hists, dim=1)
