"""``fleet_fit``: every fit of a fleet build in one launch (K1 train step
and K2 Adam).

Replaces the training half of the XLA program ``fleet.exact``
(``gordo_tpu/parallel/anomaly.py:1093`` ``one_fit``, vmapped over
machines), i.e. ``make_fit_fn`` / ``make_epoch_fn``
(``gordo_tpu/train/fit.py:217,160``) with ``optax.adam`` inside; with
Adam state in and out, ``train.stateful_fit``
(``gordo_tpu/train/checkpoint.py:165``); with row weights, ``fleet.fit``
(``gordo_tpu/parallel/fleet.py:314``).  The
kernel is CUDA C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/fleet_fit.cu``,
whose header gives its bound and design); :func:`fleet_fit_plain` is the
same function in plain PyTorch, built on
:func:`gordo_tpu_torch.train.fit.fit_plain`.

A call trains ``G`` fits of each of ``M`` machines.  Fit ``g`` trains on
the rows ``fits[g]`` of each machine's ``X``/``y`` (a fold's train rows,
or every row), taken through that machine's scaler steps of fit ``g``
(each step in its own form) as they are loaded, from the initial params of draw ``draw[i]`` and the
epoch permutations of draw ``perm_draw[i]`` (default ``draw[i]``; a warm
build gives each machine its own params and all of them the seed's
permutations).  ``counts`` (M, G) is each machine's real rows of each
fit, by default the fit's row count (in the pad-up build the machine's
rows past its length are padding, a suffix of the fit's rows): the fit's
geometry is shared, and rows at positions ``>= counts[i, g]`` weigh 0.
``w`` (M, N) instead weighs each row of ``X`` per machine (the generic
fleet API's row weights; rows of weight 0 are skipped, so a 0/1 ``w``
gives the bits of the same ``counts``).

A call runs the epochs of the permutations it is given.  With ``state``
(:class:`FitState`: the Adam moments in the kernel's parameter layout and
the steps taken, per machine and fit) it continues a fit where an earlier
call stopped, and with ``return_state`` it returns the final state: a fit
run as chunks of epochs, each from the previous chunk's params and state,
is the single call bit for bit (params per fit: ``params0`` leaves
``(D, G, ...)``).

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
from gordo_tpu_torch.kernels.scaler_stats import Prefix, ScalerChain, apply_steps, check_steps
from gordo_tpu_torch.train.fit import AdamState, batch_geometry, fit_plain

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
        ("chain", ScalerChain),
        ("perms", ctypes.c_void_p),
        ("draw", ctypes.c_void_p),
        ("perm_draw", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("wrow", ctypes.c_void_p),
        ("mu0", ctypes.c_void_p),
        ("nu0", ctypes.c_void_p),
        ("count0", ctypes.c_void_p),
        ("w0", ctypes.c_void_p * MAX_LAYERS),
        ("b0", ctypes.c_void_p * MAX_LAYERS),
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
        ("history", ctypes.c_void_p),
        ("mu", ctypes.c_void_p),
        ("nu", ctypes.c_void_p),
        ("count", ctypes.c_void_p),
        ("params_per_fit", ctypes.c_int),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("g", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("epochs", ctypes.c_int),
        ("perm_len", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("act", ctypes.c_int * MAX_LAYERS),
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
        ("fit_order", ctypes.c_int * MAX_FITS),
        ("warp_partials", ctypes.c_int),
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


class FitState(NamedTuple):
    """Adam's state of every (machine, fit) of a :func:`fleet_fit` call:
    ``mu``, ``nu`` (M, G, P) float32 in the kernel's parameter layout
    (each machine's ``W0, b0, W1, b1, ...`` flattened, :func:`flat_params`)
    and ``count`` (M, G) int32, the Adam steps taken."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor


def n_params(dims: Sequence[int]) -> int:
    return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))


def flat_params(leaves: Sequence[torch.Tensor], lead: int) -> torch.Tensor:
    """Leaves ``W0, b0, W1, ...`` with ``lead`` leading axes, flattened
    into the kernel's parameter layout (..., P)."""
    return torch.cat([t.reshape(*t.shape[:lead], -1) for t in leaves], dim=-1)


def split_params(flat: torch.Tensor, dims: Sequence[int]) -> List[torch.Tensor]:
    """Inverse of :func:`flat_params`: views ``W0 (..., in, out), b0 (...,
    out), ...`` of ``flat`` (..., P)."""
    out, off = [], 0
    lead = tuple(flat.shape[:-1])
    for a, b in zip(dims[:-1], dims[1:]):
        out.append(flat[..., off: off + a * b].reshape(*lead, a, b))
        out.append(flat[..., off + a * b: off + a * b + b])
        off += a * b + b
    return out


class LaunchPlan(NamedTuple):
    threads: int
    row_stride: int
    smem_bytes: int
    warp_partials: bool


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def launch_plan(dims: Sequence[int], max_bs: int) -> LaunchPlan:
    """Block size and shared memory for widths ``dims`` and minibatches of
    up to ``max_bs`` rows.  Takes the widths it has always taken: one
    machine's weights, Adam moments and a minibatch's rows of activations
    and deltas at a thread a row (an odd stride) within a block; raises
    ``NotImplementedError`` (wide fleet fit) otherwise.  The kernel keeps
    each feature's column of the minibatch (``row_stride`` floats, a
    multiple of 4, padded to 4 more than a multiple of 32 where that
    fits), every layer's input and two layers' deltas and each warp's
    partial sums of every parameter (``warp_partials``), or, where those
    do not fit, every layer's deltas: never more than the rule allows."""
    P = n_params(dims)
    threads = -(-max_bs // 32) * 32
    per_row = sum(dims[:-1]) + sum(dims[1:])
    smem = 4 * (3 * P + 3 * 32 + threads * (per_row | 1))
    if threads > MAX_THREADS or smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"fleet_fit cannot take widths {list(dims)} with {max_bs}-row batches: "
            f"{P} params, their Adam moments and the batch's rows need "
            f"{smem} bytes of shared memory and {threads} threads, over a "
            f"block's {SMEM_LIMIT} and {MAX_THREADS}; that waits for {WIDE_ITEM}"
        )
    widest = max(dims[1::2], default=0) + max(dims[2::2], default=0)
    rows = _round4(max_bs)
    # columns 4 floats more than a multiple of 32 start on different banks,
    # so the lanes of a warp reading rows r..r+3 of neighbouring features
    # (the weight gradients, a layer's outputs) do not queue on one bank
    for partials in (True, False):
        columns = sum(dims[:-1]) + (widest if partials else sum(dims[1:]))
        for stride in (rows + (4 - rows) % 32, rows):
            floats = 3 * P + 3 * 32 + stride * columns + (threads // 32 * P if partials else 0)
            if 4 * floats <= SMEM_LIMIT:
                return LaunchPlan(threads, stride, 4 * floats, partials)
    raise AssertionError("unreachable: every layer's deltas at a row stride of the rows fit")


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _draw_index(draw, M: int, D: int, name: str) -> np.ndarray:
    draw = np.asarray(draw, dtype=np.int64)
    if draw.shape != (M,) or (M and (draw.min() < 0 or draw.max() >= D)):
        raise ValueError(f"{name} must be (M,) = ({M},) ints in [0, {D})")
    return draw


def _validate(X, y, fits, steps, params0, perms, draw, acts, epochs, perm_draw=None,
              counts=None, w=None, state=None):
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
    # params per (draw, fit): a resumed fit's, (D, G, in, out)
    per_fit = params0[0][0].dim() == 4
    lead = (D, G) if per_fit else (D,)
    dims = [F]
    for i, (W, b) in enumerate(params0):
        _check(W, f"params0 layer {i} kernel", lead + (dims[-1], W.shape[-1]), torch.float32, X.device)
        _check(b, f"params0 layer {i} bias", lead + (W.shape[-1],), torch.float32, X.device)
        dims.append(int(W.shape[-1]))
    if dims[-1] != y.shape[2]:
        raise ValueError(f"the last layer has {dims[-1]} outputs, y {y.shape[2]} columns")
    for name, t in (("X", X), ("y", y)):
        _check(t, name, t.shape, torch.float32, X.device)
    check_steps(steps, (M, G, F), X.device, (torch.float32,), "pipeline scaler")
    perm_len = sum(epochs * fg.n_total for fg in fits)
    if perms.dim() != 2 or int(perms.shape[1]) != perm_len:
        raise ValueError(f"perms must be (D, {perm_len}), got {tuple(perms.shape)}")
    _check(perms, "perms", tuple(perms.shape), torch.int32, X.device)
    draw = _draw_index(draw, M, D, "draw")
    perm_draw = draw if perm_draw is None else _draw_index(perm_draw, M, int(perms.shape[0]), "perm_draw")
    for fg in fits:
        if fg.n < 1 or fg.rows.min() < 0 or fg.rows.max() >= N:
            raise ValueError(f"a fit's rows must be non-empty and lie in [0, {N})")
    limit = np.array([fg.n for fg in fits])
    counts = np.tile(limit, (M, 1)) if counts is None else np.asarray(counts, dtype=np.int64)
    if counts.shape != (M, G) or counts.min() < 0 or (counts > limit).any():
        raise ValueError(f"counts must be (M, G) = ({M}, {G}) ints in [0, each fit's rows]")
    if w is not None:
        _check(w, "w", (M, N), torch.float32, X.device)
    if state is not None:
        P = n_params(dims)
        _check(state.mu, "state.mu", (M, G, P), torch.float32, X.device)
        _check(state.nu, "state.nu", (M, G, P), torch.float32, X.device)
        _check(state.count, "state.count", (M, G), torch.int32, X.device)
    return M, N, F, G, D, dims, draw, perm_draw, counts


def fleet_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    fits: Sequence[FitGeometry],
    params0: Layers,
    perms: torch.Tensor,
    draw,
    acts: Sequence[Optional[str]],
    epochs: int,
    hp,
    perm_draw=None,
    counts=None,
    w: Optional[torch.Tensor] = None,
    state: Optional[FitState] = None,
    return_state: bool = False,
    chain: Optional[Prefix] = None,
):
    """Train ``len(fits)`` fits of each machine.

    ``X`` (M, N, F), ``y`` (M, N, Fo) raw rows; ``fits`` each fit's rows
    and geometry (:func:`geometry`); ``chain`` the pipeline's scaler steps
    ``[(form, a (M, G, F), b (M, G, F)), ...]``, each fit's stats, applied
    to each row as it loads (``scaler_stats.AFFINE`` or ``CENTER`` each;
    none: the raw rows); ``params0`` ``[(W (D, in, out), b (D, out)), ...]`` (or
    ``(D, G, in, out)``, ``(D, G, out)``: params per fit) and
    ``perms`` (D, perm_len) int32 (:func:`pack_perms`) the draws, of which
    machine ``i`` uses ``draw[i]`` (of the permutations ``perm_draw[i]``,
    default ``draw[i]``); ``acts`` one activation per layer; ``epochs`` the
    epochs of ``perms``; ``hp`` the
    Adam hyperparameters (``train.fit.adam_hparams``); ``counts`` (M, G)
    host ints, each machine's real rows of each fit (default every row);
    ``w`` (M, N) float32, each machine's weight of each row of ``X``
    (default: 1 below ``counts``, 0 after); ``state`` the Adam state to
    start from (default zero moments, count 0).

    Returns ``([(W (M, G, in, out), b (M, G, out)), ...], history (M, G,
    epochs))``, and the final :class:`FitState` third with
    ``return_state``."""
    steps = list(chain or ())
    if X.device.type == "cpu":
        return fleet_fit_plain(
            X, y, fits, params0, perms, draw, acts, epochs, hp, perm_draw, counts,
            w, state, return_state, chain=steps,
        )
    if X.device.type != "cuda":
        raise ValueError(f"fleet_fit runs on cuda or cpu tensors, got {X.device}")
    M, N, F, G, D, dims, draw, perm_draw, counts = _validate(
        X, y, fits, steps, params0, perms, draw, acts, epochs, perm_draw, counts, w, state
    )
    device = X.device
    P = n_params(dims)
    plan = launch_plan(dims, max(fg.bs for fg in fits))
    rows = to_device(np.concatenate([fg.rows for fg in fits]).astype(np.int32), device)
    draw_dev = to_device(draw.astype(np.int32), device)
    perm_draw_dev = draw_dev if perm_draw is draw else to_device(perm_draw.astype(np.int32), device)
    counts_dev = to_device(counts.astype(np.int32), device)
    out = [
        (torch.empty((M, G, dims[i], dims[i + 1]), dtype=torch.float32, device=device),
         torch.empty((M, G, dims[i + 1]), dtype=torch.float32, device=device))
        for i in range(len(dims) - 1)
    ]
    history = torch.empty((M, G, epochs), dtype=torch.float32, device=device)
    final = None
    if return_state:
        final = FitState(
            torch.empty((M, G, P), dtype=torch.float32, device=device),
            torch.empty((M, G, P), dtype=torch.float32, device=device),
            torch.empty((M, G), dtype=torch.int32, device=device),
        )

    args = _Args()
    args.x, args.y, args.rows = X.data_ptr(), y.data_ptr(), rows.data_ptr()
    args.chain.fill(steps)
    args.perms, args.draw = perms.data_ptr(), draw_dev.data_ptr()
    args.perm_draw = perm_draw_dev.data_ptr()
    args.counts = counts_dev.data_ptr()
    args.wrow = None if w is None else w.data_ptr()
    if state is not None:
        args.mu0, args.nu0 = state.mu.data_ptr(), state.nu.data_ptr()
        args.count0 = state.count.data_ptr()
    for i, ((W0, b0), (W, b)) in enumerate(zip(params0, out)):
        args.w0[i], args.b0[i] = W0.data_ptr(), b0.data_ptr()
        args.w[i], args.b[i] = W.data_ptr(), b.data_ptr()
    args.history = history.data_ptr()
    if final is not None:
        args.mu, args.nu, args.count = (t.data_ptr() for t in final)
    args.params_per_fit = int(params0[0][0].dim() == 4)
    args.m, args.n, args.g, args.n_layers = M, N, G, len(params0)
    args.epochs, args.perm_len = epochs, int(perms.shape[1])
    for i, d in enumerate(dims):
        args.dims[i] = d
    for i, a in enumerate(acts):
        args.act[i] = ACT_CODES[a]
    row_off = perm_off = 0
    for i, fg in enumerate(fits):
        args.fit_bs[i], args.fit_steps[i] = fg.bs, fg.steps
        args.fit_row_off[i], args.fit_perm_off[i] = row_off, perm_off
        row_off += fg.n
        perm_off += epochs * fg.n_total
    # the fits with the most steps first, so the last blocks to start are short
    for i, g in enumerate(sorted(range(G), key=lambda g: -fits[g].steps)):
        args.fit_order[i] = g
    args.warp_partials = int(plan.warp_partials)
    args.lr, args.b1, args.b2, args.eps = hp["lr"], hp["b1"], hp["b2"], hp["eps"]
    args.one_b1, args.one_b2 = 1 - hp["b1"], 1 - hp["b2"]
    args.n_params = P
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
    return (out, history, final) if return_state else (out, history)


def fleet_fit_plain(
    X: torch.Tensor,
    y: torch.Tensor,
    fits: Sequence[FitGeometry],
    params0: Layers,
    perms: torch.Tensor,
    draw,
    acts: Sequence[Optional[str]],
    epochs: int,
    hp,
    perm_draw=None,
    counts=None,
    w: Optional[torch.Tensor] = None,
    state: Optional[FitState] = None,
    return_state: bool = False,
    chain: Optional[Prefix] = None,
):
    """:func:`fleet_fit` in plain PyTorch: each fit's rows gathered, scaled,
    padded to ``steps * bs`` and fitted step for step as ``make_fit_fn``
    (``make_stateful_fit_fn`` from ``state``), each row weighted by ``w``,
    or each machine's rows from its count on weighted 0."""
    steps = list(chain or ())
    M, N, F, G, D, dims, draw, perm_draw, counts = _validate(
        X, y, fits, steps, params0, perms, draw, acts, epochs, perm_draw, counts, w, state
    )
    take = torch.as_tensor(draw, device=X.device)
    take_perm = torch.as_tensor(perm_draw, device=X.device)
    per_fit = params0[0][0].dim() == 4
    start = [(W.index_select(0, take), b.index_select(0, take)) for W, b in params0]
    count0 = None if state is None else state.count.cpu().numpy().astype(np.int64)
    outs, hists, states = [], [], []
    for g, (fg, perm) in enumerate(zip(fits, unpack_perms(perms, fits, epochs))):
        rows = torch.as_tensor(fg.rows, device=X.device)
        pad = fg.n_total - fg.n
        xg = apply_steps(X.index_select(1, rows), steps, lambda t: t[:, g, None, :])
        yg = y.index_select(1, rows)
        xg = torch.cat([xg, xg.new_zeros((M, pad, F))], dim=1)
        yg = torch.cat([yg, yg.new_zeros((M, pad, yg.shape[2]))], dim=1)
        if w is None:
            real = torch.as_tensor(counts[:, g], device=X.device)
            wg = (torch.arange(fg.n_total, device=X.device)[None] < real[:, None]).float()
        else:
            wg = torch.cat([w.index_select(1, rows), w.new_zeros((M, pad))], dim=1)
        layers0 = [(W[:, g], b[:, g]) for W, b in start] if per_fit else start
        adam0 = None
        if state is not None:
            adam0 = AdamState(split_params(state.mu[:, g], dims), split_params(state.nu[:, g], dims),
                              count0[:, g])
        layers, hist, adam = fit_plain(
            layers0, acts, xg, yg, wg, perm.index_select(0, take_perm), hp, fg.steps, fg.bs, adam0
        )
        outs.append(layers)
        hists.append(hist)
        states.append(adam)
    stacked = [
        (torch.stack([o[i][0] for o in outs], dim=1), torch.stack([o[i][1] for o in outs], dim=1))
        for i in range(len(params0))
    ]
    history = torch.stack(hists, dim=1)
    if not return_state:
        return stacked, history
    final = FitState(
        torch.stack([flat_params(a.mu, 1) for a in states], dim=1),
        torch.stack([flat_params(a.nu, 1) for a in states], dim=1),
        torch.from_numpy(np.stack([a.count for a in states], axis=1).astype(np.int32)).to(X.device),
    )
    return stacked, history, final
