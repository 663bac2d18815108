"""``lstm_layer_bwd``: the backward of one LSTM layer over one minibatch of
every slot of a fleet build's lockstep fit.

Replaces the VJP of ``_fused_lstm_layer``
(``gordo_tpu/models/factories/lstm.py:92``) and of the activation after it
inside ``jax.value_and_grad`` (``gordo_tpu/train/fit.py:164``): from the
gates and ``c`` that :func:`gordo_tpu_torch.kernels.lstm_layer.
lstm_layer_train` saved and the gradient of the layer's output, it gives
the gradient of its input (``dx``, not for the first layer) and of its
``kernel_i``, ``kernel_h`` and ``bias``, summed over each slot's real
windows.  The kernel is CUDA C++ for ``sm_90a``
(``gordo_tpu_torch/csrc/lstm_layer_bwd.cu``, whose header gives its bound
and design: a call runs the serial recurrence, then the weight gradients
and ``dx`` as products over all of a slot's rows);
:func:`lstm_layer_bwd_plain` is the same function in plain
PyTorch (autograd through :func:`~gordo_tpu_torch.kernels.lstm_layer.
lstm_layer_train_plain`).

:func:`lstm_layer_bwd` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel (its three parts, in order
on the current stream) or raises, and adds one to :data:`launches` per
call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_score import SMEM_LIMIT, _check, _ptr
from gordo_tpu_torch.kernels.scaler_stats import Prefix, ScalerChain, check_steps
from gordo_tpu_torch.kernels.lstm_layer import (
    MAX_SLOTS,
    Minibatch,
    MIN_BLOCKS,
    _check_batch,
    _groups,
    _pad,
    lstm_layer_train_plain,
)

SOURCE = "gordo_tpu_torch/csrc/lstm_layer_bwd.cu"
REPLACES = "gordo_tpu/models/factories/lstm.py:92"

#: threads a block may have (LB_THREADS in the source)
MAX_THREADS = 512
#: rows the weight gradients stage at a time, in two buffers (LB_ROWS; a
#: block of them takes as many 4 x 8 tiles of gate columns as MAX_THREADS
#: allow: measured on the H100, fewer threads and more blocks a slot were
#: slower); rows dx stages at a time, in two buffers, and blocks a slot's
#: rows are shared among for dx
GRAD_ROWS, DX_ROWS, DX_BLOCKS = 32, 32, 4
#: windows a thread of the recurrence owns (LB_WPT), and thread groups its
#: block takes at most (and, as the forward's, at least MIN_BLOCKS blocks
#: where the slots allow it)
WINDOWS_PER_THREAD, RECUR_GROUPS = 4, 4
#: activation codes the backward differentiates
ACT_CODES = {None: 0, "linear": 0, "tanh": 1}
WIDE_ITEM = "ROADMAP queue 1 item 14 (wide LSTM layers)"
ACT_ITEM = "ROADMAP queue 1 item 2 (training: activations other than tanh/linear)"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()

Grads = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]


class _Args(ctypes.Structure):
    """Mirror of ``struct LstmLayerBwdArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("scalers", ScalerChain),
        ("win", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("row_off", ctypes.c_void_p),
        ("x_mach", ctypes.c_void_p),
        ("n_windows", ctypes.c_void_p),
        ("w_i", ctypes.c_void_p),
        ("w_h", ctypes.c_void_p),
        ("gates", ctypes.c_void_p),
        ("cell", ctypes.c_void_p),
        ("dout", ctypes.c_void_p),
        ("dz", ctypes.c_void_p),
        ("hs", ctypes.c_void_p),
        ("dx", ctypes.c_void_p),
        ("dw_i", ctypes.c_void_p),
        ("dw_h", ctypes.c_void_p),
        ("dbias", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("nw", ctypes.c_int),
        ("lookback", ctypes.c_int),
        ("in_", ctypes.c_int),
        ("hidden", ctypes.c_int),
        ("rows_input", ctypes.c_int),
        ("last", ctypes.c_int),
        ("act", ctypes.c_int),
        ("groups", ctypes.c_int),
        ("w_pad", ctypes.c_int),
        ("k_pad", ctypes.c_int),
        ("grad_cols", ctypes.c_int),
        ("dx_rows", ctypes.c_int),
        ("dx_blocks", ctypes.c_int),
        ("recur_smem", ctypes.c_int),
        ("wgrad_smem", ctypes.c_int),
        ("dx_smem", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("lstm_layer_bwd")
            lib.lstm_layer_bwd_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.lstm_layer_bwd_launch.restype = ctypes.c_int
            lib.lstm_layer_bwd_error_string.argtypes = [ctypes.c_int]
            lib.lstm_layer_bwd_error_string.restype = ctypes.c_char_p
            lib.lstm_layer_bwd_args_size.argtypes = []
            lib.lstm_layer_bwd_args_size.restype = ctypes.c_int
            if lib.lstm_layer_bwd_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "lstm_layer_bwd: LstmLayerBwdArgs is "
                    f"{lib.lstm_layer_bwd_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


class LaunchPlan(NamedTuple):
    groups: int        # the recurrence: thread groups of ``hidden`` threads a block
    w_pad: int         # row stride of W_h (the recurrence) and W_i (dx) in shared memory
    k_pad: int         # row stride of the weight gradients' staged [x | h | 1] rows
    grad_cols: int     # gate columns a block of the weight gradients sums
    dx_rows: int       # rows a block of dx stages at a time (0: no dx)
    recur_smem: int
    wgrad_smem: int
    dx_smem: int


def _refuse(n_in: int, hidden: int, what: str):
    return NotImplementedError(
        f"lstm_layer_bwd cannot take a {n_in} -> {hidden} layer: {what}; that waits for {WIDE_ITEM}"
    )


def launch_plan(n_in: int, hidden: int, windows: int, want_dx: bool, slots: int = 1) -> LaunchPlan:
    """The three kernels' shapes for ``slots`` slots of ``windows``
    windows: the recurrence's thread groups (WINDOWS_PER_THREAD windows a
    thread; up to RECUR_GROUPS, as many as keep MIN_BLOCKS blocks, fewer
    while shared memory is short), the gate columns a block of the
    weight gradients sums, the rows a block of ``dx`` stages, and each
    kernel's shared memory.  Raises ``NotImplementedError`` (wide
    LSTM layers) for widths the blocks do not take."""
    if hidden > MAX_THREADS:
        raise NotImplementedError(
            f"lstm_layer_bwd takes at most {MAX_THREADS} units, got {hidden}; "
            f"that waits for {WIDE_ITEM}"
        )
    h4 = 4 * hidden
    # the widths the first design took, whose block held W_h (and W_i for
    # dx) and the gradients in shared memory: past them wide layers wait
    # for item 14, as in the forward (lstm_layer.wide_layer)
    first = hidden * (h4 | 1) + (n_in * (h4 | 1) if want_dx else 0) + (n_in + hidden + 1) * h4
    if 4 * (first + h4 + n_in + 2 * hidden) > SMEM_LIMIT:
        raise _refuse(n_in, hidden, "its weights and their gradients take more shared memory than "
                                    f"the {SMEM_LIMIT} bytes of a block of the widths the port trains")
    ws = _pad(h4)
    groups = _groups(-(-windows // WINDOWS_PER_THREAD), slots, min(RECUR_GROUPS, MAX_THREADS // hidden))
    # W_h's rows, the step's dz twice
    recur = lambda g: 4 * (hidden * ws + 2 * g * WINDOWS_PER_THREAD * h4)  # noqa: E731
    while recur(groups) > SMEM_LIMIT and groups > 1:
        groups -= 1
    if recur(groups) > SMEM_LIMIT:
        raise _refuse(n_in, hidden, f"W_h needs {4 * hidden * ws} bytes of shared memory and a block "
                                    f"has {SMEM_LIMIT}")
    k = n_in + hidden + 1
    k_pad = -(-k // 4) * 4
    col_tiles = min(-(-h4 // 8), MAX_THREADS // (k_pad // 4))
    if col_tiles < 1:
        raise _refuse(n_in, hidden, f"its weight gradients need {k_pad // 4} threads for 8 gate columns "
                                    f"and a block has {MAX_THREADS}")
    grad_cols = 8 * col_tiles
    wgrad = 4 * 2 * GRAD_ROWS * (k_pad + grad_cols)
    dx_rows, dx_smem = 0, 0
    if want_dx:
        dx_rows = DX_ROWS
        while 4 * (n_in + 2 * dx_rows) * ws > SMEM_LIMIT and dx_rows > 4:
            dx_rows //= 2
        dx_smem = 4 * (n_in + 2 * dx_rows) * ws
        if dx_smem > SMEM_LIMIT:
            raise _refuse(n_in, hidden, f"W_i needs {4 * n_in * ws} bytes of shared memory and a "
                                        f"block has {SMEM_LIMIT}")
    return LaunchPlan(groups, ws, k_pad, grad_cols, dx_rows, recur(groups), wgrad, dx_smem)


def lstm_layer_bwd(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    gates: torch.Tensor,
    cell: torch.Tensor,
    dout: torch.Tensor,
    *,
    lookback: int,
    batch: Minibatch,
    act: Optional[str] = None,
    chain: Optional[Prefix] = None,
    last: bool = False,
    want_dx: bool = True,
) -> Grads:
    """Gradients of one training-mode ``lstm_layer`` call.

    ``x``, the weights, ``batch``, ``act``, the scaler steps and
    ``last`` as that call had them; ``gates``/``cell`` what it saved;
    ``dout`` the gradient of its output ((m, B, H) when ``last``, else
    (m, B, lookback, H)), read for each slot's real windows only.  Returns
    ``(dx (m, B, lookback, in) or None, dkernel_i (m, in, 4H), dkernel_h
    (m, H, 4H), dbias (m, 4H))``, the weight gradients summed over each
    slot's real windows; ``dx`` is None for the first layer's rows or
    without ``want_dx``, and unspecified past a slot's real windows."""
    steps = list(chain or ())
    if x.device.type == "cpu":
        return lstm_layer_bwd_plain(
            x, kernel_i, kernel_h, bias, dout, lookback=lookback, batch=batch, act=act,
            chain=steps, last=last, want_dx=want_dx,
        )
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer_bwd runs on cuda or cpu tensors, got {x.device}")
    if act not in ACT_CODES:
        raise NotImplementedError(f"activation {act!r} in an LSTM fit waits for {ACT_ITEM}")
    device = x.device
    m, B = (int(s) for s in batch.win.shape)
    rows_input = x.dim() == 3
    want_dx = want_dx and not rows_input
    n_in = int(x.shape[-1])
    H = int(kernel_h.shape[1])
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"need 1..{MAX_SLOTS} slots, got {m}")
    _check(x, "x", tuple(x.shape) if rows_input else (m, B, lookback, n_in), device)
    _check(kernel_i, "kernel_i", (m, n_in, 4 * H), device)
    _check(kernel_h, "kernel_h", (m, H, 4 * H), device)
    _check(bias, "bias", (m, 4 * H), device)
    _check(gates, "gates", (m, B, lookback, 4 * H), device)
    _check(cell, "cell", (m, B, lookback, H), device)
    _check(dout, "dout", (m, B, H) if last else (m, B, lookback, H), device)
    if steps and not rows_input:
        raise ValueError("the pipeline scaler applies to the first layer's rows only")
    check_steps(steps, (m, n_in), device, (torch.float32,), "pipeline scaler")
    _check_batch(batch, m, device)

    plan = launch_plan(n_in, H, B, want_dx, m)
    dz = torch.empty((m, B, lookback, 4 * H), dtype=torch.float32, device=device)
    hs = torch.empty((m, B, lookback, H), dtype=torch.float32, device=device)
    dx = torch.empty((m, B, lookback, n_in), dtype=torch.float32, device=device) if want_dx else None
    dki = torch.empty((m, n_in, 4 * H), dtype=torch.float32, device=device)
    dkh = torch.empty((m, H, 4 * H), dtype=torch.float32, device=device)
    db = torch.empty((m, 4 * H), dtype=torch.float32, device=device)
    args = _Args()
    args.x = _ptr(x)
    args.scalers.fill(steps)
    args.win, args.rows, args.row_off = _ptr(batch.win), _ptr(batch.rows), _ptr(batch.row_off)
    args.x_mach, args.n_windows = _ptr(batch.x_mach), _ptr(batch.n_windows)
    args.w_i, args.w_h = _ptr(kernel_i), _ptr(kernel_h)
    args.gates, args.cell, args.dout, args.dz = _ptr(gates), _ptr(cell), _ptr(dout), _ptr(dz)
    args.hs = _ptr(hs)
    args.dx, args.dw_i, args.dw_h, args.dbias = _ptr(dx), _ptr(dki), _ptr(dkh), _ptr(db)
    args.m, args.n, args.nw, args.lookback = m, int(x.shape[1]), B, lookback
    args.in_, args.hidden = n_in, H
    args.rows_input, args.last, args.act = int(rows_input), int(last), ACT_CODES[act]
    args.groups, args.w_pad, args.k_pad, args.grad_cols = plan.groups, plan.w_pad, plan.k_pad, plan.grad_cols
    args.dx_rows, args.dx_blocks = plan.dx_rows, DX_BLOCKS
    args.recur_smem, args.wgrad_smem, args.dx_smem = plan.recur_smem, plan.wgrad_smem, plan.dx_smem

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lstm_layer_bwd_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lstm_layer_bwd launch failed: {lib.lstm_layer_bwd_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return dx, dki, dkh, db


def lstm_layer_bwd_plain(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    dout: torch.Tensor,
    *,
    lookback: int,
    batch: Minibatch,
    act: Optional[str] = None,
    chain: Optional[Prefix] = None,
    last: bool = False,
    want_dx: bool = True,
) -> Grads:
    """:func:`lstm_layer_bwd` in plain PyTorch: autograd through
    :func:`lstm_layer_train_plain` (recomputed), with ``dout`` zero past
    each slot's real windows."""
    want_dx = want_dx and x.dim() == 4
    mask = batch.weights() > 0
    mask = mask[:, :, None] if last else mask[:, :, None, None]
    dout = torch.where(mask, dout, torch.zeros((), dtype=dout.dtype, device=dout.device))
    with torch.enable_grad():
        xin = x.detach().requires_grad_(want_dx)
        weights = [t.detach().requires_grad_(True) for t in (kernel_i, kernel_h, bias)]
        out, _, _ = lstm_layer_train_plain(
            xin, *weights, lookback=lookback, batch=batch, act=act, chain=chain, last=last,
        )
        inputs = ([xin] if want_dx else []) + weights
        grads = torch.autograd.grad(out, inputs, grad_outputs=dout)
    if want_dx:
        return grads[0], grads[1], grads[2], grads[3]
    return None, grads[0], grads[1], grads[2]
