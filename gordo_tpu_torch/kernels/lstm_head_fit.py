"""``lstm_head_fit``: an LSTM detector's ``out`` head, its weighted mse and
their gradient, over one minibatch of every slot of a fleet build's
lockstep fit (K1's LSTM head).

Replaces, inside ``jax.value_and_grad`` of ``make_loss_fn``
(``gordo_tpu/train/fit.py:119``), the head of ``LSTMAutoEncoderModule``
(``gordo_tpu/models/factories/lstm.py:173``: a Dense on the last layer's
last step, then ``out_func``) and the mse weighted so that padding
windows count 0.  The kernel is CUDA C++ for ``sm_90a``
(``gordo_tpu_torch/csrc/lstm_head_fit.cu``, whose header gives its bound
and design); :func:`lstm_head_fit_plain` is the same function in plain
PyTorch (:func:`head_loss_plain` and autograd).

:func:`lstm_head_fit` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_score import SMEM_LIMIT, _check, _ptr
from gordo_tpu_torch.kernels.lstm_layer import MAX_SLOTS, Minibatch, _check_batch
from gordo_tpu_torch.kernels.lstm_layer_bwd import ACT_CODES, ACT_ITEM
from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS
from gordo_tpu_torch.train.fit import mse_loss

SOURCE = "gordo_tpu_torch/csrc/lstm_head_fit.cu"
REPLACES = "gordo_tpu/train/fit.py:119"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class _Args(ctypes.Structure):
    """Mirror of ``struct LstmHeadFitArgs`` in the CUDA source."""

    _fields_ = [
        ("h", ctypes.c_void_p),
        ("w", ctypes.c_void_p),
        ("b", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("win", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("row_off", ctypes.c_void_p),
        ("x_mach", ctypes.c_void_p),
        ("n_windows", ctypes.c_void_p),
        ("loss", ctypes.c_void_p),
        ("dw", ctypes.c_void_p),
        ("db", ctypes.c_void_p),
        ("dh", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("nw", ctypes.c_int),
        ("hidden", ctypes.c_int),
        ("fo", ctypes.c_int),
        ("shift", ctypes.c_int),
        ("act", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("lstm_head_fit")
            lib.lstm_head_fit_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.lstm_head_fit_launch.restype = ctypes.c_int
            lib.lstm_head_fit_error_string.argtypes = [ctypes.c_int]
            lib.lstm_head_fit_error_string.restype = ctypes.c_char_p
            lib.lstm_head_fit_args_size.argtypes = []
            lib.lstm_head_fit_args_size.restype = ctypes.c_int
            if lib.lstm_head_fit_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "lstm_head_fit: LstmHeadFitArgs is "
                    f"{lib.lstm_head_fit_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


class Plan(NamedTuple):
    """A launch, one block a slot: ``smem_bytes`` a block, its rows read
    ``vec`` floats at a time (4: padded to 16 bytes; 1: the first design's
    layout, taken where the padded one does not fit)."""

    smem_bytes: int
    vec: int


def smem_bytes(hidden: int, fo: int, windows: int) -> int:
    """Shared memory of one block in the first design's layout: W (odd row
    stride), the windows' h, their dpred and squared errors, and one loss
    per window.  Raises ``NotImplementedError`` when it exceeds a block's:
    the heads and batches the kernel takes."""
    smem = 4 * (hidden * (fo | 1) + windows * (hidden + 2 * fo + 1))
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"lstm_head_fit cannot take a {hidden} -> {fo} head over {windows}-window "
            f"batches: it needs {smem} bytes of shared memory and a block has "
            f"{SMEM_LIMIT}; that waits for ROADMAP queue 1 item 14 (wide LSTM layers)"
        )
    return smem


def launch_plan(hidden: int, fo: int, windows: int) -> Plan:
    """The launch for heads of ``hidden`` -> ``fo`` over
    ``windows``-window minibatches: rows padded to 16 bytes (W's and
    dpred's to a multiple of 4 outputs, h's of 4 units) where they fit a
    block, else the first design's layout."""
    compact = smem_bytes(hidden, fo, windows)
    r4 = lambda x: -(-x // 4) * 4  # noqa: E731
    padded = 4 * (hidden * r4(fo) + windows * (r4(hidden) + r4(fo) + fo + 1))
    if padded <= SMEM_LIMIT:
        return Plan(padded, 4)
    return Plan(compact, 1)


def lstm_head_fit(
    h: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor,
    y: torch.Tensor,
    *,
    batch: Minibatch,
    shift: int,
    act: Optional[str] = None,
) -> Result:
    """The head's loss and gradients for each slot's minibatch.

    ``h`` (m, B, H): the last layer's last step of each window; ``W`` (m,
    H, Fo), ``b`` (m, Fo): each slot's head; ``y`` (M, n, Fo) raw targets,
    window ``w``'s target the row ``shift`` after its first (``lookback -
    1`` for an autoencoder, ``lookback`` for a forecast).  Returns
    ``(loss (m,), dW (m, H, Fo), db (m, Fo), dh (m, B, H))``: each slot's
    weighted mse over its real windows (0 without any) and its gradient;
    ``dh`` is unspecified past a slot's real windows."""
    if h.device.type == "cpu":
        return lstm_head_fit_plain(h, W, b, y, batch=batch, shift=shift, act=act)
    if h.device.type != "cuda":
        raise ValueError(f"lstm_head_fit runs on cuda or cpu tensors, got {h.device}")
    if act not in ACT_CODES:
        raise NotImplementedError(f"out_func {act!r} in an LSTM fit waits for {ACT_ITEM}")
    device = h.device
    m, B = (int(s) for s in batch.win.shape)
    H, fo = int(W.shape[1]), int(W.shape[2])
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"need 1..{MAX_SLOTS} slots, got {m}")
    _check(h, "h", (m, B, H), device)
    _check(W, "W", (m, H, fo), device)
    _check(b, "b", (m, fo), device)
    if y.dim() != 3 or int(y.shape[2]) != fo:
        raise ValueError(f"y must be (M, n, {fo}), got {tuple(y.shape)}")
    _check(y, "y", tuple(y.shape), device)
    _check_batch(batch, m, device)

    plan = launch_plan(H, fo, B)
    loss = torch.empty((m,), dtype=torch.float32, device=device)
    dW = torch.empty((m, H, fo), dtype=torch.float32, device=device)
    db = torch.empty((m, fo), dtype=torch.float32, device=device)
    dh = torch.empty((m, B, H), dtype=torch.float32, device=device)
    args = _Args()
    args.h, args.w, args.b, args.y = _ptr(h), _ptr(W), _ptr(b), _ptr(y)
    args.win, args.rows, args.row_off = _ptr(batch.win), _ptr(batch.rows), _ptr(batch.row_off)
    args.x_mach, args.n_windows = _ptr(batch.x_mach), _ptr(batch.n_windows)
    args.loss, args.dw, args.db, args.dh = _ptr(loss), _ptr(dW), _ptr(db), _ptr(dh)
    args.m, args.n, args.nw, args.hidden, args.fo = m, int(y.shape[1]), B, H, fo
    args.shift, args.act, args.vec, args.smem_bytes = int(shift), ACT_CODES[act], plan.vec, plan.smem_bytes

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lstm_head_fit_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lstm_head_fit launch failed: {lib.lstm_head_fit_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return loss, dW, db, dh


def head_loss_plain(
    h: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor,
    y: torch.Tensor,
    *,
    batch: Minibatch,
    shift: int,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Each slot's weighted mse (m,) of the head on ``h``, differentiable:
    ``make_loss_fn``'s loss, padding windows weighted 0."""
    pred = ACTIVATIONS[act](torch.bmm(h, W) + b[:, None, :])
    target = batch.gather(y, 1, shift)[:, :, 0]
    return mse_loss(pred, target, batch.weights())


def lstm_head_fit_plain(
    h: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor,
    y: torch.Tensor,
    *,
    batch: Minibatch,
    shift: int,
    act: Optional[str] = None,
) -> Result:
    """:func:`lstm_head_fit` in plain PyTorch: :func:`head_loss_plain` and
    its gradient by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (h, W, b)]
        loss = head_loss_plain(*leaves, y, batch=batch, shift=shift, act=act)
        dh, dW, db = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), dW, db, dh
