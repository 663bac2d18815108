"""``lstm_layer``: one LSTM layer of a bucket of LSTM detectors.

Replaces ``_fused_lstm_layer`` (``gordo_tpu/models/factories/lstm.py:92``)
plus the activation the module applies after each layer, and, in the first
layer, ``make_windows`` (``gordo_tpu/ops/windows.py:18``): the kernel reads
window ``b``, step ``t`` from row ``b + t`` of the request as it loads,
with the pipeline's MinMax applied.  The kernel is CUDA C++ for ``sm_90a``
(``gordo_tpu_torch/csrc/lstm_layer.cu``, whose header gives its bound and
design); :func:`lstm_layer_plain` is the same function in plain PyTorch.

:func:`lstm_layer` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_score import (
    ACT_CODES,
    MAX_SLOTS,
    SMEM_LIMIT,
    _check,
    _ptr,
    slot_ints,
)
from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS
from gordo_tpu_torch.ops.windows import make_windows

SOURCE = "gordo_tpu_torch/csrc/lstm_layer.cu"
REPLACES = "gordo_tpu/models/factories/lstm.py:92"

#: threads a block may have, and windows each thread computes (LL_THREADS,
#: LL_WPT in the source)
MAX_THREADS = 512
WINDOWS_PER_THREAD = 4

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct LstmLayerArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("offset", ctypes.c_void_p),
        ("w_i", ctypes.c_void_p),
        ("w_h", ctypes.c_void_p),
        ("bias", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_windows", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
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
        ("in_pad", ctypes.c_int),
        ("h_pad", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("lstm_layer")
            lib.lstm_layer_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.lstm_layer_launch.restype = ctypes.c_int
            lib.lstm_layer_error_string.argtypes = [ctypes.c_int]
            lib.lstm_layer_error_string.restype = ctypes.c_char_p
            lib.lstm_layer_args_size.argtypes = []
            lib.lstm_layer_args_size.restype = ctypes.c_int
            if lib.lstm_layer_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "lstm_layer: LstmLayerArgs is "
                    f"{lib.lstm_layer_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


def _pad(width: int) -> int:
    """Row stride for ``width`` floats: a multiple of 4 whose float4 count
    is odd, so float4 reads of neighbouring rows hit distinct banks."""
    p = -(-width // 4) * 4
    return p if (p // 4) % 2 else p + 4


class LaunchPlan(NamedTuple):
    groups: int
    in_pad: int
    h_pad: int
    smem_bytes: int


def launch_plan(n_in: int, hidden: int, windows: int) -> LaunchPlan:
    """Thread groups per block (as many as ``MAX_THREADS`` allows, no more
    than the windows need, fewer while shared memory is short) and the
    shared memory they take.  Raises ``ValueError`` for widths whose
    weights do not fit a block."""
    if hidden > MAX_THREADS:
        raise ValueError(
            f"lstm_layer takes at most {MAX_THREADS} units, got {hidden}; wide "
            "LSTM layers wait for ROADMAP queue 1 item 14"
        )
    ip, hp = _pad(n_in), _pad(hidden)
    fixed = 4 * hidden * (ip + hp + 1)
    groups = max(1, min(MAX_THREADS // hidden, -(-windows // WINDOWS_PER_THREAD)))
    while True:
        smem = 4 * (fixed + 2 * groups * WINDOWS_PER_THREAD * (ip + hp))
        if smem <= SMEM_LIMIT:
            return LaunchPlan(groups, ip, hp, smem)
        if groups == 1:
            raise ValueError(
                f"lstm_layer cannot take a {n_in} -> {hidden} layer: its weights "
                f"need {4 * fixed} bytes of shared memory and a block has "
                f"{SMEM_LIMIT}; wide LSTM layers wait for ROADMAP queue 1 item 14"
            )
        groups -= 1


def _windows(x: torch.Tensor, lookback: int, n_windows: Optional[int]) -> int:
    if x.dim() == 3:
        nw = int(x.shape[1]) - lookback + 1 if n_windows is None else int(n_windows)
        if not 1 <= nw <= int(x.shape[1]) - lookback + 1:
            raise ValueError(
                f"{nw} windows of {lookback} rows do not fit {int(x.shape[1])} rows"
            )
        return nw
    if x.dim() != 4 or int(x.shape[2]) != lookback:
        raise ValueError(
            f"x must be rows (m, n, in) or windows (m, nw, {lookback}, in), "
            f"got shape {tuple(x.shape)}"
        )
    if n_windows is not None and int(n_windows) != int(x.shape[1]):
        raise ValueError(f"n_windows={n_windows} but x has {int(x.shape[1])} windows")
    return int(x.shape[1])


def lstm_layer(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    *,
    lookback: int,
    act: Optional[str] = None,
    n_windows: Optional[int] = None,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    idx=None,
    slot_windows=None,
    last: bool = False,
) -> torch.Tensor:
    """One LSTM layer over the windows of every slot, then ``act``.

    ``x``: the first layer's request rows (m, n, in), windowed as it loads
    (window ``b`` is rows ``b .. b + lookback - 1``, ``n_windows`` of them,
    default ``n - lookback + 1``; the forecast mode asks for one fewer),
    scaled by ``scale``/``offset`` (M, in) when given; or a later layer's
    input (m, nw, lookback, in).  ``kernel_i`` (M, in, 4H), ``kernel_h``
    (M, H, 4H), ``bias`` (M, 4H): flax's gate blocks i, f, g, o.  ``idx``
    (m,) host ints: the stacked machine of each slot (default slot i is
    machine i).  ``slot_windows`` (m,) host ints: valid windows of each
    slot (default all); outputs past them are unspecified.  Returns
    ``act(h)`` for every step (m, nw, lookback, H), or for the last step
    only (m, nw, H) when ``last``.
    """
    if x.device.type == "cpu":
        return lstm_layer_plain(
            x, kernel_i, kernel_h, bias, lookback=lookback, act=act,
            n_windows=n_windows, scale=scale, offset=offset, idx=idx, last=last,
        )
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer runs on cuda or cpu tensors, got {x.device}")
    device = x.device
    if act not in ACT_CODES:
        raise ValueError(f"activation {act!r} has no kernel code")
    if lookback < 1:
        raise ValueError(f"lookback must be >= 1, got {lookback}")
    rows_input = x.dim() == 3
    nw = _windows(x, lookback, n_windows)
    m, n, n_in = int(x.shape[0]), int(x.shape[1]), int(x.shape[-1])
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"x must have 1..{MAX_SLOTS} slots, got {m}")
    if kernel_i.dim() != 3 or kernel_h.dim() != 3:
        raise ValueError("kernel_i and kernel_h must be (M, in, 4H) and (M, H, 4H)")
    M, H = int(kernel_h.shape[0]), int(kernel_h.shape[1])
    _check(x, "x", tuple(x.shape), device)
    _check(kernel_i, "kernel_i", (M, n_in, 4 * H), device)
    _check(kernel_h, "kernel_h", (M, H, 4 * H), device)
    _check(bias, "bias", (M, 4 * H), device)
    if (scale is None) != (offset is None):
        raise ValueError("scale and offset come together")
    if scale is not None and not rows_input:
        raise ValueError("the pipeline scaler applies to the first layer's rows only")
    _check(scale, "scale", (M, n_in), device)
    _check(offset, "offset", (M, n_in), device)
    if idx is None:
        if m != M:
            raise ValueError(f"without idx, x needs one slot per machine ({m} != {M})")
        idx_dev = None
    else:
        idx_dev = slot_ints(idx, "idx", 0, M - 1, device)
        if idx_dev.numel() != m:
            raise ValueError(f"idx needs one entry per slot ({idx_dev.numel()} != {m})")
    if slot_windows is None:
        win_dev = None
    else:
        win_dev = slot_ints(slot_windows, "slot_windows", 1, nw, device)
        if win_dev.numel() != m:
            raise ValueError(f"slot_windows needs one entry per slot ({win_dev.numel()} != {m})")

    plan = launch_plan(n_in, H, nw)
    shape = (m, nw, H) if last else (m, nw, lookback, H)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    args = _Args()
    args.x, args.scale, args.offset = _ptr(x), _ptr(scale), _ptr(offset)
    args.w_i, args.w_h, args.bias = _ptr(kernel_i), _ptr(kernel_h), _ptr(bias)
    args.idx, args.n_windows, args.out = _ptr(idx_dev), _ptr(win_dev), _ptr(out)
    args.m, args.n, args.nw, args.lookback = m, n, nw, lookback
    args.in_, args.hidden = n_in, H
    args.rows_input, args.last, args.act = int(rows_input), int(last), ACT_CODES[act]
    args.groups, args.in_pad, args.h_pad = plan.groups, plan.in_pad, plan.h_pad
    args.smem_bytes = plan.smem_bytes

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lstm_layer_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lstm_layer launch failed: {lib.lstm_layer_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return out


def lstm_layer_plain(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    *,
    lookback: int,
    act: Optional[str] = None,
    n_windows: Optional[int] = None,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    idx=None,
    last: bool = False,
) -> torch.Tensor:
    """:func:`lstm_layer` in plain PyTorch, in ``_fused_lstm_layer``'s op
    order: the input product of every step first, then per step
    ``(h @ kernel_h + bias) + xp_t``.  Every window is computed."""
    if idx is not None:
        take = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
        kernel_i, kernel_h, bias = (t.index_select(0, take) for t in (kernel_i, kernel_h, bias))
        if scale is not None:
            scale, offset = scale.index_select(0, take), offset.index_select(0, take)
    nw = _windows(x, lookback, n_windows)
    if x.dim() == 3:
        if scale is not None:
            x = x * scale[:, None, :] + offset[:, None, :]
        x = make_windows(x, lookback)[:, :nw]
    m, _, T, n_in = x.shape
    H = int(kernel_h.shape[1])
    xp = torch.bmm(x.reshape(m, nw * T, n_in), kernel_i).reshape(m, nw, T, 4 * H)
    h = x.new_zeros((m, nw, H))
    c = x.new_zeros((m, nw, H))
    steps = []
    for t in range(T):
        z = (torch.bmm(h, kernel_h) + bias[:, None, :]) + xp[:, :, t]
        i, f, g, o = torch.split(z, H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        steps.append(h)
    out = h if last else torch.stack(steps, dim=2)
    return ACTIVATIONS[act](out)
