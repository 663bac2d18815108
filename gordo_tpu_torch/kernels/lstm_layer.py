"""``lstm_layer``: one LSTM layer of a bucket of LSTM detectors.

Replaces ``_fused_lstm_layer`` (``gordo_tpu/models/factories/lstm.py:92``)
plus the activation the module applies after each layer, and, in the first
layer, ``make_windows`` (``gordo_tpu/ops/windows.py:18``): the kernel reads
window ``b``, step ``t`` from row ``b + t`` of the request as it loads,
through the pipeline's scaler steps (``scaler_stats.ScalerChain``).  The
kernel is CUDA C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/lstm_layer.cu``,
whose header gives its bound and design); :func:`lstm_layer_plain` is the same function in plain PyTorch.

Training mode (:func:`lstm_layer_train`, plain version
:func:`lstm_layer_train_plain`) runs the layer over one :class:`Minibatch`
of windows per slot of a fleet build's lockstep fit
(``gordo_tpu_torch/train/lstm_fit.py``), the first layer reading each
window's rows by index from the fit's row list, and saves the gates and
``c`` of every step for the backward (``kernels/lstm_layer_bwd.py``).

:func:`lstm_layer` and :func:`lstm_layer_train` take the plain version
only for tensors on the CPU.  For CUDA tensors they launch the kernel or
raise, and add one per launch to :data:`launches` (serving) or
:data:`train_launches` (training mode).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

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
    storage_of,
)
from gordo_tpu_torch.kernels.scaler_stats import Prefix, ScalerChain, apply_steps, check_steps
from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS
from gordo_tpu_torch.ops.windows import make_windows

SOURCE = "gordo_tpu_torch/csrc/lstm_layer.cu"
REPLACES = "gordo_tpu/models/factories/lstm.py:92"

#: threads a block may have (LL_THREADS in the source)
MAX_THREADS = 512
#: windows each thread computes (the kernel's WPT): WIDE where a launch has
#: enough tiles to fill the card, NARROW where it has few (a streamed
#: machine's 144 windows), so that its blocks spread over more SMs
WIDE_WPT, NARROW_WPT = 8, 2
#: blocks a launch should have at least: two for each of the H100's 132 SMs
MIN_BLOCKS = 264
#: thread groups (of ``hidden`` threads) a block takes at most, sharing one
#: copy of the weights; a hoisted first layer up to HOIST_GROUPS, whose tile
#: of Tw windows computes xp of Tw + L - 1 rows, so that larger tiles
#: recompute fewer (on the H100 at the bench's widths: 6 and 12 beat 2, 4,
#: 8 and 10 groups at the later layers and at the first, PERF.md §6)
MAX_GROUPS, HOIST_GROUPS = 6, 12

#: kernel launches so far (the CPU path never counts): serving
#: (:func:`lstm_layer`) and training mode (:func:`lstm_layer_train`)
launches = 0
train_launches = 0
#: serving launches over bf16 storage (also in :data:`launches`)
bf16_launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct LstmLayerArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("scalers", ScalerChain),
        ("w_i", ctypes.c_void_p),
        ("w_h", ctypes.c_void_p),
        ("bias", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_windows", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("win", ctypes.c_void_p),
        ("rows", ctypes.c_void_p),
        ("row_off", ctypes.c_void_p),
        ("x_mach", ctypes.c_void_p),
        ("gates", ctypes.c_void_p),
        ("cell", ctypes.c_void_p),
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
        ("wpt", ctypes.c_int),
        ("hoist", ctypes.c_int),
        ("tile_pad", ctypes.c_int),
        ("rows_pad", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("bf16", ctypes.c_int),
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
    is odd, so float4 accesses of neighbouring rows hit distinct banks."""
    p = -(-width // 4) * 4
    return p if (p // 4) % 2 else p + 4


class LaunchPlan(NamedTuple):
    groups: int
    wpt: int
    hoist: bool
    tile_pad: int
    rows_pad: int
    smem_bytes: int

    @property
    def tile(self) -> int:
        """Windows a block computes."""
        return self.groups * self.wpt


def _smem_bytes(n_in: int, hidden: int, tile: int, hoist: bool, lookback: int) -> Tuple[int, int, int]:
    """(bytes, tile_pad, rows_pad) of a block: the weights and bias, h^T
    twice, and x_t^T twice or, hoisted, the tile's rows^T and their input
    products."""
    ts = _pad(tile)
    floats = 4 * hidden * (hidden + n_in + 1) + 2 * hidden * ts
    rs = 0
    if hoist:
        rs = _pad(tile + lookback - 1)
        floats += n_in * rs + rs * 4 * hidden
    else:
        floats += 2 * n_in * ts
    return 4 * floats, ts, rs


def wide_layer(n_in: int, hidden: int) -> bool:
    """Whether an ``n_in -> hidden`` layer is a wide one, which ROADMAP
    queue 1 item 14 takes (serving, training and the stream, with their
    tests): one whose padded weights and one group's tiles of the first
    design (four windows a thread) do not fit a block's shared memory.  The
    redesigned block holds somewhat wider layers; the widths the port takes
    stay those its tests cover (square layers of 83 units, the
    ``lstm_hourglass`` of 92 tags)."""
    ip, hp = _pad(n_in), _pad(hidden)
    return 4 * (4 * hidden * (ip + hp + 1) + 8 * (ip + hp)) > SMEM_LIMIT


def _groups(parts: int, slots: int, most: int) -> int:
    """Thread groups a block takes for ``parts`` groups' worth of windows
    a slot: at most ``most``, enough tiles for MIN_BLOCKS blocks where the
    slots allow it, and the tiles of a slot as even as the count allows."""
    tiles = max(-(-parts // max(most, 1)), -(-MIN_BLOCKS // slots))
    return max(1, -(-parts // min(tiles, parts)))


def launch_plan(n_in: int, hidden: int, windows: int, slots: int = 1,
                lookback: Optional[int] = None) -> LaunchPlan:
    """Windows a thread computes and thread groups a block takes, and the
    shared memory they need, for ``slots`` slots of ``windows`` windows;
    ``lookback`` given: the first layer's serving launch, whose input
    product is hoisted out of the step loop (xp of each of the tile's
    rows), where it fits.  WIDE_WPT windows a thread where the launch then
    has MIN_BLOCKS blocks, else NARROW_WPT; as many groups (up to
    MAX_GROUPS, or HOIST_GROUPS hoisted) as keep MIN_BLOCKS blocks, in even
    tiles; fewer groups, then no hoist, then NARROW_WPT while shared memory
    is short.  Raises ``ValueError`` for wide layers (:func:`wide_layer`)."""
    if hidden > MAX_THREADS:
        raise ValueError(
            f"lstm_layer takes at most {MAX_THREADS} units, got {hidden}; wide "
            "LSTM layers wait for ROADMAP queue 1 item 14"
        )
    if wide_layer(n_in, hidden):
        raise ValueError(
            f"lstm_layer does not take a {n_in} -> {hidden} layer: wide LSTM layers "
            "wait for ROADMAP queue 1 item 14"
        )
    wide = slots * -(-windows // WIDE_WPT) >= MIN_BLOCKS
    for wpt in (WIDE_WPT, NARROW_WPT) if wide else (NARROW_WPT,):
        for hoist in (True, False) if lookback else (False,):
            most = min(HOIST_GROUPS if hoist else MAX_GROUPS, MAX_THREADS // hidden)
            groups = _groups(-(-windows // wpt), slots, most)
            for g in range(groups, 0, -1):
                smem, ts, rs = _smem_bytes(n_in, hidden, g * wpt, hoist, lookback or 0)
                if smem <= SMEM_LIMIT:
                    return LaunchPlan(g, wpt, hoist, ts, rs, smem)
    need, _, _ = _smem_bytes(n_in, hidden, NARROW_WPT, False, 0)
    raise ValueError(
        f"lstm_layer cannot take a {n_in} -> {hidden} layer: its weights need "
        f"{need} bytes of shared memory and a block has {SMEM_LIMIT}; wide LSTM "
        "layers wait for ROADMAP queue 1 item 14"
    )


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
    chain: Optional[Prefix] = None,
    idx=None,
    slot_windows=None,
    last: bool = False,
) -> torch.Tensor:
    """One LSTM layer over the windows of every slot, then ``act``.

    ``x``: the first layer's request rows (m, n, in), windowed as it loads
    (window ``b`` is rows ``b .. b + lookback - 1``, ``n_windows`` of them,
    default ``n - lookback + 1``; the forecast mode asks for one fewer),
    each value through the pipeline's scaler steps ``chain`` (stats (M,
    in), ``fleet_score``'s form) when given; or a later layer's
    input (m, nw, lookback, in).  ``kernel_i`` (M, in, 4H), ``kernel_h``
    (M, H, 4H), ``bias`` (M, 4H): flax's gate blocks i, f, g, o.  ``idx``
    (m,) host ints: the stacked machine of each slot (default slot i is
    machine i).  ``slot_windows`` (m,) host ints: valid windows of each
    slot (default all); outputs past them are unspecified.  Returns
    ``act(h)`` for every step (m, nw, lookback, H), or for the last step
    only (m, nw, H) when ``last``.

    Storage: the weights, bias, the scaler stats and the first layer's
    rows are all float32 or all bfloat16 (reduced-precision serving; a
    later layer's input is the float32 output of the one before); the
    output is float32 either way.
    """
    steps = list(chain or ())
    if x.device.type == "cpu":
        return lstm_layer_plain(
            x, kernel_i, kernel_h, bias, lookback=lookback, act=act,
            n_windows=n_windows, chain=steps, idx=idx, last=last,
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
    store = storage_of(kernel_i)
    _check(x, "x", tuple(x.shape), device, store if rows_input else torch.float32)
    _check(kernel_i, "kernel_i", (M, n_in, 4 * H), device, store)
    _check(kernel_h, "kernel_h", (M, H, 4 * H), device, store)
    _check(bias, "bias", (M, 4 * H), device, store)
    if steps and not rows_input:
        raise ValueError("the pipeline scaler applies to the first layer's rows only")
    check_steps(steps, (M, n_in), device, (store,), "pipeline scaler")
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

    plan = launch_plan(n_in, H, nw, m, lookback if rows_input else None)
    shape = (m, nw, H) if last else (m, nw, lookback, H)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    args = _Args()
    args.x = _ptr(x)
    args.scalers.fill(steps)
    args.w_i, args.w_h, args.bias = _ptr(kernel_i), _ptr(kernel_h), _ptr(bias)
    args.idx, args.n_windows, args.out = _ptr(idx_dev), _ptr(win_dev), _ptr(out)
    args.m, args.n, args.nw, args.lookback = m, n, nw, lookback
    args.in_, args.hidden = n_in, H
    args.rows_input, args.last, args.act = int(rows_input), int(last), ACT_CODES[act]
    _fill_plan(args, plan)
    args.bf16 = int(store == torch.bfloat16)

    _launch(args, device)
    return out


def _fill_plan(args: _Args, plan: LaunchPlan) -> None:
    args.groups, args.wpt, args.hoist = plan.groups, plan.wpt, int(plan.hoist)
    args.tile_pad, args.rows_pad, args.smem_bytes = plan.tile_pad, plan.rows_pad, plan.smem_bytes


def _launch(args: _Args, device) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lstm_layer_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lstm_layer launch failed: {lib.lstm_layer_error_string(rc).decode()}")
    global launches, train_launches, bf16_launches
    with _launches_lock:
        if args.win:
            train_launches += 1
        else:
            launches += 1
            bf16_launches += args.bf16


def lstm_layer_plain(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    *,
    lookback: int,
    act: Optional[str] = None,
    n_windows: Optional[int] = None,
    chain: Optional[Prefix] = None,
    idx=None,
    last: bool = False,
) -> torch.Tensor:
    """:func:`lstm_layer` in plain PyTorch, in ``_fused_lstm_layer``'s op
    order: the input product of every step first, then per step
    ``(h @ kernel_h + bias) + xp_t``.  Every window is computed.
    bfloat16 inputs are widened to float32 first, as the kernel widens
    them as it loads."""
    steps = list(chain or ())
    x, kernel_i, kernel_h, bias = (t.float() for t in (x, kernel_i, kernel_h, bias))
    view = lambda t: t[:, None, :]  # noqa: E731
    if idx is not None:
        take = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
        kernel_i, kernel_h, bias = (t.index_select(0, take) for t in (kernel_i, kernel_h, bias))
        view = lambda t: t.index_select(0, take)[:, None, :]  # noqa: E731
    nw = _windows(x, lookback, n_windows)
    if x.dim() == 3:
        x = make_windows(apply_steps(x, steps, view), lookback)[:, :nw]
    hs, _, _ = _recurrence(x, kernel_i, kernel_h, bias)
    return ACTIVATIONS[act](hs[:, :, -1] if last else hs)


def _recurrence(x: torch.Tensor, kernel_i, kernel_h, bias, save: bool = False):
    """h of every step (m, nw, T, H) of windows ``x`` (m, nw, T, in); with
    ``save`` also the gates i, f, g, o after their activations (m, nw, T,
    4H) and c (m, nw, T, H), else None for both."""
    m, nw, T, n_in = x.shape
    H = int(kernel_h.shape[1])
    xp = torch.bmm(x.reshape(m, nw * T, n_in), kernel_i).reshape(m, nw, T, 4 * H)
    h = x.new_zeros((m, nw, H))
    c = x.new_zeros((m, nw, H))
    steps, gates, cells = [], [], []
    for t in range(T):
        z = (torch.bmm(h, kernel_h) + bias[:, None, :]) + xp[:, :, t]
        i, f, g, o = torch.split(z, H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        steps.append(h)
        if save:
            gates.append(torch.cat([i, f, g, o], dim=-1))
            cells.append(c)
    if not save:
        return torch.stack(steps, dim=2), None, None
    return (torch.stack(steps, dim=2), torch.stack(gates, dim=2), torch.stack(cells, dim=2))


# -- training mode -----------------------------------------------------------

class Minibatch(NamedTuple):
    """One lockstep step's minibatch of every slot of a fleet build, as
    int32 tensors on the device.  Slot ``s`` reads machine ``x_mach[s]``
    of the rows; its fit's gathered rows are ``rows[row_off[s]:]``; window
    ``w`` of it is those rows ``win[s, w] .. win[s, w] + lookback - 1``.
    The first ``n_windows[s]`` entries of ``win[s]`` are the minibatch's
    real windows; the rest (``-1``) weigh nothing."""

    win: torch.Tensor        # (m, B)
    n_windows: torch.Tensor  # (m,)
    rows: torch.Tensor       # (R,)
    row_off: torch.Tensor    # (m,)
    x_mach: torch.Tensor     # (m,)

    def weights(self) -> torch.Tensor:
        """(m, B) float32: 1 for the real windows, 0 for padding."""
        B = int(self.win.shape[1])
        pos = torch.arange(B, device=self.win.device)
        return (pos[None, :] < self.n_windows.long()[:, None]).float()

    def row_index(self, steps: int, shift: int = 0) -> torch.Tensor:
        """(m, B, steps) rows of each window's steps, from ``shift`` on
        (padding reads window 0)."""
        win = self.win.long().clamp_min(0)
        t = torch.arange(steps, device=win.device) + shift
        pos = self.row_off.long()[:, None, None] + win[:, :, None] + t
        return self.rows.long()[pos]

    def gather(self, x: torch.Tensor, steps: int, shift: int = 0) -> torch.Tensor:
        """(m, B, steps, f) rows of ``x`` (M, n, f) for every window."""
        return x[self.x_mach.long()[:, None, None], self.row_index(steps, shift)]


def lstm_layer_train(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    *,
    lookback: int,
    batch: Minibatch,
    act: Optional[str] = None,
    chain: Optional[Prefix] = None,
    last: bool = False,
    gates: Optional[torch.Tensor] = None,
    cell: Optional[torch.Tensor] = None,
):
    """One LSTM layer over one minibatch of windows of every slot, saving
    what the backward needs.

    ``x``: the first layer's raw rows (M, n, in), its windows read through
    ``batch`` and taken through the scaler steps ``chain`` (stats (m,
    in), each slot's own); or a later layer's input (m, B, lookback, in).  ``kernel_i`` (m, in,
    4H), ``kernel_h`` (m, H, 4H), ``bias`` (m, 4H): each slot's own.
    ``gates`` (m, B, lookback, 4H) and ``cell`` (m, B, lookback, H): where
    to save the gates after their activations and c (allocated when not
    given).  Returns ``(out, gates, cell)``: ``act(h)`` of every step (m,
    B, lookback, H), or of the last (m, B, H) when ``last``.  Windows past
    a slot's ``n_windows`` are unspecified."""
    steps = list(chain or ())
    if x.device.type == "cpu":
        return lstm_layer_train_plain(
            x, kernel_i, kernel_h, bias, lookback=lookback, batch=batch, act=act,
            chain=steps, last=last,
        )
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer runs on cuda or cpu tensors, got {x.device}")
    device = x.device
    if act not in ACT_CODES:
        raise ValueError(f"activation {act!r} has no kernel code")
    m, B = (int(s) for s in batch.win.shape)
    rows_input = x.dim() == 3
    n_in = int(x.shape[-1])
    H = int(kernel_h.shape[1])
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"need 1..{MAX_SLOTS} slots, got {m}")
    if not rows_input:
        _check(x, "x", (m, B, lookback, n_in), device)
    else:
        _check(x, "x", tuple(x.shape), device)
    _check(kernel_i, "kernel_i", (m, n_in, 4 * H), device)
    _check(kernel_h, "kernel_h", (m, H, 4 * H), device)
    _check(bias, "bias", (m, 4 * H), device)
    if steps and not rows_input:
        raise ValueError("the pipeline scaler applies to the first layer's rows only")
    check_steps(steps, (m, n_in), device, (torch.float32,), "pipeline scaler")
    _check_batch(batch, m, device)
    if gates is None:
        gates = torch.empty((m, B, lookback, 4 * H), dtype=torch.float32, device=device)
    if cell is None:
        cell = torch.empty((m, B, lookback, H), dtype=torch.float32, device=device)
    _check(gates, "gates", (m, B, lookback, 4 * H), device)
    _check(cell, "cell", (m, B, lookback, H), device)

    plan = launch_plan(n_in, H, B, m)
    out = torch.empty((m, B, H) if last else (m, B, lookback, H), dtype=torch.float32, device=device)
    args = _Args()
    args.x = _ptr(x)
    args.scalers.fill(steps)
    args.w_i, args.w_h, args.bias = _ptr(kernel_i), _ptr(kernel_h), _ptr(bias)
    args.idx, args.n_windows, args.out = None, _ptr(batch.n_windows), _ptr(out)
    args.win, args.rows, args.row_off = _ptr(batch.win), _ptr(batch.rows), _ptr(batch.row_off)
    args.x_mach, args.gates, args.cell = _ptr(batch.x_mach), _ptr(gates), _ptr(cell)
    args.m, args.n, args.nw, args.lookback = m, int(x.shape[1]), B, lookback
    args.in_, args.hidden = n_in, H
    args.rows_input, args.last, args.act = int(rows_input), int(last), ACT_CODES[act]
    _fill_plan(args, plan)
    _launch(args, device)
    return out, gates, cell


def _check_batch(batch: Minibatch, m: int, device) -> None:
    for name in Minibatch._fields:
        t = getattr(batch, name)
        if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"batch.{name} must be a contiguous int32 tensor on {device}")
    if batch.win.dim() != 2 or int(batch.win.shape[0]) != m:
        raise ValueError(f"batch.win must be (m, B) with m = {m}, got {tuple(batch.win.shape)}")
    for name in ("n_windows", "row_off", "x_mach"):
        if tuple(getattr(batch, name).shape) != (m,):
            raise ValueError(f"batch.{name} must have one entry per slot ({m})")


def lstm_layer_train_plain(
    x: torch.Tensor,
    kernel_i: torch.Tensor,
    kernel_h: torch.Tensor,
    bias: torch.Tensor,
    *,
    lookback: int,
    batch: Minibatch,
    act: Optional[str] = None,
    chain: Optional[Prefix] = None,
    last: bool = False,
):
    """:func:`lstm_layer_train` in plain PyTorch (differentiable: the plain
    fit takes its gradients by autograd).  Every window position is
    computed, padding from window 0.  Returns ``(out, gates, cell)``."""
    if x.dim() == 3:
        x = apply_steps(batch.gather(x, lookback), chain or (), lambda t: t[:, None, None, :])
    hs, gates, cell = _recurrence(x, kernel_i, kernel_h, bias, save=True)
    return ACTIVATIONS[act](hs[:, :, -1] if last else hs), gates, cell
