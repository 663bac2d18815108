"""LSTM fitting (counterpart of ``gordo_tpu/train/fit.py`` for
``LSTMAutoEncoderModule``), every fit of a fleet build in lockstep.

The JAX package runs a fit as one XLA program (``make_fit_fn`` /
``make_epoch_fn``): per epoch a permutation of the fit's windows, per
minibatch ``jax.value_and_grad`` of the weighted mse through the LSTM
stack and the ``out`` head, then ``optax.adam``.  An LSTM's params and
Adam moments do not fit one block (59,362 params at the bench's LSTM), so
the port keeps every fit's state in device memory and steps all fits of a
length group together: one *slot* per (machine, fit), slot ``i * G + g``,
and per (epoch, step) one launch of each kernel over every slot:

1. ``lstm_layer`` (training mode) for each layer, the first reading each
   window's rows from the fit's row list and scaling them;
2. ``lstm_head_fit``: the head, each slot's loss, and its gradient;
3. ``lstm_layer_bwd`` for each layer, last first;
4. ``fleet_adam`` on every leaf of every slot whose fit has this step
   (a fit with fewer steps an epoch is inactive, and Adam leaves it alone;
   a pad-up fit's step without a real window is active, and Adam steps on
   its zero gradient).

Forward and backward are ``torch.autograd.Function``\\ s, so the plain fit
(:func:`lstm_fit` with ``route="plain"``: autograd through
``lstm_layer_train_plain`` and ``head_loss_plain``, ``fleet_adam_plain``)
and the kernels' run the same loop.  The windows are those of
``gordo_tpu/parallel/anomaly.py:227`` ``_make_windowize`` on a fit's
gathered rows: window ``w`` is rows ``w .. w + lookback - 1`` of the fit,
its target the raw ``y`` row ``w + shift`` (``shift`` is the model's
offset: ``lookback - 1`` for an autoencoder, ``lookback`` for a
forecast).  The initial params and permutations are inputs, as in
:mod:`gordo_tpu_torch.train.fit`.  A fit resumes from given Adam state
(``train.stateful_fit``): its moments start where the last call left
them and its counts continue, so a fit run as chunks of epochs is the
uninterrupted one bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import lstm_layer as ll
from gordo_tpu_torch.kernels.fleet_adam import fleet_adam, fleet_adam_plain
from gordo_tpu_torch.kernels.lstm_head_fit import head_loss_plain, lstm_head_fit, smem_bytes
from gordo_tpu_torch.kernels.lstm_layer import Minibatch, lstm_layer_train, lstm_layer_train_plain
from gordo_tpu_torch.kernels.lstm_layer_bwd import ACT_CODES, ACT_ITEM, WIDE_ITEM, lstm_layer_bwd
from gordo_tpu_torch.kernels.lstm_layer_bwd import launch_plan as bwd_plan
from gordo_tpu_torch.kernels.scaler_stats import Prefix, check_steps
from gordo_tpu_torch.train.fit import AdamState, batch_geometry, bias_corrections

Cells = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
Head = Tuple[torch.Tensor, torch.Tensor]


class WindowFit(NamedTuple):
    """One fit's rows and the minibatch geometry of its windows."""

    rows: np.ndarray  # (n,) rows of X / y the fit trains on, in order
    n_windows: int
    steps: int
    bs: int

    @property
    def n_total(self) -> int:
        return self.steps * self.bs


def window_fit(rows, batch_size: int, offset: int) -> WindowFit:
    """The fit of the windows of ``rows`` for a model of ``offset``
    (``lookback - 1``, or ``lookback`` for a forecast): ``len(rows) -
    offset`` windows, in minibatches as ``batch_geometry`` cuts them."""
    rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
    n_windows = int(rows.shape[0]) - offset
    if n_windows < 1:
        raise ValueError(
            f"a fit of {rows.shape[0]} rows has no window for a model of offset {offset}"
        )
    steps, bs, _ = batch_geometry(n_windows, batch_size)
    return WindowFit(rows, n_windows, steps, bs)


def check_chain(dims: Sequence[int], acts: Sequence[Optional[str]], out_act, batch: int) -> None:
    """Raise ``NotImplementedError`` for what the kernels do not train:
    activations other than tanh and linear (ROADMAP queue 1 item 2), and
    layers or heads whose weights do not fit a block (item 14)."""
    for a in list(acts) + [out_act]:
        if a not in ACT_CODES:
            raise NotImplementedError(f"activation {a!r} in an LSTM fit waits for {ACT_ITEM}")
    for i, (n_in, h) in enumerate(zip(dims[:-2], dims[1:-1])):
        try:
            ll.launch_plan(n_in, h, batch)
        except ValueError as err:
            raise NotImplementedError(f"{err}; that waits for {WIDE_ITEM}") from None
        bwd_plan(n_in, h, batch, i > 0)
    smem_bytes(dims[-2], dims[-1], batch)


class _Layer(NamedTuple):
    """What one layer's autograd function needs besides its tensors."""

    lookback: int
    batch: Minibatch
    act: Optional[str]
    chain: Prefix
    last: bool
    gates: Optional[torch.Tensor]
    cell: Optional[torch.Tensor]


class _LayerFunction(torch.autograd.Function):
    """``lstm_layer`` (training mode) forward, ``lstm_layer_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, kernel_i, kernel_h, bias, layer: _Layer):
        out, gates, cell = lstm_layer_train(
            x, kernel_i, kernel_h, bias, lookback=layer.lookback, batch=layer.batch,
            act=layer.act, chain=layer.chain, last=layer.last,
            gates=layer.gates, cell=layer.cell,
        )
        ctx.save_for_backward(x, kernel_i, kernel_h, bias)
        ctx.layer, ctx.gates, ctx.cell = layer, gates, cell
        return out

    @staticmethod
    def backward(ctx, dout):
        x, kernel_i, kernel_h, bias = ctx.saved_tensors
        layer = ctx.layer
        dx, dki, dkh, db = lstm_layer_bwd(
            x, kernel_i, kernel_h, bias, ctx.gates, ctx.cell, dout.contiguous(),
            lookback=layer.lookback, batch=layer.batch, act=layer.act, chain=layer.chain,
            last=layer.last, want_dx=ctx.needs_input_grad[0],
        )
        return dx, dki, dkh, db, None


class _Head(NamedTuple):
    y: torch.Tensor
    batch: Minibatch
    shift: int
    act: Optional[str]


class _HeadFunction(torch.autograd.Function):
    """``lstm_head_fit``: the loss forward, its gradient (computed with it)
    backward."""

    @staticmethod
    def forward(ctx, h, W, b, head: _Head):
        loss, dW, db, dh = lstm_head_fit(h, W, b, head.y, batch=head.batch, shift=head.shift, act=head.act)
        ctx.grads = (dh, dW, db)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        dh, dW, db = ctx.grads
        return dh * dloss[:, None, None], dW * dloss[:, None, None], db * dloss[:, None], None


class _Steps(NamedTuple):
    """Every (epoch, step)'s minibatches of every slot, on the device."""

    win: torch.Tensor        # (epochs, steps, S, B) window ids, real ones first, -1 after
    n_windows: torch.Tensor  # (epochs, steps, S) real windows
    count: torch.Tensor      # (epochs, steps, S) Adam count, 0 where the slot's fit has no step
    bc: torch.Tensor         # (epochs, steps, S, 2) Adam's bias corrections
    rows: torch.Tensor       # (R,) the fits' row lists, concatenated
    row_off: torch.Tensor    # (S,)
    x_mach: torch.Tensor     # (S,)
    slot_windows: np.ndarray  # (S,) real windows of each slot's fit


def plan_steps(fits: Sequence[WindowFit], M: int, perms, draw, epochs: int, hp, device,
               counts=None, count0=None) -> _Steps:
    """The lockstep tables of ``M`` machines' ``fits``, machine ``i``'s fit
    ``g`` shuffled by ``perms[g][draw[i]]`` (epochs, n_total), its Adam
    count continuing from ``count0[i, g]`` (default 0: a fit's start).  Each
    minibatch's real windows (permutation entries below the machine's
    window count of the fit: ``counts[i, g]``, default the fit's) are
    packed to the front in permutation order; padding windows weigh 0 in
    the loss, so they add nothing and are not computed.  A step of a fit
    is active (its Adam count > 0) for every machine, also where it has no
    real window (the pad-up build): Adam then steps on a zero gradient, as
    ``make_epoch_fn`` does."""
    G = len(fits)
    S = M * G
    B = max(fg.bs for fg in fits)
    n_steps = max(fg.steps for fg in fits)
    draw = np.asarray(draw, np.int64)
    if counts is None:
        counts = np.tile([fg.n_windows for fg in fits], (M, 1))
    counts = np.asarray(counts, np.int64)
    if counts.shape != (M, G) or counts.min() < 0 or (counts > [fg.n_windows for fg in fits]).any():
        raise ValueError(f"counts must be (M, G) = ({M}, {G}) ints in [0, each fit's windows]")
    win = np.full((epochs, n_steps, S, B), -1, np.int32)
    n_real = np.zeros((epochs, n_steps, S), np.int32)
    count = np.zeros((epochs, n_steps, S), np.int32)
    for g, fg in enumerate(fits):
        steps = np.arange(epochs)[:, None] * fg.steps + np.arange(fg.steps)[None] + 1
        for d, c in np.unique(np.stack([draw, counts[:, g]], 1), axis=0):
            perm = np.asarray(perms[g][d])
            if perm.shape != (epochs, fg.n_total):
                raise ValueError(f"fit {g}'s permutations must be ({epochs}, {fg.n_total}), got {perm.shape}")
            ids = perm.reshape(epochs, fg.steps, fg.bs)
            real = ids < c
            order = np.argsort(~real, axis=-1, kind="stable")
            packed = np.where(np.take_along_axis(real, order, -1), np.take_along_axis(ids, order, -1), -1)
            slots = np.flatnonzero((draw == d) & (counts[:, g] == c)) * G + g
            win[:, : fg.steps, slots, : fg.bs] = packed[:, :, None, :]
            n_real[:, : fg.steps, slots] = real.sum(-1)[:, :, None]
            count[:, : fg.steps, slots] = steps[:, :, None]
    if count0 is not None:
        count0 = np.asarray(count0, np.int64)
        if count0.shape != (M, G) or count0.min() < 0:
            raise ValueError(f"count0 must be (M, G) = ({M}, {G}) ints >= 0")
        count = np.where(count > 0, count + count0.reshape(S).astype(np.int32), 0)
    row_off = np.cumsum([0] + [len(fg.rows) for fg in fits])[:-1]
    put = lambda a: to_device(np.ascontiguousarray(a), device)  # noqa: E731
    return _Steps(
        win=put(win), n_windows=put(n_real), count=put(count), bc=put(bias_corrections(count, hp)),
        rows=put(np.concatenate([fg.rows for fg in fits]).astype(np.int32)),
        row_off=put(np.tile(row_off, M).astype(np.int32)),
        x_mach=put(np.repeat(np.arange(M), G).astype(np.int32)),
        slot_windows=counts.reshape(S),
    )


def lstm_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    fits: Sequence[WindowFit],
    params0: Tuple[Cells, Head],
    perms: Sequence[np.ndarray],
    draw,
    acts: Sequence[Optional[str]],
    out_act: Optional[str],
    lookback: int,
    shift: int,
    epochs: int,
    hp: Dict[str, float],
    route: Optional[str] = None,
    perm_draw=None,
    counts=None,
    state: Optional[AdamState] = None,
    return_state: bool = False,
    chain: Optional[Prefix] = None,
):
    """Train ``len(fits)`` fits of each of ``M`` machines' LSTM chain.

    ``X`` (M, N, F), ``y`` (M, N, Fo) raw rows; ``fits`` each fit's rows
    and geometry (:func:`window_fit`); ``chain`` the pipeline's scaler
    steps, each fit's stats (M, G, F) (``kernels.fleet_fit.fleet_fit``'s
    form);
    ``params0`` ``([(kernel_i (D, in, 4H), kernel_h (D, H, 4H), bias (D,
    4H)), ...], (W (D, H, Fo), b (D, Fo)))`` and ``perms``
    (per fit, (D, epochs, n_total) host ints) the draws, of which machine
    ``i`` uses ``draw[i]`` (of the permutations ``perm_draw[i]``, default
    ``draw[i]``; params per fit, a resumed fit's, have leaves ``(D, G,
    ...)``); ``epochs`` those of ``perms``; ``acts`` the cells'
    activations, ``out_act`` the head's; ``hp`` Adam's (``train.fit.adam_hparams``); ``counts`` (M, G) host
    ints, each machine's real windows of each fit (the pad-up build: a
    window is real where its target row is below the machine's length;
    default every window of the fit).  ``route``:
    ``"kernels"`` (the default on CUDA; on the CPU the wrappers run their
    plain versions behind the same autograd functions) or ``"plain"`` (the
    default on the CPU).  ``state``: the Adam state to start from
    (``train.fit.AdamState``: moments per leaf, ``kernel_i, kernel_h,
    bias`` of each cell then the head's ``W, b``, each (M, G, ...), and
    ``count`` (M, G) host ints; default zero moments, count 0).

    Returns ``(cells [(kernel_i (M, G, in, 4H), ...)], head (W (M, G, H,
    Fo), b (M, G, Fo)), history (M, G, epochs))``, and the final
    ``AdamState`` fourth with ``return_state``."""
    if route is None:
        route = "kernels" if X.device.type == "cuda" else "plain"
    if route not in ("kernels", "plain"):
        raise ValueError(f"route must be 'kernels' or 'plain', got {route!r}")
    M, G = int(X.shape[0]), len(fits)
    S = M * G
    device = X.device
    cells0, head0 = params0
    dims = [int(X.shape[2])] + [int(kh.shape[-2]) for _, kh, _ in cells0] + [int(head0[0].shape[-1])]
    B = max(fg.bs for fg in fits)
    check_chain(dims, acts, out_act, B)
    if int(y.shape[2]) != dims[-1] or tuple(y.shape[:2]) != tuple(X.shape[:2]):
        raise ValueError(f"y {tuple(y.shape)} does not fit X {tuple(X.shape)} and the head")
    scalers = list(chain or ())
    check_steps(scalers, (M, G, dims[0]), device, (torch.float32,), "pipeline scaler")
    steps = plan_steps(fits, M, perms, draw if perm_draw is None else perm_draw, epochs, hp, device,
                       counts, None if state is None else state.count)

    leaves0 = [t for cell in cells0 for t in cell] + list(head0)
    draw = np.asarray(draw, np.int64)
    if head0[0].dim() == 4:  # params per (draw, fit): slot i * G + g takes draw[i] * G + g
        take = to_device((draw[:, None] * G + np.arange(G)).reshape(S), device)
        leaves0 = [t.reshape((-1,) + tuple(t.shape[2:])) for t in leaves0]
    else:
        take = to_device(np.repeat(draw, G), device)
    params = [t.index_select(0, take).contiguous() for t in leaves0]
    if state is None:
        mus = [torch.zeros_like(p) for p in params]
        nus = [torch.zeros_like(p) for p in params]
    else:
        if len(state.mu) != len(params) or len(state.nu) != len(params):
            raise ValueError(f"state needs moments for the {len(params)} leaves")
        for m, v, p in zip(state.mu, state.nu, params):
            if m.numel() != p.numel() or v.numel() != p.numel():
                raise ValueError(f"state moments of shapes {tuple(m.shape)}, {tuple(v.shape)} "
                                 f"do not fit a leaf of {tuple(p.shape)}")
        mus = [m.reshape(p.shape).clone() for m, p in zip(state.mu, params)]
        nus = [v.reshape(p.shape).clone() for v, p in zip(state.nu, params)]
    n_layers = len(cells0)
    # each slot's stats (S, F): slot i * G + g is machine i's fit g
    scalers_s = [(form, a.reshape(S, dims[0]).contiguous(), b.reshape(S, dims[0]).contiguous())
                 for form, a, b in scalers]
    n_windows = torch.tensor(steps.slot_windows, dtype=torch.float32, device=device)
    saved = [(None, None)] * n_layers
    if route == "kernels":  # the forward's saves, once for the whole fit
        saved = [
            (torch.empty((S, B, lookback, 4 * h), dtype=torch.float32, device=device),
             torch.empty((S, B, lookback, h), dtype=torch.float32, device=device))
            for h in dims[1:-1]
        ]

    def step_loss(leaves: List[torch.Tensor], batch: Minibatch) -> torch.Tensor:
        h = X
        for i, act in enumerate(acts):
            ki, kh, b = leaves[3 * i: 3 * i + 3]
            first, last = i == 0, i == n_layers - 1
            chain_i = scalers_s if first else []
            if route == "plain":
                h = lstm_layer_train_plain(h, ki, kh, b, lookback=lookback, batch=batch, act=act,
                                           chain=chain_i, last=last)[0]
            else:
                h = _LayerFunction.apply(
                    h, ki, kh, b, _Layer(lookback, batch, act, chain_i, last, *saved[i])
                )
        W, b = leaves[-2:]
        if route == "plain":
            return head_loss_plain(h, W, b, y, batch=batch, shift=shift, act=out_act)
        return _HeadFunction.apply(h, W, b, _Head(y, batch, shift, out_act))

    adam = fleet_adam_plain if route == "plain" else fleet_adam
    history = []
    for e in range(epochs):
        acc = torch.zeros(S, dtype=torch.float32, device=device)
        for s in range(int(steps.win.shape[1])):
            batch = Minibatch(steps.win[e, s], steps.n_windows[e, s], steps.rows,
                              steps.row_off, steps.x_mach)
            leaves = [p.detach().requires_grad_(True) for p in params]
            with torch.enable_grad():
                loss = step_loss(leaves, batch)
                grads = torch.autograd.grad(loss.sum(), leaves)
            with torch.no_grad():
                adam(params, [g.contiguous() for g in grads], mus, nus,
                     steps.count[e, s], steps.bc[e, s], hp)
                acc = acc + loss.detach() * steps.n_windows[e, s].float()
        history.append(acc / n_windows.clamp_min(1.0))

    def fleet(t: torch.Tensor) -> torch.Tensor:
        return t.reshape((M, G) + tuple(t.shape[1:]))

    cells = [tuple(fleet(params[3 * i + k]) for k in range(3)) for i in range(n_layers)]
    head = (fleet(params[-2]), fleet(params[-1]))
    history = fleet(torch.stack(history, dim=-1)) if history else X.new_zeros((M, G, 0))
    if not return_state:
        return cells, head, history
    count = np.zeros((M, G), np.int64) if state is None else np.asarray(state.count, np.int64)
    count = count + epochs * np.array([fg.steps for fg in fits])
    return cells, head, history, AdamState([fleet(m) for m in mus], [fleet(v) for v in nus], count)
