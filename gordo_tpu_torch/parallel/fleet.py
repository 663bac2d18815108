"""Fleet training (counterpart of ``gordo_tpu/parallel/fleet.py``).

The generic fleet API trains and applies M instances of one dense chain
on stacked data (``fold_masks``, ``FleetFitResult``, ``StagedFleetFit``,
:func:`fleet_stage` → :func:`fleet_dispatch` → ``collect``,
:func:`fleet_fit`, :func:`fleet_apply`): a fit is one launch of the
``fleet_fit`` kernel with the caller's row weights, an apply one launch of
``fleet_apply``.  A mesh (ROADMAP queue 1 item 11) and LSTM modules, whose
JAX fits take windows (M, N, L, F) (item 19), raise
``NotImplementedError``.

Host-side pieces of the fleet builds:

- :func:`stack_rows`: per-machine arrays stacked along a machine axis;
- :func:`fleet_keys`, :func:`fleet_init`, :func:`fleet_draws`: the
  JAX package's ``fleet_keys``/``fleet_init`` and epoch permutations,
  drawn by the ``fleet_init`` kernel (K11, ``kernels/fleet_init.py``) on
  the caller's device, or by its plain version on the CPU, from the same
  threefry keys: each machine's initial params (flax ``lecun_normal``
  kernels and zero biases; for an LSTM chain (:class:`LSTMDims`) each
  gate's ``kernel_i`` lecun-normal and its ``kernel_h`` orthogonal, as
  ``_FusedLSTMCellParams`` draws them, then the ``out`` Dense) and the
  per-epoch row permutations of a fit of ``n_total`` padded rows.  Keys
  and permutations are JAX's bit for bit, the params within a few ulp
  (``kernel_h`` after its QR within 1e-5).  :func:`draw_fleet` draws any
  number of seeds in one launch.

- :func:`stack_warm_params`, the port's ``_stack_warm_params``
  (``gordo_tpu/parallel/anomaly.py:317``): a warm build's per-machine
  params (each the estimator's ``state_arrays()``, the format of
  ``arrays.npz``) stacked into the ``params0`` layout of :func:`put_draws`
  / :func:`put_lstm_draws`, one draw per machine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.device import resolve_device, to_device
from gordo_tpu_torch.kernels.fleet_apply import fleet_apply as _fleet_apply_kernel
from gordo_tpu_torch.kernels.fleet_fit import fleet_fit as _fleet_fit_kernel
from gordo_tpu_torch.kernels.fleet_fit import geometry, pack_perms
from gordo_tpu_torch.kernels.fleet_init import NORMAL, TRUNCATED, Leaf, init_and_fit_keys
from gordo_tpu_torch.kernels.fleet_init import fleet_init as _fleet_init_kernel
from gordo_tpu_torch.models.factories.feedforward import layer_names
from gordo_tpu_torch.models.factories.lstm import LSTMAutoEncoderModule, cell_names
from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams

Params = List[Tuple[np.ndarray, np.ndarray]]
#: ``(seed, dims, n_totals, epochs) -> (params, {n_total: (epochs, n_total)
#: permutations})``; params are ``[(kernel, bias), ...]`` of a dense chain
#: of widths ``dims``, or ``([(kernel_i, kernel_h, bias), ...], (out
#: kernel, out bias))`` when ``dims`` is an :class:`LSTMDims`
Draws = Callable[[int, Sequence[int], Sequence[int], int], Tuple[Any, Dict[int, np.ndarray]]]


class LSTMDims(tuple):
    """Widths of an LSTM chain, ``(n_features, hidden_1, ..., hidden_k,
    n_out)``: a tuple that tells a :data:`Draws` to draw LSTM cells and an
    ``out`` head instead of dense layers."""


def stack_rows(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-machine row-major arrays with row padding.

    Returns ``(stacked (M, N, ...), weights (M, N), lengths (M,))`` where
    ``N`` is the max row count and ``weights`` masks padded rows.
    """
    arrays = [np.asarray(a, dtype=np.float32) for a in arrays]
    trailing = {a.shape[1:] for a in arrays}
    if len(trailing) != 1:
        raise ValueError(
            f"stack_rows needs homogeneous feature shapes, got {sorted(trailing)}"
        )
    lengths = np.array([a.shape[0] for a in arrays], dtype=np.int32)
    n = int(lengths.max())
    out = np.zeros((len(arrays), n) + arrays[0].shape[1:], dtype=np.float32)
    w = np.zeros((len(arrays), n), dtype=np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
        w[i, : a.shape[0]] = 1.0
    return out, w, lengths


def chain_leaves(dims) -> List[Leaf]:
    """The drawn kernels of a chain of widths ``dims``, in flax's order:
    ``dense_{i}``/``out`` kernels, or for an :class:`LSTMDims` each cell's
    ``i{c}`` input kernels and ``h{c}`` recurrent kernels (c in ``ifgo``),
    then the ``out`` head."""
    if isinstance(dims, LSTMDims):
        leaves = []
        for name, n_in, h in zip(cell_names(len(dims) - 2), dims[:-2], dims[1:-1]):
            leaves += [Leaf((name, f"i{c}"), (n_in, h), TRUNCATED) for c in "ifgo"]
            leaves += [Leaf((name, f"h{c}"), (h, h), NORMAL) for c in "ifgo"]
        return leaves + [Leaf(("out",), (dims[-2], dims[-1]), TRUNCATED)]
    names = layer_names(len(dims) - 1)
    return [Leaf((name,), (a, b), TRUNCATED) for name, a, b in zip(names, dims[:-1], dims[1:])]


def _orthogonal(z: torch.Tensor) -> torch.Tensor:
    """``jax.random.orthogonal``'s map of square normals ``z`` (..., H, H):
    ``q * sign(diag(r))`` of their QR (``torch.linalg.qr`` on the device, as
    JAX leaves it to XLA's and LAPACK's QR)."""
    q, r = torch.linalg.qr(z)
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)).unsqueeze(-2)


def draw_fleet(seeds, dims, n_totals: Sequence[int], epochs: int, device=None):
    """The draws of every seed in ``seeds`` in one ``fleet_init`` launch
    on ``device`` (as ``resolve_device``): ``(params, {n_total: (D,
    epochs, n_total) int32 permutations})``, the params stacked over the
    seeds: ``[(W (D, in, out), b (D, out)), ...]``, or for an
    :class:`LSTMDims` ``([(kernel_i (D, in, 4H), kernel_h (D, H, 4H), bias
    (D, 4H)), ...], (W (D, H, n_out), b (D, n_out)))``."""
    dev = resolve_device(device)
    seeds = to_device(np.asarray(seeds, np.int64).reshape(-1), dev)
    leaves = chain_leaves(dims)
    lengths = sorted({int(n) for n in n_totals})
    values, perms = _fleet_init_kernel(seeds, leaves, lengths, epochs)
    d = int(seeds.shape[0])
    drawn, off = [], 0
    for leaf in leaves:
        drawn.append(values[:, off: off + leaf.size].reshape(d, *leaf.shape))
        off += leaf.size

    def zeros(n):
        return torch.zeros((d, n), dtype=torch.float32, device=dev)

    if isinstance(dims, LSTMDims):
        cells = []
        for i, h in enumerate(dims[1:-1]):
            gates = drawn[8 * i: 8 * i + 8]
            kh = _orthogonal(torch.stack(gates[4:], dim=1))  # (D, 4, H, H)
            cells.append((torch.cat(gates[:4], dim=-1).contiguous(),
                          torch.cat(list(kh.unbind(1)), dim=-1).contiguous(), zeros(4 * h)))
        params = (cells, (drawn[-1].contiguous(), zeros(dims[-1])))
    else:
        params = [(W.contiguous(), zeros(b)) for W, b in zip(drawn, dims[1:])]
    return params, dict(zip(lengths, perms))


def fleet_keys(seeds) -> Tuple[np.ndarray, np.ndarray]:
    """Per-machine ``(init_key, fit_key)`` data, each (M, 2) uint32: the
    split of ``PRNGKey(seed)``, as the JAX package's ``fleet_keys``."""
    init_key, fit_key = init_and_fit_keys(torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1)))
    return tuple(np.stack([k0.numpy(), k1.numpy()], axis=-1).astype(np.uint32)
                 for k0, k1 in (init_key, fit_key))


def fleet_init(module, seeds, device=None):
    """The initial params of a factory's ``module`` (dense or LSTM chain)
    for every seed, stacked (the JAX package's ``fleet_init`` of
    ``fleet_keys(seeds)``'s init keys): one ``fleet_init`` launch."""
    dims = lstm_chain_of(module)[0] if isinstance(module, LSTMAutoEncoderModule) else chain_of(module)[0]
    return draw_fleet(seeds, dims, [], 0, device)[0]


def _host(params, i: int = 0):
    """Draw ``i`` of :func:`draw_fleet`'s params as host arrays, in the
    layout of :data:`Draws`."""
    if isinstance(params, tuple):
        cells, (W, b) = params
        return ([tuple(a[i].cpu().numpy() for a in cell) for cell in cells],
                (W[i].cpu().numpy(), b[i].cpu().numpy()))
    return [(W[i].cpu().numpy(), b[i].cpu().numpy()) for W, b in params]


def init_params(dims: Sequence[int], seed: int, device="cpu") -> Params:
    """``[(kernel (in, out), bias (out,)), ...]`` of a dense chain of widths
    ``dims``: ``module.init`` of ``split(PRNGKey(seed))[0]``."""
    return _host(draw_fleet([seed], dims, [], 0, device)[0])


def init_lstm_params(dims: Sequence[int], seed: int, device="cpu"):
    """``([(kernel_i (in, 4H), kernel_h (H, 4H), bias (4H,)), ...], (out
    kernel (H, n_out), out bias))`` of an LSTM chain of widths ``dims``: per
    gate i, f, g, o a lecun-normal input kernel and an orthogonal recurrent
    one, zero biases (flax's ``_FusedLSTMCellParams``), and a lecun-normal
    head, from ``split(PRNGKey(seed))[0]``."""
    return _host(draw_fleet([seed], LSTMDims(dims), [], 0, device)[0])


def epoch_permutations(seed: int, n_total: int, epochs: int, device="cpu") -> np.ndarray:
    """(epochs, n_total) row permutations of a fit of ``n_total`` padded
    rows: ``permutation(k, n_total)`` of each of ``split(fit_key,
    epochs)``."""
    seeds = to_device(np.asarray([seed], np.int64), resolve_device(device))
    _, (perms,) = _fleet_init_kernel(seeds, [], [int(n_total)], epochs)
    return perms[0].cpu().numpy()


def fleet_draws(
    seed: int, dims: Sequence[int], n_totals: Sequence[int], epochs: int, device="cpu"
) -> Tuple[Params, Dict[int, np.ndarray]]:
    """The default source of draws: ``(initial params, {n_total: (epochs,
    n_total) permutations})`` of one seed, as host arrays (the builders
    draw through :func:`draw_fleet` on their device instead)."""
    params, perms = draw_fleet([seed], dims, n_totals, epochs, device)
    return _host(params), {n: p[0].cpu().numpy() for n, p in perms.items()}


def chain_of(module) -> Tuple[List[int], Tuple]:
    """Widths and activations of a factory's dense chain."""
    layers = module.layers()
    dims = [layers[0][0].in_features] + [lin.out_features for lin, _ in layers]
    return dims, tuple(act for _, act in layers)


def lstm_chain_of(module) -> Tuple[LSTMDims, Tuple, Any]:
    """Widths, cell activations and head activation of a factory's LSTM chain."""
    cells = module.cells()
    dims = LSTMDims(
        [int(cells[0][0].kernel_i.shape[0])] + [c.hidden for c, _ in cells]
        + [int(module.out.out_features)]
    )
    return dims, tuple(act for _, act in cells), module.out_func


def put_draws(
    draws: Draws, seed: int, dims, fits, epochs: int, device
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """One seed's draws for ``fits`` as the kernel's device inputs (the
    default :func:`fleet_draws` drawn on ``device`` by one launch)."""
    if draws is fleet_draws:
        params0, perms = draw_fleet([seed], dims, [fg.n_total for fg in fits], epochs, device)
        packed = torch.cat([perms[fg.n_total].reshape(1, -1) for fg in fits], dim=1)
        return params0, packed.contiguous()
    params, perms = draws(seed, dims, [fg.n_total for fg in fits], epochs)
    params0 = [
        (torch.from_numpy(np.array(W, np.float32)[None]).to(device),
         torch.from_numpy(np.array(b, np.float32)[None]).to(device))
        for W, b in params
    ]
    packed = pack_perms([np.asarray(perms[fg.n_total])[None] for fg in fits])
    return params0, torch.from_numpy(packed).to(device)


def put_lstm_draws(draws: Draws, seed: int, dims: LSTMDims, fits, epochs: int, device):
    """One seed's LSTM draws for ``fits``: ``((cells, head), perms)``, the
    params on ``device`` with a leading draw axis of 1, the permutations
    per fit as host ints (1, epochs, n_total)."""
    if draws is fleet_draws:
        params0, perms = draw_fleet([seed], dims, [fg.n_total for fg in fits], epochs, device)
        host = {n: p.cpu().numpy() for n, p in perms.items()}
        return params0, [host[fg.n_total] for fg in fits]
    (cells, head), perms = draws(seed, dims, [fg.n_total for fg in fits], epochs)

    def put(a):
        return torch.from_numpy(np.array(a, np.float32)[None]).to(device)

    params0 = ([tuple(put(a) for a in cell) for cell in cells], (put(head[0]), put(head[1])))
    return params0, [np.asarray(perms[fg.n_total])[None] for fg in fits]


def _state_shapes(dims) -> Dict[str, Tuple[int, ...]]:
    """The estimator state dict's leaf shapes of a chain of widths ``dims``."""
    if isinstance(dims, LSTMDims):
        shapes = {}
        for name, n_in, h in zip(cell_names(len(dims) - 2), dims[:-2], dims[1:-1]):
            shapes.update({f"{name}.kernel_i": (n_in, 4 * h), f"{name}.kernel_h": (h, 4 * h),
                           f"{name}.bias": (4 * h,)})
        shapes.update({"out.weight": (dims[-1], dims[-2]), "out.bias": (dims[-1],)})
        return shapes
    shapes = {}
    for name, n_in, n_out in zip(layer_names(len(dims) - 1), dims[:-1], dims[1:]):
        shapes.update({f"{name}.weight": (n_out, n_in), f"{name}.bias": (n_out,)})
    return shapes


def stack_warm_params(states: Sequence[Dict[str, Any]], dims, device):
    """Per-machine warm-start params (each an estimator's ``state_arrays()``)
    as the ``params0`` of a length group with one draw per machine: ``[(W
    (M, in, out), b (M, out)), ...]``, or for an LSTM chain (``dims`` an
    :class:`LSTMDims`) ``([(kernel_i (M, in, 4H), kernel_h, bias), ...],
    (W (M, H, Fo), b (M, Fo)))``.

    Every machine's leaves must have the group's names and shapes; one
    that does not (an artifact from before a model-config change) raises
    ``ValueError``, so the caller can rebuild cold."""
    shapes = _state_shapes(dims)
    for i, state in enumerate(states):
        got = {k: tuple(np.shape(v)) for k, v in state.items()}
        if got != shapes:
            raise ValueError(
                f"warm-start params for machine {i} break the group's shared leaf "
                f"signature ({got} != {shapes}); the previous artifact predates a "
                "model-config change: rebuild cold"
            )

    def put(key, transpose=False):
        a = np.stack([np.asarray(state[key], np.float32) for state in states])
        if transpose:
            a = a.transpose(0, 2, 1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if isinstance(dims, LSTMDims):
        cells = [tuple(put(f"{name}.{k}") for k in ("kernel_i", "kernel_h", "bias"))
                 for name in cell_names(len(dims) - 2)]
        return cells, (put("out.weight", transpose=True), put("out.bias"))
    return [(put(f"{name}.weight", transpose=True), put(f"{name}.bias"))
            for name in layer_names(len(dims) - 1)]


# -- the generic fleet API (gordo_tpu/parallel/fleet.py:86-420) -------------

MESH_ITEM = "ROADMAP queue 1 item 11 (placement: the fleet axis over a mesh of cards)"
LSTM_ITEM = (
    "ROADMAP queue 1 item 19 (the generic fleet API for LSTM modules, whose "
    "fits take windows (M, N, L, F))"
)


def fold_masks(n_rows: int, splitter) -> Tuple[np.ndarray, np.ndarray]:
    """CV folds as boolean masks ``(K, n_rows)`` of train and test rows."""
    k = splitter.get_n_splits()
    train = np.zeros((k, n_rows), dtype=bool)
    test = np.zeros((k, n_rows), dtype=bool)
    for i, (tr, te) in enumerate(splitter.split(np.empty((n_rows, 1)))):
        train[i, tr] = True
        test[i, te] = True
    return train, test


class FleetFitResult:
    """Stacked fit output: ``params`` ``[(W (M, in, out), b (M, out)),
    ...]`` on the device, and the loss history.

    ``history`` is lazy: :func:`fleet_dispatch` returns while the kernel
    still runs, holding the device's (M, epochs) history; the first
    ``.history`` access (or :meth:`collect`) waits for it and caches the
    host copy."""

    def __init__(self, params, n_models: int, history: Any = None):
        self.params = params
        self.n_models = n_models
        self._history = history

    @property
    def history(self) -> np.ndarray:
        """(M, epochs) loss history, fetched on first access."""
        if self._history is not None and not isinstance(self._history, np.ndarray):
            self._history = self._history.cpu().numpy()[: self.n_models]
        return self._history

    def collect(self) -> "FleetFitResult":
        """Wait until the fit finished and the history is on the host."""
        _ = self.history
        return self

    def unstack_params(self) -> List[Params]:
        """Per-machine host params ``[(kernel (in, out), bias (out,)), ...]``."""
        host = [(W.cpu().numpy(), b.cpu().numpy()) for W, b in self.params]
        return [[(W[i], b[i]) for W, b in host] for i in range(self.n_models)]


@dataclasses.dataclass
class StagedFleetFit:
    """One bucket's fleet-fit inputs, on their way to the device (the
    copies are queued from pinned memory and do not block).  Made by
    :func:`fleet_stage`, consumed once by :func:`fleet_dispatch`, which
    drops the staged tensors as the JAX package donates its buffers: a
    staged batch cannot be dispatched twice."""

    params: Any                     # [(W (M, in, out), b (M, out)), ...]
    X: Optional[torch.Tensor]       # (M, N, F)
    y: Optional[torch.Tensor]       # (M, N, Fo)
    w: Optional[torch.Tensor]       # (M, N)
    perms: Optional[torch.Tensor]   # (M, epochs * n_total) int32
    n_models: int
    steps: int
    bs: int
    consumed: bool = False


def _dense_chain(module) -> Tuple[List[int], Tuple]:
    if isinstance(module, LSTMAutoEncoderModule):
        raise NotImplementedError(f"an LSTM module in the generic fleet API waits for {LSTM_ITEM}")
    return chain_of(module)


def _validate_fleet_params(params, m: int, m_pad: int, dims: Sequence[int]) -> None:
    """Caller-supplied params span the padded model axis, layer by layer."""
    bad = sorted({
        str(tuple(np.shape(leaf))[:1]) for pair in params for leaf in pair
        if np.ndim(leaf) < 1 or np.shape(leaf)[0] != m_pad
    })
    if bad:
        raise ValueError(
            f"caller-supplied params must have leading model axis {m_pad} "
            f"({m} machine(s) padded to the fleet width), got leading "
            f"shape(s) {bad}"
        )
    shapes = [tuple(np.shape(leaf))[1:] for pair in params for leaf in pair]
    want = [s for a, b in zip(dims[:-1], dims[1:]) for s in ((a, b), (b,))]
    if shapes != want:
        raise ValueError(f"caller-supplied params have leaf shapes {shapes}, the module {want}")


def fleet_stage(
    module,
    X: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    cfg: TrainConfig,
    seeds: Optional[np.ndarray] = None,
    mesh=None,
    params=None,
    device=None,
    draws: Draws = fleet_draws,
) -> StagedFleetFit:
    """Stage one bucket's stacked data for :func:`fleet_dispatch`.

    ``module`` a dense factory's ``nn.Module`` (its widths); ``X`` (M, N,
    F), ``y`` (M, N, Fo), ``w`` (M, N) row weights; ``seeds`` (M,) the
    draws' seeds (default ``arange(M)``): machine ``i``'s permutations, and
    its initial params unless ``params`` (``[(W (M, in, out), b (M, out)),
    ...]``) are given; ``device`` as ``resolve_device``."""
    if mesh is not None:
        raise NotImplementedError(f"fleet_stage over a mesh waits for {MESH_ITEM}")
    dims, _ = _dense_chain(module)
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    if X.ndim != 3 or y.shape[:2] != X.shape[:2] or w.shape != X.shape[:2]:
        raise ValueError(f"X (M, N, F), y (M, N, Fo) and w (M, N) must agree, got "
                         f"{X.shape}, {y.shape}, {w.shape}")
    if (X.shape[2], y.shape[2]) != (dims[0], dims[-1]):
        raise ValueError(f"the module maps {dims[0]} features to {dims[-1]}, the data "
                         f"{X.shape[2]} to {y.shape[2]}")
    m, n = X.shape[:2]
    m_pad = m  # no mesh, no model padding
    if seeds is None:
        seeds = np.arange(m_pad, dtype=np.uint32)
    else:
        seeds = np.asarray(seeds, np.uint32)
        if seeds.shape[0] not in (m, m_pad):
            raise ValueError(
                f"seeds must have one entry per machine ({m}; or {m_pad} "
                f"including mesh padding), got {seeds.shape[0]}"
            )
    fit = geometry(np.arange(n), cfg.batch_size)
    if params is not None:
        _validate_fleet_params(params, m, m_pad, dims)
    dev = resolve_device(device)
    if draws is fleet_draws:  # every seed in one fleet_init launch
        drawn, perm_sets = draw_fleet(seeds, dims, [fit.n_total], cfg.epochs, dev)
        perms = perm_sets[fit.n_total].reshape(len(seeds), -1)
        params = drawn if params is None else params
    else:
        drawn = [draws(int(s), dims, [fit.n_total], cfg.epochs) for s in seeds]
        perms = pack_perms([np.stack([np.asarray(p[fit.n_total]) for _, p in drawn])])
        if params is None:
            params = [
                tuple(np.stack([np.asarray(d[0][i][k], np.float32) for d in drawn]) for k in (0, 1))
                for i in range(len(dims) - 1)
            ]

    def put(a):  # a private copy: the caller's params stay theirs
        if isinstance(a, torch.Tensor):
            return a.detach().to(dev, torch.float32).clone().contiguous()
        return to_device(np.array(a, np.float32), dev)

    if not isinstance(perms, torch.Tensor):
        perms = to_device(perms, dev)
    return StagedFleetFit(
        params=[(put(W), put(b)) for W, b in params], X=to_device(X, dev), y=to_device(y, dev),
        w=to_device(w, dev), perms=perms, n_models=m, steps=fit.steps, bs=fit.bs,
    )


def fleet_dispatch(module, staged: StagedFleetFit, cfg: TrainConfig, mesh=None) -> FleetFitResult:
    """Launch the fleet fit on a staged bucket; returns without waiting.

    One ``fleet_fit`` launch: one fit per machine over all its rows,
    weighted by ``w``, from its staged params and permutations.  The
    staged tensors are released; read ``.history`` or call
    :meth:`FleetFitResult.collect` to wait."""
    if mesh is not None:
        raise NotImplementedError(f"fleet_dispatch over a mesh waits for {MESH_ITEM}")
    if staged.consumed:
        raise RuntimeError(
            "StagedFleetFit already dispatched: its tensors were released to "
            "the fit; stage the data again"
        )
    _, acts = _dense_chain(module)
    hp = adam_hparams(cfg)
    X, y, w, perms = staged.X, staged.y, staged.w, staged.perms
    staged.consumed = True
    staged.X = staged.y = staged.w = staged.perms = None
    M, N = (int(s) for s in X.shape[:2])
    fit = geometry(np.arange(N), cfg.batch_size)
    if (fit.steps, fit.bs) != (staged.steps, staged.bs):
        raise ValueError("cfg's batch size gives another geometry than the staged one")
    with torch.no_grad():
        layers, history = _fleet_fit_kernel(
            X, y, [fit], staged.params, perms, np.arange(M), acts, cfg.epochs, hp, w=w,
        )
    params = [(W[:, 0], b[:, 0]) for W, b in layers]
    return FleetFitResult(params=params, n_models=staged.n_models, history=history[:, 0])


def fleet_fit(
    module,
    X: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    cfg: TrainConfig,
    seeds: Optional[np.ndarray] = None,
    mesh=None,
    params=None,
    device=None,
    draws: Draws = fleet_draws,
) -> FleetFitResult:
    """Train ``M`` instances of ``module`` on stacked data in one launch:
    :func:`fleet_stage` → :func:`fleet_dispatch` →
    :meth:`FleetFitResult.collect` (arguments as :func:`fleet_stage`)."""
    staged = fleet_stage(module, X, y, w, cfg, seeds=seeds, mesh=mesh, params=params,
                         device=device, draws=draws)
    return fleet_dispatch(module, staged, cfg, mesh=mesh).collect()


def fleet_apply(module, params, X, mesh=None, device=None) -> torch.Tensor:
    """The forward pass of stacked params ``[(W (M, in, out), b (M, out)),
    ...]`` over inputs ``X`` (M, N, F): one ``fleet_apply`` launch,
    (M, N, Fo) float32 on ``device``."""
    if mesh is not None:
        raise NotImplementedError(f"fleet_apply over a mesh waits for {MESH_ITEM}")
    _, acts = _dense_chain(module)
    dev = resolve_device(device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(dev, torch.float32).contiguous()
        return to_device(np.ascontiguousarray(a, np.float32), dev)

    with torch.no_grad():
        return _fleet_apply_kernel(put(X), [(put(W), put(b)) for W, b in params], acts)
