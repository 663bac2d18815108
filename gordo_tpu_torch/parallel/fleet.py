"""Host-side pieces of fleet training (counterpart of the parts of
``gordo_tpu/parallel/fleet.py`` the exact fleet build needs).

- :func:`stack_rows`: per-machine arrays stacked along a machine axis;
- :func:`fleet_draws`, the port's ``fleet_keys``/``fleet_init``: each
  machine's initial params (flax ``lecun_normal`` kernels: a normal of
  stddev ``sqrt(1 / fan_in) / 0.87962566`` truncated at two stddevs; zero
  biases) and per-epoch row permutations, drawn from ``torch.Generator``\\ s
  seeded by the machine's seed alone (and the fit's row count), so a
  machine gets the same model whether it is built alone or in a fleet.

JAX draws from threefry keys, which the port does not reproduce: the two
agree in distribution, not in bits.  The tests hand the port JAX's draws
through a function of the same signature as :func:`fleet_draws`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.kernels.fleet_fit import pack_perms

#: flax's variance_scaling constant for a normal truncated at 2 stddevs
_TRUNC_STDDEV = 0.87962566103423978

Params = List[Tuple[np.ndarray, np.ndarray]]
#: ``(seed, dims, n_totals, epochs) -> (params [(kernel, bias), ...],
#: {n_total: (epochs, n_total) permutations})``
Draws = Callable[[int, Sequence[int], Sequence[int], int], Tuple[Any, Dict[int, np.ndarray]]]


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


def init_params(dims: Sequence[int], seed: int) -> Params:
    """``[(kernel (in, out), bias (out,)), ...]`` of a dense chain of widths
    ``dims``, drawn from a generator seeded by ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STDDEV
        kernel = torch.empty((fan_in, fan_out), dtype=torch.float32)
        torch.nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=gen)
        params.append((kernel.numpy(), np.zeros(fan_out, np.float32)))
    return params


def epoch_permutations(seed: int, n_total: int, epochs: int) -> np.ndarray:
    """(epochs, n_total) row permutations of a fit of ``n_total`` padded rows."""
    state = np.random.SeedSequence([int(seed), int(n_total)]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    return np.stack([torch.randperm(n_total, generator=gen).numpy() for _ in range(epochs)])


def fleet_draws(
    seed: int, dims: Sequence[int], n_totals: Sequence[int], epochs: int
) -> Tuple[Params, Dict[int, np.ndarray]]:
    """The default source of draws: ``(initial params, {n_total: (epochs,
    n_total) permutations})`` of one seed."""
    perms = {int(n): epoch_permutations(seed, n, epochs) for n in sorted(set(n_totals))}
    return init_params(dims, seed), perms


def chain_of(module) -> Tuple[List[int], Tuple]:
    """Widths and activations of a factory's dense chain."""
    layers = module.layers()
    dims = [layers[0][0].in_features] + [lin.out_features for lin, _ in layers]
    return dims, tuple(act for _, act in layers)


def put_draws(
    draws: Draws, seed: int, dims, fits, epochs: int, device
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """One seed's draws for ``fits`` as the kernel's device inputs."""
    params, perms = draws(seed, dims, [fg.n_total for fg in fits], epochs)
    params0 = [
        (torch.from_numpy(np.array(W, np.float32)[None]).to(device),
         torch.from_numpy(np.array(b, np.float32)[None]).to(device))
        for W, b in params
    ]
    packed = pack_perms([np.asarray(perms[fg.n_total])[None] for fg in fits])
    return params0, torch.from_numpy(packed).to(device)
