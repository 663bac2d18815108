"""``fake_quant``: int8 fake quantisation of parameter and stats leaves (K10).

Replaces ``_fake_quant_int8`` (``gordo_tpu/serve/precision.py:131``), the
int8 branch of ``cast_params``, which the JAX package runs inside every
serving program; the port runs it once when a model or bucket loads,
every float leaf of the load in one launch (:func:`fake_quant_many`,
through ``serve/precision.py::cast_params``).  The kernel is CUDA C++ for
``sm_90a`` (``gordo_tpu_torch/csrc/fake_quant.cu``, whose header gives its
bound and design); :func:`fake_quant_plain` is the same function in plain
PyTorch, bit for bit the JAX function on float32 and on bfloat16 leaves.

:func:`fake_quant_many` and :func:`fake_quant` take the plain version only
for tensors on the CPU.  For CUDA tensors they launch the kernel or raise,
and add one to :data:`launches` per launch: one a call, unless a call holds
more than :data:`MAX_LEAVES` leaves or :data:`MAX_UNITS` (leaf, group)
units, which take a launch per such share.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from gordo_tpu_torch.kernels import build

SOURCE = "gordo_tpu_torch/csrc/fake_quant.cu"
REPLACES = "gordo_tpu/serve/precision.py:131"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


#: one launch's leaves and (leaf, group) units (``FQ_MAX_LEAVES``,
#: ``FQ_MAX_UNITS``); a unit of more than BIG (``FQ_BIG``) elements takes
#: a cluster of CLUSTER blocks, a smaller one a block
MAX_LEAVES = 48
MAX_UNITS = 192
BIG = 4096
CLUSTER = 8


class _Leaf(ctypes.Structure):
    """Mirror of ``struct QuantLeaf`` in the CUDA source."""

    _fields_ = [
        ("a", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n_outer", ctypes.c_int),
        ("groups", ctypes.c_int),
        ("cols", ctypes.c_int),
        ("in_bf16", ctypes.c_int),
    ]


class _Unit(ctypes.Structure):
    """Mirror of ``struct QuantUnit`` in the CUDA source."""

    _fields_ = [("leaf", ctypes.c_int), ("group", ctypes.c_int)]


class _Args(ctypes.Structure):
    """Mirror of ``struct FakeQuantArgs`` in the CUDA source."""

    _fields_ = [
        ("n_leaves", ctypes.c_int),
        ("n_units", ctypes.c_int),
        ("n_big", ctypes.c_int),
        ("leaves", _Leaf * MAX_LEAVES),
        ("units", _Unit * MAX_UNITS),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fake_quant")
            lib.fake_quant_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.fake_quant_launch.restype = ctypes.c_int
            lib.fake_quant_error_string.argtypes = [ctypes.c_int]
            lib.fake_quant_error_string.restype = ctypes.c_char_p
            lib.fake_quant_args_size.argtypes = []
            lib.fake_quant_args_size.restype = ctypes.c_int
            lib.fake_quant_limits.argtypes = [ctypes.c_int]
            lib.fake_quant_limits.restype = ctypes.c_int
            if lib.fake_quant_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"fake_quant: FakeQuantArgs is {lib.fake_quant_args_size()} bytes "
                    f"in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            limits = tuple(lib.fake_quant_limits(i) for i in range(4))
            if limits != (MAX_LEAVES, MAX_UNITS, BIG, CLUSTER):
                raise RuntimeError(f"fake_quant: the library's limits {limits} are not the wrapper's")
            _lib = lib
        return _lib


def _geometry(a: torch.Tensor, groups: int):
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fake_quant takes float32 or bfloat16 leaves, got {a.dtype}")
    if a.dim() == 0:
        a = a.reshape(1)
    last = int(a.shape[-1])
    if groups < 1 or last % groups:
        raise ValueError(f"the last axis ({last}) does not split into {groups} groups")
    return a, a.numel() // last, last // groups


def launch_units(units: Sequence[Tuple[int, int]]) -> List[List[int]]:
    """The launches over (leaf, elements) ``units``, each a list of unit
    indices: the units of more than :data:`BIG` elements first (a cluster
    each), then the rest (a block each), cut where a launch would pass
    :data:`MAX_UNITS` units or :data:`MAX_LEAVES` leaves."""
    shares, leaves = [[]], set()
    for u in sorted(range(len(units)), key=lambda u: units[u][1] <= BIG):
        leaf = units[u][0]
        if len(shares[-1]) == MAX_UNITS or (leaf not in leaves and len(leaves) == MAX_LEAVES):
            shares.append([])
            leaves = set()
        shares[-1].append(u)
        leaves.add(leaf)
    return [share for share in shares if share]


def fake_quant_many(
    leaves: Sequence[torch.Tensor], groups: Optional[Sequence[int]] = None,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """:func:`fake_quant` of every leaf in ``leaves`` (with its ``groups``,
    default 1 each), in one launch: the bf16 leaves, written into ``out``
    when it is given (bf16 tensors of the leaves' shapes)."""
    leaves = list(leaves)
    groups = [1] * len(leaves) if groups is None else [int(g) for g in groups]
    if len(groups) != len(leaves) or (out is not None and len(out) != len(leaves)):
        raise ValueError("fake_quant_many takes one groups count and one output a leaf")
    if not leaves:
        return []
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"fake_quant_many takes leaves on one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if out is None:
        out = [torch.empty(t.shape, dtype=torch.bfloat16, device=device) for t in leaves]
    for t, o in zip(leaves, out):
        if o.dtype != torch.bfloat16 or tuple(o.shape) != tuple(t.shape) or o.device != device:
            raise ValueError(f"fake_quant_many writes a bf16 tensor of the leaf's shape {tuple(t.shape)}, "
                             f"got {o.dtype} {tuple(o.shape)} on {o.device}")
    if device.type == "cpu":
        for t, g, o in zip(leaves, groups, out):
            o.copy_(fake_quant_plain(t, g))
        return list(out)
    if device.type != "cuda":
        raise ValueError(f"fake_quant runs on cuda or cpu tensors, got {device}")
    geometry = []
    for t, g, o in zip(leaves, groups, out):
        if not t.is_contiguous() or not o.is_contiguous():
            raise ValueError("fake_quant needs contiguous leaves and outputs")
        flat, n_outer, cols = _geometry(t, g)
        if t.numel() >= 2 ** 31:
            raise ValueError(f"fake_quant takes leaves of fewer than 2**31 values, got {t.numel()}")
        geometry.append((flat, n_outer, cols))
    units = [(i, g) for i, t in enumerate(leaves) for g in range(groups[i]) if t.numel()]
    sizes = [(i, geometry[i][1] * geometry[i][2]) for i, _ in units]
    lib = _library()
    global launches
    for share in launch_units(sizes):
        args = _args([units[u] for u in share], sum(sizes[u][1] > BIG for u in share), leaves, geometry, out)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.fake_quant_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"fake_quant launch failed: {lib.fake_quant_error_string(rc).decode()}")
        with _launches_lock:
            launches += 1
    return list(out)


def _args(units, n_big, leaves, geometry, out) -> "_Args":
    """The arguments of one launch over ``units`` ((leaf, group) pairs, the
    first ``n_big`` of them the big ones)."""
    args = _Args()
    index = {}
    for i, _ in units:
        if i not in index:
            index[i] = len(index)
            flat, n_outer, cols = geometry[i]
            la = args.leaves[index[i]]
            la.a, la.out = flat.data_ptr(), out[i].data_ptr()
            la.n_outer, la.groups, la.cols = n_outer, int(flat.shape[-1]) // cols, cols
            la.in_bf16 = int(leaves[i].dtype == torch.bfloat16)
    for k, (i, g) in enumerate(units):
        args.units[k].leaf, args.units[k].group = index[i], g
    args.n_leaves, args.n_units, args.n_big = len(index), len(units), n_big
    return args


def fake_quant(a: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """``a`` (any shape, float32 or bfloat16) fake-quantised to the 127-level
    int8 grid and stored in bfloat16, with one max-|a| scale per leaf:
    ``groups`` equal column blocks of the last axis, each over every
    leading axis (one leaf of :func:`fake_quant_many`)."""
    if a.device.type == "cpu":
        return fake_quant_plain(a, groups)
    return fake_quant_many([a], [groups])[0]


def fake_quant_plain(a: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """:func:`fake_quant` in plain PyTorch, in ``_fake_quant_int8``'s op
    order; on a bf16 leaf every operation's result is rounded to bf16, as
    XLA computes bf16 arithmetic."""
    flat, n_outer, cols = _geometry(a, groups)
    bf = flat.dtype == torch.bfloat16
    x = flat.reshape(n_outer, groups, cols).float()
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf else (lambda t: t)  # noqa: E731
    m = x.abs().amax(dim=(0, 2), keepdim=True)
    floor_ = rnd(torch.tensor(1e-12, dtype=torch.float32, device=a.device))
    s = rnd(torch.maximum(m, floor_) / 127.0)
    q = torch.clamp(torch.round(rnd(x / s)), -127.0, 127.0)
    return (q * s).to(torch.bfloat16).reshape(a.shape)
