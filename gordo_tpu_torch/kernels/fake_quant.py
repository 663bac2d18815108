"""``fake_quant``: int8 fake quantisation of a parameter or stats leaf (K10).

Replaces ``_fake_quant_int8`` (``gordo_tpu/serve/precision.py:131``), the
int8 branch of ``cast_params``, which the JAX package runs inside every
serving program; the port runs it once per leaf when a model or bucket
loads (``serve/precision.py::cast_params``).  The kernel is CUDA C++ for
``sm_90a`` (``gordo_tpu_torch/csrc/fake_quant.cu``, whose header gives its
bound and design); :func:`fake_quant_plain` is the same function in plain
PyTorch, bit for bit the JAX function on float32 and on bfloat16 leaves.

:func:`fake_quant` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from gordo_tpu_torch.kernels import build

SOURCE = "gordo_tpu_torch/csrc/fake_quant.cu"
REPLACES = "gordo_tpu/serve/precision.py:131"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


class _Args(ctypes.Structure):
    """Mirror of ``struct FakeQuantArgs`` in the CUDA source."""

    _fields_ = [
        ("a", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n_outer", ctypes.c_longlong),
        ("groups", ctypes.c_int),
        ("cols", ctypes.c_int),
        ("in_bf16", ctypes.c_int),
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
            if lib.fake_quant_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"fake_quant: FakeQuantArgs is {lib.fake_quant_args_size()} bytes "
                    f"in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
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


def fake_quant(a: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """``a`` (any shape, float32 or bfloat16) fake-quantised to the 127-level
    int8 grid and stored in bfloat16, with one max-|a| scale per leaf:
    ``groups`` equal column blocks of the last axis, each over every
    leading axis."""
    if a.device.type == "cpu":
        return fake_quant_plain(a, groups)
    if a.device.type != "cuda":
        raise ValueError(f"fake_quant runs on cuda or cpu tensors, got {a.device}")
    if not a.is_contiguous():
        raise ValueError("fake_quant needs a contiguous leaf")
    flat, n_outer, cols = _geometry(a, groups)
    out = torch.empty(a.shape, dtype=torch.bfloat16, device=a.device)
    args = _Args()
    args.a, args.out = flat.data_ptr(), out.data_ptr()
    args.n_outer, args.groups, args.cols = n_outer, groups, cols
    args.in_bf16 = int(a.dtype == torch.bfloat16)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fake_quant_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fake_quant launch failed: {lib.fake_quant_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return out


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
