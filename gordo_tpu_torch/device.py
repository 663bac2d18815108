"""Device and numeric-precision policy of the port.

Entry points run on CUDA unless the caller asks for the CPU by name; with
no CUDA and no explicit request they raise instead of quietly scoring on
the host.  Both packages compute in float32: TF32 is switched off for
matmuls and for cuDNN (which defaults to TF32).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → the current CUDA device; an explicit device passes through.

    Raises ``RuntimeError`` when no device is named and CUDA is absent.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  A copy to CUDA is staged
    through pinned memory and does not wait for the stream (a copy from
    pageable memory would), so a kernel wrapper that ships its small index
    arrays this way queues its launch behind running work without
    blocking; PyTorch's host allocator keeps the pinned buffer until the
    copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_compute_dtype(compute_dtype="auto") -> torch.dtype:
    """``"auto"`` → float32 (what the reference resolves to off a TPU).

    This is the model factories' compute dtype, a matter of training;
    serving precision is ``serve/precision.py``'s.  Reduced-precision
    compute in training is ROADMAP queue 1 item 2 and raises until it
    lands.
    """
    if compute_dtype in ("auto", "float32", torch.float32):
        return torch.float32
    raise NotImplementedError(
        f"compute_dtype={compute_dtype!r}: only float32 is ported; reduced-"
        "precision training waits for ROADMAP queue 1 item 2 (training "
        "breadth); serving precision is GORDO_SERVE_DTYPE"
    )
