"""The serving-precision policy of the port: one owner of the serving dtype.

Counterpart of ``gordo_tpu/serve/precision.py``, with its own copy of the
alias table and the same error texts.  Resolution (:func:`serve_dtype`):
the ``GORDO_SERVE_DTYPE`` env var, else the caller's ``default``, else
``float32``; ``int8`` also needs ``GORDO_SERVE_INT8=1``.

What each dtype means on the card:

- ``float32``: the parity reference; every tensor stays float32 and the
  kernels' f32 instantiations run.
- ``bfloat16``: the stacked parameters, the scaler and detector stats and
  the request rows are STORED in bf16 (:func:`storage_dtype`): half the
  residency and half the host-to-device bytes.  The kernels' bf16
  instantiations widen every value to f32 as they load it and accumulate
  and write in f32, so outputs are float32 as at f32.  The aggregate
  thresholds are never cast (the confidence divides by f32 thresholds).
- ``int8``: experimental, behind the opt-in.  Every float leaf of the
  parameters and stats is fake-quantised once, when a model or bucket
  loads, by the ``fake_quant`` kernel (symmetric, one max-|a| scale per
  leaf, 127 levels, rescaled and stored in bf16), all the leaves of a load
  in one launch (:func:`cast_params`); rows are bf16 as above.

The JAX package casts inside its programs and computes in bf16 where its
modules do; the port stores reduced and computes in f32.  Both are held to
the same f32 parity bounds (``tests/test_torch_precision.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

SERVE_DTYPE_ENV = "GORDO_SERVE_DTYPE"
INT8_OPT_IN_ENV = "GORDO_SERVE_INT8"

#: accepted spellings → canonical names (the JAX module's table)
_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "i8": "int8",
}
SUPPORTED = ("float32", "bfloat16", "int8")


def canonical(name: str) -> str:
    """Canonical dtype name for any accepted spelling; ``ValueError`` on an
    unknown one (a typo'd dtype fails the process instead of serving f32)."""
    resolved = _ALIASES.get(str(name).strip().lower())
    if resolved is None:
        raise ValueError(
            f"unknown serving dtype {name!r}; supported: "
            f"{', '.join(SUPPORTED)} (GORDO_SERVE_DTYPE)"
        )
    return resolved


def _int8_opted_in() -> bool:
    return os.environ.get(INT8_OPT_IN_ENV, "").strip().lower() in ("1", "true", "on", "yes")


def serve_dtype(default: Optional[str] = None) -> str:
    """``GORDO_SERVE_DTYPE`` when set, else ``default``, else ``float32``;
    ``int8`` raises without the ``GORDO_SERVE_INT8=1`` opt-in, so a
    misconfigured deployment fails at startup, never mid-request."""
    raw = os.environ.get(SERVE_DTYPE_ENV, "").strip()
    if raw:
        name = canonical(raw)
    elif default:
        name = canonical(default)
    else:
        name = "float32"
    if name == "int8" and not _int8_opted_in():
        raise ValueError(
            "GORDO_SERVE_DTYPE=int8 is experimental (weight fake-quant, "
            "bf16 activations) and requires the explicit opt-in "
            f"{INT8_OPT_IN_ENV}=1"
        )
    return name


def resolve(dtype: Optional[str]) -> str:
    """A caller's explicit dtype (canonicalised), else :func:`serve_dtype`."""
    return canonical(dtype) if dtype else serve_dtype()


def storage_dtype(name: str) -> Optional[torch.dtype]:
    """The dtype device-resident float tensors are stored in: bf16 for
    ``bfloat16`` and ``int8``, None for ``float32`` (no cast at all)."""
    return None if canonical(name) == "float32" else torch.bfloat16


def cast_storage(t: torch.Tensor, name: str) -> torch.Tensor:
    """A float tensor at the storage dtype (identity for f32 and for
    non-float tensors)."""
    st = storage_dtype(name)
    if st is None or not t.is_floating_point():
        return t
    return t.to(st).contiguous()


def cast_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """Request rows at the storage dtype, cast on the host before the copy
    (half the H2D bytes at bf16).  Rows are data, never fake-quantised."""
    st = storage_dtype(name)
    return x if st is None else x.to(st)


def cast_params(leaves: Sequence[torch.Tensor], name: str,
                groups: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The float leaves of one load (a model's or a bucket's stack) for
    serving at ``name``: unchanged at f32, cast to bf16 at bf16, and at
    int8 fake-quantised all in one ``fake_quant_many`` call (its plain
    version for CPU tensors).  ``groups`` (default 1 a leaf): the last
    axis holds that many equal column blocks, each its own leaf (an LSTM's
    gates, which the JAX package keeps as separate leaves); every leading
    axis belongs to the leaf, so a stacked (M, ...) leaf takes one scale
    across its machines, as the reference's bucket path does."""
    name = canonical(name)
    if name == "float32":
        return list(leaves)
    if name == "bfloat16":
        return [t.to(torch.bfloat16).contiguous() for t in leaves]
    from gordo_tpu_torch.kernels.fake_quant import fake_quant_many

    return fake_quant_many([t.contiguous() for t in leaves], groups)
