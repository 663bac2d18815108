"""Callables usable as ``FunctionTransformer`` funcs in definitions.

Counterpart of ``gordo_tpu/ops/transformer_funcs.py`` (reference:
``gordo_components/model/transformer_funcs/general.py``).  Each func
describes a step form of the ``chain_apply`` kernel (K12), not an eager
torch op: a ``FunctionTransformer`` step becomes one step of its
pipeline's chain (:func:`step_of`), and a func called on rows runs that
one step, through the kernel for a CUDA tensor and its plain version for
host rows.  The JAX package takes the constant (``factor``, ``addend``)
as a Python scalar against float32 rows, so it is rounded to float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gordo_tpu_torch.kernels.chain_apply import ADD, EXPM1, LOG1P, MUL, Step, chain_apply, func_step

FUNC_ITEM = "ROADMAP queue 1 item 2 (training breadth: transformer funcs beyond multiplier, adder, log1p and expm1)"


def _run(X, step: Step):
    if isinstance(X, torch.Tensor):
        return chain_apply(X.float(), [step])
    X = np.ascontiguousarray(X, dtype=np.float32)
    return chain_apply(torch.from_numpy(X), [step]).numpy()


def multiplier(X, factor: float = 1.0):
    """Multiply all values by ``factor`` (reference: ``general.multiplier``)."""
    return _run(X, func_step(MUL, factor))


def adder(X, addend: float = 0.0):
    return _run(X, func_step(ADD, addend))


def log1p(X):
    return _run(X, func_step(LOG1P))


def expm1(X):
    return _run(X, func_step(EXPM1))


#: each func's form and the name and default of its constant
FORMS = {
    multiplier: (MUL, "factor", 1.0),
    adder: (ADD, "addend", 0.0),
    log1p: (LOG1P, None, 0.0),
    expm1: (EXPM1, None, 0.0),
}


def step_of(func: Optional[Callable], kw_args: Optional[dict] = None) -> Optional[Step]:
    """The ``chain_apply`` step of ``func`` called with ``kw_args``; None
    for no func (the identity).  A func that is not one of the four
    raises ``NotImplementedError``."""
    if func is None:
        return None
    if func not in FORMS:
        raise NotImplementedError(
            f"FunctionTransformer func {getattr(func, '__name__', func)!r} waits for {FUNC_ITEM}"
        )
    form, name, default = FORMS[func]
    kw = dict(kw_args or {})
    c = kw.pop(name, default) if name else 0.0
    if kw:
        raise TypeError(f"{func.__name__}() got unexpected keyword arguments {sorted(kw)}")
    return func_step(form, c)
