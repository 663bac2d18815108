"""Safe row-filter expression evaluation.

Copy of ``gordo_tpu/dataset/filter_rows.py``.

Reference equivalent: ``gordo_components/dataset/filter_rows.py`` —
``pandas_filter_rows(df, expr)``: numexpr-style boolean expressions over tag
columns (e.g. ``"`TAG-A` > 0 & `TAG-B` < 100"``) applied before training.

Safety: the expression comes from project YAML, so it is validated against a
conservative token policy before being handed to ``DataFrame.eval`` (python
engine, no ``@`` locals, no attribute access, no dunder names).
"""

from __future__ import annotations

import re
from typing import Union

import pandas as pd

_FORBIDDEN = re.compile(r"(__|@|\.\s*[A-Za-z_])")
_ALLOWED_FUNCS = {"abs", "sqrt", "exp", "log", "sin", "cos"}
_CALL = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*\(")


_BACKTICKED = re.compile(r"`[^`]*`")


def _validate(expr: str) -> None:
    # Tag names are free-form (dots are common in real sensor tags, e.g.
    # "1903.R-29LT1001.MA_Y"); backtick-quoted names are column references,
    # not expression syntax, so they are excluded from token validation.
    expr = _BACKTICKED.sub("COL", expr)
    if _FORBIDDEN.search(expr):
        raise ValueError(
            f"Row filter {expr!r} contains forbidden tokens "
            "(attribute access / dunder / locals are not allowed)"
        )
    for fn in _CALL.findall(expr):
        if fn not in _ALLOWED_FUNCS:
            raise ValueError(
                f"Row filter {expr!r} calls disallowed function {fn!r}; "
                f"allowed: {sorted(_ALLOWED_FUNCS)}"
            )


def pandas_filter_rows(
    df: pd.DataFrame, filter_str: Union[str, list], buffer_size: int = 0
) -> pd.DataFrame:
    """Keep rows where the expression(s) evaluate truthy.

    ``buffer_size`` drops that many rows *around* every filtered-out row as
    well (sensor transients straddle the offending sample) — reference's
    ``row_filter_buffer_size`` behavior.
    """
    expressions = [filter_str] if isinstance(filter_str, str) else list(filter_str)
    mask = pd.Series(True, index=df.index)
    for expr in expressions:
        _validate(expr)
        result = df.eval(expr, engine="python")
        mask &= pd.Series(result, index=df.index).astype(bool)
    if buffer_size > 0:
        bad = ~mask
        # widen every filtered-out sample by +-buffer_size rows
        widened = bad.rolling(2 * buffer_size + 1, center=True, min_periods=1).max()
        mask = ~widened.astype(bool)
    return df[mask]
