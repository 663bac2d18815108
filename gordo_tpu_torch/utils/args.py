"""Constructor-argument capture (copy of ``gordo_tpu/utils/args.py``).

``capture_args`` records ``__init__`` arguments on the instance so that
components describe themselves: ``get_params()`` round-trips through
definition dicts.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict


@functools.lru_cache(maxsize=256)
def _cached_signature(init):
    return inspect.signature(init)


def capture_args(init):
    """Decorator for ``__init__`` storing bound arguments as ``_init_params``."""

    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        sig = _cached_signature(init)
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        params: Dict[str, Any] = {
            k: v for k, v in bound.arguments.items() if k != "self"
        }
        for name, p in sig.parameters.items():
            if p.kind is inspect.Parameter.VAR_KEYWORD and name in params:
                params.update(params.pop(name))
            if p.kind is inspect.Parameter.VAR_POSITIONAL and name in params:
                params[name] = list(params[name])
        self._init_params = params
        return init(self, *args, **kwargs)

    return wrapper


class ParamsMixin:
    """sklearn-flavoured ``get_params``/``set_params`` off captured args."""

    _init_params: Dict[str, Any]

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return dict(getattr(self, "_init_params", {}))

    def set_params(self, **params):
        new = self.get_params()
        new.update(params)
        self.__init__(**new)  # type: ignore[misc]
        return self

    def clone(self):
        """Fresh unfitted copy with identical construction params."""
        from gordo_tpu_torch.serializer.definition import (
            from_definition,
            into_definition,
        )

        return from_definition(into_definition(self))
