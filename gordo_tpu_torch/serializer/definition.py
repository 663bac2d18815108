"""Definition-dict ⇄ live object interpreter.

Counterpart of ``gordo_tpu/serializer/definition.py``.  A definition is a
nested dict where a string is a dotted path instantiated with no kwargs, a
single-key dict ``{"pkg.mod.Class": {kwargs}}`` is a class with kwargs,
and kwargs recurse.  Dotted paths resolve through
:mod:`gordo_tpu_torch.registry`, so the JAX package's definitions
(``gordo_tpu.*``) and reference-era ones (``sklearn.*``,
``gordo_components.*``) build the port's classes.  Only the port's own
modules are ever imported.
"""

from __future__ import annotations

import copy
import importlib
from typing import Any, Mapping

from gordo_tpu_torch.registry import ALLOWED_IMPORT_PREFIXES, resolve_alias


def _looks_like_import_path(key: str) -> bool:
    return isinstance(key, str) and "." in key and not key.startswith(".")


def import_locate(dotted: str) -> Any:
    """Import ``pkg.mod.attr`` (after alias rewriting), allowlist-enforced."""
    dotted = resolve_alias(dotted)
    if not dotted.startswith(ALLOWED_IMPORT_PREFIXES):
        raise ValueError(
            f"Refusing to import {dotted!r}: not under allowed prefixes "
            f"{ALLOWED_IMPORT_PREFIXES}"
        )
    module_path, _, attr = dotted.rpartition(".")
    try:
        module = importlib.import_module(module_path)
    except ImportError as exc:
        raise ImportError(f"Cannot import module {module_path!r} for {dotted!r}: {exc}")
    try:
        return getattr(module, attr)
    except AttributeError:
        raise ImportError(f"Module {module_path!r} has no attribute {attr!r}")


def from_definition(definition: Any) -> Any:
    """Recursively turn a definition structure into live objects."""
    if isinstance(definition, str):
        if _looks_like_import_path(definition):
            target = import_locate(definition)
            return target() if isinstance(target, type) else target
        return definition

    if isinstance(definition, Mapping):
        if len(definition) == 1:
            (key, value), = definition.items()
            if _looks_like_import_path(key):
                target = import_locate(key)
                if value is None:
                    return target() if isinstance(target, type) else target
                if isinstance(value, Mapping):
                    kwargs = {k: _recurse_value(v) for k, v in value.items()}
                    return target(**kwargs)
                return target(_recurse_value(value))
        return {k: _recurse_value(v) for k, v in definition.items()}

    if isinstance(definition, (list, tuple)):
        return [from_definition(item) for item in definition]

    return definition


def _recurse_value(value: Any) -> Any:
    if isinstance(value, Mapping):
        if len(value) == 1 and _looks_like_import_path(next(iter(value))):
            return from_definition(value)
        return {k: _recurse_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_recurse_value(v) for v in value]
    if isinstance(value, str) and _looks_like_import_path(value):
        # a dotted string stays a string unless it names a component
        # (e.g. a Pipeline step given by path alone)
        try:
            target = import_locate(value)
        except (ValueError, ImportError):
            return value
        return target() if isinstance(target, type) else target
    return value


def into_definition(obj: Any) -> Any:
    """Inverse of :func:`from_definition` through ``get_params()``."""
    if obj is None or isinstance(obj, (int, float, bool, str)):
        return obj
    if isinstance(obj, Mapping):
        return {k: into_definition(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [into_definition(v) for v in obj]
    if hasattr(obj, "get_params"):
        cls = type(obj)
        path = f"{cls.__module__}.{cls.__qualname__}"
        params = {
            k: into_definition(v)
            for k, v in obj.get_params(deep=False).items()
            if v is not None
        }
        return {path: params}
    return copy.deepcopy(obj)
