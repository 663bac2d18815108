"""On-disk key→value registry for built-model caching.

Copy of ``gordo_tpu/utils/disk_registry.py``.

Reference equivalent: ``gordo_components/util/disk_registry.py`` — flat
files ``{registry_dir}/{key}`` whose contents are the cached value (here:
the absolute path of a built model artifact dir).  Load-bearing for the
fleet north star: a re-run project build skips every machine whose config
hash is already registered.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional

logger = logging.getLogger(__name__)

_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]+$")


def _key_path(registry_dir: str, key: str) -> str:
    if not _KEY_RE.match(key):
        raise ValueError(f"Invalid registry key {key!r}")
    return os.path.join(registry_dir, key)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename INTO it survives a crash — an
    ``os.replace`` alone makes the file atomic, not durable: until the
    directory entry itself is flushed, a power cut can roll the rename
    back.  Best-effort on filesystems that refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_key(registry_dir: str, key: str, value: str) -> None:
    os.makedirs(registry_dir, exist_ok=True)
    path = _key_path(registry_dir, key)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(value)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic vs concurrent builders of the same key
    # durability, not just atomicity: the registry entry must not survive
    # a crash that its artifact (pack/model bytes, fsynced before their
    # own rename) did not
    fsync_dir(registry_dir)


def get_value(registry_dir: str, key: str) -> Optional[str]:
    path = _key_path(registry_dir, key)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()


def list_keys(registry_dir: str) -> "list[str]":
    """Every key in the registry, sorted.  Tolerates a missing dir (empty
    registry) and skips in-flight ``.tmp.<pid>`` files from concurrent
    writers — multi-host builds share one registry dir."""
    try:
        names = os.listdir(registry_dir)
    except FileNotFoundError:
        return []
    return sorted(n for n in names if _KEY_RE.match(n))


def merge_registries(source_dirs: "list[str]", dest_dir: str) -> int:
    """Union per-shard registries into ``dest_dir`` (last writer wins on a
    duplicate key, which only happens when two shards built the same
    config — same value either way).  Returns the number of keys written.
    Used when multi-host shards write host-local registries instead of a
    shared one; with a shared dir the merge is implicit."""
    n = 0
    for src in source_dirs:
        for key in list_keys(src):
            value = get_value(src, key)
            if value is not None:
                write_key(dest_dir, key, value)
                n += 1
    return n


def delete_value(registry_dir: str, key: str) -> bool:
    path = _key_path(registry_dir, key)
    if os.path.exists(path):
        os.remove(path)
        return True
    return False
