"""Compile the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and builds with
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``kernels/_build/lib<name>-<hash>.so``, keyed by a hash of the source, the
shared headers and the flags: an edited source rebuilds, an unchanged one
loads the cached library.  ``build`` starts one ``nvcc`` per source, all at once.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME, PATH and the toolkit's "
        "default prefix); the CUDA kernels cannot be built"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Keyed by the source, the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(*names: str) -> List[str]:
    """Build every named source that has no current library, one ``nvcc``
    each, all started together; returns the library paths.  Raises with
    the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not os.path.exists(p)]
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = []
    for name, path in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += "\n(nvcc timed out after 600 s)"
        if proc.returncode == 0:
            with open(path + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, path)
        else:
            failures.append(f"{name}:\n{log}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build(name)
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
