"""Build-project bench of the port (``python -m gordo_tpu_torch.bench``).

Builds a ``RandomDataset`` project of ``--machines`` default detectors
(``DEFAULT_MODEL``: MinMaxScaler + the feedforward hourglass, the default
``TrainConfig``, ``TimeSeriesSplit(3)``) with ``--tags`` tags and
``--rows`` rows after resampling, through ``builder.build_project``, and
prints one JSON object: models/h, the build's stage split (config, load,
dispatch, collect, assemble, write seconds), the card's busy share over the
build (``torch.profiler``: kernel time over wall time) and the card's name.
A first, small build warms up (kernel builds, allocator) and is not timed.

``bench.py`` at the repository's root stays the JAX package's harness.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional

import pandas as pd

#: the first resampled row of the bench's projects (RandomDataset's default)
START = pd.Timestamp("2017-12-25 06:00:00Z")
RESOLUTION = "10min"


def project_config(machines: int, tags: int, rows: int, seed: int = 0, epochs: Optional[int] = None) -> str:
    """A project YAML of ``machines`` default detectors, each over its own
    ``tags`` random tags and ``rows`` 10-minute rows.  ``epochs`` (default:
    ``TrainConfig``'s) makes the model explicit (``DEFAULT_MODEL`` with an
    epoch count)."""
    end = START + (rows - 1) * pd.Timedelta(RESOLUTION)
    lines = [
        "globals:",
        "  dataset:",
        "    type: RandomDataset",
        f"    train_start_date: '{START.isoformat()}'",
        f"    train_end_date: '{end.isoformat()}'",
        f"    resolution: {RESOLUTION}",
    ]
    if epochs is not None:
        lines += [
            "  model:",
            "    gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector:",
            "      base_estimator:",
            "        gordo_tpu.pipeline.Pipeline:",
            "          steps:",
            "            - gordo_tpu.ops.scalers.MinMaxScaler",
            "            - gordo_tpu.models.estimator.AutoEncoder:",
            "                kind: feedforward_hourglass",
            f"                epochs: {int(epochs)}",
        ]
    lines.append("machines:")
    for i in range(machines):
        tag_list = ", ".join(f"s{seed}-m{i}-t{j}" for j in range(tags))
        lines += [f"  - name: machine-{i:05d}", f"    dataset: {{tag_list: [{tag_list}]}}"]
    return "\n".join(lines) + "\n"


def busy_share(fn, device, profile: bool = True) -> Dict[str, Any]:
    """Run ``fn()`` under ``torch.profiler``; the card's kernel time over
    the wall time (``None`` off the card or unprofiled)."""
    import torch

    if torch.device(device).type != "cuda" or not profile:
        t0 = time.time()
        out = fn()
        return {"result": out, "wall_seconds": time.time() - t0, "busy_share": None,
                "kernel_seconds": None}
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if getattr(e, "device_type", None) is not None
                    and str(e.device_type).endswith("CUDA"))
    return {"result": out, "wall_seconds": wall, "busy_share": kernel_us / 1e6 / wall,
            "kernel_seconds": kernel_us / 1e6}


def run(machines: int = 512, tags: int = 10, rows: int = 576, device=None,
        out_dir: Optional[str] = None, profile: bool = True, warmup: int = 8) -> Dict[str, Any]:
    """Build the bench's project once (after a warm-up build of ``warmup``
    machines) and return its figures."""
    import torch

    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.device import resolve_device
    from gordo_tpu_torch.workflow.config import NormalizedConfig

    dev = resolve_device(device)
    root = out_dir or tempfile.mkdtemp(prefix="gordo-bench-")
    try:
        if warmup:
            warm = NormalizedConfig.from_source(project_config(warmup, tags, rows, seed=1), "bench")
            build_project(warm.machines, os.path.join(root, "warmup"), device=dev)
        t0 = time.time()
        config = NormalizedConfig.from_source(project_config(machines, tags, rows), "bench")
        config_seconds = time.time() - t0

        def build():
            return build_project(config.machines, os.path.join(root, "models"),
                                 model_register_dir=os.path.join(root, "registry"), device=dev)

        timed = busy_share(build, dev, profile)
        result = timed["result"]
        stages = dict(result.stage_seconds)
        stages["config"] += config_seconds  # YAML parse and normalization
        seconds = result.seconds + config_seconds
        return {
            "machines": machines, "tags": tags, "rows": rows,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "built": len(result.fleet_built) + len(result.single_built),
            "failed": len(result.failed),
            "seconds": seconds,
            "models_per_hour": (len(result.fleet_built) + len(result.single_built)) * 3600.0 / seconds,
            "stage_seconds": stages,
            "device_idle_seconds": result.device_idle_seconds,
            "busy_share": timed["busy_share"],
            "kernel_seconds": timed["kernel_seconds"],
            "profiled": bool(profile and dev.type == "cuda"),
        }
    finally:
        if out_dir is None:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m gordo_tpu_torch.bench", description=__doc__.split("\n")[0])
    parser.add_argument("--machines", type=int, default=512)
    parser.add_argument("--tags", type=int, default=10)
    parser.add_argument("--rows", type=int, default=576)
    parser.add_argument("--device", default=None, help="default: the current CUDA device; 'cpu' to run there")
    parser.add_argument("--out-dir", default=None, help="keep the artifacts here (default: a temporary dir)")
    parser.add_argument("--no-profile", action="store_true", help="skip torch.profiler (no busy share)")
    args = parser.parse_args(argv)
    out = run(args.machines, args.tags, args.rows, device=args.device, out_dir=args.out_dir,
              profile=not args.no_profile)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
