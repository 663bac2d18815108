"""Command line of the port (``python -m gordo_tpu_torch.cli <verb>``).

Counterpart of ``gordo_tpu/cli/cli.py`` on ``argparse``, with the verbs
``build`` (one machine, ``provide_saved_model``), ``build-project`` (a
project YAML through the fleet engine) and ``run-server``.  They read the
JAX package's environment variables (``MODEL_CONFIG``, ``DATA_CONFIG``,
``OUTPUT_DIR``, ``MACHINE_CONFIG``, ...) and run on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, List, Optional

import yaml


def _parse_config(value: Optional[str], name: str) -> Dict[str, Any]:
    """YAML/JSON text or a path to a YAML file → dict."""
    if not value:
        raise SystemExit(f"{name} is required (option or env var)")
    if os.path.exists(value):
        with open(value) as f:
            value = f.read()
    loaded = yaml.safe_load(value)
    if not isinstance(loaded, dict):
        raise SystemExit(f"{name} did not parse to a mapping")
    return loaded


def _device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="Torch device (default: the current CUDA device; 'cpu' runs the "
             "kernels' plain PyTorch versions).",
    )


def _add_build(verbs) -> None:
    env = os.environ.get
    build = verbs.add_parser("build", help="Build one machine's model into OUTPUT_DIR.")
    build.add_argument("output_dir", nargs="?", default=env("OUTPUT_DIR", "./models"))
    build.add_argument("--name", default=env("MACHINE_NAME", "machine"), help="Machine name.")
    build.add_argument("--model-config", default=env("MODEL_CONFIG"),
                       help="Model definition (YAML/JSON text or file; default: DEFAULT_MODEL).")
    build.add_argument("--data-config", default=env("DATA_CONFIG"),
                       help="Dataset config (YAML/JSON text or file).")
    build.add_argument("--metadata", default=env("METADATA", "{}"), help="User metadata (YAML/JSON).")
    build.add_argument("--evaluation-config", default=env("EVALUATION_CONFIG"),
                       help="Evaluation config, e.g. '{\"cv_mode\": \"full_build\"}'.")
    build.add_argument("--model-register-dir", default=env("MODEL_REGISTER_DIR"),
                       help="Config-hash cache registry dir; hits skip training.")
    build.add_argument("--print-cv-scores", action="store_true", help="Print CV scores to stdout.")
    _device_arg(build)

    project = verbs.add_parser(
        "build-project",
        help="Build every machine of a project YAML; homogeneous machines train as fleets.",
    )
    project.add_argument("--machine-config", default=env("MACHINE_CONFIG"),
                         required="MACHINE_CONFIG" not in os.environ,
                         help="Project YAML (text or file) with machines/globals.")
    project.add_argument("--project-name", default=env("PROJECT_NAME", "project"))
    project.add_argument("--output-dir", default=env("OUTPUT_DIR", "./models"))
    project.add_argument("--model-register-dir", default=env("MODEL_REGISTER_DIR"))
    project.add_argument("--max-bucket-size", type=int, default=None,
                         help="Machines per fleet chunk (default: 512 dense, 128 recurrent).")
    project.add_argument("--data-workers", type=int, default=None, help="Loader threads.")
    project.add_argument("--align-lengths", type=int, default=None,
                         help="Truncate each machine's rows down to a multiple of this.")
    project.add_argument("--pad-lengths", type=int, default=None,
                         help="Pad each machine's rows up to a multiple of this (weight-masked).")
    project.add_argument("--machines", dest="machines_filter", default=None,
                         help="Comma-separated machine names: build only these.")
    project.add_argument("--auto-pad", action=argparse.BooleanOptionalAction, default=True,
                         help="Turn on --pad-lengths where the JAX package's ragged-compile "
                              "estimate would.")
    project.add_argument("--artifact-format", choices=["v1", "v2"], default=None,
                         help="v1: one directory per machine (the port's layout); v2 waits "
                              "for ROADMAP queue 1 item 4c.")
    project.add_argument("--ingest", action=argparse.BooleanOptionalAction, default=None,
                         help="The fleet ingest plane (waits for ROADMAP queue 1 item 4b).")
    project.add_argument("--replace-cache", action="store_true")
    _device_arg(project)


def _build(args) -> None:
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.builder.build_model import provide_saved_model
    from gordo_tpu_torch.workflow.config import DEFAULT_MODEL

    model_cfg = _parse_config(args.model_config, "MODEL_CONFIG") if args.model_config else DEFAULT_MODEL
    data_cfg = _parse_config(args.data_config, "DATA_CONFIG")
    meta = _parse_config(args.metadata, "METADATA") if args.metadata else {}
    eval_cfg = (_parse_config(args.evaluation_config, "EVALUATION_CONFIG")
                if args.evaluation_config else None)
    path = provide_saved_model(
        args.name, model_cfg, data_cfg, metadata=meta, output_dir=args.output_dir,
        model_register_dir=args.model_register_dir, evaluation_config=eval_cfg,
        device=args.device,
    )
    if args.print_cv_scores:
        scores = serializer.load_metadata(path).get("model", {}).get("cross_validation", {})
        for metric, value in scores.get("scores", {}).items():
            print(f"{metric}: {value}")
    print(path)


def _build_project(args) -> None:
    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.workflow.config import NormalizedConfig

    config = NormalizedConfig.from_source(args.machine_config, args.project_name)
    machines = config.machines
    if args.machines_filter:
        wanted = {n.strip() for n in args.machines_filter.split(",") if n.strip()}
        machines = [m for m in machines if m.name in wanted]
        missing = wanted - {m.name for m in machines}
        if missing:
            raise SystemExit(f"--machines names not in the project: {sorted(missing)}")
    result = build_project(
        machines, args.output_dir, model_register_dir=args.model_register_dir,
        replace_cache=args.replace_cache, max_bucket_size=args.max_bucket_size,
        data_workers=args.data_workers, align_lengths=args.align_lengths,
        pad_lengths=args.pad_lengths, auto_pad=args.auto_pad,
        artifact_format=args.artifact_format, ingest=args.ingest, device=args.device,
    )
    print(json.dumps(result.summary()))
    if result.failed:
        sys.exit(1)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gordo_tpu_torch")
    verbs = parser.add_subparsers(dest="verb", required=True)
    _add_build(verbs)
    serve = verbs.add_parser(
        "run-server",
        help="Serve model(s) over the /gordo/v0/<project>/<machine>/ routes.",
    )
    serve.add_argument(
        "--model-dir", default=os.environ.get("MODEL_LOCATION"),
        required="MODEL_LOCATION" not in os.environ,
        help="One machine's artifact dir, or a project dir of them "
             "(default: $MODEL_LOCATION).",
    )
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=5555)
    serve.add_argument(
        "--project", default=os.environ.get("PROJECT_NAME", "project"),
        help="Project name in the route prefix (default: $PROJECT_NAME or 'project').",
    )
    _device_arg(serve)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.verb == "build":
        _build(args)
    elif args.verb == "build-project":
        _build_project(args)
    elif args.verb == "run-server":
        from gordo_tpu_torch.serve.server import run_server

        run_server(
            args.model_dir, host=args.host, port=args.port,
            project=args.project, device=args.device,
        )


if __name__ == "__main__":
    main()
