"""Command line of the port (``python -m gordo_tpu_torch.cli <verb>``).

Counterpart of ``gordo_tpu/cli/cli.py`` on ``argparse``; this slice has
the ``run-server`` verb.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gordo_tpu_torch")
    verbs = parser.add_subparsers(dest="verb", required=True)
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
    serve.add_argument(
        "--device", default=None,
        help="Torch device to score on (default: the current CUDA device; "
             "'cpu' runs the kernels' plain PyTorch versions).",
    )
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.verb == "run-server":
        from gordo_tpu_torch.serve.server import run_server

        run_server(
            args.model_dir, host=args.host, port=args.port,
            project=args.project, device=args.device,
        )


if __name__ == "__main__":
    main()
