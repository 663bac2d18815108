"""Run chosen ``chip_smoke.py`` phases from one tree of the repository.

    python3 scripts/chip_phases.py TREE PHASE[,PHASE...] [--smoke SMOKE_TREE]

``TREE`` is a checkout (the working tree, or a parent commit unpacked with
``git archive`` where ``.gitignore`` allows); its kernels are built from
its own sources and its own ``chip_smoke.py`` runs each ``phase_<name>``.
With ``--smoke``, the phases are ``SMOKE_TREE``'s ``chip_smoke.py`` run
over ``TREE``'s package: one set of phases, with one set of seeded inputs
and of printed output hashes, over the kernels of two trees.
One JSON line a phase: the tree, the phase, whether it passed, its
seconds and what it returned.  To compare two commits on one card, run
them in turns in one command (parent, change, change, parent).
"""

import importlib.util
import json
import os
import sys
import time
import traceback

argv = sys.argv[1:]
smoke_tree = None
if "--smoke" in argv:
    at = argv.index("--smoke")
    smoke_tree = os.path.abspath(argv[at + 1])
    del argv[at: at + 2]
tree, phases = os.path.abspath(argv[0]), argv[1].split(",")
os.chdir(tree)
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(smoke_tree or tree, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
from gordo_tpu_torch.device import resolve_device  # noqa: E402

resolve_device()
label = os.path.basename(tree.rstrip("/"))
t0 = time.perf_counter()
cs.phase_build()
print(json.dumps({"tree": label, "phase": "build", "seconds": time.perf_counter() - t0}), flush=True)
for ph in phases:
    t0 = time.perf_counter()
    try:
        out, ok = getattr(cs, "phase_" + ph)(), True
    except Exception as exc:  # the other phases and trees still run
        traceback.print_exc()
        out, ok = {"error": repr(exc)}, False
    print(json.dumps({"tree": label, "phase": ph, "ok": ok, "seconds": time.perf_counter() - t0,
                      "out": out}, default=str), flush=True)
