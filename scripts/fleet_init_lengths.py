"""Time long permutations through one tree's ``fleet_init`` on the card.

    python3 scripts/fleet_init_lengths.py TREE N [N ...]

``TREE`` is a checkout (the working tree, or a parent commit unpacked with
``git archive`` where ``.gitignore`` allows); its kernel is built from its
own sources.  For each N, one permutation of N items (seed 7, one epoch)
is held bit for bit to the tree's plain version, then timed (CUDA events,
the tree's ``chip_smoke.time_ms``, 20 calls) beside ``torch.randperm(N)``.
A length the tree's kernel refuses prints its error.  One JSON line a
length, with the card's name and power limit.  To compare two commits on
one card, run them in turns in one command.
"""

import json
import os
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gordo_tpu_torch.device import resolve_device  # noqa: E402
from gordo_tpu_torch.kernels import fleet_init as fi  # noqa: E402

resolve_device()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
seeds = torch.tensor([7], device="cuda")
for n in map(int, sys.argv[2:]):
    line = {"tree": os.path.basename(tree), "n": n, "card": card}
    run = lambda n=n: fi.fleet_init(seeds, [], [n], 1)  # noqa: E731
    try:
        got = run()[1][0]
    except NotImplementedError as exc:
        line["refused"] = str(exc)
    else:
        cs.check(torch.equal(got, fi.fleet_init_reference(seeds, [], [n], 1)[1][0]),
                 f"fleet_init of {n} items bit for bit the plain version")
        line["ms"] = cs.time_ms(run, 20)[0]
    line["randperm_ms"] = cs.time_ms(lambda n=n: torch.randperm(n, device="cuda"), 20)[0]
    print(json.dumps(line), flush=True)
