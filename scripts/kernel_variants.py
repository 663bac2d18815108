"""Time build variants of a kernel on the card.

    python3 scripts/kernel_variants.py KERNEL [VARIANT ...]

KERNEL is ``fleet_init`` or ``fake_quant``.  A variant is the kernel's
``csrc/<KERNEL>.cu`` built with some of its macros set on the ``nvcc``
command line, and its wrapper with some of its constants set
(``FLEET_INIT_VARIANTS``, ``FAKE_QUANT_VARIANTS`` below; ``kept`` is the
source and wrapper as they stand), built beside the kernels' own
libraries and launched through the wrapper (its library swapped for the
variant's) at the smoke's shapes:

- ``fleet_init`` (``chip_smoke._fleet_init_cases``): the bench's bucket
  with its values, and each of its permutation lengths alone; one seed of
  the bench's LSTM, its permutations and its values apart; a year's
  permutation; one value (the launch's fixed cost);
- ``fake_quant``: the stacked bf16 leaves of a 512-machine default bucket
  and of a 64-machine LSTM bucket (the shapes of
  ``chip_smoke.phase_precision_kernel_check``, random values), and one
  machine's f32 leaves, each set in one launch.

Each variant is first held to the plain version on every case
(``fleet_init``'s permutations and ``fake_quant``'s outputs bit for bit).
Prints one JSON line a variant: ptxas's registers and spills, and device
ms a case (CUDA events, ``chip_smoke.time_ms``), with the card's name and
power limit; first, for ``fleet_init``, the launch of an empty kernel
taking the argument struct's bytes and one taking an int.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from gordo_tpu_torch.device import resolve_device  # noqa: E402
from gordo_tpu_torch.kernels import build  # noqa: E402
from gordo_tpu_torch.kernels import fake_quant as fq  # noqa: E402
from gordo_tpu_torch.kernels import fleet_init as fi  # noqa: E402

#: name -> ({macro: value} for nvcc's -D, {wrapper constant: value})
FLEET_INIT_VARIANTS = {
    "kept": ({}, {}),
    # every launch in blocks of 512 threads (one an SM)
    "blocks_of_512": ({}, {"_WARP_LAUNCH_THREADS": 512}),
    # every launch in blocks of 256 threads (two an SM)
    "blocks_of_256": ({}, {"_THREADS": 256}),
    # every permutation of 256 keys or more a block's, however many
    "block_path_only": ({}, {"WARP_PATH_PERMS": 2 ** 31}),
    # clusters sized for 16,384 keys a block (four blocks at a year)
    "cluster_chunk_16384": ({}, {"CLUSTER_CHUNK_KEYS": 16384}),
}

#: as FLEET_INIT_VARIANTS, for csrc/fake_quant.cu
FAKE_QUANT_VARIANTS = {
    "kept": ({}, {}),
    # blocks of 1,024 threads (a big unit's eighth in half the steps)
    "threads_1024": ({"FQ_THREADS": 1024}, {}),
    # a cluster for every unit past 16,384 values (four times the kept)
    "big_16384": ({"FQ_BIG": 16384}, {"BIG": 16384}),
}

#: empty kernels, to time a launch alone: one taking the kernel's
#: argument struct by value (its size in bytes), one taking an int
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
struct Big { char bytes[%d]; };
__global__ void empty_big(const Big a) { if (a.bytes[0] == 123 && threadIdx.x == 9999) asm volatile("trap;"); }
__global__ void empty_small(int x) { if (x == 123 && threadIdx.x == 9999) asm volatile("trap;"); }
extern "C" int launch_big(void* stream) { Big a = {}; empty_big<<<1, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError(); }
extern "C" int launch_small(void* stream) { empty_small<<<1, 256, 0, (cudaStream_t)stream>>>(0);
  return (int)cudaGetLastError(); }
"""


def build_variant(kernel: str, name: str, defines: dict):
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(build.BUILD_DIR, f"{kernel}_variant_{name}.so")
    flags = [f"-D{k}={v}" for k, v in defines.items()]
    out = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-o", lib, build.source_path(kernel)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    return lib, out.stdout + out.stderr


def use(kernel: str, mod, path: str) -> None:
    lib = ctypes.CDLL(path)
    getattr(lib, f"{kernel}_launch").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    getattr(lib, f"{kernel}_launch").restype = ctypes.c_int
    getattr(lib, f"{kernel}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{kernel}_error_string").restype = ctypes.c_char_p
    mod._lib = lib


def fleet_init_cases():
    """name -> (run, held): ``run`` launches the case through the wrapper,
    ``held`` says whether its permutations are the plain version's."""
    (bucket, lstm, year, *_), _ = cs._fleet_init_cases()
    path = lambda leaves: [leaf for leaf in leaves if leaf.kind != fi.RAW]  # noqa: E731
    spec = {"bucket": (bucket[1], path(bucket[2]), bucket[3], bucket[4])}
    for n in bucket[3]:
        spec[f"bucket_perms_{n}"] = (bucket[1], [], [n], bucket[4])
    spec["lstm_seed"] = (lstm[1], path(lstm[2]), lstm[3], lstm[4])
    spec["lstm_perms"] = (lstm[1], [], lstm[3], lstm[4])
    spec["lstm_values"] = (lstm[1], path(lstm[2]), [], 0)
    spec["year"] = (year[1], [], year[3], year[4])
    spec["one_value"] = (lstm[1], [fi.Leaf(("dense_0",), (1, 1), fi.RAW)], [], 0)
    out = {}
    for case, (seeds_np, leaves, n_totals, epochs) in spec.items():
        seeds = torch.from_numpy(seeds_np.astype("int64")).cuda()
        run = lambda s=seeds, l=leaves, n=n_totals, e=epochs: fi.fleet_init(s, l, n, e)  # noqa: E731

        def held(s=seeds, l=leaves, n=n_totals, e=epochs, run=run):
            return all(torch.equal(g, r) for g, r in zip(run()[1], fi.fleet_init_reference(s, l, n, e)[1]))
        out[case] = (run, held)
    return out


def fake_quant_cases():
    """As :func:`fleet_init_cases`: each bucket's stacked bf16 leaves and
    one machine's f32 leaves, the outputs held bit for bit (NaN by
    place)."""
    rng = np.random.default_rng(cs.SEED)
    put = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()  # noqa: E731
    dims = cs.hourglass(10)
    default = [t for a, b in zip(dims[:-1], dims[1:]) for t in (put(512, a, b), put(512, b))]
    default += [put(512, 10) for _ in range(4)]
    ldims = list(cs._fleet_init_cases()[1])
    lstm, groups = [], []
    for n_in, h in zip(ldims[:-2], ldims[1:-1]):
        lstm += [put(64, n_in, 4 * h), put(64, h, 4 * h), put(64, 4 * h)]
        groups += [4, 4, 4]
    lstm += [put(64, ldims[-2], ldims[-1]), put(64, ldims[-1])] + [put(64, ldims[-1]) for _ in range(4)]
    groups += [1] * 6
    spec = {"default_bucket": ([t.bfloat16() for t in default], [1] * len(default)),
            "lstm_bucket": ([t.bfloat16() for t in lstm], groups),
            "default_machine_f32": ([t[:1].contiguous() for t in default], [1] * len(default))}
    out = {}
    for case, (leaves, g) in spec.items():
        run = lambda l=leaves, g=g: fq.fake_quant_many(l, g)  # noqa: E731

        def held(l=leaves, g=g, run=run):
            return all(torch.equal(a.view(torch.int16), fq.fake_quant_plain(t, k).view(torch.int16))
                       for a, t, k in zip(run(), l, g))
        out[case] = (run, held)
    return out


KERNELS = {"fleet_init": (fi, FLEET_INIT_VARIANTS, fleet_init_cases),
           "fake_quant": (fq, FAKE_QUANT_VARIANTS, fake_quant_cases)}


def main() -> None:
    resolve_device()
    kernel = sys.argv[1]
    mod, variants, make_cases = KERNELS[kernel]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    names = sys.argv[2:] or list(variants)
    todo = make_cases()
    kept = {k: getattr(mod, k) for _, constants in variants.values() for k in constants}
    if kernel == "fleet_init":
        print(json.dumps({"launch_floor_ms": launch_floor(), "card": card}), flush=True)
    for name in names:
        defines, constants = variants[name]
        lib, log = build_variant(kernel, name, defines)
        use(kernel, mod, lib)
        for k, v in {**kept, **constants}.items():
            setattr(mod, k, v)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        line = {"kernel": kernel, "variant": name, "card": card, "registers": regs, "spill_stores": spills,
                "ms": {}}
        for case, (run, held) in todo.items():
            cs.check(held(), f"{kernel} {name} {case}: bit for bit the plain version")
            line["ms"][case] = cs.time_ms(run, 20)[0]
        print(json.dumps(line), flush=True)


def launch_floor() -> dict:
    """Device ms a launch of an empty kernel taking ``fleet_init``'s
    argument struct's bytes, and one taking an int."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "launch_floor.cu")
    with open(cu, "w") as f:
        f.write(FLOOR_SOURCE % ctypes.sizeof(fi._Args))
    lib_path = cu[:-3] + ".so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib_path, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    out = {}
    for fn in ("launch_big", "launch_small"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        launch = lambda fn=fn: getattr(lib, fn)(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))  # noqa: E731
        out[fn] = cs.time_ms(launch, 20)[0]
    return out


if __name__ == "__main__":
    main()
