"""Time build variants of a kernel on the card.

    python3 scripts/kernel_variants.py KERNEL [VARIANT ...]

KERNEL is ``fleet_init``, ``fake_quant``, ``fleet_score``,
``chain_apply``, ``rolling_median``, ``lstm_head_fit``, ``cv_epilogue``
or ``scaler_minmax`` (``csrc/scaler_stats.cu``'s MinMax statistic).  A variant is the kernel's ``csrc/<KERNEL>.cu`` built
with some of its macros set on the ``nvcc`` command line, and its wrapper
with some of its constants set (``FLEET_INIT_VARIANTS``,
``FAKE_QUANT_VARIANTS``, ``FLEET_SCORE_VARIANTS``,
``CHAIN_APPLY_VARIANTS``, ``ROLLING_MEDIAN_VARIANTS``,
``HEAD_FIT_VARIANTS`` below; ``kept`` is the source and wrapper as
they stand), built beside the kernels' own libraries and launched
through the wrapper (its library swapped for the variant's) at the
smoke's shapes:

- ``fleet_init`` (``chip_smoke._fleet_init_cases``): the bench's bucket
  with its values, and each of its permutation lengths alone; one seed of
  the bench's LSTM, its permutations and its values apart; a year's
  permutation; one value (the launch's fixed cost);
- ``fake_quant``: the stacked bf16 leaves of a 512-machine default bucket
  and of a 64-machine LSTM bucket (the shapes of
  ``chip_smoke.phase_precision_kernel_check``, random values), and one
  machine's f32 leaves, each set in one launch;
- ``fleet_score``: the bench's bucket (512 × 2048 × 10, f32 and bf16),
  the 128-tag hourglass (1 × 4096 × 128), the LSTM head (64 × 4085 × 42
  → 50) and the epilogue alone at 512 × 2048 × 10;
- ``chain_apply``: chain C stacked at 512 × 2048 × 10 (f32 and bf16
  rows), the stacked Standard inverse there, chain A at 576 × 10;
- ``rolling_median``: the LSTM bucket (64 × 4085 × 50 + the total) and the
  stacked default bucket (512 × 2048 × 10 + the total) over 144 rows, and
  8 slots of the LSTM bucket over ``MAX_WINDOW`` rows, NaN holes as in
  ``chip_smoke.with_holes``;
- ``lstm_head_fit``: the bench's lockstep step (256 slots × 64 windows,
  42 -> 50), 16 slots at 256 windows, and ``chip_smoke.HEAD_FIRST_LAYOUT``
  (the plan's unpadded layout), on random minibatches;
- ``cv_epilogue``: K4 and K8 (row counts 0..144) at the build bench's
  1,536 slots × 144 × 10 (the warp path), and K4 at the LSTM builds'
  192 × 133 × 50 (the block path), held bit for bit;
- ``scaler_minmax``: the build bench's 512 × 576 × 10 over its 4 nested
  row lists, plain and NaN-padded (the nested path), after a Standard step
  and over index lists (the list path), a year and 2 × 57,344 rows over
  uneven lists (the split path), held bit for bit.

Each variant is first held to the plain version on every case
(``fleet_init``'s permutations and ``fake_quant``'s outputs bit for bit;
``fleet_score``'s, ``chain_apply``'s, ``rolling_median``'s and
``lstm_head_fit``'s within the smoke's tolerances,
with a hash of each output, ``chip_smoke.output_hashes``, so that two
variants' bits compare).  Prints one JSON line a variant: ptxas's
registers and spills, and device ms a case (CUDA events,
``chip_smoke.time_ms``), with the card's name and power limit; first, for
``fleet_init``, the launch of an empty kernel taking the argument
struct's bytes and one taking an int.
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
from gordo_tpu_torch.kernels import chain_apply as ca  # noqa: E402
from gordo_tpu_torch.kernels import cv_epilogue as ce  # noqa: E402
from gordo_tpu_torch.kernels import fake_quant as fq  # noqa: E402
from gordo_tpu_torch.kernels import fleet_init as fi  # noqa: E402
from gordo_tpu_torch.kernels import fleet_score as fs  # noqa: E402
from gordo_tpu_torch.kernels import lstm_head_fit as hf  # noqa: E402
from gordo_tpu_torch.kernels import rolling_median as rm  # noqa: E402
from gordo_tpu_torch.kernels import scaler_stats as ss  # noqa: E402

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

#: as FLEET_INIT_VARIANTS, for csrc/fleet_score.cu
FLEET_SCORE_VARIANTS = {
    "kept": ({}, {}),
    # the tile path in blocks of 128 threads (one item a thread at the
    # 128-tag shape's widest layers)
    "tile_threads_128": ({"FS_TILE_THREADS": 128}, {}),
    # the tile path's tiles kept at 32 rows or more (128 blocks at 1 x
    # 4096 x 128, one an SM)
    "tile_rows_32": ({}, {"TILE_MIN_ROWS": 32}),
    # the row path in tiles of 512 rows (256 threads), and of 128 (64)
    "row_tile_512": ({}, {"ROW_TILE": 512}),
    "row_tile_128": ({}, {"ROW_TILE": 128}),
    # the row path's grid at 4 and at 16 blocks an SM (longer and shorter
    # runs of tiles a block)
    "row_blocks_4": ({}, {"ROW_BLOCKS_PER_SM": 4}),
    "row_blocks_16": ({}, {"ROW_BLOCKS_PER_SM": 16}),
}

#: as FLEET_INIT_VARIANTS, for csrc/chain_apply.cu
CHAIN_APPLY_VARIANTS = {
    "kept": ({}, {}),
    # the elementwise path with two 16-byte loads in flight a thread
    "ew_batch_2": ({"CA_EW_BATCH": 2}, {"EW_TILE_VALUES": 2 * 4 * ca.THREADS}),
    # the elementwise path's tiles of about 16,384 values (four batches)
    "ew_tile_16384": ({}, {"EW_TILE_VALUES": 16384}),
    # the row path in tiles of 256 rows
    "rows_256": ({}, {"ROW_THREADS_MAX": 256}),
    # the row path's ring of raw tiles two deep (one in flight), and four
    "row_stages_2": ({"CA_ROW_STAGES": 2}, {}),
    "row_stages_4": ({"CA_ROW_STAGES": 4}, {}),
    # the row path's grid at 4 and at 16 blocks an SM
    "row_blocks_4": ({}, {"ROW_BLOCKS_PER_SM": 4}),
    "row_blocks_16": ({}, {"ROW_BLOCKS_PER_SM": 16}),
}

#: as FLEET_INIT_VARIANTS, for csrc/rolling_median.cu
ROLLING_MEDIAN_VARIANTS = {
    "kept": ({}, {}),
    # blocks of at most 8 and 2 warps (series)
    "warps_8": ({"RM_MAX_THREADS": 256}, {"MAX_WARPS": 8}),
    "warps_2": ({}, {"MAX_WARPS": 2}),
    # the register path's registers capped for 8 blocks of 128 threads an
    # SM (64 a thread)
    "regs_64": ({"RM_MIN_BLOCKS": 8}, {}),
    # at least 4 rows a lane (2,048 keys, 7 rows a lane at the longest
    # window)
    "lane_rows_4": ({}, {"LANE_ROWS_MIN": 4}),
}

#: as FLEET_INIT_VARIANTS, for csrc/lstm_head_fit.cu
HEAD_FIT_VARIANTS = {
    "kept": ({}, {}),
    # blocks of 128 and of 512 threads
    "threads_128": ({"HF_THREADS": 128}, {}),
    "threads_512": ({"HF_THREADS": 512}, {}),
}

#: as FLEET_INIT_VARIANTS, for csrc/cv_epilogue.cu (its cases timed as the
#: source stands)
EPILOGUE_VARIANTS = {"kept": ({}, {})}

#: as FLEET_INIT_VARIANTS, for csrc/scaler_stats.cu's MinMax statistic
MINMAX_VARIANTS = {
    "kept": ({}, {}),
    # the nested and list paths' float4 loads in blocks of 64 and of 256
    # threads (the kept 128)
    "range_threads_64": ({}, {"RANGE_THREADS": 64}),
    "range_threads_256": ({}, {"RANGE_THREADS": 256}),
    # the split path's blocks of about 16,384 and 2,048 values
    "split_16384": ({}, {"SPLIT_VALUES": 16384}),
    "split_2048": ({}, {"SPLIT_VALUES": 2048}),
}

#: cv_epilogue's cases: (slots, rows, tags, masked)
EPILOGUE_SHAPES = {"k4_bench": (1536, 144, 10, False), "k8_bench": (1536, 144, 10, True),
                   "k4_block_path": (192, 133, 50, False)}

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


def _held_within(run, plain, tol: float, rows=None):
    """``held`` for a kernel whose outputs the smoke holds within ``tol``
    of the plain version (each slot's first ``rows[s]`` rows where given),
    the kernel's output hashes kept in ``hashes``."""
    hashes = {}

    def held():
        got, ref = run(), plain()
        got = got if isinstance(got, dict) else {"out": got}
        ref = ref if isinstance(ref, dict) else {"out": ref}
        hashes.update(cs.output_hashes(got, rows))
        for k in ref:
            g, r = got[k].float(), ref[k].float()
            if rows is not None:
                g = torch.cat([g[i, :c] for i, c in enumerate(rows)])
                r = torch.cat([r[i, :c] for i, c in enumerate(rows)])
            if cs._masked_err(r, g, k)[0] > tol:
                return False
        return True
    held.hashes = hashes
    return held


def fleet_score_cases():
    """As :func:`fleet_init_cases`, each output held within the smoke's
    tolerance of the plain version."""
    rng = np.random.default_rng(cs.SEED)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    out = {}
    for label, (machines, n, tags) in zip(("bucket", "wide"), cs.KERNEL_SHAPES):
        dev = cs.to_device(cs.random_chain(rng, machines, tags), "cuda")
        x = torch.randn((machines, n, tags), generator=gen, device="cuda")
        run = lambda x=x, d=dev: fs.fleet_score(x, d["layers"], d["acts"], **d["kw"])  # noqa: E731
        plain = lambda x=x, d=dev: fs.fleet_score_plain(x, d["layers"], d["acts"], **d["kw"])  # noqa: E731
        out[label] = (run, _held_within(run, plain, cs.TOLERANCE))
        if label == "bucket":
            bf = torch.bfloat16
            layers = [(W.to(bf), b.to(bf)) for W, b in dev["layers"]]
            (form, s, o), (dform, ds, do) = dev["kw"]["chain"][0], dev["kw"]["det"]
            kw = dict(chain=[(form, s.to(bf), o.to(bf))], det=(dform, ds.to(bf), do.to(bf)), agg_thr=dev["kw"]["agg_thr"])
            xb = x.to(bf)
            run = lambda xb=xb, l=layers, kw=kw, a=dev["acts"]: fs.fleet_score(xb, l, a, **kw)  # noqa: E731
            plain = lambda xb=xb, l=layers, kw=kw, a=dev["acts"]: fs.fleet_score_plain(xb, l, a, **kw)  # noqa: E731
            out["bucket_bf16"] = (run, _held_within(run, plain, cs.TOLERANCE))
            y = x + 0.05 * torch.randn(x.shape, generator=gen, device="cuda")
            ekw = dict(det=dev["kw"]["det"], agg_thr=dev["kw"]["agg_thr"], y=y)
            run = lambda x=x, ekw=ekw: fs.fleet_score(x, [], [], **ekw)  # noqa: E731
            plain = lambda x=x, ekw=ekw: fs.fleet_score_plain(x, [], [], **ekw)  # noqa: E731
            out["epilogue"] = (run, _held_within(run, plain, cs.TOLERANCE))
    machines, n, tags = cs.LSTM_SHAPE
    nw, hidden = n - cs.LOOKBACK + 1, 42  # the lstm_hourglass's last layer at 50 tags
    put = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()  # noqa: E731
    h, W, b = put(machines, nw, hidden), put(machines, hidden, tags) / hidden ** 0.5, put(machines, tags)
    det = cs.minmax_step(put(machines, tags).abs() + 0.5, put(machines, tags))
    y = put(machines, n, tags)
    run = lambda: fs.fleet_score(h, [(W, b)], ["linear"], det=det, y=y, y_offset=cs.LOOKBACK - 1)  # noqa: E731
    plain = lambda: fs.fleet_score_plain(h, [(W, b)], ["linear"], det=det, y=y, y_offset=cs.LOOKBACK - 1)  # noqa: E731
    out["lstm_head"] = (run, _held_within(run, plain, cs.TOLERANCE))
    return out


def chain_apply_cases():
    """As :func:`fleet_score_cases`, for ``chain_apply``."""
    rng = np.random.default_rng(cs.SEED)
    M, n, F = cs.TRANSFORM_SERVE_SHAPE
    src = cs.random_chain_c(rng, M, F, cs.CHAIN_C_K)
    x = torch.from_numpy(cs.request_rows(rng, M, n, F)).cuda()
    f32 = cs.chain_c_steps(src, "cuda")
    bf = torch.bfloat16
    bf16 = [ca.Step(s.form, s.a.to(bf), None if s.b is None else s.b.to(bf), stacked=True) for s in f32]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    inverse = [ca.Step(ca.AFFINE, put(rng.uniform(0.5, 2, (M, F))), put(rng.standard_normal((M, F))), stacked=True)]
    rows, tags = cs.TRANSFORM_SHAPES[0]
    xa = put(cs.bench_fleet(rng, 1, rows, tags)[0])
    chain_a = [ca.Step(ca.IMPUTE, put(src["fill"][0])), ca.func_step(ca.MUL, 2.0),
               ca.Step(ca.PCA, put(src["mean"][0]), put(src["components"][0].T)),
               ca.Step(ca.AFFINE, put(src["pca_scale"][0]), put(src["pca_offset"][0]))]
    spec = {"chain_c": (x, f32), "chain_c_bf16": (x.to(bf), bf16), "standard_inverse": (x, inverse),
            "chain_a": (xa, chain_a)}
    out = {}
    for case, (rows_in, steps) in spec.items():
        run = lambda r=rows_in, s=steps: ca.chain_apply(r, s)  # noqa: E731
        plain = lambda r=rows_in, s=steps: ca.chain_apply_plain(r, s)  # noqa: E731
        out[case] = (run, _held_within(run, plain, cs.TRANSFORM_TOLERANCE["chain_apply"]))
    return out


def rolling_median_cases():
    """As :func:`fleet_score_cases`, for ``rolling_median`` (held exactly,
    NaN by place)."""
    rng = np.random.default_rng(cs.SEED)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    lm, ln, lf = cs.LSTM_SHAPE
    lstm = (lm, ln - cs.LOOKBACK + 1, lf)
    out = {}
    for case, (m, n, f), window in (("lstm_bucket", lstm, cs.SMOOTH_WINDOW),
                                    ("default_bucket", cs.MEDIAN_DEFAULT_SHAPE, cs.SMOOTH_WINDOW),
                                    ("longest_window", (cs.MEDIAN_LONGEST_SLOTS, *lstm[1:]), rm.MAX_WINDOW)):
        tag = put(np.abs(rng.standard_normal((m, n, f))))
        total = tag.square().mean(-1).sqrt()
        cs.with_holes(rng, tag)
        thr = put(rng.uniform(0.5, 2.0, m))
        run = lambda t=tag, s=total, h=thr, w=window: rm.rolling_median(t, s, w, agg_thr=h)  # noqa: E731
        ref = rm.rolling_median_plain(tag, total, window, agg_thr=thr)  # once: slow at the longest window
        out[case] = (run, _held_within(run, lambda ref=ref: ref, cs.LSTM_TOLERANCE["rolling_median"]))
    return out


def lstm_head_fit_cases():
    """As :func:`fleet_score_cases`, for ``lstm_head_fit`` on random
    minibatches (a tenth of the slots without a real window), ``dh`` held
    over the real windows."""
    rng = np.random.default_rng(cs.SEED)
    out = {}
    for case, shape in (("bench_step", (256, 64, 42, 50)), ("batch_256", (16, 256, 42, 50)),
                        ("first_layout", cs.HEAD_FIRST_LAYOUT)):
        h, W, b, y, batch, n_real = cs.random_head_step(rng, *shape, "cuda")
        kw = dict(batch=batch, shift=cs.LOOKBACK - 1, act="linear")

        def outputs(res, n_real=n_real):
            got = dict(zip(("loss", "dW", "db", "dh"), res))
            got["dh"] = torch.cat([got["dh"][s, :c] for s, c in enumerate(n_real)])  # real windows only
            return got
        run = lambda h=h, W=W, b=b, y=y, kw=kw: hf.lstm_head_fit(h, W, b, y, **kw)  # noqa: E731
        ref = outputs(hf.lstm_head_fit_plain(h, W, b, y, **kw))
        held = _held_within(lambda run=run, outputs=outputs: outputs(run()), lambda ref=ref: ref,
                            cs.LSTM_TRAIN_TOLERANCE["lstm_head_fit"])
        out[case] = (run, held)
    return out


def _held_bits(run, plain):
    """``held`` for a kernel held bit for bit to its plain version, its
    output hashes kept in ``hashes``."""
    hashes = {}

    def held():
        got, ref = run(), plain()
        got = got if isinstance(got, dict) else dict(enumerate(got))
        ref = ref if isinstance(ref, dict) else dict(enumerate(ref))
        hashes.update({str(k): cs.output_hash(v) for k, v in got.items()})
        return all(cs.differing(ref[k], got[k]) == 0 for k in ref)
    held.hashes = hashes
    return held


def cv_epilogue_cases():
    """As :func:`fleet_init_cases`, for ``cv_epilogue`` (K4 and K8)."""
    rng = np.random.default_rng(cs.SEED)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    out = {}
    for case, (S, nt, tags, masked) in EPILOGUE_SHAPES.items():
        y = put(rng.standard_normal((S, nt, tags)) + 3.0)
        pred = put(y.cpu().numpy() + 0.3 * rng.standard_normal((S, nt, tags)))
        tag = (pred - y).abs().contiguous()
        total = tag.norm(dim=-1).contiguous()
        counts = rng.integers(0, nt + 1, S) if masked else None
        args = (tag, total, pred, y, counts)
        run = lambda args=args, m=masked: ce.cv_epilogue(*args, masked=m)  # noqa: E731
        plain = lambda args=args, m=masked: ce.cv_epilogue_plain(*args, masked=m)  # noqa: E731
        out[case] = (run, _held_bits(run, plain))
    return out


def minmax_inputs():
    """The MinMax cases' ``(x, row lists, prefix)``."""
    from gordo_tpu_torch.train.cv import TimeSeriesSplit

    rng = np.random.default_rng(cs.SEED)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    machines, rows, tags = cs.TRAIN_SHAPE
    lists = [tr for tr, _ in TimeSeriesSplit(3).split(np.empty((rows, 1)))] + [np.arange(rows)]
    X = cs.bench_fleet(rng, machines, rows, tags)
    Xn = X.copy()
    for i, n in enumerate(cs.ragged_lengths(rows, machines, cs.RAGGED_SPREAD)):
        Xn[i, n:] = np.nan
    X, Xn = put(X), put(Xn)
    mean, std = ss.scaler_stats(X, lists, stat="standard")
    longest = 57_344
    uneven = [np.arange(longest), np.arange(31_337), np.sort(rng.permutation(longest)[:45_001]), np.arange(8_193)]
    picked = [np.sort(rng.permutation(rows)[: rows // 2 + 12]), np.arange(rows // 6, 2 * rows // 3), np.arange(rows)]
    return {"bench": (X, lists, ()), "nan_padded": (Xn, lists, ()), "after_standard": (X, lists, [(ss.CENTER, mean, std)]),
            "index_lists": (Xn, picked, ()), "year": (put(cs.bench_fleet(rng, 1, cs.SCALER_YEAR, tags)),
                                                      [np.arange(cs.SCALER_YEAR)], ()),
            "max_rows": (put(cs.bench_fleet(rng, 2, longest, tags)), uneven, ())}


def scaler_minmax_cases():
    """As :func:`fleet_init_cases`, for the MinMax statistic."""
    out = {}
    for case, (x, lists, prefix) in minmax_inputs().items():
        run = lambda x=x, l=lists, p=prefix: ss.scaler_stats(x, l, prefix=p, offset_fma=True)  # noqa: E731
        plain = lambda x=x, l=lists, p=prefix: ss.scaler_stats_plain(x, l, prefix=p, offset_fma=True)  # noqa: E731
        out[case] = (run, _held_bits(run, plain))
    return out


KERNELS = {"fleet_init": (fi, FLEET_INIT_VARIANTS, fleet_init_cases),
           "fake_quant": (fq, FAKE_QUANT_VARIANTS, fake_quant_cases),
           "fleet_score": (fs, FLEET_SCORE_VARIANTS, fleet_score_cases),
           "chain_apply": (ca, CHAIN_APPLY_VARIANTS, chain_apply_cases),
           "rolling_median": (rm, ROLLING_MEDIAN_VARIANTS, rolling_median_cases),
           "lstm_head_fit": (hf, HEAD_FIT_VARIANTS, lstm_head_fit_cases),
           "cv_epilogue": (ce, EPILOGUE_VARIANTS, cv_epilogue_cases),
           "scaler_minmax": (ss, MINMAX_VARIANTS, scaler_minmax_cases)}
#: the CUDA source of each kernel where it is not ``csrc/<KERNEL>.cu``
SOURCES = {"scaler_minmax": "scaler_stats"}


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
    source = SOURCES.get(kernel, kernel)
    for name in names:
        defines, constants = variants[name]
        lib, log = build_variant(source, name, defines)
        use(source, mod, lib)
        for k, v in {**kept, **constants}.items():
            setattr(mod, k, v)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        line = {"kernel": kernel, "variant": name, "card": card, "registers": regs, "spill_stores": spills,
                "ms": {}, "hashes": {}}
        for case, (run, held) in todo.items():
            cs.check(held(), f"{kernel} {name} {case}: held to the plain version")
            line["ms"][case] = cs.time_ms(run, 20)[0]
            if hasattr(held, "hashes"):
                line["hashes"][case] = dict(held.hashes)
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
