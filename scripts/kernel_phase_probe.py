"""Per-phase clocks of the port's kernels on the card.

    python3 scripts/kernel_phase_probe.py [stream_step] [fleet_fit] [fleet_score]
        [rolling_median] [lstm_head_fit] [cv_epilogue] [scaler_minmax]

A copy of each kernel's source reads ``%globaltimer`` at its phase
boundaries (thread 0; for ``fleet_fit`` thread 0 of the first block, one
of the longest fits; for ``fleet_score``'s row path thread 0 of every
block, once a tile) and adds each phase's nanoseconds to a device array.
The copies are built with ``nvcc`` beside the kernels' own libraries and
launched through the kernels' wrappers (the wrapper's library swapped for
the copy), at the smoke's shapes: a default detector and an LSTM head
streamed (one new row, and the full window), ``fleet_fit`` at
512 x 576 x 10, and ``fleet_score`` at the bench's bucket (512 x 2048 x
10, f32 and bf16, and the epilogue alone), each also with its tanh layers
made linear (``linear_acts``: other bits, the activations' share of the
time).  Prints one JSON line each: microseconds a launch (a stream step),
a step of the first block (``fleet_fit``) or a tile (``fleet_score``) by
phase.  ``rolling_median`` is clocked by lane 0 of every warp (its
phases summed over the warps, at the smoke's three shapes) and
``lstm_head_fit`` by thread 0 of every block (summed over the slots, at
the bench's lockstep step and at a batch of 256), each through the
shapes of ``scripts/kernel_variants.py``.  ``cv_epilogue`` and
``scaler_minmax`` keep a timeline instead: every block's ``%globaltimer``
at its start and at its phase boundaries (``cv_epilogue``'s warp path:
the staging barrier as each warp passes it, K4's mse and mae windows, the
maxima, the passes; the MinMax statistic: each segment reduced, the
block's end), printed as the spread of the blocks' starts (waves) and
each phase's mean and largest microseconds, at the cases of
``scripts/kernel_variants.py``.  The probes cost a few clock reads; read
the split, not the total.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
from gordo_tpu_torch.device import resolve_device  # noqa: E402
from gordo_tpu_torch.kernels import build  # noqa: E402
from gordo_tpu_torch.kernels import fleet_fit as ff  # noqa: E402
from gordo_tpu_torch.kernels import stream_step as sk  # noqa: E402

PROBE_DEFS = r"""
__device__ unsigned long long g_probe_acc[16];
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe_acc, sizeof(g_probe_acc)); }
extern "C" int probe_zero() { unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_probe_acc, z, sizeof(z)); }
"""


def clock(i: int, cond: str = "threadIdx.x == 0", atomic: bool = False) -> str:
    """CUDA source: add the time since the last clock to phase ``i`` (by an
    atomic add where many blocks clock at once)."""
    add = f"atomicAdd(&g_probe_acc[{i}], pt_ - probe_prev)" if atomic else f"g_probe_acc[{i}] += pt_ - probe_prev"
    return f"if ({cond}) {{ const unsigned long long pt_ = probe_now(); {add}; probe_prev = pt_; }}"


def _insert(src: str, anchor: str, text: str, after: bool = True) -> str:
    if src.count(anchor) < 1:
        raise SystemExit(f"anchor not found in the source: {anchor!r}")
    return src.replace(anchor, anchor + text if after else text + anchor, 1)


#: stream_step's phases: the ring shift; the stats, weights and carried
#: tags loaded; the newest row scored beside the older totals (or every
#: row, priming); the medians
STREAM_PHASES = ["shift", "loads", "score_and_totals", "median"]


def patch_stream(src: str) -> str:
    src = _insert(src, '#include "dense_rows.cuh"', "\n" + PROBE_DEFS)
    src = _insert(src, "  const int F = a.F;\n", "  unsigned long long probe_prev = probe_now();\n", after=False)
    src = _insert(src, "  __syncthreads();\n  if (a.x && threadIdx.x == 0) a.count[0] = s_count;",
                  "\n  " + clock(1))
    src = _insert(src, "    __syncthreads();  // stats, resident weights and the older tags in shared memory",
                  "\n    " + clock(2))
    src = _insert(src, "  __syncthreads();\n\n  // the masked nanmedian", "\n  " + clock(3), after=False)
    end = src.rindex("}", 0, src.index('extern "C" int stream_step_args_size()'))
    return src[:end] + "  __syncthreads();\n  " + clock(4) + "\n" + src[end:]


#: fleet_fit's phases a step: the pack barrier; thread 0's warp loading
#: its rows and running its forward pass; its loss and backward pass; the
#: wait for the other warps; the Adam step
FIT_PHASES = ["pack", "load_forward_warp0", "loss_backward_warp0", "wait_other_warps", "adam"]


def patch_fit(src: str) -> str:
    first = "blockIdx.x == 0 && threadIdx.x == 0"
    src = _insert(src, '#include "scaler_prefix.cuh"', "\n" + PROBE_DEFS)
    src = _insert(src, "  for (int e = 0; e < a.epochs; ++e) {\n    float epoch_acc",
                  "  unsigned long long probe_prev = probe_now();\n", after=False)
    src = _insert(src, "      __syncthreads();  // the last step's Adam done; the warps' weights visible",
                  "\n      " + clock(1, first))
    src = _insert(src, "      __syncwarp();\n\n      // the loss and the last layer's deltas",
                  "      " + clock(2, first) + "\n", after=False)
    src = _insert(src, "      __syncthreads();  // every warp's partial sums (or every layer's deltas)",
                  "      " + clock(3, first) + "\n", after=False)
    src = _insert(src, "      __syncthreads();  // every warp's partial sums (or every layer's deltas)",
                  "\n      " + clock(4, first))
    return _insert(src, "      if (t == 0) {\n        float batch = 0.f;", "      " + clock(5, first) + "\n",
                   after=False)


#: fleet_score's row-path phases a tile (a block walks a run of tiles):
#: the wait for its rows (the block's weights and stats too, before its
#: first tile) and the barrier; thread 0's row through the scaler steps,
#: the layers and the epilogue; the barrier; the staged stores
SCORE_PHASES = ["wait_rows", "score", "barrier", "stores"]


def patch_score(src: str, linear_acts: bool = False) -> str:
    src = _insert(src, '#include "spans.cuh"', "\n" + PROBE_DEFS)
    src = _insert(src, "  constexpr int S = FS_ROW_STRIDE;\n", "  unsigned long long probe_prev = probe_now();\n")
    src = _insert(src, "    __syncthreads();  // this tile's rows in; the last tile's stores done\n",
                  "    " + clock(1, atomic=True) + "\n")
    src = _insert(src, "    __syncthreads();\n    if (a.pred) walk_nt(rows, fo, tid, nt,", "    " + clock(2, atomic=True) + "\n",
                  after=False)
    src = _insert(src, "    if (a.pred) walk_nt(rows, fo, tid, nt,", "    " + clock(3, atomic=True) + "\n", after=False)
    src = _insert(src, "    if (det) store_span(a.tag + row_base * fo, ts, rows * fo, tid, nt);\n",
                  "    " + clock(4, atomic=True) + "\n")
    if linear_acts:
        tanh = "if (code == ACT_TANH) body([](float v) { return act_fn(ACT_TANH, v); });"
        src = _insert(src, tanh, "")  # checks the anchor
        src = src.replace(tanh, "if (code == ACT_TANH) body([](float v) { return v; });", 1)
    return src


#: rolling_median's phases a warp: its keys sorted and placed; the prefix
#: counts; its lanes' first rows (the walk from the first key); the rows
#: slid over; within the first, up to 512 keys (in registers): the keys
#: built, the network, the placing; and the block's rows staged (up to its
#: barrier), then the warp's work to its end
MEDIAN_PHASES = ["sort_place", "prefix", "first_row", "slid_rows", "keys", "network", "place",
                 "stage", "smooth"]


def patch_median(src: str) -> str:
    lane0 = "(threadIdx.x & 31) == 0"
    src = _insert(src, '#include "bitonic.cuh"', "\n" + PROBE_DEFS)
    src = _insert(src, "  const int lane = threadIdx.x & 31;\n  WarpArrays s;\n",
                  "  unsigned long long probe_prev = probe_now();\n")
    src = _insert(src, "  __syncwarp();\n  unsigned running = 0;\n", "  " + clock(1, lane0, True) + "\n", after=False)
    src = _insert(src, "  if (lane == 0) s.pre[P] = (unsigned short)running;\n  __syncwarp();\n",
                  "  " + clock(2, lane0, True) + "\n")
    src = _insert(src, "    const int j = lane * E + i;", "    if (i == 1) " + clock(3, lane0, True) + "\n", after=False)
    src = _insert(src, "      if (a.agg_thr) a.conf[row] = med / thr;\n    }\n  }\n", "  " + clock(4, lane0, True) + "\n")
    src = _insert(src, "  const int lane = threadIdx.x & 31;\n  uint64_t v[K];\n",
                  "  unsigned long long probe_prev = probe_now();\n")
    src = _insert(src, "  warp_sort<K>(v, 0);\n", "  " + clock(5, lane0, True) + "\n", after=False)
    src = _insert(src, "  warp_sort<K>(v, 0);\n", "  " + clock(6, lane0, True) + "\n")
    src = _insert(src, "  for (int r = 0; r < K; ++r) place(s, v[r], lane * K + r);\n", "  " + clock(7, lane0, True) + "\n")
    src = _insert(src, "  const int W = a.warps;\n", "  unsigned long long probe_prev = probe_now();\n")
    src = _insert(src, "  if (ch.c > a.f) return;  // the whole warp alike\n  float thr", "  " + clock(8, lane0, True) + "\n",
                  after=False)
    end = src.rindex("}", 0, src.index('extern "C" int rolling_median_args_size()'))
    return src[:end] + "  " + clock(9, lane0, True) + "\n" + src[end:]


#: lstm_head_fit's phases a block: W, h and the targets staged; the
#: predictions and dpred; dW, dh, db and the window losses; the slot's loss
HEAD_PHASES = ["stage", "forward", "gradients", "loss"]


def patch_head(src: str) -> str:
    src = _insert(src, '#include "copy_async.cuh"', "\n" + PROBE_DEFS)
    src = _insert(src, "  const int nthr = blockDim.x;\n", "  unsigned long long probe_prev = probe_now();\n")
    src = _insert(src, "  copy_async_wait<0>();\n  __syncthreads();\n", "  " + clock(1, atomic=True) + "\n")
    src = _insert(src, "  // db and each window's loss", "  " + clock(2, atomic=True) + "\n", after=False)
    src = _insert(src, "  if (tid == 0) {\n    float s = 0.f;", "  " + clock(3, atomic=True) + "\n", after=False)
    end = src.rindex("}", 0, src.index('extern "C" int lstm_head_fit_args_size()'))
    return src[:end] + "  " + clock(4, atomic=True) + "\n" + src[end:]


def build_probe(name: str, patch, tag: str = "") -> ctypes.CDLL:
    """The patched copy of ``csrc/<name>.cu`` built beside the kernels."""
    out = os.path.join(build.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{name}_probe{tag}.cu")
    with open(build.source_path(name)) as f:
        src = patch(f.read())
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(out, f"lib{name}_probe{tag}.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", lib_path, path]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stderr[-4000:])
    print(json.dumps({"probe_build": name + tag,
                      "ptxas": [ln for ln in r.stderr.splitlines() if "registers" in ln or "stack" in ln]}))
    lib = ctypes.CDLL(lib_path)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.probe_zero.argtypes = []
    return lib


def read_us(lib, launches: int, names) -> dict:
    """Microseconds a launch of each phase, since the last ``probe_zero``."""
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.probe_read(buf)
    return {nm: buf[i + 1] / launches / 1e3 for i, nm in enumerate(names)}


def probe_stream(reps: int = 200) -> None:
    lib = build_probe("stream_step", patch_stream)
    lib.stream_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.stream_step_launch.restype = ctypes.c_int
    lib.stream_step_error_string.argtypes = [ctypes.c_int]
    lib.stream_step_error_string.restype = ctypes.c_char_p
    sk._lib = lib
    rng = np.random.default_rng(7)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    W = cs.SMOOTH_WINDOW
    for kind in ("default", "lstm"):
        if kind == "default":
            src = cs.random_chain(rng, 1, 10)
            F, off, f_in = 10, 0, 10
            layers, acts = [(put(w), put(b)) for w, b in src["layers"]], src["acts"]
        else:
            src = cs.random_lstm(rng, 1, cs.LSTM_SHAPE[2])
            F, off, f_in = cs.LSTM_SHAPE[2], cs.LOOKBACK - 1, src["dims"][-1]
            layers, acts = [(put(src["head"][0]), put(src["head"][1]))], ["linear"]
        H = off + W
        det = cs.minmax_step(put(src["det_scale"]), put(src["det_offset"]))
        pipe = [cs.minmax_step(put(src["scale"]), put(src["offset"]))] if kind == "default" else None
        ring, out = put(rng.standard_normal((H, F))), torch.empty((H, F), device="cuda")
        row, count = put(rng.standard_normal(F)), torch.tensor([H], dtype=torch.int32, device="cuda")
        tags = [torch.rand((W, F), device="cuda") for _ in range(2)]
        h_full = torch.randn((W, f_in), device="cuda")
        for mode in ("carried", "full"):
            kw = dict(window=W, mode_offset=off, det=det, agg_thr=put(src["agg"]))
            if mode == "carried":
                kw.update(tags_in=tags[0], tags_out=tags[1])
            h = h_full[-1:] if mode == "carried" else h_full
            if kind == "default":
                def step():
                    sk.stream_step(ring, count, layers, acts, chain=pipe, x=row, ring_out=out, **kw)
            else:
                def step():
                    sk.stream_step(out, count, layers, acts, h=h, **kw)
            for _ in range(20):
                step()
            torch.cuda.synchronize()
            lib.probe_zero()
            for _ in range(reps):
                step()
            print(json.dumps({"probe": "stream_step", "kind": kind, "mode": mode,
                              "us": read_us(lib, reps, STREAM_PHASES)}), flush=True)


def probe_fit() -> None:
    from gordo_tpu_torch.parallel.fleet import fleet_draws, put_draws
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams

    lib = build_probe("fleet_fit", patch_fit)
    lib.fleet_fit_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fleet_fit_launch.restype = ctypes.c_int
    lib.fleet_fit_error_string.argtypes = [ctypes.c_int]
    lib.fleet_fit_error_string.restype = ctypes.c_char_p
    ff._lib = lib
    machines, rows, tags = cs.TRAIN_SHAPE
    X = torch.from_numpy(cs.bench_fleet(np.random.default_rng(5), machines, rows, tags)).cuda()
    cfg = TrainConfig()
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    fits = [ff.geometry(r, cfg.batch_size) for r in [tr for tr, _ in folds] + [np.arange(rows)]]
    dims = cs.hourglass(tags)
    acts = ["tanh"] * (len(dims) - 2) + ["linear"]
    params0, perms = put_draws(fleet_draws, 0, dims, fits, cfg.epochs, X.device)
    draw = np.zeros(machines, np.int64)

    def fit():
        return ff.fleet_fit(X, X, fits, params0, perms, draw, acts, cfg.epochs, adam_hparams(cfg))

    fit()
    torch.cuda.synchronize()
    lib.probe_zero()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = cfg.epochs * max(f.steps for f in fits)
    us = read_us(lib, 1, FIT_PHASES)
    print(json.dumps({"probe": "fleet_fit", "block0_steps": steps, "us_total": us,
                      "us_per_step": {k: v / steps for k, v in us.items()}, "launch_wall_ms": wall * 1e3}),
          flush=True)


def probe_score(reps: int = 20) -> None:
    from gordo_tpu_torch.kernels import fleet_score as fs

    machines, n, tags = cs.KERNEL_SHAPES[0]
    rng = np.random.default_rng(cs.SEED)
    dev = cs.to_device(cs.random_chain(rng, machines, tags), "cuda")
    x = torch.from_numpy(rng.standard_normal((machines, n, tags)).astype(np.float32)).cuda()
    bf = torch.bfloat16
    (form, s, o), (dform, ds, do) = dev["kw"]["chain"][0], dev["kw"]["det"]
    cases = {
        "bucket": (x, dev["layers"], dev["acts"], dev["kw"]),
        "bucket_bf16": (x.to(bf), [(W.to(bf), b.to(bf)) for W, b in dev["layers"]], dev["acts"],
                        dict(chain=[(form, s.to(bf), o.to(bf))], det=(dform, ds.to(bf), do.to(bf)),
                             agg_thr=dev["kw"]["agg_thr"])),
        "epilogue": (x, [], [], dict(det=dev["kw"]["det"], agg_thr=dev["kw"]["agg_thr"], y=x + 0.05)),
    }
    for linear in (False, True):
        lib = build_probe("fleet_score", lambda src: patch_score(src, linear), "_linear" if linear else "")
        lib.fleet_score_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fleet_score_launch.restype = ctypes.c_int
        lib.fleet_score_error_string.argtypes = [ctypes.c_int]
        lib.fleet_score_error_string.restype = ctypes.c_char_p
        fs._lib = lib
        for case, (xc, layers, acts, kw) in cases.items():
            if linear and not layers:
                continue
            run = lambda: fs.fleet_score(xc, layers, acts, **kw)  # noqa: E731
            plan = fs.launch_plan([tags] + [int(W.shape[2]) for W, _ in layers], machines, n,
                                  torch.cuda.get_device_properties(0).multi_processor_count)
            tiles = machines * -(-n // plan.rows_per_block)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            lib.probe_zero()
            for _ in range(reps):
                run()
            print(json.dumps({"probe": "fleet_score", "case": case, "linear_acts": linear,
                              "rows_per_block": plan.rows_per_block, "blocks_per_slot": plan.blocks_per_slot,
                              "us_per_tile": read_us(lib, reps * tiles, SCORE_PHASES),
                              "ms": cs.time_ms(run, 20)[0]}), flush=True)
    fs._lib = None


def _use(mod, name: str, lib) -> None:
    getattr(lib, f"{name}_launch").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    getattr(lib, f"{name}_launch").restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    mod._lib = lib


def probe_cases(name: str, mod, patch, phases, units, reps: int = 10) -> None:
    """Each case of ``kernel_variants``' for the kernel, through the probed
    copy: microseconds by phase summed over the clocking threads, and per
    ``units(case)`` (warps or blocks) of a launch."""
    import kernel_variants as kv

    lib = build_probe(name, patch)
    _use(mod, name, lib)
    for case, (run, held) in kv.KERNELS[name][2]().items():
        cs.check(held(), f"{name} probe {case}: held to the plain version")
        run()
        torch.cuda.synchronize()
        lib.probe_zero()
        for _ in range(reps):
            run()
        us = read_us(lib, reps, phases)
        n = units(case)
        print(json.dumps({"probe": name, "case": case, "units": n, "us_summed": us,
                          "us_per_unit": {k: v / n for k, v in us.items()}, "ms": cs.time_ms(run, 20)[0]}),
              flush=True)
    mod._lib = None


def probe_median() -> None:
    from gordo_tpu_torch.kernels import rolling_median as rm

    lm, ln, lf = cs.LSTM_SHAPE
    shapes = {"lstm_bucket": ((lm, ln - cs.LOOKBACK + 1, lf), cs.SMOOTH_WINDOW),
              "default_bucket": (cs.MEDIAN_DEFAULT_SHAPE, cs.SMOOTH_WINDOW),
              "longest_window": ((cs.MEDIAN_LONGEST_SLOTS, ln - cs.LOOKBACK + 1, lf), rm.MAX_WINDOW)}

    def warps(case):
        (m, n, f), w = shapes[case]
        plan = rm.launch_plan(n, f + 1, w)
        return m * plan.chunks * (f + 1)
    probe_cases("rolling_median", rm, patch_median, MEDIAN_PHASES, warps)


def probe_head() -> None:
    from gordo_tpu_torch.kernels import lstm_head_fit as hf

    probe_cases("lstm_head_fit", hf, patch_head, HEAD_PHASES, {"bench_step": 256, "batch_256": 16}.get)


#: a block's timeline: up to 8 clocks at its marks
TIMELINE_DEFS = r"""
#define PROBE_MARKS 8
__device__ unsigned long long* g_probe_times;
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ size_t probe_block() {
  return ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; }
extern "C" int probe_set(unsigned long long* p) {
  return (int)cudaMemcpyToSymbol(g_probe_times, &p, sizeof(p)); }
extern "C" int probe_read(unsigned long long*) { return 0; }
extern "C" int probe_zero() { return 0; }
"""


def mark(k: int, cond: str) -> str:
    return f"if ({cond}) g_probe_times[probe_block() * PROBE_MARKS + {k}] = probe_now();"


#: cv_epilogue's warp path: the marks and the phases between them
EPILOGUE_MARKS = {"start": 0, "staged_w0": 1, "staged_w1": 2, "windows_end": 3, "maxima_end": 4, "passes_end": 5}
EPILOGUE_PHASES = {"stage": ("start", "staged_w1"), "windows": ("staged_w1", "windows_end"),
                   "maxima": ("windows_end", "maxima_end"), "passes": ("staged_w0", "passes_end")}


def patch_epilogue(src: str) -> str:
    src = _insert(src, '#include "xla_order.cuh"\n', TIMELINE_DEFS)
    src = _insert(src, "  const int slot = blockIdx.x;\n  const int t = threadIdx.x;\n  const int fo = a.fo, nt = a.nt;\n",
                  "  " + mark(0, "t == 0") + "\n")
    src = _insert(src, "  __syncthreads();  // the one barrier: every copy visible to both warps\n",
                  "  " + mark(1, "t == 0") + "\n  " + mark(2, "t == 32") + "\n")
    src = _insert(src, "    cw_maxima<MASKED>(tg, to, n, fo, a.window, lane,", "    " + mark(3, "t == 32") + "\n",
                  after=False)
    src = _insert(src, "a.total_max + slot);\n", "    " + mark(4, "t == 32") + "\n")
    src = _insert(src, "    cw_passes<MASKED>(ys, ps, n, fo, l1, lo, lane, per, out);\n", "    " + mark(5, "t == 0") + "\n")
    return src


#: the MinMax statistic: the block's start, its first five segments reduced,
#: its end
MINMAX_MARKS = {"start": 0, **{f"segment_{k}": 1 + k for k in range(5)}, "end": 7}


def patch_minmax(src: str) -> str:
    src = _insert(src, '#include "xla_order.cuh"\n', TIMELINE_DEFS)
    src = _insert(src, "  __shared__ int s_last;\n  const int t = threadIdx.x;\n", "  " + mark(0, "t == 0") + "\n")
    src = _insert(src, "      mm_reduce<V>(a, lo, hi, mm_keys + 2 * k * cw);\n",
                  "      if (k < 5) { " + mark("1 + k", "t == 0") + " }\n")
    src = _insert(src, "  if (PATH != MM_SPLIT) return;\n", "  " + mark(7, "t == 0") + "\n", after=False)
    return src


def probe_timeline(name: str, source: str, mod, patch, marks: dict, phases: dict, blocks) -> None:
    """Each case of ``kernel_variants``' for ``name`` through the patched
    copy of ``csrc/<source>.cu``: one launch's block timeline."""
    import kernel_variants as kv

    lib = build_probe(source, patch)
    lib.probe_set.argtypes = [ctypes.c_void_p]
    _use(mod, source, lib)
    inv = {v: k for k, v in marks.items()}
    for case, (run, held) in kv.KERNELS[name][2]().items():
        n_blocks = blocks(case)
        times = torch.zeros(n_blocks * 8, dtype=torch.int64, device="cuda")
        lib.probe_set(times.data_ptr())  # before any launch of the patched copy
        cs.check(held(), f"{name} probe {case}: held to the plain version")
        times.zero_()
        run()
        torch.cuda.synchronize()
        t = times.view(n_blocks, 8).cpu().numpy().astype(np.float64)
        seen = t[:, 0] > 0
        t, t0 = t[seen], t[seen, 0].min()
        at = {inv[k]: (t[:, k] - t0) / 1e3 for k in inv if (t[:, k] > 0).any()}
        starts = at["start"]
        line = {"probe": name, "case": case, "blocks": int(seen.sum()),
                "start_us_quantiles": [float(np.quantile(starts, q)) for q in (0, 0.25, 0.5, 0.75, 0.9, 1)],
                "end_us": float(max(v.max() for v in at.values())), "phases_us": {}}
        if phases:
            for ph, (a, b) in phases.items():
                if a in at and b in at:
                    d = at[b] - at[a]
                    line["phases_us"][ph] = {"mean": float(d.mean()), "max": float(d.max())}
        else:
            order = sorted(at, key=marks.get)
            for a, b in zip(order, order[1:]):
                d = at[b] - at[a]
                line["phases_us"][f"{a}..{b}"] = {"mean": float(d.mean()), "max": float(d.max())}
        line["ms"] = cs.time_ms(run, 20)[0]
        print(json.dumps(line), flush=True)
    mod._lib = None


def probe_epilogue() -> None:
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    import kernel_variants as kv

    probe_timeline("cv_epilogue", "cv_epilogue", ce, patch_epilogue, EPILOGUE_MARKS, EPILOGUE_PHASES,
                   lambda case: kv.EPILOGUE_SHAPES[case][0])


def probe_minmax() -> None:
    from gordo_tpu_torch.kernels import scaler_stats as ss
    import kernel_variants as kv

    inputs = kv.minmax_inputs()

    def blocks(case):
        x, lists, prefix = inputs[case]
        g = ss.launch_plan(x.shape, lists, len(prefix)).grid
        return g[0] * g[1] * g[2]
    probe_timeline("scaler_minmax", "scaler_stats", ss, patch_minmax, MINMAX_MARKS, {}, blocks)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phase_probe: needs a CUDA card", file=sys.stderr)
        return 1
    resolve_device()
    probes = {"stream_step": probe_stream, "fleet_fit": probe_fit, "fleet_score": probe_score,
              "rolling_median": probe_median, "lstm_head_fit": probe_head,
              "cv_epilogue": probe_epilogue, "scaler_minmax": probe_minmax}
    for name in sys.argv[1:] or list(probes):
        probes[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
