#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gordo_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and ``nvcc``; it builds every kernel from ``gordo_tpu_torch/csrc``
itself.  Phases, each printing one JSON line:

1. ``device``: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (that line is also printed raw).
2. ``build``: seconds to build the kernels, and ptxas's register and
   spill report.
3. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, at the shapes below, with the tolerance stated; kernel and plain
   device times from CUDA events (``time_ms``), the host time to enqueue
   one call, and the bound.
4. ``serve``: the port's serving entry points on the card.  A model
   directory of 8 default detectors at 10 tags and one at 128 tags (random
   weights from a seed) is served by ``ThreadingHTTPServer``; every route
   is called, each response is held to the plain version, one response to
   a float64 numpy reference, and the kernels' launch counts (set to 0
   just before) must show that every scoring request went through them.
5. ``train_kernel_check``: the training kernels (``scaler_stats``,
   ``fleet_fit``, ``cv_epilogue``) against their plain versions on the
   card, at the bench shape (512 machines × 576 rows × 10 tags, the
   default ``TrainConfig``), each kernel fed what the one before it made,
   as the build does; times as in phase 3 (the plain versions, thousands
   of small launches, are timed by CUDA events around whole calls, host
   gaps included), and each bound.
6. ``train``: ``FleetDiffBuilder.build`` builds 512 default detectors on
   the card (wall seconds, models/h), the launch counts (set to 0 just
   before) showing that every fit, stat and epilogue went through the
   kernels; 8 of the machines are built again on the CPU (plain versions)
   and their thresholds and CV scores compared; 8 of the card's detectors
   are dumped and served through the HTTP server for one bulk request,
   held to the plain scorer on the CPU.

Then the ``kernels`` summary line and, last, ``{"ok": true, "device":
{...}}``.  Any failure raises and exits non-zero without a result; so does
a run without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the phases run: always the card when the script runs; an importer
#: may set "cpu" to rehearse the phases' logic (no timing, no build)
DEVICE = "cuda"
SEED = 20261017
#: max |kernel - plain| / max |plain| per output series (fp32; the two sum
#: the dense layers in different orders)
TOLERANCE = 1e-5
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: (machines, rows, tags) the fleet_score check runs at: a bucket of the
#: build bench's 512 machines at 2048 rows each, and one 128-tag machine
KERNEL_SHAPES = [(512, 2048, 10), (1, 4096, 128)]
OUTPUTS = ("model-output", "tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")
#: the build bench's fleet (bench.py:47,273): 512 machines, 4 days at
#: 10-minute resolution (576 rows), 10 tags
TRAIN_SHAPE = (512, 576, 10)
#: machines of the build that are built again on the CPU, and served
CPU_MACHINES = 8
#: training kernel against its plain version, max |kernel - plain| /
#: max |plain| per output (measured on an H100 80GB HBM3 at 700 W, values
#: in PERF.md): the stats are exact (a min and a max, the same
#: roundings; measured 0); a fit sums each gradient over rows in another
#: order, and 10 to 30 dependent Adam steps divide by sqrt(nu), which
#: amplifies that where gradients are small (measured 2.9e-6 on params,
#: 1.5e-7 on the loss history); the epilogue's means are float32 sums in
#: another order (measured 2.4e-7)
TRAIN_TOLERANCE = {"scaler_stats": 1e-6, "fleet_fit": 1e-4, "fleet_fit_history": 1e-5,
                   "cv_epilogue": 1e-5}
#: the card's build against the CPU's, per machine: the fits' differences
#: above carried through out-of-fold scoring into thresholds (measured
#: 2.1e-7) and CV scores (measured <= 1.0e-6; explained variance, a small
#: difference of near-equal numbers, 1.9e-6)
BUILD_TOLERANCE = {"thresholds": 1e-4, "explained_variance_score": 1e-3, "r2_score": 1e-3,
                   "mean_squared_error": 1e-4, "mean_absolute_error": 1e-4}
#: the reference default model, in the JAX package's paths
DEFAULT_MODEL = {
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            "gordo_tpu.ops.scalers.MinMaxScaler",
            {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}},
        ]}}
    }
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def hourglass(tags: int):
    from gordo_tpu_torch.models.factories.utils import hourglass_calc_dims

    enc = hourglass_calc_dims(0.5, 3, tags)
    return [tags] + enc + enc[::-1] + [tags]


def random_chain(rng: np.random.Generator, machines: int, tags: int):
    """Stacked numpy arrays of ``machines`` default detectors: lecun-normal
    kernels (in, out), small biases, MinMax stats and thresholds."""
    dims = hourglass(tags)
    layers = []
    for i in range(len(dims) - 1):
        W = rng.standard_normal((machines, dims[i], dims[i + 1])) / math.sqrt(dims[i])
        b = 0.1 * rng.standard_normal((machines, dims[i + 1]))
        layers.append((W.astype(np.float32), b.astype(np.float32)))
    def minmax():
        lo = rng.uniform(-3, -1, (machines, tags))
        hi = rng.uniform(1, 3, (machines, tags))
        scale = 1.0 / (hi - lo)
        return scale.astype(np.float32), (-lo * scale).astype(np.float32)
    scale, offset = minmax()
    det_scale, det_offset = minmax()
    return {
        "dims": dims,
        "layers": layers,
        "acts": ["tanh"] * (len(dims) - 2) + ["linear"],
        "scale": scale,
        "offset": offset,
        "det_scale": det_scale,
        "det_offset": det_offset,
        "feature_thresholds": rng.uniform(0.05, 0.5, (machines, tags)).astype(np.float32),
        "agg": rng.uniform(0.2, 1.0, machines).astype(np.float32),
    }


def to_device(chain, device):
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(
        layers=[(put(W), put(b)) for W, b in chain["layers"]],
        acts=chain["acts"],
        kw=dict(
            scale=put(chain["scale"]), offset=put(chain["offset"]),
            det_scale=put(chain["det_scale"]), det_offset=put(chain["det_offset"]),
            agg_thr=put(chain["agg"]),
        ),
    )


def norm_err(ref, got) -> float:
    ref = ref.double()
    return float((ref - got.double()).abs().max() / ref.abs().max().clamp_min(1e-30))


def compare(ref: dict, got: dict, rows=None):
    """Per-output max normalised error and max absolute error (over the
    valid rows of each slot when ``rows`` is given)."""
    errs, abs_err = {}, 0.0
    for k in OUTPUTS:
        r, g = ref[k], got[k]
        if rows is not None:
            r = torch.cat([r[i, : rows[i]] for i in range(len(rows))])
            g = torch.cat([g[i, : rows[i]] for i in range(len(rows))])
        check(bool(g.isfinite().all()), f"{k} is finite")
        errs[k] = norm_err(r, g)
        abs_err = max(abs_err, float((r.double() - g.double()).abs().max()))
    return errs, abs_err


def time_ms(fn, reps: int):
    """``(device ms, host ms)`` per call of ``fn``.

    The device time comes from CUDA events around ``reps`` calls that the
    host enqueues while the card sleeps, so the card runs them back to
    back and host overhead between launches is not timed; the host time
    is the wall time of enqueueing one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # sleep for 3x the measured enqueue time, at up to 2 GHz
    torch.cuda._sleep(int(3 * reps * host_s * 2e9))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    check(enqueue_s < 3 * reps * host_s,
          f"the timed launches were enqueued while the card slept ({enqueue_s:.6f} s "
          f"to enqueue {reps} calls, sleep sized for {3 * reps * host_s:.6f} s)")
    return device_ms, host_s * 1e3


def time_calls_ms(fn, reps: int):
    """``(device ms, host ms)`` per call of a function that launches many
    small kernels (a plain version): CUDA events around ``reps`` whole
    calls after one warm-up, so the device time includes the gaps in which
    the card waits for the host."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, (time.perf_counter() - t0) * 1e3 / reps


def bound(nbytes: float, ops: float):
    """Least time for ``nbytes`` of device memory traffic and ``ops`` fp32
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "flops": ops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fleet_score_bound(m: int, n: int, dims, machines: int):
    """Least time for one fleet_score call: each input byte read once,
    each output byte written once, and the dense layers' FLOPs."""
    f = dims[0]
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    in_floats = m * n * f + machines * (weights + 4 * f + 1)
    out_floats = m * n * (2 * dims[-1] + 2)
    nbytes = 4 * (in_floats + out_floats)
    flops = 2 * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1)) * m * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {
        "bytes": nbytes,
        "flops": flops,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name


def phase_build():
    from gordo_tpu_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build("fleet_score", "fleet_fit", "scaler_stats", "cv_epilogue")
    seconds = time.perf_counter() - t0
    ptxas = []
    for p in paths:
        with open(p + ".log") as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def phase_kernel_check():
    from gordo_tpu_torch.kernels import fleet_score as fs

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    shapes = []
    for machines, n, tags in KERNEL_SHAPES:
        chain = random_chain(rng, machines, tags)
        dev = to_device(chain, DEVICE)
        x = torch.randn((machines, n, tags), generator=gen, device=DEVICE)
        run = lambda: fs.fleet_score(x, dev["layers"], dev["acts"], **dev["kw"])  # noqa: E731
        plain = lambda: fs.fleet_score_plain(x, dev["layers"], dev["acts"], **dev["kw"])  # noqa: E731
        got = run()
        ref = plain()
        errs, abs_err = compare(ref, got)
        check(all(e <= TOLERANCE for e in errs.values()),
              f"fleet_score at {machines}x{n}x{tags} within {TOLERANCE}: {errs}")
        entry = {"shape": [machines, n, tags], "max_norm_err": errs, "max_abs_err": abs_err}
        if machines > 1:
            # a subset of the bucket by stack position, with ragged rows
            m_sub = machines // 8
            idx = np.sort(rng.choice(machines, m_sub, replace=False))[::-1].copy()
            rows = rng.integers(1, n + 1, m_sub)
            xs = torch.randn((m_sub, n, tags), generator=gen, device=DEVICE)
            got_s = fs.fleet_score(xs, dev["layers"], dev["acts"], idx=idx, n_rows=rows, **dev["kw"])
            ref_s = fs.fleet_score_plain(xs, dev["layers"], dev["acts"], idx=idx, n_rows=rows, **dev["kw"])
            errs_s, abs_s = compare(ref_s, got_s, rows)
            check(all(e <= TOLERANCE for e in errs_s.values()),
                  f"fleet_score subset of {m_sub} within {TOLERANCE}: {errs_s}")
            entry["subset"] = {"machines": m_sub, "max_norm_err": errs_s, "max_abs_err": abs_s}
            entry["max_abs_err"] = max(abs_err, abs_s)
        # the plain version is ~30 launches a call: few calls, so that the
        # launches queued behind the sleep stay within the card's queue
        entry["ms"], entry["host_ms"] = time_ms(run, 20 if machines > 1 else 100)
        entry["plain_ms"], entry["plain_host_ms"] = time_ms(plain, 5)
        entry.update(fleet_score_bound(machines, n, chain["dims"], machines))
        shapes.append(entry)
        del x, got, ref, dev
        torch.cuda.empty_cache()
    emit({"phase": "kernel_check", "kernel": "fleet_score", "tolerance": TOLERANCE, "shapes": shapes})
    return shapes


def _request(url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def numpy_reference(chain, i: int, X: np.ndarray) -> dict:
    """Float64 numpy evaluation of machine ``i``'s chain, independent of torch."""
    X = X.astype(np.float64)
    h = X * chain["scale"][i] + chain["offset"][i]
    for (W, b), act in zip(chain["layers"], chain["acts"]):
        h = h @ W[i].astype(np.float64) + b[i]
        h = np.tanh(h) if act == "tanh" else h
    ds, do = chain["det_scale"][i], chain["det_offset"][i]
    tag = np.abs((h * ds + do) - (X * ds + do))
    total = np.sqrt((tag * tag).sum(-1))
    return {"model-output": h, "tag-anomaly-scores": tag, "total-anomaly-score": total,
            "anomaly-confidence": total / max(float(chain["agg"][i]), 1e-12)}


def phase_serve():
    from gordo_tpu_torch import convert, serializer
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.serve.server import ModelCollection, make_server

    definition = DEFAULT_MODEL
    rng = np.random.default_rng(SEED + 1)
    groups = {10: (8, 2048), 128: (1, 512)}  # tags: (machines, request rows)
    machines = {}  # name -> (chain, index in chain, rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        model_dir = os.path.join(tmp, "models")
        for tags, (count, rows) in groups.items():
            chain = random_chain(rng, count, tags)
            for i in range(count):
                params = {
                    (f"dense_{l}" if l < len(chain["layers"]) - 1 else "out"):
                        {"kernel": W[i], "bias": b[i]}
                    for l, (W, b) in enumerate(chain["layers"])
                }
                model = convert.from_reference(
                    definition, params,
                    scaler_stats=[{"scale": chain["scale"][i], "offset": chain["offset"][i]}],
                    detector_stats={"scale": chain["det_scale"][i], "offset": chain["det_offset"][i]},
                    feature_thresholds=chain["feature_thresholds"][i],
                    aggregate_threshold=float(chain["agg"][i]),
                )
                name = f"m{tags}-{i}"
                meta = {"dataset": {"tag_list": [f"{name}-tag-{j}" for j in range(tags)]}}
                serializer.dump(model, os.path.join(model_dir, name), metadata=meta)
                machines[name] = (chain, i, rows)
        collection = ModelCollection.from_directory(
            model_dir, project="smoke", device=None if DEVICE == "cuda" else DEVICE
        )
        check(collection.device.type == DEVICE, f"collection on {DEVICE}, got {collection.device}")
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke"
        inputs = {
            name: rng.standard_normal((rows, chain["dims"][0])).astype(np.float32)
            for name, (chain, _, rows) in machines.items()
        }
        fs.launches = 0
        scoring, latencies, worst = 0, [], {}
        try:
            for name, X in inputs.items():
                status, body = _request(f"{base}/{name}/healthcheck")
                check(status == 200, f"healthcheck {name}: {status} {body}")
                status, body = _request(f"{base}/{name}/metadata")
                check(status == 200 and body["endpoint-metadata"]["model-name"] == name,
                      f"metadata {name}: {status}")
                for route in ("prediction", "anomaly/prediction"):
                    t0 = time.perf_counter()
                    status, body = _request(f"{base}/{name}/{route}", {"X": X.tolist()})
                    latencies.append(time.perf_counter() - t0)
                    scoring += 1
                    check(status == 200, f"{route} {name}: {status} {body}")
                    worst_route = _hold_to_plain(machines[name], X, body["data"], fs)
                    for k, v in worst_route.items():
                        worst[k] = max(worst.get(k, 0.0), v)
            t0 = time.perf_counter()
            status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                    {"X": {n: X.tolist() for n, X in inputs.items()}})
            latencies.append(time.perf_counter() - t0)
            scoring += 1
            check(status == 200, f"bulk: {status} {body}")
            for name, X in inputs.items():
                for k, v in _hold_to_plain(machines[name], X, body["data"][name], fs).items():
                    worst[k] = max(worst.get(k, 0.0), v)
            status, body = _request(f"{base}/no-such-machine/healthcheck")
            check(status == 404, f"unknown machine gives 404, got {status}")
            launches = fs.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
        # per-machine routes launch once per request, the bulk route once
        # per bucket (two here)
        expected = 2 * len(inputs) + len(groups)
        check(launches == expected,
              f"fleet_score launched {launches} times for {scoring} scoring requests, expected {expected}")
        check(all(v <= TOLERANCE for v in worst.values()), f"served values within {TOLERANCE}: {worst}")
    return {
        "machines": {str(t): c for t, (c, _) in groups.items()},
        "scoring_requests": scoring,
        "launches": launches,
        "max_norm_err_vs_plain": worst,
        "request_seconds_p50": float(np.median(latencies)),
    }


def _hold_to_plain(machine, X: np.ndarray, data: dict, fs) -> dict:
    """Max normalised error of one served response against the plain
    version on the card, and of its first rows against float64 numpy."""
    chain, i, _ = machine
    one = {k: chain[k][i:i + 1] for k in ("scale", "offset", "det_scale", "det_offset", "agg")}
    one["layers"] = [(W[i:i + 1], b[i:i + 1]) for W, b in chain["layers"]]
    one["acts"] = chain["acts"]
    dev = to_device(one, DEVICE)
    x = torch.from_numpy(X[None]).to(DEVICE)
    ref = fs.fleet_score_plain(x, dev["layers"], dev["acts"], **dev["kw"])
    errs = {}
    for k in OUTPUTS:
        if k not in data:
            continue
        got = torch.tensor(data[k], dtype=torch.float64)
        check(tuple(got.shape) == tuple(ref[k][0].shape),
              f"{k} shape {tuple(got.shape)} != {tuple(ref[k][0].shape)}")
        check(bool(got.isfinite().all()), f"{k} finite")
        errs[k] = norm_err(ref[k][0].cpu(), got)
    ref64 = numpy_reference(chain, i, X[:16])
    for k in errs:
        got = np.asarray(data[k], np.float64)[:16]
        err = np.abs(ref64[k] - got).max() / max(np.abs(ref64[k]).max(), 1e-30)
        errs[k] = max(errs[k], float(err))
    return errs


def bench_fleet(rng: np.random.Generator, machines: int, rows: int, tags: int):
    """Each machine's tags: a mixture of two shared-frequency sine latents
    plus noise, as the bench's random dataset makes them."""
    t = np.arange(rows)[None, :, None]
    freqs = rng.uniform(0.01, 0.1, (machines, 1, 2))
    phases = rng.uniform(0, 2 * np.pi, (machines, 1, 2))
    latents = np.sin(freqs * t + phases)
    mix = rng.uniform(-1, 1, (machines, 2, tags))
    X = latents @ mix + 0.05 * rng.standard_normal((machines, rows, tags))
    return X.astype(np.float32)


def fleet_fit_bound(fits, dims, machines: int, rows: int, epochs: int):
    """Least time for one fleet_fit call: each input (rows, targets,
    permutations, stats, initial params) read once, each output written
    once; per real row visit the forward pass, the backward deltas and the
    weight gradients, per step one Adam update of every parameter."""
    f = dims[0]
    weights = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    n_params = weights + sum(dims[1:])
    delta_weights = weights - dims[0] * dims[1]
    row_visits = machines * epochs * sum(fg.n for fg in fits)
    steps = machines * epochs * sum(fg.steps for fg in fits)
    ops = row_visits * 2 * (2 * weights + delta_weights) + steps * 12 * n_params
    g = len(fits)
    nbytes = 4 * (2 * machines * rows * f + epochs * sum(fg.n_total for fg in fits)
                  + sum(fg.n for fg in fits) + 2 * machines * g * f + n_params
                  + machines * g * (n_params + epochs))
    return bound(nbytes, ops)


def phase_train_kernel_check():
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.parallel.fleet import fleet_draws, put_draws
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams

    machines, rows, tags = TRAIN_SHAPE
    X = torch.from_numpy(bench_fleet(np.random.default_rng(SEED + 2), machines, rows, tags)).to(DEVICE)
    cfg = TrainConfig()
    hp = adam_hparams(cfg)
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    row_lists = [tr for tr, _ in folds] + [np.arange(rows)]
    fits = [ff.geometry(r, cfg.batch_size) for r in row_lists]
    dims = hourglass(tags)
    acts = ["tanh"] * (len(dims) - 2) + ["linear"]
    entries = {}

    def record(name, run, plain, reps, plain_reps, errs, abs_err, bound_info, tol):
        check(all(v <= tol[k] for k, v in errs.items()), f"{name} within {tol}: {errs}")
        entry = {"max_norm_err": errs, "max_abs_err": abs_err, "tolerance": tol}
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, reps)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, plain_reps)
        entry.update(bound_info)
        entries[name] = entry

    def errors(pairs):
        errs, worst = {}, 0.0
        for key, (ref, got) in pairs.items():
            check(bool(got.isfinite().all()), f"{key} is finite")
            errs[key] = norm_err(ref, got)
            worst = max(worst, float((ref.double() - got.double()).abs().max()))
        return errs, worst

    # K3: every fit's pipeline stats, and the detector's on the targets
    run = lambda: ss.scaler_stats(X, row_lists)  # noqa: E731
    plain = lambda: ss.scaler_stats_plain(X, row_lists)  # noqa: E731
    (scale, offset), (scale_p, offset_p) = run(), plain()
    errs, abs_err = errors({"scale": (scale_p, scale), "offset": (offset_p, offset)})
    visits = machines * sum(len(r) for r in row_lists) * tags
    record("scaler_stats", run, plain, 20, 5, errs, abs_err,
           bound(4 * (machines * rows * tags + sum(len(r) for r in row_lists)
                      + 2 * machines * len(row_lists) * tags), 2 * visits),
           {k: TRAIN_TOLERANCE["scaler_stats"] for k in errs})

    # K1 + K2: the three fold fits and the final fit of every machine
    params0, perms = put_draws(fleet_draws, 0, dims, fits, cfg.epochs, X.device)
    draw = np.zeros(machines, np.int64)
    args = (X, X, fits, scale, offset, params0, perms, draw, acts, cfg.epochs, hp)
    run = lambda: ff.fleet_fit(*args)  # noqa: E731
    plain = lambda: ff.fleet_fit_plain(*args)  # noqa: E731
    (layers, hist), (layers_p, hist_p) = run(), plain()
    pairs = {f"layer{i}.{k}": (p, g) for i, ((gw, gb), (pw, pb)) in enumerate(zip(layers, layers_p))
             for k, p, g in (("kernel", pw, gw), ("bias", pb, gb))}
    pairs["history"] = (hist_p, hist)
    errs, abs_err = errors(pairs)
    tol = {k: TRAIN_TOLERANCE["fleet_fit_history" if k == "history" else "fleet_fit"] for k in errs}
    record("fleet_fit", run, plain, 3, 2, errs, abs_err,
           fleet_fit_bound(fits, dims, machines, rows, cfg.epochs), tol)

    # out-of-fold scoring (K5, checked in phase 3) feeds K4
    K, G = len(folds), len(fits)
    te = torch.from_numpy(np.concatenate([t for _, t in folds])).to(X.device)
    nt = len(folds[0][1])
    x_oof = X.index_select(1, te).reshape(machines * K, nt, tags)
    flat = [(W.reshape(machines * G, *W.shape[2:]), b.reshape(machines * G, -1)) for W, b in layers]
    det_s, det_o = ss.scaler_stats(X, [np.arange(rows)])
    expand = lambda t: t.expand(machines, G, tags).reshape(machines * G, tags)  # noqa: E731
    scored = fs.fleet_score(
        x_oof, flat, acts, scale=scale.reshape(machines * G, tags), offset=offset.reshape(machines * G, tags),
        det_scale=expand(det_s), det_offset=expand(det_o),
        idx=(np.arange(machines)[:, None] * G + np.arange(K)).reshape(-1), y=x_oof,
    )
    epi_args = (scored["tag-anomaly-scores"], scored["total-anomaly-score"], scored["model-output"], x_oof)
    run = lambda: ce.cv_epilogue(*epi_args)  # noqa: E731
    plain = lambda: ce.cv_epilogue_plain(*epi_args)  # noqa: E731
    got, ref = run(), plain()
    errs, abs_err = errors({k: (ref[k], got[k]) for k in ref})
    elems = machines * K * nt * tags
    record("cv_epilogue", run, plain, 20, 5, errs, abs_err,
           bound(4 * (3 * elems + machines * K * nt + machines * K * (tags + 5)),
                 elems * (ce.SMOOTHING_WINDOW + 12) + machines * K * nt * ce.SMOOTHING_WINDOW),
           {k: TRAIN_TOLERANCE["cv_epilogue"] for k in errs})
    emit({"phase": "train_kernel_check", "shape": list(TRAIN_SHAPE), "kernels": entries})
    del X, layers, layers_p, scored, x_oof
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def phase_train():
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.serve.server import ModelCollection, make_server

    machines, rows, tags = TRAIN_SHAPE
    Xs = list(bench_fleet(np.random.default_rng(SEED + 3), machines, rows, tags))
    spec = analyze_definition(from_definition(DEFAULT_MODEL))
    check(spec is not None, "the default model is fleetable")
    builder = FleetDiffBuilder(spec, device=None if DEVICE == "cuda" else DEVICE)
    counters = (ff, ss, ce, fs)
    for mod in counters:
        mod.launches = 0
    t0 = time.perf_counter()
    pending = builder.dispatch(Xs)
    dispatch_seconds = time.perf_counter() - t0
    detectors = pending.collect()
    seconds = time.perf_counter() - t0
    launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in counters}
    if DEVICE == "cuda":
        # one length group: 1 fit launch, 2 stats (pipeline, detector), 1
        # out-of-fold scoring, 1 epilogue
        expected = {"fleet_fit": 1, "scaler_stats": 2, "cv_epilogue": 1, "fleet_score": 1}
        check(launches == expected, f"build launches {launches}, expected {expected}")
    check(len(detectors) == machines, f"{len(detectors)} detectors built")
    for det in detectors:
        check(np.isfinite(det.feature_thresholds_).all() and np.isfinite(det.aggregate_threshold_),
              "thresholds finite")
        check(det.feature_thresholds_.shape == (tags,), "one threshold per tag")

    # the first machines again, on the CPU
    cpu = FleetDiffBuilder(spec, device="cpu").build(Xs[:CPU_MACHINES])
    worst = {}
    for a, b in zip(cpu, detectors):
        pairs = {"thresholds": (np.append(a.feature_thresholds_, a.aggregate_threshold_),
                                np.append(b.feature_thresholds_, b.aggregate_threshold_))}
        for name, v in a.cv_metadata_["scores"].items():
            pairs[name] = (np.asarray(v["folds"]), np.asarray(b.cv_metadata_["scores"][name]["folds"]))
        for key, (ref, got) in pairs.items():
            err = float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))
            worst[key] = max(worst.get(key, 0.0), err)
    for key, err in worst.items():
        check(err <= BUILD_TOLERANCE[key], f"card vs CPU build {key}: {err} > {BUILD_TOLERANCE[key]}")

    # serve some of the card's detectors
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        names = [f"built-{i}" for i in range(CPU_MACHINES)]
        for i, name in enumerate(names):
            meta = {"dataset": {"tag_list": [f"{name}-tag-{j}" for j in range(tags)]}}
            serializer.dump(detectors[i], os.path.join(tmp, name), metadata=meta)
        collection = ModelCollection.from_directory(
            tmp, project="built", device=None if DEVICE == "cuda" else DEVICE
        )
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        fs.launches = 0
        try:
            payload = {"X": {n: Xs[i][:256].tolist() for i, n in enumerate(names)}}
            status, body = _request(
                f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/built/_bulk/anomaly/prediction",
                payload,
            )
            serve_launches = fs.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
    check(status == 200, f"bulk request on built detectors: {status} {body}")
    if DEVICE == "cuda":
        check(serve_launches == 1, f"bulk request launched fleet_score {serve_launches} times")
    served = {}
    for i, name in enumerate(names):
        ref = detectors[i].anomaly(Xs[i][:256], device="cpu")
        for k in OUTPUTS:
            got = np.asarray(body["data"][name][k], np.float64)
            check(got.shape == np.shape(ref[k]) and np.isfinite(got).all(), f"served {k} of {name}")
            err = float(np.abs(got - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
            served[k] = max(served.get(k, 0.0), err)
    check(all(v <= TOLERANCE for v in served.values()), f"served built detectors within {TOLERANCE}: {served}")
    return {
        "machines": machines,
        "rows": rows,
        "tags": tags,
        "build_seconds": seconds,
        "models_per_hour": machines / seconds * 3600,
        # where the wall time went: enqueueing (host stacking, copies,
        # launches), waiting for the card and fetching, assembling the
        # detectors in Python
        "dispatch_seconds": dispatch_seconds,
        "fetch_seconds": pending.fetch_seconds,
        "assemble_seconds": pending.assemble_seconds,
        "launches": launches,
        "cpu_vs_card_max_norm_err": worst,
        "served_machines": len(names),
        "served_max_norm_err": served,
        "serve_launches": serve_launches,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "gordo_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(gordo_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from gordo_tpu_torch.device import resolve_device
    from gordo_tpu_torch.kernels import fleet_score as fs

    resolve_device()  # TF32 off for the plain versions' matmuls
    kind = phase_device()
    phase_build()
    shapes = phase_kernel_check()
    serve = phase_serve()
    emit({"phase": "serve", **serve})
    train_kernels = phase_train_kernel_check()
    train = phase_train()
    emit({"phase": "train", **train})
    main_shape = shapes[0]
    summary = [{
        "name": "fleet_score",
        "route": "cuda",
        "source": fs.SOURCE,
        "replaces": fs.REPLACES,
        "launches": serve["launches"] + train["launches"]["fleet_score"],
        "launches_by_path": {"serve": serve["launches"], "train": train["launches"]["fleet_score"]},
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "shapes": [{k: s[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "host_ms", "plain_host_ms")}
                   for s in shapes],
    }]
    for name, entry in train_kernels.items():
        mod = importlib.import_module(f"gordo_tpu_torch.kernels.{name}")
        summary.append({
            "name": name,
            "route": "cuda",
            "source": mod.SOURCE,
            "replaces": mod.REPLACES,
            "launches": train["launches"][name],
            "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": None,
            "shape": list(TRAIN_SHAPE),
            "host_ms": entry["host_ms"],
            "plain_host_ms": entry["plain_host_ms"],
        })
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
