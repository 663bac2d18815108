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
7. ``lstm_kernel_check``: the LSTM serving kernels at the bench's LSTM
   (BASELINE config 2: 64 machines × 4096 rows × 50 tags,
   ``lstm_hourglass``, lookback 12): ``lstm_layer`` for every layer, each
   fed what the kernel made for the layer before, the ``fleet_score`` head,
   and ``rolling_median`` (window 144, NaNs in one column), each against
   its plain version on the card (also on a subset of the bucket with
   ragged rows, the forecast's windows and lookback 1); times as in
   phase 3, each bound, and the
   time of one PyTorch call of the same function (``torch.nn.LSTM`` per
   machine and layer; chunked ``torch.nanquantile``).
8. ``lstm_serve``: a model directory of 8 LSTM ``ae`` detectors at the
   bench config, an LSTM ``forecast`` detector with window 144 and a
   default feedforward detector with window 144 (random weights from a
   seed), served over HTTP: per-machine requests of 4096 rows, a short
   request (400), one bulk request of all ten machines × 576 rows, and one
   of five of the ae detectors at ragged rows with the other two.
   Responses are held to the plain versions on the CPU, one to a float64
   numpy reference, and the launch counts (set to 0 just before) must show
   every scoring request went through ``lstm_layer`` (once per layer),
   ``fleet_score`` and ``rolling_median``.

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
    return {
        "dims": dims,
        "layers": layers,
        "acts": ["tanh"] * (len(dims) - 2) + ["linear"],
        **random_stats(rng, machines, tags),
    }


def random_stats(rng: np.random.Generator, machines: int, tags: int):
    """Pipeline and detector MinMax stats and thresholds of ``machines``
    detectors."""
    def minmax():
        lo = rng.uniform(-3, -1, (machines, tags))
        hi = rng.uniform(1, 3, (machines, tags))
        scale = 1.0 / (hi - lo)
        return scale.astype(np.float32), (-lo * scale).astype(np.float32)
    scale, offset = minmax()
    det_scale, det_offset = minmax()
    return {
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
    the card waits for the host; the host time is the host's own, up to
    the last call's return (a function that waits for the card inside,
    as a plain version does, has that wait in it)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3 / reps


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
    paths = build.build("fleet_score", "fleet_fit", "scaler_stats", "cv_epilogue",
                        "lstm_layer", "rolling_median")
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


# -- the LSTM path --------------------------------------------------------

#: the bench's LSTM (BASELINE config 2; bench.py:49-51,248-266): a bucket of
#: 64 machines, 4096-row requests (bench.py:836), 50 tags, lookback 12
LSTM_SHAPE = (64, 4096, 50)
LOOKBACK = 12
#: the detector window: one day of the bench's 10-minute rows
SMOOTH_WINDOW = 144
#: LSTM kernels against their plain versions, max |kernel - plain| / max
#: |plain| per output (fp32): each layer's two products sum in another
#: order than the plain version's matmuls; the median selects the same
#: values and averages them the same way, so it is exact
LSTM_TOLERANCE = {"lstm_layer": 1e-5, "fleet_score": 1e-5, "rolling_median": 0.0}
#: served LSTM responses against the plain versions on the CPU and a
#: float64 numpy reference (six layers of twelve steps in float32)
LSTM_SERVE_TOLERANCE = 1e-5
LSTM_MODEL = {
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            "gordo_tpu.ops.scalers.MinMaxScaler",
            {"gordo_tpu.models.estimator.LSTMAutoEncoder": {
                "kind": "lstm_hourglass", "lookback_window": LOOKBACK}},
        ]}}
    }
}


def with_window(definition: dict, estimator: str = None) -> dict:
    """``definition`` with a detector window of SMOOTH_WINDOW rows (and the
    final estimator's path replaced by ``estimator``)."""
    definition = json.loads(json.dumps(definition))
    det = definition["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]
    det["window"] = SMOOTH_WINDOW
    if estimator is not None:
        steps = det["base_estimator"]["gordo_tpu.pipeline.Pipeline"]["steps"]
        ((_, kwargs),) = steps[-1].items()
        steps[-1] = {estimator: kwargs}
    return definition


def random_lstm(rng: np.random.Generator, machines: int, tags: int):
    """Stacked numpy arrays of ``machines`` LSTM detectors at the hourglass
    widths: kernels scaled as lecun-normal, small biases, MinMax stats and
    thresholds."""
    dims = hourglass(tags)[:-1]  # tags, then the six LSTM widths
    cells = []
    for i in range(len(dims) - 1):
        n_in, h = dims[i], dims[i + 1]
        ki = rng.standard_normal((machines, n_in, 4 * h)) / math.sqrt(n_in)
        kh = rng.standard_normal((machines, h, 4 * h)) / math.sqrt(h)
        b = 0.1 * rng.standard_normal((machines, 4 * h))
        cells.append(tuple(a.astype(np.float32) for a in (ki, kh, b)))
    W = rng.standard_normal((machines, dims[-1], tags)) / math.sqrt(dims[-1])
    b = 0.1 * rng.standard_normal((machines, tags))
    return {
        "dims": dims,
        "cells": cells,
        "head": (W.astype(np.float32), b.astype(np.float32)),
        **random_stats(rng, machines, tags),
    }


def lstm_layer_cost(m: int, n: int, n_in: int, h: int, first: bool, last: bool):
    """(bytes, FLOPs) of one ``lstm_layer`` call over a bucket: its input
    read once (the first layer's request rows, a later layer's windows),
    its weights once per machine, its output written once.  The hidden
    product is needed per window and step (each window's state starts at
    zero), and so is a later layer's input product, whose input differs
    per window; the first layer's input product depends on the row alone
    (windows overlap), so the function needs it once per row, although
    the kernel and JAX compute it per window and step."""
    nw = n - LOOKBACK + 1
    inp = m * n * n_in if first else m * nw * LOOKBACK * n_in
    out = m * nw * h * (1 if last else LOOKBACK)
    weights = m * 4 * h * (n_in + h + 1)
    input_product = 8 * h * n_in * (m * n if first else m * nw * LOOKBACK)
    hidden_product = 8 * h * h * m * nw * LOOKBACK
    return 4 * (inp + out + weights), input_product + hidden_product


def lstm_layer_bound(m: int, n: int, dims):
    costs = [lstm_layer_cost(m, n, dims[i], dims[i + 1], i == 0, i == len(dims) - 2)
             for i in range(len(dims) - 1)]
    return bound(sum(c[0] for c in costs), sum(c[1] for c in costs))


def _torch_lstm(ki, kh, b):
    """``torch.nn.LSTM`` (cuDNN, TF32 off) with one machine's layer, the
    yardstick: flax's i, f, g, o blocks are PyTorch's gate order; the bias
    goes to ``bias_ih``, ``bias_hh`` is zero."""
    n_in, h4 = ki.shape
    lstm = torch.nn.LSTM(n_in, h4 // 4, batch_first=True).to(ki.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(ki.T)
        lstm.weight_hh_l0.copy_(kh.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    return lstm


def _valid_err(ref, got, counts, what: str, tol: float):
    """Max normalised and absolute error over each slot's first
    ``counts[s]`` rows; NaN must sit where the plain version has it."""
    r = torch.cat([ref[s, :c] for s, c in enumerate(counts)])
    g = torch.cat([got[s, :c] for s, c in enumerate(counts)])
    check(bool(torch.equal(torch.isnan(r), torch.isnan(g))), f"{what}: NaN where the plain version has it")
    fin = ~torch.isnan(r)
    err = norm_err(r[fin], g[fin])
    check(err <= tol, f"{what} within {tol}: {err}")
    return err, float((r[fin].double() - g[fin].double()).abs().max())


def lstm_layer_variants(rng, net, x, scale, offset):
    """``lstm_layer`` on what the bucket-wide check does not reach: a
    subset of the bucket's machines by stack position (``idx``) with ragged
    windows per slot, the forecast's one-fewer windows, and lookback 1."""
    from gordo_tpu_torch.kernels import lstm_layer as ll

    machines, n, _ = x.shape
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(x.device)  # noqa: E731
    (ki0, kh0, b0), (ki1, kh1, b1) = ([put(a) for a in c] for c in net["cells"][:2])
    out = []
    m_sub = min(8, machines)
    idx = np.sort(rng.choice(machines, m_sub, replace=False))[::-1].copy()
    windows = rng.integers(1, n - LOOKBACK + 2, m_sub)
    xs = x[:m_sub].contiguous()
    for name, kw in (
        ("subset_ragged", dict(lookback=LOOKBACK, idx=idx, slot_windows=windows)),
        ("forecast_windows", dict(lookback=LOOKBACK, n_windows=n - LOOKBACK)),
        ("lookback_1", dict(lookback=1)),
    ):
        counts = windows if "slot_windows" in kw else [kw.get("n_windows", n - kw["lookback"] + 1)] * m_sub
        first = dict(kw, act="tanh", scale=scale, offset=offset)
        if "idx" not in kw:
            first.update(scale=scale[:m_sub].contiguous(), offset=offset[:m_sub].contiguous())
            weights0 = [a[:m_sub].contiguous() for a in (ki0, kh0, b0)]
            weights1 = [a[:m_sub].contiguous() for a in (ki1, kh1, b1)]
        else:
            weights0, weights1 = (ki0, kh0, b0), (ki1, kh1, b1)
        got0 = ll.lstm_layer(xs, *weights0, **first)
        plain_kw = {k: v for k, v in first.items() if k != "slot_windows"}
        ref0 = ll.lstm_layer_plain(xs, *weights0, **plain_kw)
        err0, abs0 = _valid_err(ref0, got0, counts, f"lstm_layer {name} (rows)", LSTM_TOLERANCE["lstm_layer"])
        # the next layer, fed the kernel's windows, as its last layer
        second = {k: v for k, v in kw.items() if k != "n_windows"}
        got1 = ll.lstm_layer(got0, *weights1, act="tanh", last=True, **second)
        second.pop("slot_windows", None)
        ref1 = ll.lstm_layer_plain(got0, *weights1, act="tanh", last=True, **second)
        err1, abs1 = _valid_err(ref1, got1, counts, f"lstm_layer {name} (windows)", LSTM_TOLERANCE["lstm_layer"])
        out.append({"variant": name, "max_norm_err": max(err0, err1), "max_abs_err": max(abs0, abs1)})
    return out


def rolling_median_variant(rng, tag, total, thr):
    """``rolling_median`` on a subset of the bucket's machines with ragged
    rows per slot and the confidence of each slot's machine."""
    from gordo_tpu_torch.kernels import rolling_median as rm

    machines, nw, _ = tag.shape
    m_sub = min(8, machines)
    idx = np.sort(rng.choice(machines, m_sub, replace=False))[::-1].copy()
    rows = rng.integers(1, nw + 1, m_sub)
    rows[0] = 1
    sub_tag, sub_total = tag[:m_sub].contiguous(), total[:m_sub].contiguous()
    got = rm.rolling_median(sub_tag, sub_total, SMOOTH_WINDOW, agg_thr=thr, idx=idx, n_rows=rows)
    ref = rm.rolling_median_plain(sub_tag, sub_total, SMOOTH_WINDOW, agg_thr=thr, idx=idx)
    errs, worst = {}, 0.0
    for k in ref:
        errs[k], a = _valid_err(ref[k], got[k], rows, f"rolling_median subset {k}",
                                LSTM_TOLERANCE["rolling_median"])
        worst = max(worst, a)
    return {"machines": m_sub, "max_norm_err": errs, "max_abs_err": worst}


def phase_lstm_kernel_check():
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import rolling_median as rm
    from gordo_tpu_torch.ops.windows import make_windows

    machines, n, tags = LSTM_SHAPE
    rng = np.random.default_rng(SEED + 4)
    net = random_lstm(rng, machines, tags)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    x = put(rng.standard_normal((machines, n, tags)).astype(np.float32))
    scale, offset = put(net["scale"]), put(net["offset"])
    nw = n - LOOKBACK + 1
    entries, layers = {}, []

    def timed(entry, run, plain, reps, library=None):
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, reps)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, 2)
            if library is not None:
                entry["library_ms"], _ = time_calls_ms(library, 2)

    # every layer, fed what the kernel made for the layer before
    h = x
    for i, cell in enumerate(net["cells"]):
        ki, kh, b = (put(a) for a in cell)
        n_in, hidden = int(ki.shape[1]), int(kh.shape[1])
        first, last = i == 0, i == len(net["cells"]) - 1
        kw = dict(lookback=LOOKBACK, act="tanh", last=last,
                  scale=scale if first else None, offset=offset if first else None)
        inp = h
        run = lambda: ll.lstm_layer(inp, ki, kh, b, **kw)  # noqa: E731
        plain = lambda: ll.lstm_layer_plain(inp, ki, kh, b, **kw)  # noqa: E731
        got, ref = run(), plain()
        check(bool(got.isfinite().all()), f"lstm_layer {i} is finite")
        err = norm_err(ref, got)
        check(err <= LSTM_TOLERANCE["lstm_layer"],
              f"lstm_layer {i} within {LSTM_TOLERANCE['lstm_layer']}: {err}")
        entry = {"layer": i, "widths": [n_in, hidden], "max_norm_err": err,
                 "max_abs_err": float((ref.double() - got.double()).abs().max())}
        del ref
        library = None
        if DEVICE == "cuda":
            # the library's LSTM takes materialised windows, one machine a call
            wins = make_windows(inp * scale[:, None] + offset[:, None], LOOKBACK) if first else inp
            nets = [_torch_lstm(ki[j], kh[j], b[j]) for j in range(machines)]

            def library():
                with torch.no_grad():
                    return [torch.tanh(nets[j](wins[j])[0]) for j in range(machines)]

            lib_out = torch.stack([o[:, -1] if last else o for o in library()])
            entry["library_max_norm_err"] = norm_err(got, lib_out)
            del lib_out
        timed(entry, run, plain, 5, library)
        entry.update(bound(*lstm_layer_cost(machines, n, n_in, hidden, first, last)))
        layers.append(entry)
        h = got
        if DEVICE == "cuda":
            del wins, nets, library
            torch.cuda.empty_cache()
    total = {k: sum(e[k] for e in layers) for k in ("ms", "plain_ms", "library_ms") if k in layers[0]}
    total.update(lstm_layer_bound(machines, n, net["dims"]))
    entries["lstm_layer"] = {"layers": layers, "tolerance": LSTM_TOLERANCE["lstm_layer"], **total,
                             "variants": lstm_layer_variants(rng, net, x, scale, offset)}
    entries["lstm_layer"]["max_abs_err"] = max(
        [e["max_abs_err"] for e in layers] + [v["max_abs_err"] for v in entries["lstm_layer"]["variants"]])

    # the head and detector epilogue: fleet_score on the final states
    W, bh = put(net["head"][0]), put(net["head"][1])
    hidden = int(W.shape[1])
    det = dict(det_scale=put(net["det_scale"]), det_offset=put(net["det_offset"]),
               y=x, y_offset=LOOKBACK - 1)
    run = lambda: fs.fleet_score(h, [(W, bh)], ["linear"], **det)  # noqa: E731
    plain = lambda: fs.fleet_score_plain(h, [(W, bh)], ["linear"], **det)  # noqa: E731
    got, ref = run(), plain()
    check(all(bool(v.isfinite().all()) for v in got.values()), "LSTM head is finite")
    errs = {k: norm_err(ref[k], got[k]) for k in ref}
    check(all(e <= LSTM_TOLERANCE["fleet_score"] for e in errs.values()),
          f"LSTM head within {LSTM_TOLERANCE['fleet_score']}: {errs}")
    head = {"shape": [machines, nw, hidden, tags], "max_norm_err": errs,
            "max_abs_err": max(float((ref[k].double() - got[k].double()).abs().max()) for k in ref)}
    timed(head, run, plain, 20)
    head.update(bound(4 * (machines * nw * (hidden + tags)  # states, targets
                           + machines * (hidden * tags + 3 * tags)  # head, detector stats
                           + machines * nw * (2 * tags + 1)),  # pred, tags, total
                      2 * machines * nw * hidden * tags))
    entries["fleet_score_lstm_head"] = head

    # the detector's smoothing, with NaNs in one tag's column
    tag = got["tag-anomaly-scores"].clone()
    total_score = got["total-anomaly-score"]
    holes = torch.from_numpy(rng.random((machines, nw)) < 0.1).to(tag.device)
    gap = min(1000, nw // 4)
    holes[:, gap: gap + 2 * SMOOTH_WINDOW] = True  # all-NaN windows too
    tag[:, :, 3] = torch.where(holes, torch.nan, tag[:, :, 3])
    thr = put(net["agg"])
    run = lambda: rm.rolling_median(tag, total_score, SMOOTH_WINDOW, agg_thr=thr)  # noqa: E731
    plain = lambda: rm.rolling_median_plain(tag, total_score, SMOOTH_WINDOW, agg_thr=thr)  # noqa: E731
    got_m, ref_m = run(), plain()
    check(bool(torch.isnan(ref_m["tag-anomaly-scores"][:, gap + 2 * SMOOTH_WINDOW - 1, 3]).all()),
          "an all-NaN window gives NaN")
    errs, worst = {}, 0.0
    for k in ref_m:
        r, g = ref_m[k], got_m[k]
        check(bool(torch.equal(torch.isnan(r), torch.isnan(g))),
              f"rolling_median {k}: NaN exactly where the plain version has it")
        fin = ~torch.isnan(r)
        errs[k] = norm_err(r[fin], g[fin])
        worst = max(worst, float((r[fin].double() - g[fin].double()).abs().max()))
    check(all(e <= LSTM_TOLERANCE["rolling_median"] for e in errs.values()),
          f"rolling_median within {LSTM_TOLERANCE['rolling_median']}: {errs}")
    subset = rolling_median_variant(rng, tag, total_score, thr)
    median = {"shape": [machines, nw, tags + 1], "window": SMOOTH_WINDOW, "max_norm_err": errs,
              "max_abs_err": max(worst, subset["max_abs_err"]), "subset": subset,
              "tolerance": LSTM_TOLERANCE["rolling_median"]}

    def library():
        # torch.nanquantile refuses inputs over 2**24 elements: each slot's
        # windows go in two chunks of rows
        series = torch.cat([tag, total_score[..., None]], dim=-1)
        pad = series.new_full((machines, SMOOTH_WINDOW - 1, tags + 1), float("nan"))
        padded = torch.cat([pad, series], dim=1)
        half = nw // 2
        return [torch.nanquantile(padded[j, lo: hi + SMOOTH_WINDOW - 1].unfold(0, SMOOTH_WINDOW, 1),
                                  0.5, dim=-1, interpolation="midpoint")
                for j in range(machines) for lo, hi in ((0, half), (half, nw))]

    timed(median, run, plain, 20, library)
    elems = machines * nw * (tags + 1)
    # in: the scores, thresholds; out: the smoothed scores, confidence; a
    # compare per window element
    median.update(bound(4 * (2 * elems + machines + machines * nw), elems * SMOOTH_WINDOW))
    entries["rolling_median"] = median
    emit({"phase": "lstm_kernel_check", "shape": list(LSTM_SHAPE), "lookback": LOOKBACK,
          "kernels": entries})
    del x, h, got, ref, tag, got_m, ref_m
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def lstm_numpy_reference(net, i: int, X: np.ndarray, mode: str, window: int, rows: int) -> dict:
    """Float64 numpy evaluation of LSTM detector ``i`` of ``net`` on ``X``
    (its first ``rows`` output rows), independent of torch."""
    L = LOOKBACK
    off = L - 1 if mode == "ae" else L
    X = X.astype(np.float64)
    xs = X * net["scale"][i] + net["offset"][i]
    h_in = np.stack([xs[w: w + L] for w in range(rows)])  # (rows, L, F)
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    for ki, kh, b in net["cells"]:
        ki, kh, b = (a[i].astype(np.float64) for a in (ki, kh, b))
        H = kh.shape[0]
        h = np.zeros((rows, H))
        c = np.zeros((rows, H))
        steps = []
        for t in range(L):
            z = h_in[:, t] @ ki + h @ kh + b
            c = sig(z[:, H:2 * H]) * c + sig(z[:, :H]) * np.tanh(z[:, 2 * H:3 * H])
            h = sig(z[:, 3 * H:]) * np.tanh(c)
            steps.append(np.tanh(h))
        h_in = np.stack(steps, 1)
    pred = h_in[:, -1] @ net["head"][0][i].astype(np.float64) + net["head"][1][i]
    ds, do = net["det_scale"][i], net["det_offset"][i]
    y = X[off: off + rows]
    tag = np.abs((pred * ds + do) - (y * ds + do))
    total = np.sqrt((tag * tag).sum(-1))
    if window:
        def smooth(a):
            return np.stack([np.median(a[max(0, r - window + 1): r + 1], axis=0) for r in range(len(a))])
        tag, total = smooth(tag), smooth(total)
    return {"model-output": pred, "tag-anomaly-scores": tag, "total-anomaly-score": total,
            "anomaly-confidence": total / max(float(net["agg"][i]), 1e-12)}


def phase_lstm_serve():
    from gordo_tpu_torch import convert, serializer
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import rolling_median as rm
    from gordo_tpu_torch.serve.scorer import CompiledScorer, short_rows_message
    from gordo_tpu_torch.serve.server import ModelCollection, make_server

    _, rows, tags = LSTM_SHAPE
    bulk_rows = 576
    ae_count = 8
    rng = np.random.default_rng(SEED + 5)
    net = random_lstm(rng, ae_count + 1, tags)  # 8 ae detectors, then the forecast one
    ff = random_chain(rng, 1, tags)
    forecast = with_window(LSTM_MODEL, "gordo_tpu.models.estimator.LSTMForecast")
    models = {}  # name -> (definition, flax params, arrays, index in them)
    for i in range(ae_count + 1):
        params = convert.lstm_layers_to_flax([tuple(a[i] for a in c) for c in net["cells"]],
                                             (net["head"][0][i], net["head"][1][i]))
        if i < ae_count:
            models[f"lstm-ae-{i}"] = (LSTM_MODEL, params, net, i)
        else:
            models["lstm-forecast"] = (forecast, params, net, i)
    ff_params = {(f"dense_{l}" if l < len(ff["layers"]) - 1 else "out"): {"kernel": W[0], "bias": b[0]}
                 for l, (W, b) in enumerate(ff["layers"])}
    models["ff-window"] = (with_window(DEFAULT_MODEL), ff_params, ff, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lstm_") as tmp:
        for name, (definition, params, src, i) in models.items():
            model = convert.from_reference(
                definition, params,
                scaler_stats=[{"scale": src["scale"][i], "offset": src["offset"][i]}],
                detector_stats={"scale": src["det_scale"][i], "offset": src["det_offset"][i]},
                feature_thresholds=src["feature_thresholds"][i],
                aggregate_threshold=float(src["agg"][i]),
            )
            meta = {"dataset": {"tag_list": [f"{name}-tag-{j}" for j in range(tags)]}}
            serializer.dump(model, os.path.join(tmp, name), metadata=meta)
        collection = ModelCollection.from_directory(
            tmp, project="lstm", device=None if DEVICE == "cuda" else DEVICE
        )
        cpu = {name: CompiledScorer(serializer.load(os.path.join(tmp, name)), device="cpu")
               for name in models}
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/lstm"
        inputs = {name: rng.standard_normal((rows, tags)).astype(np.float32)
                  for name in ("lstm-ae-0", "lstm-forecast", "ff-window")}
        bulk = {name: rng.standard_normal((bulk_rows, tags)).astype(np.float32) for name in models}
        for mod in (ll, fs, rm):
            mod.launches = 0
        responses, latencies = [], {}
        try:
            for name, X in inputs.items():
                for route in ("prediction", "anomaly/prediction"):
                    t0 = time.perf_counter()
                    status, body = _request(f"{base}/{name}/{route}", {"X": X.tolist()})
                    latencies[f"{name} {route}"] = time.perf_counter() - t0
                    check(status == 200, f"{route} {name}: {status} {body}")
                    responses.append((name, route, X, body["data"]))
            t0 = time.perf_counter()
            status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                    {"X": {n: X.tolist() for n, X in bulk.items()}})
            latencies["bulk"] = time.perf_counter() - t0
            check(status == 200, f"bulk: {status} {body}")
            for name, X in bulk.items():
                responses.append((name, "bulk", X, body["data"][name]))
            # part of the ae bucket at ragged rows (one row past the
            # lookback gives one window), and the other two buckets
            ragged = {f"lstm-ae-{i}": r for i, r in zip((6, 1, 4, 3, 2), (576, 400, 200, 13, 12))}
            ragged.update({"lstm-forecast": 145, "ff-window": 7})
            sub = {name: bulk[name][:r] for name, r in ragged.items()}
            status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                    {"X": {n: X.tolist() for n, X in sub.items()}})
            check(status == 200, f"ragged bulk: {status} {body}")
            for name, X in sub.items():
                responses.append((name, "bulk", X, body["data"][name]))
            launches = {"lstm_layer": ll.launches, "fleet_score": fs.launches,
                        "rolling_median": rm.launches}
            # a request no longer than the lookback is a client error
            status, body = _request(f"{base}/lstm-forecast/anomaly/prediction",
                                    {"X": bulk["lstm-forecast"][:LOOKBACK].tolist()})
            check(status == 400 and json.loads(body) == {"error": short_rows_message(LOOKBACK, LOOKBACK)},
                  f"short request: {status} {body}")
            breakdown = _request_breakdown(collection, inputs, sub) if DEVICE == "cuda" else {}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
    # six lstm_layer launches for each LSTM request, one fleet_score for
    # each request, one rolling_median for each anomaly request with a
    # window; each bulk request scores three buckets (the ae detectors,
    # the forecast one, the feedforward one)
    expected = {"lstm_layer": 6 * 4 + 2 * 6 * 2, "fleet_score": 6 + 2 * 3, "rolling_median": 2 + 2 * 2}
    if DEVICE == "cuda":
        check(launches == expected, f"LSTM serving launches {launches}, expected {expected}")
    worst = {}
    for name, route, X, data in responses:
        scorer = cpu[name]
        ref = {"model-output": scorer.predict(X)} if route == "prediction" else scorer.anomaly_arrays(X)
        for k in OUTPUTS:
            if k not in data:
                continue
            got = np.asarray(data[k], np.float64)
            check(got.shape == np.shape(ref[k]) and np.isfinite(got).all(), f"{route} {name} {k}")
            err = float(np.abs(got - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
            worst[k] = max(worst.get(k, 0.0), err)
    # one response against float64 numpy: the forecast detector's anomaly
    # response, its first 300 rows
    ((X, data),) = [(X, d) for n, r, X, d in responses
                    if n == "lstm-forecast" and r == "anomaly/prediction"]
    first = min(300, X.shape[0] - LOOKBACK)
    ref64 = lstm_numpy_reference(net, ae_count, X, "forecast", SMOOTH_WINDOW, first)
    worst64 = {}
    for k, ref in ref64.items():
        got = np.asarray(data[k], np.float64)[:first]
        worst64[k] = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
    check(all(v <= LSTM_SERVE_TOLERANCE for v in worst.values()),
          f"served LSTM values within {LSTM_SERVE_TOLERANCE} of the plain versions: {worst}")
    check(all(v <= LSTM_SERVE_TOLERANCE for v in worst64.values()),
          f"served forecast response within {LSTM_SERVE_TOLERANCE} of float64: {worst64}")
    return {
        "machines": {"lstm_ae": ae_count, "lstm_forecast_window": 1, "ff_window": 1},
        "request_rows": rows,
        "bulk_rows": bulk_rows,
        "scoring_requests": 2 * len(inputs) + 2,
        "launches": launches,
        "max_norm_err_vs_plain": worst,
        "max_norm_err_vs_float64": worst64,
        "request_seconds": latencies,
        "breakdown": breakdown,
    }


def _request_breakdown(collection, inputs, ragged) -> dict:
    """Where a 4096-row anomaly request's time goes, per model: the
    kernels (CUDA events around the launches of one request, on rows
    already on the card) and the scorer's call (host clock: copies to and
    from the card, the launches, numpy), beside the HTTP request's wall
    time measured above (JSON decode and encode on top).  And the ragged
    bulk request's slots of the LSTM ``ae`` bucket, a subset at ragged
    rows: its kernels and the host time that enqueues them (the slot
    indices and counts go to the card once for the seven launches)."""
    out = {}
    bucket = next(b for b in collection.fleet_scorer.buckets if "lstm-ae-0" in b.position)
    names = [n for n in ragged if n in bucket.position]
    rows = [int(ragged[n].shape[0]) for n in names]
    x = np.zeros((len(names), max(rows), bucket.n_features), np.float32)
    for slot, name in enumerate(names):
        x[slot, : rows[slot]] = ragged[name]
    x = torch.from_numpy(x).to(DEVICE)
    idx = [bucket.position[n] for n in names]
    device_ms, host_ms = time_calls_ms(lambda: bucket.run(x, True, idx, rows), 5)
    out[f"lstm-ae bulk, {len(names)} ragged slots"] = {"kernels_ms": device_ms, "enqueue_ms": host_ms}
    for name, X in inputs.items():
        scorer = collection.get(name).scorer
        x = torch.from_numpy(X[None]).to(DEVICE)
        device_ms, host_ms = time_calls_ms(lambda: scorer._stack.run(x, True), 5)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            scorer.anomaly_arrays(X)
            walls.append(time.perf_counter() - t0)
        out[name] = {"kernels_ms": device_ms, "enqueue_ms": host_ms,
                     "scorer_ms": float(np.median(walls)) * 1e3}
    return out


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
    lstm_kernels = phase_lstm_kernel_check()
    lstm_serve = phase_lstm_serve()
    emit({"phase": "lstm_serve", **lstm_serve})
    main_shape = shapes[0]
    head = lstm_kernels["fleet_score_lstm_head"]
    summary = [{
        "name": "fleet_score",
        "route": "cuda",
        "source": fs.SOURCE,
        "replaces": fs.REPLACES,
        "launches": (serve["launches"] + train["launches"]["fleet_score"]
                     + lstm_serve["launches"]["fleet_score"]),
        "launches_by_path": {"serve": serve["launches"], "train": train["launches"]["fleet_score"],
                             "lstm_serve": lstm_serve["launches"]["fleet_score"]},
        "max_abs_err": max([s["max_abs_err"] for s in shapes] + [head["max_abs_err"]]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "shapes": [{k: s[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "host_ms", "plain_host_ms")}
                   for s in shapes]
                  + [{"shape": head["shape"], "lstm_head": True,
                      **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "host_ms", "plain_host_ms")}}],
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
    for name in ("lstm_layer", "rolling_median"):
        entry = lstm_kernels[name]
        mod = importlib.import_module(f"gordo_tpu_torch.kernels.{name}")
        summary.append({
            "name": name,
            "route": "cuda",
            "source": mod.SOURCE,
            "replaces": mod.REPLACES,
            "launches": lstm_serve["launches"][name],
            "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
            "shape": list(LSTM_SHAPE),
        })
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
