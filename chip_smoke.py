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
   as the build does, ``scaler_stats`` (MinMax, the nested path) and
   ``cv_epilogue`` (K4, the warp path) bit for bit their plain versions
   (the epilogue also on targets at a level of 1e4, and by its block path
   at the LSTM builds' 192 slots × 133 × 50, K4 and K8), every output
   hashed; times as in phase 3 (the plain
   versions, thousands of small launches, are timed by CUDA events around
   whole calls, host gaps included), and each bound.
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
   machine and layer; chunked ``torch.nanquantile``); ``lstm_layer`` also
   at the stream's launch shape (one machine's ring of 155 rows, its 144
   windows), each layer held to its plain version and timed.
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
9. ``lstm_train_kernel_check``: the LSTM training kernels at the bench's
   LSTM build (64 machines × 576 rows × 50 tags, lookback 12, batch 64,
   ``TimeSeriesSplit(3)``: 256 slots, one per fold fit and final fit of
   each machine), on one lockstep step's minibatches: the training-mode
   ``lstm_layer`` per layer (outputs and saves), ``lstm_head_fit``,
   ``lstm_layer_bwd`` per layer (each fed the kernel's gradient from
   above) and ``fleet_adam`` over every leaf with the first fold's slots
   inactive (left alone bit for bit), each against its plain version;
   times as in phase 3, each bound (``lstm_step_cost``), and the time of
   the nearest PyTorch call (``torch.nn.LSTM`` forward, and its gradient
   through autograd, one slot a call; PyTorch's fused Adam); then the four
   again, untimed, on one step of 4 machines at the default batch of 256
   windows.
10. ``lstm_train``: ``FleetDiffBuilder.build`` of 64 such LSTM detectors
   (a first build, then the counted one: seconds, models/h, dispatch,
   fetch and assembly seconds, launches of every kernel, set to 0 just
   before; then a build under ``torch.profiler`` for the card's time by
   kernel and its busy share), held per machine to the same program with
   the plain lockstep fit on the card (params, histories, thresholds, CV
   scores); two of the detectors are served over HTTP, two anomaly
   requests each, and held to the in-process scorers on the card and on
   the CPU; 8 of the machines' series are built again as ``LSTMForecast``
   detectors through the kernels and held to the plain lockstep fit.  The
   whole fit's bound is ``lstm_fit_bound``.  Then the ``lstm_redesign``
   line: ``lstm_layer`` at the bench's and the stream's shapes,
   ``lstm_layer_bwd`` per lockstep step and the LSTM build's seconds
   beside the parent design's figures (``PARENT_LSTM``).
11. ``ragged_kernel_check``: the masked epilogue (K8: ``cv_epilogue`` with
   row counts from 0 to 144 over 1,536 slots × 144 rows × 10 tags, held
   to its plain version bit for bit, the empty slots to their fixed values, and to
   the suffix-weighted metrics; slots with NaN and inf in real rows,
   whose non-finite maxima K8 maps to 0 and K4 keeps; its outputs
   hashed), ``scaler_stats`` on NaN-padded ragged rows (bit for bit its
   plain version, hashed), ``fleet_fit`` with a real-row count per (machine, fit) at 512 ×
   576 × 10 whose fits hold minibatches of padding alone, and two
   lockstep LSTM steps of the bench's LSTM build with ragged window
   counts, the second with slots that have no real window (their loss
   and gradients must come back as zeros); times and bounds as above.
12. ``ragged_train``: 512 default detectors whose machine i has 576 - (i
   mod 128) rows, built with ``pad_lengths=64`` (two padded groups) and
   exactly (128 groups), each twice, the second counted (seconds,
   models/h, dispatch, fetch, assembly, launches by kernel); the padded
   build held per machine to the same programs through the plain
   versions on the card (``plain_kernels``), its 576-row machines to the
   exact build's bit for bit (their CV scores to the weighted metrics of
   the exact build's predictions, K8's formulas); then a warm pad-up
   rebuild on the series grown by 64 rows from the padded build's params,
   held the same way.
13. ``ragged_lstm_train``: the same for 64 of the bench's LSTM detectors
   whose machine i has 576 - 16 (i mod 4) rows: one padded group, four
   exact ones, the padded build held to its program with the plain
   lockstep fit and plain versions on the card, the 576-row machines bit
   for bit (the CV scores as above); then a warm exact rebuild from the padded build's params,
   held to its plain version.
14. ``precision_kernel_check``: the bf16 instantiations (K10) against
   their plain versions on the card: ``fleet_score`` over bf16 storage at
   512 × 2048 × 10 (and a subset with ragged rows) and the bf16 LSTM head
   at 64 × 4085 × 42→50; ``lstm_layer`` over bf16 storage, six layers at
   64 × 4096 × 50; ``fake_quant_many`` over every stacked leaf of a
   512-machine default bucket and of a 64-machine LSTM bucket (bf16, one
   scale across the machines), over one machine's f32 leaves and over
   edge leaves (zero, one element, NaN, gate blocks), each set in one
   launch, bit for bit the plain version leaf by leaf, NaN by place;
   times, and bounds with the inputs at their storage width.
15. ``precision_serve``: 512 default and 8 LSTM detectors served over HTTP
   at ``GORDO_SERVE_DTYPE=float32``, ``bfloat16`` and ``int8``
   (``GORDO_SERVE_INT8=1``): six per-machine requests, a bulk request of
   all 520 and a one-machine subset of each bucket; the reduced responses
   held to the f32 ones with the r12 bounds; device bytes resident per
   bucket; each kernel's launches (set to 0 just before), the bf16 ones
   and ``fake_quant``'s at the int8 load (one a load: each machine's
   scorer and each bucket).
16. ``stream_kernel_check``: ``stream_step`` for a default detector
   (window 144), an LSTM ae detector's head (50 tags, lookback 12) and a
   chain-C detector (its ``chain_apply`` output the dense stack's input),
   at f32 and over bf16, at steady state and in warm-up, against its
   plain version, and bit for bit against the request path's kernels
   (``fleet_score``, after ``lstm_layer`` or ``chain_apply``, then
   ``rolling_median``) over the same rows; rows streamed from an empty
   ring past a full one, the carried one-row mode (the LSTM's layers and
   the chain over the newest window or row) bit for bit the full-window
   mode at every row, verdicts and carried tag scores; the ring shift
   alone; both modes' times beside the card's launch floor (an empty
   kernel), and bounds.
17. ``stream``: 64 default and 8 LSTM ae detectors (window 144) fed 300
   rows each through ``StreamHub.ingest_rows`` (launches set to 0 just
   before: one ``stream_step`` per row; an LSTM's row also one shift and
   one ``lstm_layer`` per layer), every steady-state verdict of 8 of each
   kind held bit for bit to the request path, each row's latency on the
   host clock; a bf16 twin held to f32 with the r12 bounds; then 20 rows
   through HTTP ingest (both body forms) with an SSE subscriber and a
   poller, whose event ids must be the ring's, strictly increasing, none
   lost or repeated; the routes' 400, 404 and 422 answers.

18. ``resume_kernel_check``: ``fleet_fit`` resumed and weighted at
   TRAIN_SHAPE (4 fits, 10 epochs): one launch against the same fit as
   chunks of 3+3+3+1 epochs, each from the last chunk's params and Adam
   state, bit for bit (params, moments, counts, history), and against
   the plain version; the fit with random non-binary row weights against
   its plain version, and with 0/1 weights bit for bit the launch with
   the equal row counts; ``fleet_apply`` at KERNEL_SHAPES against its
   plain version and bit for bit against ``fleet_score``'s model output;
   times, bounds, and the plain version's chain of library calls timed
   back to back.
19. ``resume``: a default detector's ``AutoEncoder`` (576 × 10) and an
   ``LSTMAutoEncoder`` at LSTM_TRAIN_MODEL's widths (576 × 50, lookback
   12) fitted with ``checkpoint_dir`` on the card, stopped after 4 epochs
   and resumed to 10, bit for bit the uninterrupted fits; the seconds of
   each checkpoint save and load, the launches (set to 0 just before).
20. ``fleet_api``: ``fleet_stage`` → ``fleet_dispatch`` → ``collect`` of
   512 machines × 449–576 rows × 10 tags (``stack_rows``), then
   ``fleet_apply`` of the result: seconds of each stage (``fleet_stage``
   draws every seed in one ``fleet_init`` launch), models/h, one launch
   of each kernel, held to the same calls through the plain versions on
   the card.
21. ``fleet_init_kernel_check``: K11 (``fleet_init``) against its plain
   version on the card: 512 seeds of the 10-tag hourglass with the
   permutations of the four fits of 576 rows under TimeSeriesSplit(3) and
   batch 256 over 10 epochs, one seed of the bench's LSTM, one
   permutation of a year of 10-minute rows (52,560, sorted over a
   cluster), every sort path's edge lengths for 3 seeds × 3 epochs in one
   launch and the warp path's for 205 × 5 (alone and beside a cluster
   job), and the longest permutation
   (131,072; a longer one raises);
   every leaf's raw bits (its key and fold-in) and every permutation bit
   for bit, the draws within FLEET_INIT_ULP, the orthogonal kernels after
   their QR within FLEET_INIT_QR_TOLERANCE; times of the kernel, its plain
   version and ``torch.randperm`` over the same permutations, and the
   bound.  Then the ``init_quant_redesign`` line: ``fleet_init``'s and
   ``fake_quant``'s times and the int8 load seconds beside the parent
   design's (``PARENT_FLEET_INIT``, ``PARENT_FAKE_QUANT``).
22. ``build_project``: ``builder.build_project`` of a 512-machine
   RandomDataset project YAML (10 tags, 576 rows, the default model,
   TrainConfig and TimeSeriesSplit(3)) on the card: seconds, models/h,
   the stage split, the launches (one ``fleet_init``, ``fleet_fit``,
   ``fleet_score`` and ``cv_epilogue``, two ``scaler_stats``); a second
   run that hits the cache and launches nothing; the output directory
   served over HTTP, one bulk request of every machine through one
   ``fleet_score`` launch, held to the plain scorer on the CPU.

23. ``scaler_kernel_check``: K3's Standard statistic (``scaler_stats``)
   and Robust statistic (``scaler_quantiles``) against their plain
   versions on the card at 512 × 576 × 10 over the 4 row lists of
   ``TimeSeriesSplit(3)`` and the full series, on NaN-padded ragged rows
   (449–576), as the second step of the chains Standard → MinMax and
   MinMax (to (1, -1)) → Robust, and on a year of 10-minute rows (52,560
   × 10: Robust also NaN-padded and after a MinMax (1, -1) step) and at
   57,344 rows over uneven row lists, each bit for bit its plain version;
   the MinMax statistic after the Standard step in the fleet build's
   form (its offset one FMA), and by each path of its plan (nested ranges
   over NaN-padded rows, index lists, a year, the uneven lists), each bit
   for bit its plain version, timed, every output hashed;
   Robust's selection and sort timed beside each other; times, bounds,
   and ``torch.nanquantile`` (one call a row list) beside Robust.
24. ``scaler_build``: ``FleetDiffBuilder.build`` of 512 × 576 × 10
   detectors with a ``RobustScaler`` pipeline step and a
   ``StandardScaler`` detector scaler (seconds, models/h, launches by
   kernel set to 0 just before), held per machine to the same program
   through the plain versions on the card; 64 of them served over HTTP
   (one bulk request, one ``fleet_score`` launch, held to the plain scorer
   on the CPU) and 24 rows streamed into four (one ``stream_step`` a row,
   every verdict the request path's bit for bit).

25. ``transform_kernel_check``: K12 (``chain_apply``) against its plain
   version on the card over every step form (imputer, centre, multiply,
   expm1, add, log1p, PCA at k = 8, 10 and the full width, affine) on
   rows with NaN cells, QuantileTransformer steps (Q = 100 uniform and
   normal, Q = 1,000 normal) over quantised rows whose grids tie, and
   chain A's steps, at 576 × 10 and 4,096 × 128, and the PCA step alone
   at the full width beside ``torch.mm``; ``scaler_quantiles``' grid
   variant (Q = 100, the median by selection and by the sort) and
   ``scaler_stats``' means (a NaN column) at 576 × 10, on a year of
   10-minute rows (52,560 × 10) and at 57,344 rows over uneven row lists,
   each bit for bit its plain version, Robust's kernel rechecked there, and the
   grid at its sort's edges (Q 1,000, 27,000 and 57,344 rows, an all-NaN
   column, one row), every grid bit for bit its plain version; times,
   bounds, and ``torch.nanquantile``, ``torch.nanmedian``, ``torch.mean``
   and ``torch.nanmean`` beside the statistics.
26. ``transform_build``: ``build_project`` of a 16-machine RandomDataset
   YAML (576 rows × 10 tags; 8 chain A, 6 chain B and 2 chain B with a
   uniform output) through the singles pass on the card (seconds, stage
   split, the card's busy share, launches of every kernel set to 0 just
   before), the same machines built again through the plain versions on
   the card and held per machine, then served over HTTP per machine and
   in bulk with NaN cells in the request rows (one ``chain_apply`` and one
   ``fleet_score`` launch a machine), held to the plain scorer on the CPU.

27. ``container_kernel_check``: ``chain_apply``'s inverse forms (the
   MinMax inverse as CENTER, the Standard and Robust inverses as AFFINE,
   ``PCA_INV`` at k 8 → F 10 and k 128 → F 128, ``QUANTILE_INV`` uniform
   and normal at Q 100 and 1,000) and the epilogue-only ``fleet_score``
   (with and without thresholds) against their plain versions on the card
   at 1 × 2048 × 10, 1 × 4,096 × 128 and stacked at 512 × 2048 × 10, on
   rows with NaN cells; times, bounds (``epilogue_bound``), plain times,
   and ``torch.addcmul``/``torch.addmm``/``torch.baddbmm`` beside the
   affine and PCA inverses; the PCA forms swept at k 1 to 128, stacked
   with ``idx``, ``n_rows`` and a column range, at every ``<T, TO>``
   instantiation (``pca_forms_check``), and ``PCA_INV`` at k 128 held to
   the bits of the FMA chain it sums.
28. ``container_build``: ``build_project`` of a 16-machine RandomDataset
   YAML (576 rows × 10 tags: 8 of gordo's default
   ``TransformedTargetRegressor``, one of them with a window of 144, 4
   TTRs with a normal ``QuantileTransformer`` target, 2
   ``Pipeline[FeatureUnion[PCA(4), MinMaxScaler], AutoEncoder]``, 2
   ``MultiOutputRegressor(AutoEncoder)``) through the singles pass on the
   card (seconds, stage split, busy share, every kernel's launches held
   exactly), held per machine to the same build through the plain
   versions on the card, then served over HTTP at float32 and bfloat16
   per machine and in bulk with 2048 rows a machine (each request's
   launches held exactly: a TTR's three, four with the window), bf16 bit
   for bit f32, every answer held to the plain scorer on the CPU, and a
   stream bind refused with 422.
29. ``uncentred_chain``: 64 machines × 576 × 10 tags plus a level of 1e3
   as detectors of ``[RobustScaler, MinMaxScaler]`` and of
   ``[MinMaxScaler, StandardScaler]``, each with a StandardScaler detector
   scaler, every step applied in turn in its own form by the kernels that
   load scaled rows: each chain built (launches held exactly) and held to
   its plain program on the card, 4 machines served 2048 rows at float32
   and bfloat16 (one ``fleet_score`` launch a request, each held to the
   plain scorer on the CPU at its dtype) and 4 streamed, every verdict the
   request path's bit for bit.

The holds of a build to its plain program (phases 12, 13 and 24) and of
the ragged ``fleet_fit`` (phase 11) admit an array that misses its bound
only within the smaller of the plain version's movements from initial
params one ulp up and one ulp down, and at most ``ONE_ULP_ADMITTED``
arrays and machines a hold.

Every build of phases 6 to 22, 24, 26, 28 and 29 draws its initial params and permutations
through ``fleet_init`` (one launch a length group, or a fit on the single path), counted with the
build's kernels.

Then the ``kernels`` summary line (``cv_epilogue``'s launches in pad-up
groups are listed under ``cv_epilogue_masked``, K8; those in exact groups
under ``cv_epilogue``, K4; ``fleet_score_bf16`` and ``lstm_layer_bf16``
are the bf16 instantiations, whose launches are also in ``fleet_score``'s
and ``lstm_layer``'s; ``stream_step`` counts the scoring launches and the
LSTM rows' shifts; ``fleet_fit_stateful`` and ``fleet_fit_weighted``
are ``fleet_fit`` resumed and with row weights, whose launches are not in
``fleet_fit``'s; ``scaler_stats_standard`` and ``scaler_stats_mean`` are
``scaler_stats``' Standard and mean statistics, whose launches are also in
``scaler_stats``'; ``scaler_quantiles_grid`` is ``scaler_quantiles``' grid
variant, whose launches are not in ``scaler_quantiles``';
``chain_apply_inverse`` is ``chain_apply`` on a TransformedTargetRegressor's
target inverse and ``fleet_score_epilogue`` the epilogue alone, whose
launches are not in ``chain_apply``'s and ``fleet_score``'s) and, last,
``{"ok": true, "device": {...}}``.

The phases that run ``fleet_score`` or ``chain_apply`` on seeded inputs
(``kernel_check``, ``lstm_kernel_check``, ``precision_kernel_check``,
``transform_kernel_check``, ``transform_serve_kernel_check``,
``container_kernel_check``) print a hash of every output
(``output_hashes``), so that two trees' kernels compare bit for bit
through ``scripts/chip_phases.py --smoke``; after phase 27 a
``score_chain_redesign`` line gives the two kernels' times at their main
shapes beside the parent design's (``PARENT_FLEET_SCORE``,
``PARENT_CHAIN_APPLY``).  A library call that computes a kernel's function
in one launch (``torch.addcmul``, ``torch.addmm``, ``torch.baddbmm``,
``torch.mm``, ``torch.mean``) is timed as the kernel is (``time_ms``); the
plain versions and multi-launch library calls by ``time_calls_ms``.  Any failure raises and exits non-zero without a result; so does
a run without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
#: 1.5e-7 on the loss history); the epilogue sums in XLA's window order on
#: both sides (measured 0, and held bit for bit)
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
            chain=[minmax_step(put(chain["scale"]), put(chain["offset"]))],
            det=minmax_step(put(chain["det_scale"]), put(chain["det_offset"])),
            agg_thr=put(chain["agg"]),
        ),
    )


def minmax_step(scale, offset):
    """A MinMax scaler as the kernels take it: one AFFINE step."""
    from gordo_tpu_torch.kernels.scaler_stats import AFFINE
    return (AFFINE, scale, offset)


def differing(ref, got) -> int:
    """Values of ``got`` that are not ``ref``'s bit for bit, a NaN where
    ``ref`` has one (any payload) and a zero's sign aside (a sort may rank
    -0 and +0 either way)."""
    r, g = ref.float() + 0.0, got.float() + 0.0
    both_nan = torch.isnan(r) & torch.isnan(g)
    return int(((r.view(torch.int32) != g.view(torch.int32)) & ~both_nan).sum())


def output_hash(t: torch.Tensor, rows=None) -> str:
    """The first 16 hex digits of the sha256 of ``t``'s bytes (each slot's
    first ``rows[s]`` rows where given: the rows past them are
    unspecified), every NaN as one payload: two runs on the same inputs
    print the same hash exactly when their outputs agree bit for bit."""
    if rows is not None:
        t = torch.cat([t[i, : int(c)] for i, c in enumerate(rows)])
    t = t.detach()
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def output_hashes(out, rows=None) -> dict:
    """``output_hash`` of each output of a dict (fleet_score's), or of one
    tensor (under ``"out"``)."""
    if isinstance(out, dict):
        return {k: output_hash(v, rows) for k, v in sorted(out.items())}
    return {"out": output_hash(out, rows)}


def plan_path(mod, *args, **kw):
    """The path name of ``mod.launch_plan(*args)`` (``cv_epilogue``: warp
    or block; ``scaler_stats``' MinMax: nested, list or split), or None
    for a tree whose module has no plan (a parent before the plans)."""
    plan = getattr(mod, "launch_plan", None)
    if plan is None:
        return None
    got = plan(*args, **kw)
    names = getattr(mod, "PATH_NAMES", ("warp", "block"))
    return names[got.path]


def norm_err(ref, got) -> float:
    ref = ref.double()
    return float((ref - got.double()).abs().max() / ref.abs().max().clamp_min(1e-30))


def score_err(ref, got) -> float:
    """Max error of per-slot scores whose perfect value is 1 (explained
    variance, r2), each over max(|ref|, 1): absolute near 1, relative where
    a slot of (nearly) constant targets sends its score far out (a slot of
    one row has r2 near -1e11), so that no slot sets the scale of another."""
    ref = ref.double()
    return float(((ref - got.double()).abs() / ref.abs().clamp_min(1.0)).max())


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


def time_ms(fn, reps: int, attempts: int = 4):
    """``(device ms, host ms)`` per call of ``fn``.

    The device time comes from CUDA events around ``reps`` calls that the
    host enqueues while the card sleeps, so the card runs them back to
    back and host overhead between launches is not timed; the host time
    is the wall time of enqueueing one call. A measurement counts only if
    the enqueueing ended within the sleep; one that a host stall pushed
    past it is taken again with twice the sleep, up to ``attempts`` times.
    A first pass behind the sleep can stall so: the pinned buffers of a
    wrapper's index arrays (``device.to_device``) are not reused until
    their copies ran, so each call may pin a new one."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # sleep for 3x the measured enqueue time (10 ms at least), at up to 2 GHz
    sleep_s = max(3 * reps * host_s, 0.01)
    for _ in range(attempts):
        torch.cuda._sleep(int(sleep_s * 2e9))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if enqueue_s < sleep_s:
            return start.elapsed_time(end) / reps, host_s * 1e3
        sleep_s *= 2
    check(False, f"the timed launches were enqueued while the card slept ({enqueue_s:.6f} s "
                 f"to enqueue {reps} calls, sleep sized for {sleep_s / 2:.6f} s, {attempts} attempts)")


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


def time_entry(entry: dict, run, plain, reps: int, plain_reps: int = 2, library=None) -> None:
    """On the card, ``entry``'s times: the kernel's by ``time_ms`` over
    ``reps`` calls, its plain version's (and ``library``'s, where given)
    by ``time_calls_ms``."""
    if DEVICE == "cuda":
        entry["ms"], entry["host_ms"] = time_ms(run, reps)
        entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, plain_reps)
        if library is not None:
            entry["library_ms"], _ = time_calls_ms(library, 2)

def bound(nbytes: float, ops: float):
    """Least time for ``nbytes`` of device memory traffic and ``ops`` fp32
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "flops": ops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fleet_score_bound(m: int, n: int, dims, machines: int, in_bytes: int = 4):
    """Least time for one fleet_score call: each input byte read once (the
    rows, weights and stats at ``in_bytes`` each, the f32 thresholds), each
    output byte written once, and the dense layers' FLOPs."""
    f = dims[0]
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    in_values = m * n * f + machines * (weights + 4 * f)
    out_floats = m * n * (2 * dims[-1] + 2)
    nbytes = in_bytes * in_values + 4 * (machines + out_floats)
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
                        "lstm_layer", "rolling_median", "lstm_layer_bwd", "lstm_head_fit",
                        "fleet_adam", "fake_quant", "stream_step", "fleet_apply", "fleet_init",
                        "scaler_quantiles", "chain_apply")
    seconds = time.perf_counter() - t0
    ptxas = []
    for p in paths:
        with open(p + ".log") as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln or "entry function" in ln]
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
        entry = {"shape": [machines, n, tags], "max_norm_err": errs, "max_abs_err": abs_err,
                 "hashes": output_hashes(got)}
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
            entry["subset"] = {"machines": m_sub, "max_norm_err": errs_s, "max_abs_err": abs_s,
                               "hashes": output_hashes(got_s, rows)}
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
    from gordo_tpu_torch import serializer
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
                model = port_detector(definition, dense_params(chain, i), chain, i)
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


def fleet_fit_bound(fits, dims, machines: int, rows: int, epochs: int, counts=None,
                    state: bool = False, weights: bool = False):
    """Least time for one fleet_fit call: each input (rows, targets,
    permutations, stats, initial params; with ``weights`` the (M, N) row
    weights; with ``state`` Adam's moments and counts in) read once, each
    output (with ``state`` the moments and counts too) written once; per
    real row visit (``counts`` (M, G): each machine's rows of nonzero
    weight in each fit, default every row) the forward pass, the backward
    deltas and the weight gradients, per step one Adam update of every
    parameter."""
    f = dims[0]
    weights = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    n_params = weights + sum(dims[1:])
    delta_weights = weights - dims[0] * dims[1]
    real = machines * sum(fg.n for fg in fits) if counts is None else int(np.sum(counts))
    row_visits = epochs * real
    steps = machines * epochs * sum(fg.steps for fg in fits)
    ops = row_visits * 2 * (2 * weights + delta_weights) + steps * 12 * n_params
    g = len(fits)
    nbytes = 4 * (2 * machines * rows * f + epochs * sum(fg.n_total for fg in fits)
                  + sum(fg.n for fg in fits) + 2 * machines * g * f + n_params
                  + machines * g * (n_params + epochs))
    if state:
        nbytes += 4 * machines * g * (4 * n_params + 2)
    if weights:
        nbytes += 4 * machines * rows
    return bound(nbytes, ops)


def _ff_counters():
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_init as fi
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss

    return {"fleet_fit": (ff, "launches"), "scaler_stats": (ss, "launches"),
            "scaler_stats_standard": (ss, "standard_launches"), "scaler_quantiles": (sq, "launches"),
            "fleet_score": (fs, "launches"), "cv_epilogue": (ce, "launches"),
            "fleet_init": (fi, "launches")}


def _lstm_counters():
    from gordo_tpu_torch.kernels import fleet_adam as fa
    from gordo_tpu_torch.kernels import lstm_head_fit as hf
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import lstm_layer_bwd as lb

    return {"lstm_layer_train": (ll, "train_launches"), "lstm_layer": (ll, "launches"),
            "lstm_layer_bwd": (lb, "launches"), "lstm_head_fit": (hf, "launches"),
            "fleet_adam": (fa, "launches"),
            **{k: v for k, v in _ff_counters().items() if k != "fleet_fit"}}


def _expected_launches(spec, pending) -> dict:
    """Launches of the build ``pending`` (a ``PendingFleetBuild``): per
    group it launched 1 fleet_init (its seed's draws), 1 stats launch per
    pipeline scaler step and 1 for the detector scaler (``scaler_stats``
    for MinMax and Standard, ``scaler_quantiles`` for Robust), 1
    out-of-fold scoring, 1 epilogue, and 1 fleet_fit or, for an LSTM, per lockstep step each layer forward and
    backward, the head and Adam, then each layer once out of fold."""
    from gordo_tpu_torch.parallel.anomaly import chain_dims
    from gordo_tpu_torch.train.lstm_fit import window_fit

    lstm = spec.window_mode != "none"
    out = dict.fromkeys(_lstm_counters() if lstm else _ff_counters(), 0)
    from gordo_tpu_torch.ops.scalers import RobustScaler, StandardScaler

    scalers = [*spec.scaler_protos, spec.detector_proto.scaler]
    for g in pending.groups:
        out["fleet_init"] += 1
        for sc in scalers:
            out["scaler_quantiles" if isinstance(sc, RobustScaler) else "scaler_stats"] += 1
            out["scaler_stats_standard"] += isinstance(sc, StandardScaler)
        out["fleet_score"] += 1
        out["cv_epilogue"] += 1
        if not lstm:
            out["fleet_fit"] += 1
            continue
        layers = len(chain_dims(spec, g.X.shape[2], g.y.shape[2])) - 2
        rows = [tr for tr, _ in g.folds] + [np.arange(g.X.shape[1])]
        n_steps = spec.train_cfg.epochs * max(
            window_fit(r, spec.train_cfg.batch_size, spec.offset).steps for r in rows)
        out["lstm_layer_train"] += layers * n_steps
        out["lstm_layer_bwd"] += layers * n_steps
        out["lstm_head_fit"] += n_steps
        out["fleet_adam"] += n_steps
        out["lstm_layer"] += layers
    return out


#: the slots the block path of cv_epilogue takes in the builds: an LSTM
#: fleet's folds (64 machines x 3 folds, 144 - 11 rows of 50 tags)
CV_BLOCK_SHAPE = (192, 133, 50)


def _cv_block_path_check(rng) -> dict:
    """``cv_epilogue`` at slots wider than the warp path takes (the LSTM
    builds' 50 tags): K4 and K8 (row counts 0..nt) against their plain
    versions bit for bit, hashed, K4 timed."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce

    S, nt, tags = CV_BLOCK_SHAPE
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    y = put(rng.standard_normal((S, nt, tags)) + 3.0)
    pred = put(y.cpu().numpy() + 0.3 * rng.standard_normal((S, nt, tags)))
    tag = (pred - y).abs().contiguous()
    total = tag.norm(dim=-1).contiguous()
    counts = rng.integers(0, nt + 1, S)
    counts[:3] = [0, 1, nt]
    out = {"shape": list(CV_BLOCK_SHAPE), "path": plan_path(ce, nt, tags)}
    check(out["path"] in (None, "block"), f"cv_epilogue at {CV_BLOCK_SHAPE} takes the block path ({out['path']})")
    for masked, n_rows in ((False, None), (True, counts)):
        args = (tag, total, pred, y, n_rows)
        got = ce.cv_epilogue(*args, masked=masked)
        ref = ce.cv_epilogue_plain(*args, masked=masked)
        key = "masked" if masked else "exact"
        out[key] = {"differing": sum(differing(ref[k], got[k]) for k in ref), "hashes": output_hashes(got)}
        check(out[key]["differing"] == 0, f"cv_epilogue block path {key}: bit for bit its plain version")
        if not masked:
            elems = S * nt * tags
            out[key].update(bound(4 * (3 * elems + S * nt + S * (tags + 5)),
                                  elems * (ce.SMOOTHING_WINDOW + 12) + S * nt * ce.SMOOTHING_WINDOW))
            time_entry(out[key], lambda: ce.cv_epilogue(*args), lambda: ce.cv_epilogue_plain(*args), 20, 2)
    return out


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
    # a min and a max in any order, the same roundings: bit for bit
    entries["scaler_stats"]["differing"] = differing(scale_p, scale) + differing(offset_p, offset)
    entries["scaler_stats"]["hashes"] = {"scale": output_hash(scale), "offset": output_hash(offset)}
    entries["scaler_stats"]["path"] = plan_path(ss, X.shape, row_lists)
    check(entries["scaler_stats"]["differing"] == 0,
          f"scaler_stats: bit for bit its plain version ({entries['scaler_stats']['differing']} differ)")

    # K1 + K2: the three fold fits and the final fit of every machine
    params0, perms = put_draws(fleet_draws, 0, dims, fits, cfg.epochs, X.device)
    draw = np.zeros(machines, np.int64)
    args = (X, X, fits, params0, perms, draw, acts, cfg.epochs, hp)
    kw = dict(chain=[minmax_step(scale, offset)])
    run = lambda: ff.fleet_fit(*args, **kw)  # noqa: E731
    plain = lambda: ff.fleet_fit_plain(*args, **kw)  # noqa: E731
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
        x_oof, flat, acts, chain=[minmax_step(scale.reshape(machines * G, tags), offset.reshape(machines * G, tags))],
        det=minmax_step(expand(det_s), expand(det_o)),
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
    # the metrics sum in XLA's window order on both sides: bit for bit, on
    # these targets and on targets at a level of 1e4 (the order mattered)
    level = x_oof + 1e4
    far = ce.cv_epilogue(*epi_args[:3], level), ce.cv_epilogue_plain(*epi_args[:3], level)
    entries["cv_epilogue"]["differing"] = sum(differing(ref[k], got[k]) for k in ref)
    entries["cv_epilogue"]["differing_level_1e4"] = sum(differing(far[1][k], far[0][k]) for k in ref)
    check(entries["cv_epilogue"]["differing"] == 0 and entries["cv_epilogue"]["differing_level_1e4"] == 0,
          f"cv_epilogue: bit for bit its plain version ({entries['cv_epilogue']})")
    entries["cv_epilogue"]["hashes"] = output_hashes(got)
    entries["cv_epilogue"]["hashes_level_1e4"] = output_hashes(far[0])
    entries["cv_epilogue"]["path"] = plan_path(ce, nt, tags)
    entries["cv_epilogue"]["block_path"] = _cv_block_path_check(np.random.default_rng(SEED + 31))
    emit({"phase": "train_kernel_check", "shape": list(TRAIN_SHAPE), "kernels": entries})
    del X, layers, layers_p, scored, x_oof
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def phase_train():
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.serve.server import ModelCollection, make_server

    machines, rows, tags = TRAIN_SHAPE
    Xs = list(bench_fleet(np.random.default_rng(SEED + 3), machines, rows, tags))
    spec = analyze_definition(from_definition(DEFAULT_MODEL))
    check(spec is not None, "the default model is fleetable")
    builder = FleetDiffBuilder(spec, device=None if DEVICE == "cuda" else DEVICE)
    counters = _ff_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    pending = builder.dispatch(Xs)
    dispatch_seconds = time.perf_counter() - t0
    detectors = pending.collect()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    if DEVICE == "cuda":
        # one length group: 1 fit launch, 2 stats (pipeline, detector), 1
        # out-of-fold scoring, 1 epilogue
        expected = _expected_launches(spec, pending)
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


#: the stream's launch of an LSTM detector's layers: one machine's ring of
#: SMOOTH_WINDOW + LOOKBACK - 1 rows, its SMOOTH_WINDOW windows
LSTM_STREAM_ROWS = SMOOTH_WINDOW + LOOKBACK - 1


def lstm_stream_shape(net, x, scale, offset, rows: int = LOOKBACK) -> dict:
    """The six ``lstm_layer`` launches at a stream's shape (machine 0 of the
    bucket, its first ``rows`` rows: LOOKBACK, one window, a streamed
    row's launch; LSTM_STREAM_ROWS, the window's 144, the launch that
    primes a stream), each fed the kernel's output of the layer before and
    held to its plain version; the layers' summed device times, plain
    times and ``torch.nn.LSTM`` times (one call a layer), and their
    bound."""
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.ops.windows import make_windows

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[:1])).to(x.device)  # noqa: E731
    s1, o1 = scale[:1].contiguous(), offset[:1].contiguous()
    h = x[:1, :rows].contiguous()
    layers = []
    for i, cell in enumerate(net["cells"]):
        ki, kh, b = (put(a) for a in cell)
        n_in, hidden = int(ki.shape[1]), int(kh.shape[1])
        first, last = i == 0, i == len(net["cells"]) - 1
        kw = dict(lookback=LOOKBACK, act="tanh", last=last, chain=[minmax_step(s1, o1)] if first else None)
        inp = h
        run = lambda: ll.lstm_layer(inp, ki, kh, b, **kw)  # noqa: E731
        plain = lambda: ll.lstm_layer_plain(inp, ki, kh, b, **kw)  # noqa: E731
        got, ref = run(), plain()
        err = norm_err(ref, got)
        check(err <= LSTM_TOLERANCE["lstm_layer"],
              f"lstm_layer {i} at the stream's shape within {LSTM_TOLERANCE['lstm_layer']}: {err}")
        entry = {"layer": i, "widths": [n_in, hidden], "max_norm_err": err,
                 "max_abs_err": float((ref.double() - got.double()).abs().max())}
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, 50)
            entry["plain_ms"], _ = time_calls_ms(plain, 5)
            wins = make_windows(inp * s1[:, None] + o1[:, None], LOOKBACK)[0] if first else inp[0]
            lstm = _torch_lstm(ki[0], kh[0], b[0])

            def library():
                with torch.no_grad():
                    return torch.tanh(lstm(wins)[0])

            entry["library_ms"], _ = time_calls_ms(library, 20)
        entry.update(bound(*lstm_layer_cost(1, rows, n_in, hidden, first, last)))
        layers.append(entry)
        h = got
    out = {"shape": [1, rows, int(x.shape[-1])], "windows": rows - LOOKBACK + 1, "layers": layers,
           "max_abs_err": max(e["max_abs_err"] for e in layers)}
    out.update({k: sum(e[k] for e in layers) for k in ("ms", "plain_ms", "library_ms") if k in layers[0]})
    out.update(lstm_layer_bound(1, rows, net["dims"]))
    return out


def lstm_layer_variants(rng, net, x, scale, offset):
    """``lstm_layer`` on what the bucket-wide check does not reach: a
    subset of the bucket's machines by stack position (``idx``) with ragged
    windows per slot, the forecast's one-fewer windows, lookback 1, and a
    chain of a Standard and a MinMax step on rows far from zero (each step
    in its own form)."""
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import scaler_stats as ss

    machines, n, _ = x.shape
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(x.device)  # noqa: E731
    (ki0, kh0, b0), (ki1, kh1, b1) = ([put(a) for a in c] for c in net["cells"][:2])
    out = []
    m_sub = min(8, machines)
    idx = np.sort(rng.choice(machines, m_sub, replace=False))[::-1].copy()
    windows = rng.integers(1, n - LOOKBACK + 2, m_sub)
    xs = x[:m_sub].contiguous()
    level = xs + 1e3
    chain = [(ss.CENTER, level.mean(1).contiguous(), (level.std(1) + 0.1).contiguous()),
             (ss.AFFINE, scale[:m_sub].contiguous(), offset[:m_sub].contiguous())]
    for name, kw in (
        ("subset_ragged", dict(lookback=LOOKBACK, idx=idx, slot_windows=windows)),
        ("forecast_windows", dict(lookback=LOOKBACK, n_windows=n - LOOKBACK)),
        ("lookback_1", dict(lookback=1)),
        ("uncentred_chain", dict(lookback=LOOKBACK)),
    ):
        counts = windows if "slot_windows" in kw else [kw.get("n_windows", n - kw["lookback"] + 1)] * m_sub
        first = dict(kw, act="tanh", chain=[minmax_step(scale, offset)])
        if name == "uncentred_chain":
            first = dict(kw, act="tanh", chain=chain)
            weights0 = [a[:m_sub].contiguous() for a in (ki0, kh0, b0)]
            weights1 = [a[:m_sub].contiguous() for a in (ki1, kh1, b1)]
            got0 = ll.lstm_layer(level, *weights0, **first)
            ref0 = ll.lstm_layer_plain(level, *weights0, **first)
            err0, abs0 = _valid_err(ref0, got0, counts, f"lstm_layer {name} (rows)", LSTM_TOLERANCE["lstm_layer"])
            out.append({"variant": name, "max_norm_err": err0, "max_abs_err": abs0})
            continue
        if "idx" not in kw:
            first.update(chain=[minmax_step(scale[:m_sub].contiguous(), offset[:m_sub].contiguous())])
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


#: the parent design's figures beside which the smoke prints the
#: redesigned LSTM kernels' (``lstm_redesign_line``): each the mean of the
#: parent tree's runs of these phases before and after the redesign's in
#: one call (PERF.md §6, "NVIDIA H100 80GB HBM3, 700.00 W")
PARENT_LSTM = {"lstm_layer_ms": 25.485, "lstm_layer_stream_ms": 0.6869, "lstm_layer_bwd_ms": 8.677,
               "lstm_build_seconds": 1.093}


#: the parent design's figures beside which the smoke prints the
#: redesigned fleet_init and fake_quant (``init_quant_redesign_line``):
#: each the mean of the parent tree's runs of these phases before and
#: after the redesign's in one call (PERF.md §6, "NVIDIA H100 80GB HBM3,
#: 700.00 W")
PARENT_FLEET_INIT = {"bucket_ms": 1.25268, "lstm_seed_ms": 0.031284, "year_ms": 2.538686}
PARENT_FAKE_QUANT = {"default_bucket_ms": 0.225414, "lstm_bucket_ms": 0.94417, "int8_launches": 9450,
                     "int8_load_seconds": 6.881269}


def init_quant_redesign_line(fleet_init_kernels: dict, precision_kernels: dict, precision: dict) -> dict:
    """``fleet_init`` at the bench's bucket, an LSTM seed and a year's
    permutation (with ``torch.randperm``'s time there), ``fake_quant`` over
    each bucket's leaves, and the int8 load's seconds and launches, beside
    the parent design's (PARENT_FLEET_INIT, PARENT_FAKE_QUANT)."""
    fq = precision_kernels["fake_quant"]["variants"]
    int8 = precision["dtypes"]["int8"]
    return {"phase": "init_quant_redesign",
            "fleet_init_bucket_ms": fleet_init_kernels["hourglass_bucket"].get("ms"),
            "fleet_init_lstm_seed_ms": fleet_init_kernels["lstm_hourglass"].get("ms"),
            "fleet_init_year_ms": fleet_init_kernels["year_permutation"].get("ms"),
            "randperm_year_ms": fleet_init_kernels["year_permutation"].get("library_ms"),
            "fake_quant_default_bucket_ms": fq["default_bucket"].get("ms"),
            "fake_quant_lstm_bucket_ms": fq["lstm_bucket"].get("ms"),
            "int8_load_seconds": int8["load_seconds"], "int8_launches": int8["launches"]["fake_quant"],
            "parent": {"fleet_init": PARENT_FLEET_INIT, "fake_quant": PARENT_FAKE_QUANT}}


#: the parent design's figures beside which the smoke prints the
#: redesigned fleet_score and chain_apply (``score_chain_redesign_line``):
#: each the mean of the parent tree's runs of the kernel-check phases
#: before and after the redesign's in one call (``scripts/chip_phases.py``,
#: PERF.md §6, "NVIDIA H100 80GB HBM3, 700.00 W"); the streamed row's
#: chain_apply from the parent's final smoke run (``torch.profiler``)
PARENT_FLEET_SCORE = {"f32_ms": 0.215373, "bf16_ms": 0.213205, "wide_ms": 0.078639, "lstm_head_ms": 0.551174,
                      "epilogue_ms": 0.094313}
PARENT_CHAIN_APPLY = {"chain_c_f32_ms": 0.119307, "chain_c_bf16_ms": 0.120133, "chain_c_bf16_out_ms": 0.116472,
                      "standard_inverse_ms": 0.06987, "robust_inverse_ms": 0.06981, "chain_a_ms": 0.006228,
                      "stream_row_ms": 0.00199185}


def score_chain_redesign_line(shapes: list, lstm_kernels: dict, precision_kernels: dict, transform_kernels: dict,
                              transform_serve_kernels: dict, transform_serve: dict, container_kernels: dict) -> dict:
    """``fleet_score`` at the bench's bucket (f32, bf16), the 128-tag shape,
    the LSTM head and the epilogue alone at 512 × 2048 × 10, and
    ``chain_apply`` on the stacked chain C (three instantiations), the
    stacked Standard and Robust inverses (with ``torch.addcmul``'s time by
    the same events), chain A and a streamed chain-C row, beside the
    parent design's (PARENT_FLEET_SCORE, PARENT_CHAIN_APPLY)."""
    rows, tags = TRANSFORM_SHAPES[0]
    stacked = "x".join(str(v) for v in CONTAINER_SHAPES[-1])
    stream = transform_serve["stream"]["float32"].get("kernel_ms_by_name", {})
    return {"phase": "score_chain_redesign",
            "fleet_score": {"f32_ms": shapes[0].get("ms"), "bf16_ms": precision_kernels["fleet_score_bf16"].get("ms"),
                            "wide_ms": shapes[1].get("ms"),
                            "lstm_head_ms": lstm_kernels["fleet_score_lstm_head"].get("ms"),
                            "epilogue_ms": container_kernels[f"epilogue_thresholds_{stacked}"].get("ms")},
            "chain_apply": {"chain_c_f32_ms": transform_serve_kernels["float32"].get("ms"),
                            "chain_c_bf16_ms": transform_serve_kernels["bfloat16"].get("ms"),
                            "chain_c_bf16_out_ms": transform_serve_kernels["bfloat16_out"].get("ms"),
                            "standard_inverse_ms": container_kernels[f"standard_inverse_{stacked}"].get("ms"),
                            "robust_inverse_ms": container_kernels[f"robust_inverse_{stacked}"].get("ms"),
                            "chain_a_ms": transform_kernels[f"chain_a_{rows}x{tags}"].get("ms"),
                            "stream_row_ms": sum(v for k, v in stream.items() if "chain_apply" in k) or None},
            "addcmul_ms": {"standard": container_kernels[f"standard_inverse_{stacked}"].get("library_ms"),
                           "robust": container_kernels[f"robust_inverse_{stacked}"].get("library_ms")},
            "parent": {"fleet_score": PARENT_FLEET_SCORE, "chain_apply": PARENT_CHAIN_APPLY}}


def lstm_redesign_line(lstm_kernels: dict, lstm_train_kernels: dict, lstm_train: dict) -> dict:
    """The redesigned LSTM kernels' times in this run beside the parent
    design's (PARENT_LSTM): ``lstm_layer`` at the bench's and the stream's
    shapes, ``lstm_layer_bwd`` per lockstep step, and the LSTM build's
    seconds."""
    fwd, bwd = lstm_kernels["lstm_layer"], lstm_train_kernels["lstm_layer_bwd"]
    return {"phase": "lstm_redesign",
            "lstm_layer_ms": fwd.get("ms"), "lstm_layer_bound_ms": fwd["bound_ms"],
            "lstm_layer_stream_ms": fwd["stream_prime_shape"].get("ms"),
            "lstm_layer_stream_bound_ms": fwd["stream_prime_shape"]["bound_ms"],
            "lstm_layer_stream_newest_ms": fwd["stream_shape"].get("ms"),
            "lstm_layer_bwd_ms": bwd.get("ms"), "lstm_layer_bwd_bound_ms": bwd["bound_ms"],
            "lstm_build_seconds": lstm_train["build_seconds"],
            "parent": PARENT_LSTM}


#: the parent design's figures beside which the smoke prints the
#: redesigned rolling_median and lstm_head_fit (``median_head_redesign_line``):
#: each the mean of the parent tree's runs of these phases before and after
#: the redesign's in one call (``scripts/chip_phases.py``, PERF.md §6,
#: "NVIDIA H100 80GB HBM3, 700.00 W")
PARENT_ROLLING_MEDIAN = {"lstm_bucket_ms": 5.030573, "default_bucket_ms": 8.153302, "longest_window_ms": 246.673108}
PARENT_HEAD_FIT = {"bench_step_ms": 0.051206, "batch_256_ms": 0.10985, "lstm_build_seconds": 0.589526}


def median_head_redesign_line(lstm_kernels: dict, lstm_train_kernels: dict, lstm_train: dict) -> dict:
    """``rolling_median`` at the LSTM bucket, the stacked default bucket and
    the longest window, ``lstm_head_fit`` on the bench's lockstep step and
    at a batch of 256 windows, and the LSTM build's seconds, beside the
    parent design's (PARENT_ROLLING_MEDIAN, PARENT_HEAD_FIT); with
    ``fleet_adam`` beside fused ``torch.optim.Adam`` by the same events."""
    med, head = lstm_kernels["rolling_median"], lstm_train_kernels["lstm_head_fit"]
    adam = lstm_train_kernels["fleet_adam"]
    return {"phase": "median_head_redesign",
            "rolling_median": {"lstm_bucket_ms": med.get("ms"), "default_bucket_ms": med["default_bucket"].get("ms"),
                               "longest_window_ms": med["longest_window"].get("ms")},
            "lstm_head_fit": {"bench_step_ms": head.get("ms"), "batch_256_ms": head["batch_256"].get("ms"),
                              "lstm_build_seconds": lstm_train["build_seconds"]},
            "fleet_adam": {"ms": adam.get("ms"), "fused_adam_ms": adam.get("library_ms"),
                           "fused_adam_window_ms": adam.get("library_window_ms")},
            "parent": {"rolling_median": PARENT_ROLLING_MEDIAN, "lstm_head_fit": PARENT_HEAD_FIT}}


#: cv_epilogue (K4, K8) and the MinMax statistic before their redesign
#: (PERF.md, the parent's final runs: K4 and K8 at 1,536 slots × 144 × 10,
#: MinMax at 512 × 576 × 10 over 4 row lists)
PARENT_EPILOGUE_MINMAX = {"k4_ms": 0.0494, "k8_ms": 0.0407, "minmax_ms": 0.0193}


def epilogue_minmax_redesign_line(train_kernels: dict, ragged_kernels: dict, scaler_kernels: dict) -> dict:
    """The redesigned cv_epilogue and MinMax statistic beside their
    parent designs' figures (``PARENT_EPILOGUE_MINMAX``), with the path
    each case took."""
    minmax = {k: {"path": e.get("path"), "ms": e.get("ms")} for k, e in scaler_kernels.items()
              if e["stat"] == "minmax"}
    return {
        "phase": "epilogue_minmax_redesign",
        "parent": PARENT_EPILOGUE_MINMAX,
        "k4": {"path": train_kernels["cv_epilogue"].get("path"), "ms": train_kernels["cv_epilogue"].get("ms")},
        "k8": {"path": ragged_kernels["cv_epilogue_masked"].get("path"),
               "ms": ragged_kernels["cv_epilogue_masked"].get("ms")},
        "block_path_k4_ms": train_kernels["cv_epilogue"]["block_path"]["exact"].get("ms"),
        "minmax": {"path": train_kernels["scaler_stats"].get("path"), "ms": train_kernels["scaler_stats"].get("ms")},
        "minmax_nan_padded_ms": ragged_kernels["scaler_stats_nan_padded"].get("ms"),
        "minmax_cases": minmax,
    }


#: the stacked default bucket (512 machines × 2048 rows × 10 tags, the
#: fleet_score bench's) smoothed over SMOOTH_WINDOW, and the slots of the
#: LSTM bucket smoothed over rolling_median.MAX_WINDOW (few, so that the
#: plain version's windows stay small)
MEDIAN_DEFAULT_SHAPE = KERNEL_SHAPES[0]
MEDIAN_LONGEST_SLOTS = 8


def with_holes(rng, tag: torch.Tensor) -> None:
    """NaNs in tag 3 of every slot: a tenth of its rows at random, and a
    run of 2 SMOOTH_WINDOW rows (all-NaN windows)."""
    machines, rows, _ = tag.shape
    holes = torch.from_numpy(rng.random((machines, rows)) < 0.1).to(tag.device)
    gap = min(1000, rows // 4)
    holes[:, gap: gap + 2 * SMOOTH_WINDOW] = True
    tag[:, :, 3] = torch.where(holes, torch.nan, tag[:, :, 3])


def median_case(tag, total, thr, window: int, reps: int = 20, plain_reps: int = 2, library=None):
    """``rolling_median`` against its plain version on one input: equal
    bit for bit (NaN in the same places), the kernel's output hashes, its
    time, the plain version's (and ``library``'s) and the bound.  Returns
    the entry and the plain version's outputs."""
    from gordo_tpu_torch.kernels import rolling_median as rm

    run = lambda: rm.rolling_median(tag, total, window, agg_thr=thr)  # noqa: E731
    plain = lambda: rm.rolling_median_plain(tag, total, window, agg_thr=thr)  # noqa: E731
    got, ref = run(), plain()
    machines, rows, tags = tag.shape
    errs, worst = {}, 0.0
    for k in ref:
        r, g = ref[k], got[k]
        check(bool(torch.equal(torch.isnan(r), torch.isnan(g))),
              f"rolling_median {k} (window {window}, {machines} slots): NaN exactly where the plain version has it")
        fin = ~torch.isnan(r)
        errs[k] = norm_err(r[fin], g[fin])
        worst = max(worst, float((r[fin].double() - g[fin].double()).abs().max()))
    check(all(e <= LSTM_TOLERANCE["rolling_median"] for e in errs.values()),
          f"rolling_median (window {window}, {machines} slots) within {LSTM_TOLERANCE['rolling_median']}: {errs}")
    entry = {"shape": [machines, rows, tags + 1], "window": window, "max_norm_err": errs, "max_abs_err": worst,
             "tolerance": LSTM_TOLERANCE["rolling_median"], "hashes": output_hashes(got)}
    del got
    time_entry(entry, run, plain, reps, plain_reps, library)
    elems = machines * rows * (tags + 1)
    # in: the scores, thresholds; out: the smoothed scores, confidence; an
    # order-statistic tree's compares an output, log2 of the window (a
    # sort's is more)
    entry.update(bound(4 * (2 * elems + int(thr.numel()) + machines * rows),
                       elems * max(1, (window - 1).bit_length())))
    return entry, ref


def default_bucket_median(rng) -> dict:
    """``median_case`` at the stacked default bucket: positive scores, a
    total per row, NaN holes as in the LSTM bucket's case."""
    machines, rows, tags = MEDIAN_DEFAULT_SHAPE
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    tag = put(np.abs(rng.standard_normal((machines, rows, tags))))
    total = tag.square().mean(-1).sqrt()
    with_holes(rng, tag)
    thr = put(rng.uniform(0.5, 2.0, machines))
    entry, ref = median_case(tag, total, thr, SMOOTH_WINDOW)
    del ref, tag, total
    return entry


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
    return {"machines": m_sub, "max_norm_err": errs, "max_abs_err": worst, "hashes": output_hashes(got, rows)}


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

    # every layer, fed what the kernel made for the layer before
    h = x
    for i, cell in enumerate(net["cells"]):
        ki, kh, b = (put(a) for a in cell)
        n_in, hidden = int(ki.shape[1]), int(kh.shape[1])
        first, last = i == 0, i == len(net["cells"]) - 1
        kw = dict(lookback=LOOKBACK, act="tanh", last=last,
                  chain=[minmax_step(scale, offset)] if first else None)
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
        time_entry(entry, run, plain, 5, library=library)
        entry.update(bound(*lstm_layer_cost(machines, n, n_in, hidden, first, last)))
        layers.append(entry)
        h = got
        if DEVICE == "cuda":
            del wins, nets, library
            torch.cuda.empty_cache()
    total = {k: sum(e[k] for e in layers) for k in ("ms", "plain_ms", "library_ms") if k in layers[0]}
    total.update(lstm_layer_bound(machines, n, net["dims"]))
    entries["lstm_layer"] = {"layers": layers, "tolerance": LSTM_TOLERANCE["lstm_layer"], **total,
                             "variants": lstm_layer_variants(rng, net, x, scale, offset),
                             "stream_shape": lstm_stream_shape(net, x, scale, offset),
                             "stream_prime_shape": lstm_stream_shape(net, x, scale, offset, LSTM_STREAM_ROWS)}
    entries["lstm_layer"]["max_abs_err"] = max(
        [e["max_abs_err"] for e in layers] + [v["max_abs_err"] for v in entries["lstm_layer"]["variants"]]
        + [entries["lstm_layer"][k]["max_abs_err"] for k in ("stream_shape", "stream_prime_shape")])

    # the head and detector epilogue: fleet_score on the final states
    W, bh = put(net["head"][0]), put(net["head"][1])
    hidden = int(W.shape[1])
    det = dict(det=minmax_step(put(net["det_scale"]), put(net["det_offset"])), y=x, y_offset=LOOKBACK - 1)
    run = lambda: fs.fleet_score(h, [(W, bh)], ["linear"], **det)  # noqa: E731
    plain = lambda: fs.fleet_score_plain(h, [(W, bh)], ["linear"], **det)  # noqa: E731
    got, ref = run(), plain()
    check(all(bool(v.isfinite().all()) for v in got.values()), "LSTM head is finite")
    errs = {k: norm_err(ref[k], got[k]) for k in ref}
    check(all(e <= LSTM_TOLERANCE["fleet_score"] for e in errs.values()),
          f"LSTM head within {LSTM_TOLERANCE['fleet_score']}: {errs}")
    head = {"shape": [machines, nw, hidden, tags], "max_norm_err": errs,
            "max_abs_err": max(float((ref[k].double() - got[k].double()).abs().max()) for k in ref),
            "hashes": output_hashes(got)}
    time_entry(head, run, plain, 20)
    head.update(bound(4 * (machines * nw * (hidden + tags)  # states, targets
                           + machines * (hidden * tags + 3 * tags)  # head, detector stats
                           + machines * nw * (2 * tags + 1)),  # pred, tags, total
                      2 * machines * nw * hidden * tags))
    entries["fleet_score_lstm_head"] = head

    # the detector's smoothing, with NaNs in one tag's column
    tag = got["tag-anomaly-scores"].clone()
    total_score = got["total-anomaly-score"]
    with_holes(rng, tag)
    thr = put(net["agg"])

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

    median, ref_m = median_case(tag, total_score, thr, SMOOTH_WINDOW, library=library)
    gap = min(1000, nw // 4)
    check(bool(torch.isnan(ref_m["tag-anomaly-scores"][:, gap + 2 * SMOOTH_WINDOW - 1, 3]).all()),
          "an all-NaN window gives NaN")
    del ref_m
    subset = rolling_median_variant(rng, tag, total_score, thr)
    median["subset"] = subset
    median["max_abs_err"] = max(median["max_abs_err"], subset["max_abs_err"])
    # the stacked default bucket's smoothing, and the longest window on a
    # few of this bucket's slots
    median["default_bucket"] = default_bucket_median(rng)
    few = MEDIAN_LONGEST_SLOTS
    median["longest_window"], _ = median_case(tag[:few].contiguous(), total_score[:few].contiguous(),
                                              thr[:few].contiguous(), rm.MAX_WINDOW, reps=5, plain_reps=1)
    for case in ("default_bucket", "longest_window"):
        median["max_abs_err"] = max(median["max_abs_err"], median[case]["max_abs_err"])
    entries["rolling_median"] = median
    emit({"phase": "lstm_kernel_check", "shape": list(LSTM_SHAPE), "lookback": LOOKBACK,
          "kernels": entries})
    del x, h, got, ref, tag
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
    from gordo_tpu_torch import serializer
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
        if i < ae_count:
            models[f"lstm-ae-{i}"] = (LSTM_MODEL, lstm_params(net, i), net, i)
        else:
            models["lstm-forecast"] = (forecast, lstm_params(net, i), net, i)
    models["ff-window"] = (with_window(DEFAULT_MODEL), dense_params(ff, 0), ff, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lstm_") as tmp:
        for name, (definition, params, src, i) in models.items():
            model = port_detector(definition, params, src, i)
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


# -- LSTM training ---------------------------------------------------------

#: the bench's LSTM build (BASELINE config 2; bench.py:49-51,248-266,273,815):
#: 64 machines x 576 rows x 50 tags, lookback 12, 10 epochs, batch 64,
#: TimeSeriesSplit(3)
LSTM_TRAIN_SHAPE = (64, 576, 50)
LSTM_TRAIN_MODEL = json.loads(json.dumps(LSTM_MODEL))
LSTM_TRAIN_MODEL["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
    "gordo_tpu.pipeline.Pipeline"]["steps"][1]["gordo_tpu.models.estimator.LSTMAutoEncoder"].update(
    epochs=10, batch_size=64)
#: the training kernels are also checked on one step of this many machines
#: at the default TrainConfig's batch (256 windows)
LSTM_VARIANT_MACHINES, LSTM_VARIANT_BATCH = 4, 256
#: machines of the LSTM build that are built again as forecast detectors
LSTM_FORECAST_MACHINES = 8
#: the minibatch the training kernels are checked on: epoch 0, step 2 (the
#: first fold's last, which has padding windows) for the layers and the
#: head; step 4 (the first fold inactive) for Adam
CHECK_STEP, ADAM_STEP = 2, 4
#: LSTM training kernels against their plain versions on the card, max
#: |kernel - plain| / max |plain| per output (fp32; measured on an H100
#: 80GB HBM3 at 700 W, values in PERF.md): the forward computes what the
#: plain version does in its op order (measured 0); the backward and the
#: head sum their gradients over windows and steps in another order than
#: the plain version's autograd, and take the derivatives in JAX's forms
#: (measured <= 6.5e-7 and <= 3.3e-7); Adam rounds each operation as the
#: plain version's PyTorch operations do (measured 0)
LSTM_TRAIN_TOLERANCE = {"lstm_layer_train": 1e-5, "lstm_layer_bwd": 1e-4, "lstm_head_fit": 1e-5,
                        "fleet_adam": 1e-6}
#: the card's LSTM build against the plain lockstep fit on the card, per
#: machine and leaf (measured as above): 90 dependent Adam steps divide by
#: sqrt(nu), which amplifies the gradients' sum order where gradients are
#: small.  The median machine's leaves differ by <= 4.2e-7, the worst
#: machine's worst leaf (a 25-unit layer's bias, 100 values from zero) by
#: 1.5e-4, hence 1e-3 on params; the history (7.5e-7), thresholds
#: (2.4e-6) and CV scores (<= 5.1e-6) move far less
LSTM_BUILD_TOLERANCE = {"params": 1e-3, "history": 1e-5, "thresholds": 1e-4,
                        "explained_variance_score": 1e-3, "r2_score": 1e-3,
                        "mean_squared_error": 1e-3, "mean_absolute_error": 1e-3}


def distinct_rows(win: np.ndarray, n_real: np.ndarray, lookback: int) -> np.ndarray:
    """Rows each minibatch's real windows cover (``win`` (..., B) window
    ids, real ones first; ``n_real`` (...)): the first LSTM layer's input
    product and its weight gradient depend on the row alone."""
    B = win.shape[-1]
    real = np.arange(B) < n_real[..., None]
    ids = np.where(real, win, np.iinfo(np.int32).max).astype(np.int64)
    ids.sort(axis=-1)
    gaps = np.minimum(np.diff(ids, axis=-1), lookback)
    gaps = np.where(real[..., 1:], gaps, 0)  # real is a prefix, so sorted order keeps it
    return np.where(n_real > 0, lookback + gaps.sum(-1), 0)


def lstm_step_cost(dims, n_real: np.ndarray, distinct: np.ndarray, lookback: int,
                   n_slots: int, active: int):
    """(bytes, FLOPs) of one lockstep step of each training kernel, summed
    over its slots (``n_real`` and ``distinct`` per slot): inputs read
    once, outputs written once.  Per real window-step a layer's forward
    needs 8H(in + H) FLOP (its hidden product, and its input product
    unless it is the first layer, whose input product is needed once per
    distinct row); its backward dh and dx (not into the first layer),
    and the two weight gradients (the first layer's input-side one once per
    distinct row).  The head needs 6 H Fo per real window; Adam 12 FLOP
    and 28 bytes per parameter of each active slot."""
    ws = int(n_real.sum()) * lookback
    rows = int(distinct.sum())
    fwd_b = fwd_f = bwd_b = bwd_f = 0
    for i, (n_in, h) in enumerate(zip(dims[:-2], dims[1:-1])):
        first, last = i == 0, i == len(dims) - 3
        weights = n_slots * 4 * h * (n_in + h + 1)
        inp = rows * n_in if first else ws * n_in
        out = (int(n_real.sum()) if last else ws) * h
        saves = ws * 5 * h
        fwd_b += 4 * (inp + weights + out + saves)
        fwd_f += ws * 8 * h * h + (rows if first else ws) * 8 * h * n_in
        bwd_b += 4 * (inp + weights + saves + out + (0 if first else ws * n_in) + weights)
        bwd_f += ws * 16 * h * h + (rows * 8 * h * n_in if first else ws * 16 * h * n_in)
    h, fo = dims[-2], dims[-1]
    real = int(n_real.sum())
    head = (4 * (real * (2 * h + fo) + n_slots * (2 * (h * fo + fo) + 1)), real * 6 * h * fo)
    n_params = sum(4 * h * (n_in + h + 1) for n_in, h in zip(dims[:-2], dims[1:-1])) + h * fo + fo
    adam = (28 * active * n_params, 12 * active * n_params)
    return {"lstm_layer_train": (fwd_b, fwd_f), "lstm_layer_bwd": (bwd_b, bwd_f),
            "lstm_head_fit": head, "fleet_adam": adam}


def lstm_fit_bound(steps, dims, lookback: int, machines: int, rows: int):
    """Least time for a whole lockstep LSTM fit (every fold fit and the
    final fit of every machine, every epoch): the FLOPs of every step's
    kernels for this run's minibatches (lstm_step_cost), against the rows,
    targets, tables and initial params read once and the fitted params and
    histories written once."""
    win = steps.win.cpu().numpy()
    n_real = steps.n_windows.cpu().numpy()
    count = steps.count.cpu().numpy()
    distinct = distinct_rows(win, n_real, lookback)
    flops = 0
    for e in range(win.shape[0]):
        for s in range(win.shape[1]):
            costs = lstm_step_cost(dims, n_real[e, s], distinct[e, s], lookback, win.shape[2],
                                   int((count[e, s] > 0).sum()))
            flops += sum(c[1] for c in costs.values())
    n_params = sum(4 * h * (n_in + h + 1) for n_in, h in zip(dims[:-2], dims[1:-1])) + dims[-2] * dims[-1] + dims[-1]
    S = win.shape[2]
    nbytes = 4 * (2 * machines * rows * dims[0] + win.size + 3 * n_real.size + n_params
                  + S * (n_params + win.shape[0]))
    return bound(nbytes, flops)


def _lstm_library_fwd(x, cells, batch, valid, scale, offset, layer: int, last: bool):
    """``torch.nn.LSTM`` (cuDNN, TF32 off) of one layer, one slot a call,
    on each slot's real windows (the first layer's materialised and
    scaled), then tanh: the library's nearest call to the training-mode
    layer."""
    ki, kh, b = cells[layer]
    if x.dim() == 3:
        x = batch.gather(x, LOOKBACK) * scale[:, None, None] + offset[:, None, None]
    nets = [_torch_lstm(ki[s], kh[s], b[s]) for s in range(ki.shape[0])]
    inputs = [x[s, : valid[s]].contiguous() for s in range(ki.shape[0])]

    def library():
        with torch.no_grad():
            return [torch.tanh(nets[s](inputs[s])[0]) for s in range(len(nets))]
    return library, nets, inputs


def head_fit_hashes(out, valid) -> dict:
    """``output_hash`` of each output of ``lstm_head_fit``, ``dh`` over
    each slot's real windows only (the rest is unspecified)."""
    loss, dW, db, dh = out
    return {"loss": output_hash(loss), "dW": output_hash(dW), "db": output_hash(db), "dh": output_hash(dh, valid)}


#: a head whose rows padded to 16 bytes do not fit a block (4 slots, 256
#: windows, 42 -> 85): lstm_head_fit's plan takes the first design's layout
HEAD_FIRST_LAYOUT = (4, 256, 42, 85)


def random_head_step(rng, slots: int, windows: int, hidden: int, fo: int, device=None):
    """Seeded inputs of one ``lstm_head_fit`` step: ``(h, W, b, y, batch,
    n_real)``, each slot's real windows between half the batch and all of
    it, every tenth slot without one, its windows drawn from a row list
    of 400 of the 576 rows of one of 64 machines."""
    from gordo_tpu_torch.kernels.lstm_layer import Minibatch

    put = lambda a, t=np.float32: torch.from_numpy(np.ascontiguousarray(a, t)).to(device or DEVICE)  # noqa: E731
    n, per_fit = 576, 400
    n_real = np.minimum(rng.integers(windows // 2, 2 * windows, slots), windows)
    n_real[::10] = 0
    win = np.full((slots, windows), -1)
    for s in range(slots):
        win[s, : n_real[s]] = rng.integers(0, per_fit - LOOKBACK, n_real[s])
    rows = np.concatenate([np.sort(rng.choice(n, per_fit, replace=False)) for _ in range(slots)])
    batch = Minibatch(put(win, np.int32), put(n_real, np.int32), put(rows, np.int32),
                      put(np.arange(slots) * per_fit, np.int32), put(np.arange(slots) % 64, np.int32))
    h = put(np.tanh(rng.standard_normal((slots, windows, hidden))))
    W = put(rng.standard_normal((slots, hidden, fo)) / hidden ** 0.5)
    b, y = put(0.1 * rng.standard_normal((slots, fo))), put(rng.standard_normal((64, n, fo)))
    return h, W, b, y, batch, n_real


def head_first_layout_check(rng) -> dict:
    """``lstm_head_fit`` on HEAD_FIRST_LAYOUT against its plain version
    (the plan's other layout: one float a load)."""
    from gordo_tpu_torch.kernels import lstm_head_fit as hf

    slots, windows, hidden, fo = HEAD_FIRST_LAYOUT
    h, W, b, y, batch, n_real = random_head_step(rng, slots, windows, hidden, fo)
    kw = dict(batch=batch, shift=LOOKBACK - 1, act="linear")
    run = lambda: hf.lstm_head_fit(h, W, b, y, **kw)  # noqa: E731
    got, ref = run(), hf.lstm_head_fit_plain(h, W, b, y, **kw)
    tol = LSTM_TRAIN_TOLERANCE["lstm_head_fit"]
    errs = {}
    for k, r, g in zip(("loss", "dW", "db"), ref[:3], got[:3]):
        check(bool(g.isfinite().all()), f"lstm_head_fit first layout {k} is finite")
        errs[k] = norm_err(r, g)
    errs["dh"], _ = _valid_err(ref[3], got[3], n_real, "lstm_head_fit first layout dh", tol)
    check(all(e <= tol for e in errs.values()), f"lstm_head_fit first layout within {tol}: {errs}")
    entry = {"shape": list(HEAD_FIRST_LAYOUT), "max_norm_err": errs, "hashes": head_fit_hashes(got, n_real),
             "vec": hf.launch_plan(hidden, fo, windows).vec}
    check(entry["vec"] == 1, "HEAD_FIRST_LAYOUT takes the first design's layout")
    if DEVICE == "cuda":
        entry["ms"], entry["host_ms"] = time_ms(run, 20)
    return entry


def _real_windows_only(out: torch.Tensor, batch) -> torch.Tensor:
    """A training-mode layer's output with zeros past each slot's real
    windows: the kernel leaves padding windows unwritten (no kernel reads
    them); the plain versions compute them, weighted 0, so they get zeros
    rather than what the allocator's reused memory holds (a NaN there
    would reach the plain gradients as NaN * 0)."""
    real = batch.weights() > 0
    return out.masked_fill(~real.reshape(real.shape + (1,) * (out.dim() - 2)), 0.0)


def _lstm_train_variant(X, row_lists, scale, offset, off, hp, batch_size: int) -> dict:
    """The four training kernels against their plain versions on one
    lockstep step of a few machines at another batch size (the default
    ``TrainConfig``'s 256 windows: other shared-memory plans), each fed
    what the kernel before it made; max normalised error per kernel."""
    from gordo_tpu_torch.kernels import fleet_adam as fa
    from gordo_tpu_torch.kernels import lstm_head_fit as hf
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import lstm_layer_bwd as lb
    from gordo_tpu_torch.kernels.lstm_layer import Minibatch
    from gordo_tpu_torch.parallel.fleet import LSTMDims, fleet_draws, put_lstm_draws
    from gordo_tpu_torch.train.lstm_fit import plan_steps, window_fit

    machines, _, tags = X.shape
    fits = [window_fit(r, batch_size, off) for r in row_lists]
    S = machines * len(fits)
    dims = LSTMDims(hourglass(tags))
    _, perms = put_lstm_draws(fleet_draws, 1, dims, fits, 1, X.device)
    steps = plan_steps(fits, machines, perms, np.zeros(machines, np.int64), 1, hp, X.device)
    batch = Minibatch(steps.win[0, 0], steps.n_windows[0, 0], steps.rows, steps.row_off, steps.x_mach)
    valid = batch.n_windows.cpu().numpy()
    net = random_lstm(np.random.default_rng(SEED + 8), S, tags)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(X.device)  # noqa: E731
    cells = [tuple(put(a) for a in c) for c in net["cells"]]
    W, bh = put(net["head"][0]), put(net["head"][1])
    errs = {}

    def hold(name, ref, got, counts=None):
        tol = LSTM_TRAIN_TOLERANCE[name]
        if counts is None:
            check(bool(got.isfinite().all()), f"{name} at batch {batch_size} is finite")
            err = norm_err(ref, got)
            check(err <= tol, f"{name} at batch {batch_size} within {tol}: {err}")
        else:
            err, _ = _valid_err(ref, got, counts, f"{name} at batch {batch_size}", tol)
        errs[name] = max(errs.get(name, 0.0), err)

    h, inputs, saves = X, [], []
    for i, (ki, kh, b) in enumerate(cells):
        first = i == 0
        kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=i == len(cells) - 1,
                  chain=[minmax_step(scale[:S], offset[:S])] if first else None)
        got = ll.lstm_layer_train(h, ki, kh, b, **kw)
        ref = ll.lstm_layer_train_plain(h, ki, kh, b, **kw)
        for r, g in zip(ref, got):
            hold("lstm_layer_train", r, g, valid)
        inputs.append(h)
        saves.append(got[1:])
        h = _real_windows_only(got[0], batch)
    run = lambda: hf.lstm_head_fit(h, W, bh, X, batch=batch, shift=off, act="linear")  # noqa: E731
    got = run()
    ref = hf.lstm_head_fit_plain(h, W, bh, X, batch=batch, shift=off, act="linear")
    for r, g in zip(ref[:3], got[:3]):
        hold("lstm_head_fit", r, g)
    hold("lstm_head_fit", ref[3], got[3], valid)
    head = {"hashes": head_fit_hashes(got, valid)}
    if DEVICE == "cuda":
        head["ms"], head["host_ms"] = time_ms(run, 20)
    grads, dout = [None] * len(cells), got[3]
    for i in reversed(range(len(cells))):
        first = i == 0
        kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=i == len(cells) - 1,
                  chain=[minmax_step(scale[:S], offset[:S])] if first else None,
                  want_dx=not first)
        got_b = lb.lstm_layer_bwd(inputs[i], *cells[i], *saves[i], dout, **kw)
        ref_b = lb.lstm_layer_bwd_plain(inputs[i], *cells[i], dout, **kw)
        for r, g in zip(ref_b[1:], got_b[1:]):
            hold("lstm_layer_bwd", r, g)
        if not first:
            hold("lstm_layer_bwd", ref_b[0], got_b[0], valid)
        grads[i], dout = got_b[1:], got_b[0]
    leaves = [t for c in cells for t in c] + [W, bh]
    grad_leaves = [g for gs in grads for g in gs] + [got[1], got[2]]
    states = [([p.clone() for p in leaves], [torch.zeros_like(p) for p in leaves],
               [torch.zeros_like(p) for p in leaves]) for _ in range(2)]
    fa.fleet_adam(states[0][0], grad_leaves, states[0][1], states[0][2], steps.count[0, 0], steps.bc[0, 0], hp)
    fa.fleet_adam_plain(states[1][0], grad_leaves, states[1][1], states[1][2], steps.count[0, 0],
                        steps.bc[0, 0], hp)
    for group_got, group_ref in zip(states[0], states[1]):
        for g, r in zip(group_got, group_ref):
            hold("fleet_adam", r, g)
    return {"batch_size": batch_size, "slots": S, "real_windows": int(valid.sum()),
            "max_norm_err": errs, "lstm_head_fit": head}


def phase_lstm_train_kernel_check():
    from gordo_tpu_torch.kernels import fleet_adam as fa
    from gordo_tpu_torch.kernels import lstm_head_fit as hf
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import lstm_layer_bwd as lb
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.kernels.lstm_layer import Minibatch
    from gordo_tpu_torch.parallel.anomaly import analyze_definition
    from gordo_tpu_torch.parallel.fleet import LSTMDims, fleet_draws, put_lstm_draws
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import adam_hparams
    from gordo_tpu_torch.train.lstm_fit import plan_steps, window_fit

    machines, rows, tags = LSTM_TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 6)
    X = torch.from_numpy(bench_fleet(rng, machines, rows, tags)).to(DEVICE)
    spec = analyze_definition(from_definition(LSTM_TRAIN_MODEL))
    cfg, off = spec.train_cfg, spec.offset
    hp = adam_hparams(cfg)
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    row_lists = [tr for tr, _ in folds] + [np.arange(rows)]
    fits = [window_fit(r, cfg.batch_size, off) for r in row_lists]
    S = machines * len(fits)
    scale, offset = ss.scaler_stats(X, row_lists)
    scale, offset = scale.reshape(S, tags).contiguous(), offset.reshape(S, tags).contiguous()
    dims = LSTMDims(hourglass(tags))
    _, perms = put_lstm_draws(fleet_draws, 0, dims, fits, cfg.epochs, X.device)
    steps = plan_steps(fits, machines, perms, np.zeros(machines, np.int64), cfg.epochs, hp, X.device)
    # every slot its own weights, lecun-normal scaled, so no two slots agree
    net = random_lstm(rng, S, tags)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    cells = [tuple(put(a) for a in c) for c in net["cells"]]
    W, bh = put(net["head"][0]), put(net["head"][1])
    batch = Minibatch(steps.win[0, CHECK_STEP], steps.n_windows[0, CHECK_STEP], steps.rows,
                      steps.row_off, steps.x_mach)
    valid = batch.n_windows.cpu().numpy()
    win = batch.win.cpu().numpy()
    count = steps.count[0, ADAM_STEP].cpu().numpy()
    costs = lstm_step_cost(dims, valid, distinct_rows(win, valid, LOOKBACK), LOOKBACK, S,
                           int((count > 0).sum()))
    tol = LSTM_TRAIN_TOLERANCE
    entries = {name: {"layers": [], "tolerance": tol[name], "max_abs_err": 0.0, **bound(*costs[name])}
               for name in ("lstm_layer_train", "lstm_layer_bwd")}

    def hold(name, pairs, counts=None):
        """Max normalised and absolute error of each (ref, got) pair, over
        each slot's real windows when ``counts`` is given."""
        errs, worst = {}, 0.0
        for key, (ref, got) in pairs.items():
            if counts is not None:
                errs[key], a = _valid_err(ref, got, counts, f"{name} {key}", tol[name])
            else:
                check(bool(got.isfinite().all()), f"{name} {key} is finite")
                errs[key] = norm_err(ref, got)
                check(errs[key] <= tol[name], f"{name} {key} within {tol[name]}: {errs[key]}")
                a = float((ref.double() - got.double()).abs().max())
            worst = max(worst, a)
        return errs, worst

    # forward: every layer fed what the kernel made for the layer before
    h, inputs, saves = X, [], []
    for i, (ki, kh, b) in enumerate(cells):
        first, last = i == 0, i == len(cells) - 1
        kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=last,
                  chain=[minmax_step(scale, offset)] if first else None)
        inp = h
        run = lambda: ll.lstm_layer_train(inp, ki, kh, b, **kw)  # noqa: E731
        plain = lambda: ll.lstm_layer_train_plain(inp, ki, kh, b, **kw)  # noqa: E731
        got, ref = run(), plain()
        errs, worst = hold("lstm_layer_train", {"out": (ref[0], got[0]), "gates": (ref[1], got[1]),
                                                "cell": (ref[2], got[2])}, valid)
        entry = {"layer": i, "widths": [int(ki.shape[1]), int(kh.shape[1])], "max_norm_err": errs}
        library = None
        if DEVICE == "cuda":
            library, _, _ = _lstm_library_fwd(inp, cells, batch, valid, scale, offset, i, last)
        time_entry(entry, run, plain, 5, library=library)
        entries["lstm_layer_train"]["layers"].append(entry)
        entries["lstm_layer_train"]["max_abs_err"] = max(entries["lstm_layer_train"]["max_abs_err"], worst)
        inputs.append(inp)
        saves.append(got[1:])
        h = _real_windows_only(got[0], batch)
        del ref, library
    ll.train_launches = 0

    # the head, its loss and gradient
    run = lambda: hf.lstm_head_fit(h, W, bh, X, batch=batch, shift=off, act="linear")  # noqa: E731
    plain = lambda: hf.lstm_head_fit_plain(h, W, bh, X, batch=batch, shift=off, act="linear")  # noqa: E731
    got, ref = run(), plain()
    errs, worst = hold("lstm_head_fit", {"loss": (ref[0], got[0]), "dW": (ref[1], got[1]),
                                         "db": (ref[2], got[2])})
    errs_dh, worst_dh = hold("lstm_head_fit", {"dh": (ref[3], got[3])}, valid)
    head = {"max_norm_err": {**errs, **errs_dh}, "max_abs_err": max(worst, worst_dh),
            "tolerance": tol["lstm_head_fit"], "hashes": head_fit_hashes(got, valid),
            **bound(*costs["lstm_head_fit"])}
    time_entry(head, run, plain, 20)
    entries["lstm_head_fit"] = head
    head_grads, dout = [got[1], got[2]], got[3]

    # backward, last layer first, each fed the kernel's gradient from above
    grads = [None] * len(cells)
    for i in reversed(range(len(cells))):
        ki, kh, b = cells[i]
        first, last = i == 0, i == len(cells) - 1
        kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=last,
                  chain=[minmax_step(scale, offset)] if first else None, want_dx=not first)
        inp, (gates, cell), d = inputs[i], saves[i], dout
        run = lambda: lb.lstm_layer_bwd(inp, ki, kh, b, gates, cell, d, **kw)  # noqa: E731
        plain = lambda: lb.lstm_layer_bwd_plain(inp, ki, kh, b, d, **kw)  # noqa: E731
        got, ref = run(), plain()
        pairs = {"dkernel_i": (ref[1], got[1]), "dkernel_h": (ref[2], got[2]), "dbias": (ref[3], got[3])}
        errs, worst = hold("lstm_layer_bwd", pairs)
        if not first:
            errs_dx, worst_dx = hold("lstm_layer_bwd", {"dx": (ref[0], got[0])}, valid)
            errs.update(errs_dx)
            worst = max(worst, worst_dx)
        entry = {"layer": i, "widths": [int(ki.shape[1]), int(kh.shape[1])], "max_norm_err": errs}
        library = None
        if DEVICE == "cuda":
            # the library's gradient of the same layer: cuDNN's LSTM backward
            # through autograd, one slot a call, its forward taken first
            _, nets, lib_in = _lstm_library_fwd(inp, cells, batch, valid, scale, offset, i, last)
            outs, wants, douts = [], [], []
            for s, net_s in enumerate(nets):
                xs = lib_in[s].requires_grad_(not first)
                with torch.enable_grad():
                    o = torch.tanh(net_s(xs)[0])
                    outs.append(o[:, -1] if last else o)
                wants.append(([xs] if not first else []) + list(net_s.parameters()))
                douts.append(d[s, : valid[s]])

            def library():
                return [torch.autograd.grad(outs[s], wants[s], douts[s], retain_graph=True)
                        for s in range(len(outs))]
        time_entry(entry, run, plain, 5, library=library)
        entries["lstm_layer_bwd"]["layers"].append(entry)
        entries["lstm_layer_bwd"]["max_abs_err"] = max(entries["lstm_layer_bwd"]["max_abs_err"], worst)
        grads[i] = got[1:]
        dout = got[0]
        del ref, library
        if DEVICE == "cuda":
            del outs, wants, douts, nets
            torch.cuda.empty_cache()
    for name in ("lstm_layer_train", "lstm_layer_bwd"):
        layers = entries[name]["layers"]
        for k in ("ms", "plain_ms", "library_ms"):
            if k in layers[0]:
                entries[name][k] = sum(e[k] for e in layers)

    # Adam over every leaf of every slot, the first fold's slots inactive
    leaves = [t for c in cells for t in c] + [W, bh]
    grad_leaves = [g for gs in grads for g in gs] + head_grads
    moments = [(0.01 * torch.randn_like(p), 1e-4 * torch.rand_like(p)) for p in leaves]
    cnt, bc = steps.count[0, ADAM_STEP], steps.bc[0, ADAM_STEP]
    inactive = torch.from_numpy(count == 0).to(X.device)
    check(bool(inactive.any()) and not bool(inactive.all()), "the Adam step has active and inactive slots")

    def state():
        return ([p.clone() for p in leaves], [m.clone() for m, _ in moments],
                [v.clone() for _, v in moments])
    start, got_state, ref_state = state(), state(), state()
    fa.fleet_adam(got_state[0], grad_leaves, got_state[1], got_state[2], cnt, bc, hp)
    fa.fleet_adam_plain(ref_state[0], grad_leaves, ref_state[1], ref_state[2], cnt, bc, hp)
    for group, group0 in zip(got_state, start):
        for a, a0 in zip(group, group0):
            check(bool(torch.equal(a[inactive], a0[inactive])),
                  "fleet_adam leaves inactive slots alone, bit for bit")
    pairs = {f"{kind}{i}": (r, g) for kind, rs, gs in zip(("param", "mu", "nu"), ref_state, got_state)
             for i, (r, g) in enumerate(zip(rs, gs))}
    errs, worst = hold("fleet_adam", pairs)
    adam = {"max_norm_err": max(errs.values()), "max_abs_err": worst, "tolerance": tol["fleet_adam"],
            "active_slots": int((count > 0).sum()), "slots": S, **bound(*costs["fleet_adam"])}
    run = lambda: fa.fleet_adam(got_state[0], grad_leaves, got_state[1], got_state[2], cnt, bc, hp)  # noqa: E731
    plain = lambda: fa.fleet_adam_plain(ref_state[0], grad_leaves, ref_state[1], ref_state[2], cnt, bc, hp)  # noqa: E731
    library = None
    if DEVICE == "cuda":
        # PyTorch's fused Adam over the same leaves (every slot, one count)
        lib_params = [p.clone().requires_grad_(True) for p in leaves]
        for p, g in zip(lib_params, grad_leaves):
            p.grad = g.clone()
        opt = torch.optim.Adam(lib_params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]), eps=hp["eps"], fused=True)
        library = opt.step
    time_entry(adam, run, plain, 20, library=library)
    if DEVICE == "cuda":
        # the same call by the kernels' own events (no launch gaps), the
        # one-call window's figure kept beside it
        adam["library_window_ms"] = adam["library_ms"]
        adam["library_ms"], adam["library_host_ms"] = time_ms(library, 20)
    entries["fleet_adam"] = adam
    variant = _lstm_train_variant(X[:LSTM_VARIANT_MACHINES], row_lists, scale, offset, off, hp,
                                  LSTM_VARIANT_BATCH)
    entries["lstm_head_fit"]["batch_256"] = variant["lstm_head_fit"]
    entries["lstm_head_fit"]["first_layout"] = head_first_layout_check(rng)
    emit({"phase": "lstm_train_kernel_check", "shape": list(LSTM_TRAIN_SHAPE), "slots": S,
          "batch": cfg.batch_size, "lookback": LOOKBACK, "step": CHECK_STEP,
          "real_windows": int(valid.sum()), "kernels": entries, "variant": variant})
    del X, h, inputs, saves, grads, got, leaves, grad_leaves, got_state, ref_state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def _lstm_forecast_check(Xs, folds) -> dict:
    """The build program of an ``LSTMForecast`` bucket (targets one row
    after each window, one window fewer per test fold) through the kernels,
    held to its plain lockstep fit on the card, per machine."""
    from gordo_tpu_torch.parallel.anomaly import analyze_definition, exact_fleet_program
    from gordo_tpu_torch.serializer import from_definition

    definition = json.loads(json.dumps(LSTM_TRAIN_MODEL))
    steps = definition["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
        "gordo_tpu.pipeline.Pipeline"]["steps"]
    steps[1] = {"gordo_tpu.models.estimator.LSTMForecast":
                steps[1]["gordo_tpu.models.estimator.LSTMAutoEncoder"]}
    spec = analyze_definition(from_definition(definition))
    check(spec is not None and spec.window_mode == "forecast", "the forecast detector is fleetable")
    X = torch.from_numpy(np.stack(Xs)).to(DEVICE)
    with torch.no_grad():
        got = exact_fleet_program(spec, X, X, folds, final=True)
        ref = exact_fleet_program(spec, X, X, folds, final=True, route="plain")
    K, worst = len(folds), {}
    pairs = {"history": (ref["history"], got["history"]),
             "thresholds": (torch.cat([ref["feature_thresholds"], ref["aggregate_threshold"][:, None]], 1),
                            torch.cat([got["feature_thresholds"], got["aggregate_threshold"][:, None]], 1)),
             **{name: (ref["metrics"][name], got["metrics"][name]) for name in ref["metrics"]}}
    for i, (c_ref, c_got) in enumerate(zip(ref["cells"] + [ref["head"]], got["cells"] + [got["head"]])):
        for k, (a, b) in enumerate(zip(c_ref, c_got)):
            pairs[f"params{i}.{k}"] = (a[:, K], b[:, K])
    for key, (a, b) in pairs.items():
        check(bool(b.isfinite().all()), f"forecast {key} is finite")
        for m in range(len(Xs)):
            if bool(a[m].any()):
                kind = "params" if key.startswith("params") else key
                worst[kind] = max(worst.get(kind, 0.0), norm_err(a[m], b[m]))
    for key, err in worst.items():
        check(err <= LSTM_BUILD_TOLERANCE[key],
              f"LSTM forecast build vs the plain lockstep fit, {key}: {err} > {LSTM_BUILD_TOLERANCE[key]}")
    return {"machines": len(Xs), "vs_plain_lockstep_max_norm_err": worst}


def _profile_build(builder, Xs) -> dict:
    """One more build under ``torch.profiler``: the card's time by kernel
    (self device time of each kernel's events) and in all, and the build's
    wall time under the profiler (which slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        builder.build(Xs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_kernel = {}
    for evt in prof.key_averages():
        # the kernels and copies on the card (the host-side events that
        # launched them report the same time again)
        ms = evt.self_device_time_total / 1e3
        if evt.device_type == torch.autograd.DeviceType.CUDA and ms > 0:
            by_kernel[evt.key.split("(")[0][:60]] = {"ms": ms, "calls": evt.count}
    check(bool(by_kernel), "the profiler saw the card's kernels")
    return {"device_ms": sum(v["ms"] for v in by_kernel.values()), "profiled_wall_seconds": wall,
            "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms"])[:12])}


def phase_lstm_train():
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.parallel.anomaly import (
        FleetDiffBuilder,
        analyze_definition,
        exact_fleet_program,
        lstm_slot_state,
        module_for,
        scores_summary,
    )
    from gordo_tpu_torch.parallel.fleet import fleet_draws, lstm_chain_of, put_lstm_draws
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.serve.scorer import CompiledScorer
    from gordo_tpu_torch.serve.server import ModelCollection, make_server
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import adam_hparams
    from gordo_tpu_torch.train.lstm_fit import plan_steps, window_fit

    machines, rows, tags = LSTM_TRAIN_SHAPE
    Xs = list(bench_fleet(np.random.default_rng(SEED + 7), machines, rows, tags))
    spec = analyze_definition(from_definition(LSTM_TRAIN_MODEL))
    check(spec is not None and spec.window_mode == "ae", "the bench's LSTM detector is fleetable")
    builder = FleetDiffBuilder(spec, device=None if DEVICE == "cuda" else DEVICE)
    counters = _lstm_counters()
    # a first build pays the process's one-time costs of these kernels and
    # buffers; the counted build is the second
    t0 = time.perf_counter()
    builder.build(Xs)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    cold_seconds = time.perf_counter() - t0
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    pending = builder.dispatch(Xs)
    dispatch_seconds = time.perf_counter() - t0
    detectors = pending.collect()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    profile = _profile_build(builder, Xs) if DEVICE == "cuda" else {}
    if profile:
        profile["busy_share"] = profile["device_ms"] / 1e3 / seconds

    # what the build ran: the fits' lockstep steps, from the same tables
    cfg, hp = spec.train_cfg, adam_hparams(spec.train_cfg)
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    fits = [window_fit(r, cfg.batch_size, spec.offset) for r in [tr for tr, _ in folds] + [np.arange(rows)]]
    dims, _, _ = lstm_chain_of(module_for(spec, tags, tags))
    _, perms = put_lstm_draws(fleet_draws, spec.seed, dims, fits, cfg.epochs, "cpu")
    steps = plan_steps(fits, machines, perms, np.zeros(machines, np.int64), cfg.epochs, hp, "cpu")
    n_steps = cfg.epochs * max(fg.steps for fg in fits)
    if DEVICE == "cuda":
        expected = _expected_launches(spec, pending)
        check(launches == expected, f"LSTM build launches {launches}, expected {expected}")
    check(len(detectors) == machines, f"{len(detectors)} LSTM detectors built")
    for det in detectors:
        check(np.isfinite(det.feature_thresholds_).all() and np.isfinite(det.aggregate_threshold_),
              "LSTM thresholds finite")
        check(det.feature_thresholds_.shape == (tags,), "one threshold per tag")
        check(np.isfinite(det.base_estimator._final.history_).all(), "LSTM history finite")

    # the same build's program with the plain lockstep fit, on the card
    X = torch.from_numpy(np.stack(Xs)).to(builder.device)
    with torch.no_grad():
        out = exact_fleet_program(spec, X, X, folds, final=True, route="plain")
    K = len(folds)
    cells = [tuple(t.cpu().numpy() for t in c) for c in out["cells"]]
    head = tuple(t.cpu().numpy() for t in out["head"])
    history = out["history"][:, K].cpu().numpy()
    feat = out["feature_thresholds"].cpu().numpy()
    agg = out["aggregate_threshold"].cpu().numpy()
    scores = scores_summary({k: v.cpu().numpy() for k, v in out["metrics"].items()})
    del X, out
    worst, leaves = {}, {}

    def hold(key, ref, got):
        ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
        err = float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))
        worst[key] = max(worst.get(key, 0.0), err)
        return err

    for i, det in enumerate(detectors):
        got = det.base_estimator._final.state_arrays()
        for name, ref in lstm_slot_state(cells, head, i, K).items():
            if np.any(ref):
                err = hold("params", ref, got[name])
                leaves.setdefault(name, []).append(err)
        hold("history", history[i], det.base_estimator._final.history_)
        hold("thresholds", np.append(feat[i], agg[i]),
             np.append(det.feature_thresholds_, det.aggregate_threshold_))
        for name, v in scores[i].items():
            hold(name, v["folds"], det.cv_metadata_["scores"][name]["folds"])
    # per leaf: the worst machine's error and the median machine's
    by_leaf = {name: [max(v), float(np.median(v))] for name, v in leaves.items()}
    emit({"phase": "lstm_train_vs_plain", "max_norm_err": worst, "params_by_leaf": by_leaf})
    for key, err in worst.items():
        check(err <= LSTM_BUILD_TOLERANCE[key],
              f"LSTM build vs the plain lockstep fit, {key}: {err} > {LSTM_BUILD_TOLERANCE[key]}")

    # serve two of the built detectors
    names = ["lstm-built-0", "lstm-built-1"]
    served = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lstm_train_") as tmp:
        for i, name in enumerate(names):
            meta = {"dataset": {"tag_list": [f"{name}-tag-{j}" for j in range(tags)]}}
            serializer.dump(detectors[i], os.path.join(tmp, name), metadata=meta)
        collection = ModelCollection.from_directory(
            tmp, project="lstm-built", device=None if DEVICE == "cuda" else DEVICE
        )
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/lstm-built"
        fs.launches = 0
        responses = []
        try:
            for i, name in enumerate(names):
                for lo, hi in ((0, rows), (rows // 2, rows)):
                    X = Xs[i][lo:hi]
                    status, body = _request(f"{base}/{name}/anomaly/prediction", {"X": X.tolist()})
                    check(status == 200, f"anomaly/prediction {name}: {status} {body}")
                    responses.append((i, X, body["data"]))
            serve_launches = fs.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
    if DEVICE == "cuda":
        check(serve_launches == len(responses), f"{len(responses)} LSTM requests launched fleet_score "
              f"{serve_launches} times")
    for i, X, data in responses:
        for device in {DEVICE, "cpu"}:
            ref = CompiledScorer(detectors[i], device=None if device == "cuda" else device).anomaly_arrays(X)
            for k in OUTPUTS:
                got = np.asarray(data[k], np.float64)
                check(got.shape == np.shape(ref[k]) and np.isfinite(got).all(), f"served {k} of {names[i]}")
                err = float(np.abs(got - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
                served[f"{device} {k}"] = max(served.get(f"{device} {k}", 0.0), err)
    check(all(v <= TOLERANCE for v in served.values()),
          f"served LSTM detectors within {TOLERANCE} of the in-process scorers: {served}")
    forecast = _lstm_forecast_check(Xs[:LSTM_FORECAST_MACHINES], folds)
    fit_bound = lstm_fit_bound(steps, dims, LOOKBACK, machines, rows)
    return {
        "machines": machines,
        "rows": rows,
        "tags": tags,
        "lookback": LOOKBACK,
        "epochs": cfg.epochs,
        "batch_size": cfg.batch_size,
        "slots": machines * len(fits),
        "lockstep_steps": n_steps,
        "build_seconds": seconds,
        "models_per_hour": machines / seconds * 3600,
        "first_build_seconds": cold_seconds,
        "dispatch_seconds": dispatch_seconds,
        "fetch_seconds": pending.fetch_seconds,
        "assemble_seconds": pending.assemble_seconds,
        "launches": launches,
        "profile": profile,
        "fit_bound": fit_bound,
        "vs_plain_lockstep_max_norm_err": worst,
        "served_machines": len(names),
        "served_requests": len(responses),
        "served_max_norm_err": served,
        "forecast": forecast,
    }


# -- ragged (pad-up) and warm builds ------------------------------------------

#: the ragged fleet of the pad-up build: machine i of TRAIN_SHAPE's 512 has
#: 576 - (i mod RAGGED_SPREAD) rows (128 lengths, 449..576); pad_lengths
#: RAGGED_PAD makes two padded groups (512, 576).  The warm rebuild runs on
#: the series extended by RAGGED_EXTEND rows (513..640: groups 576, 640)
RAGGED_SPREAD = 128
RAGGED_PAD = 64
RAGGED_EXTEND = 64
#: the ragged LSTM fleet: machine i of LSTM_TRAIN_SHAPE's 64 has 576 -
#: RAGGED_LSTM_STEP * (i mod RAGGED_LSTM_SPREAD) rows (576, 560, 544, 528),
#: one padded group at 576; exact, four groups
RAGGED_LSTM_STEP, RAGGED_LSTM_SPREAD = 16, 4
#: a ragged build against the same programs through the plain versions on
#: the card, per machine: the fits' tolerances (TRAIN_TOLERANCE,
#: LSTM_BUILD_TOLERANCE) and the build's (BUILD_TOLERANCE); the stats
#: are exact
RAGGED_TOLERANCE = {"params": TRAIN_TOLERANCE["fleet_fit"], "history": TRAIN_TOLERANCE["fleet_fit_history"],
                    "scaler": 1e-6, "detector": 1e-6, **BUILD_TOLERANCE}
LSTM_RAGGED_TOLERANCE = {"scaler": 1e-6, "detector": 1e-6, **LSTM_BUILD_TOLERANCE}
#: the most arrays, and machines (or slots), one hold of a fit to its plain
#: version admits at their one-ulp movement (``_check_admitted``): PR 9's
#: final run admitted one array of one machine or slot in each hold
ONE_ULP_ADMITTED = {"arrays": 4, "machines": 2}
#: the masked epilogue (K8) and the suffix-weighted metrics it stands for,
#: held to one another on the card: the same function, summed in another
#: order (the tolerances of tests/test_torch_padded_build.py)
WEIGHTED_TOLERANCE = {"explained_variance_score": 1e-4, "r2_score": 1e-5,
                      "mean_squared_error": 1e-5, "mean_absolute_error": 1e-5}


@contextlib.contextmanager
def plain_kernels():
    """Within: the fleet build's programs call the kernels' plain versions
    (on any device), the LSTM fit's lockstep loop still chosen by its
    ``route``."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.ops import scalers
    from gordo_tpu_torch.parallel import anomaly

    def lstm_layer_plain(*args, slot_windows=None, **kwargs):
        return ll.lstm_layer_plain(*args, **kwargs)

    plain = {(anomaly, "fleet_fit"): ff.fleet_fit_plain, (anomaly, "fleet_score"): fs.fleet_score_plain,
             (anomaly, "cv_epilogue"): ce.cv_epilogue_plain, (anomaly, "lstm_layer"): lstm_layer_plain,
             # the scalers' stats (the chain's steps and the detector scaler)
             (scalers, "scaler_stats"): ss.scaler_stats_plain,
             (scalers, "scaler_quantiles"): sq.scaler_quantiles_plain}
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def ragged_lengths(rows: int, machines: int, spread: int, step: int = 1) -> np.ndarray:
    return rows - step * (np.arange(machines) % spread)


def _build_counted(spec, builder, Xs, counters, warm=None) -> tuple:
    """Build twice; count the second (seconds, models/h, where the wall
    time went, launches of every kernel, set to 0 just before, held on the
    card to what its groups should launch; its groups, and the epilogue
    launches of its pad-up groups, K8's).  Returns ``(detectors, info,
    pending)``."""
    builder.build(Xs, warm_params=warm)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    pending = builder.dispatch(Xs, warm_params=warm)
    dispatch_seconds = time.perf_counter() - t0
    detectors = pending.collect()
    seconds = time.perf_counter() - t0
    info = {"machines": len(Xs), "build_seconds": seconds, "models_per_hour": len(Xs) / seconds * 3600,
            "dispatch_seconds": dispatch_seconds, "fetch_seconds": pending.fetch_seconds,
            "assemble_seconds": pending.assemble_seconds,
            "launches": {name: getattr(mod, attr) for name, (mod, attr) in counters.items()},
            "groups": len(pending.groups), "pad_built_groups": sum(g.pad_built for g in pending.groups)}
    if DEVICE == "cuda":
        want = _expected_launches(spec, pending)
        check(info["launches"] == want, f"build launches {info['launches']}, expected {want}")
    # one epilogue launch per group (held just above): those of pad-up groups are K8's
    info["cv_epilogue_masked_launches"] = info["pad_built_groups"] if DEVICE == "cuda" else 0
    return detectors, info, pending


def _detector_arrays(det) -> dict:
    """What a detector holds, as float64 arrays by name."""
    est = det.base_estimator._final
    out = {f"params/{k}": v for k, v in est.state_arrays().items()}
    out["history"] = est.history_
    out["thresholds"] = np.append(det.feature_thresholds_, det.aggregate_threshold_)
    for name, v in det.cv_metadata_["scores"].items():
        out[name] = np.asarray(v["folds"])
    for i, (_, step) in enumerate(det.base_estimator.steps[:-1]):
        for k, v in step.stats_.items():
            out[f"scaler/{i}/{k}"] = v
    for k, v in det.scaler.stats_.items():
        out[f"detector/{k}"] = v
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def one_ulp(params, direction: int):
    """Initial params with every kernel one float32 ulp higher (``direction``
    1) or lower (-1) (biases, drawn as zeros, kept): the conditioning probe
    of a fit."""
    step = lambda t: torch.nextafter(t, torch.full_like(t, direction * math.inf))  # noqa: E731
    if isinstance(params, tuple):  # an LSTM chain's (cells, head)
        cells, (W, b) = params
        return [(step(ki), step(kh), bias) for ki, kh, bias in cells], (step(W), b)
    return [(step(W), b) for W, b in params]


def one_ulp_draws(device, direction: int):
    """The default draws (``fleet_init`` on ``device``) with their kernels
    one ulp higher or lower, as a ``draws=`` source."""
    from gordo_tpu_torch.parallel import fleet

    def draws(seed, dims, n_totals, epochs):
        params, perms = fleet.draw_fleet([seed], dims, n_totals, epochs, device)
        return fleet._host(one_ulp(params, direction)), {n: p[0].cpu().numpy() for n, p in perms.items()}
    return draws


def _check_admitted(admitted: list, what: str) -> None:
    """At most ``ONE_ULP_ADMITTED`` arrays and machines (slots) of one hold
    are admitted at their one-ulp movement."""
    units = {a.get("machine", tuple(a.get("slot", ()))) for a in admitted}
    check(len(admitted) <= ONE_ULP_ADMITTED["arrays"] and len(units) <= ONE_ULP_ADMITTED["machines"],
          f"{what}: {len(admitted)} arrays of {len(units)} machines admitted at their one-ulp "
          f"movement, more than {ONE_ULP_ADMITTED}")


def _hold_to_plain_program(spec, builder, pending, detectors, tolerance: dict):
    """Each group of the build ``pending`` again, on the rows, folds and
    warm params it launched, through its program with every kernel's plain
    version on the card (the LSTM fit's plain lockstep loop), held per
    machine to the built detectors within ``tolerance`` by kind; a
    reference of zeros is held exactly.

    A fit can be ill-conditioned: the plain version itself then moves by
    more than the tolerance when its initial params move by one ulp.  A
    machine's array that misses the tolerance is held instead to that
    movement, the smaller of the same program's from params one ulp higher
    and one ulp lower (``one_ulp``), which it must not exceed; at most
    ``ONE_ULP_ADMITTED`` arrays and machines are admitted so.  Returns
    ``(worst, admitted)``: the worst normalised error by kind over the
    arrays held to the tolerance, and each array held to its one-ulp
    movement."""
    from gordo_tpu_torch.parallel.anomaly import (
        chain_dims,
        exact_fleet_program,
        layer_state,
        lstm_slot_state,
        padded_fleet_program,
    )
    from gordo_tpu_torch.parallel.fleet import fleet_draws, stack_warm_params

    host = lambda t: t.cpu().numpy()  # noqa: E731

    def plain_arrays(g, X, y, params0, draws):
        """The plain program's arrays of each machine of group ``g``."""
        with torch.no_grad(), plain_kernels():
            if g.pad_built:
                out = padded_fleet_program(spec, X, y, g.lens, g.folds, draws=draws, route="plain",
                                           params0=params0)
            else:
                out = exact_fleet_program(spec, X, y, g.folds, final=True, draws=draws, route="plain",
                                          params0=params0)
        K = len(g.folds)
        if "cells" in out:
            cells = [tuple(host(t) for t in c) for c in out["cells"]]
            head = tuple(host(t) for t in out["head"])
            state = lambda j: lstm_slot_state(cells, head, j, K)  # noqa: E731
        else:
            layers = [(host(W), host(b)) for W, b in out["layers"]]
            state = lambda j: layer_state(layers, j, K)  # noqa: E731
        arrays = []
        for j in range(len(g.indices)):
            ref = {f"params/{k}": v for k, v in state(j).items()}
            ref["history"] = host(out["history"][j, K])
            ref["thresholds"] = np.append(host(out["feature_thresholds"][j]),
                                          host(out["aggregate_threshold"][j]))
            for name, v in out["metrics"].items():
                ref[name] = host(v[j])
            for i, (proto, leaves) in enumerate(zip(spec.scaler_protos, out["steps"])):
                for k, t in zip(proto.STAT_KEYS, leaves):
                    ref[f"scaler/{i}/{k}"] = host(t[j, K])
            for k, t in zip(spec.detector_proto.scaler.STAT_KEYS, out["det_stats"]):
                ref[f"detector/{k}"] = host(t[j])
            arrays.append(ref)
        return arrays

    def r12(r, other):
        return float(np.abs(np.asarray(r, np.float64) - other).max() / np.abs(r).max())

    worst, admitted = {}, []
    for g in pending.groups:
        X = torch.from_numpy(g.X).to(builder.device)
        y = X if g.y is g.X else torch.from_numpy(g.y).to(builder.device)
        params0 = None
        if g.warm is not None:
            params0 = stack_warm_params(g.warm, chain_dims(spec, g.X.shape[2], g.y.shape[2]), builder.device)
        refs = plain_arrays(g, X, y, params0, fleet_draws)
        nudged = None  # the one-ulp probe, run for a group only where needed
        for j, i in enumerate(g.indices):
            got = _detector_arrays(detectors[i])
            for key, r in refs[j].items():
                got_k = got[key]
                check(bool(np.isfinite(got_k).all()), f"{key} of machine {i} is finite")
                if not np.any(r):
                    check(not np.any(got_k), f"{key} of machine {i} is zero as the plain version's")
                    continue
                kind = key.split("/")[0]
                err = r12(r, got_k)
                if err <= tolerance[kind]:
                    worst[kind] = max(worst.get(kind, 0.0), err)
                    continue
                if nudged is None:
                    nudged = [plain_arrays(g, X, y, one_ulp(params0, d), fleet_draws) if params0 is not None
                              else plain_arrays(g, X, y, None, one_ulp_draws(builder.device, d))
                              for d in (1, -1)]
                movement = min(r12(r, n[j][key]) for n in nudged)
                check(err <= movement, f"machine {i} {key}: {err} off its plain version, beyond "
                                       f"{tolerance[kind]} and the plain version's one-ulp movement {movement}")
                admitted.append({"machine": int(i), "array": key, "err": err, "one_ulp_movement": movement})
    _check_admitted(admitted, "hold to the plain program")
    return worst, admitted


def _check_worst(worst: dict, tolerance: dict, what: str) -> None:
    for kind, err in worst.items():
        check(err <= tolerance[kind], f"{what}, {kind}: {err} > {tolerance[kind]}")


def _bitwise_equal(a, b, machines, what: str, skip=()) -> int:
    """Detectors ``a[i]`` and ``b[i]`` hold the same bits, for each i (the
    arrays named in ``skip`` aside)."""
    for i in machines:
        da, db = _detector_arrays(a[i]), _detector_arrays(b[i])
        check(set(da) == set(db), f"{what}: machine {i} has the same arrays")
        for key in set(da) - set(skip):
            check(np.array_equal(da[key], db[key]), f"{what}: machine {i} {key} bit for bit")
    return len(machines)


def _keep_out_of_fold(builder) -> dict:
    """Make ``builder`` keep each machine's out-of-fold predictions, test
    rows and targets as its groups are collected: ``{machine: (predictions
    (K, rows, Fo), test rows, targets)}``, the last build's."""
    kept = {}
    collect = builder._collect_group

    def keep(g):
        for m, i in enumerate(g.indices):
            kept[i] = (g.out["predictions"][m], g.out["test_rows"], g.y[m])
        return collect(g)

    builder._collect_group = keep
    return kept


def _padded_scores_check(padded, kept, machines, what: str) -> None:
    """A pad-up build's CV scores of full-length machines, bit for bit the
    weighted metrics (K8's formulas, ``fleet.padded``) of the exact build's
    predictions ``kept``; the exact build's own scores are ``fleet.exact``'s
    (K4), another order of the same sums."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce

    for i in machines:
        pred, tests, y = kept[i]
        off = max(len(r) for r in tests) - int(pred.shape[1])
        for k, rows_k in enumerate(tests):
            n = len(rows_k) - off
            yk = torch.from_numpy(np.ascontiguousarray(y[rows_k][off:], np.float32)).to(pred.device)[None]
            want = ce.fold_metrics(yk, pred[k][None, :n], n, masked=True)
            for name in ce.METRIC_NAMES:
                check(padded[i].cv_metadata_["scores"][name]["folds"][k] == float(want[name][0]),
                      f"{what}: machine {i} fold {k} {name} is the weighted metric of the exact build's predictions")


def _non_finite_max_check(rng, tags: int) -> dict:
    """Slots whose real rows hold NaN (a diverged pad-up fit) or inf: the
    masked epilogue (K8) gives their maxima 0, as ``_masked_smoothed_max``
    does, the exact one (K4) keeps them; kernel and plain version agree
    bit for bit on which and on every finite maximum."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce

    S, nt = 8, 144
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    y = rng.standard_normal((S, nt, tags))
    pred = y + 0.3 * rng.standard_normal((S, nt, tags))
    pred[0, 5:40] = np.nan  # every tag's windows reach a NaN row
    pred[1, :, 2] = np.nan  # one tag NaN throughout
    pred[2, 7, 4] = np.inf
    y, pred = put(y), put(pred)
    tag = (pred - y).abs().contiguous()
    total = tag.norm(dim=-1).contiguous()
    counts = np.array([nt, nt, nt, nt, 60, 1, 0, nt // 2])
    out = {}
    for masked in (True, False):
        got = ce.cv_epilogue(tag, total, pred, y, counts, masked=masked)
        ref = ce.cv_epilogue_plain(tag, total, pred, y, counts, masked=masked)
        for k in ("feature_max", "total_max"):
            g, r = got[k], ref[k]
            check(bool(torch.equal(torch.isnan(g), torch.isnan(r))), f"cv_epilogue {k} masked={masked}: NaN where the plain version has it")
            fin = torch.isfinite(r)
            check(bool(torch.equal(g[fin], r[fin])) and bool(torch.equal(torch.isinf(g), torch.isinf(r))),
                  f"cv_epilogue {k} masked={masked} equals its plain version")
        if masked:
            check(bool(got["feature_max"][:3].isfinite().all()) and float(got["feature_max"][0].abs().max()) == 0.0,
                  "K8 maps a non-finite maximum of a slot with rows to 0")
            check(float(got["total_max"][0]) == 0.0 and float(got["feature_max"][1, 2]) == 0.0,
                  "K8 maps a NaN total maximum and a NaN tag's maximum to 0")
        else:
            check(bool(torch.isnan(got["feature_max"][0]).all()) and bool(torch.isnan(got["feature_max"][1, 2])),
                  "K4 keeps a NaN maximum")
        out["masked" if masked else "exact"] = {
            "non_finite_feature_max": int((~torch.isfinite(got["feature_max"])).sum()),
            "zeroed": int((got["feature_max"][:3] == 0).sum())}
    return out


def phase_ragged_kernel_check():
    """K8 and the per-machine counts on the card: ``cv_epilogue`` with row
    counts from 0 to nt (against its plain version and the suffix-weighted
    metrics), ``scaler_stats`` on NaN-padded rows, ``fleet_fit`` with
    ragged per-(machine, fit) row counts whose fits hold minibatches of
    padding alone, and one lockstep LSTM step in which some slots have no
    real window (their gradients must be written as zeros)."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.ops import metrics as tmetrics
    from gordo_tpu_torch.parallel.fleet import fleet_draws, put_draws
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams

    machines, rows, tags = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 9)
    entries = {}

    def errors(pairs, tol, what):
        errs, worst = {}, 0.0
        for key, (ref, got) in pairs.items():
            check(bool(got.isfinite().all()), f"{what} {key} is finite")
            errs[key] = (score_err if key in ce.EMPTY_ONE else norm_err)(ref, got)
            check(errs[key] <= tol, f"{what} {key} within {tol}: {errs[key]}")
            worst = max(worst, float((ref.double() - got.double()).abs().max()))
        return errs, worst

    # K8: the epilogue of every (machine, fold) slot over its real rows
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    S, nt = machines * len(folds), len(folds[0][1])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    y = put(rng.standard_normal((S, nt, tags)))
    pred = put(y.cpu().numpy() + 0.3 * rng.standard_normal((S, nt, tags)))
    tag = (pred - y).abs().contiguous()
    total = tag.norm(dim=-1).contiguous()
    counts = rng.integers(0, nt + 1, S)
    counts[:8] = [0, 0, 1, 2, nt, nt, nt - 1, 3]
    epi_args = (tag, total, pred, y, counts)
    run = lambda: ce.cv_epilogue(*epi_args, masked=True)  # noqa: E731
    plain = lambda: ce.cv_epilogue_plain(*epi_args, masked=True)  # noqa: E731
    got, ref = run(), plain()
    empty = torch.from_numpy(counts == 0).to(DEVICE)
    check(bool(torch.equal(got["has"], ref["has"])), "cv_epilogue has flags equal the plain version's")
    for name, want in (("feature_max", 0.0), ("total_max", 0.0), ("explained_variance_score", 1.0),
                       ("r2_score", 1.0), ("mean_squared_error", 0.0), ("mean_absolute_error", 0.0)):
        check(bool((got[name][empty] == want).all()), f"cv_epilogue {name} of an empty slot is {want}")
    errs, abs_err = errors({k: (ref[k], got[k]) for k in ref}, TRAIN_TOLERANCE["cv_epilogue"], "cv_epilogue masked")
    w = (torch.arange(nt, device=DEVICE)[None] < torch.from_numpy(counts).to(DEVICE)[:, None]).float()
    weighted = {}
    for name, fn in tmetrics.WEIGHTED_METRICS.items():
        want = fn(y, pred, w)
        has = ~empty
        weighted[name] = (score_err if name in ce.EMPTY_ONE else norm_err)(want[has], got[name][has])
        check(weighted[name] <= WEIGHTED_TOLERANCE[name],
              f"cv_epilogue {name} against the weighted metrics: {weighted[name]}")
    real = int(counts.sum())
    entry = {"max_norm_err": errs, "max_abs_err": abs_err, "tolerance": TRAIN_TOLERANCE["cv_epilogue"],
             "weighted_metrics_max_norm_err": weighted, "weighted_tolerance": WEIGHTED_TOLERANCE,
             "slots": S, "rows": nt, "tags": tags, "real_rows": real, "empty_slots": int((counts == 0).sum()),
             # the rows this run's counts need, read once; the outputs
             **bound(4 * (real * (3 * tags + 1) + S * (tags + 7)),
                     real * tags * (ce.SMOOTHING_WINDOW + 12) + real * ce.SMOOTHING_WINDOW)}
    # the metrics sum in XLA's window order on both sides: bit for bit
    entry["differing"] = sum(differing(ref[k], got[k]) for k in ref)
    check(entry["differing"] == 0, f"cv_epilogue masked: bit for bit its plain version ({entry['differing']} differ)")
    entry["hashes"] = output_hashes(got)
    entry["path"] = plan_path(ce, nt, tags, masked=True)
    time_entry(entry, run, plain, 20, 5)
    entry["non_finite"] = _non_finite_max_check(rng, tags)
    entries["cv_epilogue_masked"] = entry

    # K3 on NaN-padded ragged rows: each machine's rows past its length NaN
    lens = ragged_lengths(rows, machines, RAGGED_SPREAD)
    Xn = bench_fleet(rng, machines, rows, tags)
    for i, n in enumerate(lens):
        Xn[i, n:] = np.nan
    Xn = put(Xn)
    row_lists = [tr for tr, _ in folds] + [np.arange(rows)]
    run = lambda: ss.scaler_stats(Xn, row_lists)  # noqa: E731
    plain = lambda: ss.scaler_stats_plain(Xn, row_lists)  # noqa: E731
    (scale, offset), (scale_p, offset_p) = run(), plain()
    errs, abs_err = errors({"scale": (scale_p, scale), "offset": (offset_p, offset)},
                           TRAIN_TOLERANCE["scaler_stats"], "scaler_stats on NaN-padded rows")
    visits = sum(len(r) for r in row_lists)
    entry = {"max_norm_err": errs, "max_abs_err": abs_err, "tolerance": TRAIN_TOLERANCE["scaler_stats"],
             **bound(4 * (machines * visits * tags + visits + 2 * machines * len(row_lists) * tags),
                     2 * machines * visits * tags)}
    entry["differing"] = differing(scale_p, scale) + differing(offset_p, offset)
    check(entry["differing"] == 0, f"scaler_stats on NaN-padded rows: bit for bit its plain version ({entry['differing']} differ)")
    entry["hashes"] = {"scale": output_hash(scale), "offset": output_hash(offset)}
    entry["path"] = plan_path(ss, Xn.shape, row_lists)
    time_entry(entry, run, plain, 20, 5)
    entries["scaler_stats_nan_padded"] = entry

    # K1 + K2 with a real-row count per (machine, fit): a quarter of the
    # machines keep few rows of each fit, so their fits hold minibatches of
    # padding alone, which still take Adam steps
    cfg = TrainConfig()
    hp = adam_hparams(cfg)
    fits = [ff.geometry(r, cfg.batch_size) for r in row_lists]
    sizes = np.array([fg.n for fg in fits])
    fit_counts = np.minimum(rng.integers(1, sizes + 1, (machines, len(fits))), sizes)
    few = np.arange(machines) % 4 == 0
    fit_counts[few] = rng.integers(0, 24, (int(few.sum()), len(fits)))
    fit_counts[0, 0] = 0  # a fit of padding alone
    dims = hourglass(tags)
    acts = ["tanh"] * (len(dims) - 2) + ["linear"]
    X = torch.nan_to_num(Xn, nan=0.0)
    params0, perms = put_draws(fleet_draws, 0, dims, fits, cfg.epochs, X.device)
    empty_batches = 0
    for g, p in enumerate(ff.unpack_perms(perms.cpu(), fits, cfg.epochs)):
        ids = p[0].numpy().reshape(cfg.epochs, fits[g].steps, fits[g].bs)
        real_in = (ids[None] < fit_counts[:, g, None, None, None]).sum(-1)
        empty_batches += int((real_in == 0).sum())
    check(empty_batches > 0, "the ragged fits hold minibatches of padding alone")
    args = (X, X, fits, params0, perms, np.zeros(machines, np.int64), acts, cfg.epochs, hp)
    kw = dict(counts=fit_counts, chain=[minmax_step(scale, offset)])
    run = lambda: ff.fleet_fit(*args, **kw)  # noqa: E731
    plain = lambda: ff.fleet_fit_plain(*args, **kw)  # noqa: E731
    (layers, hist), (layers_p, hist_p) = run(), plain()
    pairs = {f"layer{i}.{k}": (p, g) for i, ((gw, gb), (pw, pb)) in enumerate(zip(layers, layers_p))
             for k, p, g in (("kernel", pw, gw), ("bias", pb, gb))}
    # a fit the plain version itself moves by more than the tolerance when
    # its initial params move by one ulp is held to that movement instead
    # (the held slots are listed): the conditioning probe runs where needed
    tol = TRAIN_TOLERANCE["fleet_fit"]
    over = {k for k, (p, g) in pairs.items() if norm_err(p, g) > tol}
    held, held_pairs = [], {}
    if over:
        moved = []
        for d in (1, -1):
            nudged = ff.fleet_fit_plain(X, X, fits, one_ulp(params0, d), perms, np.zeros(machines, np.int64),
                                        acts, cfg.epochs, hp, **kw)[0]
            moved.append({f"layer{i}.{k}": m for i, (mw, mb) in enumerate(nudged)
                          for k, m in (("kernel", mw), ("bias", mb))})
        for key in sorted(over):
            p, g = held_pairs[key] = pairs.pop(key)
            scale_k = p.double().abs().max()
            off = (g.double() - p.double()).abs().reshape(machines, len(fits), -1).amax(-1) / scale_k
            # the smaller of the movements one ulp up and one ulp down
            move = torch.minimum(*[(m[key].double() - p.double()).abs().reshape(machines, len(fits), -1).amax(-1)
                                   / scale_k for m in moved])
            bad = (off > tol) & (off > move)
            check(not bool(bad.any()), f"fleet_fit ragged {key}: slots beyond {tol} and their one-ulp movement")
            for m, gi in (off > tol).nonzero().tolist():
                held.append({"array": key, "slot": [m, gi], "count": int(fit_counts[m, gi]),
                             "err": float(off[m, gi]), "one_ulp_movement": float(move[m, gi])})
    _check_admitted(held, "fleet_fit ragged")
    errs, abs_err = errors(pairs, tol, "fleet_fit ragged")
    for key, (p, g) in held_pairs.items():
        errs[key] = norm_err(p, g)
        abs_err = max(abs_err, float((p.double() - g.double()).abs().max()))
    herr, habs = errors({"history": (hist_p, hist)}, TRAIN_TOLERANCE["fleet_fit_history"], "fleet_fit ragged")
    entry = {"max_norm_err": {**errs, **herr}, "max_abs_err": max(abs_err, habs),
             "tolerance": {"params": TRAIN_TOLERANCE["fleet_fit"], "history": TRAIN_TOLERANCE["fleet_fit_history"]},
             "all_padding_minibatches": empty_batches, "real_rows": int(fit_counts.sum()),
             "held_to_one_ulp_movement": held,
             **fleet_fit_bound(fits, dims, machines, rows, cfg.epochs, fit_counts)}
    time_entry(entry, run, plain, 3, 2)
    entries["fleet_fit_ragged"] = entry
    entries["lstm_zero_window_step"] = _lstm_zero_window_step_check(rng)
    emit({"phase": "ragged_kernel_check", "shape": list(TRAIN_SHAPE), "kernels": entries})
    del X, Xn, layers, layers_p, y, pred, tag, total
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def _lstm_zero_window_step_check(rng) -> dict:
    """The LSTM training kernels on two lockstep steps of the bench's LSTM
    build (64 machines × 4 fits) with ragged window counts, the second
    step with slots that have no real window: each kernel against its plain
    version, fed what the kernel before it made, and the empty slots'
    gradients exactly 0 (the kernels write them; the caching allocator
    hands the second step the first step's buffers)."""
    from gordo_tpu_torch.kernels import lstm_head_fit as hf
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import lstm_layer_bwd as lb
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.kernels.lstm_layer import Minibatch
    from gordo_tpu_torch.parallel.anomaly import analyze_definition
    from gordo_tpu_torch.parallel.fleet import LSTMDims, fleet_draws, put_lstm_draws
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import adam_hparams
    from gordo_tpu_torch.train.lstm_fit import plan_steps, window_fit

    machines, rows, tags = LSTM_TRAIN_SHAPE
    X = torch.from_numpy(bench_fleet(rng, machines, rows, tags)).to(DEVICE)
    spec = analyze_definition(from_definition(LSTM_TRAIN_MODEL))
    cfg, off = spec.train_cfg, spec.offset
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    row_lists = [tr for tr, _ in folds] + [np.arange(rows)]
    fits = [window_fit(r, cfg.batch_size, off) for r in row_lists]
    S = machines * len(fits)
    scale, offset = ss.scaler_stats(X, row_lists)
    scale, offset = scale.reshape(S, tags).contiguous(), offset.reshape(S, tags).contiguous()
    dims = LSTMDims(hourglass(tags))
    _, perms = put_lstm_draws(fleet_draws, 0, dims, fits, 1, X.device)
    sizes = np.array([fg.n_windows for fg in fits])
    counts = np.minimum(rng.integers(1, sizes + 1, (machines, len(fits))), sizes)
    counts[::4] = rng.integers(0, 8, (len(counts[::4]), len(fits)))
    steps = plan_steps(fits, machines, perms, np.zeros(machines, np.int64), 1, adam_hparams(cfg),
                       X.device, counts)
    n_real = steps.n_windows[0].cpu().numpy()
    active = steps.count[0].cpu().numpy() > 0
    zero = (n_real == 0) & active
    s_empty = 1 + int(np.argmax(zero[1:].sum(-1)))
    check(bool(zero[s_empty].any()), "a lockstep step after the first has empty active slots")
    net = random_lstm(rng, S, tags)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    cells = [tuple(put(a) for a in c) for c in net["cells"]]
    W, bh = put(net["head"][0]), put(net["head"][1])
    errs = {}

    def hold(name, ref, got, counts_=None):
        tol = LSTM_TRAIN_TOLERANCE[name]
        if counts_ is None:
            check(bool(got.isfinite().all()), f"{name} is finite")
            err = norm_err(ref, got)
            check(err <= tol, f"{name} within {tol}: {err}")
        else:
            err, _ = _valid_err(ref, got, counts_, name, tol)
        errs[name] = max(errs.get(name, 0.0), err)

    empty_grads, head_hashes = [], {}
    for s in (0, s_empty):
        batch = Minibatch(steps.win[0, s], steps.n_windows[0, s], steps.rows, steps.row_off, steps.x_mach)
        valid = batch.n_windows.cpu().numpy()
        h, inputs, saves = X, [], []
        for i, (ki, kh, b) in enumerate(cells):
            first = i == 0
            kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=i == len(cells) - 1,
                      chain=[minmax_step(scale, offset)] if first else None)
            got = ll.lstm_layer_train(h, ki, kh, b, **kw)
            ref = ll.lstm_layer_train_plain(h, ki, kh, b, **kw)
            for r, g in zip(ref, got):
                hold("lstm_layer_train", r, g, valid)
            inputs.append(h)
            saves.append(got[1:])
            h = _real_windows_only(got[0], batch)
        got = hf.lstm_head_fit(h, W, bh, X, batch=batch, shift=off, act="linear")
        ref = hf.lstm_head_fit_plain(h, W, bh, X, batch=batch, shift=off, act="linear")
        for r, g in zip(ref[:3], got[:3]):
            hold("lstm_head_fit", r, g)
        head_hashes[f"step_{s}"] = head_fit_hashes(got, valid)
        grads, dout = [got[0], got[1], got[2]], got[3]
        for i in reversed(range(len(cells))):
            first = i == 0
            kw = dict(lookback=LOOKBACK, batch=batch, act="tanh", last=i == len(cells) - 1,
                      chain=[minmax_step(scale, offset)] if first else None, want_dx=not first)
            got_b = lb.lstm_layer_bwd(inputs[i], *cells[i], *saves[i], dout, **kw)
            ref_b = lb.lstm_layer_bwd_plain(inputs[i], *cells[i], dout, **kw)
            for r, g in zip(ref_b[1:], got_b[1:]):
                hold("lstm_layer_bwd", r, g)
            grads += list(got_b[1:])
            dout = got_b[0]
        if s == s_empty:
            sel = torch.from_numpy(zero[s]).to(DEVICE)
            for g in grads:
                empty_grads.append(bool((g[sel] == 0).all()))
    check(all(empty_grads), "the empty slots' loss and gradients are written as zeros")
    return {"slots": S, "step": s_empty, "empty_active_slots": int(zero[s_empty].sum()),
            "max_norm_err": errs, "empty_slots_zero": all(empty_grads), "lstm_head_fit_hashes": head_hashes}


def phase_ragged_train():
    """The pad-up build of a ragged fleet of 512 default detectors (two
    padded groups) and its exact build (one group per length), each built
    twice and the second counted; the padded build held per machine to the
    same programs through the plain versions on the card, and its 576-row
    machines to the exact build's bit for bit; then a warm pad-up rebuild
    on the series extended by RAGGED_EXTEND rows from the padded build's
    params, held to its plain version on the card.  Their CV scores are
    held to the weighted metrics of the exact build's predictions (K8's
    formulas; K4's are another order of the same sums)."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.serializer import from_definition

    machines, rows, tags = TRAIN_SHAPE
    base = bench_fleet(np.random.default_rng(SEED + 10), machines, rows + RAGGED_EXTEND, tags)
    lens = ragged_lengths(rows, machines, RAGGED_SPREAD)
    Xs = [base[i, :n] for i, n in enumerate(lens)]
    spec = analyze_definition(from_definition(DEFAULT_MODEL))
    device = None if DEVICE == "cuda" else DEVICE
    padded_builder = FleetDiffBuilder(spec, pad_lengths=RAGGED_PAD, device=device)
    exact_builder = FleetDiffBuilder(spec, device=device)
    counters = _ff_counters()
    padded, padded_info, pending = _build_counted(spec, padded_builder, Xs, counters)
    kept = _keep_out_of_fold(exact_builder)
    exact, exact_info, _ = _build_counted(spec, exact_builder, Xs, counters)
    check(all(getattr(d, "pad_built_", False) for d in padded), "every machine pad-built")
    worst, admitted = _hold_to_plain_program(spec, padded_builder, pending, padded, RAGGED_TOLERANCE)
    emit({"phase": "ragged_train_vs_plain", "max_norm_err": worst, "held_to_one_ulp_movement": admitted})
    _check_worst(worst, RAGGED_TOLERANCE, "ragged pad-up build vs its plain version")
    full = [i for i, n in enumerate(lens) if n == rows]
    same = _bitwise_equal(padded, exact, full, "padded vs exact build", skip=ce.METRIC_NAMES)
    _padded_scores_check(padded, kept, full, "padded build")

    # warm: the series grown by RAGGED_EXTEND rows, from the padded build's params
    Xw = [base[i, : n + RAGGED_EXTEND] for i, n in enumerate(lens)]
    warm = [d.base_estimator._final.state_arrays() for d in padded]
    warm_dets, warm_info, pending = _build_counted(spec, padded_builder, Xw, counters, warm)
    warm_worst, warm_admitted = _hold_to_plain_program(spec, padded_builder, pending, warm_dets,
                                                       RAGGED_TOLERANCE)
    _check_worst(warm_worst, RAGGED_TOLERANCE, "warm pad-up build vs its plain version")
    return {"machines": machines, "tags": tags, "lengths": [int(lens.min()), int(lens.max())],
            "distinct_lengths": len(set(lens.tolist())), "pad_lengths": RAGGED_PAD,
            "padded": padded_info, "exact": exact_info, "vs_plain_max_norm_err": worst,
            "vs_plain_held_to_one_ulp_movement": admitted,
            "bitwise_equal_full_length_machines": same, "warm": warm_info,
            "warm_vs_plain_max_norm_err": warm_worst, "warm_held_to_one_ulp_movement": warm_admitted}


def phase_ragged_lstm_train():
    """The pad-up build of a ragged fleet of the bench's LSTM detectors
    (one padded group) and its exact build (one group per length), each
    built twice and the second counted; the padded build held per machine
    to the same program through the plain versions (and the plain lockstep
    fit) on the card, its full-length machines to the exact build's bit for
    bit (their CV scores to the weighted metrics of the exact build's
    predictions); then a warm exact rebuild from the padded build's params,
    held to its plain version on the card."""
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.serializer import from_definition

    machines, rows, tags = LSTM_TRAIN_SHAPE
    base = bench_fleet(np.random.default_rng(SEED + 11), machines, rows, tags)
    lens = ragged_lengths(rows, machines, RAGGED_LSTM_SPREAD, RAGGED_LSTM_STEP)
    Xs = [base[i, :n] for i, n in enumerate(lens)]
    spec = analyze_definition(from_definition(LSTM_TRAIN_MODEL))
    device = None if DEVICE == "cuda" else DEVICE
    padded_builder = FleetDiffBuilder(spec, pad_lengths=RAGGED_PAD, device=device)
    exact_builder = FleetDiffBuilder(spec, device=device)
    counters = _lstm_counters()
    padded, padded_info, pending = _build_counted(spec, padded_builder, Xs, counters)
    kept = _keep_out_of_fold(exact_builder)
    exact, exact_info, _ = _build_counted(spec, exact_builder, Xs, counters)
    check(all(getattr(d, "pad_built_", False) for d in padded), "every LSTM machine pad-built")
    worst, admitted = _hold_to_plain_program(spec, padded_builder, pending, padded, LSTM_RAGGED_TOLERANCE)
    emit({"phase": "ragged_lstm_train_vs_plain", "max_norm_err": worst, "held_to_one_ulp_movement": admitted})
    _check_worst(worst, LSTM_RAGGED_TOLERANCE, "ragged LSTM pad-up build vs its plain version")
    full = [i for i, n in enumerate(lens) if n == rows]
    same = _bitwise_equal(padded, exact, full, "padded vs exact LSTM build", skip=ce.METRIC_NAMES)
    _padded_scores_check(padded, kept, full, "padded LSTM build")

    warm = [d.base_estimator._final.state_arrays() for d in padded]
    warm_dets, warm_info, pending = _build_counted(spec, exact_builder, Xs, counters, warm)
    warm_worst, warm_admitted = _hold_to_plain_program(spec, exact_builder, pending, warm_dets,
                                                       LSTM_RAGGED_TOLERANCE)
    _check_worst(warm_worst, LSTM_RAGGED_TOLERANCE, "warm exact LSTM build vs its plain version")
    return {"machines": machines, "tags": tags, "lengths": sorted(set(lens.tolist())),
            "pad_lengths": RAGGED_PAD, "padded": padded_info, "exact": exact_info,
            "vs_plain_max_norm_err": worst, "vs_plain_held_to_one_ulp_movement": admitted,
            "bitwise_equal_full_length_machines": same,
            "warm": warm_info, "warm_vs_plain_max_norm_err": warm_worst,
            "warm_held_to_one_ulp_movement": warm_admitted}


# -- reduced-precision serving (K10) and the streaming plane (K9) ------------

#: reduced precision against f32, per machine and output: max |f32 -
#: reduced| / max |f32|, the r12 bounds of tests/test_serving_precision.py
#: (:100-105 for bf16, :295 for int8)
PRECISION_BOUNDS = {
    "bfloat16": {"model-output": 0.03, "tag-anomaly-scores": 0.10,
                 "total-anomaly-score": 0.10, "anomaly-confidence": 0.10},
    "int8": {k: 0.25 for k in OUTPUTS},
}
#: the precision phase's fleet: a bucket of default detectors (the build
#: bench's 512) and one of LSTM detectors at the bench's LSTM
PRECISION_FLEET = {"default": 512, "lstm": 8}
PRECISION_ROWS = 64
#: the stream phase: default detectors (10 tags) and LSTM ae detectors
#: (50 tags), both with the smoothing window; rows each is fed in process
#: and over HTTP; machines of each kind whose every steady-state verdict is
#: held bit for bit to the request path
STREAM_FLEET = {"default": 64, "lstm": 8}
STREAM_ROWS = 300
STREAM_HTTP_ROWS = 20
STREAM_CHECKED = 8


def port_detector(definition, params, src, i, thresholds: bool = True):
    """The port's detector ``i`` of the stacked random arrays ``src``."""
    from gordo_tpu_torch import convert

    return convert.from_reference(
        definition, params,
        scaler_stats=[{"scale": src["scale"][i], "offset": src["offset"][i]}],
        detector_stats={"scale": src["det_scale"][i], "offset": src["det_offset"][i]},
        feature_thresholds=src["feature_thresholds"][i] if thresholds else None,
        aggregate_threshold=float(src["agg"][i]) if thresholds else None,
    )


def dense_params(chain, i):
    return {(f"dense_{l}" if l < len(chain["layers"]) - 1 else "out"): {"kernel": W[i], "bias": b[i]}
            for l, (W, b) in enumerate(chain["layers"])}


def lstm_params(net, i):
    from gordo_tpu_torch import convert

    return convert.lstm_layers_to_flax([tuple(a[i] for a in c) for c in net["cells"]],
                                       (net["head"][0][i], net["head"][1][i]))


def write_fleet(directory: str, rng, fleet: dict, window: bool) -> dict:
    """Dump ``fleet["default"]`` default detectors (10 tags) and
    ``fleet["lstm"]`` LSTM ae detectors (50 tags, lookback LOOKBACK),
    with the smoothing window when ``window``; returns ``{name: tags}``."""
    from gordo_tpu_torch import serializer

    tags = {}
    chain = random_chain(rng, fleet["default"], 10)
    net = random_lstm(rng, fleet["lstm"], LSTM_SHAPE[2])
    ff_def = with_window(DEFAULT_MODEL) if window else DEFAULT_MODEL
    lstm_def = with_window(LSTM_MODEL) if window else LSTM_MODEL
    models = [(f"ff-{i}", ff_def, dense_params(chain, i), chain, i) for i in range(fleet["default"])]
    models += [(f"lstm-{i}", lstm_def, lstm_params(net, i), net, i) for i in range(fleet["lstm"])]
    for name, definition, params, src, i in models:
        model = port_detector(definition, params, src, i)
        n = int(src["scale"].shape[1])
        meta = {"dataset": {"tag_list": [f"{name}-tag-{j}" for j in range(n)]}}
        serializer.dump(model, os.path.join(directory, name), metadata=meta)
        tags[name] = n
    return tags


@contextlib.contextmanager
def serve_dtype_env(dtype: str):
    """Within: ``GORDO_SERVE_DTYPE=dtype`` (and the int8 opt-in)."""
    saved = {k: os.environ.get(k) for k in ("GORDO_SERVE_DTYPE", "GORDO_SERVE_INT8")}
    os.environ["GORDO_SERVE_DTYPE"] = dtype
    if dtype == "int8":
        os.environ["GORDO_SERVE_INT8"] = "1"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fake_quant_leaves(leaves, groups):
    """``fake_quant_many`` over every leaf (one launch, as a load takes
    them), and its plain version leaf by leaf, as two calls."""
    from gordo_tpu_torch.kernels import fake_quant as fq

    run = lambda: fq.fake_quant_many(leaves, groups)  # noqa: E731
    plain = lambda: [fq.fake_quant_plain(t, g) for t, g in zip(leaves, groups)]  # noqa: E731
    return run, plain


def _bf16_nan(t: torch.Tensor) -> torch.Tensor:
    """Where a bf16 tensor holds NaN."""
    return torch.isnan(t.float())


def fake_quant_edge_leaves(rng, put):
    """Leaves at the kernel's edges, beside each bucket's: all zero (the
    1e-12 floor) in f32 and bf16, one element, a NaN in a small bf16 leaf
    and in one past ``BIG`` (a cluster's), gate blocks of unequal ranges
    (``groups=4``) in both dtypes, a leaf whose rows are one column."""
    from gordo_tpu_torch.kernels import fake_quant as fq

    bf = torch.bfloat16
    small_nan = rng.standard_normal((3, 7))
    small_nan[1, 2] = np.nan
    big_nan = rng.standard_normal((fq.BIG + 5, 2))
    big_nan[fq.BIG, 1] = np.nan
    gates = rng.standard_normal((64, 50, 4 * 50))
    gates[..., 50:100] *= 20.0
    leaves = [put(np.zeros((5, 3))), put(np.zeros((5, 3))).to(bf), put(np.array([0.37])),
              put(small_nan).to(bf), put(big_nan), put(gates), put(gates).to(bf),
              put(rng.standard_normal((fq.BIG * 3, 1)))]
    return leaves, [1, 1, 1, 1, 1, 4, 4, 1]


def phase_precision_kernel_check():
    """The bf16 instantiations of ``fleet_score`` and ``lstm_layer`` and the
    ``fake_quant`` kernel against their plain versions on the card."""
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 20)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    entries = {}

    # fleet_score over bf16 storage at the default bucket, and a subset
    machines, n, tags = KERNEL_SHAPES[0]
    chain = random_chain(rng, machines, tags)
    dev = to_device(chain, DEVICE)
    layers = [(W.to(bf), b.to(bf)) for W, b in dev["layers"]]
    (form, s, o), (det_form, ds, do) = dev["kw"]["chain"][0], dev["kw"]["det"]
    kw = dict(chain=[(form, s.to(bf), o.to(bf))], det=(det_form, ds.to(bf), do.to(bf)), agg_thr=dev["kw"]["agg_thr"])
    x = put(rng.standard_normal((machines, n, tags))).to(bf)
    run = lambda: fs.fleet_score(x, layers, chain["acts"], **kw)  # noqa: E731
    plain = lambda: fs.fleet_score_plain(x, layers, chain["acts"], **kw)  # noqa: E731
    launches0 = fs.bf16_launches
    got, ref = run(), plain()
    check(DEVICE != "cuda" or fs.bf16_launches == launches0 + 1, "the bf16 fleet_score launch is counted as bf16")
    errs, abs_err = compare(ref, got)
    check(all(e <= TOLERANCE for e in errs.values()), f"bf16 fleet_score within {TOLERANCE}: {errs}")
    entry = {"shape": [machines, n, tags], "storage": "bfloat16", "max_norm_err": errs, "max_abs_err": abs_err,
             "hashes": output_hashes(got)}
    m_sub = machines // 8
    idx = np.sort(rng.choice(machines, m_sub, replace=False))[::-1].copy()
    rows = rng.integers(1, n + 1, m_sub)
    xs = put(rng.standard_normal((m_sub, n, tags))).to(bf)
    got_s = fs.fleet_score(xs, layers, chain["acts"], idx=idx, n_rows=rows, **kw)
    ref_s = fs.fleet_score_plain(xs, layers, chain["acts"], idx=idx, n_rows=rows, **kw)
    errs_s, abs_s = compare(ref_s, got_s, rows)
    check(all(e <= TOLERANCE for e in errs_s.values()), f"bf16 fleet_score subset within {TOLERANCE}: {errs_s}")
    entry["subset"] = {"machines": m_sub, "max_norm_err": errs_s, "max_abs_err": abs_s,
                       "hashes": output_hashes(got_s, rows)}
    entry["max_abs_err"] = max(abs_err, abs_s)
    # a NaN threshold gives a NaN confidence, as jnp.maximum and the plain
    # version keep it
    nan_kw = dict(kw, agg_thr=torch.where(torch.arange(machines, device=DEVICE) == idx[0],
                                          torch.nan, kw["agg_thr"]))
    got_n = fs.fleet_score(xs, layers, chain["acts"], idx=idx, n_rows=rows, **nan_kw)["anomaly-confidence"]
    check(bool(torch.isnan(got_n[0, :rows[0]]).all()) and bool(got_n[1, :rows[1]].isfinite().all()),
          "a NaN threshold gives a NaN confidence, and only its slot's")
    time_entry(entry, run, plain, 20, 5)
    entry.update(fleet_score_bound(machines, n, chain["dims"], machines, in_bytes=2))
    entries["fleet_score_bf16"] = entry
    stacked_ff = [t for layer in layers for t in layer] + [*kw["chain"][0][1:], *kw["det"][1:]]
    del x, got, ref, xs, got_s, ref_s

    # lstm_layer over bf16 storage: six layers at the bench's LSTM, each fed
    # what the kernel made for the layer before, then the bf16 head
    machines, n, tags = LSTM_SHAPE
    net = random_lstm(rng, machines, tags)
    x = put(rng.standard_normal((machines, n, tags))).to(bf)
    scale, offset = put(net["scale"]).to(bf), put(net["offset"]).to(bf)
    h, layer_entries, stacked_lstm, groups_lstm = x, [], [], []
    for i, cell in enumerate(net["cells"]):
        ki, kh, b = (put(a).to(bf) for a in cell)
        stacked_lstm += [ki, kh, b]
        groups_lstm += [4, 4, 4]
        n_in, hidden = int(ki.shape[1]), int(kh.shape[1])
        first, last = i == 0, i == len(net["cells"]) - 1
        lkw = dict(lookback=LOOKBACK, act="tanh", last=last,
                   chain=[minmax_step(scale, offset)] if first else None)
        inp = h
        run = lambda: ll.lstm_layer(inp, ki, kh, b, **lkw)  # noqa: E731
        plain = lambda: ll.lstm_layer_plain(inp, ki, kh, b, **lkw)  # noqa: E731
        launches0 = ll.bf16_launches
        got, ref = run(), plain()
        check(DEVICE != "cuda" or ll.bf16_launches == launches0 + 1, "a bf16 lstm_layer launch is counted as bf16")
        check(got.dtype == torch.float32 and bool(got.isfinite().all()), f"bf16 lstm_layer {i}: finite f32")
        err = norm_err(ref, got)
        check(err <= LSTM_TOLERANCE["lstm_layer"], f"bf16 lstm_layer {i} within {LSTM_TOLERANCE['lstm_layer']}: {err}")
        e = {"layer": i, "widths": [n_in, hidden], "max_norm_err": err,
             "max_abs_err": float((ref.double() - got.double()).abs().max())}
        del ref
        time_entry(e, run, plain, 5)
        nbytes, ops = lstm_layer_cost(machines, n, n_in, hidden, first, last)
        # the first layer's rows and every layer's weights are read at 2 bytes
        weights = machines * 4 * hidden * (n_in + hidden + 1)
        nbytes -= 2 * (weights + (machines * n * n_in if first else 0))
        e.update(bound(nbytes, ops))
        layer_entries.append(e)
        h = got
    total = {k: sum(e[k] for e in layer_entries) for k in ("ms", "plain_ms", "bytes", "flops") if k in layer_entries[0]}
    total.update(bound(total["bytes"], total["flops"]))
    entries["lstm_layer_bf16"] = {"layers": layer_entries, "storage": "bfloat16", "shape": [machines, n, tags],
                                  "tolerance": LSTM_TOLERANCE["lstm_layer"],
                                  "max_abs_err": max(e["max_abs_err"] for e in layer_entries), **total}
    W, bh = put(net["head"][0]).to(bf), put(net["head"][1]).to(bf)
    stacked_lstm += [W, bh]
    groups_lstm += [1, 1]
    det = dict(det=minmax_step(put(net["det_scale"]).to(bf), put(net["det_offset"]).to(bf)),
               y=x, y_offset=LOOKBACK - 1)
    stacked_lstm += [scale, offset, *det["det"][1:]]
    groups_lstm += [1, 1, 1, 1]
    run = lambda: fs.fleet_score(h, [(W, bh)], ["linear"], **det)  # noqa: E731
    plain = lambda: fs.fleet_score_plain(h, [(W, bh)], ["linear"], **det)  # noqa: E731
    got, ref = run(), plain()
    errs = {k: norm_err(ref[k], got[k]) for k in ref}
    check(all(e <= LSTM_TOLERANCE["fleet_score"] for e in errs.values()), f"bf16 LSTM head within tolerance: {errs}")
    nw, hidden = n - LOOKBACK + 1, int(W.shape[1])
    head = {"shape": [machines, nw, hidden, tags], "storage": "bfloat16", "max_norm_err": errs,
            "max_abs_err": max(float((ref[k].double() - got[k].double()).abs().max()) for k in ref),
            "hashes": output_hashes(got)}
    time_entry(head, run, plain, 20, 5)
    head.update(bound(4 * machines * nw * hidden + 2 * machines * nw * tags  # f32 states, bf16 targets
                      + 2 * machines * (hidden * tags + 3 * tags)  # bf16 head and detector stats
                      + 4 * machines * nw * (2 * tags + 1),  # f32 pred, tags, total
                      2 * machines * nw * hidden * tags))
    entries["fleet_score_bf16"]["lstm_head"] = head
    entries["fleet_score_bf16"]["max_abs_err"] = max(entries["fleet_score_bf16"]["max_abs_err"], head["max_abs_err"])
    del x, h, got, ref

    # fake_quant: every stacked leaf of the two buckets (stored bf16, one
    # scale across the machines, as the bucket path quantises), one
    # machine's f32 leaves (the per-machine path) and the kernel's edge
    # leaves, each set in one launch; bit for bit the plain version leaf by
    # leaf, NaN by place
    from gordo_tpu_torch.kernels import fake_quant as fq

    edge_leaves, edge_groups = fake_quant_edge_leaves(rng, put)
    fq_entries = {}
    for name, leaves, groups in (
        ("default_bucket", stacked_ff, [1] * len(stacked_ff)),
        ("lstm_bucket", stacked_lstm, groups_lstm),
        ("default_machine_f32", [t[:1].float().contiguous() for t in stacked_ff], [1] * len(stacked_ff)),
        ("edges", edge_leaves, edge_groups),
    ):
        run, plain = fake_quant_leaves(leaves, groups)
        before = fq.launches
        got, ref = run(), plain()
        if DEVICE == "cuda":
            check(fq.launches - before == 1, f"fake_quant {name}: one launch, got {fq.launches - before}")
        worst = 0.0
        for a, g, r in zip(leaves, got, ref):
            check(g.dtype == bf and tuple(g.shape) == tuple(a.shape), f"fake_quant {name}: bf16 of the leaf's shape")
            nan = _bf16_nan(r)
            check(bool(torch.equal(_bf16_nan(g), nan))
                  and bool(torch.equal(g.view(torch.int16)[~nan], r.view(torch.int16)[~nan])),
                  f"fake_quant {name} bit for bit its plain version, NaN by place")
            if bool(nan.any()):
                continue
            levels = (g.float() / g.float().abs().amax().clamp_min(1e-30) * 127).round().unique().numel()
            check(levels <= 255, f"fake_quant {name}: at most 255 levels, got {levels}")
            worst = max(worst, float((g.double() - r.double()).abs().max()))
        e = {"leaves": len(leaves), "elements": int(sum(t.numel() for t in leaves)),
             "input": str(leaves[0].dtype).replace("torch.", ""), "max_abs_err": worst}
        time_entry(e, run, plain, 20, 5)
        e.update(bound(sum(t.numel() * (t.element_size() + 2) for t in leaves),
                       sum(4 * t.numel() for t in leaves)))
        fq_entries[name] = e
    entries["fake_quant"] = {**fq_entries["default_bucket"], "variants": fq_entries}
    emit({"phase": "precision_kernel_check", "kernels": entries})
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def _served_error(ref: dict, got: dict, bounds: dict) -> dict:
    """Per output, max |ref - got| / max |ref| of one machine's response."""
    errs = {}
    for k, tol in bounds.items():
        if k not in ref:
            continue
        r, g = np.asarray(ref[k], np.float64), np.asarray(got[k], np.float64)
        check(r.shape == g.shape and np.isfinite(g).all(), f"{k}: finite, shape {r.shape}")
        errs[k] = float(np.abs(r - g).max() / max(np.abs(r).max(), 1e-6))
    return errs


def phase_precision_serve():
    """The default-detector bucket and the LSTM bucket served at f32, bf16
    and int8 over HTTP: per-machine, bulk and one-machine-subset requests,
    each reduced response held to the f32 one with the r12 bounds; device
    bytes resident per bucket; launches of each kernel while serving."""
    from gordo_tpu_torch.kernels import fake_quant as fq
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.serve.server import ModelCollection, make_server

    rng = np.random.default_rng(SEED + 21)
    out = {"fleet": PRECISION_FLEET, "rows": PRECISION_ROWS, "dtypes": {}}
    responses = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prec_") as tmp:
        tags = write_fleet(tmp, rng, PRECISION_FLEET, window=False)
        X = {name: rng.standard_normal((PRECISION_ROWS, t)).astype(np.float32) for name, t in tags.items()}
        singles = ["ff-0", "ff-1", "ff-2", "ff-3", "lstm-0", "lstm-1"]
        # one machine of each bucket: the subset path of both
        subset = {name: X[name] for name in (f"ff-{PRECISION_FLEET['default'] - 1}",
                                             f"lstm-{PRECISION_FLEET['lstm'] - 1}")}
        for dtype in ("float32", "bfloat16", "int8"):
            info = {}
            fq.launches = 0
            t0 = time.perf_counter()
            with serve_dtype_env(dtype):
                collection = ModelCollection.from_directory(
                    tmp, project="prec", device=None if DEVICE == "cuda" else DEVICE)
            check(collection.serve_dtype == dtype, f"collection serves at {dtype}, got {collection.serve_dtype}")
            info["load_seconds"] = time.perf_counter() - t0
            server = make_server(collection, "127.0.0.1", 0)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/prec"
            for mod in (fs, ll):
                mod.launches = 0
                mod.bf16_launches = 0
            got, latencies = {}, []
            try:
                for name in singles:
                    t0 = time.perf_counter()
                    status, body = _request(f"{base}/{name}/anomaly/prediction", {"X": X[name].tolist()})
                    latencies.append(time.perf_counter() - t0)
                    check(status == 200, f"{dtype} {name}: {status} {body}")
                    got[("machine", name)] = body["data"]
                t0 = time.perf_counter()
                status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                        {"X": {n: a.tolist() for n, a in X.items()}})
                info["bulk_seconds"] = time.perf_counter() - t0
                check(status == 200, f"{dtype} bulk: {status}")
                for name in X:
                    got[("bulk", name)] = body["data"][name]
                status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                        {"X": {n: a.tolist() for n, a in subset.items()}})
                check(status == 200, f"{dtype} subset: {status}")
                for name in subset:
                    got[("subset", name)] = body["data"][name]
                launches = {"fleet_score": fs.launches, "fleet_score_bf16": fs.bf16_launches,
                            "lstm_layer": ll.launches, "lstm_layer_bf16": ll.bf16_launches,
                            "fake_quant": fq.launches}
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            check(not thread.is_alive(), "server thread stopped")
            # 6 single requests, then one launch per bucket (two) for the
            # bulk request and for the subset request; each LSTM scoring
            # runs every LSTM layer
            reduced = dtype != "float32"
            n_cells = len(hourglass(LSTM_SHAPE[2])) - 2
            want = {"fleet_score": 10, "fleet_score_bf16": 10 if reduced else 0,
                    "lstm_layer": n_cells * 4, "lstm_layer_bf16": n_cells * 4 if reduced else 0}
            # int8 quantises every float leaf once, all the leaves of a load
            # (each machine's scorer: every layer's W and b and the two
            # scalers' stats, an LSTM's cells' three leaves, its head's two
            # and the four stats; then each bucket's stacked leaves) in one
            # launch
            want["fake_quant"] = (PRECISION_FLEET["default"] + PRECISION_FLEET["lstm"] + 2
                                  if dtype == "int8" else 0)
            if DEVICE == "cuda":
                check(launches == want, f"{dtype} serving launches {launches}, expected {want}")
            info["launches"] = launches
            info["request_seconds_p50"] = float(np.median(latencies))
            info["resident_bytes"] = {
                ("default" if b.mode == "none" else "lstm"): b.resident_bytes()
                for b in collection.fleet_scorer.buckets
            }
            responses[dtype] = got
            out["dtypes"][dtype] = info
            del collection
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    worst = {}
    for dtype in ("bfloat16", "int8"):
        w = {}
        for key, ref in responses["float32"].items():
            errs = _served_error(ref, responses[dtype][key], PRECISION_BOUNDS[dtype])
            for k, e in errs.items():
                check(e <= PRECISION_BOUNDS[dtype][k],
                      f"{dtype} {key} {k}: {e:.4%} of f32, over {PRECISION_BOUNDS[dtype][k]:.0%}")
                w[f"{key[0]} {k}"] = max(w.get(f"{key[0]} {k}", 0.0), e)
        worst[dtype] = w
    f32_bytes = out["dtypes"]["float32"]["resident_bytes"]
    for dtype in ("bfloat16", "int8"):
        for bucket, nbytes in out["dtypes"][dtype]["resident_bytes"].items():
            check(nbytes < 0.55 * f32_bytes[bucket], f"{dtype} {bucket} bucket resident {nbytes} of f32's {f32_bytes[bucket]}")
    out["max_norm_err_vs_f32"] = worst
    out["bounds"] = PRECISION_BOUNDS
    return out


def stream_bound(H: int, F: int, W: int, dims, elem: int, lstm: bool, rows: int = None):
    """Least time of one ``stream_step``: the ring read and written, the new
    row, the chain's weights and stats read once at the storage width (an
    LSTM's state in f32: ``rows`` of it), the carried tag scores read and
    written (f32), the verdict written; the dense stack's FLOPs over the
    ``rows`` scored rows (default W, the priming mode; 1 a carried step)
    and every row's L2 total."""
    rows = W if rows is None else rows
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    fo = dims[-1]
    nbytes = elem * (2 * H * F + F + weights + (0 if lstm else 2 * F) + 2 * fo) + 4 * (fo + 4)
    nbytes += 4 * (W * fo if rows == W else 2 * W * fo)
    if lstm:
        nbytes += 4 * rows * dims[0]
    flops = 2 * rows * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1)) + 2 * W * fo
    return bound(nbytes, flops)


#: rows a kernel check streams from an empty ring: across the warm-up
#: (an LSTM's first valid row is its LOOKBACK-th) and past a full ring
STREAM_CHECK_EXTRA_ROWS = 8


def launch_floor_ms() -> dict:
    """The card's launch floor: an empty kernel from ``stream_step``'s
    library, timed as a step is (``time_ms``: CUDA events around launches
    enqueued while the card sleeps; and the host's enqueue time)."""
    from gordo_tpu_torch.kernels import stream_step as sk

    ms, host_ms = time_ms(lambda: sk.empty_launch(torch.device(DEVICE)), 500)
    return {"ms": ms, "host_ms": host_ms}


def phase_stream_kernel_check():
    """``stream_step`` (and its shift alone) against its plain version and,
    bit for bit, against the request path's kernels over the same rows, for
    a default detector, an LSTM ae detector and a chain-C detector (its
    chain's output as the dense stack's input), at f32 and over bf16; a
    stream of rows from an empty ring through the carried one-row mode
    (the LSTM's layers over the newest window) held bit for bit to the
    full-window mode at every row, and the plain version's carried mode to
    its full mode; both modes' times beside the card's launch floor."""
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import rolling_median as rm
    from gordo_tpu_torch.kernels import stream_step as sk

    rng = np.random.default_rng(SEED + 22)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    entries = {}
    W = SMOOTH_WINDOW
    for kind in ("default", "lstm", "chain"):
        if kind == "default":
            src = random_chain(rng, 1, 10)
            layers = [(put(w), put(b)) for w, b in src["layers"]]
            acts, dims, offset_rows, F = src["acts"], src["dims"], 0, 10
        elif kind == "chain":
            # chain C's stream: chain_apply's output of the ring's rows feeds the dense stack
            src = random_chain_c(rng, 1, 10, CHAIN_C_K)
            layers = [(put(w), put(b)) for w, b in src["layers"]]
            acts, dims, offset_rows, F = src["acts"], src["dims"], 0, 10
        else:
            src = random_lstm(rng, 1, LSTM_SHAPE[2])
            layers = [(put(src["head"][0]), put(src["head"][1]))]
            acts, F, offset_rows = ["linear"], LSTM_SHAPE[2], LOOKBACK - 1
            dims = [src["dims"][-1], F]
        H = offset_rows + W
        for dtype in (torch.float32, torch.bfloat16):
            cast = lambda t: None if t is None else (t if t.dtype != torch.float32 else t.to(dtype))  # noqa: E731
            lay = [(cast(w), cast(b)) for w, b in layers]
            st = {k: cast(put(src[k])) for k in ("scale", "offset", "det_scale", "det_offset")}
            pipe, det = [minmax_step(st["scale"], st["offset"])], minmax_step(st["det_scale"], st["det_offset"])
            thr = put(src["agg"])
            cells = [tuple(cast(put(a)) for a in c) for c in src.get("cells", [])]
            ring = cast(put(rng.standard_normal((H, F))))
            row = cast(put(rng.standard_normal(F)))
            if kind == "chain":
                steps = [dataclasses.replace(st, a=cast(st.a), b=cast(st.b)) for st in chain_c_steps(src, DEVICE)]

            def model_input(ring_now, newest=False, plain=False):
                # the dense stack's input: the LSTM's last-layer state of the
                # ring's windows, or the chain's output of its rows; or of the
                # newest window (row) alone
                if kind == "chain":
                    fn = ca.chain_apply_plain if plain else ca.chain_apply
                    x = ring_now[None, W - 1:] if newest else ring_now[None]
                    return fn(x, steps, out_dtype=torch.float32)[0]
                fn = ll.lstm_layer_plain if plain else ll.lstm_layer
                h = ring_now[None, W - 1: W - 1 + LOOKBACK] if newest else ring_now[None]
                for i, (ki, kh, b) in enumerate(cells):
                    h = fn(h, ki, kh, b, lookback=LOOKBACK, act="tanh",
                           n_windows=(1 if newest else W) if i == 0 else None, chain=pipe if i == 0 else None,
                           last=i == len(cells) - 1)
                return h[0]

            def score(ring_in, count, x=None, ring_out=None, plain=False, tags_in=None, tags_out=None):
                fn = sk.stream_step_plain if plain else sk.stream_step
                kw = dict(window=W, mode_offset=offset_rows, det=det, agg_thr=thr,
                          tags_in=tags_in, tags_out=tags_out)
                if kind == "default":
                    return fn(ring_in, count, lay, acts, chain=pipe, x=x, ring_out=ring_out, **kw)
                # the newest window alone, as the stream takes it on the card
                newest = tags_in is not None and not plain and DEVICE == "cuda"
                return fn(ring_in, count, lay, acts, h=model_input(ring_in, newest, plain), **kw)

            e = {"ring": [H, F], "window": W, "storage": str(dtype).replace("torch.", ""),
                 "sort_k": sk.launch_plan(dims, W).sort_k}
            # steady state, and warm-up (count < H: older scores masked)
            for label, count0 in (("steady", 10 * H), ("warm_up", offset_rows + 3)):
                count_k = torch.tensor([count0], dtype=torch.int32, device=DEVICE)
                count_p = count_k.clone()
                out_k, out_p = torch.empty_like(ring), torch.empty_like(ring)
                if kind == "default":
                    got = score(ring, count_k, row, out_k)
                    ref = score(ring, count_p, row, out_p, plain=True)
                else:
                    sk.stream_shift(ring, out_k, count_k, row)
                    sk.stream_shift_plain(ring, out_p, count_p, row)
                    got = score(out_k, count_k)
                    ref = score(out_p, count_p, plain=True)
                check(bool(torch.equal(out_k, out_p)) and int(count_k) == int(count_p) == count0 + 1,
                      f"stream_step {kind} {label}: the shifted ring and count equal the plain version's")
                fin = ~torch.isnan(ref)
                check(bool(torch.equal(fin, ~torch.isnan(got))), f"stream_step {kind} {label}: NaN where the plain version has it")
                err = norm_err(ref[fin], got[fin])
                check(err <= TOLERANCE, f"stream_step {kind} {label} within {TOLERANCE}: {err}")
                e[label] = {"max_norm_err": err, "max_abs_err": float((ref[fin].double() - got[fin].double()).abs().max())}
                if label == "steady":
                    # the request path's kernels over the same H rows
                    fo = F
                    if kind == "default":
                        scored = fs.fleet_score(out_k[None], lay, acts, chain=pipe, det=det)
                    else:
                        scored = fs.fleet_score(model_input(out_k)[None], lay, acts, y=out_k[None],
                                                y_offset=offset_rows, det=det)
                    med = rm.rolling_median(scored["tag-anomaly-scores"], scored["total-anomaly-score"], W,
                                            agg_thr=thr)
                    want = torch.cat([med["tag-anomaly-scores"][0, -1], med["total-anomaly-score"][0, -1:],
                                      med["anomaly-confidence"][0, -1:]])
                    check(bool(torch.equal(got[:fo + 2], want)),
                          f"stream_step {kind} {str(dtype)}: the verdict is bit for bit the request path's")
                    check(float(got[fo + 2]) == 1.0, "a steady-state row is valid")
            e["carried"] = _carried_stream_check(kind, score, rng, H, F, W, dtype)
            e["max_abs_err"] = max(e["steady"]["max_abs_err"], e["warm_up"]["max_abs_err"],
                                   e["carried"]["max_abs_err"])
            count_t = torch.tensor([H], dtype=torch.int32, device=DEVICE)
            out_t = torch.empty_like(ring)
            fo = dims[-1]
            tags_t = [torch.randn((W, fo), device=DEVICE).abs() for _ in range(2)]
            if DEVICE == "cuda":
                if kind == "default":
                    full = lambda: score(ring, count_t, row, out_t)  # noqa: E731
                    one = lambda: score(ring, count_t, row, out_t, tags_in=tags_t[0], tags_out=tags_t[1])  # noqa: E731
                    plain = lambda: score(ring, count_t.clone(), row, out_t.clone(), plain=True,  # noqa: E731
                                          tags_in=tags_t[0], tags_out=tags_t[1].clone())
                else:
                    h_full = torch.randn((W, dims[0]), device=DEVICE)
                    skw = dict(window=W, mode_offset=offset_rows, det=det, agg_thr=thr)
                    full = lambda: sk.stream_step(out_t, count_t, lay, acts, h=h_full, **skw)  # noqa: E731
                    one = lambda: sk.stream_step(out_t, count_t, lay, acts, h=h_full[-1:], tags_in=tags_t[0],  # noqa: E731
                                                 tags_out=tags_t[1], **skw)
                    plain = lambda: sk.stream_step_plain(out_t, count_t, lay, acts, h=h_full[-1:],  # noqa: E731
                                                         tags_in=tags_t[0], tags_out=tags_t[1].clone(), **skw)
                    e["shift_ms"], e["shift_host_ms"] = time_ms(lambda: sk.stream_shift(ring, out_t, count_t, row), 200)
                e["ms"], e["host_ms"] = time_ms(one, 200)
                e["full_ms"], e["full_host_ms"] = time_ms(full, 200)
                e["plain_ms"], e["plain_host_ms"] = time_calls_ms(plain, 20)
            elem = 2 if dtype == torch.bfloat16 else 4
            e.update(stream_bound(H, F, W, dims, elem, kind != "default", rows=1))
            e["full_bound_ms"] = stream_bound(H, F, W, dims, elem, kind != "default")["bound_ms"]
            entries[f"{kind}_{e['storage']}"] = e
    if DEVICE == "cuda":
        entries["launch_floor"] = launch_floor_ms()
    emit({"phase": "stream_kernel_check", "kernels": {"stream_step": entries}})
    return entries


def _carried_stream_check(kind, score, rng, H, F, W, dtype) -> dict:
    """Rows streamed from an empty ring (count 0) past a full one, the
    kernel's carried mode (primed at the first row, then one new row a
    step; an LSTM's layers over the newest window) against its full mode
    at every row, bit for bit (verdicts and carried tag scores), the plain
    version's modes against each other the same way, and the kernel
    against the plain version within TOLERANCE."""
    rows = torch.from_numpy(rng.standard_normal((H + STREAM_CHECK_EXTRA_ROWS, F)).astype(np.float32))
    rows = rows.to(DEVICE).to(dtype)
    fo = F
    state = {}
    for name, plain in (("kernel", False), ("plain", True)):
        for mode in ("carried", "full"):
            rings = [torch.zeros((H, F), dtype=dtype, device=DEVICE), torch.zeros((H, F), dtype=dtype, device=DEVICE)]
            tags = [torch.zeros((W, fo), device=DEVICE), torch.zeros((W, fo), device=DEVICE)]
            state[name, mode] = {"rings": rings, "tags": tags, "cur": 0,
                                 "count": torch.zeros(1, dtype=torch.int32, device=DEVICE), "plain": plain,
                                 "carried": mode == "carried", "verdicts": [], "tag_hist": []}
    from gordo_tpu_torch.kernels import stream_step as sk

    for t in range(rows.shape[0]):
        for st in state.values():
            ring_in, ring_out = st["rings"][st["cur"]], st["rings"][1 - st["cur"]]
            tags_in = st["tags"][st["cur"]] if st["carried"] and t > 0 else None
            tags_out = st["tags"][1 - st["cur"]]
            if kind == "default":
                v = score(ring_in, st["count"], rows[t], ring_out, plain=st["plain"],
                          tags_in=tags_in, tags_out=tags_out)
            else:
                (sk.stream_shift_plain if st["plain"] else sk.stream_shift)(ring_in, ring_out, st["count"], rows[t])
                v = score(ring_out, st["count"], plain=st["plain"], tags_in=tags_in, tags_out=tags_out)
            st["cur"] = 1 - st["cur"]
            st["verdicts"].append(v)
            st["tag_hist"].append(tags_out.clone())
    out = {"rows": int(rows.shape[0]), "max_abs_err": 0.0, "max_norm_err": 0.0}
    for name in ("kernel", "plain"):
        a, b = state[name, "carried"], state[name, "full"]
        same = all(torch.equal(x, y) or (torch.isnan(x) == torch.isnan(y)).all()
                   and torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)])
                   for x, y in zip(a["verdicts"], b["verdicts"]))
        same_tags = all(torch.equal(x, y) for x, y in zip(a["tag_hist"], b["tag_hist"]))
        check(same and same_tags, f"stream_step {kind} {dtype} {name}: the carried mode is the full mode "
                                  f"bit for bit at every row (verdicts {same}, tags {same_tags})")
    valid = 0
    for got, ref in zip(state["kernel", "carried"]["verdicts"], state["plain", "carried"]["verdicts"]):
        fin = ~torch.isnan(ref)
        check(bool(torch.equal(fin, ~torch.isnan(got))), f"stream_step {kind} carried: NaN where the plain version has it")
        if fin.any():
            out["max_norm_err"] = max(out["max_norm_err"], norm_err(ref[fin], got[fin]))
            out["max_abs_err"] = max(out["max_abs_err"], float((ref[fin].double() - got[fin].double()).abs().max()))
        valid += int(float(got[-1]) == 1.0)
    check(out["max_norm_err"] <= TOLERANCE, f"stream_step {kind} carried within {TOLERANCE}: {out['max_norm_err']}")
    check(valid == rows.shape[0] - (H - W), f"stream_step {kind} carried: {valid} valid rows of {rows.shape[0]}")
    out["valid_rows"] = valid
    return out


def _sse_reader(url: str, want_last: list, events: list):
    """Read SSE frames from ``url`` into ``events`` until an event with id
    ``want_last[0]`` (set later) has arrived or the server closes."""
    req = urllib.request.Request(url, headers={"Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        frame = {}
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("id: "):
                frame["id"] = int(line[4:])
            elif line.startswith("event: "):
                frame["type"] = line[7:]
            elif line.startswith("data: "):
                frame["data"] = json.loads(line[6:])
            elif line == "" and frame:
                events.append(frame)
                frame = {}
            if want_last[0] is not None and events and events[-1]["id"] >= want_last[0]:
                return


def _stream_breakdown(collection, X: dict, names) -> dict:
    """Where a streamed row's time goes, per machine of ``names``: on the
    host clock, a row's ``ingest`` split into the enqueue (the row's cast
    and copy, the launches) and the wait for the verdict (the card's work
    and the copy back), over 100 steady-state rows of a throwaway stream;
    and under ``torch.profiler``, the card's time by kernel over 50 rows."""
    from torch.profiler import ProfilerActivity, profile

    from gordo_tpu_torch.serve.stream import MachineStream

    out = {}
    for name in names:
        ms = MachineStream(name, collection.get(name).scorer)
        rows = X[name]
        for r in rows[:ms.state_rows]:
            ms.ingest(r)
        enqueue, wait = [], []
        for r in rows[ms.state_rows: ms.state_rows + 100]:
            t0 = time.perf_counter()
            verdict = ms._advance(np.ascontiguousarray(r))
            t1 = time.perf_counter()
            verdict.cpu()
            enqueue.append(t1 - t0)
            wait.append(time.perf_counter() - t1)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in rows[:50]:
                ms.ingest(r)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_kernel = {}
        for evt in prof.key_averages():
            ms_dev = evt.self_device_time_total / 1e3
            if evt.device_type == torch.autograd.DeviceType.CUDA and ms_dev > 0:
                by_kernel[evt.key.split("(")[0][:60]] = {"ms_per_row": ms_dev / 50, "calls": evt.count}
        device = sum(v["ms_per_row"] for v in by_kernel.values())
        out[name] = {"enqueue_ms_p50": 1e3 * float(np.median(enqueue)),
                     "wait_ms_p50": 1e3 * float(np.median(wait)),
                     "device_ms_per_row": device, "profiled_ms_per_row": 1e3 * wall / 50,
                     "busy_share": device / (1e3 * wall / 50), "by_kernel": by_kernel}
    return out


def phase_stream():
    """64 default and 8 LSTM ae detectors with a window of 144 rows, each
    fed STREAM_ROWS rows in process, then STREAM_HTTP_ROWS over HTTP with an
    SSE subscriber and a poller; steady-state verdicts held bit for bit to
    the request path; a bf16 stream held to its f32 twin."""
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import rolling_median as rm
    from gordo_tpu_torch.kernels import stream_step as sk
    from gordo_tpu_torch.serve.server import ModelCollection, make_server
    from gordo_tpu_torch.serve.stream import MachineStream, reference_verdict

    rng = np.random.default_rng(SEED + 23)
    out = {"fleet": STREAM_FLEET, "rows": STREAM_ROWS, "window": SMOOTH_WINDOW, "lookback": LOOKBACK}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        tags = write_fleet(tmp, rng, STREAM_FLEET, window=True)
        # a detector that requires thresholds it never derived: 422
        chain = random_chain(rng, 1, 10)
        from gordo_tpu_torch import serializer
        serializer.dump(port_detector(with_window(DEFAULT_MODEL), dense_params(chain, 0), chain, 0,
                                      thresholds=False), os.path.join(tmp, "no-thresholds"))
        collection = ModelCollection.from_directory(tmp, project="stream",
                                                    device=None if DEVICE == "cuda" else DEVICE)
        hub = collection.stream_hub
        # each machine's rows: sines with noise, then a burst to cross the threshold
        X = {}
        for name, t in tags.items():
            rows = bench_fleet(rng, 1, STREAM_ROWS + STREAM_HTTP_ROWS, t)[0]
            rows[STREAM_ROWS - 40: STREAM_ROWS - 30] += 3.0
            X[name] = rows
        counters = {"stream_step": (sk, "launches"), "stream_shift": (sk, "shift_launches"),
                    "lstm_layer": (ll, "launches"), "fleet_score": (fs, "launches"),
                    "rolling_median": (rm, "launches")}
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        verdicts = {name: {} for name in tags}
        latency = {"default": [], "lstm": []}
        t_start = time.perf_counter()
        for r in range(STREAM_ROWS):
            for name in tags:
                scorer = collection.get(name).scorer
                t0 = time.perf_counter()
                events = hub.ingest_rows(name, scorer, X[name][r], dtype=collection.serve_dtype)
                latency["lstm" if name.startswith("lstm") else "default"].append(time.perf_counter() - t0)
                for ev in events:
                    if ev["type"] == "verdict":
                        verdicts[name][ev["data"]["step"]] = ev["data"]
        drive_seconds = time.perf_counter() - t_start
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        n_ff, n_lstm = STREAM_FLEET["default"], STREAM_FLEET["lstm"]
        n_cells = len(hourglass(LSTM_SHAPE[2])) - 2
        want = {"stream_step": (n_ff + n_lstm) * STREAM_ROWS, "stream_shift": n_lstm * STREAM_ROWS,
                "lstm_layer": n_cells * n_lstm * STREAM_ROWS, "fleet_score": 0, "rolling_median": 0}
        if DEVICE == "cuda":
            check(launches == want, f"stream launches {launches}, expected {want}")
        out["launches"] = launches
        out["drive_seconds"] = drive_seconds
        for kind, lat in latency.items():
            out[f"step_seconds_{kind}"] = {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99))}
        # every steady-state verdict of the checked machines, bit for bit
        checked = 0
        for name in [f"ff-{i}" for i in range(STREAM_CHECKED)] + [f"lstm-{i}" for i in range(min(STREAM_CHECKED, n_lstm))]:
            ms = hub.streams[name]
            H = ms.state_rows
            check(len(verdicts[name]) == STREAM_ROWS - ms.offset, f"{name}: one verdict per valid row")
            for t in range(H, STREAM_ROWS + 1):
                ref = reference_verdict(collection.get(name).scorer, X[name][t - H:t])
                v = verdicts[name][t]
                got = {"tag-anomaly-scores": np.asarray(v["tag-anomaly-scores"], np.float32),
                       "total-anomaly-score": np.float32(v["total-anomaly-score"]),
                       "anomaly-confidence": np.float32(v["anomaly-confidence"])}
                for k in ref:
                    check(np.asarray(got[k], np.float32).tobytes() == np.asarray(ref[k], np.float32).tobytes(),
                          f"{name} step {t} {k}: the streamed verdict is the request path's bit for bit")
                checked += 1
        out["verdicts_checked_bitwise"] = checked
        thresholds = sum(1 for ev in hub.ring.since(0)[0] if ev["type"] == "threshold")
        check(thresholds > 0, "the burst crossed some aggregate thresholds")
        out["threshold_events"] = thresholds

        # a bf16 stream of the checked machines, held to its f32 twin
        worst = {}
        for name in [f"ff-{i}" for i in range(STREAM_CHECKED)] + [f"lstm-{i}" for i in range(min(STREAM_CHECKED, n_lstm))]:
            twin = MachineStream(name, collection.get(name).scorer, dtype="bfloat16")
            series = {k: [] for k in ("tag-anomaly-scores", "total-anomaly-score", "anomaly-confidence")}
            ref = {k: [] for k in series}
            for t in range(1, STREAM_ROWS + 1):
                v = twin.ingest(X[name][t - 1])
                if v is None:
                    continue
                for k in series:
                    series[k].append(np.asarray(v[k], np.float64))
                    f32 = verdicts[name][t][k]
                    ref[k].append(np.asarray(f32, np.float64))
            errs = _served_error({k: np.stack(v) for k, v in ref.items()},
                                 {k: np.stack(v) for k, v in series.items()}, PRECISION_BOUNDS["bfloat16"])
            for k, e in errs.items():
                check(e <= PRECISION_BOUNDS["bfloat16"][k], f"bf16 stream {name} {k}: {e:.4%} of f32")
                worst[k] = max(worst.get(k, 0.0), e)
        out["bf16_max_norm_err_vs_f32"] = worst
        if DEVICE == "cuda":
            out["breakdown"] = _stream_breakdown(collection, X, ["ff-0", "lstm-0"])

        # over HTTP: an SSE subscriber and a poller from the ring's head
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/stream"
        head = hub.ring.last_id
        sse_events, want_last = [], [None]
        reader = threading.Thread(target=_sse_reader, args=(f"{base}/stream", want_last, sse_events),
                                  daemon=True)
        polled = []
        try:
            reader.start()
            deadline = time.time() + 30
            while hub.n_subscribers < 1 and time.time() < deadline:
                time.sleep(0.01)
            check(hub.n_subscribers == 1, "the SSE subscriber is attached")
            errors = {
                "bad body": _request(f"{base}/stream/ingest", {"nope": 1}),
                "unknown machine": _request(f"{base}/stream/ingest", {"machine": "no-such", "x": [0.0] * 10}),
                "bad width": _request(f"{base}/stream/ingest", {"machine": "ff-0", "x": [[0.0] * 3]}),
                "unsupported": _request(f"{base}/stream/ingest", {"machine": "no-thresholds", "x": [[0.0] * 10]}),
                "bad event id": _request(f"{base}/stream?mode=poll&after=x&timeout=0"),
                "unknown subscription": _request(f"{base}/stream?machines=no-such&mode=poll&timeout=0"),
            }
            statuses = {k: s for k, (s, _) in errors.items()}
            check(statuses == {"bad body": 400, "unknown machine": 404, "bad width": 400, "unsupported": 422,
                               "bad event id": 400, "unknown subscription": 404},
                  f"stream error answers {statuses}")
            http_events, t_http = 0, []
            for r in range(STREAM_ROWS, STREAM_ROWS + STREAM_HTTP_ROWS):
                if r % 2:
                    body = {"X": {name: [X[name][r].tolist()] for name in tags}}
                    t0 = time.perf_counter()
                    status, resp = _request(f"{base}/stream/ingest", body)
                    t_http.append(time.perf_counter() - t0)
                    check(status == 200 and resp["accepted"] == len(tags), f"bulk ingest: {status} {resp}")
                    http_events += resp["events"]
                else:
                    for name in tags:
                        status, resp = _request(f"{base}/stream/ingest", {"machine": name, "x": [X[name][r].tolist()]})
                        check(status == 200 and resp["accepted"] == 1, f"ingest {name}: {status} {resp}")
                        http_events += resp["events"]
            last = hub.ring.last_id
            check(last - head == http_events, f"the ring gained {last - head} events, the answers report {http_events}")
            want_last[0] = last
            cursor = head
            while cursor < last:
                status, doc = _request(f"{base}/stream?mode=poll&after={cursor}&timeout=5")
                check(status == 200 and doc["events"], f"poll after {cursor}: {status}")
                polled += doc["events"]
                cursor = doc["last-event-id"]
        finally:
            # closing the server ends the SSE writer, and with it the reader
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            reader.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
        check(not reader.is_alive(), "the SSE reader ended")
        ids_sse, ids_poll = [e["id"] for e in sse_events], [e["id"] for e in polled]
        expected_ids = list(range(head + 1, last + 1))
        check(ids_sse == expected_ids, f"SSE ids strictly increasing, none lost or repeated ({len(ids_sse)} of {len(expected_ids)})")
        check(ids_poll == expected_ids, f"poll ids strictly increasing, none lost or repeated ({len(ids_poll)} of {len(expected_ids)})")
        check([e["data"] for e in sse_events] == [e["data"] for e in polled], "SSE and poll carry the same events")
        out["http"] = {"rows": STREAM_HTTP_ROWS, "events": http_events,
                       "verdicts": sum(e["type"] == "verdict" for e in polled),
                       "ingest_seconds_p50": float(np.median(t_http)) if t_http else None}
        del collection
    return out


# -- resumable fits and the generic fleet API ------------------------------

#: the chunks a fit of TRAIN_SHAPE's 10 epochs is split into, each launch
#: starting from the last one's params and Adam state
RESUME_CHUNKS = (3, 3, 3, 1)
#: the checkpointed estimator fits: stopped after this many epochs, then
#: resumed to the full budget, a checkpoint every RESUME_EVERY epochs
RESUME_STOP, RESUME_EVERY = 4, 3
#: a fleet_fit's Adam moments against the plain version's, as its params
#: (TRAIN_TOLERANCE["fleet_fit"]: the gradients sum in another order;
#: measured on an H100 80GB HBM3 at 700 W 3.9e-7 on mu, 1.4e-7 on nu)
STATE_TOLERANCE = TRAIN_TOLERANCE["fleet_fit"]
#: the generic fleet API's fleet: TRAIN_SHAPE with machine i's rows cut
#: to 576 - (i mod FLEET_API_SPREAD), stacked by stack_rows
FLEET_API_SPREAD = 128


def fleet_apply_bound(m: int, n: int, dims):
    """Least time for one fleet_apply call: the rows and each machine's
    weights read once, the outputs written once, the dense layers' FLOPs."""
    weights = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    nbytes = 4 * (m * n * dims[0] + m * weights + m * n * dims[-1])
    return bound(nbytes, 2 * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1)) * m * n)


def _state_pairs(layers, state, prefix=""):
    pairs = {f"{prefix}layer{i}.{k}": t for i, (W, b) in enumerate(layers) for k, t in (("kernel", W), ("bias", b))}
    if state is not None:
        pairs.update({f"{prefix}mu": state.mu, f"{prefix}nu": state.nu, f"{prefix}count": state.count})
    return pairs


def phase_resume_kernel_check():
    """``fleet_fit`` resumed (``train.stateful_fit``) and weighted
    (``fleet.fit``), and ``fleet_apply``, on the card: the 10-epoch fit of
    TRAIN_SHAPE's four fits per machine once in one launch and once as
    chunks of RESUME_CHUNKS epochs, each from the last chunk's params and
    Adam state, which must be bit for bit the one launch (params, moments,
    counts, history), and the one launch against the plain version; the
    same fit with random non-binary row weights against its plain version,
    and with 0/1 weights bit for bit the launch with the equal row counts;
    ``fleet_apply`` at KERNEL_SHAPES against its plain version and bit for
    bit against ``fleet_score``'s model output."""
    from gordo_tpu_torch.kernels import fleet_apply as fa
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.parallel.fleet import fleet_draws, put_draws
    from gordo_tpu_torch.train.cv import TimeSeriesSplit
    from gordo_tpu_torch.train.fit import TrainConfig, adam_hparams

    machines, rows, tags = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 20)
    X = torch.from_numpy(bench_fleet(rng, machines, rows, tags)).to(DEVICE)
    cfg = TrainConfig()
    hp = adam_hparams(cfg)
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    row_lists = [tr for tr, _ in folds] + [np.arange(rows)]
    fits = [ff.geometry(r, cfg.batch_size) for r in row_lists]
    dims = hourglass(tags)
    acts = ["tanh"] * (len(dims) - 2) + ["linear"]
    scale, offset = ss.scaler_stats(X, row_lists)
    params0, perms = put_draws(fleet_draws, 0, dims, fits, cfg.epochs, X.device)
    zero = np.zeros(machines, np.int64)
    pipe = [minmax_step(scale, offset)]
    fit = lambda *a, **k: ff.fleet_fit(X, X, fits, *a, chain=pipe, **k)  # noqa: E731
    fit_plain = lambda *a, **k: ff.fleet_fit_plain(X, X, fits, *a, chain=pipe, **k)  # noqa: E731
    entries = {}

    def errors(ref: dict, got: dict, tol: dict, what: str):
        errs, worst = {}, 0.0
        for key, r in ref.items():
            g = got[key]
            check(bool(g.isfinite().all()) if g.is_floating_point() else True, f"{what} {key} is finite")
            errs[key] = norm_err(r, g)
            worst = max(worst, float((r.double() - g.double()).abs().max()))
            check(errs[key] <= tol[key], f"{what} {key}: {errs[key]} > {tol[key]}")
        return errs, worst

    def tolerance(keys):
        return {k: (0.0 if k == "count" else TRAIN_TOLERANCE["fleet_fit_history"] if k == "history"
                    else STATE_TOLERANCE) for k in keys}

    # one launch of all epochs, and the same fit as chunks from saved state
    layers, hist, state = fit(params0, perms, zero, acts, cfg.epochs, hp, return_state=True)
    whole = {**_state_pairs(layers, state), "history": hist}
    per_fit = ff.unpack_perms(perms.cpu(), fits, cfg.epochs)
    check(sum(RESUME_CHUNKS) == cfg.epochs, f"the chunks {RESUME_CHUNKS} cover {cfg.epochs} epochs")
    p, st, hists, e0 = params0, None, [], 0
    for chunk in RESUME_CHUNKS:
        part = torch.from_numpy(ff.pack_perms([q[:, e0:e0 + chunk].numpy() for q in per_fit])).to(DEVICE)
        p, h, st = fit(p, part, zero if st is None else np.arange(machines), acts, chunk,
                                hp, perm_draw=zero, state=st, return_state=True)
        hists.append(h)
        e0 += chunk
    chunked = {**_state_pairs(p, st), "history": torch.cat(hists, dim=-1)}
    for key, ref in whole.items():
        check(torch.equal(ref, chunked[key]), f"fleet_fit chunked {RESUME_CHUNKS}: {key} bit for bit")
    check(st.count.cpu().numpy().tolist() == [[cfg.epochs * fg.steps for fg in fits]] * machines,
          "the final Adam counts")
    layers_p, hist_p, state_p = fit_plain(params0, perms, zero, acts, cfg.epochs, hp,
                                                   return_state=True)
    plain = {**_state_pairs(layers_p, state_p), "history": hist_p}
    errs, abs_err = errors(plain, whole, tolerance(plain), "stateful fleet_fit")
    # the timed launch: all epochs from given (zero) state, state written
    zero_state = ff.FitState(torch.zeros_like(state.mu), torch.zeros_like(state.nu),
                             torch.zeros_like(state.count))
    run = lambda: fit(params0, perms, zero, acts, cfg.epochs, hp, state=zero_state,  # noqa: E731
                               return_state=True)
    plain_run = lambda: fit_plain(params0, perms, zero, acts, cfg.epochs, hp,  # noqa: E731
                                           state=zero_state, return_state=True)
    entry = {"max_norm_err": errs, "max_abs_err": abs_err, "tolerance": tolerance(errs),
             "chunks": list(RESUME_CHUNKS), "chunked_bitwise": True,
             **fleet_fit_bound(fits, dims, machines, rows, cfg.epochs, state=True)}
    if DEVICE == "cuda":
        entry["ms"], entry["host_ms"] = time_ms(run, 3)
        entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain_run, 2)
    entries["fleet_fit_stateful"] = entry

    # row weights: random, non-binary, a tenth of them 0
    w = rng.uniform(0.0, 2.0, (machines, rows)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.1] = 0.0
    w_dev = torch.from_numpy(w).to(DEVICE)
    run = lambda: fit(params0, perms, zero, acts, cfg.epochs, hp, w=w_dev)  # noqa: E731
    plain_run = lambda: fit_plain(params0, perms, zero, acts, cfg.epochs, hp, w=w_dev)  # noqa: E731
    (lw, hw), (lw_p, hw_p) = run(), plain_run()
    got = {**_state_pairs(lw, None), "history": hw}
    ref = {**_state_pairs(lw_p, None), "history": hw_p}
    errs, abs_err = errors(ref, got, tolerance(ref), "weighted fleet_fit")
    nonzero = np.stack([(w[:, r] != 0).sum(axis=1) for r in row_lists], axis=1)
    entry = {"max_norm_err": errs, "max_abs_err": abs_err, "tolerance": tolerance(errs),
             "zero_weights": int((w == 0).sum()),
             **fleet_fit_bound(fits, dims, machines, rows, cfg.epochs, nonzero, weights=True)}
    if DEVICE == "cuda":
        entry["ms"], entry["host_ms"] = time_ms(run, 3)
        entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain_run, 2)
    # 0/1 weights give the bits of the row counts they stand for
    lengths = ragged_lengths(rows, machines, FLEET_API_SPREAD)
    mask = torch.from_numpy((np.arange(rows)[None] < lengths[:, None]).astype(np.float32)).to(DEVICE)
    counts = np.minimum(lengths[:, None], [fg.n for fg in fits])
    by_mask = fit(params0, perms, zero, acts, cfg.epochs, hp, w=mask)
    by_counts = fit(params0, perms, zero, acts, cfg.epochs, hp, counts=counts)
    for (a, b), (c, d) in zip(by_mask[0], by_counts[0]):
        check(torch.equal(a, c) and torch.equal(b, d), "0/1 weights: params bit for bit the counts'")
    check(torch.equal(by_mask[1], by_counts[1]), "0/1 weights: history bit for bit the counts'")
    entry["mask_bitwise_counts"] = True
    entries["fleet_fit_weighted"] = entry
    del X, layers, layers_p, state, state_p, lw, lw_p, by_mask, by_counts

    # fleet_apply at the serving check's shapes
    shapes = []
    for m, n, t in KERNEL_SHAPES:
        chain = random_chain(rng, m, t)
        dev = to_device(chain, DEVICE)
        x = torch.from_numpy(rng.standard_normal((m, n, t)).astype(np.float32)).to(DEVICE)
        run = lambda: fa.fleet_apply(x, dev["layers"], chain["acts"])  # noqa: E731
        plain_run = lambda: fa.fleet_apply_plain(x, dev["layers"], chain["acts"])  # noqa: E731
        out, ref = run(), plain_run()
        check(tuple(out.shape) == (m, n, t) and bool(out.isfinite().all()), "fleet_apply output")
        err = norm_err(ref, out)
        check(err <= TOLERANCE, f"fleet_apply {m}x{n}x{t}: {err} > {TOLERANCE}")
        scored = fs.fleet_score(x, dev["layers"], chain["acts"])["model-output"]
        check(torch.equal(scored, out), f"fleet_apply {m}x{n}x{t} bit for bit fleet_score's model output")
        entry = {"shape": [m, n, t], "max_norm_err": err, "tolerance": TOLERANCE,
                 "max_abs_err": float((ref.double() - out.double()).abs().max()),
                 "bitwise_fleet_score": True, **fleet_apply_bound(m, n, chain["dims"])}
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, 20)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain_run, 5)
            # the chain of library calls the plain version makes (torch.bmm,
            # the bias, the activation per layer), back to back
            entry["library_chain_ms"], _ = time_ms(plain_run, 20)
        shapes.append(entry)
        del x, out, ref, scored
    entries["fleet_apply"] = {**shapes[0], "shapes": shapes,
                              "max_abs_err": max(e["max_abs_err"] for e in shapes)}
    emit({"phase": "resume_kernel_check", "shape": list(TRAIN_SHAPE), "kernels": entries})
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


@contextlib.contextmanager
def timed_checkpoints(seconds: dict):
    """Within: the seconds of every checkpoint save and load, by kind."""
    from gordo_tpu_torch.train import checkpoint

    saved = {name: getattr(checkpoint, name) for name in ("save_checkpoint", "load_checkpoint")}

    def timing(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return call

    for name, fn in saved.items():
        setattr(checkpoint, name, timing(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(checkpoint, name, fn)


def phase_resume():
    """Checkpointed fits through the estimators on the card: a default
    detector's ``AutoEncoder`` on one machine of TRAIN_SHAPE and an
    ``LSTMAutoEncoder`` at LSTM_TRAIN_MODEL's widths, each fitted with
    ``checkpoint_dir``, stopped after RESUME_STOP epochs, then resumed to
    the full budget; params and history must be the uninterrupted fit's
    bit for bit.  Launches (set to 0 just before the checkpointed fits):
    ``fleet_fit`` once per chunk, the LSTM training kernels per step."""
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.models.estimator import AutoEncoder, LSTMAutoEncoder
    from gordo_tpu_torch.train import checkpoint

    device = None if DEVICE == "cuda" else DEVICE
    lstm_kwargs = dict(LSTM_TRAIN_MODEL["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
        "gordo_tpu.pipeline.Pipeline"]["steps"][1]["gordo_tpu.models.estimator.LSTMAutoEncoder"])
    _, rows, tags = TRAIN_SHAPE
    _, lrows, ltags = LSTM_TRAIN_SHAPE
    cases = {
        "autoencoder": (AutoEncoder, {"kind": "feedforward_hourglass"},
                        bench_fleet(np.random.default_rng(SEED + 21), 1, rows, tags)[0]),
        "lstm_autoencoder": (LSTMAutoEncoder, lstm_kwargs,
                             bench_fleet(np.random.default_rng(SEED + 22), 1, lrows, ltags)[0]),
    }
    counters = {"fleet_fit": (ff, "launches"), **_lstm_counters()}
    counters = {k: counters[k] for k in ("fleet_fit", "lstm_layer_train", "lstm_layer_bwd",
                                         "lstm_head_fit", "fleet_adam", "fleet_init")}
    out = {}
    for name, (cls, kwargs, X) in cases.items():
        epochs = kwargs.get("epochs", 10)
        t0 = time.perf_counter()
        ref = cls(**kwargs).fit(X, device=device)
        first_fit_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = cls(**kwargs).fit(X, device=device)
        fit_seconds = time.perf_counter() - t0
        for key, v in ref.state_arrays().items():
            check(np.array_equal(v, again.state_arrays()[key]), f"{name}: a repeated fit's {key} bit for bit")
        seconds = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            with timed_checkpoints(seconds):
                cls(**{**kwargs, "epochs": RESUME_STOP}).fit(
                    X, device=device, checkpoint_dir=tmp, checkpoint_every=RESUME_EVERY)
                stopped = checkpoint.load_checkpoint(tmp)
                got = cls(**kwargs).fit(X, device=device, checkpoint_dir=tmp,
                                        checkpoint_every=RESUME_EVERY)
            resume_seconds = time.perf_counter() - t0
            launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
            payload = sum(os.path.getsize(os.path.join(tmp, "ckpt", f))
                          for f in os.listdir(os.path.join(tmp, "ckpt")))
        check(stopped is not None and stopped.epochs_done == RESUME_STOP, f"{name} stopped at {RESUME_STOP}")
        for key, v in ref.state_arrays().items():
            check(np.array_equal(v, got.state_arrays()[key]), f"{name} resumed: {key} bit for bit")
        check(np.array_equal(ref.history_, got.history_), f"{name} resumed: history bit for bit")
        check(bool(np.isfinite(got.history_).all()) and len(got.history_) == epochs, f"{name} history")
        chunks = -(-RESUME_STOP // RESUME_EVERY) + -(-(epochs - RESUME_STOP) // RESUME_EVERY)
        if DEVICE == "cuda":
            if cls is AutoEncoder:
                check(launches["fleet_fit"] == chunks, f"{name}: {launches['fleet_fit']} fleet_fit launches, "
                                                       f"{chunks} chunks")
            else:
                check(launches["fleet_fit"] == 0 and all(launches[k] > 0 for k in launches if k != "fleet_fit"),
                      f"{name} launched the LSTM training kernels: {launches}")
        out[name] = {
            "rows": int(X.shape[0]), "tags": int(X.shape[1]), "epochs": epochs, "stopped_at": RESUME_STOP,
            "checkpoint_every": RESUME_EVERY, "chunks": chunks, "launches": launches,
            "first_fit_seconds": first_fit_seconds, "uninterrupted_fit_seconds": fit_seconds,
            "stopped_and_resumed_seconds": resume_seconds,
            "save_seconds": seconds.get("save_checkpoint", []), "load_seconds": seconds.get("load_checkpoint", []),
            "checkpoint_bytes": payload, "bitwise": True,
        }
    return out


def phase_fleet_api():
    """The generic fleet API on the card: ``fleet_stage`` →
    ``fleet_dispatch`` → ``collect`` of TRAIN_SHAPE's machines with ragged
    lengths (machine i has 576 - (i mod FLEET_API_SPREAD) rows, stacked by
    ``stack_rows``, the padding weighted 0), then ``fleet_apply`` of the
    fitted params over the stacked rows; launches (set to 0 just before):
    one ``fleet_fit``, one ``fleet_apply``.  The same calls again with the
    kernels' plain versions on the card, held to the kernels'."""
    from gordo_tpu_torch import parallel
    from gordo_tpu_torch.kernels import fleet_apply as fa
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_init as fi
    from gordo_tpu_torch.parallel import fleet
    from gordo_tpu_torch.registry import lookup_factory
    from gordo_tpu_torch.train.fit import TrainConfig

    machines, rows, tags = TRAIN_SHAPE
    device = None if DEVICE == "cuda" else DEVICE
    full = bench_fleet(np.random.default_rng(SEED + 23), machines, rows, tags)
    lengths = ragged_lengths(rows, machines, FLEET_API_SPREAD)
    X, w, got_lengths = parallel.stack_rows([full[i, :n] for i, n in enumerate(lengths)])
    check(np.array_equal(got_lengths, lengths), "stack_rows lengths")
    module = lookup_factory("AutoEncoder", "feedforward_hourglass")(n_features=tags, n_features_out=tags)
    cfg = TrainConfig()
    ff.launches = fa.launches = fi.launches = 0
    t0 = time.perf_counter()
    staged = parallel.fleet_stage(module, X, X, w, cfg, device=device)
    if DEVICE == "cuda":  # the draws' launch has finished: stage's time is its own
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    result = parallel.fleet_dispatch(module, staged, cfg)
    t2 = time.perf_counter()
    result.collect()
    t3 = time.perf_counter()
    pred = parallel.fleet_apply(module, result.params, X, device=device)
    pred_host = pred.cpu().numpy()
    t4 = time.perf_counter()
    launches = {"fleet_fit": ff.launches, "fleet_apply": fa.launches, "fleet_init": fi.launches}
    if DEVICE == "cuda":
        check(launches == {"fleet_fit": 1, "fleet_apply": 1, "fleet_init": 1}, f"fleet API launches {launches}")
    check(result.history.shape == (machines, cfg.epochs) and bool(np.isfinite(result.history).all()),
          "fleet_fit history")
    check(pred_host.shape == (machines, rows, tags) and bool(np.isfinite(pred_host).all()), "fleet_apply output")
    # the same calls through the plain versions on the card
    saved = fleet._fleet_fit_kernel, fleet._fleet_apply_kernel, fleet._fleet_init_kernel
    fleet._fleet_fit_kernel, fleet._fleet_apply_kernel, fleet._fleet_init_kernel = (
        ff.fleet_fit_plain, fa.fleet_apply_plain, fi.fleet_init_reference)
    try:
        plain = parallel.fleet_fit(module, X, X, w, cfg, device=device)
        plain_pred = parallel.fleet_apply(module, result.params, X, device=device)
    finally:
        fleet._fleet_fit_kernel, fleet._fleet_apply_kernel, fleet._fleet_init_kernel = saved
    worst = {"params": 0.0, "history": norm_err(torch.from_numpy(plain.history), torch.from_numpy(result.history))}
    for (W, b), (Wp, bp) in zip(result.params, plain.params):
        worst["params"] = max(worst["params"], norm_err(Wp, W), norm_err(bp, b) if bool(bp.any()) else 0.0)
    worst["apply"] = norm_err(plain_pred, pred)
    tol = {"params": TRAIN_TOLERANCE["fleet_fit"], "history": TRAIN_TOLERANCE["fleet_fit_history"],
           "apply": TOLERANCE}
    _check_worst(worst, tol, "fleet API against its plain versions")
    seconds = t3 - t0
    return {
        "machines": machines, "rows": [int(lengths.min()), int(lengths.max())], "tags": tags,
        "epochs": cfg.epochs, "stage_seconds": t1 - t0, "dispatch_seconds": t2 - t1,
        "collect_seconds": t3 - t2, "apply_seconds": t4 - t3, "fit_seconds": seconds,
        "models_per_hour": machines / seconds * 3600, "launches": launches,
        "plain_max_norm_err": worst, "tolerance": tol,
    }


# -- fleet init (K11) and build-project ----------------------------------

#: K11's normals against their plain version and the JAX package's, in
#: ulp of float32 (log1pf on the card against XLA's own log1p and
#: PyTorch's; tests/test_torch_fleet_init.py measures the same bound
#: against JAX on the CPU); keys, bits and permutations are bit for bit
FLEET_INIT_ULP = 4
#: an orthogonal kernel_h after its QR (torch.linalg.qr of the two sets of
#: normals), r12
FLEET_INIT_QR_TOLERANCE = 1e-5
#: fleet_stage's seeds of TRAIN_SHAPE's bucket; one seed of the bench's
#: LSTM; one permutation of a year of 10-minute rows (a cluster's sort)
FLEET_INIT_YEAR = 52_560
#: the cases timed (the others are the paths' edges, held but not timed)
FLEET_INIT_TIMED = ("hourglass_bucket", "lstm_hourglass", "year_permutation")
#: the build-project phase: TRAIN_SHAPE's project (RandomDataset, the
#: default model and TrainConfig), its bulk request's rows per machine
#: and the machines held to the plain scorer on the CPU
BUILD_PROJECT_REQUEST_ROWS = 64
BUILD_PROJECT_CHECKED = 4


def _ulp_err(ref: torch.Tensor, got: torch.Tensor) -> int:
    """Max distance in float32 ulps (same-sign values; 0 for equal bits)."""
    a = ref.contiguous().view(torch.int32).to(torch.int64)
    b = got.contiguous().view(torch.int32).to(torch.int64)
    a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int((a - b).abs().max()) if a.numel() else 0


def _fleet_init_cases():
    """(name, seeds, leaves, n_totals, epochs) of the K11 check: every
    drawn leaf also as its raw bits (held bit for bit)."""
    from gordo_tpu_torch.kernels import fleet_init as fi
    from gordo_tpu_torch.kernels.fleet_fit import geometry
    from gordo_tpu_torch.parallel.fleet import chain_leaves, lstm_chain_of
    from gordo_tpu_torch.registry import lookup_factory
    from gordo_tpu_torch.train.fit import TrainConfig
    from gordo_tpu_torch.train.lstm_fit import window_fit
    from gordo_tpu_torch.train.cv import build_splitter

    machines, rows, tags = TRAIN_SHAPE
    cfg = TrainConfig()
    fit_rows = [tr for tr, _ in build_splitter(None).split(np.empty((rows, 1)))] + [np.arange(rows)]
    n_totals = sorted({geometry(r, cfg.batch_size).n_total for r in fit_rows})

    def with_raw(leaves):
        return leaves + [fi.Leaf(leaf.path, leaf.shape, fi.RAW) for leaf in leaves]

    _, lrows, ltags = LSTM_TRAIN_SHAPE
    lstm_kwargs = dict(LSTM_TRAIN_MODEL["gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector"]["base_estimator"][
        "gordo_tpu.pipeline.Pipeline"]["steps"][1]["gordo_tpu.models.estimator.LSTMAutoEncoder"])
    module = lookup_factory("LSTMAutoEncoder", lstm_kwargs["kind"])(
        n_features=ltags, n_features_out=ltags, lookback_window=LOOKBACK)
    ldims = lstm_chain_of(module)[0]
    lstm_total = window_fit(np.arange(lrows), lstm_kwargs["batch_size"], LOOKBACK - 1).n_total
    edges = [1, 2, 32, 33, fi.BLOCK_MIN_KEYS // 2, fi.BLOCK_MIN_KEYS // 2 + 1, fi.WARP_KEYS, fi.WARP_KEYS + 1, 1625, 1626,
             fi.BLOCK_KEYS, fi.BLOCK_KEYS + 1, FLEET_INIT_YEAR, fi.MAX_ITEMS // 2 + 1]
    return [
        ("hourglass_bucket", np.arange(machines), with_raw(chain_leaves(hourglass(tags))), n_totals,
         cfg.epochs),
        ("lstm_hourglass", np.array([SEED % 2 ** 32]), with_raw(chain_leaves(ldims)), [lstm_total],
         lstm_kwargs["epochs"]),
        ("year_permutation", np.array([7]), [], [FLEET_INIT_YEAR], 1),
        # every path's edges in one launch of a few permutations (3 seeds x
        # 3 epochs: a block each from 256 keys, a cluster of 8 blocks of
        # 16,384 keys for the longest), then the warp path's with 1,025
        # permutations (its last block holds one of its eight)
        ("edges", np.array([0, 7, 2 ** 32 - 1]), with_raw(chain_leaves([4, 3, 4])), edges, 3),
        ("edges_warp", np.arange(205), [], [1, 2, 33, fi.BLOCK_MIN_KEYS // 2, fi.BLOCK_MIN_KEYS // 2 + 1,
                                            fi.WARP_KEYS], 5),
        # the same beside a cluster job (sixteen a block of 512)
        ("edges_cluster_launch", np.arange(205), [], [33, fi.WARP_KEYS // 2, fi.WARP_KEYS, fi.BLOCK_KEYS + 1], 5),
        ("longest", np.array([11]), [], [fi.MAX_ITEMS], 1),
    ], ldims


def phase_fleet_init_kernel_check():
    """K11 against its plain version on the card: the raw bits (keys,
    fold-ins) and the permutations bit for bit, the lecun-normal and
    normal draws within FLEET_INIT_ULP, the orthogonal kernels after their
    QR within FLEET_INIT_QR_TOLERANCE, at the bench's bucket, an LSTM
    seed, a year's permutation, every sort path's edge lengths (3 seeds x
    3 epochs; the warp path's at 205 x 5) and the longest permutation; a
    longer one raises.  The
    kernel, its plain version and ``torch.randperm`` over the same
    permutations timed at FLEET_INIT_TIMED, and the bound."""
    from gordo_tpu_torch.kernels import fleet_init as fi
    from gordo_tpu_torch.parallel.fleet import _orthogonal

    cases, ldims = _fleet_init_cases()
    out = {}
    try:
        fi.fleet_init(torch.tensor([1], device=DEVICE), [], [fi.MAX_ITEMS + 1], 1)
        check(False, f"a permutation of {fi.MAX_ITEMS + 1} items raises")
    except NotImplementedError:
        pass
    for name, seeds_np, leaves, n_totals, epochs in cases:
        seeds = torch.from_numpy(seeds_np.astype(np.int64)).to(DEVICE)
        got_v, got_p = fi.fleet_init(seeds, leaves, n_totals, epochs)
        ref_v, ref_p = fi.fleet_init_reference(seeds, leaves, n_totals, epochs)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        entry = {"seeds": int(seeds.shape[0]), "leaves": len(leaves), "n_totals": list(n_totals),
                 "epochs": epochs, "values": int(got_v.shape[1])}
        for n, g, r in zip(n_totals, got_p, ref_p):
            check(bool(torch.equal(g, r)), f"fleet_init {name}: permutations of {n} bit for bit")
            check(bool((torch.sort(g, dim=-1).values
                        == torch.arange(n, device=g.device, dtype=g.dtype)).all()),
                  f"fleet_init {name}: each row of {n} is a permutation")
        ulp, abs_err, off = 0, 0.0, 0
        normals = {}
        for leaf in leaves:
            g, r = (v[:, off: off + leaf.size] for v in (got_v, ref_v))
            off += leaf.size
            if leaf.kind == fi.RAW:
                check(bool(torch.equal(g.view(torch.int32), r.view(torch.int32))),
                      f"fleet_init {name}: raw bits of {'/'.join(leaf.path)} bit for bit")
                continue
            ulp = max(ulp, _ulp_err(r, g))
            abs_err = max(abs_err, float((r.double() - g.double()).abs().max()))
            if leaf.kind == fi.NORMAL:
                normals.setdefault(leaf.path[0], []).append(
                    (g.reshape(-1, *leaf.shape), r.reshape(-1, *leaf.shape)))
        check(ulp <= FLEET_INIT_ULP, f"fleet_init {name}: draws within {FLEET_INIT_ULP} ulp, got {ulp}")
        qr = 0.0
        for gates in normals.values():
            q_got = _orthogonal(torch.stack([g for g, _ in gates], 1))
            q_ref = _orthogonal(torch.stack([r for _, r in gates], 1))
            qr = max(qr, norm_err(q_ref, q_got))
        check(qr <= FLEET_INIT_QR_TOLERANCE, f"fleet_init {name}: kernel_h after QR {qr}")
        entry.update({"max_ulp": ulp, "max_abs_err": abs_err, "kernel_h_max_norm_err": qr})
        entry["paths"] = [("warp", "block", "cluster")[fi.path_of(n, len(seeds_np) * epochs)] for n in n_totals]
        if DEVICE == "cuda" and name in FLEET_INIT_TIMED:  # on the path's work: the raw leaves are the check's
            path_leaves = [leaf for leaf in leaves if leaf.kind != fi.RAW]
            run = lambda: fi.fleet_init(seeds, path_leaves, n_totals, epochs)  # noqa: E731
            entry["ms"], entry["host_ms"] = time_ms(run, 20)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(
                lambda: fi.fleet_init_reference(seeds, path_leaves, n_totals, epochs), 2)
            d = int(seeds.shape[0])

            def randperms():
                for n in n_totals:
                    for _ in range(d * epochs):
                        torch.randperm(n, device=DEVICE)
            entry["library_ms"], entry["library_host_ms"] = time_calls_ms(randperms, 1)
            drawn = sum(leaf.size for leaf in path_leaves)
            entry.update(bound(fi.bound_bytes(d, drawn, n_totals, epochs),
                               fi.bound_ops(d, drawn, n_totals, epochs)))
        out[name] = entry
        del got_v, got_p, ref_v, ref_p
    out["tolerance"] = {"ulp": FLEET_INIT_ULP, "kernel_h": FLEET_INIT_QR_TOLERANCE}
    out["lstm_dims"] = list(ldims)
    emit({"phase": "fleet_init_kernel_check", **out})
    return out


def phase_build_project():
    """``build_project`` on the card, as ``python -m gordo_tpu_torch.cli
    build-project`` runs it: TRAIN_SHAPE's RandomDataset project (the
    default model, TrainConfig and TimeSeriesSplit(3); a YAML of
    ``gordo_tpu_torch.bench.project_config``) built into a model directory
    with a registry (seconds, models/h, the stage split, launches of every
    kernel set to 0 just before), then built again (every machine a cache
    hit, no launch), then served over HTTP (the server of ``run-server``):
    one bulk request of every machine, one ``fleet_score`` launch, held to
    the plain scorer on the CPU for a few machines."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.bench import project_config
    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.dataset.base import GordoBaseDataset
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.serve.server import ModelCollection, make_server
    from gordo_tpu_torch.workflow.config import NormalizedConfig

    machines, rows, tags = TRAIN_SHAPE
    device = None if DEVICE == "cuda" else DEVICE
    counters = _ff_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_project_") as tmp:
        out_dir, registry = os.path.join(tmp, "models"), os.path.join(tmp, "registry")
        t0 = time.perf_counter()
        config = NormalizedConfig.from_source(project_config(machines, tags, rows), "smoke")
        config_seconds = time.perf_counter() - t0
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        result = build_project(config.machines, out_dir, model_register_dir=registry, device=device)
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        check(not result.failed and len(result.fleet_built) == machines,
              f"build_project built {len(result.fleet_built)} of {machines}: {result.failed}")
        if DEVICE == "cuda":
            want = {"fleet_fit": 1, "scaler_stats": 2, "scaler_stats_standard": 0, "scaler_quantiles": 0,
                    "fleet_score": 1, "cv_epilogue": 1, "fleet_init": 1}
            check(launches == want, f"build_project launches {launches}, expected {want}")
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t1 = time.perf_counter()
        again = build_project(config.machines, out_dir, model_register_dir=registry, device=device)
        cached_seconds = time.perf_counter() - t1
        cached_launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        check(len(again.cached) == machines and not again.fleet_built and not again.single_built,
              f"the second build hits the cache: {again.summary()}")
        check(not any(cached_launches.values()), f"a cached build launches nothing: {cached_launches}")
        written = sorted(n for n in os.listdir(out_dir) if serializer.is_artifact_dir(os.path.join(out_dir, n)))
        check(len(written) == machines, f"{len(written)} artifacts written")

        names = [m.name for m in config.machines]
        data = {m.name: np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)
                for m in config.machines}
        collection = ModelCollection.from_directory(out_dir, project="smoke", device=device)
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        fs.launches = 0
        try:
            payload = {"X": {n: data[n][:BUILD_PROJECT_REQUEST_ROWS].tolist() for n in names}}
            t2 = time.perf_counter()
            status, body = _request(
                f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/smoke/_bulk/anomaly/prediction",
                payload,
            )
            request_seconds = time.perf_counter() - t2
            serve_launches = fs.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
        check(status == 200, f"bulk request on the built project: {status}")
        if DEVICE == "cuda":
            check(serve_launches == 1, f"bulk request launched fleet_score {serve_launches} times")
        served = {}
        for n in names[:BUILD_PROJECT_CHECKED]:
            ref = serializer.load(os.path.join(out_dir, n)).anomaly(
                data[n][:BUILD_PROJECT_REQUEST_ROWS], device="cpu")
            for k in OUTPUTS:
                got = np.asarray(body["data"][n][k], np.float64)
                check(got.shape == np.shape(ref[k]) and np.isfinite(got).all(), f"served {k} of {n}")
                err = float(np.abs(got - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
                served[k] = max(served.get(k, 0.0), err)
        check(all(v <= TOLERANCE for v in served.values()), f"served project within {TOLERANCE}: {served}")
        meta = serializer.load_metadata(os.path.join(out_dir, names[0]))
        check(meta.get("cache_key") and meta["model"].get("fleet_built") is True, "artifact metadata")
    stages = dict(result.stage_seconds)
    stages["config"] += config_seconds
    seconds = result.seconds + config_seconds
    return {
        "machines": machines, "rows": rows, "tags": tags, "build_seconds": seconds,
        "models_per_hour": machines / seconds * 3600, "stage_seconds": stages,
        "device_idle_seconds": result.device_idle_seconds, "peak_loaded": result.peak_loaded,
        "artifacts_written": len(written), "launches": launches,
        "cached_build_seconds": cached_seconds, "cached": len(again.cached),
        "cached_launches": cached_launches, "served_machines": len(names),
        "request_rows": BUILD_PROJECT_REQUEST_ROWS, "request_seconds": request_seconds,
        "serve_launches": serve_launches, "served_max_norm_err": served,
    }


SCALER_YEAR = 52_560
#: the Standard and Robust statistics against their plain versions on the
#: card, max |kernel - plain| / max |plain| per output: the Standard sums
#: run in XLA:CPU's window order on both sides (expected 0); Robust's
#: selection is exact, its interpolation the plain version's FMA (taken in
#: float64 there) and its chain prefix the same separate roundings
#: (expected 0)
SCALER_TOLERANCE = {"standard": 1e-5, "robust": 1e-6, "minmax": TRAIN_TOLERANCE["scaler_stats"]}
#: ``DiffBasedAnomalyDetector(scaler=StandardScaler,
#: base_estimator=Pipeline[RobustScaler, AutoEncoder])``, the JAX package's paths
SCALER_MODEL = {
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "scaler": "gordo_tpu.ops.scalers.StandardScaler",
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            "gordo_tpu.ops.scalers.RobustScaler",
            {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}},
        ]}},
    }
}
#: the scaler build held to its plain program on the card: the fits'
#: tolerance, the Robust step's stats as its kernel's, the Standard
#: detector scaler's as its
SCALER_BUILD_TOLERANCE = {"params": TRAIN_TOLERANCE["fleet_fit"], "history": TRAIN_TOLERANCE["fleet_fit_history"],
                          "scaler": SCALER_TOLERANCE["robust"], "detector": SCALER_TOLERANCE["standard"],
                          **BUILD_TOLERANCE}
#: machines of the scaler build served over HTTP (one bulk request of 64
#: rows a machine), and machines and rows streamed
SCALER_SERVED = 64
SCALER_REQUEST_ROWS = 64
SCALER_STREAM = {"machines": 4, "rows": 24}
_STAT_KEYS = {"minmax": ("scale", "offset"), "standard": ("mean", "std"), "robust": ("center", "scale")}


def stat_bound(machines: int, rows: int, tags: int, lists, prefix_steps: int, ops_per_visit: int):
    """Least time for one stats launch: the rows read once, the row lists'
    indices, each prefix step's two (M, G, F) stats and the two outputs;
    per visited value ``ops_per_visit`` operations and two per prefix step
    (per pass)."""
    g = len(lists)
    visits = machines * sum(len(r) for r in lists) * tags
    nbytes = 4 * (machines * rows * tags + sum(len(r) for r in lists)
                  + 2 * (prefix_steps + 1) * machines * g * tags)
    return bound(nbytes, visits * (ops_per_visit + 2 * prefix_steps))


def phase_scaler_kernel_check():
    """K3's Standard statistic (``scaler_stats``) and Robust statistic
    (``scaler_quantiles``) against their plain versions on the card: at
    TRAIN_SHAPE over the 4 row lists of TimeSeriesSplit(3) and the full
    series, on NaN-padded ragged rows (449–576), as the second step of two
    chains (Standard then MinMax; MinMax to (1, -1), a negative scale, then
    Robust), each step fed the kernel's stats of the step before, and
    Robust on one year of 10-minute rows (52,560) × 10 tags; the Standard
    statistic also after that MinMax step (its prefix instantiation), at
    128 tags (column groups of 13 and 11) and on the year (a cluster per
    column group).  Robust past one sort chunk (the cluster sort) on the
    year NaN-padded and after a MinMax (1, -1) step; both statistics at
    QS_MAX_ROWS (57,344) over uneven row lists; Robust's selection at a
    year and its sort at TRAIN_SHAPE, timed beside the launcher's choice.
    The MinMax statistic by each path of its plan: nested ranges over the
    NaN-padded rows, index lists at TRAIN_SHAPE and the Standard-prefixed
    chains (the list path), the year (plain and NaN-padded) and the uneven
    QS_MAX_ROWS lists (the split path).  Every entry counts its values that
    are not the plain version's bit for bit (``differing``, which must be
    0: the Standard sums run in XLA's window order on both sides, Robust's
    order statistics are exact, a min and a max take any order) and hashes
    its outputs.  Times, bounds, and the library call:
    ``torch.nanquantile`` (one call a row list) for Robust; no one PyTorch
    call takes a NaN-aware std, nor MinMax's scale and offset
    (``torch.aminmax`` propagates NaN)."""
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.train.cv import TimeSeriesSplit

    machines, rows, tags = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 23)
    folds = list(TimeSeriesSplit(3).split(np.empty((rows, 1))))
    row_lists = [tr for tr, _ in folds] + [np.arange(rows)]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    X = bench_fleet(rng, machines, rows, tags)
    Xn = X.copy()
    for i, n in enumerate(ragged_lengths(rows, machines, RAGGED_SPREAD)):
        Xn[i, n:] = np.nan
    X, Xn = put(X), put(Xn)
    year = put(bench_fleet(rng, 1, SCALER_YEAR, tags))
    q = torch.from_numpy(sq.fractions((25.0, 75.0))).to(DEVICE)
    entries = {}

    def hold(name, stat, run, plain, bound_info, library=None, reps=20, plain_reps=5, path=None):
        got, ref = run(), plain()
        errs, worst = {}, 0.0
        for key, r, g in zip(_STAT_KEYS[stat], ref, got):
            check(bool(g.isfinite().all()), f"{name} {key} is finite")
            errs[key] = norm_err(r, g)
            worst = max(worst, float((r.double() - g.double()).abs().max()))
        tol = SCALER_TOLERANCE[stat]
        check(all(e <= tol for e in errs.values()), f"{name} within {tol}: {errs}")
        entry = {"stat": stat, "max_norm_err": errs, "max_abs_err": worst, "tolerance": tol, **bound_info}
        entry["differing"] = sum(differing(r, g) for r, g in zip(ref, got))
        check(entry["differing"] == 0, f"{name}: bit for bit its plain version ({entry['differing']} differ)")
        entry["hashes"] = {key: output_hash(g) for key, g in zip(_STAT_KEYS[stat], got)}
        if path is not None:
            entry["path"] = path
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, reps)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, plain_reps)
            entry["library_ms"] = None if library is None else time_calls_ms(library, plain_reps)[0]
        entries[name] = entry
        return got

    def nanquantile(x, lists):
        # the row lists are prefixes of the series: one call a row list
        return lambda: [torch.nanquantile(x[:, : len(r)], q, dim=1) for r in lists]

    def robust_through(sort_above, x, lists):
        # Robust with the launcher's switch from the selection to the sort
        # at another length (0: always the sort)
        saved = sq.ROBUST_SORT_ABOVE
        sq.ROBUST_SORT_ABOVE = sort_above
        try:
            return sq.scaler_quantiles(x, lists)
        finally:
            sq.ROBUST_SORT_ABOVE = saved

    full = stat_bound(machines, rows, tags, row_lists, 0, 4)
    mean, std = hold("standard", "standard", lambda: ss.scaler_stats(X, row_lists, stat="standard"),
                     lambda: ss.scaler_stats_plain(X, row_lists, stat="standard"), full)
    hold("robust", "robust", lambda: sq.scaler_quantiles(X, row_lists),
         lambda: sq.scaler_quantiles_plain(X, row_lists), stat_bound(machines, rows, tags, row_lists, 0, 1),
         library=nanquantile(X, row_lists))
    hold("standard_nan_padded", "standard", lambda: ss.scaler_stats(Xn, row_lists, stat="standard"),
         lambda: ss.scaler_stats_plain(Xn, row_lists, stat="standard"), full)
    hold("robust_nan_padded", "robust", lambda: sq.scaler_quantiles(Xn, row_lists),
         lambda: sq.scaler_quantiles_plain(Xn, row_lists), stat_bound(machines, rows, tags, row_lists, 0, 1),
         library=nanquantile(Xn, row_lists))
    # chains: the second step's stats taken through the first step's map
    std_prefix = [(ss.CENTER, mean, std)]
    hold("chain_standard_minmax", "minmax", lambda: ss.scaler_stats(X, row_lists, prefix=std_prefix),
         lambda: ss.scaler_stats_plain(X, row_lists, prefix=std_prefix),
         stat_bound(machines, rows, tags, row_lists, 1, 2), path=plan_path(ss, X.shape, row_lists, 1))
    # the fleet build's form: the offset a - lo * scale one FMA, as
    # fleet.exact's fusion computes it, bit for bit its plain version
    hold("chain_standard_minmax_fused", "minmax",
         lambda: ss.scaler_stats(X, row_lists, (1.0, -1.0), prefix=std_prefix, offset_fma=True),
         lambda: ss.scaler_stats_plain(X, row_lists, (1.0, -1.0), prefix=std_prefix, offset_fma=True),
         stat_bound(machines, rows, tags, row_lists, 1, 2), path=plan_path(ss, X.shape, row_lists, 1))
    reverse = ss.scaler_stats(X, row_lists, (1.0, -1.0))
    check(bool((reverse[0] < 0).all()), "a MinMax step to (1, -1) has a negative scale")
    mm_prefix = [(ss.AFFINE, *reverse)]
    hold("chain_minmax_robust", "robust", lambda: sq.scaler_quantiles(X, row_lists, prefix=mm_prefix),
         lambda: sq.scaler_quantiles_plain(X, row_lists, prefix=mm_prefix),
         stat_bound(machines, rows, tags, row_lists, 1, 1))
    hold("chain_minmax_standard", "standard", lambda: ss.scaler_stats(X, row_lists, stat="standard", prefix=mm_prefix),
         lambda: ss.scaler_stats_plain(X, row_lists, stat="standard", prefix=mm_prefix),
         stat_bound(machines, rows, tags, row_lists, 1, 4))
    # MinMax by each of its plan's paths: the nested ranges of the build
    # over NaN-padded rows (the nested path), index lists at TRAIN_SHAPE
    # (the list path; the Standard-prefixed chains above too), and past
    # one block's rows a year and uneven index lists below (the split path)
    hold("minmax_nan_padded", "minmax", lambda: ss.scaler_stats(Xn, row_lists, offset_fma=True),
         lambda: ss.scaler_stats_plain(Xn, row_lists, offset_fma=True), stat_bound(machines, rows, tags, row_lists, 0, 2),
         path=plan_path(ss, Xn.shape, row_lists))
    picked = [np.sort(rng.permutation(rows)[: rows // 2 + 12]), np.arange(rows // 6, 2 * rows // 3), np.arange(rows)]
    hold("minmax_index_lists", "minmax", lambda: ss.scaler_stats(Xn, picked), lambda: ss.scaler_stats_plain(Xn, picked),
         stat_bound(machines, rows, tags, picked, 0, 2), path=plan_path(ss, Xn.shape, picked))
    wide = put(bench_fleet(rng, 64, rows, 128))
    hold("standard_128_tags", "standard", lambda: ss.scaler_stats(wide, row_lists, stat="standard"),
         lambda: ss.scaler_stats_plain(wide, row_lists, stat="standard"), stat_bound(64, rows, 128, row_lists, 0, 4))
    del wide
    whole = [np.arange(SCALER_YEAR)]
    hold("standard_year", "standard", lambda: ss.scaler_stats(year, whole, stat="standard"),
         lambda: ss.scaler_stats_plain(year, whole, stat="standard"), stat_bound(1, SCALER_YEAR, tags, whole, 0, 4),
         reps=5, plain_reps=3)
    hold("minmax_year", "minmax", lambda: ss.scaler_stats(year, whole), lambda: ss.scaler_stats_plain(year, whole),
         stat_bound(1, SCALER_YEAR, tags, whole, 0, 2), reps=20, plain_reps=3, path=plan_path(ss, year.shape, whole))
    hold("robust_year", "robust", lambda: sq.scaler_quantiles(year, whole),
         lambda: sq.scaler_quantiles_plain(year, whole), stat_bound(1, SCALER_YEAR, tags, whole, 0, 1),
         library=nanquantile(year, whole), reps=5, plain_reps=3)
    # Robust past one sort chunk sorts each column over a cluster: the
    # year NaN-padded (a pad-up group's tail of NaN rows), after a
    # MinMax step to (1, -1) (its keys reversed), and at QS_MAX_ROWS over
    # uneven row lists, one of them not a prefix; the selection at a year
    # and the sort at TRAIN_SHAPE beside the launcher's choice
    year_pad = year.clone()
    year_pad[:, SCALER_YEAR - SCALER_YEAR // 13:] = float("nan")
    hold("robust_year_nan_padded", "robust", lambda: sq.scaler_quantiles(year_pad, whole),
         lambda: sq.scaler_quantiles_plain(year_pad, whole), stat_bound(1, SCALER_YEAR, tags, whole, 0, 1),
         library=nanquantile(year_pad, whole), reps=5, plain_reps=3)
    hold("minmax_year_nan_padded", "minmax", lambda: ss.scaler_stats(year_pad, whole, offset_fma=True),
         lambda: ss.scaler_stats_plain(year_pad, whole, offset_fma=True), stat_bound(1, SCALER_YEAR, tags, whole, 0, 2),
         reps=20, plain_reps=3, path=plan_path(ss, year_pad.shape, whole))
    year_flip = [(ss.AFFINE, *ss.scaler_stats(year, whole, (1.0, -1.0)))]
    hold("robust_year_minmax", "robust", lambda: sq.scaler_quantiles(year, whole, prefix=year_flip),
         lambda: sq.scaler_quantiles_plain(year, whole, prefix=year_flip),
         stat_bound(1, SCALER_YEAR, tags, whole, 1, 1), reps=5, plain_reps=3)
    hold("robust_year_selection", "robust", lambda: robust_through(sq.MAX_ROWS, year, whole),
         lambda: sq.scaler_quantiles_plain(year, whole), stat_bound(1, SCALER_YEAR, tags, whole, 0, 1),
         reps=5, plain_reps=3)
    hold("robust_sorted", "robust", lambda: robust_through(0, X, row_lists),
         lambda: sq.scaler_quantiles_plain(X, row_lists), stat_bound(machines, rows, tags, row_lists, 0, 1))
    longest = sq.MAX_ROWS
    long_x = put(bench_fleet(rng, 2, longest, tags))
    uneven = [np.arange(longest), np.arange(31_337), np.sort(rng.permutation(longest)[:45_001]),
              np.arange(8_193)]
    hold("standard_max_rows", "standard", lambda: ss.scaler_stats(long_x, uneven, stat="standard"),
         lambda: ss.scaler_stats_plain(long_x, uneven, stat="standard"),
         stat_bound(2, longest, tags, uneven, 0, 4), reps=5, plain_reps=2)
    hold("minmax_max_rows", "minmax", lambda: ss.scaler_stats(long_x, uneven), lambda: ss.scaler_stats_plain(long_x, uneven),
         stat_bound(2, longest, tags, uneven, 0, 2), reps=20, plain_reps=2, path=plan_path(ss, long_x.shape, uneven))
    hold("robust_max_rows", "robust", lambda: sq.scaler_quantiles(long_x, uneven),
         lambda: sq.scaler_quantiles_plain(long_x, uneven), stat_bound(2, longest, tags, uneven, 0, 1),
         reps=5, plain_reps=2)
    del long_x, year_pad
    emit({"phase": "scaler_kernel_check", "shape": list(TRAIN_SHAPE), "year_rows": SCALER_YEAR,
          "kernels": entries})
    del X, Xn, year
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def phase_scaler_build():
    """``FleetDiffBuilder.build`` of TRAIN_SHAPE's fleet as
    ``SCALER_MODEL`` detectors (a Robust pipeline step, a Standard detector
    scaler), built twice, the second counted (seconds, models/h, launches
    of every kernel set to 0 just before: one ``scaler_quantiles`` and one
    Standard ``scaler_stats``), held per machine to the same program
    through the plain versions on the card (each step's own stats, params,
    history, thresholds, CV scores); then SCALER_SERVED of the detectors
    dumped and served over HTTP, one bulk request through one
    ``fleet_score`` launch, held to the plain scorer on the CPU; and
    SCALER_STREAM rows streamed into a few of them (one ``stream_step``
    a row), every verdict the request path's bit for bit."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import stream_step as sk
    from gordo_tpu_torch.ops.scalers import RobustScaler, StandardScaler
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.serve.server import ModelCollection, make_server
    from gordo_tpu_torch.serve.stream import reference_verdict

    machines, rows, tags = TRAIN_SHAPE
    Xs = list(bench_fleet(np.random.default_rng(SEED + 29), machines, rows, tags))
    spec = analyze_definition(from_definition(SCALER_MODEL))
    check(spec is not None, "the scaler detector is fleetable")
    device = None if DEVICE == "cuda" else DEVICE
    builder = FleetDiffBuilder(spec, device=DEVICE)
    detectors, info, pending = _build_counted(spec, builder, Xs, _ff_counters())
    if DEVICE == "cuda":
        check(info["launches"]["scaler_quantiles"] == 1 and info["launches"]["scaler_stats_standard"] == 1,
              f"one Robust and one Standard stats launch: {info['launches']}")
    for det in detectors:
        step = det.base_estimator.steps[0][1]
        check(isinstance(step, RobustScaler) and sorted(step.stats_) == ["center", "scale"]
              and isinstance(det.scaler, StandardScaler) and sorted(det.scaler.stats_) == ["mean", "std"],
              "each step's own stats under the reference's keys")
        check(bool(np.isfinite(det.feature_thresholds_).all()), "finite thresholds")
    worst, admitted = _hold_to_plain_program(spec, builder, pending, detectors, SCALER_BUILD_TOLERANCE)
    _check_worst(worst, SCALER_BUILD_TOLERANCE, "scaler build against its plain program")
    info.update(vs_plain_max_norm_err=worst, vs_plain_held_to_one_ulp_movement=admitted)

    names = [f"scaler-{i:03d}" for i in range(SCALER_SERVED)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scalers_") as tmp:
        for i, name in enumerate(names):
            serializer.dump(detectors[i], os.path.join(tmp, name),
                            metadata={"dataset": {"tag_list": [f"{name}-t{j}" for j in range(tags)]}})
        collection = ModelCollection.from_directory(tmp, project="scalers", device=device)
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        fs.launches = 0
        try:
            payload = {"X": {n: Xs[i][-SCALER_REQUEST_ROWS:].tolist() for i, n in enumerate(names)}}
            t0 = time.perf_counter()
            status, body = _request(
                f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/scalers/_bulk/anomaly/prediction", payload)
            request_seconds = time.perf_counter() - t0
            serve_launches = fs.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
        check(status == 200, f"bulk request of the scaler detectors: {status}")
        if DEVICE == "cuda":
            check(serve_launches == 1, f"bulk request launched fleet_score {serve_launches} times")
        served = {}
        for i, n in enumerate(names[:CPU_MACHINES]):
            ref = detectors[i].anomaly(Xs[i][-SCALER_REQUEST_ROWS:], device="cpu")
            for k in OUTPUTS:
                got = np.asarray(body["data"][n][k], np.float64)
                check(got.shape == np.shape(ref[k]) and np.isfinite(got).all(), f"served {k} of {n}")
                served[k] = max(served.get(k, 0.0), float(np.abs(got - ref[k]).max() / np.abs(ref[k]).max()))
        check(all(v <= TOLERANCE for v in served.values()), f"served scaler detectors within {TOLERANCE}: {served}")

        # a few rows streamed into a few of them: every verdict the request
        # path's bit for bit
        hub = collection.stream_hub
        streamed = names[:SCALER_STREAM["machines"]]
        sk.launches = 0
        verdicts = {n: {} for n in streamed}
        for r in range(SCALER_STREAM["rows"]):
            for i, n in enumerate(streamed):
                for ev in hub.ingest_rows(n, collection.get(n).scorer, Xs[i][r], dtype=collection.serve_dtype):
                    if ev["type"] == "verdict":
                        verdicts[n][ev["data"]["step"]] = ev["data"]
        stream_launches = sk.launches
        if DEVICE == "cuda":
            want = SCALER_STREAM["machines"] * SCALER_STREAM["rows"]
            check(stream_launches == want, f"stream_step launched {stream_launches} times, expected {want}")
        checked = 0
        for i, n in enumerate(streamed):
            H = hub.streams[n].state_rows
            for t in range(H, SCALER_STREAM["rows"] + 1):
                ref = reference_verdict(collection.get(n).scorer, Xs[i][t - H:t])
                v = verdicts[n][t]
                got = {"tag-anomaly-scores": v["tag-anomaly-scores"], "total-anomaly-score": v["total-anomaly-score"],
                       "anomaly-confidence": v["anomaly-confidence"]}
                for k in ref:
                    check(np.asarray(got[k], np.float32).tobytes() == np.asarray(ref[k], np.float32).tobytes(),
                          f"{n} step {t} {k}: the streamed verdict is the request path's bit for bit")
                checked += 1
    info.update(served_machines=len(names), request_rows=SCALER_REQUEST_ROWS, request_seconds=request_seconds,
                serve_launches=serve_launches, served_max_norm_err=served, stream_launches=stream_launches,
                streamed_machines=len(streamed), streamed_rows=SCALER_STREAM["rows"],
                verdicts_checked_bitwise=checked)
    return info


TRANSFORM_SHAPES = [(576, 10), (4096, 128)]
#: QuantileTransformer's default grid, and the year of 10-minute rows the
#: grid statistic also runs on
TRANSFORM_Q = 100
TRANSFORM_YEAR = 52_560
#: K12 and the single-machine statistics against their plain versions on
#: the card, max |kernel - plain| / max |plain| over the finite values (the
#: NaNs must sit at the same places): chain_apply's PCA sums in another
#: order than cuBLAS (the other steps round as the plain version's
#: separate operations do, the FMAs as its float64 ones); the grid's
#: selection is exact and its interpolation the plain version's FMA
#: (expected 0, a double rounding in float64 at most 1 ulp); the means sum
#: in XLA:CPU's tree order on both sides (expected 0)
TRANSFORM_TOLERANCE = {"chain_apply": 1e-5, "grid": 1e-6, "mean": 1e-6}
#: chain A and chain B of the single-machine path, the JAX package's paths
CHAIN_A = {
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            {"gordo_tpu.ops.scalers.SimpleImputer": {"strategy": "median"}},
            {"gordo_tpu.ops.scalers.FunctionTransformer": {
                "func": "gordo_tpu.ops.transformer_funcs.multiplier", "kw_args": {"factor": 2}}},
            {"gordo_tpu.ops.scalers.PCA": {"n_components": 8}},
            "gordo_tpu.ops.scalers.MinMaxScaler",
            {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}},
        ]}}
    }
}


def chain_b(distribution: str = "normal") -> dict:
    return {
        "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
            "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
                {"gordo_tpu.ops.scalers.QuantileTransformer": {
                    "n_quantiles": TRANSFORM_Q, "output_distribution": distribution}},
                {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}},
            ]}}
        }
    }


#: the transform build's project: machines of chain A, of chain B (normal)
#: and of chain B with a uniform output; rows of each request; the
#: machines whose responses are held to the plain scorer on the CPU
TRANSFORM_FLEET = {"chain_a": 8, "chain_b": 6, "chain_b_uniform": 2}
TRANSFORM_ROWS = 576
TRANSFORM_REQUEST_ROWS = 64
#: the transform build held to its plain program on the card, per machine
#: (max |kernel build - plain build| / max |plain build|): the stats as the
#: kernels', the fits as ``fleet_fit``'s against its plain version, the
#: rest as the fleet builds'
TRANSFORM_BUILD_TOLERANCE = {"stats": 1e-5, "params": TRAIN_TOLERANCE["fleet_fit"],
                             "thresholds": BUILD_TOLERANCE["thresholds"],
                             "explained_variance_score": BUILD_TOLERANCE["explained_variance_score"],
                             "mean_squared_error": BUILD_TOLERANCE["mean_squared_error"]}


def _masked_err(ref: torch.Tensor, got: torch.Tensor, what: str) -> tuple:
    """``(max norm error, max abs error)`` over the finite values, the
    non-finite ones required at the same places with the same values."""
    ref, got = ref.double(), got.double()
    fin = torch.isfinite(ref)
    check(bool((fin == torch.isfinite(got)).all()), f"{what}: non-finite values at the same places")
    check(bool((torch.isnan(ref) == torch.isnan(got)).all()), f"{what}: NaN at the same places")
    check(bool((ref[~fin & ~torch.isnan(ref)] == got[~fin & ~torch.isnan(got)]).all()), f"{what}: same infinities")
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (ref[fin] - got[fin]).abs()
    return float(diff.max() / ref[fin].abs().max().clamp_min(1e-30)), float(diff.max())


def single_stat_bound(n: int, tags: int, nq: int, outputs: int):
    """Least time for one single-machine statistic (the grid, the median,
    the means): the (n, F) rows read once and, for the grid, its ``nq``
    fractions, ``outputs`` values a column written once, one operation a
    value.  The stat kernels' row-list interface is not the function's
    work, so its indices are not counted."""
    return bound(4 * (n * tags + nq + outputs * tags), n * tags)


def chain_apply_bound(n: int, steps, f: int):
    """Least time for one chain_apply call: the rows read once, the steps'
    stats read once, the output written once; per value 2 operations an
    affine or centre step, 1 the others, a PCA step (or its inverse) 2 F k
    a row, a quantile step (or its inverse) ceil(log2 Q) comparisons and 6
    operations (and 40 for ndtri or ndtr).  ``n`` counts the rows of every
    slot of a stacked call."""
    from gordo_tpu_torch.kernels import chain_apply as ca

    w, ops, stats = f, 0.0, 0
    for st in steps:
        stats += sum(int(t.numel()) for t in (st.a, st.b) if t is not None)
        if st.form == ca.PCA:
            k = int(st.b.shape[-1])
            ops += n * (w + 2 * w * k)
            w = k
        elif st.form == ca.PCA_INV:
            k = int(st.b.shape[-1])
            ops += n * (2 * w * k + k)
            w = k
        elif st.form in (ca.QUANTILE, ca.QUANTILE_INV):
            ops += n * w * (math.ceil(math.log2(int(st.a.shape[-2]))) + 6 + (40 if st.normal else 0))
        else:
            ops += n * w * (2 if st.form in (ca.AFFINE, ca.CENTER) else 1)
    return bound(4 * (n * f + stats + n * w), ops)


def phase_transform_kernel_check():
    """K12 and the single-machine statistics against their plain versions
    on the card.  ``chain_apply`` over every step form at each of
    TRANSFORM_SHAPES: an imputer, centre, multiply, expm1, add, log1p,
    PCA and affine chain on rows with NaN cells, with PCA at k = 8, 10 and
    the full width; QuantileTransformer steps of Q = 100
    (uniform and normal) and Q = 1,000 (normal) on quantised rows, whose
    grids (from the kernel) tie, with NaN rows; and chains A and B as the
    build fits them, and the PCA step alone at the full width beside
    ``torch.mm`` of the centred rows.  ``scaler_quantiles``' grid variant
    (Q = 100, the median by selection and by the sort) at the first shape
    and on a year of 10-minute rows (52,560 × 10), and at its sort's
    edges (Q 1,000, 27,000 and 57,344 rows with an all-NaN column, one
    row), each bit for bit its plain version (``grid_bits``), Robust's
    kernel rechecked value for value against its plain version;
    ``scaler_stats``' mean (``jnp.mean``) with a NaN column and NaN-mean,
    at the first shape, on the year (a cluster per column group) and at
    QS_MAX_ROWS over uneven row lists, each bit for bit its plain version
    (``mean_bits``).
    Times, bounds, and the library calls: ``torch.nanquantile`` over the
    grid, ``torch.mm``, ``torch.mean`` and ``torch.nanmean``; no one
    PyTorch call runs a transform chain."""
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss

    rng = np.random.default_rng(SEED + 31)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    entries = {}

    def hold(name, run, plain, bound_info, tol, library=None, reps=20, plain_reps=5, one_launch=False):
        """``library``: one PyTorch call computing the same function, timed
        as the kernel is (``time_ms``) where it is ``one_launch``, else as
        the plain version (``time_calls_ms``: its launch gaps included)."""
        got, ref = run(), plain()
        outs = list(got) if isinstance(got, (tuple, list)) else [got]
        refs = list(ref) if isinstance(ref, (tuple, list)) else [ref]
        errs, worst = [], 0.0
        for r, g in zip(refs, outs):
            e, a = _masked_err(r, g, name)
            errs.append(e)
            worst = max(worst, a)
        check(max(errs) <= tol, f"{name} within {tol}: {errs}")
        entry = {"max_norm_err": max(errs), "max_abs_err": worst, "tolerance": tol, **bound_info,
                 "hashes": [output_hash(g) for g in outs]}
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, reps)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, plain_reps)
            entry["library_ms"] = None if library is None else (
                time_ms(library, reps)[0] if one_launch else time_calls_ms(library, plain_reps)[0])
        entries[name] = entry
        return got

    def mean_bits(name, stat, x, lists):
        """The means bit for bit their plain versions (both in XLA's
        window order)."""
        got = ss.scaler_stats(x, lists, stat=stat)[0]
        ref = ss.scaler_stats_plain(x, lists, stat=stat)[0]
        entries[name]["differing"] = differing(ref, got)
        check(entries[name]["differing"] == 0, f"{name}: bit for bit its plain version")

    def grid_bits(name, x, lists, q, midpoint=False):
        """The grid variant bit for bit its plain version (exact order
        statistics; a zero's sign aside: the kernel ranks -0 first,
        torch.sort keeps the rows' order)."""
        got = sq.scaler_quantiles_grid(x, lists, q, midpoint=midpoint) + 0.0
        ref = sq.scaler_quantiles_grid_plain(x, lists, q, midpoint=midpoint) + 0.0
        check(same_bits(ref.cpu().numpy(), got.cpu().numpy()), f"{name}: bit for bit its plain version")
        entries[name]["bitwise"] = True

    # the statistics: the grid, the median, the means
    rows, tags = TRANSFORM_SHAPES[0]
    for label, n in (("", rows), ("_year", TRANSFORM_YEAR)):
        X = np.round(bench_fleet(rng, 1, n, tags) * 8) / 8   # quantised: tied values
        X[0, rng.random((n, tags)) < 0.01] = np.nan
        x = put(X)
        whole = [np.arange(n)]
        q = put(ca.percentile_fractions(TRANSFORM_Q))
        reps = 20 if not label else 5
        hold(f"grid{label}", lambda: sq.scaler_quantiles_grid(x, whole, q),
             lambda: sq.scaler_quantiles_grid_plain(x, whole, q),
             single_stat_bound(n, tags, TRANSFORM_Q, TRANSFORM_Q), TRANSFORM_TOLERANCE["grid"],
             library=lambda: torch.nanquantile(x[0], q, dim=0), reps=reps, plain_reps=3)
        grid_bits(f"grid{label}", x, whole, q)
        half = put([0.5])
        hold(f"median{label}", lambda: sq.scaler_quantiles_grid(x, whole, half, midpoint=True),
             lambda: sq.scaler_quantiles_grid_plain(x, whole, half, midpoint=True),
             single_stat_bound(n, tags, 1, 1), TRANSFORM_TOLERANCE["grid"],
             library=lambda: torch.nanmedian(x[0], dim=0).values, reps=reps, plain_reps=3)
        grid_bits(f"median{label}", x, whole, half, midpoint=True)
        # the median through the sort (its fraction twice), beside the
        # selection the launcher keeps for one fraction
        halves = put([0.5, 0.5])
        hold(f"median_sorted{label}", lambda: sq.scaler_quantiles_grid(x, whole, halves, midpoint=True),
             lambda: sq.scaler_quantiles_grid_plain(x, whole, halves, midpoint=True),
             single_stat_bound(n, tags, 2, 2), TRANSFORM_TOLERANCE["grid"], reps=reps, plain_reps=3)
        grid_bits(f"median_sorted{label}", x, whole, halves, midpoint=True)
        # Robust's path, unchanged: its plain version's values exactly (a
        # zero may come out as -0.0 on one side: the kernel ranks -0 first,
        # torch.sort keeps the rows' order)
        hold(f"robust{label}", lambda: sq.scaler_quantiles(x, whole), lambda: sq.scaler_quantiles_plain(x, whole),
             stat_bound(1, n, tags, whole, 0, 1), 0.0, reps=reps, plain_reps=3)
        Xm = bench_fleet(rng, 1, n, tags)
        Xm[0, 5, 3] = np.nan     # jnp.mean keeps a NaN column's NaN
        xm = put(Xm)
        hold(f"mean{label}", lambda: ss.scaler_stats(xm, whole, stat="mean")[0],
             lambda: ss.scaler_stats_plain(xm, whole, stat="mean")[0],
             single_stat_bound(n, tags, 0, 1), TRANSFORM_TOLERANCE["mean"],
             library=lambda: torch.mean(xm, dim=1), reps=reps, plain_reps=3, one_launch=True)
        check(bool(torch.isnan(ss.scaler_stats(xm, whole, stat="mean")[0][0, 0, 3])), "a NaN column's mean is NaN")
        mean_bits(f"mean{label}", "mean", xm, whole)
        hold(f"nanmean{label}", lambda: ss.scaler_stats(xm, whole, stat="nanmean")[0],
             lambda: ss.scaler_stats_plain(xm, whole, stat="nanmean")[0],
             single_stat_bound(n, tags, 0, 1), TRANSFORM_TOLERANCE["mean"],
             library=lambda: torch.nanmean(xm, dim=1), reps=reps, plain_reps=3)
        mean_bits(f"nanmean{label}", "nanmean", xm, whole)

    # the means past one block over uneven row lists (QS_MAX_ROWS, 31,337,
    # a non-prefix 45,001 and 8,193 rows), two machines, a NaN column
    n = sq.MAX_ROWS
    Xm = bench_fleet(rng, 2, n, tags)
    Xm[1, 40_000, 6] = np.nan
    xm = put(Xm)
    uneven = [np.arange(n), np.arange(31_337), np.sort(rng.permutation(n)[:45_001]), np.arange(8_193)]
    for stat in ("mean", "nanmean"):
        hold(f"{stat}_max_rows", lambda: ss.scaler_stats(xm, uneven, stat=stat)[0],
             lambda: ss.scaler_stats_plain(xm, uneven, stat=stat)[0],
             single_stat_bound(2 * sum(len(r) for r in uneven), tags, 0, 2 * len(uneven)),
             TRANSFORM_TOLERANCE["mean"], reps=5, plain_reps=2)
        mean_bits(f"{stat}_max_rows", stat, xm, uneven)
    del xm

    # the grid's sort at its edges: quantised rows (tied keys) with NaN
    # rows and an all-NaN column, at Q 1,000 on the first shape, at 27,000
    # rows (a cluster of 4 blocks) and at QS_MAX_ROWS (57,344, of 8); a
    # one-row list
    for label, n, nq in (("q1000", rows, 1000), ("27000", 27_000, TRANSFORM_Q),
                         ("max_rows", sq.MAX_ROWS, TRANSFORM_Q)):
        X = np.round(bench_fleet(rng, 1, n, tags) * 8) / 8
        X[0, rng.random(n) < 0.01] = np.nan
        X[0, :, 1] = np.nan
        x = put(X)
        whole = [np.arange(n)]
        q = put(ca.percentile_fractions(nq))
        hold(f"grid_{label}", lambda: sq.scaler_quantiles_grid(x, whole, q),
             lambda: sq.scaler_quantiles_grid_plain(x, whole, q),
             single_stat_bound(n, tags, nq, nq), TRANSFORM_TOLERANCE["grid"],
             library=lambda: torch.nanquantile(x[0], q, dim=0), reps=5, plain_reps=2)
        grid_bits(f"grid_{label}", x, whole, q)
    x = put(np.round(bench_fleet(rng, 1, rows, tags) * 8) / 8)
    one = [np.array([rows // 2])]
    q = put(ca.percentile_fractions(TRANSFORM_Q))
    hold("grid_one_row", lambda: sq.scaler_quantiles_grid(x, one, q),
         lambda: sq.scaler_quantiles_grid_plain(x, one, q),
         single_stat_bound(1, tags, TRANSFORM_Q, TRANSFORM_Q), TRANSFORM_TOLERANCE["grid"], reps=5, plain_reps=2)
    grid_bits("grid_one_row", x, one, q)

    # chain_apply: every step form, both quantile outputs, chains A and B
    for n, f in TRANSFORM_SHAPES:
        X = bench_fleet(rng, 1, n, f)[0]
        Xq = np.round(X * 4) / 4                             # quantised rows: tied grid values
        nan_rows = rng.random(n) < 0.02
        Xn = X.copy()
        Xn[nan_rows, rng.integers(0, f, int(nan_rows.sum()))] = np.nan
        x, xq, xn = put(X), put(Xq), put(Xn)
        whole = [np.arange(n)]
        grid = sq.scaler_quantiles_grid(xq[None].contiguous(), whole, put(ca.percentile_fractions(TRANSFORM_Q)))[0, 0]
        grid_1000 = sq.scaler_quantiles_grid(xq[None].contiguous(), whole, put(ca.percentile_fractions(1000)))[0, 0]
        check(bool((grid[1:] == grid[:-1]).any()), "the quantised grid has tied entries")
        xq_nan = xq.clone()
        xq_nan[torch.from_numpy(nan_rows).to(DEVICE)] = float("nan")
        mean, std = (put(v) for v in (X.mean(0), X.std(0) + 0.1))
        fill = put(np.nanmedian(Xn, 0))
        u, sv, vt = torch.linalg.svd(x - x.mean(0), full_matrices=False)
        qs = put(ca.unit_linspace(TRANSFORM_Q))
        for k in sorted({8, 10, f}):
            comps = vt[:k].contiguous()
            steps = [ca.Step(ca.IMPUTE, fill), ca.Step(ca.CENTER, mean, std), ca.func_step(ca.MUL, 0.5),
                     ca.func_step(ca.EXPM1), ca.func_step(ca.ADD, 1.0), ca.func_step(ca.LOG1P),
                     ca.Step(ca.PCA, put(np.zeros(f)), comps.t().contiguous()),
                     ca.Step(ca.AFFINE, put(rng.uniform(0.5, 2, k)), put(rng.uniform(-1, 1, k)))]
            hold(f"every_form_{n}x{f}_k{k}", lambda: ca.chain_apply(xn, steps), lambda: ca.chain_apply_plain(xn, steps),
                 chain_apply_bound(n, steps, f), TRANSFORM_TOLERANCE["chain_apply"])
        # the forward PCA step alone at the full width, beside torch.mm of
        # the rows centred beforehand (the library call's part of the work)
        pca = [ca.Step(ca.PCA, mean, vt.t().contiguous())]
        centred = x - mean
        hold(f"pca_k{f}_{n}x{f}", lambda: ca.chain_apply(x, pca), lambda: ca.chain_apply_plain(x, pca),
             chain_apply_bound(n, pca, f), TRANSFORM_TOLERANCE["chain_apply"],
             library=lambda: torch.mm(centred, pca[0].b), one_launch=True)
        for label, steps, rows_in in (
            ("quantile_uniform", [ca.Step(ca.QUANTILE, grid, qs)], xq_nan),
            ("quantile_normal", [ca.Step(ca.QUANTILE, grid, qs, normal=True)], xq_nan),
            ("quantile_1000_normal", [ca.Step(ca.QUANTILE, grid_1000, put(ca.unit_linspace(1000)), normal=True)],
             xq_nan),
            ("chain_a", [ca.Step(ca.IMPUTE, fill), ca.func_step(ca.MUL, 2.0),
                         ca.Step(ca.PCA, mean, vt[: min(8, f)].t().contiguous()),
                         ca.Step(ca.AFFINE, put(rng.uniform(0.5, 2, min(8, f))), put(rng.uniform(-1, 1, min(8, f))))],
             xn),
        ):
            hold(f"{label}_{n}x{f}", lambda: ca.chain_apply(rows_in, steps), lambda: ca.chain_apply_plain(rows_in, steps),
                 chain_apply_bound(n, steps, f), TRANSFORM_TOLERANCE["chain_apply"])
    emit({"phase": "transform_kernel_check", "shapes": TRANSFORM_SHAPES, "q": TRANSFORM_Q,
          "year_rows": TRANSFORM_YEAR, "kernels": entries})
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def transform_project(rows: int, tags: int) -> str:
    """The transform build's project YAML: TRANSFORM_FLEET's machines of
    chains A and B, each over its own ``tags`` RandomDataset tags and
    ``rows`` 10-minute rows (``gordo_tpu_torch.bench.project_config``'s
    dataset), each machine naming its model."""
    from gordo_tpu_torch.bench import project_config

    machines = sum(TRANSFORM_FLEET.values())
    text = project_config(machines, tags, rows, seed=12)
    models = ([CHAIN_A] * TRANSFORM_FLEET["chain_a"] + [chain_b()] * TRANSFORM_FLEET["chain_b"]
              + [chain_b("uniform")] * TRANSFORM_FLEET["chain_b_uniform"])
    lines = []
    for line in text.splitlines():
        lines.append(line)
        if line.startswith("    dataset: {tag_list"):
            lines.append(f"    model: {json.dumps(models.pop(0))}")
    return "\n".join(lines) + "\n"


def _transform_counters():
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss

    return {"chain_apply": (ca, "launches"), "scaler_quantiles_grid": (sq, "grid_launches"),
            "scaler_stats_mean": (ss, "mean_launches"), **_ff_counters()}


@contextlib.contextmanager
def plain_single_kernels():
    """Within: the single-machine path calls the kernels' plain versions
    (on any device): the transforms' statistics and ``chain_apply`` (its
    own module's name too, which ``chain_apply_union`` calls), the fits'
    draws and ``fleet_fit``, the scorer's ``chain_apply`` and
    ``fleet_score``."""
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fleet_fit as ff
    from gordo_tpu_torch.kernels import fleet_init as fi
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss
    from gordo_tpu_torch.models import estimator
    from gordo_tpu_torch.ops import scalers
    from gordo_tpu_torch.parallel import fleet
    from gordo_tpu_torch.serve import scorer

    plain = {(scalers, "chain_apply"): ca.chain_apply_plain, (scorer, "chain_apply"): ca.chain_apply_plain,
             (ca, "chain_apply"): ca.chain_apply_plain,
             (scalers, "scaler_stats"): ss.scaler_stats_plain,
             (scalers, "scaler_quantiles_grid"): sq.scaler_quantiles_grid_plain,
             (estimator, "fleet_fit"): ff.fleet_fit_plain, (scorer, "fleet_score"): fs.fleet_score_plain,
             (fleet, "_fleet_init_kernel"): fi.fleet_init_reference}
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _transform_arrays(det) -> dict:
    """A built transform detector's stats, params, thresholds and CV
    scores, as float64 arrays by group."""
    out = {"stats": [], "params": []}
    for k, v in det.state_arrays().items():
        if k in ("feature_thresholds", "aggregate_threshold"):
            continue
        (out["params"] if ".dense_" in k or ".out." in k else out["stats"]).append(np.asarray(v, np.float64).ravel())
    arrays = {g: np.concatenate(v) for g, v in out.items()}
    arrays["thresholds"] = np.append(det.feature_thresholds_, det.aggregate_threshold_).astype(np.float64)
    scores = det.cv_metadata_["scores"]
    for name in ("explained_variance_score", "mean_squared_error"):
        arrays[name] = np.asarray(scores[name]["folds"], np.float64)
    return arrays


def phase_transform_build():
    """``build_project`` of a RandomDataset project YAML of TRANSFORM_FLEET's
    chain A and chain B machines (TRANSFORM_ROWS × 10 tags) on the card:
    each through build-project's singles pass (``build_model``:
    cross-validation through the generic fold loop, thresholds, the final
    fit), with the stage split, the launches of every kernel (set to 0 just
    before) and the card's busy share; the same machines built again with
    every kernel of the path swapped for its plain version on the card
    (``plain_single_kernels``) and held per machine (stats, params,
    thresholds, CV scores); then the model directory served over HTTP:
    a per-machine anomaly request of TRANSFORM_REQUEST_ROWS rows with NaN
    cells for every machine and one bulk request of all of them (each
    machine one ``chain_apply`` and one ``fleet_score`` launch), held to
    the plain scorer on the CPU."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.bench import busy_share
    from gordo_tpu_torch.builder.build_model import build_model
    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.dataset.base import GordoBaseDataset
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.ops.scalers import PCA, QuantileTransformer
    from gordo_tpu_torch.serve.server import ModelCollection, make_server
    from gordo_tpu_torch.workflow.config import NormalizedConfig

    machines, tags = sum(TRANSFORM_FLEET.values()), 10
    device = None if DEVICE == "cuda" else DEVICE
    counters = _transform_counters()
    config = NormalizedConfig.from_source(transform_project(TRANSFORM_ROWS, tags), "transforms")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_transforms_") as tmp:
        # a first build of one machine of each chain loads cuSOLVER and the
        # kernels, outside the counted build
        build_project([config.machines[0], config.machines[-1]], os.path.join(tmp, "warm"), device=device)
        out_dir = os.path.join(tmp, "models")
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        timed = busy_share(lambda: build_project(config.machines, out_dir, device=device),
                           DEVICE if DEVICE == "cuda" else "cpu")
        result = timed["result"]
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        check(not result.failed and len(result.single_built) == machines and not result.fleet_built,
              f"build_project built {len(result.single_built)} of {machines} singles: {result.failed}")
        if DEVICE == "cuda":
            # per machine: 3 fold fits and the final fit, each one fleet_init
            # and one fleet_fit, each fitting the chain's steps in turn (A:
            # the median's grid, PCA's mean and MinMax's stats, and five
            # chain_apply launches, one a step and PCA's centring; B: the
            # grid and one chain_apply); each fold's scoring request one
            # chain_apply and one fleet_score; the detector scaler's MinMax
            # stats twice (cross-validation and the final fit)
            folds, fits = 3, 4
            a, b = TRANSFORM_FLEET["chain_a"], machines - TRANSFORM_FLEET["chain_a"]
            want = {"fleet_fit": machines * fits, "fleet_init": machines * fits,
                    "fleet_score": machines * folds, "scaler_quantiles_grid": machines * fits,
                    "scaler_stats_mean": a * fits, "scaler_stats": 2 * a * fits + 2 * machines,
                    "chain_apply": (5 * a + b) * fits + machines * folds,
                    "cv_epilogue": 0, "scaler_quantiles": 0, "scaler_stats_standard": 0}
            check(launches == want, f"transform build launches {launches}, expected {want}")
        models = {n: serializer.load(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))
                  if serializer.is_artifact_dir(os.path.join(out_dir, n))}
        check(len(models) == machines, f"{len(models)} artifacts written")
        for det in models.values():
            check(bool(np.isfinite(det.feature_thresholds_).all()), "finite thresholds")
            first = det.base_estimator.steps[0][1]
            if isinstance(first, QuantileTransformer):
                check(first.stats_["grid"].shape == (TRANSFORM_Q, tags), "the quantile grid's shape")
            else:
                pca = det.base_estimator.steps[2][1]
                check(isinstance(pca, PCA) and pca.stats_["components"].shape == (8, tags), "PCA (8, 10)")

        # where the time of the singles pass went, from each artifact's
        # metadata (build_model's data, cross-validation and fit seconds)
        singles_split = {"data": 0.0, "cross_validation": 0.0, "fit": 0.0}
        for n in models:
            meta = serializer.load_metadata(os.path.join(out_dir, n))["model"]
            singles_split["data"] += meta["data_query_duration_sec"]
            singles_split["cross_validation"] += meta["cross_validation_duration_sec"]
            singles_split["fit"] += meta["model_builder_duration_sec"]
        data = {m.name: np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)
                for m in config.machines}
        # the card's SVD against the CPU's on the same rows: chain A's PCA
        # refitted on the CPU from the card's imputed and multiplied rows
        svd = {"components": 0, "sign_flips": 0, "max_abs_gap": 0.0}
        for n, det in models.items():
            steps = [st for _, st in det.base_estimator.steps]
            if not any(isinstance(st, PCA) for st in steps):
                continue
            Z = steps[1].transform(steps[0].transform(data[n]))
            cpu = PCA(n_components=8).fit(Z, device="cpu").stats_["components"]
            card = steps[2].stats_["components"]
            dots = np.sum(cpu.astype(np.float64) * card, axis=1)
            svd["components"] += len(dots)
            svd["sign_flips"] += int((dots < 0).sum())
            svd["max_abs_gap"] = max(svd["max_abs_gap"], float(np.abs(np.abs(cpu) - np.abs(card)).max()))

        # the same machines through the plain versions on the card
        worst = {}
        with plain_single_kernels():
            for m in config.machines:
                plain_det, _ = build_model(m.name, m.model, m.dataset, m.metadata, m.evaluation, device=device)
                ref, got = _transform_arrays(plain_det), _transform_arrays(models[m.name])
                for key, r in ref.items():
                    err = float(np.abs(r - got[key]).max() / max(np.abs(r).max(), 1e-30))
                    worst[key] = max(worst.get(key, 0.0), err)
        _check_worst(worst, TRANSFORM_BUILD_TOLERANCE, "transform build against its plain program")

        requests = {}
        for i, n in enumerate(sorted(data)):
            X = data[n][-TRANSFORM_REQUEST_ROWS:].copy()
            X[3 + i % 5, i % tags] = np.nan          # a sensor dropout in the request
            requests[n] = X
        collection = ModelCollection.from_directory(out_dir, project="transforms", device=device)
        server = make_server(collection, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/transforms"
        try:
            ca.launches = fs.launches = 0
            t0 = time.perf_counter()
            single = {n: _request(f"{base}/{n}/anomaly/prediction", {"X": X.tolist()}) for n, X in requests.items()}
            single_seconds = (time.perf_counter() - t0) / len(requests)
            single_launches = {"chain_apply": ca.launches, "fleet_score": fs.launches}
            ca.launches = fs.launches = 0
            t1 = time.perf_counter()
            status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                    {"X": {n: X.tolist() for n, X in requests.items()}})
            bulk_seconds = time.perf_counter() - t1
            bulk_launches = {"chain_apply": ca.launches, "fleet_score": fs.launches}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread stopped")
        check(status == 200 and all(st == 200 for st, _ in single.values()), "transform requests answered 200")
        if DEVICE == "cuda":
            want = {"chain_apply": machines, "fleet_score": machines}
            check(single_launches == want and bulk_launches == want,
                  f"each machine's request one chain_apply and one fleet_score: {single_launches}, {bulk_launches}")
        served = {}
        for n, X in requests.items():
            ref = models[n].anomaly(X, device="cpu")
            for label, got_all in (("single", single[n][1]["data"]), ("bulk", body["data"][n])):
                for k in OUTPUTS:
                    r = torch.from_numpy(np.asarray(ref[k], np.float64))
                    g = torch.from_numpy(np.asarray(got_all[k], np.float64))
                    check(g.shape == r.shape, f"served {k} of {n} ({label})")
                    err, _ = _masked_err(r, g, f"served {k} of {n} ({label})")
                    served[k] = max(served.get(k, 0.0), err)
        check(all(v <= TOLERANCE for v in served.values()), f"served transform detectors within {TOLERANCE}: {served}")
    return {
        "machines": machines, "rows": TRANSFORM_ROWS, "tags": tags, "fleet": TRANSFORM_FLEET,
        "build_seconds": result.seconds, "models_per_hour": machines / result.seconds * 3600,
        "stage_seconds": dict(result.stage_seconds), "singles_seconds": singles_split,
        "svd_card_vs_cpu": svd, "busy_share": timed["busy_share"],
        "kernel_seconds": timed["kernel_seconds"], "launches": launches,
        "vs_plain_max_norm_err": worst, "request_rows": TRANSFORM_REQUEST_ROWS,
        "single_request_seconds": single_seconds, "bulk_request_seconds": bulk_seconds,
        "single_launches": single_launches, "bulk_launches": bulk_launches, "served_max_norm_err": served,
    }


#: chain C: the fused transform chain (SimpleImputer(median), PCA(8),
#: MinMaxScaler) before the default AutoEncoder, the JAX package's paths
CHAIN_C_K = 8
CHAIN_C = {
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            {"gordo_tpu.ops.scalers.SimpleImputer": {"strategy": "median"}},
            {"gordo_tpu.ops.scalers.PCA": {"n_components": CHAIN_C_K}},
            "gordo_tpu.ops.scalers.MinMaxScaler",
            {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}},
        ]}}
    }
}
#: the LSTM behind a fused chain: SimpleImputer(mean), PCA() (k = the
#: tags), then BASELINE config 2's LSTM (lstm_hourglass, lookback 12)
LSTM_CHAIN = {
    "gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            {"gordo_tpu.ops.scalers.SimpleImputer": {"strategy": "mean"}},
            "gordo_tpu.ops.scalers.PCA",
            {"gordo_tpu.models.estimator.LSTMAutoEncoder": {"kind": "lstm_hourglass",
                                                            "lookback_window": LOOKBACK}},
        ]}}
    }
}
#: a bucket of chain-C detectors as the stacked kernel sees it: the build
#: bench's 512 machines, 2048 rows each, 10 tags; the subset route's slots
TRANSFORM_SERVE_SHAPE = (512, 2048, 10)
TRANSFORM_SERVE_SUBSET = 64
#: share of the request cells that are NaN (sensor dropouts)
TRANSFORM_SERVE_NAN = 0.005
#: stacked chain_apply against its plain version on the same inputs, max
#: |kernel - plain| / max |plain| over the finite values (the NaNs at the
#: same places): the PCA step sums in another order than the plain
#: version's matmul (as TRANSFORM_TOLERANCE's chain_apply); with a bf16
#: output both round an f32 value that differs in its last bits, one bf16
#: ulp at most (2^-7 of the largest value)
TRANSFORM_SERVE_TOLERANCE = {"float32": TRANSFORM_TOLERANCE["chain_apply"], "bfloat16_out": 2.0 ** -7}
#: the served directory: chain-C detectors, and chain-A detectors (the
#: transform build's, a ``multiplier`` step: no fused chain, served per
#: machine at f32);
#: machines asked for one by one; streamed machines (window 144) and rows;
#: machines built through build-project's singles pass
TRANSFORM_SERVE_FLEET = {"chain_c": 512, "chain_a": 4}
TRANSFORM_SERVE_ROWS = 2048
TRANSFORM_SERVE_SINGLES = 4
TRANSFORM_STREAM = {"machines": 4, "rows": 200}
TRANSFORM_BUILT = 16
#: an LSTM bucket behind chain (SimpleImputer, PCA) at the K6 rows' shapes;
#: machines held to the plain scorer on the CPU; rows streamed
LSTM_CHAIN_SHAPE = LSTM_SHAPE
LSTM_CHAIN_CHECKED = 2
LSTM_CHAIN_STREAM_ROWS = 40


def random_chain_c(rng: np.random.Generator, machines: int, tags: int, k: int):
    """Stacked numpy arrays of ``machines`` chain-C detectors: the
    imputer's fill and PCA's mean near the rows' range, orthonormal
    components (k, tags) per machine, MinMax stats of the k components,
    the default AutoEncoder of k inputs and ``tags`` outputs, the detector
    scaler and thresholds."""
    from gordo_tpu_torch.models.factories.utils import hourglass_calc_dims

    q, _ = np.linalg.qr(rng.standard_normal((machines, tags, tags)))
    enc = hourglass_calc_dims(0.5, 3, k)
    dims = [k] + enc + enc[::-1] + [tags]
    layers = []
    for i in range(len(dims) - 1):
        W = rng.standard_normal((machines, dims[i], dims[i + 1])) / math.sqrt(dims[i])
        layers.append((W.astype(np.float32), (0.1 * rng.standard_normal((machines, dims[i + 1]))).astype(np.float32)))
    pcs = random_stats(rng, machines, k)
    return {
        "dims": dims, "layers": layers, "acts": ["tanh"] * (len(dims) - 2) + ["linear"],
        "fill": (0.2 * rng.standard_normal((machines, tags))).astype(np.float32),
        "mean": (0.1 * rng.standard_normal((machines, tags))).astype(np.float32),
        "components": np.ascontiguousarray(q[:, :k, :].astype(np.float32)),
        "pca_scale": pcs["scale"], "pca_offset": pcs["offset"],
        **random_stats(rng, machines, tags),
    }


def chain_c_steps(src, device):
    """chain_apply's stacked steps of chain C from ``random_chain_c``."""
    from gordo_tpu_torch.kernels import chain_apply as ca

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    return [ca.Step(ca.IMPUTE, put(src["fill"]), stacked=True),
            ca.Step(ca.PCA, put(src["mean"]), put(src["components"].transpose(0, 2, 1)), stacked=True),
            ca.Step(ca.AFFINE, put(src["pca_scale"]), put(src["pca_offset"]), stacked=True)]


def chain_c_detector(src, i, definition=CHAIN_C, thresholds: bool = True):
    """The port's chain-C detector ``i`` of ``random_chain_c``'s arrays."""
    from gordo_tpu_torch import convert

    return convert.from_reference(
        definition, dense_params(src, i),
        scaler_stats=[{"fill": src["fill"][i]},
                      {"mean": src["mean"][i], "components": src["components"][i]},
                      {"scale": src["pca_scale"][i], "offset": src["pca_offset"][i]}],
        detector_stats={"scale": src["det_scale"][i], "offset": src["det_offset"][i]},
        feature_thresholds=src["feature_thresholds"][i] if thresholds else None,
        aggregate_threshold=float(src["agg"][i]) if thresholds else None,
    )


def chain_a_detector(src, i):
    """A chain-A detector (imputer, ``multiplier``, PCA(8), MinMax): chain
    C's arrays of machine ``i``, its multiplier step between the imputer
    and PCA."""
    from gordo_tpu_torch import convert

    return convert.from_reference(
        CHAIN_A, dense_params(src, i),
        scaler_stats=[{"fill": src["fill"][i]}, {},
                      {"mean": src["mean"][i], "components": src["components"][i]},
                      {"scale": src["pca_scale"][i], "offset": src["pca_offset"][i]}],
        detector_stats={"scale": src["det_scale"][i], "offset": src["det_offset"][i]},
        feature_thresholds=src["feature_thresholds"][i], aggregate_threshold=float(src["agg"][i]),
    )


def request_rows(rng, machines: int, rows: int, tags: int) -> np.ndarray:
    """``bench_fleet`` rows with TRANSFORM_SERVE_NAN of their cells NaN."""
    X = bench_fleet(rng, machines, rows, tags)
    X[rng.random(X.shape) < TRANSFORM_SERVE_NAN] = np.nan
    return X


def stacked_chain_bound(rows: int, f: int, k: int, machines: int, in_bytes: int, out_bytes: int):
    """Least time for one stacked chain-C ``chain_apply``: the ``rows``
    valid rows read once at the storage width, the stats of the
    ``machines`` that the slots read (all of the bucket's, or the subset's
    distinct ``idx``) read once (fill, mean, components, MinMax), the
    (rows, k) output written once; per row f selects, f subtractions, 2 f k
    for the projection and 2 k for the MinMax."""
    stats = machines * (2 * f + f * k + 2 * k)
    return bound(in_bytes * (rows * f + stats) + out_bytes * rows * k, rows * (2 * f + 2 * f * k + 2 * k))


def same_bits(ref, got) -> bool:
    """Two float32 arrays bit for bit, a NaN matching any NaN (its payload
    is no value: the card's arithmetic makes 0x7fffffff, the medians'
    empty window 0x7fc00000)."""
    r, g = np.atleast_1d(np.asarray(ref, np.float32)), np.atleast_1d(np.asarray(got, np.float32))
    nan = np.isnan(r)
    return r.shape == g.shape and bool((nan == np.isnan(g)).all()) and \
        r[~nan].tobytes() == g[~nan].tobytes()


def _nan_err(ref, got, what: str) -> float:
    """max |ref - got| / max |ref| over the finite values of two host
    arrays, NaN required at the same places."""
    r, g = torch.from_numpy(np.asarray(ref, np.float64)), torch.from_numpy(np.asarray(got, np.float64))
    check(tuple(r.shape) == tuple(g.shape), f"{what}: shape {tuple(g.shape)}, want {tuple(r.shape)}")
    return _masked_err(r, g, what)[0]


def phase_transform_serve_kernel_check():
    """The stacked ``chain_apply`` (a machine axis: ``serve.fleet`` over
    chain C) against its plain version on the card, on a bucket of
    TRANSFORM_SERVE_SHAPE with NaN cells: f32 rows and stats; bf16 rows and
    stats (K10 over K12), output f32 (fleet_score's input) and bf16 (the
    first lstm_layer's); int8 stats (fake-quantised by ``fake_quant``, as
    a bucket loads them); the subset route (TRANSFORM_SERVE_SUBSET ``idx``
    slots, ragged ``n_rows``) at f32 and bf16.  Times, bounds, the plain
    version's time, and the torch.where + torch.baddbmm + affine sequence
    that computes the same chain (no one PyTorch call does), timed beside
    it."""
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fake_quant as fq

    M, n, F = TRANSFORM_SERVE_SHAPE
    k = CHAIN_C_K
    rng = np.random.default_rng(SEED + 41)
    src = random_chain_c(rng, M, F, k)
    x = torch.from_numpy(request_rows(rng, M, n, F)).to(DEVICE)
    xb = x.to(torch.bfloat16)
    f32 = chain_c_steps(src, DEVICE)
    bf16 = [ca.Step(s.form, s.a.to(torch.bfloat16), None if s.b is None else s.b.to(torch.bfloat16), stacked=True)
            for s in f32]
    int8 = [ca.Step(s.form, fq.fake_quant(s.a), None if s.b is None else fq.fake_quant(s.b), stacked=True)
            for s in bf16]
    idx = np.sort(rng.choice(M, TRANSFORM_SERVE_SUBSET, replace=False))
    rows = rng.integers(n // 2, n + 1, TRANSFORM_SERVE_SUBSET)
    rows[0] = n
    sub = torch.from_numpy(idx).to(DEVICE)
    xs, xsb = x[sub].contiguous(), xb[sub].contiguous()
    tol = TRANSFORM_SERVE_TOLERANCE
    variants = {
        "float32": (x, f32, {}, torch.float32, tol["float32"], 4, 4),
        "bfloat16": (xb, bf16, {}, torch.float32, tol["float32"], 2, 4),
        "bfloat16_out": (xb, bf16, {}, torch.bfloat16, tol["bfloat16_out"], 2, 2),
        "int8": (xb, int8, {}, torch.float32, tol["float32"], 2, 4),
        "subset_float32": (xs, f32, {"idx": idx, "n_rows": rows}, torch.float32, tol["float32"], 4, 4),
        "subset_bfloat16": (xsb, bf16, {"idx": idx, "n_rows": rows}, torch.float32, tol["float32"], 2, 4),
    }
    entries = {}
    for name, (rows_in, steps, kw, out_dtype, tolerance, in_bytes, out_bytes) in variants.items():
        run = lambda: ca.chain_apply(rows_in, steps, out_dtype=out_dtype, **kw)  # noqa: E731
        plain = lambda: ca.chain_apply_plain(rows_in, steps, out_dtype=out_dtype, **kw)  # noqa: E731
        got, ref = run(), plain()
        check(got.dtype == out_dtype and tuple(got.shape) == (int(rows_in.shape[0]), n, k),
              f"{name}: {got.dtype} {tuple(got.shape)}")
        counts = rows if "idx" in kw else np.full(int(rows_in.shape[0]), n)
        valid = lambda t: torch.cat([t[i, :c] for i, c in enumerate(counts)])  # noqa: E731
        err, abs_err = _masked_err(valid(ref), valid(got), f"chain_apply {name}")
        check(err <= tolerance, f"stacked chain_apply {name} within {tolerance}: {err}")
        entry = {"max_norm_err": err, "max_abs_err": abs_err, "tolerance": tolerance,
                 "slots": int(rows_in.shape[0]), "rows": int(counts.sum()), "storage": str(rows_in.dtype),
                 "out": str(out_dtype), "hashes": output_hashes(got.float(), counts),
                 **stacked_chain_bound(int(counts.sum()), F, k, len(np.unique(kw["idx"])) if "idx" in kw else M,
                                       in_bytes, out_bytes)}
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, 20)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, 3)
        entries[name] = entry
    # the same chain in library calls (the projection as x C^T - mean C^T)
    fill, mean, comps_t = (t for t in (f32[0].a, f32[1].a, f32[1].b))
    proj_mean = -torch.bmm(mean[:, None, :], comps_t)
    scale, offset = f32[2].a[:, None, :], f32[2].b[:, None, :]

    def library():
        h = torch.where(torch.isnan(x), fill[:, None, :], x)
        return torch.baddbmm(proj_mean, h, comps_t) * scale + offset

    entries["float32"]["comparison_err"] = _masked_err(ca.chain_apply_plain(x, f32), library(), "library chain")[0]
    if DEVICE == "cuda":
        entries["float32"]["comparison_ms"] = time_calls_ms(library, 5)[0]
    entries["float32"]["comparison"] = "torch.where + torch.baddbmm + affine"
    emit({"phase": "transform_serve_kernel_check", "shape": list(TRANSFORM_SERVE_SHAPE), "k": k,
          "subset": TRANSFORM_SERVE_SUBSET, "kernels": entries})
    del x, xb, xs, xsb
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


def _transform_serve_counters():
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fake_quant as fq
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import rolling_median as rm
    from gordo_tpu_torch.kernels import stream_step as sk

    return {"chain_apply": (ca, "launches"), "chain_apply_stacked": (ca, "stacked_launches"),
            "chain_apply_bf16": (ca, "bf16_launches"), "fleet_score": (fs, "launches"),
            "fleet_score_bf16": (fs, "bf16_launches"), "lstm_layer": (ll, "launches"),
            "lstm_layer_bf16": (ll, "bf16_launches"), "rolling_median": (rm, "launches"),
            "stream_step": (sk, "launches"), "stream_shift": (sk, "shift_launches"),
            "fake_quant": (fq, "launches")}


def _zero(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def _post_bytes(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _serve_http(collection, requests: list):
    """Serve ``collection`` over HTTP for ``requests`` (``(path, body
    bytes)``): each answer and its seconds."""
    from gordo_tpu_torch.serve.server import make_server

    server = make_server(collection, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/{collection.project}"
    out = []
    try:
        for path, body in requests:
            t0 = time.perf_counter()
            status, answer = _post_bytes(f"{base}/{path}", body)
            out.append((status, answer, time.perf_counter() - t0))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread stopped")
    return out


def _transform_served(tmp, rng, out):
    """The chain-C directory served at f32, bf16 and int8 over HTTP."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
    from gordo_tpu_torch.serve.server import ModelCollection

    n_c, n_a = TRANSFORM_SERVE_FLEET["chain_c"], TRANSFORM_SERVE_FLEET["chain_a"]
    M, n, F = n_c + n_a, TRANSFORM_SERVE_ROWS, TRANSFORM_SERVE_SHAPE[2]
    src = random_chain_c(rng, M, F, CHAIN_C_K)
    models = {}
    for i in range(M):
        name = f"c-{i}" if i < n_c else f"a-{i - n_c}"
        models[name] = chain_c_detector(src, i) if i < n_c else chain_a_detector(src, i)
        meta = {"dataset": {"tag_list": [f"{name}-tag-{j}" for j in range(F)]}}
        serializer.dump(models[name], os.path.join(tmp, name), metadata=meta)
    X = dict(zip(models, request_rows(rng, M, n, F)))
    subset = [f"c-{i}" for i in np.sort(rng.choice(n_c, TRANSFORM_SERVE_SUBSET, replace=False))]
    singles = [f"c-{i}" for i in range(TRANSFORM_SERVE_SINGLES)] + ["a-0"]
    encode = lambda names: json.dumps({"X": {m: X[m].tolist() for m in names}}).encode()  # noqa: E731
    t0 = time.perf_counter()
    bulk_body, subset_body = encode(list(models)), encode(subset)
    single_bodies = [json.dumps({"X": X[m].tolist()}).encode() for m in singles]
    out["encode_seconds"] = time.perf_counter() - t0
    out["bulk_request_bytes"] = len(bulk_body)
    counters = _transform_serve_counters()
    device = None if DEVICE == "cuda" else DEVICE
    responses, dtypes = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        info = {}
        _zero(counters)
        with serve_dtype_env(dtype):
            collection = ModelCollection.from_directory(tmp, project="transforms", device=device)
        check(collection.serve_dtype == dtype, f"collection at {dtype}")
        fleet = collection.fleet_scorer
        check(len(fleet.buckets) == 1 and sorted(fleet.fallbacks) == [f"a-{i}" for i in range(n_a)],
              f"{dtype}: one chain-C bucket and the chain-A fallbacks, got "
              f"{[len(b.names) for b in fleet.buckets]} and {sorted(fleet.fallbacks)}")
        check(all(s._stack.dtype == "float32" for s in fleet.fallbacks.values()), "chain A served at f32")
        info["resident_bytes"] = fleet.buckets[0].resident_bytes()
        info["load_launches"] = _read(counters)
        _zero(counters)
        requests = [("_bulk/anomaly/prediction", bulk_body)]
        answers = _serve_http(collection, requests)
        info["bulk_launches"] = _read(counters)
        _zero(counters)
        answers += _serve_http(collection, [("_bulk/anomaly/prediction", subset_body)])
        info["subset_launches"] = _read(counters)
        _zero(counters)
        answers += _serve_http(collection, [(f"{m}/anomaly/prediction", b) for m, b in zip(singles, single_bodies)])
        info["single_launches"] = _read(counters)
        check(all(status == 200 for status, _, _ in answers), f"{dtype}: every request answered 200")
        info["bulk_seconds"], info["subset_seconds"] = answers[0][2], answers[1][2]
        info["single_seconds"] = [a[2] for a in answers[2:]]
        if DEVICE == "cuda":
            reduced = int(dtype != "float32")
            # one chain_apply and one fleet_score for the bucket, and each
            # chain-A fallback its own pair at f32 (a stack of one machine)
            want = {"chain_apply": 1 + n_a, "chain_apply_stacked": 1 - reduced + n_a, "chain_apply_bf16": reduced,
                    "fleet_score": 1 + n_a, "fleet_score_bf16": reduced}
            got = {k: info["bulk_launches"][k] for k in want}
            check(got == want, f"{dtype} bulk launches {got}, expected {want}")
            want = {"chain_apply": 1, "chain_apply_stacked": 1 - reduced, "chain_apply_bf16": reduced,
                    "fleet_score": 1, "fleet_score_bf16": reduced}
            got = {k: info["subset_launches"][k] for k in want}
            check(got == want, f"{dtype} subset launches {got}, expected {want}")
            check(info["single_launches"]["chain_apply"] == len(singles)
                  and info["single_launches"]["fleet_score"] == len(singles), f"{dtype} single launches")
            # int8: every stats and weight leaf of the bucket quantised once
            # at load, and of each machine's own scorer
            if dtype == "int8":
                check(info["load_launches"]["fake_quant"] > 0, "int8 quantised the leaves at load")
        bulk, sub = answers[0][1]["data"], answers[1][1]["data"]
        responses[dtype] = {("bulk", m): bulk[m] for m in models}
        responses[dtype].update({("subset", m): sub[m] for m in subset})
        responses[dtype].update({("single", m): a[1]["data"] for m, a in zip(singles, answers[2:])})
        dtypes[dtype] = info
        del collection, fleet, answers, bulk, sub
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    # f32 against the plain scorer on the CPU; reduced against f32
    plain = FleetScorer.from_models(models, device="cpu", dtype="float32").score_all(X)
    served = {}
    for (route, m), got in responses["float32"].items():
        for key in OUTPUTS:
            served[key] = max(served.get(key, 0.0), _nan_err(plain[m][key], got[key], f"{route} {m} {key}"))
    check(all(v <= TOLERANCE for v in served.values()), f"served chain C within {TOLERANCE} of the CPU: {served}")
    worst = {}
    for dtype in ("bfloat16", "int8"):
        w = {}
        for key, ref in responses["float32"].items():
            for k, bound_ in PRECISION_BOUNDS[dtype].items():
                e = _nan_err(ref[k], responses[dtype][key][k], f"{dtype} {key} {k}")
                if key[1].startswith("a-"):
                    check(e == 0.0, f"chain A at {dtype} is its f32 answer: {key} {k} {e}")
                check(e <= bound_, f"{dtype} {key} {k}: {e:.4%} of f32, over {bound_:.0%}")
                w[f"{key[0]} {k}"] = max(w.get(f"{key[0]} {k}", 0.0), e)
        worst[dtype] = w
    f32_bytes = dtypes["float32"]["resident_bytes"]
    for dtype in ("bfloat16", "int8"):
        check(dtypes[dtype]["resident_bytes"] < 0.55 * f32_bytes,
              f"{dtype} chain-C bucket resident {dtypes[dtype]['resident_bytes']} of f32's {f32_bytes}")
    out.update({"served_max_norm_err_vs_cpu": served, "max_norm_err_vs_f32": worst, "dtypes": dtypes,
                "machines": M, "rows": n, "tags": F, "k": CHAIN_C_K, "subset": TRANSFORM_SERVE_SUBSET,
                "singles": singles})


def _transform_stream(tmp, rng, out):
    """TRANSFORM_STREAM's chain-C detectors with a window of 144 rows
    streamed through the hub at f32 and bf16, every steady-state verdict
    held bit for bit to the request path."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.serve.server import ModelCollection
    from gordo_tpu_torch.serve.stream import reference_verdict

    n_m, n_rows, F = TRANSFORM_STREAM["machines"], TRANSFORM_STREAM["rows"], TRANSFORM_SERVE_SHAPE[2]
    src = random_chain_c(rng, n_m, F, CHAIN_C_K)
    for i in range(n_m):
        serializer.dump(chain_c_detector(src, i, with_window(CHAIN_C)), os.path.join(tmp, f"s-{i}"))
    X = request_rows(rng, n_m, n_rows, F)
    counters = _transform_serve_counters()
    info = {}
    for dtype in ("float32", "bfloat16"):
        with serve_dtype_env(dtype):
            collection = ModelCollection.from_directory(tmp, project="stream", device=None if DEVICE == "cuda" else DEVICE)
        hub = collection.stream_hub
        verdicts = {i: {} for i in range(n_m)}
        _zero(counters)
        t0 = time.perf_counter()
        for r in range(n_rows):
            for i in range(n_m):
                for ev in hub.ingest_rows(f"s-{i}", collection.get(f"s-{i}").scorer, X[i, r], dtype=dtype):
                    if ev["type"] == "verdict":
                        verdicts[i][ev["data"]["step"]] = ev["data"]
        seconds = time.perf_counter() - t0
        launches = _read(counters)
        if DEVICE == "cuda":
            steps = n_m * n_rows
            want = {"stream_shift": steps, "chain_apply": steps, "stream_step": steps, "fleet_score": 0,
                    "chain_apply_bf16": steps if dtype != "float32" else 0}
            got = {k: launches[k] for k in want}
            check(got == want, f"{dtype} transform stream launches {got}, expected {want}")
        checked = 0
        for i in range(n_m):
            scorer = collection.get(f"s-{i}").scorer
            H = hub.streams[f"s-{i}"].state_rows
            check(H == SMOOTH_WINDOW, f"ring of {H} rows")
            for t in range(H, n_rows + 1):
                ref = reference_verdict(scorer, X[i, t - H:t])
                v = verdicts[i][t]
                got = {"tag-anomaly-scores": np.asarray(v["tag-anomaly-scores"], np.float32),
                       "total-anomaly-score": np.float32(v["total-anomaly-score"]),
                       "anomaly-confidence": np.float32(v["anomaly-confidence"])}
                for key in ref:
                    check(same_bits(ref[key], got[key]),
                          f"{dtype} s-{i} step {t} {key}: the streamed verdict is the request path's bit for bit")
                checked += 1
        info[dtype] = {"launches": launches, "seconds": seconds, "step_seconds": seconds / (n_m * n_rows),
                       "verdicts_checked_bitwise": checked}
        if DEVICE == "cuda":
            info[dtype].update(_chain_stream_kernel_ms(hub, collection, X[0], dtype))
            info[dtype].update(chain_stream_bound(src, F, 2 if dtype == "bfloat16" else 4))
        del collection
    out["stream"] = {"machines": n_m, "rows": n_rows, "window": SMOOTH_WINDOW, **info}


#: rows a streamed chain-C machine takes under the profiler for the device
#: time of a row's launches
CHAIN_STREAM_TIMED_ROWS = 20


def _chain_stream_kernel_ms(hub, collection, rows, dtype) -> dict:
    """Device time of one streamed chain-C row's launches (the ring's shift,
    ``chain_apply`` over the ring, ``stream_step``), summed over its kernels
    by ``torch.profiler`` across CHAIN_STREAM_TIMED_ROWS rows of machine 0."""
    from torch.profiler import ProfilerActivity, profile

    scorer = collection.get("s-0").scorer
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(CHAIN_STREAM_TIMED_ROWS):
            list(hub.ingest_rows("s-0", scorer, rows[r % len(rows)], dtype=dtype))
        torch.cuda.synchronize()
    by_kernel, copies = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            ms = e.self_device_time_total / 1e3 / CHAIN_STREAM_TIMED_ROWS
            if e.key.startswith("Memcpy"):
                copies += ms
            else:
                by_kernel[e.key[:60]] = ms
    check(bool(by_kernel), "the profiler saw the streamed rows' kernels")
    return {"kernel_ms": sum(by_kernel.values()), "kernel_ms_by_name": by_kernel, "copy_ms": copies}


def chain_stream_bound(src, tags: int, elem: int) -> dict:
    """Least time of one streamed chain-C row: the shift (the ring read and
    written, the new row), ``chain_apply`` over the ring's newest row (read,
    the chain's output written, its stats read once; the PCA's operations),
    and ``stream_step`` on that row's output with the carried tag scores
    (``stream_bound``), stats and weights at the storage width ``elem``."""
    H, k, dims = SMOOTH_WINDOW, CHAIN_C_K, src["dims"]
    chain_bytes = 4 * (tags + k) + elem * (2 * tags + tags * k + 2 * k)
    chain_ops = tags + 2 * tags * k + 2 * k
    step = stream_bound(H, k, SMOOTH_WINDOW, dims, elem, False, rows=1)
    b = bound(step["bytes"] + chain_bytes + 4 * (2 * H * tags + tags), step["flops"] + chain_ops)
    return {"kernel_bound_ms": b["bound_ms"], "kernel_bound_by": b["bound_by"]}


def chain_c_project(machines: int, rows: int, tags: int) -> str:
    """A RandomDataset project YAML of ``machines`` chain-C detectors."""
    from gordo_tpu_torch.bench import project_config

    lines = []
    for line in project_config(machines, tags, rows, seed=13).splitlines():
        lines.append(line)
        if line.startswith("    dataset: {tag_list"):
            lines.append(f"    model: {json.dumps(CHAIN_C)}")
    return "\n".join(lines) + "\n"


def _transform_built(tmp, rng, out):
    """TRANSFORM_BUILT chain-C machines built through build-project's
    singles pass on the card, served in one bulk request (one bucket: one
    chain_apply and one fleet_score), held to the plain scorer on the CPU."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.dataset.base import GordoBaseDataset
    from gordo_tpu_torch.serve.server import ModelCollection
    from gordo_tpu_torch.workflow.config import NormalizedConfig

    tags = TRANSFORM_SERVE_SHAPE[2]
    config = NormalizedConfig.from_source(chain_c_project(TRANSFORM_BUILT, TRANSFORM_ROWS, tags), "chain-c")
    device = None if DEVICE == "cuda" else DEVICE
    out_dir = os.path.join(tmp, "built")
    t0 = time.perf_counter()
    result = build_project(config.machines, out_dir, device=device)
    seconds = time.perf_counter() - t0
    check(not result.failed and len(result.single_built) == TRANSFORM_BUILT,
          f"build_project built {len(result.single_built)} of {TRANSFORM_BUILT} singles: {result.failed}")
    X = {}
    for m in config.machines:
        rows = np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)
        Q = rows[-TRANSFORM_REQUEST_ROWS:].copy()
        Q[rng.random(Q.shape) < 0.02] = np.nan
        X[m.name] = Q
    collection = ModelCollection.from_directory(out_dir, project="chain-c", device=device)
    check(len(collection.fleet_scorer.buckets) == 1 and not collection.fleet_scorer.fallbacks,
          "the built chain-C machines share one bucket")
    counters = _transform_serve_counters()
    _zero(counters)
    ((status, body, request_seconds),) = _serve_http(
        collection, [("_bulk/anomaly/prediction", json.dumps({"X": {k: v.tolist() for k, v in X.items()}}).encode())])
    launches = _read(counters)
    check(status == 200, "built chain C bulk request answered 200")
    if DEVICE == "cuda":
        check(launches["chain_apply"] == 1 and launches["fleet_score"] == 1,
              f"built chain C: one chain_apply and one fleet_score, got {launches}")
    served = {}
    for name, Q in X.items():
        ref = serializer.load(os.path.join(out_dir, name)).anomaly(Q, device="cpu")
        for key in OUTPUTS:
            served[key] = max(served.get(key, 0.0), _nan_err(ref[key], body["data"][name][key], f"{name} {key}"))
    check(all(v <= TOLERANCE for v in served.values()), f"built chain C served within {TOLERANCE}: {served}")
    out["built"] = {"machines": TRANSFORM_BUILT, "rows": TRANSFORM_ROWS, "build_seconds": seconds,
                    "request_seconds": request_seconds, "launches": launches, "served_max_norm_err": served}


def _lstm_chain(tmp, rng, out):
    """LSTM_CHAIN_SHAPE's LSTM detectors behind (SimpleImputer(mean), PCA())
    scored as one bucket through the fleet scorer (one chain_apply, one
    lstm_layer per layer, one fleet_score), two held to the plain scorer
    on the CPU; one streamed, each steady-state verdict held bit for bit
    to the request path."""
    from gordo_tpu_torch import convert
    from gordo_tpu_torch.serve.fleet_scorer import FleetScorer
    from gordo_tpu_torch.serve.scorer import CompiledScorer
    from gordo_tpu_torch.serve.stream import MachineStream, reference_verdict

    M, n, F = LSTM_CHAIN_SHAPE
    net = random_lstm(rng, M, F)
    q, _ = np.linalg.qr(rng.standard_normal((M, F, F)))
    fill = (0.2 * rng.standard_normal((M, F))).astype(np.float32)
    mean = (0.1 * rng.standard_normal((M, F))).astype(np.float32)
    device = None if DEVICE == "cuda" else DEVICE
    models = {}
    for i in range(M):
        models[f"l-{i}"] = convert.from_reference(
            LSTM_CHAIN, lstm_params(net, i),
            scaler_stats=[{"fill": fill[i]}, {"mean": mean[i], "components": q[i].astype(np.float32)}],
            detector_stats={"scale": net["det_scale"][i], "offset": net["det_offset"][i]},
            feature_thresholds=net["feature_thresholds"][i], aggregate_threshold=float(net["agg"][i]))
    X = dict(zip(models, request_rows(rng, M, n, F)))
    fleet = FleetScorer.from_models(models, device=device, dtype="float32")
    check(len(fleet.buckets) == 1 and not fleet.fallbacks, "the LSTM chain bucket")
    counters = _transform_serve_counters()
    fleet.score_all(X)  # a first request loads the kernels, outside the count
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    got = fleet.score_all(X)
    seconds = time.perf_counter() - t0
    launches = _read(counters)
    n_cells = len(net["cells"])
    if DEVICE == "cuda":
        want = {"chain_apply": 1, "lstm_layer": n_cells, "fleet_score": 1}
        check({k: launches[k] for k in want} == want, f"LSTM chain bucket launches {launches}, expected {want}")
    served = {}
    for name in list(models)[:LSTM_CHAIN_CHECKED]:
        ref = models[name].anomaly(X[name], device="cpu")
        for key in OUTPUTS:
            served[key] = max(served.get(key, 0.0), _nan_err(ref[key], got[name][key], f"{name} {key}"))
    check(all(v <= LSTM_SERVE_TOLERANCE for v in served.values()),
          f"LSTM chain served within {LSTM_SERVE_TOLERANCE} of the CPU: {served}")
    scorer = CompiledScorer(models["l-0"], device=device)
    ms = MachineStream("l-0", scorer)
    rows = X["l-0"][:LSTM_CHAIN_STREAM_ROWS]
    _zero(counters)
    verdicts = [ms.ingest(row) for row in rows]
    stream_launches = _read(counters)
    if DEVICE == "cuda":
        want = {"stream_shift": len(rows), "chain_apply": len(rows), "lstm_layer": n_cells * len(rows),
                "stream_step": len(rows), "fleet_score": 0}
        check({k: stream_launches[k] for k in want} == want, f"LSTM chain stream launches {stream_launches}")
    checked = 0
    for t in range(ms.state_rows, len(rows) + 1):
        ref = reference_verdict(scorer, rows[t - ms.state_rows: t])
        for key in ref:
            check(same_bits(ref[key], verdicts[t - 1][key]), f"LSTM chain stream step {t} {key}: bit for bit the request path")
        checked += 1
    out["lstm_chain"] = {"shape": list(LSTM_CHAIN_SHAPE), "lookback": LOOKBACK, "bucket_seconds": seconds,
                         "launches": launches, "served_max_norm_err": served,
                         "stream": {"rows": len(rows), "state_rows": ms.state_rows,
                                    "verdicts_checked_bitwise": checked, "launches": stream_launches}}


def transform_serve_summary(summary: list, kernels: dict, ts_out: dict) -> None:
    """The ``kernels`` line's part of the transform-serving path: every
    kernel's launches there, and the stacked float32 and the bf16 launches
    of ``chain_apply`` as entries of their own, which the ``chain_apply``
    entry (one set of stats at float32) then does not count."""
    from gordo_tpu_torch.kernels import chain_apply as ca

    ts = transform_serve_launches(ts_out)
    if DEVICE == "cuda":
        for name in ("chain_apply", "chain_apply_stacked", "chain_apply_bf16", "fleet_score", "fleet_score_bf16",
                     "lstm_layer", "stream_step", "stream_shift", "fake_quant"):
            check(ts[name] > 0, f"{name} launched on the transform-serving path")
    for entry in summary:
        name = entry["name"]
        if name in ts:
            entry["launches_by_path"]["transform_serve"] = ts[name] + (
                ts["stream_shift"] if name == "stream_step" else 0) - (
                ts["chain_apply_stacked"] + ts["chain_apply_bf16"] if name == "chain_apply" else 0)
        entry["launches"] = sum(entry["launches_by_path"].values())
    for name, key, variants, launches in (
        ("chain_apply_stacked", "float32", ("float32", "subset_float32"), ts["chain_apply_stacked"]),
        ("chain_apply_bf16", "bfloat16", ("bfloat16", "bfloat16_out", "int8", "subset_bfloat16"),
         ts["chain_apply_bf16"]),
    ):
        entry = kernels[key]
        summary.append({
            "name": name, "route": "cuda", "source": ca.SOURCE, "replaces": "gordo_tpu/serve/fleet_scorer.py:76",
            "launches": launches, "launches_by_path": {"transform_serve": launches},
            "max_abs_err": max(kernels[v]["max_abs_err"] for v in variants),
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            # no one PyTorch call runs a transform chain; the sequence of
            # library calls that computes chain C is timed beside it
            "library_ms": None,
            "comparison_ms": kernels["float32"].get("comparison_ms"),
            "comparison": kernels["float32"]["comparison"],
            "shape": [*TRANSFORM_SERVE_SHAPE, "chain C", f"k {CHAIN_C_K}"], "storage": entry["storage"],
            "variants": {v: {f: kernels[v].get(f) for f in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "max_norm_err", "slots", "rows", "out")}
                         for v in variants},
        })


def transform_serve_launches(ts: dict) -> dict:
    """Every kernel's launches on the transform-serving path: the requests
    at each dtype (and int8's quantisation at load), the streams, the
    built machines' request and the LSTM chain's bucket and stream."""
    runs = []
    for info in ts["dtypes"].values():
        runs += [info["load_launches"], info["bulk_launches"], info["subset_launches"], info["single_launches"]]
    runs += [ts["stream"][d]["launches"] for d in ("float32", "bfloat16")]
    runs += [ts["built"]["launches"], ts["lstm_chain"]["launches"], ts["lstm_chain"]["stream"]["launches"]]
    total = {}
    for run in runs:
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_transform_serve():
    """Chain-C detectors served where the JAX package serves them fused: a
    directory of 512 of them and 4 chain-A fallbacks over HTTP at f32, bf16
    and int8 (a bulk request of every machine × 2048 rows with NaN cells,
    a subset of 64, per-machine requests; launches counted, set to 0 just
    before each; held to the plain scorer on the CPU at f32 and to the f32
    answer at reduced precision; the bucket's resident bytes), a stream of
    4 at f32 and bf16, 16 built through build-project's singles pass and
    served, and an LSTM bucket behind (SimpleImputer, PCA) at 64 × 4096 ×
    50 scored and streamed."""
    rng = np.random.default_rng(SEED + 43)
    out = {}
    for part in (_transform_served, _transform_stream, _transform_built, _lstm_chain):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tserve_") as tmp:
            t0 = time.perf_counter()
            part(tmp, rng, out)
            out[f"{part.__name__.strip('_')}_seconds"] = time.perf_counter() - t0
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Pipeline containers: the target inverses and the epilogue alone
# ---------------------------------------------------------------------------

#: (slots, rows, tags) of the container kernel check: one request of the
#: path (one machine × 2048 rows × 10 tags), one 128-tag machine and a
#: stacked bucket of 512 such requests, where the time means something
#: against the bound
CONTAINER_SHAPES = [(1, 2048, 10), (1, 4096, 128), (512, 2048, 10)]
#: inverse forms and the epilogue against their plain versions, max |kernel
#: - plain| / max |plain|: the affine, centre and quantile inverses are the
#: same roundings (measured 0; ndtr's exp is taken in double on both sides:
#: with CUDA's expf, 7.5e-6 at Q 1,000, "NVIDIA H100 80GB HBM3, 700.00 W");
#: PCA_INV's dot sums in another order (fp32, measured 1.3e-7); the
#: epilogue sums the squared tags in another order (measured 1.1e-6)
CONTAINER_TOLERANCE = {"chain_apply_inverse": TRANSFORM_TOLERANCE["chain_apply"],
                       "fleet_score_epilogue": TOLERANCE}
#: the container build's fleet: gordo's default TTR (one of them with a
#: detector window), TTRs with a normal quantile target transformer, a
#: FeatureUnion pipeline and a MultiOutputRegressor
CONTAINER_FLEET = {"ttr": 8, "ttr_quantile": 4, "union": 2, "mor": 2}
CONTAINER_ROWS = 576
CONTAINER_REQUEST_ROWS = 2048
CONTAINER_WINDOW = 144
_AUTOENCODER = {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}}


def _container_model(kind: str, window: int = 0) -> dict:
    """A detector definition of the container build, by the reference's
    (sklearn) paths, as a project YAML of gordo names them."""
    if kind in ("ttr", "ttr_quantile"):
        transformer = ("sklearn.preprocessing.MinMaxScaler" if kind == "ttr" else
                       {"sklearn.preprocessing.QuantileTransformer": {"n_quantiles": 100,
                                                                       "output_distribution": "normal"}})
        base = {"sklearn.compose.TransformedTargetRegressor": {
            "transformer": transformer,
            "regressor": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler",
                                                                   _AUTOENCODER]}}}}
    elif kind == "union":
        base = {"sklearn.pipeline.Pipeline": {"steps": [
            {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
                {"sklearn.decomposition.PCA": {"n_components": 4}}, "sklearn.preprocessing.MinMaxScaler"]}},
            _AUTOENCODER]}}
    else:
        base = {"sklearn.multioutput.MultiOutputRegressor": {"estimator": _AUTOENCODER}}
    detector = {"base_estimator": base}
    if window:
        detector["window"] = window
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": detector}


def container_kinds() -> list:
    """Each machine's kind in the container build, in the YAML's order."""
    return [k for k, n in CONTAINER_FLEET.items() for _ in range(n)]


def container_project(rows: int, tags: int) -> str:
    """The container build's project YAML: CONTAINER_FLEET's machines over
    their own ``tags`` RandomDataset tags and ``rows`` 10-minute rows, the
    first TTR with a detector window of CONTAINER_WINDOW rows."""
    from gordo_tpu_torch.bench import project_config

    kinds = container_kinds()
    models = [_container_model(k, CONTAINER_WINDOW if i == 0 else 0) for i, k in enumerate(kinds)]
    lines = []
    for line in project_config(len(kinds), tags, rows, seed=14).splitlines():
        lines.append(line)
        if line.startswith("    dataset: {tag_list"):
            lines.append(f"    model: {json.dumps(models.pop(0))}")
    return "\n".join(lines) + "\n"


def epilogue_bound(m: int, n: int, f: int, machines: int, thresholds: bool):
    """Least time for one epilogue-only fleet_score call: the prediction
    and the targets read once, the detector's stats (and thresholds) read
    once, the tag scores, totals (and confidences) written once; per value
    the two scalings, the difference, its magnitude and square and the sum
    (6 operations), per row the square root (and the division)."""
    nbytes = 4 * (2 * m * n * f + machines * (2 * f + int(thresholds)) + m * n * (f + 1 + int(thresholds)))
    return bound(nbytes, m * n * (6 * f + 1 + int(thresholds)))


def phase_container_kernel_check():
    """``chain_apply``'s inverse forms and the epilogue-only ``fleet_score``
    against their plain versions on the card, at CONTAINER_SHAPES: the
    MinMax inverse (CENTER), the Standard and Robust inverses (AFFINE),
    ``PCA_INV`` (k 8 → F 10, and k 128 → F 128 at the 128-tag shape) and
    ``QUANTILE_INV`` (uniform and normal, Q 100 and 1,000) on rows with NaN
    cells and values past the grid's ends, each with one set of stats and,
    at the stacked shape, each slot its own machine's; the epilogue with
    and without thresholds on predictions and targets with NaN cells.
    Times, bounds, the plain version's time and, where one PyTorch call
    computes the same function, that call's by the kernel's own events
    (``torch.addcmul`` for the affine inverse, ``torch.addmm``/
    ``torch.baddbmm`` for PCA_INV); a hash of every output."""
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import scaler_quantiles as sq

    rng = np.random.default_rng(SEED + 47)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)  # noqa: E731
    entries = {}

    def hold(name, run, plain, bound_info, tol, library=None, reps=20, plain_reps=3):
        """``library``: one PyTorch call computing the same function, timed
        as the kernel is (``time_ms``)."""
        got, ref = run(), plain()
        hashes = output_hashes(got)
        if isinstance(got, dict):
            keys = sorted(ref)
            check(sorted(got) == keys, f"{name}: outputs {sorted(got)} against {keys}")
            got, ref = [got[k] for k in keys], [ref[k] for k in keys]
        outs = list(got) if isinstance(got, (tuple, list)) else [got]
        refs = list(ref) if isinstance(ref, (tuple, list)) else [ref]
        errs, worst = [], 0.0
        for r, g in zip(refs, outs):
            e, a = _masked_err(r, g, name)
            errs.append(e)
            worst = max(worst, a)
        check(max(errs) <= tol, f"{name} within {tol}: {errs}")
        entry = {"max_norm_err": max(errs), "max_abs_err": worst, "tolerance": tol, **bound_info, "hashes": hashes}
        if DEVICE == "cuda":
            entry["ms"], entry["host_ms"] = time_ms(run, reps)
            entry["plain_ms"], entry["plain_host_ms"] = time_calls_ms(plain, plain_reps)
            entry["library_ms"] = None if library is None else time_ms(library, reps)[0]
        entries[name] = entry

    for m, n, f in CONTAINER_SHAPES:
        label = f"{m}x{n}x{f}"
        stacked = m > 1
        X = bench_fleet(rng, m, n, f)
        X[rng.random(X.shape) < 0.002] = np.nan
        lo, hi = np.nanmin(X, axis=1), np.nanmax(X, axis=1)                  # (m, f)
        scale = (1.0 / np.maximum(hi - lo, 1e-12)).astype(np.float32)
        mean, std = np.nanmean(X, axis=1), np.nanstd(X, axis=1) + 0.1

        def stats(a):
            """One machine's stats (F,) or each slot's own (m, F)."""
            return put(a if stacked else a[0])

        x = put(X if stacked else X[0])
        forms = {
            "minmax": [ca.Step(ca.CENTER, stats(-lo * scale), stats(scale), stacked=stacked)],
            "standard": [ca.Step(ca.AFFINE, stats(std), stats(mean), stacked=stacked)],
            "robust": [ca.Step(ca.AFFINE, stats(std * 1.3), stats(mean * 0.9), stacked=stacked)],
        }
        for name, steps in forms.items():
            library = None
            if name != "minmax":
                a, b = steps[0].a, steps[0].b
                library = (lambda a=a, b=b: torch.addcmul(b[:, None], x, a[:, None])) if stacked else (
                    lambda a=a, b=b: torch.addcmul(b, x, a))
            hold(f"{name}_inverse_{label}", lambda steps=steps: ca.chain_apply(x, steps),
                 lambda steps=steps: ca.chain_apply_plain(x, steps), chain_apply_bound(m * n, steps, f),
                 CONTAINER_TOLERANCE["chain_apply_inverse"], library=library,
                 plain_reps=1 if stacked else 3)
        # PCA's inverse: k components back to F
        k = 8 if f == 10 else f
        comps = np.linalg.qr(rng.standard_normal((m, f, f)))[0][:, :, :k].transpose(0, 2, 1)   # (m, k, f)
        Z = rng.standard_normal((m, n, k)).astype(np.float32)
        Z[rng.random(Z.shape) < 0.002] = np.nan
        z = put(Z if stacked else Z[0])
        pmean = rng.standard_normal((m, f))
        pca = [ca.Step(ca.PCA_INV, stats(pmean), put(comps if stacked else comps[0]), stacked=stacked)]
        library = ((lambda: torch.baddbmm(pca[0].a[:, None], z, pca[0].b)) if stacked
                   else (lambda: torch.addmm(pca[0].a, z, pca[0].b)))
        hold(f"pca_inv_k{k}_{label}", lambda: ca.chain_apply(z, pca), lambda: ca.chain_apply_plain(z, pca),
             chain_apply_bound(m * n, pca, k), CONTAINER_TOLERANCE["chain_apply_inverse"], library=library,
             plain_reps=1 if stacked else 3)
        # the quantile inverse: grids (quantised rows tie) from the kernel
        for q in (100, 1000):
            fracs = put(ca.percentile_fractions(q))
            Xq = np.round(X * 4) / 4
            grids = sq.scaler_quantiles_grid(put(Xq), [np.arange(n)], fracs)[:, 0].contiguous()  # (m, q, f)
            qs = put(ca.unit_linspace(q))
            qs_m = qs.expand(m, q).contiguous() if stacked else qs
            for normal in (False, True):
                if normal:
                    U = rng.standard_normal((m, n, f)) * 1.5
                    U[:, :4] = [[-9.0], [9.0], [-30.0], [0.0]]                        # far tails, the middle
                else:
                    U = rng.uniform(-0.05, 1.05, (m, n, f))                           # past both ends
                U[rng.random(U.shape) < 0.002] = np.nan
                u = put(U if stacked else U[0])
                steps = [ca.Step(ca.QUANTILE_INV, grids if stacked else grids[0], qs_m, normal=normal,
                                 stacked=stacked)]
                hold(f"quantile_inv_{'normal' if normal else 'uniform'}_q{q}_{label}",
                     lambda steps=steps, u=u: ca.chain_apply(u, steps),
                     lambda steps=steps, u=u: ca.chain_apply_plain(u, steps),
                     chain_apply_bound(m * n, steps, f), CONTAINER_TOLERANCE["chain_apply_inverse"],
                     plain_reps=1)
        if f != 10:
            continue
        # the epilogue alone, with and without thresholds
        pred = put(X + 0.05 * rng.standard_normal(X.shape))
        Y = X.copy()
        Y[rng.random(Y.shape) < 0.002] = np.nan
        y = put(Y)
        ds, do = put(scale), put(-lo * scale)
        thr = put(rng.uniform(0.5, 2.0, m))
        for with_thr in (False, True):
            kw = dict(det=minmax_step(ds, do), agg_thr=thr if with_thr else None, y=y)
            hold(f"epilogue_{'thresholds_' if with_thr else ''}{label}",
                 lambda kw=kw: fs.fleet_score(pred, [], [], **kw),
                 lambda kw=kw: fs.fleet_score_plain(pred, [], [], **kw),
                 epilogue_bound(m, n, f, m, with_thr), CONTAINER_TOLERANCE["fleet_score_epilogue"])
    pca_forms_check(rng, put, entries)
    emit({"phase": "container_kernel_check", "shapes": CONTAINER_SHAPES, "kernels": entries})
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return entries


#: the PCA forms' sweep: slots of 128 tags, their machines and valid rows,
#: the output's spare columns before the step's (a column range)
PCA_FORMS = {"rows": 512, "tags": 128, "idx": [2, 0, 1, 2], "n_rows": [512, 300, 1, 77], "out_col": 2,
             "ks": (1, 8, 10, 127, 128)}


def _sequential_fma(x: torch.Tensor, comps: torch.Tensor, mean: torch.Tensor, inverse: bool) -> torch.Tensor:
    """One machine's PCA (or PCA_INV) step as the kernel sums it: per output
    a chain of FMAs, c ascending (each in float64, rounded once), PCA_INV's
    mean added after, PCA's subtracted from each value first."""
    v = x if inverse else x - mean
    acc = torch.zeros((x.shape[0], comps.shape[1]), dtype=torch.float32, device=x.device)
    for c in range(comps.shape[0]):
        acc = (v[:, c:c + 1].double() * comps[c].double() + acc.double()).float()
    return acc + mean if inverse else acc


def pca_forms_check(rng, put, entries) -> None:
    """``chain_apply``'s PCA and PCA_INV steps at k in PCA_FORMS["ks"]
    against their plain version on the card: stacked slots with ``idx``,
    ``n_rows`` and a column range, at each instantiation (float32 rows and
    output; bf16 rows, float32 output; bf16 both), each slot's valid rows
    only; and PCA_INV at k 128 over 4,096 rows against the FMA chain it
    sums (its bits)."""
    from gordo_tpu_torch.kernels import chain_apply as ca

    n, f, idx, counts, col = (PCA_FORMS[k] for k in ("rows", "tags", "idx", "n_rows", "out_col"))
    machines = max(idx) + 1
    worst, hashes = {}, {}
    for k in PCA_FORMS["ks"]:
        comps = np.linalg.qr(rng.standard_normal((machines, f, f)))[0][:, :, :k].transpose(0, 2, 1)  # (M, k, f)
        mean = rng.standard_normal((machines, f))
        for form, w_in, w_out, b in ((ca.PCA, f, k, comps.transpose(0, 2, 1)), (ca.PCA_INV, k, f, comps)):
            X = bench_fleet(rng, len(idx), n, w_in) * 3
            X[rng.random(X.shape) < 0.002] = np.nan
            for store, out_dtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)):
                steps = [ca.Step(form, put(mean).to(store), put(b).to(store), stacked=True)]
                x = put(X).to(store)
                kw = dict(idx=idx, n_rows=counts, out_dtype=out_dtype, out_col=col)
                out = lambda: torch.zeros((len(idx), n, w_out + col + 1), dtype=out_dtype, device=DEVICE)  # noqa: E731
                got = ca.chain_apply(x, steps, out=out(), **kw)
                ref = ca.chain_apply_plain(x, steps, out=out(), **kw)
                valid = torch.zeros((len(idx), n), dtype=torch.bool, device=DEVICE)
                for slot, c in enumerate(counts):
                    valid[slot, :c] = True
                name = f"{ca.FORM_NAMES[form]}_k{k}_{str(store)[6:]}_to_{str(out_dtype)[6:]}"
                check(bool((got[..., :col] == 0).all() and (got[..., col + w_out:] == 0).all()),
                      f"{name}: only its column range written")
                e, _ = _masked_err(ref[..., col:col + w_out][valid].float(), got[..., col:col + w_out][valid].float(),
                                   name)
                tol = (TRANSFORM_SERVE_TOLERANCE["bfloat16_out"] if out_dtype == torch.bfloat16
                       else TRANSFORM_TOLERANCE["chain_apply"])
                check(e <= tol, f"{name} within {tol}: {e}")
                worst[name] = e
                hashes[name] = output_hash(got[..., col:col + w_out][valid].float())
    # the register-tiled product sums each output as the FMA chain it replaced
    comps = put(np.linalg.qr(rng.standard_normal((128, 128)))[0].T)    # (k, F)
    z = put(rng.standard_normal((4096, 128)))
    pmean = put(rng.standard_normal(128))
    got = ca.chain_apply(z, [ca.Step(ca.PCA_INV, pmean, comps)])
    ref = _sequential_fma(z, comps, pmean, inverse=True)
    mismatched = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    check(mismatched == 0, f"PCA_INV k 128: {mismatched} outputs differ from the FMA chain's bits")
    entries["pca_forms"] = {"max_norm_err": worst, "cases": len(worst), "pca_inv_k128_fma_chain_mismatches": mismatched,
                            "hashes": hashes}


def _container_counters():
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import rolling_median as rm

    return {**_transform_counters(), "chain_apply_inverse": (ca, "inverse_launches"),
            "fleet_score_epilogue": (fs, "epilogue_launches"), "rolling_median": (rm, "launches")}


#: the counters read after each request of the container build
_REQUEST_COUNTERS = ("chain_apply", "chain_apply_inverse", "fleet_score", "fleet_score_epilogue", "rolling_median")


def _container_expected_launches(kinds, tags: int) -> dict:
    """The container build's launches: per machine 3 fold fits and the
    final fit (TimeSeriesSplit(3)), each one fleet_init and one fleet_fit
    per AutoEncoder (a MultiOutputRegressor's one a column) with its
    transforms' statistics and ``chain_apply`` launches, each fold's
    scoring request and the detector scaler's MinMax statistics twice
    (cross-validation and the final fit).  A TTR's fit: the target's
    statistic and transform, the pipeline MinMax's statistic and transform;
    its request: the model output, the inverse, the epilogue.  A
    FeatureUnion's fit: PCA's mean, centring and (SVD) components, MinMax's
    statistic, a ``chain_apply`` per branch; its request the two branches
    and one ``fleet_score``.  A MultiOutputRegressor's request: one model
    launch over its columns, stacked as machines, and the epilogue."""
    folds, fits = 3, 4
    want = {k: 0 for k in ("fleet_fit", "fleet_init", "fleet_score", "fleet_score_epilogue", "chain_apply",
                           "chain_apply_inverse",
                           "scaler_stats", "scaler_stats_mean", "scaler_quantiles_grid", "cv_epilogue",
                           "scaler_quantiles", "scaler_stats_standard", "rolling_median")}
    for kind in kinds:
        models = tags if kind == "mor" else 1
        want["fleet_fit"] += fits * models
        want["fleet_init"] += fits * models
        want["scaler_stats"] += 2
        if kind in ("ttr", "ttr_quantile"):
            want["scaler_stats"] += fits * (2 if kind == "ttr" else 1)
            want["scaler_quantiles_grid"] += fits * (kind == "ttr_quantile")
            want["chain_apply"] += 2 * fits + folds
            want["chain_apply_inverse"] += folds
            want["fleet_score"] += 2 * folds
            want["fleet_score_epilogue"] += folds
        elif kind == "union":
            want["scaler_stats"] += 2 * fits
            want["scaler_stats_mean"] += fits
            want["chain_apply"] += 3 * fits + 2 * folds
            want["fleet_score"] += folds
        else:
            want["fleet_score"] += 2 * folds
            want["fleet_score_epilogue"] += folds
    return want


def _request_launches(kind: str, tags: int, window: bool) -> dict:
    """One request's launches on a machine of ``kind``."""
    if kind in ("ttr", "ttr_quantile"):
        out = {"chain_apply": 1, "chain_apply_inverse": 1, "fleet_score": 2, "fleet_score_epilogue": 1}
    elif kind == "union":
        out = {"chain_apply": 2, "chain_apply_inverse": 0, "fleet_score": 1, "fleet_score_epilogue": 0}
    else:
        out = {"chain_apply": 0, "chain_apply_inverse": 0, "fleet_score": 2, "fleet_score_epilogue": 1}
    out["rolling_median"] = int(window)
    return out


def phase_container_build():
    """``build_project`` of a 16-machine RandomDataset YAML of CONTAINER_FLEET
    (CONTAINER_ROWS × 10 tags) through build-project's singles pass on the
    card (seconds, stage split, busy share, launches of every kernel set to
    0 just before, held exactly), the same machines built again with every
    kernel of the path swapped for its plain version on the card and held
    per machine; then the model directory served over HTTP at float32 and
    bfloat16, a per-machine anomaly request of CONTAINER_REQUEST_ROWS rows
    with NaN cells for every machine (its launches held exactly: a TTR's
    three, four with the window) and one bulk request of all of them; the
    bf16 answers bit for bit the f32 ones (these chains serve at float32,
    as the reference's model path does), every answer held to the plain
    scorer on the CPU, and a stream bind on a TTR refused with 422."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.bench import busy_share
    from gordo_tpu_torch.builder.build_model import build_model
    from gordo_tpu_torch.builder.fleet_build import build_project
    from gordo_tpu_torch.dataset.base import GordoBaseDataset
    from gordo_tpu_torch.serve.server import ModelCollection, make_server
    from gordo_tpu_torch.workflow.config import NormalizedConfig

    kinds, tags = container_kinds(), 10
    machines = len(kinds)
    device = None if DEVICE == "cuda" else DEVICE
    counters = _container_counters()
    config = NormalizedConfig.from_source(container_project(CONTAINER_ROWS, tags), "containers")
    kind_of = {m.name: k for m, k in zip(config.machines, kinds)}
    windowed = config.machines[0].name
    with tempfile.TemporaryDirectory(prefix="chip_smoke_containers_") as tmp:
        # a first build of one machine of each kind loads cuSOLVER and the
        # kernels, outside the counted build
        firsts = [next(m for m in config.machines if kind_of[m.name] == k) for k in CONTAINER_FLEET]
        build_project(firsts, os.path.join(tmp, "warm"), device=device)
        out_dir = os.path.join(tmp, "models")
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        timed = busy_share(lambda: build_project(config.machines, out_dir, device=device),
                           DEVICE if DEVICE == "cuda" else "cpu")
        result = timed["result"]
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        check(not result.failed and len(result.single_built) == machines and not result.fleet_built,
              f"build_project built {len(result.single_built)} of {machines} singles: {result.failed}")
        if DEVICE == "cuda":
            want = _container_expected_launches(kinds, tags)
            check(launches == want, f"container build launches {launches}, expected {want}")
        models = {n: serializer.load(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))
                  if serializer.is_artifact_dir(os.path.join(out_dir, n))}
        check(len(models) == machines, f"{len(models)} artifacts written")
        for n, det in models.items():
            check(bool(np.isfinite(det.feature_thresholds_).all()), f"finite thresholds of {n}")
            check(type(det.base_estimator).__name__ == {
                "ttr": "TransformedTargetRegressor", "ttr_quantile": "TransformedTargetRegressor",
                "union": "Pipeline", "mor": "MultiOutputRegressor"}[kind_of[n]], f"{n}'s container")
        check(int(models[windowed].window or 0) == CONTAINER_WINDOW, "the windowed TTR keeps its window")
        singles_split = {"data": 0.0, "cross_validation": 0.0, "fit": 0.0}
        for n in models:
            meta = serializer.load_metadata(os.path.join(out_dir, n))["model"]
            singles_split["data"] += meta["data_query_duration_sec"]
            singles_split["cross_validation"] += meta["cross_validation_duration_sec"]
            singles_split["fit"] += meta["model_builder_duration_sec"]

        # the same machines through the plain versions on the card
        worst = {}
        t_plain = time.perf_counter()
        with plain_single_kernels():
            for m in config.machines:
                plain_det, _ = build_model(m.name, m.model, m.dataset, m.metadata, m.evaluation, device=device)
                ref, got = _transform_arrays(plain_det), _transform_arrays(models[m.name])
                for key, r in ref.items():
                    err = float(np.abs(r - got[key]).max() / max(np.abs(r).max(), 1e-30))
                    worst[key] = max(worst.get(key, 0.0), err)
        plain_seconds = time.perf_counter() - t_plain
        _check_worst(worst, TRANSFORM_BUILD_TOLERANCE, "container build against its plain program")

        data = {m.name: np.asarray(GordoBaseDataset.from_dict(dict(m.dataset)).get_data()[0], np.float32)
                for m in config.machines}
        requests = {}
        for i, n in enumerate(sorted(data)):
            X = np.resize(data[n], (CONTAINER_REQUEST_ROWS, tags)).copy()
            X[3 + i % 5, i % tags] = X[len(X) // 2 + i, (i + 3) % tags] = np.nan     # sensor dropouts
            requests[n] = X
        answers, stream, request_seconds = {}, None, {}
        per_request = {}
        for dtype in ("float32", "bfloat16"):
            collection = ModelCollection.from_directory(out_dir, project="containers", device=device,
                                                        serve_dtype=dtype)
            server = make_server(collection, "127.0.0.1", 0)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{server.server_address[1]}/gordo/v0/containers"
            try:
                single, t0 = {}, time.perf_counter()
                for n, X in requests.items():
                    for mod, attr in counters.values():
                        setattr(mod, attr, 0)
                    single[n] = _request(f"{base}/{n}/anomaly/prediction", {"X": X.tolist()})
                    per_request.setdefault(n, {})[dtype] = {
                        name: getattr(counters[name][0], counters[name][1]) for name in _REQUEST_COUNTERS}
                single_seconds = (time.perf_counter() - t0) / len(requests)
                for mod, attr in counters.values():
                    setattr(mod, attr, 0)
                t1 = time.perf_counter()
                status, body = _request(f"{base}/_bulk/anomaly/prediction",
                                        {"X": {n: X.tolist() for n, X in requests.items()}})
                bulk_seconds = time.perf_counter() - t1
                bulk_launches = {name: getattr(counters[name][0], counters[name][1]) for name in _REQUEST_COUNTERS}
                if dtype == "float32":
                    stream = _request(f"{base}/stream/ingest", {"machine": windowed, "x": requests[windowed][:2].tolist()})
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            check(not thread.is_alive(), "server thread stopped")
            check(collection.serve_dtype == dtype and sorted(collection.fleet_scorer.fallbacks) == sorted(models),
                  f"every container machine served one by one at {dtype}")
            check(status == 200 and all(st == 200 for st, _ in single.values()), f"container requests 200 ({dtype})")
            answers[dtype] = {n: (single[n][1]["data"], body["data"][n]) for n in requests}
            request_seconds[dtype] = {"single": single_seconds, "bulk": bulk_seconds, "bulk_launches": bulk_launches}
        if DEVICE == "cuda":
            for n in requests:
                want = _request_launches(kind_of[n], tags, n == windowed)
                for dtype in answers:
                    check(per_request[n][dtype] == want,
                          f"{n} ({kind_of[n]}, {dtype}) request launches {per_request[n][dtype]}, expected {want}")
            want_bulk = {}
            for n in requests:
                for k, v in _request_launches(kind_of[n], tags, n == windowed).items():
                    want_bulk[k] = want_bulk.get(k, 0) + v
            for dtype, info in request_seconds.items():
                check(info["bulk_launches"] == want_bulk,
                      f"bulk request launches at {dtype} {info['bulk_launches']}, expected {want_bulk}")
        check(stream[0] == 422 and "no fused anomaly chain" in str(stream[1]),
              f"a stream bind on a TTR refused with 422: {stream}")
        served = {}
        for n, X in requests.items():
            ref = models[n].anomaly(X, device="cpu")
            f32_single = answers["float32"][n][0]
            for dtype, per_machine in answers.items():
                for label, got_all in zip(("single", "bulk"), per_machine[n]):
                    for k in OUTPUTS:
                        g = np.asarray(got_all[k], np.float64)
                        check(np.array_equal(g, np.asarray(f32_single[k], np.float64), equal_nan=True),
                              f"{n} {k} at {dtype} ({label}) bit for bit the f32 answer")
                        r = torch.from_numpy(np.asarray(ref[k], np.float64))
                        check(g.shape == tuple(r.shape), f"served {k} of {n} ({label})")
                        err, _ = _masked_err(r, torch.from_numpy(g), f"served {k} of {n} ({label})")
                        served[k] = max(served.get(k, 0.0), err)
        check(all(v <= TOLERANCE for v in served.values()), f"served containers within {TOLERANCE}: {served}")
    # every request's launches, single and bulk at both dtypes
    request_launches = {}
    for info in request_seconds.values():
        for name, v in info["bulk_launches"].items():
            request_launches[name] = request_launches.get(name, 0) + v
    for n in requests:
        for counts in per_request[n].values():
            for name, v in counts.items():
                request_launches[name] += v
    return {
        "machines": machines, "rows": CONTAINER_ROWS, "tags": tags, "fleet": CONTAINER_FLEET,
        "window": CONTAINER_WINDOW, "build_seconds": result.seconds,
        "models_per_hour": machines / result.seconds * 3600, "stage_seconds": dict(result.stage_seconds),
        "singles_seconds": singles_split, "busy_share": timed["busy_share"],
        "kernel_seconds": timed["kernel_seconds"], "launches": launches,
        "plain_build_seconds": plain_seconds, "vs_plain_max_norm_err": worst,
        "request_rows": CONTAINER_REQUEST_ROWS, "request_seconds": request_seconds,
        "request_launches": request_launches,
        "stream_bind": {"status": stream[0], "error": str(stream[1])},
        "served_max_norm_err": served,
    }


def container_summary(summary: list, kernels: dict, build: dict) -> None:
    """The ``kernels`` line's part of the container path: every kernel's
    launches in the container build and its requests (``chain_apply``'s
    without the inverses, ``fleet_score``'s without the epilogue alone),
    and ``chain_apply_inverse`` and ``fleet_score_epilogue`` as entries of
    their own, each launch counted by its wrapper."""
    from gordo_tpu_torch.kernels import chain_apply as ca
    from gordo_tpu_torch.kernels import fleet_score as fs

    inverse = build["launches"]["chain_apply_inverse"] + build["request_launches"]["chain_apply_inverse"]
    epilogue = build["launches"]["fleet_score_epilogue"] + build["request_launches"]["fleet_score_epilogue"]
    if DEVICE == "cuda":
        check(inverse > 0 and epilogue > 0, "the container path launched the inverse and the epilogue alone")
    for entry in summary:
        name = entry["name"]
        if name in build["launches"]:
            entry["launches_by_path"]["container_build"] = build["launches"][name] + build["request_launches"].get(
                name, 0) - (inverse if name == "chain_apply" else 0) - (epilogue if name == "fleet_score" else 0)
        entry["launches"] = sum(entry["launches_by_path"].values())
    path = f"{CONTAINER_SHAPES[0][0]}x{CONTAINER_SHAPES[0][1]}x{CONTAINER_SHAPES[0][2]}"
    for name, mod, replaces, head, kinds, launches, shape in (
        ("chain_apply_inverse", ca, "gordo_tpu/ops/scalers.py:262", f"quantile_inv_normal_q100_{path}",
         ("minmax", "standard", "robust", "pca_inv", "quantile_inv"), inverse,
         [*CONTAINER_SHAPES[0], "QUANTILE_INV, normal output, Q 100"]),
        ("fleet_score_epilogue", fs, "gordo_tpu/anomaly/diff.py:42", f"epilogue_thresholds_{path}",
         ("epilogue",), epilogue, [*CONTAINER_SHAPES[0], "epilogue alone, with thresholds"]),
    ):
        entry = kernels[head]
        variants = {k: {f: e.get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                               "max_norm_err")}
                    for k, e in kernels.items() if k.startswith(kinds)}
        summary.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": replaces,
            "launches": launches, "launches_by_path": {"container_build": launches},
            "max_abs_err": max(kernels[k]["max_abs_err"] for k in variants),
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            # no one PyTorch call computes the quantile inverse's ndtr and
            # interp or the epilogue; torch.addcmul and torch.addmm stand
            # beside the affine and PCA inverses among the variants
            "library_ms": entry["library_ms"], "shape": shape, "variants": variants,
        })


UNCENTRED_SHAPE = (64, 576, 10)
#: a level far from zero against the tags' spread (a pressure of 100 +- 1, a
#: temperature in kelvin), added to every tag
UNCENTRED_LEVEL = 1e3
#: the two chains, each with a Standard detector scaler
UNCENTRED_CHAINS = {
    "robust_minmax": ["gordo_tpu.ops.scalers.RobustScaler", "gordo_tpu.ops.scalers.MinMaxScaler"],
    "minmax_standard": ["gordo_tpu.ops.scalers.MinMaxScaler", "gordo_tpu.ops.scalers.StandardScaler"],
}
UNCENTRED_REQUEST_ROWS = 2048
UNCENTRED_SERVED = 4
UNCENTRED_STREAM = {"machines": 4, "rows": 24}
#: the builds held to their plain program on the card: the fits' tolerance,
#: each chain step's and the detector's stats as their kernels'
UNCENTRED_BUILD_TOLERANCE = {"params": TRAIN_TOLERANCE["fleet_fit"], "history": TRAIN_TOLERANCE["fleet_fit_history"],
                             "scaler": SCALER_TOLERANCE["standard"], "detector": SCALER_TOLERANCE["standard"],
                             **BUILD_TOLERANCE}


def uncentred_model(steps) -> dict:
    return {"gordo_tpu.anomaly.diff.DiffBasedAnomalyDetector": {
        "scaler": "gordo_tpu.ops.scalers.StandardScaler",
        "base_estimator": {"gordo_tpu.pipeline.Pipeline": {"steps": [
            *steps, {"gordo_tpu.models.estimator.AutoEncoder": {"kind": "feedforward_hourglass"}}]}}}}


def phase_uncentred_chain():
    """Scaler chains on uncentred columns: UNCENTRED_SHAPE's fleet (the
    bench's random tags plus UNCENTRED_LEVEL) as detectors of each of
    UNCENTRED_CHAINS, each step applied in turn in its own form by the
    kernels that load scaled rows (``csrc/scaler_prefix.cuh``).  Each chain
    is built twice, the second counted (seconds, launches of every kernel
    set to 0 just before), and held per machine to the same program through
    the plain versions on the card; UNCENTRED_SERVED machines served
    UNCENTRED_REQUEST_ROWS rows at float32 and at bfloat16, each held to
    the plain scorer on the CPU at the same dtype at TOLERANCE, one
    ``fleet_score`` launch a request (bf16 against f32 is recorded: rows of
    1e3 stored in bf16 keep steps of 4, far coarser than the tags' spread);
    UNCENTRED_STREAM rows streamed into a few, every verdict the request
    path's bit for bit."""
    from gordo_tpu_torch.kernels import fleet_score as fs
    from gordo_tpu_torch.kernels import stream_step as sk
    from gordo_tpu_torch.parallel.anomaly import FleetDiffBuilder, analyze_definition
    from gordo_tpu_torch.serializer import from_definition
    from gordo_tpu_torch.serve.scorer import CompiledScorer
    from gordo_tpu_torch.serve.stream import MachineStream, reference_verdict

    machines, rows, tags = UNCENTRED_SHAPE
    rng = np.random.default_rng(SEED + 53)
    Xs = list(bench_fleet(rng, machines, rows, tags) + np.float32(UNCENTRED_LEVEL))
    requests = bench_fleet(rng, UNCENTRED_SERVED, UNCENTRED_REQUEST_ROWS, tags) + np.float32(UNCENTRED_LEVEL)
    out = {"shape": list(UNCENTRED_SHAPE), "level": UNCENTRED_LEVEL, "launches": {}, "chains": {}}
    for name, steps in UNCENTRED_CHAINS.items():
        spec = analyze_definition(from_definition(uncentred_model(steps)))
        check(spec is not None, f"the {name} detector is fleetable")
        builder = FleetDiffBuilder(spec, device=DEVICE)
        detectors, info, pending = _build_counted(spec, builder, Xs, _ff_counters())
        for det in detectors:
            check(bool(np.isfinite(det.feature_thresholds_).all()), f"{name}: finite thresholds")
        worst, admitted = _hold_to_plain_program(spec, builder, pending, detectors, UNCENTRED_BUILD_TOLERANCE)
        _check_worst(worst, UNCENTRED_BUILD_TOLERANCE, f"{name} build against its plain program")
        info.update(vs_plain_max_norm_err=worst, vs_plain_held_to_one_ulp_movement=admitted)
        for key, n in info["launches"].items():
            out["launches"][key] = out["launches"].get(key, 0) + n

        served = {"float32": {}, "bfloat16": {}}
        bf16_err, per_request, seconds = {}, [], []
        for i in range(UNCENTRED_SERVED):
            X = requests[i]
            got = {}
            for dtype in served:
                scorer = CompiledScorer(detectors[i], device=None if DEVICE == "cuda" else DEVICE, dtype=dtype)
                fs.launches = 0
                t0 = time.perf_counter()
                got[dtype] = scorer.anomaly_arrays(X)
                seconds.append(time.perf_counter() - t0)
                per_request.append(fs.launches)
                ref = CompiledScorer(detectors[i], device="cpu", dtype=dtype).anomaly_arrays(X)
                for k, err in _served_error(ref, got[dtype], dict.fromkeys(OUTPUTS)).items():
                    served[dtype][k] = max(served[dtype].get(k, 0.0), err)
            for k, err in _served_error(got["float32"], got["bfloat16"], dict.fromkeys(OUTPUTS)).items():
                bf16_err[k] = max(bf16_err.get(k, 0.0), err)
        check(all(v <= TOLERANCE for d in served.values() for v in d.values()),
              f"{name}: served within {TOLERANCE} of the plain scorer: {served}")
        if DEVICE == "cuda":
            check(set(per_request) == {1}, f"{name}: one fleet_score launch a request, got {per_request}")
        out["launches"]["fleet_score"] = out["launches"].get("fleet_score", 0) + sum(per_request)

        sk.launches = 0
        checked = 0
        for i in range(UNCENTRED_STREAM["machines"]):
            scorer = CompiledScorer(detectors[i], device=None if DEVICE == "cuda" else DEVICE, dtype="float32")
            ms = MachineStream(f"{name}-{i}", scorer)
            H = ms.state_rows
            for t, row in enumerate(Xs[i][:UNCENTRED_STREAM["rows"]], start=1):
                v = ms.ingest(row)
                if t < H:
                    continue
                ref = reference_verdict(scorer, Xs[i][t - H:t])
                for k in ref:
                    check(np.asarray(v[k], np.float32).tobytes() == np.asarray(ref[k], np.float32).tobytes(),
                          f"{name} machine {i} step {t} {k}: the streamed verdict is the request path's bit for bit")
                checked += 1
        stream_launches = sk.launches
        if DEVICE == "cuda":
            want = UNCENTRED_STREAM["machines"] * UNCENTRED_STREAM["rows"]
            check(stream_launches == want, f"{name}: stream_step launched {stream_launches} times, expected {want}")
        out["launches"]["stream_step"] = out["launches"].get("stream_step", 0) + stream_launches
        info.update(served_machines=UNCENTRED_SERVED, request_rows=UNCENTRED_REQUEST_ROWS,
                    served_max_norm_err=served, bf16_vs_f32_max_norm_err=bf16_err,
                    fleet_score_launches_per_request=per_request, request_seconds=seconds,
                    stream_launches=stream_launches, verdicts_checked_bitwise=checked)
        out["chains"][name] = info
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
    lstm_train_kernels = phase_lstm_train_kernel_check()
    lstm_train = phase_lstm_train()
    emit({"phase": "lstm_train", **lstm_train})
    emit(lstm_redesign_line(lstm_kernels, lstm_train_kernels, lstm_train))
    emit(median_head_redesign_line(lstm_kernels, lstm_train_kernels, lstm_train))
    ragged_kernels = phase_ragged_kernel_check()
    ragged = phase_ragged_train()
    emit({"phase": "ragged_train", **ragged})
    ragged_lstm = phase_ragged_lstm_train()
    emit({"phase": "ragged_lstm_train", **ragged_lstm})
    precision_kernels = phase_precision_kernel_check()
    precision = phase_precision_serve()
    emit({"phase": "precision_serve", **precision})
    stream_kernels = phase_stream_kernel_check()
    stream = phase_stream()
    emit({"phase": "stream", **stream})
    resume_kernels = phase_resume_kernel_check()
    resume = phase_resume()
    emit({"phase": "resume", **resume})
    fleet_api = phase_fleet_api()
    emit({"phase": "fleet_api", **fleet_api})
    fleet_init_kernels = phase_fleet_init_kernel_check()
    emit(init_quant_redesign_line(fleet_init_kernels, precision_kernels, precision))
    project = phase_build_project()
    emit({"phase": "build_project", **project})
    scaler_kernels = phase_scaler_kernel_check()
    scaler_build = phase_scaler_build()
    emit({"phase": "scaler_build", **scaler_build})
    transform_kernels = phase_transform_kernel_check()
    transform_build = phase_transform_build()
    emit({"phase": "transform_build", **transform_build})
    transform_serve_kernels = phase_transform_serve_kernel_check()
    transform_serve = phase_transform_serve()
    emit({"phase": "transform_serve", **transform_serve})
    container_kernels = phase_container_kernel_check()
    emit(score_chain_redesign_line(shapes, lstm_kernels, precision_kernels, transform_kernels,
                                   transform_serve_kernels, transform_serve, container_kernels))
    container_build = phase_container_build()
    emit({"phase": "container_build", **container_build})
    uncentred = phase_uncentred_chain()
    emit({"phase": "uncentred_chain", **uncentred})
    main_shape = shapes[0]
    head = lstm_kernels["fleet_score_lstm_head"]
    summary = [{
        "name": "fleet_score",
        "route": "cuda",
        "source": fs.SOURCE,
        "replaces": fs.REPLACES,
        "launches": (serve["launches"] + train["launches"]["fleet_score"]
                     + lstm_serve["launches"]["fleet_score"] + lstm_train["launches"]["fleet_score"]),
        "launches_by_path": {"serve": serve["launches"], "train": train["launches"]["fleet_score"],
                             "lstm_serve": lstm_serve["launches"]["fleet_score"],
                             "lstm_train": lstm_train["launches"]["fleet_score"]},
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
            "launches": train["launches"][name] + lstm_train["launches"].get(name, 0),
            "launches_by_path": {"train": train["launches"][name],
                                 "lstm_train": lstm_train["launches"].get(name, 0)},
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
            "launches": lstm_serve["launches"][name] + lstm_train["launches"].get(name, 0),
            "launches_by_path": {"lstm_serve": lstm_serve["launches"][name],
                                 "lstm_train": lstm_train["launches"].get(name, 0)},
            "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
            "shape": list(LSTM_SHAPE),
        })
        if name == "rolling_median":
            summary[-1]["shapes"] = {key: {k: entry[key][k] for k in (
                "shape", "window", "ms", "plain_ms", "bound_ms", "bound_by")}
                for key in ("default_bucket", "longest_window")}
        if name == "lstm_layer":
            for key in ("stream_shape", "stream_prime_shape"):
                summary[-1][key] = {k: entry[key][k] for k in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    for name, entry in lstm_train_kernels.items():
        mod = importlib.import_module(
            f"gordo_tpu_torch.kernels.{'lstm_layer' if name == 'lstm_layer_train' else name}")
        summary.append({
            "name": name,
            "route": "cuda",
            "source": mod.SOURCE,
            "replaces": mod.REPLACES,
            "launches": lstm_train["launches"][name],
            "max_abs_err": entry["max_abs_err"],
            "ms": entry["ms"],
            "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry.get("library_ms"),
            "shape": [*LSTM_TRAIN_SHAPE, "one lockstep step of every slot"],
        })
    # fleet init (K11): each build's groups draw through it
    from gordo_tpu_torch.kernels import fleet_init as fi
    init_entry = fleet_init_kernels["hourglass_bucket"]
    summary.append({
        "name": "fleet_init", "route": "cuda", "source": fi.SOURCE, "replaces": fi.REPLACES,
        "launches": 0,
        "launches_by_path": {"train": train["launches"]["fleet_init"],
                             "lstm_train": lstm_train["launches"]["fleet_init"]},
        "max_abs_err": max(e["max_abs_err"] for k, e in fleet_init_kernels.items() if isinstance(e, dict)
                           and "max_abs_err" in e),
        "max_ulp": max(e["max_ulp"] for k, e in fleet_init_kernels.items() if isinstance(e, dict)
                       and "max_ulp" in e),
        "ms": init_entry["ms"], "plain_ms": init_entry["plain_ms"], "bound_ms": init_entry["bound_ms"],
        "bound_by": init_entry["bound_by"],
        # torch.randperm over the same permutations (the port never calls it)
        "library_ms": init_entry["library_ms"],
        "shape": [init_entry["seeds"], "seeds", init_entry["values"] // 2, "values",
                  init_entry["n_totals"], "x", init_entry["epochs"], "epochs"],
        "shapes": {k: {f: e.get(f) for f in ("seeds", "n_totals", "epochs", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "max_ulp")}
                   for k, e in fleet_init_kernels.items() if isinstance(e, dict) and "seeds" in e},
    })
    # the ragged paths: the launches of cv_epilogue in the builds' pad-up
    # groups are the masked epilogue's (K8), the rest K4's
    ragged_paths = {
        "ragged_train": ragged["padded"], "ragged_train_exact": ragged["exact"],
        "ragged_train_warm": ragged["warm"],
        "ragged_lstm_train": ragged_lstm["padded"],
        "ragged_lstm_train_exact": ragged_lstm["exact"],
        "ragged_lstm_train_warm": ragged_lstm["warm"],
    }
    for entry in summary:
        by_path = entry.setdefault("launches_by_path", {"lstm_train": entry["launches"]})
        for path, info in ragged_paths.items():
            by_path[path] = info["launches"].get(entry["name"], 0)
            if entry["name"] == "cv_epilogue":
                by_path[path] -= info["cv_epilogue_masked_launches"]
        entry["launches"] = sum(by_path.values())
    fit_entry = next(e for e in summary if e["name"] == "fleet_fit")
    stats_entry = next(e for e in summary if e["name"] == "scaler_stats")
    for entry, key in ((fit_entry, "fleet_fit_ragged"), (stats_entry, "scaler_stats_nan_padded")):
        entry[key] = {k: v for k, v in ragged_kernels[key].items() if k not in ("bytes", "flops")}
    # the MinMax statistic by each path of its plan (scaler_kernel_check)
    stats_entry["path"] = train_kernels["scaler_stats"].get("path")
    stats_entry["shapes"] = {k: {f: e.get(f) for f in ("path", "ms", "plain_ms", "bound_ms", "bound_by")}
                             for k, e in scaler_kernels.items() if e["stat"] == "minmax"}
    epi_entry = next(e for e in summary if e["name"] == "cv_epilogue")
    epi_entry["path"] = train_kernels["cv_epilogue"].get("path")
    block = train_kernels["cv_epilogue"]["block_path"]
    epi_entry["block_path"] = {"shape": block["shape"], "path": block["path"],
                               **{k: block["exact"].get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    masked = ragged_kernels["cv_epilogue_masked"]
    from gordo_tpu_torch.kernels import cv_epilogue as ce
    by_path = {path: info["cv_epilogue_masked_launches"] for path, info in ragged_paths.items()}
    summary.append({
        "name": "cv_epilogue_masked",
        "route": "cuda",
        "source": ce.SOURCE,
        "replaces": "gordo_tpu/parallel/anomaly.py:185",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": masked["max_abs_err"],
        "ms": masked["ms"],
        "plain_ms": masked["plain_ms"],
        "bound_ms": masked["bound_ms"],
        "bound_by": masked["bound_by"],
        "library_ms": None,
        "shape": [masked["slots"], masked["rows"], masked["tags"], "row counts 0..nt"],
        "host_ms": masked["host_ms"],
        "plain_host_ms": masked["plain_host_ms"],
    })
    # reduced-precision serving: the bf16 instantiations' launches by dtype
    # (also in fleet_score's and lstm_layer's totals), and fake_quant's at
    # the int8 load
    served = {d: precision["dtypes"][d]["launches"] for d in ("float32", "bfloat16", "int8")}
    for entry in summary:
        if entry["name"] in ("fleet_score", "lstm_layer"):
            for d, counts in served.items():
                entry["launches_by_path"][f"precision_serve_{d}"] = counts[entry["name"]]
            if entry["name"] == "lstm_layer":
                entry["launches_by_path"]["stream"] = stream["launches"]["lstm_layer"]
            entry["launches"] = sum(entry["launches_by_path"].values())
    from gordo_tpu_torch.kernels import fake_quant as fq
    from gordo_tpu_torch.kernels import lstm_layer as ll
    from gordo_tpu_torch.kernels import stream_step as sk
    for name, mod, entry, shape in (
        ("fleet_score_bf16", fs, precision_kernels["fleet_score_bf16"], list(KERNEL_SHAPES[0])),
        ("lstm_layer_bf16", ll, precision_kernels["lstm_layer_bf16"], list(LSTM_SHAPE)),
    ):
        by_path = {f"precision_serve_{d}": served[d][name] for d in ("bfloat16", "int8")}
        summary.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            # no PyTorch call computes over bf16 storage in f32
            "library_ms": None, "shape": shape, "storage": "bfloat16",
        })
    fq_entry = precision_kernels["fake_quant"]
    summary.append({
        "name": "fake_quant", "route": "cuda", "source": fq.SOURCE, "replaces": fq.REPLACES,
        "launches": served["int8"]["fake_quant"], "launches_by_path": {"precision_serve_int8": served["int8"]["fake_quant"]},
        "max_abs_err": max(v["max_abs_err"] for v in fq_entry["variants"].values()),
        "ms": fq_entry["ms"], "plain_ms": fq_entry["plain_ms"], "bound_ms": fq_entry["bound_ms"],
        "bound_by": fq_entry["bound_by"], "library_ms": None,
        "shape": [PRECISION_FLEET["default"], "stacked leaves of the default bucket", fq_entry["leaves"]],
    })
    step = stream_kernels["default_float32"]
    summary.append({
        "name": "stream_step", "route": "cuda", "source": sk.SOURCE, "replaces": sk.REPLACES,
        "launches": stream["launches"]["stream_step"] + stream["launches"]["stream_shift"],
        "launches_by_path": {"stream": stream["launches"]["stream_step"],
                             "stream_shift": stream["launches"]["stream_shift"]},
        "max_abs_err": max(e["max_abs_err"] for k, e in stream_kernels.items() if k != "launch_floor"),
        "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": None,
        "shape": [*step["ring"], "window", step["window"], "one new row"],
        "variants": {k: {f: e.get(f) for f in ("ms", "full_ms", "plain_ms", "bound_ms", "full_bound_ms",
                                               "shift_ms", "sort_k")}
                     for k, e in stream_kernels.items() if k != "launch_floor"},
        "launch_floor": stream_kernels["launch_floor"],
    })
    # resumable fits: the LSTM estimator's launches on the resume path;
    # the stateful and weighted fleet_fit (whose launches are not in
    # fleet_fit's) and fleet_apply
    lstm_resume = resume["lstm_autoencoder"]["launches"]
    for entry in summary:
        if entry["name"] in ("lstm_layer_train", "lstm_layer_bwd", "lstm_head_fit", "fleet_adam"):
            entry["launches_by_path"]["resume"] = lstm_resume[entry["name"]]
            entry["launches"] = sum(entry["launches_by_path"].values())
    from gordo_tpu_torch.kernels import fleet_apply as fa
    from gordo_tpu_torch.kernels import fleet_fit as ff
    for name, replaces, path, launches, shape in (
        ("fleet_fit_stateful", "gordo_tpu/train/checkpoint.py:165", "resume",
         resume["autoencoder"]["launches"]["fleet_fit"], [*TRAIN_SHAPE, "4 fits, state in and out"]),
        ("fleet_fit_weighted", "gordo_tpu/parallel/fleet.py:314", "fleet_api",
         fleet_api["launches"]["fleet_fit"], [*TRAIN_SHAPE, "4 fits, non-binary row weights"]),
    ):
        entry = resume_kernels[name]
        summary.append({
            "name": name, "route": "cuda", "source": ff.SOURCE, "replaces": replaces,
            "launches": launches, "launches_by_path": {path: launches},
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"], "library_ms": None,
            "shape": shape,
        })
    # the build-project and generic fleet API paths
    for entry in summary:
        name = entry["name"]
        if name in project["launches"]:
            entry["launches_by_path"]["build_project"] = project["launches"][name] + (
                project["serve_launches"] if name == "fleet_score" else 0)
        if name == "fleet_init":
            entry["launches_by_path"]["resume"] = sum(r["launches"]["fleet_init"] for r in resume.values())
            entry["launches_by_path"]["fleet_api"] = fleet_api["launches"]["fleet_init"]
        entry["launches"] = sum(entry["launches_by_path"].values())
    # the scaler build (Robust step, Standard detector scaler): its
    # launches of every kernel, the bulk request's and the stream's
    for entry in summary:
        name = entry["name"]
        if name in scaler_build["launches"] or name in ("fleet_score", "stream_step"):
            entry["launches_by_path"]["scaler_build"] = scaler_build["launches"].get(name, 0) + (
                scaler_build["serve_launches"] if name == "fleet_score" else 0) + (
                scaler_build["stream_launches"] if name == "stream_step" else 0)
        entry["launches"] = sum(entry["launches_by_path"].values())
    from gordo_tpu_torch.kernels import scaler_quantiles as sq
    from gordo_tpu_torch.kernels import scaler_stats as ss
    for name, mod, replaces, key in (("scaler_stats_standard", ss, ss.REPLACES_STANDARD, "standard"),
                                     ("scaler_quantiles", sq, sq.REPLACES, "robust")):
        entry = scaler_kernels[key]
        by_path = {"scaler_build": scaler_build["launches"][name]}
        summary.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(e["max_abs_err"] for e in scaler_kernels.values() if e["stat"] == key),
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            # torch.nanquantile, one call a row list, for Robust; no one
            # PyTorch call takes a NaN-aware std
            "library_ms": entry["library_ms"],
            "shape": [*TRAIN_SHAPE, "4 row lists"],
            "shapes": {k: {f: e.get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                       for k, e in scaler_kernels.items() if e["stat"] == key},
        })
    # the transform build (chains A and B through the singles pass): its
    # launches of every kernel, its requests' included
    for entry in summary:
        name = entry["name"]
        if name in transform_build["launches"]:
            entry["launches_by_path"]["transform_build"] = transform_build["launches"][name] + (
                transform_build["single_launches"].get(name, 0) + transform_build["bulk_launches"].get(name, 0))
        entry["launches"] = sum(entry["launches_by_path"].values())
    from gordo_tpu_torch.kernels import chain_apply as ca
    transform_counts = {name: transform_build["launches"][name] + transform_build["single_launches"].get(name, 0)
                        + transform_build["bulk_launches"].get(name, 0)
                        for name in ("chain_apply", "scaler_quantiles_grid", "scaler_stats_mean")}
    rows, tags = TRANSFORM_SHAPES[0]
    for name, mod, replaces, key, library, kinds, shape in (
        ("chain_apply", ca, ca.REPLACES, f"chain_a_{rows}x{tags}", None,
         ("every_form", "quantile", "chain_a"), [rows, tags, "chain A"]),
        ("scaler_quantiles_grid", sq, sq.REPLACES_GRID, "grid", "torch.nanquantile over the grid",
         ("grid", "median"), [1, rows, tags, f"Q {TRANSFORM_Q}"]),
        ("scaler_stats_mean", ss, ss.REPLACES_MEAN, "mean", "torch.mean", ("mean", "nanmean"), [1, rows, tags]),
    ):
        entry = transform_kernels[key]
        shapes_of = {k: {f: e.get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                     for k, e in transform_kernels.items() if k.startswith(kinds)}
        summary.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": replaces,
            "launches": transform_counts[name], "launches_by_path": {"transform_build": transform_counts[name]},
            "max_abs_err": max(transform_kernels[k]["max_abs_err"] for k in shapes_of),
            "ms": entry["ms"], "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            # no one PyTorch call runs a transform chain; torch.nanquantile
            # over the grid and torch.mean beside the statistics
            "library_ms": entry["library_ms"], "library": library, "shape": shape, "shapes": shapes_of,
        })
    transform_serve_summary(summary, transform_serve_kernels, transform_serve)
    container_summary(summary, container_kernels, container_build)
    # the uncentred chains: their builds', requests' and streams' launches
    for entry in summary:
        name = entry["name"]
        if name in uncentred["launches"]:
            entry["launches_by_path"]["uncentred_chain"] = uncentred["launches"][name]
            entry["launches"] = sum(entry["launches_by_path"].values())
    apply_entry = resume_kernels["fleet_apply"]
    summary.append({
        "name": "fleet_apply", "route": "cuda", "source": fa.SOURCE, "replaces": fa.REPLACES,
        "launches": fleet_api["launches"]["fleet_apply"],
        "launches_by_path": {"fleet_api": fleet_api["launches"]["fleet_apply"]},
        "max_abs_err": apply_entry["max_abs_err"], "ms": apply_entry["ms"],
        "plain_ms": apply_entry["plain_ms"], "bound_ms": apply_entry["bound_ms"],
        "bound_by": apply_entry["bound_by"],
        # no one PyTorch call computes a stacked dense chain; the chain of
        # library calls the plain version makes is timed beside it
        "library_ms": None, "library_chain_ms": apply_entry["library_chain_ms"],
        "shape": apply_entry["shape"],
        "shapes": [{k: e[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_chain_ms")}
                   for e in apply_entry["shapes"]],
    })
    emit(epilogue_minmax_redesign_line(train_kernels, ragged_kernels, scaler_kernels))
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
