"""``fleet_score``: fused anomaly scoring of a bucket of feedforward detectors.

Replaces the XLA programs ``serve.fleet`` / ``serve.fleet_subset``
(``gordo_tpu/serve/fleet_scorer.py:51`` ``_fleet_score_core``, ``:120``
``_fleet_score_subset_core``) and ``serve.score``
(``gordo_tpu/serve/scorer.py:211`` ``_score_program_fn``) for the
feedforward / MinMax chain; for an LSTM detector it is the ``out`` head
and the detector epilogue after the ``lstm_layer`` launches, and with a
detector window ``rolling_median`` smooths its scores and takes the
confidence.  With no layers it is that epilogue alone, ``anomaly.scores``
(``gordo_tpu/anomaly/diff.py:41``) on a prediction already computed: a
``TransformedTargetRegressor``'s after its target's inverse, a
``MultiOutputRegressor``'s after its columns' model launch.  The kernel
is CUDA C++ for ``sm_90a`` (``gordo_tpu_torch/csrc/fleet_score.cu``,
whose header gives its bound and design); :func:`fleet_score_plain` is the
same function in plain PyTorch.

:func:`fleet_score` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch (and to :data:`bf16_launches` for one over
bf16 storage).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gordo_tpu_torch.device import to_device
from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.scaler_stats import Prefix, ScalerChain, apply_steps, check_steps
from gordo_tpu_torch.models.factories.feedforward import ACTIVATIONS

SOURCE = "gordo_tpu_torch/csrc/fleet_score.cu"
REPLACES = "gordo_tpu/serve/fleet_scorer.py:51"

#: activation codes of the kernel's ``act_fn``
ACT_CODES = {
    None: 0, "linear": 0, "tanh": 1, "relu": 2, "sigmoid": 3, "elu": 4,
    "selu": 5, "softplus": 6, "leaky_relu": 7, "gelu": 8,
}
MAX_LAYERS = 16
#: rows of a tile are a multiple of the rows each thread computes (FS_RPT)
_ROW_TILES = (256, 128, 64, 32, 16, 8)
#: shared memory one block may use on sm_90
SMEM_LIMIT = 232448
#: all layers' weights are loaded at once (one round of global loads)
#: when they take at most this much shared memory; wider models stream
#: one layer at a time
RESIDENT_WEIGHT_BYTES = 32 * 1024
#: grid rows are ``blockIdx.y``
MAX_SLOTS = 65535

#: kernel launches so far (the CPU path never counts), and those of them
#: over bf16 storage and those of the epilogue alone (no layers)
launches = 0
bf16_launches = 0
epilogue_launches = 0
_launches_lock = threading.Lock()

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]
#: one scaler step ``(form, a, b)`` (``scaler_stats.AFFINE`` or ``CENTER``)
Step = Tuple[int, torch.Tensor, torch.Tensor]


class DenseChain(ctypes.Structure):
    """Mirror of ``struct DenseChain`` in ``csrc/dense_rows.cuh``."""

    _fields_ = [
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("act", ctypes.c_int * MAX_LAYERS),
        ("weights_resident", ctypes.c_int),
    ]

    def fill(self, layers: "Layers", acts: Sequence[Optional[str]], dims: Sequence[int],
             resident: bool) -> None:
        for i, (W, b) in enumerate(layers):
            self.w[i], self.b[i] = W.data_ptr(), b.data_ptr()
        self.n_layers = len(layers)
        for i, d in enumerate(dims):
            self.dims[i] = d
        for i, a in enumerate(acts):
            self.act[i] = ACT_CODES[a]
        self.weights_resident = int(resident)


class _Args(ctypes.Structure):
    """Mirror of ``struct FleetScoreArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_rows", ctypes.c_void_p),
        ("scalers", ScalerChain),
        ("chain", DenseChain),
        ("det", ScalerChain),
        ("agg_thr", ctypes.c_void_p),
        ("pred", ctypes.c_void_p),
        ("tag", ctypes.c_void_p),
        ("total", ctypes.c_void_p),
        ("conf", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("y_n", ctypes.c_int),
        ("y_row0", ctypes.c_int),
        ("rows_per_block", ctypes.c_int),
        ("max_dim", ctypes.c_int),
        ("wbuf_floats", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("x_bf16", ctypes.c_int),
        ("bf16", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fleet_score")
            lib.fleet_score_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.fleet_score_launch.restype = ctypes.c_int
            lib.fleet_score_error_string.argtypes = [ctypes.c_int]
            lib.fleet_score_error_string.restype = ctypes.c_char_p
            lib.fleet_score_args_size.argtypes = []
            lib.fleet_score_args_size.restype = ctypes.c_int
            if lib.fleet_score_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    "fleet_score: FleetScoreArgs is "
                    f"{lib.fleet_score_args_size()} bytes in the library but "
                    f"{ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


class LaunchPlan(NamedTuple):
    rows_per_block: int
    smem_bytes: int
    weights_resident: bool
    wbuf_floats: int


def weight_buffer(dims: Sequence[int]):
    """``(resident, wbuf_floats, layer_sizes)`` of a dense chain of widths
    ``dims`` in shared memory (``csrc/dense_rows.cuh``): all layers at once
    when they take at most ``RESIDENT_WEIGHT_BYTES``, else one at a time."""
    sizes = [dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1)]
    resident = 4 * sum(sizes) <= RESIDENT_WEIGHT_BYTES
    return resident, sum(sizes) if resident else max(sizes), sizes


def launch_plan(
    dims: Sequence[int], m: int, n: int, sm_count: int, with_detector: bool = True
) -> LaunchPlan:
    """Row tile and shared memory for a chain of widths ``dims``.

    Weights are resident when all layers fit in ``RESIDENT_WEIGHT_BYTES``,
    else streamed one layer at a time.  The row tile is the largest whose
    shared memory fits, halved (down to 16 rows) while the grid has fewer
    blocks than SMs.  Raises ``ValueError`` for widths whose largest layer
    does not fit."""
    resident, wbuf, sizes = weight_buffer(dims)
    fixed = wbuf + 2 * dims[-1]
    per_row = 2 * max(dims) + (dims[-1] if with_detector else 0)
    for rows in _ROW_TILES:
        smem = 4 * (fixed + rows * per_row)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"fleet_score cannot take widths {list(dims)}: its largest layer "
            f"({max(sizes)} floats) and an {_ROW_TILES[-1]}-row tile need "
            f"{smem} bytes of shared memory, over the {SMEM_LIMIT} a block has"
        )
    while rows > 16 and m * math.ceil(n / rows) < sm_count:
        rows //= 2
    return LaunchPlan(rows, 4 * (fixed + rows * per_row), resident, wbuf)


def _host_ints(values, name: str, lo: int, hi: int) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.int64))
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {arr.shape}")
    if arr.size and (arr.min() < lo or arr.max() > hi):
        raise ValueError(f"{name} values must lie in [{lo}, {hi}]")
    return arr.astype(np.int32)


def slot_ints(values, name: str, lo: int, hi: int, device) -> torch.Tensor:
    """Per-slot ints (``idx``, row or window counts) as an int32 tensor on
    ``device``, checked against ``[lo, hi]`` on the host.  An int32 tensor
    already on ``device`` passes as it is, unchecked: its maker checked it,
    so a caller that feeds several kernels the same counts copies them to
    the card once."""
    if isinstance(values, torch.Tensor) and values.device == torch.device(device):
        if values.dtype != torch.int32 or values.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got {values.dtype} {tuple(values.shape)}")
        return values
    return to_device(_host_ints(values, name, lo, hi), device)


#: the storage types the serving kernels take (float32, and bfloat16 for
#: reduced-precision serving)
STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def storage_of(t: torch.Tensor) -> torch.dtype:
    """The storage type of a chain's stacked leaf ``t``; raises for others."""
    if t.dtype not in STORAGE_DTYPES:
        raise TypeError(f"serving tensors are float32 or bfloat16, got {t.dtype}")
    return t.dtype


def _check(
    t: Optional[torch.Tensor], name: str, shape: Tuple[int, ...], device,
    dtype: Union[torch.dtype, Tuple[torch.dtype, ...]] = torch.float32,
) -> None:
    if t is None:
        return
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        names = " or ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fleet_score(
    x: torch.Tensor,
    layers: Layers,
    acts: Sequence[Optional[str]],
    *,
    chain: Optional[Prefix] = None,
    det: Optional[Step] = None,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
    y: Optional[torch.Tensor] = None,
    y_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Score ``x`` (m, n, f) through the stacked chains of M machines.

    ``layers``: ``[(W (M, in, out), b (M, out)), ...]`` with one activation
    name per layer in ``acts`` (the last is the output head's).
    ``chain``: the pipeline's scaler steps ``[(form, a (M, f), b (M, f)),
    ...]`` (``scaler_stats.AFFINE`` or ``CENTER`` each; none: no scaler).
    ``det``: the detector scaler's step ``(form, a (M, f), b (M, f))``;
    without it only ``model-output`` is computed.  ``agg_thr`` (M,): aggregate
    thresholds, adding ``anomaly-confidence``.  ``idx`` (m,) host ints:
    the stacked machine each slot of ``x`` is scored by (default: slot i
    is machine i, m == M).  ``n_rows`` (m,) host ints: valid rows of each
    slot (default n); output rows past them are unspecified.  ``y``
    (m, n_y, f_out): targets of the detector, output row ``r`` against
    ``y`` row ``y_offset + r`` (default ``x``, which then needs f_out ==
    f).  The LSTM detectors pass their last layer's final states as ``x``
    and the raw request rows as ``y``, from the model's offset on.

    No ``layers`` (and no ``acts``): the epilogue alone, ``x`` the
    prediction (float32), which comes back as ``model-output`` unwritten;
    it needs the detector scaler (M from its stats) and no pipeline
    scaler.

    Storage: the layers, the stats and ``y`` are all float32, or all
    bfloat16 (reduced-precision serving; ``x`` is then bfloat16 rows, or
    an LSTM head's float32 states); ``agg_thr`` is float32.  Outputs are
    float32 either way.
    """
    steps = list(chain or ())
    dets = [] if det is None else [det]
    if x.device.type == "cpu":
        return fleet_score_plain(
            x, layers, acts, chain=steps, det=det, agg_thr=agg_thr,
            idx=idx, n_rows=n_rows, y=y, y_offset=y_offset,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fleet_score runs on cuda or cpu tensors, got {x.device}")
    device = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (m, n, f), got shape {tuple(x.shape)}")
    m, n, f = (int(s) for s in x.shape)
    if not 1 <= m <= MAX_SLOTS or n < 1:
        raise ValueError(f"x must have 1..{MAX_SLOTS} slots and >= 1 row, got {tuple(x.shape)}")
    M, store = _epilogue_only_check(layers, acts, steps, dets)
    if M is None:
        M, store = int(layers[0][0].shape[0]), storage_of(layers[0][0])
    dims = [f]
    for i, (W, b) in enumerate(layers):
        if W.dim() != 3:
            raise ValueError(f"layer {i} weight must be (M, in, out), got {tuple(W.shape)}")
        _check(W, f"layer {i} weight", (M, dims[-1], int(W.shape[2])), device, store)
        _check(b, f"layer {i} bias", (M, int(W.shape[2])), device, store)
        dims.append(int(W.shape[2]))
    if min(dims) < 1:
        raise ValueError(f"every layer needs a width >= 1, got {dims}")
    fo = dims[-1]
    _check(x, "x", (m, n, f), device, (torch.float32, store))
    check_steps(steps, (M, f), device, (store,), "pipeline scaler")
    if not dets and (agg_thr is not None or y is not None):
        raise ValueError("agg_thr and y need the detector scaler")
    if dets and y is None and fo != f:
        raise ValueError(
            f"anomaly scoring against x needs as many outputs as inputs ({fo} != {f})"
        )
    check_steps(dets, (M, fo), device, (store,), "detector scaler")
    _check(agg_thr, "agg_thr", (M,), device)
    y_n = n
    if y is not None:
        y_n = int(y.shape[1]) if y.dim() == 3 else -1
        if y_offset < 0 or y_n < y_offset + n:
            raise ValueError(
                f"y needs rows {y_offset}..{y_offset + n - 1} of each slot, got "
                f"shape {tuple(y.shape)}"
            )
        _check(y, "y", (m, y_n, fo), device, store)
    if idx is None:
        if m != M:
            raise ValueError(f"without idx, x needs one slot per machine ({m} != {M})")
        idx_dev = None
    else:
        idx_dev = slot_ints(idx, "idx", 0, M - 1, device)
        if idx_dev.numel() != m:
            raise ValueError(f"idx needs one entry per slot ({idx_dev.numel()} != {m})")
    if n_rows is None:
        rows_dev = None
    else:
        rows_dev = slot_ints(n_rows, "n_rows", 1, n, device)
        if rows_dev.numel() != m:
            raise ValueError(f"n_rows needs one entry per slot ({rows_dev.numel()} != {m})")

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    plan = launch_plan(dims, m, n, sm_count, with_detector=bool(dets))
    pred = torch.empty((m, n, fo), dtype=torch.float32, device=device) if layers else None
    result = {"model-output": x if pred is None else pred}
    tag = total = conf = None
    if dets:
        tag = result["tag-anomaly-scores"] = torch.empty((m, n, fo), dtype=torch.float32, device=device)
        total = result["total-anomaly-score"] = torch.empty((m, n), dtype=torch.float32, device=device)
        if agg_thr is not None:
            conf = result["anomaly-confidence"] = torch.empty_like(total)

    args = _Args()
    args.x, args.y = _ptr(x), _ptr(y)
    args.idx, args.n_rows = _ptr(idx_dev), _ptr(rows_dev)
    args.scalers.fill(steps)
    args.chain.fill(layers, acts, dims, plan.weights_resident)
    args.det.fill(dets)
    args.agg_thr = _ptr(agg_thr)
    args.pred, args.tag, args.total, args.conf = (
        _ptr(pred), _ptr(tag), _ptr(total), _ptr(conf)
    )
    args.m, args.n, args.f = m, n, f
    args.y_n, args.y_row0 = y_n, y_offset
    args.rows_per_block = plan.rows_per_block
    args.max_dim = max(dims)
    args.wbuf_floats = plan.wbuf_floats
    args.smem_bytes = plan.smem_bytes
    args.x_bf16 = int(x.dtype == torch.bfloat16)
    args.bf16 = int(store == torch.bfloat16)

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fleet_score_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fleet_score launch failed: {lib.fleet_score_error_string(rc).decode()}"
        )
    global launches, bf16_launches, epilogue_launches
    with _launches_lock:
        launches += 1
        bf16_launches += args.bf16
        epilogue_launches += int(not layers)
    return result


def _epilogue_only_check(layers: Layers, acts, steps: Prefix, dets: Prefix) -> Tuple[Optional[int], Optional[torch.dtype]]:
    """``(M, storage)`` of an epilogue-only call (no layers), checked;
    ``(None, None)`` for a call with layers, whose count is checked."""
    if layers or acts:
        if not 1 <= len(layers) <= MAX_LAYERS or len(acts) != len(layers):
            raise ValueError(
                f"need 1..{MAX_LAYERS} layers with one activation each, got "
                f"{len(layers)} layers and {len(acts)} activations"
            )
        for a in acts:
            if a not in ACT_CODES:
                raise ValueError(f"activation {a!r} has no kernel code")
        return None, None
    if not dets or steps:
        raise ValueError("an epilogue-only fleet_score (no layers) needs the detector scaler, "
                         "and takes no pipeline scaler")
    return int(dets[0][1].shape[0]), storage_of(dets[0][1])


def fleet_score_plain(
    x: torch.Tensor,
    layers: Layers,
    acts: Sequence[Optional[str]],
    *,
    chain: Optional[Prefix] = None,
    det: Optional[Step] = None,
    agg_thr: Optional[torch.Tensor] = None,
    idx=None,
    n_rows=None,
    y: Optional[torch.Tensor] = None,
    y_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """:func:`fleet_score` in plain PyTorch, in the JAX program's op order.

    ``n_rows`` only marks which output rows are meaningful; every row is
    computed.  bfloat16 inputs are widened to float32 first, as the kernel
    widens them as it loads.  A MinMax step is one FMA, as in the kernel
    and in the JAX package's jitted scorer (XLA:CPU fuses ``x * scale +
    offset``)."""
    steps = list(chain or ())
    dets = [] if det is None else [det]
    if not layers:
        _epilogue_only_check(layers, acts, steps, dets)
    wide = lambda t: None if t is None else t.float()  # noqa: E731
    x, y = wide(x), wide(y)
    layers = [(W.float(), b.float()) for W, b in layers]
    view = lambda t: t[:, None, :]  # noqa: E731
    if idx is not None:
        take = torch.as_tensor(idx.cpu() if isinstance(idx, torch.Tensor) else np.asarray(idx, np.int64),
                               dtype=torch.int64, device=x.device)

        def pick(t):
            return None if t is None else t.index_select(0, take)

        layers = [(pick(W), pick(b)) for W, b in layers]
        agg_thr = pick(agg_thr)
        view = lambda t: pick(t)[:, None, :]  # noqa: E731
    h = apply_steps(x, steps, view)
    for (W, b), act in zip(layers, acts):
        h = ACTIVATIONS[act](torch.bmm(h, W) + b[:, None, :])
    result = {"model-output": h}
    if dets:
        target = x if y is None else y[:, y_offset: y_offset + x.shape[1]]
        tag = torch.abs(apply_steps(h, dets, view) - apply_steps(target, dets, view))
        total = torch.sqrt(torch.sum(tag * tag, dim=-1))
        result["tag-anomaly-scores"] = tag
        result["total-anomaly-score"] = total
        if agg_thr is not None:
            result["anomaly-confidence"] = total / torch.clamp_min(agg_thr, 1e-12)[:, None]
    return result
