"""``chain_apply``: a pipeline's transform steps on rows, (n, F) → (n, F') (K12).

Replaces the eager transforms of the JAX package's single-machine path:
each pipeline step's ``transform`` (``gordo_tpu/ops/scalers.py:248-260``
QuantileTransformer, ``:303-305`` SimpleImputer, ``:338-340`` PCA, the
scalers' ``apply``) and the funcs ``FunctionTransformer`` applies
(``gordo_tpu/ops/transformer_funcs.py:11-25``), as ``Pipeline.
_transform_until_final`` runs them step by step and ``serve.score`` fuses
them (``gordo_tpu/serve/scorer.py:240-241``); and their inverses, which
``TransformedTargetRegressor.predict`` runs on a prediction
(``gordo_tpu/pipeline.py:168-172``): the scalers' ``invert`` in the
AFFINE and CENTER forms, PCA's (``ops/scalers.py:343-344``) as
:data:`PCA_INV` and QuantileTransformer's (``:262-274``) as
:data:`QUANTILE_INV`.  The kernel is CUDA C++ for
``sm_90a`` (``gordo_tpu_torch/csrc/chain_apply.cu``, whose header gives
each step's form, its bound and design); :func:`chain_apply_plain` is the
same function in plain PyTorch, in the JAX op order, with an FMA (taken in
float64 and rounded once) where XLA:CPU fuses one.

A chain is a sequence of :class:`Step`: its ``form`` (:data:`AFFINE` ...
:data:`QUANTILE_INV`) and its stats tensors on the rows' device.  Helpers
below make each (:func:`affine_step`, ...).  :func:`stack_steps` stacks
the same chain of M machines along a leading machine axis (a bucket of the
fleet scorer, ``serve.fleet`` over a fused chain): the rows are then (m,
n, F), slot ``s`` read by machine ``idx[s]`` over its first ``n_rows[s]``
rows.  Rows and stats are stored at one type, float32 or bfloat16
(reduced-precision serving, K10 over K12); the arithmetic is float32 and
the output goes out at ``out_dtype``, into a new tensor or into columns
``out_col ..`` of a wider one (``out``: a ``FeatureUnion``'s branches
each write their columns of one output).  :func:`unit_linspace` and
:func:`percentile_fractions` reproduce ``jnp.linspace(0, 1, Q)`` and
``jnp.linspace(0, 100, Q) / 100`` as XLA computes them.

:func:`chain_apply` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gordo_tpu_torch.kernels import build
from gordo_tpu_torch.kernels.fleet_init import fma

SOURCE = "gordo_tpu_torch/csrc/chain_apply.cu"
REPLACES = "gordo_tpu/ops/scalers.py:248"

AFFINE, CENTER, IMPUTE, MUL, ADD, LOG1P, EXPM1, PCA, QUANTILE, PCA_INV, QUANTILE_INV = range(11)
FORM_NAMES = ("affine", "center", "impute", "mul", "add", "log1p", "expm1", "pca", "quantile",
              "pca_inv", "quantile_inv")
#: the kernel's limits (``CA_MAX_STEPS``, ``CA_MAX_WIDTH``, ``CA_MAX_Q``,
#: ``CA_MAX_SLOTS``, ``CA_NARROW_MAX``: the row path's widest step,
#: ``CA_THREADS``: a block's threads, the row path's most rows)
MAX_STEPS = 8
MAX_WIDTH = 128
MAX_Q = 1000
MAX_SLOTS = 65535
NARROW_MAX = 16
THREADS = 256
#: the kernel's paths (``CA_PATH_TILE``, ``CA_PATH_ELEMENTWISE``, ``CA_PATH_ROWS``)
PATH_TILE, PATH_ELEMENTWISE, PATH_ROWS = range(3)
PATH_NAMES = ("tile", "elementwise", "rows")
#: the forms the elementwise path takes
ELEMENTWISE = frozenset((AFFINE, CENTER, IMPUTE, MUL, ADD, LOG1P, EXPM1))
#: values a block of the elementwise path takes: four a load, CA_EW_BATCH
#: loads a thread
EW_TILE_VALUES = 4 * 4 * THREADS
#: the row path's largest and smallest blocks
ROW_THREADS_MAX = 128
ROW_THREADS_MIN = 64
#: the row path's resident blocks an SM that its plan aims at: each block
#: walks a run of its slot's tiles, the next tile's rows loading while it
#: applies the chain to one
ROW_BLOCKS_PER_SM = 8
#: the storage types the kernel reads and writes
STORAGE_DTYPES = (torch.float32, torch.bfloat16)
LIMITS_ITEM = "ROADMAP queue 1 item 2 (training breadth: wider transform chains)"

#: kernel launches so far (the CPU path never counts), and those of them
#: over stacked stats at float32 and over bf16 storage (the two are
#: disjoint: the rest are float32 over one set of stats), and those of a
#: transform's inverse (steps marked ``inverse``)
launches = 0
stacked_launches = 0
bf16_launches = 0
inverse_launches = 0
_launches_lock = threading.Lock()


@dataclasses.dataclass
class Step:
    """One transform step: ``form`` and its stats on the rows' device.

    ``a``/``b``: AFFINE ``x * a + b`` and CENTER ``(x - a) / b``, each
    (F,); IMPUTE ``a`` the fill (F,); PCA ``a`` the mean (F,) and ``b``
    the components transposed (F, k), so that a row's k outputs read
    neighbouring values; PCA_INV ``x @ b + a``, ``a`` the mean (F,) and
    ``b`` the components (k, F); QUANTILE and QUANTILE_INV ``a`` the grid
    (Q, F) and ``b`` the unit grid ``qs`` (Q,).  ``c``: MUL's factor and
    ADD's addend.  ``normal``: a quantile step's ``output_distribution ==
    "normal"``.
    ``stacked``: ``a`` and ``b`` carry a leading machine axis (M, ...).
    ``inverse``: a step of a transform's inverse (``inverse_steps``),
    whose launches :data:`inverse_launches` counts."""

    form: int
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    c: float = 0.0
    normal: bool = False
    stacked: bool = False
    inverse: bool = False

    def width_out(self, width_in: int) -> int:
        return int(self.b.shape[-1]) if self.form in (PCA, PCA_INV) else width_in


def _f32(t, device) -> torch.Tensor:
    return torch.as_tensor(np.array(t, np.float32, order="C")).to(device)


def affine_step(scale, offset, device) -> Step:
    return Step(AFFINE, _f32(scale, device), _f32(offset, device))


def center_step(center, scale, device) -> Step:
    return Step(CENTER, _f32(center, device), _f32(scale, device))


def impute_step(fill, device) -> Step:
    return Step(IMPUTE, _f32(fill, device))


def pca_step(mean, components, device) -> Step:
    """PCA's ``(x - mean) @ components.T``, ``components`` (k, F)."""
    return Step(PCA, _f32(mean, device), _f32(np.asarray(components, np.float32).T, device))


def pca_inv_step(mean, components, device) -> Step:
    """PCA's inverse ``x @ components + mean``, ``components`` (k, F)."""
    return Step(PCA_INV, _f32(mean, device), _f32(components, device))


def quantile_step(grid, normal: bool, device, form: int = QUANTILE) -> Step:
    """QuantileTransformer's map (``form`` QUANTILE) or its inverse
    (QUANTILE_INV) over ``grid`` (Q, F)."""
    grid = np.asarray(grid, np.float32)
    return Step(form, _f32(grid, device), _f32(unit_linspace(grid.shape[0]), device), normal=bool(normal))


def func_step(form: int, c: float = 0.0) -> Step:
    """A transformer func's step: MUL, ADD (the constant in float32, as
    JAX takes a Python scalar against float32 rows), LOG1P or EXPM1."""
    return Step(form, c=float(np.float32(c)))


def _linspace0(stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(0, stop, num)`` in float32 as XLA:CPU computes it:
    ``i * (stop * (1 / (num - 1)))``, each product rounded, then ``stop``
    (measured bit for bit against the JAX package for num ≤ 2,000)."""
    f = np.float32
    if num < 1:
        raise ValueError(f"need at least one grid entry, got {num}")
    if num == 1:
        return np.zeros(1, f)
    step = f(f(stop) * (f(1) / f(num - 1)))
    return np.append(np.arange(num - 1, dtype=f) * step, f(stop)).astype(f)


def unit_linspace(num: int) -> np.ndarray:
    """``jnp.linspace(0.0, 1.0, num)`` (QuantileTransformer's ``qs``)."""
    return _linspace0(1.0, num)


def percentile_fractions(num: int) -> np.ndarray:
    """``jnp.nanpercentile``'s fractions of ``jnp.linspace(0.0, 100.0,
    num)``: ``q / 100``, which XLA:CPU computes as ``q * (1 / 100)``."""
    f = np.float32
    return (_linspace0(100.0, num) * (f(1) / f(100))).astype(f)


def stack_steps(chains: Sequence[Sequence[Step]], stack=torch.stack) -> List[Step]:
    """The same chain of M machines as one chain of stacked steps: each
    step's ``a`` and ``b`` stacked along a new leading machine axis by
    ``stack`` (a list of M tensors to one; the serving scorer casts them
    there).  The machines' chains must agree step by step in form, shapes
    and constants."""
    first = chains[0]
    if any(len(chain) != len(first) or any(st.stacked for st in chain) for chain in chains):
        raise ValueError("stacked machines need chains of one machine each, of equal length")
    out = []
    for j, s in enumerate(first):
        col = [chain[j] for chain in chains]
        for o in col:
            if (o.form, o.c, o.normal, o.inverse) != (s.form, s.c, s.normal, s.inverse) or any(
                    (t is None) != (u is None) or (t is not None and t.shape != u.shape)
                    for t, u in ((o.a, s.a), (o.b, s.b))):
                raise ValueError(f"step {j} ({FORM_NAMES[s.form]}) differs between the stacked machines")
        out.append(Step(s.form, None if s.a is None else stack([o.a for o in col]),
                        None if s.b is None else stack([o.b for o in col]), s.c, s.normal, stacked=True,
                        inverse=s.inverse))
    return out


def machines_of(steps: Sequence[Step]) -> Optional[int]:
    """M of stacked steps, None for one set of stats; raises when the
    steps mix the two or disagree on M."""
    ms = {int(t.shape[0]) if s.stacked else None for s in steps for t in (s.a, s.b) if t is not None}
    ms |= {None for s in steps if not s.stacked}
    if len(ms) > 1:
        raise ValueError(f"a chain's steps are stacked over one machine count, got {sorted(ms, key=str)}")
    return ms.pop() if ms else None


class _Step(ctypes.Structure):
    """Mirror of ``struct ChainStep`` in the CUDA source."""

    _fields_ = [
        ("form", ctypes.c_int),
        ("width_in", ctypes.c_int),
        ("width_out", ctypes.c_int),
        ("q", ctypes.c_int),
        ("normal", ctypes.c_int),
        ("c", ctypes.c_float),
        ("a", ctypes.c_void_p),
        ("b", ctypes.c_void_p),
        ("a_stride", ctypes.c_longlong),
        ("b_stride", ctypes.c_longlong),
    ]


class _Args(ctypes.Structure):
    """Mirror of ``struct ChainApplyArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("n_rows", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("f_out", ctypes.c_int),
        ("max_width", ctypes.c_int),
        ("rows_per_tile", ctypes.c_int),
        ("n_steps", ctypes.c_int),
        ("bf16", ctypes.c_int),
        ("out_bf16", ctypes.c_int),
        ("out_stride", ctypes.c_int),
        ("out_col", ctypes.c_int),
        ("path", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("blocks_per_slot", ctypes.c_int),
        ("steps", _Step * MAX_STEPS),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("chain_apply")
            lib.chain_apply_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.chain_apply_launch.restype = ctypes.c_int
            lib.chain_apply_error_string.argtypes = [ctypes.c_int]
            lib.chain_apply_error_string.restype = ctypes.c_char_p
            lib.chain_apply_args_size.argtypes = []
            lib.chain_apply_args_size.restype = ctypes.c_int
            lib.chain_apply_limits.argtypes = [ctypes.c_void_p]
            lib.chain_apply_limits.restype = ctypes.c_int
            if lib.chain_apply_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"chain_apply: ChainApplyArgs is {lib.chain_apply_args_size()} bytes in "
                    f"the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            limits = (ctypes.c_int * 6)()
            lib.chain_apply_limits(limits)
            if tuple(limits) != (MAX_STEPS, MAX_WIDTH, MAX_Q, MAX_SLOTS, NARROW_MAX, THREADS):
                raise RuntimeError("chain_apply: the kernel's limits differ from the wrapper's")
            _lib = lib
        return _lib


def widths(steps: Sequence[Step], f: int):
    """The width before each step and after the last, checked against each
    step's stats (one machine's: a stacked step's leading axis aside)."""
    out = [int(f)]
    for i, s in enumerate(steps):
        w = out[-1]
        if s.form not in range(len(FORM_NAMES)):
            raise ValueError(f"step {i}: unknown form {s.form!r}")
        want = {AFFINE: [(w,), (w,)], CENTER: [(w,), (w,)], IMPUTE: [(w,)],
                PCA: [(w,), None], PCA_INV: [None, None], QUANTILE: [None, None],
                QUANTILE_INV: [None, None]}.get(s.form, [])
        a, b = (None if t is None else t.shape[1:] if s.stacked else t.shape for t in (s.a, s.b))
        for name, t, shape in zip("ab", (a, b), want):
            if t is None or (shape is not None and tuple(t) != shape):
                raise ValueError(f"step {i} ({FORM_NAMES[s.form]}): {name} must be {shape}, got "
                                 f"{None if t is None else tuple(t)}")
        if s.form == PCA and (len(b) != 2 or int(b[0]) != w or not 1 <= b[1] <= w):
            raise ValueError(f"step {i} (pca): the transposed components must be ({w}, k <= {w}), "
                             f"got {tuple(b)}")
        if s.form == PCA_INV and (len(b) != 2 or int(b[0]) != w or int(b[1]) < w or tuple(a) != (int(b[1]),)):
            raise ValueError(f"step {i} (pca_inv): the components must be ({w}, F >= {w}) and the mean "
                             f"(F,), got {tuple(b)} and {tuple(a)}")
        if s.form in (QUANTILE, QUANTILE_INV) and (len(a) != 2 or int(a[1]) != w or tuple(b) != (int(a[0]),)):
            raise ValueError(f"step {i} ({FORM_NAMES[s.form]}): grid must be (Q, {w}) and qs (Q,), got "
                             f"{tuple(a)} and {tuple(b)}")
        out.append(s.width_out(w))
    return out


def rows_per_tile(max_width: int, m: int, n: int, sm_count: int) -> int:
    """The tile path's tile for ``m`` slots of ``n`` rows: the most rows
    (32..256, a power of two) whose two buffers of ``max_width`` floats a
    row fit 32 KB of shared memory and that still give two blocks an SM (a
    short request keeps 32-row tiles, as many blocks as it has)."""
    rows = 256
    while rows > 32 and (2 * rows * max_width * 4 > 32 * 1024 or m * -(-n // rows) < 2 * sm_count):
        rows //= 2
    return rows


class LaunchPlan(NamedTuple):
    path: int
    rows_per_tile: int
    blocks_per_slot: int


def launch_plan(forms: Sequence[int], ws: Sequence[int], m: int, n: int, sm_count: int) -> LaunchPlan:
    """The kernel's path for a chain of step ``forms`` over widths ``ws``
    (:func:`widths`), ``m`` slots of ``n`` rows, and its row tile:

    - elementwise steps alone: the elementwise path, a tile of the slot's
      rows split evenly into spans of about ``EW_TILE_VALUES`` values (a
      grid short of SMs in smaller tiles, as many as there are SMs);
    - a PCA or PCA_INV step, no quantile step, every width at most
      ``NARROW_MAX``: the row path, a row a thread, tiles of
      ``ROW_THREADS_MAX`` rows halved (down to ``ROW_THREADS_MIN``) while
      the grid has fewer tiles than SMs, and as many blocks a slot as
      leave ``ROW_BLOCKS_PER_SM`` an SM (at least one, at most a tile
      each), each walking a run of the slot's tiles;
    - else the tile path (:func:`rows_per_tile`).

    Blocks a slot: a tile each, but on the row path."""
    if set(forms) <= ELEMENTWISE:
        rows = -(-n // -(-n * ws[0] // EW_TILE_VALUES))
        if m * -(-n // rows) < sm_count:
            rows = max(1, min(rows, m * n // sm_count))
        return LaunchPlan(PATH_ELEMENTWISE, rows, -(-n // rows))
    if not set(forms) & {QUANTILE, QUANTILE_INV} and max(ws) <= NARROW_MAX:
        rows = ROW_THREADS_MAX
        while rows > ROW_THREADS_MIN and m * -(-n // rows) < sm_count:
            rows //= 2
        return LaunchPlan(PATH_ROWS, rows, min(-(-n // rows), max(1, ROW_BLOCKS_PER_SM * sm_count // m)))
    rows = rows_per_tile(max(ws), m, n, sm_count)
    return LaunchPlan(PATH_TILE, rows, -(-n // rows))


def _slots(x: torch.Tensor, steps: Sequence[Step], idx, n_rows):
    """``(M, idx, n_rows)`` of a call, checked: M None for one set of stats
    (every leading axis of ``x`` is rows), else ``x`` is (m, n, F) and
    ``idx``/``n_rows`` are per-slot (host ints, or int32 tensors on the
    rows' device that their maker checked)."""
    from gordo_tpu_torch.kernels.fleet_score import slot_ints

    M = machines_of(steps)
    if M is None:
        if idx is not None or n_rows is not None:
            raise ValueError("idx and n_rows need stacked steps")
        return None, None, None
    if x.dim() != 3:
        raise ValueError(f"stacked steps take rows (m, n, F), got {tuple(x.shape)}")
    m, n = int(x.shape[0]), int(x.shape[1])
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"x must have 1..{MAX_SLOTS} slots, got {m}")
    if idx is None:
        if m != M:
            raise ValueError(f"without idx, x needs one slot per machine ({m} != {M})")
    else:
        idx = slot_ints(idx, "idx", 0, M - 1, x.device)
        if idx.numel() != m:
            raise ValueError(f"idx needs one entry per slot ({idx.numel()} != {m})")
    if n_rows is not None:
        n_rows = slot_ints(n_rows, "n_rows", 1, n, x.device)
        if n_rows.numel() != m:
            raise ValueError(f"n_rows needs one entry per slot ({n_rows.numel()} != {m})")
    return M, idx, n_rows


def _out_buffer(x: torch.Tensor, f_out: int, out_dtype: torch.dtype, out: Optional[torch.Tensor],
                out_col: int) -> torch.Tensor:
    """The tensor a call writes: a new (..., n, f_out) one, or ``out``
    (..., n, W), checked, whose columns ``out_col .. out_col + f_out`` the
    call writes."""
    if out is None:
        if out_col:
            raise ValueError("out_col needs out")
        return torch.empty((*x.shape[:-1], f_out), dtype=out_dtype, device=x.device)
    if (out.shape[:-1] != x.shape[:-1] or out.dtype != out_dtype or out.device != x.device
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {out_dtype} tensor {tuple(x.shape[:-1])} + (W,) on "
                         f"{x.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if not 0 <= out_col <= int(out.shape[-1]) - f_out:
        raise ValueError(f"columns {out_col}..{out_col + f_out - 1} do not lie in out's {int(out.shape[-1])}")
    return out


def chain_apply(x: torch.Tensor, steps: Sequence[Step], *, idx=None, n_rows=None,
                out_dtype: torch.dtype = torch.float32, out: Optional[torch.Tensor] = None,
                out_col: int = 0) -> torch.Tensor:
    """``x`` (..., n, F) through ``steps`` in order.

    With one set of stats a step, the leading axes are rows too.  With
    stacked steps (:func:`stack_steps`, M machines) ``x`` is (m, n, F):
    slot ``s`` goes through machine ``idx[s]``'s stats (default: slot s is
    machine s, m == M), over its first ``n_rows[s]`` rows (default n;
    output rows past them are unspecified).  ``x`` and the stats are
    stored at one type, float32 or bfloat16; the output is ``out_dtype``
    (float32, or bfloat16 from bfloat16 storage), computed in float32
    either way.  With ``out`` (the shape of the output but ``W`` columns
    wide, at ``out_dtype``) the call writes its columns ``out_col ..`` and
    returns ``out``."""
    stats = {t.dtype for s in steps for t in (s.a, s.b) if t is not None}
    if not stats <= {x.dtype} or (out_dtype == torch.bfloat16 and x.dtype != torch.bfloat16):
        raise TypeError(f"chain_apply stores rows and stats at one type, and writes bfloat16 only from "
                        f"bfloat16 storage, got rows {x.dtype}, stats {sorted(map(str, stats))}, out {out_dtype}")
    if x.device.type == "cpu":
        return chain_apply_plain(x, steps, idx=idx, n_rows=n_rows, out_dtype=out_dtype, out=out, out_col=out_col)
    if x.device.type != "cuda":
        raise ValueError(f"chain_apply runs on cuda or cpu tensors, got {x.device}")
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    args, result, M = launch_args(x, steps, idx, n_rows, out_dtype, out, out_col, sm_count)
    if args is None:
        return result
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.chain_apply_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"chain_apply launch failed: {lib.chain_apply_error_string(rc).decode()}")
    global launches, stacked_launches, bf16_launches, inverse_launches
    with _launches_lock:
        launches += 1
        stacked_launches += int(M is not None and not args.bf16)
        bf16_launches += args.bf16
        inverse_launches += int(any(s.inverse for s in steps))
    return result


def launch_args(x: torch.Tensor, steps: Sequence[Step], idx, n_rows, out_dtype: torch.dtype,
                out: Optional[torch.Tensor], out_col: int, sm_count: int):
    """``(args, result, M)``: :func:`chain_apply`'s checked arguments for the
    kernel, planned for ``sm_count`` SMs (None for a call of no rows), its
    output tensor (on ``x``'s device, not yet written) and the stacked
    machine count (None for one set of stats)."""
    if x.dtype not in STORAGE_DTYPES or out_dtype not in STORAGE_DTYPES or x.dim() < 2:
        raise TypeError(f"x must be float32 or bfloat16 (..., n, F) and out_dtype one of the two, got "
                        f"{x.dtype} {tuple(x.shape)} and {out_dtype}")
    if not 1 <= len(steps) <= MAX_STEPS:
        raise NotImplementedError(f"a chain of {len(steps)} transform steps waits for {LIMITS_ITEM}: "
                                  f"chain_apply takes 1..{MAX_STEPS}")
    ws = widths(steps, int(x.shape[-1]))
    if max(ws) > MAX_WIDTH:
        raise NotImplementedError(f"a transform chain {max(ws)} columns wide waits for {LIMITS_ITEM}: "
                                  f"chain_apply takes at most {MAX_WIDTH}")
    M, idx, n_rows = _slots(x, steps, idx, n_rows)
    for s in steps:
        for t in (s.a, s.b):
            if t is not None and (t.device != x.device or not t.is_contiguous()):
                raise ValueError(f"a step's stats must be contiguous on {x.device}")
        if s.form in (QUANTILE, QUANTILE_INV) and not 2 <= int(s.a.shape[-2]) <= MAX_Q:
            raise NotImplementedError(f"a quantile grid of {int(s.a.shape[-2])} entries waits for "
                                      f"{LIMITS_ITEM}: chain_apply takes 2..{MAX_Q}")
    if M is None:
        rows = x.reshape(1, -1, ws[0]).contiguous()
    else:
        rows = x.contiguous()
    m, n = int(rows.shape[0]), int(rows.shape[1])
    result = _out_buffer(x, ws[-1], out_dtype, out, out_col)
    if n == 0:
        return None, result, M
    args = _Args()
    args.x, args.out = rows.data_ptr(), result.data_ptr()
    args.idx = None if idx is None else idx.data_ptr()
    args.n_rows = None if n_rows is None else n_rows.data_ptr()
    args.m, args.n, args.f, args.f_out, args.max_width = m, n, ws[0], ws[-1], max(ws)
    plan = launch_plan([s.form for s in steps], ws, m, n, sm_count)
    args.path, args.rows_per_tile, args.blocks_per_slot = plan
    args.n_steps = len(steps)
    args.bf16 = int(x.dtype == torch.bfloat16)
    args.out_bf16 = int(out_dtype == torch.bfloat16)
    args.out_stride, args.out_col = int(result.shape[-1]), int(out_col)
    args.vec = int(args.out_stride == ws[-1] and rows.data_ptr() % 16 == 0 and result.data_ptr() % 16 == 0)
    for i, s in enumerate(steps):
        st = args.steps[i]
        st.form, st.width_in, st.width_out = int(s.form), ws[i], ws[i + 1]
        st.q = int(s.a.shape[-2]) if s.form in (QUANTILE, QUANTILE_INV) else 0
        st.normal = int(bool(s.normal))
        st.c = float(s.c)
        st.a = None if s.a is None else s.a.data_ptr()
        st.b = None if s.b is None else s.b.data_ptr()
        st.a_stride = int(s.a[0].numel()) if s.stacked and s.a is not None else 0
        st.b_stride = int(s.b[0].numel()) if s.stacked and s.b is not None else 0
    args.inputs = (rows, idx, n_rows, steps)  # alive until the launch is enqueued
    return args, result, M


def chain_apply_union(x: torch.Tensor, branches: Sequence[Sequence[Step]], *,
                      out_dtype: torch.dtype = torch.float32, **kw) -> torch.Tensor:
    """Each branch's steps over ``x``, the outputs side by side along the
    features (a ``FeatureUnion``): one :func:`chain_apply` launch a branch,
    each writing its columns of one output.  ``kw`` (``idx``, ``n_rows``)
    go to every launch."""
    ws = [widths(steps, int(x.shape[-1]))[-1] for steps in branches]
    out = torch.empty((*x.shape[:-1], sum(ws)), dtype=out_dtype, device=x.device)
    col = 0
    for steps, w in zip(branches, ws):
        chain_apply(x, steps, out_dtype=out_dtype, out=out, out_col=col, **kw)
        col += w
    return out


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

_CEPHES = {
    "p0": [-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
           1.39312609387279679503E1, -1.23916583867381258016E0],
    "q0": [1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
           -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
           1.59056225126211695515E1, -1.18331621121330003142E0],
    "p1": [4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
           4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
           -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4],
    "q1": [1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
           1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
           -3.80806407691578277194E-2, -9.33259480895457427372E-4],
    "p2": [3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
           1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
           3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9],
    "q2": [1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
           2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
           2.89247864745380683936E-6, 6.79019408009981274425E-9],
}


def _polyval(name: str, x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros_like(x)
    for p in np.asarray(_CEPHES[name], np.float32):
        y = fma(y, x, torch.full_like(x, float(p)))
    return y


def ndtri_plain(p: torch.Tensor) -> torch.Tensor:
    """``jax._src.scipy.special._ndtri`` in float32, every branch computed
    and selected as the reference does."""
    f = np.float32
    thr_hi, thr_lo = float(f(-np.expm1(-2.0))), float(f(np.exp(-2.0)))
    mcp = torch.where(p > thr_hi, 1.0 - p, p)
    s = torch.where(mcp == 0.0, torch.full_like(p, 0.5), mcp)
    w = s - 0.5
    ww = w * w
    big = (w + (w * ww) * (_polyval("p0", ww) / _polyval("q0", ww))) * -float(f(np.sqrt(2.0 * np.pi)))
    z = torch.sqrt(-2.0 * torch.log(s))
    first = z - torch.log(z) / z
    iz = 1.0 / z
    small = _polyval("p2", iz) / _polyval("q2", iz) / z
    other = _polyval("p1", iz) / _polyval("q1", iz) / z
    x = torch.where(s > thr_lo, big, torch.where(z >= 8.0, first - small, first - other))
    x = torch.where(p > float(f(1.0 - np.exp(-2.0))), x, -x)
    return torch.where(p == 0.0, -torch.inf, torch.where(p == 1.0, torch.inf, x))


#: XLA's float32 ``erf`` (``x * A(x^2) / B(x^2)`` with x clamped to
#: ±3.7439211627767994) and the three polynomials of its float32
#: ``erfc`` (``1 - x E(x^2)`` below 1, ``exp(-x^2) / x * P(1 / x^2)``
#: below 2, ``R`` beyond), as jaxlib's compiled HLO gives them
_XLA_ERF = {
    "A": [0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
          0.18520832239976145, 1.128379143519084],
    "B": [-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
          0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0],
    "E": [7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129, 0.112835854, -0.37612626,
          1.12837911],
    "P": [0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469, -0.494451523, 0.340488,
          -0.274112701, 0.563825965],
    "R": [-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523, 0.42184633, -0.282076746,
          0.564189494],
}


def _horner(name: str, x: torch.Tensor) -> torch.Tensor:
    """XLA's ``p = p * x + c`` from ``p = c0`` on, each step one FMA."""
    cs = np.asarray(_XLA_ERF[name], np.float32)
    y = torch.full_like(x, float(cs[0]))
    for c in cs[1:]:
        y = fma(y, x, torch.full_like(x, float(c)))
    return y


def _flush(v: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 to zero, as XLA:CPU computes with denormals off."""
    return torch.where(v.abs() < float(np.finfo(np.float32).tiny), torch.zeros_like(v), v)


def _erf_plain(x: torch.Tensor) -> torch.Tensor:
    c = float(np.float32(3.7439211627767994))
    x = x.clamp(-c, c)
    x2 = x * x
    return (x * _horner("A", x2)) / _horner("B", x2)


def _erfc_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erfc`` of ``x >= 0`` (ndtr's argument)."""
    x2 = x * x
    small = fma(-x, _horner("E", x2), torch.ones_like(x))
    z = -x2
    p = torch.where(x < 2.0, _horner("P", 1.0 / x2), _horner("R", 1.0 / x2))
    # exp in float64, rounded once: the same on every path of PyTorch's exp
    big = _flush(_flush(torch.exp(z.double()).float()) * (1.0 / x) * p)
    big = torch.where(z < float(np.float32(-88.7228394)), torch.zeros_like(x), big)
    return torch.where(x < 1.0, small, big)


def ndtr_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.ndtr`` (``norm.cdf``) in float32: ``0.5 * (1 +
    erf(w))`` for ``|w| < sqrt(2) / 2``, else ``0.5 * (2 - erfc(|w|))`` or
    ``0.5 * erfc(|w|)``, ``w = x * sqrt(2) / 2``, with XLA's erf and erfc."""
    half_sqrt2 = float(np.float32(0.5) * np.sqrt(2.0, dtype=np.float32))
    w = x * half_sqrt2
    z = w.abs()
    tail = _erfc_plain(z)
    y = torch.where(z < half_sqrt2, 1.0 + _erf_plain(w), torch.where(w > 0.0, 2.0 - tail, tail))
    return _flush(0.5 * y)


def _interp_cols(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` of each column ``j`` of ``x`` (n, F) on ``xp[j]``
    onto ``fp[j]`` (each (F, Q))."""
    Q = int(xp.shape[1])
    # searchsorted(side='right'): the count of entries <= x; NaN lands at Q
    i = (~(xp[None] > x[..., None])).sum(-1)                        # (n, F)
    i = i.clamp(1, Q - 1)

    def at(t, k):
        return torch.gather(t, 1, k.t()).t()

    x0, x1, f0, f1 = at(xp, i - 1), at(xp, i), at(fp, i - 1), at(fp, i)
    df, dx, delta = f1 - f0, x1 - x0, x - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    out = torch.where(dx0, f0, fma(delta / torch.where(dx0, torch.ones_like(dx), dx), df, f0))
    out = torch.where(x < xp[:, 0], fp[:, 0], out)
    return torch.where(x > xp[:, -1], fp[:, -1], out)


def interp_plain(x: torch.Tensor, grid: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` of each column of ``x`` (n, F) on its column of
    ``grid`` (Q, F) onto ``qs`` (Q,)."""
    cols = grid.t().contiguous()                                   # (F, Q)
    return _interp_cols(x, cols, qs.expand_as(cols))


def interp_inverse_plain(u: torch.Tensor, grid: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """The inverse: ``jnp.interp`` of each column of ``u`` (n, F) on
    ``qs`` (Q,) onto its column of ``grid`` (Q, F)."""
    cols = grid.t().contiguous()
    return _interp_cols(u, qs.expand_as(cols), cols)


def _apply_plain(h: torch.Tensor, steps: Sequence[Step]) -> torch.Tensor:
    """Rows ``h`` (n, F) float32 through one machine's ``steps`` (stats
    widened to float32)."""
    f = np.float32
    for s in steps:
        a = None if s.a is None else s.a.float()
        b = None if s.b is None else s.b.float()
        if s.form == AFFINE:
            h = h * a + b
        elif s.form == CENTER:
            h = (h - a) / b
        elif s.form == IMPUTE:
            h = torch.where(torch.isnan(h), a, h)
        elif s.form == MUL:
            h = h * s.c
        elif s.form == ADD:
            h = h + s.c
        elif s.form == LOG1P:
            h = torch.log1p(h)
        elif s.form == EXPM1:
            h = torch.expm1(h)
        elif s.form == PCA:
            h = (h - a) @ b
        elif s.form == PCA_INV:
            h = h @ b + a
        elif s.form == QUANTILE:
            h = interp_plain(h, a, b)
            if s.normal:
                h = ndtri_plain(torch.clamp(h, float(f(1e-6)), float(f(1 - 1e-6))))
        else:
            h = interp_inverse_plain(ndtr_plain(h) if s.normal else h, a, b)
    return h


def chain_apply_plain(x: torch.Tensor, steps: Sequence[Step], *, idx=None, n_rows=None,
                      out_dtype: torch.dtype = torch.float32, out: Optional[torch.Tensor] = None,
                      out_col: int = 0) -> torch.Tensor:
    """:func:`chain_apply` in plain PyTorch, each step rounded as the
    reference's; bfloat16 rows and stats are widened to float32 first, as
    the kernel widens them as it loads.  Stacked steps run slot by slot,
    each slot through its machine's stats as one machine's chain does (so
    that a stacked call equals the per-machine calls bit for bit);
    ``n_rows`` only marks which output rows are meaningful."""
    ws = widths(steps, int(x.shape[-1]))
    result = _out_buffer(x, ws[-1], out_dtype, out, out_col)
    result[..., out_col: out_col + ws[-1]] = _chain_plain(x, steps, idx, n_rows).to(out_dtype)
    return result


def _chain_plain(x: torch.Tensor, steps: Sequence[Step], idx, n_rows) -> torch.Tensor:
    M = machines_of(steps)
    if M is None:
        if idx is not None or n_rows is not None:
            raise ValueError("idx and n_rows need stacked steps")
        h = _apply_plain(x.reshape(-1, int(x.shape[-1])).float(), steps)
        return h.reshape(*x.shape[:-1], int(h.shape[-1]))
    if x.dim() != 3:
        raise ValueError(f"stacked steps take rows (m, n, F), got {tuple(x.shape)}")
    m = int(x.shape[0])
    if idx is None and m != M:
        raise ValueError(f"without idx, x needs one slot per machine ({m} != {M})")
    machines = range(M) if idx is None else [int(i) for i in np.asarray(
        idx.cpu() if isinstance(idx, torch.Tensor) else idx, np.int64)]
    if len(machines) != m or not all(0 <= i < M for i in machines):
        raise ValueError(f"idx needs one entry in [0, {M - 1}] per slot, got {list(machines)} for {m} slots")

    def one(i):
        return [Step(s.form, None if s.a is None else s.a[i], None if s.b is None else s.b[i], s.c, s.normal)
                for s in steps]

    return torch.stack([_apply_plain(x[slot].float(), one(i)) for slot, i in enumerate(machines)])
