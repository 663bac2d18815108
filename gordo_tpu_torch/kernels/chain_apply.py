"""``chain_apply``: a pipeline's transform steps on rows, (n, F) → (n, F') (K12).

Replaces the eager transforms of the JAX package's single-machine path:
each pipeline step's ``transform`` (``gordo_tpu/ops/scalers.py:248-260``
QuantileTransformer, ``:303-305`` SimpleImputer, ``:338-340`` PCA, the
scalers' ``apply``) and the funcs ``FunctionTransformer`` applies
(``gordo_tpu/ops/transformer_funcs.py:11-25``), as ``Pipeline.
_transform_until_final`` runs them step by step and ``serve.score`` fuses
them (``gordo_tpu/serve/scorer.py:240-241``).  The kernel is CUDA C++ for
``sm_90a`` (``gordo_tpu_torch/csrc/chain_apply.cu``, whose header gives
each step's form, its bound and design); :func:`chain_apply_plain` is the
same function in plain PyTorch, in the JAX op order, with an FMA (taken in
float64 and rounded once) where XLA:CPU fuses one.

A chain is a sequence of :class:`Step`: its ``form`` (:data:`AFFINE` ...
:data:`QUANTILE`) and its stats tensors on the rows' device.  Helpers
below make each (:func:`affine_step`, ...).  :func:`unit_linspace` and
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
from typing import Optional, Sequence

import numpy as np
import torch

from gordo_tpu_torch.kernels import build

SOURCE = "gordo_tpu_torch/csrc/chain_apply.cu"
REPLACES = "gordo_tpu/ops/scalers.py:248"

AFFINE, CENTER, IMPUTE, MUL, ADD, LOG1P, EXPM1, PCA, QUANTILE = range(9)
FORM_NAMES = ("affine", "center", "impute", "mul", "add", "log1p", "expm1", "pca", "quantile")
#: the kernel's limits (``CA_MAX_STEPS``, ``CA_MAX_WIDTH``, ``CA_MAX_Q``)
MAX_STEPS = 8
MAX_WIDTH = 128
MAX_Q = 1000
LIMITS_ITEM = "ROADMAP queue 1 item 2 (training breadth: wider transform chains)"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()


@dataclasses.dataclass
class Step:
    """One transform step: ``form`` and its stats on the rows' device.

    ``a``/``b``: AFFINE ``x * a + b`` and CENTER ``(x - a) / b``, each
    (F,); IMPUTE ``a`` the fill (F,); PCA ``a`` the mean (F,) and ``b``
    the components transposed (F, k), so that a row's k outputs read
    neighbouring values; QUANTILE ``a`` the grid (Q, F) and ``b`` the
    unit grid ``qs`` (Q,).  ``c``: MUL's factor and ADD's addend.
    ``normal``: a QUANTILE step's ``output_distribution == "normal"``."""

    form: int
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    c: float = 0.0
    normal: bool = False

    def width_out(self, width_in: int) -> int:
        return int(self.b.shape[1]) if self.form == PCA else width_in


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


def quantile_step(grid, normal: bool, device) -> Step:
    grid = np.asarray(grid, np.float32)
    return Step(QUANTILE, _f32(grid, device), _f32(unit_linspace(grid.shape[0]), device), normal=bool(normal))


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
    ]


class _Args(ctypes.Structure):
    """Mirror of ``struct ChainApplyArgs`` in the CUDA source."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("f", ctypes.c_int),
        ("f_out", ctypes.c_int),
        ("max_width", ctypes.c_int),
        ("n_steps", ctypes.c_int),
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
            limits = (ctypes.c_int * 3)()
            lib.chain_apply_limits(limits)
            if tuple(limits) != (MAX_STEPS, MAX_WIDTH, MAX_Q):
                raise RuntimeError("chain_apply: the kernel's limits differ from the wrapper's")
            _lib = lib
        return _lib


def widths(steps: Sequence[Step], f: int):
    """The width before each step and after the last, checked against each
    step's stats."""
    out = [int(f)]
    for i, s in enumerate(steps):
        w = out[-1]
        if s.form not in range(len(FORM_NAMES)):
            raise ValueError(f"step {i}: unknown form {s.form!r}")
        want = {AFFINE: [(w,), (w,)], CENTER: [(w,), (w,)], IMPUTE: [(w,)],
                PCA: [(w,), None], QUANTILE: [None, None]}.get(s.form, [])
        for name, t, shape in zip("ab", (s.a, s.b), want):
            if t is None or (shape is not None and tuple(t.shape) != shape):
                raise ValueError(f"step {i} ({FORM_NAMES[s.form]}): {name} must be {shape}, got "
                                 f"{None if t is None else tuple(t.shape)}")
        if s.form == PCA and (s.b.dim() != 2 or int(s.b.shape[0]) != w or not 1 <= s.b.shape[1] <= w):
            raise ValueError(f"step {i} (pca): the transposed components must be ({w}, k <= {w}), "
                             f"got {tuple(s.b.shape)}")
        if s.form == QUANTILE and (s.a.dim() != 2 or int(s.a.shape[1]) != w
                                   or tuple(s.b.shape) != (int(s.a.shape[0]),)):
            raise ValueError(f"step {i} (quantile): grid must be (Q, {w}) and qs (Q,), got "
                             f"{tuple(s.a.shape)} and {tuple(s.b.shape)}")
        out.append(s.width_out(w))
    return out


def chain_apply(x: torch.Tensor, steps: Sequence[Step]) -> torch.Tensor:
    """``x`` (..., n, F) float32 through ``steps`` in order; the leading
    axes are rows too."""
    if x.device.type == "cpu":
        return chain_apply_plain(x, steps)
    if x.device.type != "cuda":
        raise ValueError(f"chain_apply runs on cuda or cpu tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() < 2:
        raise TypeError(f"x must be float32 (..., n, F), got {x.dtype} {tuple(x.shape)}")
    if not 1 <= len(steps) <= MAX_STEPS:
        raise NotImplementedError(f"a chain of {len(steps)} transform steps waits for {LIMITS_ITEM}: "
                                  f"chain_apply takes 1..{MAX_STEPS}")
    ws = widths(steps, int(x.shape[-1]))
    if max(ws) > MAX_WIDTH:
        raise NotImplementedError(f"a transform chain {max(ws)} columns wide waits for {LIMITS_ITEM}: "
                                  f"chain_apply takes at most {MAX_WIDTH}")
    for s in steps:
        for t in (s.a, s.b):
            if t is not None and (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()):
                raise ValueError(f"a step's stats must be contiguous float32 on {x.device}")
        if s.form == QUANTILE and not 2 <= int(s.a.shape[0]) <= MAX_Q:
            raise NotImplementedError(f"a quantile grid of {int(s.a.shape[0])} entries waits for "
                                      f"{LIMITS_ITEM}: chain_apply takes 2..{MAX_Q}")
    rows = x.reshape(-1, ws[0]).contiguous()
    n = int(rows.shape[0])
    out = torch.empty((n, ws[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.reshape(*x.shape[:-1], ws[-1])
    args = _Args()
    args.x, args.out = rows.data_ptr(), out.data_ptr()
    args.n, args.f, args.f_out, args.max_width = n, ws[0], ws[-1], max(ws)
    args.n_steps = len(steps)
    for i, s in enumerate(steps):
        st = args.steps[i]
        st.form, st.width_in, st.width_out = int(s.form), ws[i], ws[i + 1]
        st.q = int(s.a.shape[0]) if s.form == QUANTILE else 0
        st.normal = int(bool(s.normal))
        st.c = float(s.c)
        st.a = None if s.a is None else s.a.data_ptr()
        st.b = None if s.b is None else s.b.data_ptr()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.chain_apply_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"chain_apply launch failed: {lib.chain_apply_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return out.reshape(*x.shape[:-1], ws[-1])


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (the product is exact in
    float64), as XLA:CPU's fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


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
        y = _fma(y, x, torch.full_like(x, float(p)))
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


def interp_plain(x: torch.Tensor, grid: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` of each column of ``x`` (n, F) on its column of
    ``grid`` (Q, F) onto ``qs`` (Q,)."""
    Q = int(grid.shape[0])
    cols = grid.t().contiguous()                                   # (F, Q)
    # searchsorted(side='right'): the count of entries <= x; NaN lands at Q
    i = (~(cols[None] > x[..., None])).sum(-1)                     # (n, F)
    i = i.clamp(1, Q - 1)
    x0 = torch.gather(cols, 1, (i - 1).t()).t()
    x1 = torch.gather(cols, 1, i.t()).t()
    f0, f1 = qs[i - 1], qs[i]
    df, dx, delta = f1 - f0, x1 - x0, x - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    out = torch.where(dx0, f0, _fma(delta / torch.where(dx0, torch.ones_like(dx), dx), df, f0))
    out = torch.where(x < grid[0], qs[0], out)
    return torch.where(x > grid[-1], qs[-1], out)


def chain_apply_plain(x: torch.Tensor, steps: Sequence[Step]) -> torch.Tensor:
    """:func:`chain_apply` in plain PyTorch, each step rounded as the
    reference's."""
    widths(steps, int(x.shape[-1]))
    shape = x.shape[:-1]
    h = x.reshape(-1, int(x.shape[-1])).float()
    f = np.float32
    for s in steps:
        if s.form == AFFINE:
            h = h * s.a + s.b
        elif s.form == CENTER:
            h = (h - s.a) / s.b
        elif s.form == IMPUTE:
            h = torch.where(torch.isnan(h), s.a, h)
        elif s.form == MUL:
            h = h * s.c
        elif s.form == ADD:
            h = h + s.c
        elif s.form == LOG1P:
            h = torch.log1p(h)
        elif s.form == EXPM1:
            h = torch.expm1(h)
        elif s.form == PCA:
            h = (h - s.a) @ s.b
        else:
            h = interp_plain(h, s.a, s.b)
            if s.normal:
                h = ndtri_plain(torch.clamp(h, float(f(1e-6)), float(f(1 - 1e-6))))
    return h.reshape(*shape, int(h.shape[-1]))
