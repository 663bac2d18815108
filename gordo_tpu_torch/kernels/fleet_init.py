"""``fleet_init``: the JAX package's keys, initial params and epoch
permutations, drawn for many seeds at once (K11).

Replaces the XLA programs of fleet init: ``fleet_keys``
(``gordo_tpu/parallel/fleet.py:190``: ``PRNGKey(seed)`` then ``split``),
``fleet_init`` (``:199``: ``module.init(k, x)["params"]`` under ``vmap``),
the per-epoch keys ``jax.random.split(rng, cfg.epochs)``
(``gordo_tpu/train/fit.py:230``) and ``jax.random.permutation(key,
n_total)`` (``train/fit.py:170``).  The kernel is CUDA C++ for ``sm_90a``
(``gordo_tpu_torch/csrc/fleet_init.cu``, whose header gives its bound and
design); :func:`fleet_init_reference` is the same function in plain
PyTorch, its uint32 arithmetic held in int64 tensors masked to 32 bits.

Both reimplement, without importing them, JAX's threefry2x32 (20 rounds),
its split and fold-in and its partitionable random bits (jax 0.9.0's
default), ``uniform``'s mantissa trick, ``truncated_normal`` and
``normal`` through XLA's f32 ``ErfInv`` polynomial (Giles; the operation
order of XLA's decomposition, with the fused multiply-adds XLA:CPU
contracts it to), ``permutation``'s
shuffle (``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable key-value
sort of fresh random bits), and flax's key per leaf: the init key folded
with the first four bytes of the SHA-1 of the leaf's scope path and its
scope's rng counter (``flax/core/scope.py`` ``_fold_in_static``).  Keys,
bits, uniforms and permutations are JAX's bit for bit; the normals differ
from JAX's only where ``log1p`` does (XLA's own approximation against
CUDA's ``log1pf`` or PyTorch's): a few ulp, the bound set by
``tests/test_torch_fleet_init.py``.

:func:`fleet_init` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises, and adds one to
:data:`launches` per launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_tpu_torch.kernels import build

SOURCE = "gordo_tpu_torch/csrc/fleet_init.cu"
REPLACES = "gordo_tpu/parallel/fleet.py:190"

#: kernel launches so far (the CPU path never counts)
launches = 0
_launches_lock = threading.Lock()

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: a leaf's draws: lecun-normal, standard normal, or its raw random bits
#: (as float32 bit patterns; what the smoke holds bit for bit)
TRUNCATED, NORMAL, RAW = 0, 1, 2

_F32 = np.float32
_SQRT2 = _F32(np.sqrt(2))
#: ``lax.erf(∓2 / sqrt2)`` in f32: ``truncated_normal(-2, 2)``'s uniform range
_TRUNC_LO = np.array(3212073496, np.uint32).view(np.float32)[()]
_TRUNC_HI = np.array(1064589848, np.uint32).view(np.float32)[()]
#: ``truncated_normal``'s clip to the open interval (-2, 2)
_CLIP_LO = np.nextafter(_F32(-2), _F32(np.inf))
_CLIP_HI = np.nextafter(_F32(2), _F32(-np.inf))
#: ``normal``'s uniform range [nextafter(-1, 0), 1)
_NORM_LO = np.nextafter(_F32(-1), _F32(0))
_NORM_HI = _F32(1)
#: flax's variance_scaling constant: the stddev of a unit normal truncated at 2
_TRUNC_STDDEV = _F32(0.87962566103423978)

#: XLA's f32 ErfInv coefficients (w < 5, w >= 5), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

#: the kernel's paths (``csrc/fleet_init.cu``): a permutation's keys,
#: padded to a power of two P of at least 32, are sorted by a warp in
#: registers up to WARP_KEYS (when a launch has WARP_PATH_PERMS of that
#: length or more, or P is below BLOCK_MIN_KEYS), else by one block (a
#: segment of P / 16 keys a warp) up to BLOCK_KEYS, past it by a
#: thread-block cluster of up to CLUSTER_BLOCKS blocks of up to
#: CHUNK_KEYS keys each
WARP, BLOCK, CLUSTER = 0, 1, 2
WARP_KEYS = 1024
WARP_PATH_PERMS = 1024
BLOCK_MIN_KEYS = 256
BLOCK_KEYS = 8192
CLUSTER_BLOCKS = 8
CHUNK_KEYS = 16384
#: the longest permutation a launch takes on the card
MAX_ITEMS = CLUSTER_BLOCKS * CHUNK_KEYS
LONG_SERIES_ITEM = "ROADMAP queue 1 item 20 (long series)"
#: threads a block: a launch whose permutations all take the warp path
#: runs blocks of _WARP_LAUNCH_THREADS, any other blocks of _THREADS (the
#: kernel's ``FI_MAX_THREADS``); a cluster is sized for
#: CLUSTER_CHUNK_KEYS keys a block
_THREADS = 512
_WARP_LAUNCH_THREADS = 256
CLUSTER_CHUNK_KEYS = 8192
_VALUES_PER_BLOCK = 1024
#: a warp's output stage: WARP_KEYS int32, one pad every 32
_WARP_STAGE_BYTES = 4 * (WARP_KEYS + WARP_KEYS // 32)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One drawn kernel of a flax module: its scope ``path`` (e.g.
    ``("dense_0",)``, ``("OptimizedLSTMCell_1", "hf")``), its ``shape`` and
    ``kind`` (:data:`TRUNCATED` lecun-normal, or :data:`NORMAL`, the draws
    an orthogonal kernel's QR takes)."""

    path: Tuple[str, ...]
    shape: Tuple[int, int]
    kind: int

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def fold(self) -> int:
        """flax's ``_fold_in_static`` data of the leaf's key: a kernel is
        its scope's first param, so its rng counter is 1."""
        m = hashlib.sha1()
        for x in (*self.path, 1):
            m.update(x.encode("utf-8") if isinstance(x, str)
                     else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        return int.from_bytes(m.digest()[:4], byteorder="big")

    @property
    def scale(self) -> np.float32:
        """lecun_normal's stddev ``sqrt(1 / fan_in) / 0.8796...`` in f32 (1
        for a normal leaf)."""
        if self.kind != TRUNCATED:
            return _F32(1)
        return np.sqrt(_F32(1.0 / self.shape[0])) / _TRUNC_STDDEV


def shuffle_rounds(n: int) -> int:
    """``jax.random.permutation``'s number of sort rounds for ``n`` items."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


# -- the plain version: uint32 in int64 tensors ------------------------------

def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(key: Tuple[torch.Tensor, torch.Tensor], x0: torch.Tensor, x1: torch.Tensor):
    """JAX's threefry2x32 hash of counts ``(x0, x1)`` under ``key``
    (uint32 values in int64 tensors that broadcast together)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seeds: torch.Tensor):
    """``PRNGKey(seed)`` of each seed, as JAX's 32-bit mode makes it: ``(0,
    seed mod 2**32)``."""
    seeds = seeds.to(torch.int64) & MASK
    return torch.zeros_like(seeds), seeds


def split(key, num: int):
    """``jax.random.split(key, num)``: keys ``(k0, k1)``, each with a
    trailing axis of ``num``."""
    k0, k1 = (k.unsqueeze(-1) for k in key)
    count = torch.arange(num, dtype=torch.int64, device=k0.device)
    return threefry2x32((k0, k1), torch.zeros_like(count), count)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key[0].device) & MASK
    return threefry2x32(key, torch.zeros_like(data), data)


def random_bits(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` of each key (partitionable
    mode): a trailing axis of ``n``."""
    if n >= 2 ** 32:
        raise ValueError(f"random_bits takes fewer than 2**32 counts, got {n}")
    k0, k1 = (k.unsqueeze(-1) for k in key)
    count = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32((k0, k1), torch.zeros_like(count), count)
    return y0 ^ y1


def _f32(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once, as a fused multiply-add
    (XLA:CPU contracts the products of ``uniform`` and ``ErfInv`` into
    FMAs): the product is exact in f64, the sum is rounded to odd in f64
    (53 bits, two more than f32 needs), so its rounding to f32 is the
    FMA's."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, np.inf), torch.full_like(s, -np.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def uniform(bits: torch.Tensor, lo: np.float32, hi: np.float32) -> torch.Tensor:
    """``jax.random.uniform``'s map of 32 random bits to [lo, hi) in f32."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - _f32(1.0).to(bits.device)
    lo_t = _f32(lo).to(bits.device)
    return torch.maximum(lo_t, fma(floats, _f32(_F32(hi) - _F32(lo)).to(bits.device), lo_t))


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv`` (Giles), operation for operation, its
    polynomial steps fused multiply-adds as XLA:CPU emits them."""
    dev = u.device
    w = -torch.log1p(u * -u)
    lt = w < _f32(5).to(dev)
    c = [torch.where(lt, _f32(a).to(dev), _f32(b).to(dev)) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    w = torch.where(lt, w + _f32(-2.5).to(dev), torch.sqrt(w) + _f32(-3).to(dev))
    p = c[0]
    for ci in c[1:]:
        p = fma(p, w, ci)
    return torch.where(u.abs() == _f32(1).to(dev), u * _f32(np.inf).to(dev), p * u)


def leaf_values(key, leaf: Leaf) -> torch.Tensor:
    """One leaf's draws (each key's, a trailing axis of ``leaf.size``):
    lecun-normal values for a :data:`TRUNCATED` leaf, standard normals for
    a :data:`NORMAL` one."""
    bits = random_bits(key, leaf.size)
    dev = bits.device
    if leaf.kind == RAW:
        return (bits - (bits >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32).view(torch.float32)
    if leaf.kind == TRUNCATED:
        out = _f32(_SQRT2).to(dev) * erf_inv(uniform(bits, _TRUNC_LO, _TRUNC_HI))
        out = torch.clamp(out, _f32(_CLIP_LO).to(dev), _f32(_CLIP_HI).to(dev))
        return out * _f32(leaf.scale).to(dev)
    return _f32(_SQRT2).to(dev) * erf_inv(uniform(bits, _NORM_LO, _NORM_HI))


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` of each key: int64, a trailing
    axis of ``n``."""
    x = torch.arange(n, dtype=torch.int64, device=key[0].device).expand(*key[0].shape, n)
    for _ in range(shuffle_rounds(n)):
        k0, k1 = split(key, 2)
        key, sub = (k0[..., 0], k1[..., 0]), (k0[..., 1], k1[..., 1])
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()


def init_and_fit_keys(seeds: torch.Tensor):
    """``split(PRNGKey(seed))`` of each seed: ``(init_key, fit_key)``."""
    k0, k1 = split(prng_key(seeds), 2)
    return (k0[..., 0], k1[..., 0]), (k0[..., 1], k1[..., 1])


def fleet_init_reference(
    seeds: torch.Tensor, leaves: Sequence[Leaf], n_totals: Sequence[int], epochs: int
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """:func:`fleet_init` in plain PyTorch."""
    seeds = _validate(seeds, leaves, n_totals, epochs)
    init_key, fit_key = init_and_fit_keys(seeds)
    values = torch.cat(
        [leaf_values(fold_in(init_key, leaf.fold), leaf) for leaf in leaves]
        + [torch.empty((seeds.shape[0], 0), dtype=torch.float32, device=seeds.device)], dim=-1)
    epoch_keys = split(fit_key, epochs)
    return values, [permutation(epoch_keys, int(n)).to(torch.int32) for n in n_totals]


def _validate(seeds, leaves, n_totals, epochs) -> torch.Tensor:
    if seeds.dim() != 1 or seeds.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"seeds must be a 1-D integer tensor, got {seeds.dtype} {tuple(seeds.shape)}")
    for n in n_totals:
        if not 1 <= int(n) < 2 ** 31:
            raise ValueError(f"a permutation needs 1..2**31-1 items, got {n}")
    if epochs < 0:
        raise ValueError(f"epochs must be >= 0, got {epochs}")
    for leaf in leaves:
        if leaf.kind not in (TRUNCATED, NORMAL, RAW) or min(leaf.shape) < 1:
            raise ValueError(f"bad leaf {leaf}")
    return seeds.to(torch.int64)


# -- the kernel ----------------------------------------------------------------

class _LeafArgs(ctypes.Structure):
    """Mirror of ``struct InitLeaf`` in the CUDA source."""

    _fields_ = [
        ("fold", ctypes.c_uint32),
        ("kind", ctypes.c_int),
        ("size", ctypes.c_int),
        ("offset", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


class _JobArgs(ctypes.Structure):
    """Mirror of ``struct PermJob`` in the CUDA source."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("rounds", ctypes.c_int),
        ("log_p", ctypes.c_int),
        ("path", ctypes.c_int),
        ("chunk", ctypes.c_int),
        ("first_block", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("out", ctypes.c_void_p),
    ]


MAX_LEAVES = 128
MAX_JOBS = 16


class _Args(ctypes.Structure):
    """Mirror of ``struct FleetInitArgs`` in the CUDA source."""

    _fields_ = [
        ("seeds", ctypes.c_void_p),
        ("d", ctypes.c_int),
        ("n_values", ctypes.c_int),
        ("values", ctypes.c_void_p),
        ("n_leaves", ctypes.c_int),
        ("leaves", _LeafArgs * MAX_LEAVES),
        ("epochs", ctypes.c_int),
        ("n_jobs", ctypes.c_int),
        ("jobs", _JobArgs * MAX_JOBS),
        ("value_first_block", ctypes.c_int),
        ("value_blocks_per_seed", ctypes.c_int),
        ("blocks", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("trunc_lo", ctypes.c_float),
        ("trunc_span", ctypes.c_float),
        ("norm_lo", ctypes.c_float),
        ("norm_span", ctypes.c_float),
        ("clip_lo", ctypes.c_float),
        ("clip_hi", ctypes.c_float),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fleet_init")
            lib.fleet_init_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.fleet_init_launch.restype = ctypes.c_int
            lib.fleet_init_error_string.argtypes = [ctypes.c_int]
            lib.fleet_init_error_string.restype = ctypes.c_char_p
            lib.fleet_init_args_size.argtypes = []
            lib.fleet_init_args_size.restype = ctypes.c_int
            if lib.fleet_init_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(
                    f"fleet_init: FleetInitArgs is {lib.fleet_init_args_size()} bytes "
                    f"in the library but {ctypes.sizeof(_Args)} in the wrapper"
                )
            _lib = lib
        return _lib


def padded_keys(n: int) -> int:
    """P: ``n`` sort keys padded to a power of two, at least 32 (a warp)."""
    return max(32, 1 << (int(n) - 1).bit_length())


def path_of(n: int, perms: int = WARP_PATH_PERMS) -> int:
    """The path that sorts ``perms`` permutations of ``n`` items in a
    launch: :data:`WARP` (many short ones: a warp each, the fewest
    instructions), :data:`BLOCK` (a block each: a few short ones sort in
    less time so) or :data:`CLUSTER`."""
    p = padded_keys(n)
    if p <= WARP_KEYS and (perms >= WARP_PATH_PERMS or p < BLOCK_MIN_KEYS):
        return WARP
    return BLOCK if p <= BLOCK_KEYS else CLUSTER


@dataclasses.dataclass(frozen=True)
class Job:
    """One permutation length of a launch: its path, its keys ``2**log_p``,
    the keys a block holds (``chunk``), and its blocks of the grid."""

    n: int
    rounds: int
    path: int
    log_p: int
    chunk: int
    first_block: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's grid: the jobs (in ``n_totals``' order), the value
    blocks after them, the cluster size, the threads a block and the
    dynamic shared memory."""

    jobs: Tuple[Job, ...]
    value_first_block: int
    value_blocks_per_seed: int
    blocks: int
    cluster: int
    threads: int
    smem_bytes: int


def launch_plan(d: int, epochs: int, n_totals: Sequence[int], n_values: int) -> Plan:
    """The grid of one launch: the cluster jobs' blocks first (each
    permutation a whole cluster, so every cluster is one permutation's),
    then the block jobs' (one a permutation), then the warp jobs' (a
    permutation a warp of the block), then the value blocks (1,024 values
    of one seed each), rounded up to whole clusters.  Blocks are of
    _WARP_LAUNCH_THREADS where every permutation takes the warp path,
    else of _THREADS.  Every cluster
    job takes the launch's cluster size, the most any of them needs.
    Raises ``NotImplementedError`` for a permutation of more than
    :data:`MAX_ITEMS` items."""
    for n in n_totals:
        if n > MAX_ITEMS:
            raise NotImplementedError(
                f"a permutation of {n} items waits for {LONG_SERIES_ITEM}: fleet_init sorts at most "
                f"{MAX_ITEMS} items on the card (a cluster of {CLUSTER_BLOCKS} blocks of {CHUNK_KEYS} keys)")
    perms = d * epochs
    paths = [path_of(n, perms) for n in n_totals]
    cluster = max([padded_keys(n) // CLUSTER_CHUNK_KEYS for n, p in zip(n_totals, paths) if p == CLUSTER] + [1])
    cluster = min(cluster, CLUSTER_BLOCKS)
    threads = _WARP_LAUNCH_THREADS if paths and set(paths) == {WARP} else _THREADS
    warps = threads // 32
    jobs: List[Optional[Job]] = [None] * len(n_totals)
    block = 0
    for path in (CLUSTER, BLOCK, WARP):
        for i, n in enumerate(n_totals):
            if paths[i] != path:
                continue
            p = padded_keys(n)
            blocks = perms * cluster if path == CLUSTER else perms if path == BLOCK else -(-perms // warps)
            chunk = p // cluster if path == CLUSTER else p if path == BLOCK else 0
            rounds = shuffle_rounds(int(n))
            if rounds > 2 or (path == WARP and rounds > 1):
                raise AssertionError(f"{rounds} rounds of {n} items on path {path}")
            jobs[i] = Job(int(n), rounds, path, p.bit_length() - 1, chunk, block, blocks)
            block += blocks
    value_blocks = -(-n_values // _VALUES_PER_BLOCK)
    total = block + d * value_blocks
    total = -(-total // cluster) * cluster
    smem = max([_WARP_STAGE_BYTES * warps if WARP in paths else 0]
               + [8 * (j.chunk + j.chunk // 32) + 4 * j.chunk for j in jobs if j.path != WARP])
    return Plan(tuple(jobs), block, value_blocks, total, cluster, threads, smem)


def _args(seeds: torch.Tensor, leaves: Sequence[Leaf], epochs: int, values: torch.Tensor,
          perms: Sequence[torch.Tensor], plan: Plan) -> "_Args":
    """The kernel's arguments: the int64 seeds (the kernel takes each one's
    low 32 bits, ``PRNGKey``'s), the outputs, and the grid of ``plan``."""
    d, n_values = values.shape
    args = _Args()
    args.seeds = seeds.data_ptr()
    args.d, args.n_values = d, n_values
    args.values = values.data_ptr()
    args.n_leaves = len(leaves)
    off = 0
    for i, leaf in enumerate(leaves):
        la = args.leaves[i]
        la.fold, la.kind, la.size, la.offset = leaf.fold, leaf.kind, leaf.size, off
        la.scale = float(leaf.scale)
        off += leaf.size
    args.epochs = epochs
    args.n_jobs = len(plan.jobs)
    for i, (job, out) in enumerate(zip(plan.jobs, perms)):
        ja = args.jobs[i]
        ja.n, ja.rounds, ja.log_p, ja.path, ja.chunk = job.n, job.rounds, job.log_p, job.path, job.chunk
        ja.first_block, ja.blocks, ja.out = job.first_block, job.blocks, out.data_ptr()
    args.value_first_block = plan.value_first_block
    args.value_blocks_per_seed = plan.value_blocks_per_seed
    args.blocks, args.cluster, args.threads, args.smem_bytes = plan.blocks, plan.cluster, plan.threads, plan.smem_bytes
    args.trunc_lo = float(_TRUNC_LO)
    args.trunc_span = float(_TRUNC_HI - _TRUNC_LO)
    args.norm_lo = float(_NORM_LO)
    args.norm_span = float(_NORM_HI - _NORM_LO)
    args.clip_lo, args.clip_hi = float(_CLIP_LO), float(_CLIP_HI)
    return args


def fleet_init(
    seeds: torch.Tensor, leaves: Sequence[Leaf], n_totals: Sequence[int], epochs: int
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The draws of ``seeds`` (D,) in one launch: ``values`` (D, sum of the
    leaves' sizes) float32, each leaf's values row-major at its offset
    (lecun-normal kernels scaled; the standard normals an orthogonal
    kernel's QR takes), and per ``n_totals`` entry the ``(D, epochs, n)``
    int32 permutations of ``split(fit_key, epochs)``'s keys.  On the card
    a permutation of more than :data:`MAX_ITEMS` items raises
    ``NotImplementedError``; the plain version takes any length."""
    if seeds.device.type == "cpu":
        return fleet_init_reference(seeds, leaves, n_totals, epochs)
    if seeds.device.type != "cuda":
        raise ValueError(f"fleet_init runs on cuda or cpu tensors, got {seeds.device}")
    seeds = _validate(seeds, leaves, n_totals, epochs)
    if len(leaves) > MAX_LEAVES or len(n_totals) > MAX_JOBS:
        raise ValueError(f"fleet_init takes at most {MAX_LEAVES} leaves and {MAX_JOBS} "
                         f"permutation lengths, got {len(leaves)} and {len(n_totals)}")
    device = seeds.device
    d = int(seeds.shape[0])
    seeds = seeds.contiguous()
    n_values = sum(leaf.size for leaf in leaves)
    if d * n_values >= 2 ** 31:
        raise ValueError(f"{d} seeds x {n_values} values overflow the kernel's indices")
    values = torch.empty((d, n_values), dtype=torch.float32, device=device)
    perms = [torch.empty((d, epochs, int(n)), dtype=torch.int32, device=device) for n in n_totals]
    plan = launch_plan(d, epochs, [int(n) for n in n_totals], n_values)

    args = _args(seeds, leaves, epochs, values, perms, plan)
    if plan.blocks == 0:
        return values, perms
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"fleet_init's grid of {plan.blocks} blocks is past the card's limit")

    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fleet_init_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fleet_init launch failed: {lib.fleet_init_error_string(rc).decode()}")
    global launches
    with _launches_lock:
        launches += 1
    return values, perms


def bound_bytes(d: int, n_values: int, n_totals: Sequence[int], epochs: int) -> int:
    """Bytes a launch must move: the seeds read, the values and
    permutations written."""
    return 4 * d + 4 * d * n_values + 4 * d * epochs * sum(n_totals)


def bound_ops(d: int, n_values: int, n_totals: Sequence[int], epochs: int) -> int:
    """Integer operations a launch must do: one threefry2x32 (20 rounds of
    an add, a rotate of three operations and a xor, five key injections of
    three adds: ~115 ops) per drawn value and per sort key of each
    permutation's rounds."""
    counts = d * n_values + d * epochs * sum(shuffle_rounds(n) * n for n in n_totals)
    return 115 * counts
