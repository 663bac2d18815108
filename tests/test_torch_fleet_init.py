"""Fleet init (K11) against ``jax.random`` and ``module.init`` on the CPU.

``gordo_tpu_torch.kernels.fleet_init``'s plain version (what the kernel
is held to on the card) reimplements threefry2x32, split, fold-in, random
bits, ``permutation`` and the init's draws.  Bounds:

- keys (``PRNGKey``, ``split``, ``fold_in``), ``random.bits`` and
  ``permutation``: bit for bit;
- lecun-normal kernels (``dense_{i}``, ``out``, LSTM ``kernel_i``) and the
  normals of ``kernel_h``: ``ULP_BOUND`` ulp of float32.  The uniforms are
  JAX's bits (the FMA XLA:CPU contracts ``uniform`` and ``ErfInv``'s
  polynomial into is reproduced exactly); only ``log1p`` differs, PyTorch's
  against XLA's own approximation.  Measured here: 2 ulp over the
  hourglass at 10 tags and 3 at 50 tags (seeds 0, 1, 7, 2**32 - 1; 0.6%
  and 0.8% of the values differ at all), 4 ulp over the LSTM hourglass at
  50 tags (0.9% differ): log1p's ulps, amplified where erfinv is
  steep;
- ``kernel_h`` after its QR: ``QR_TOL`` in r12 (measured 2.4e-6 over the
  LSTM hourglass's 42- to 25-unit gates: the two LAPACK QRs and the
  normals' ulps);
- ``fleet_draws`` against ``tests/torch_parity.py::jax_draws``: the same
  bounds (measured 2 ulp dense; 3 ulp and 8.3e-7 on ``kernel_h`` for the
  small LSTM chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gordo_tpu.models.factories  # noqa: F401 — registers the JAX factories
from gordo_tpu.registry import lookup_factory as jax_factory
from gordo_tpu_torch.kernels import fleet_init as fi
from gordo_tpu_torch.parallel import fleet
from gordo_tpu_torch.registry import lookup_factory
from torch_parity import jax_draws, r12

ULP_BOUND = 4
QR_TOL = 1e-5
SEEDS = (0, 1, 7, 2 ** 32 - 1)


def ulps(ref, got) -> int:
    a = np.asarray(ref, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def key_data(key) -> list:
    return [int(v) for v in np.asarray(jax.random.key_data(key))]


def pair(key, i=0) -> list:
    return [int(key[0].reshape(-1)[i]), int(key[1].reshape(-1)[i])]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_match_jax(seed):
    root = jax.random.PRNGKey(seed)
    init_key, fit_key = jax.random.split(root)
    ours = fi.prng_key(torch.tensor([seed]))
    assert pair(ours) == key_data(root)
    got_init, got_fit = fleet.fleet_keys(np.array([seed], np.uint32))
    assert [int(v) for v in got_init[0]] == key_data(init_key)
    assert [int(v) for v in got_fit[0]] == key_data(fit_key)
    # split into many, fold_in, and random bits of each
    k0, k1 = fi.split(fi.init_and_fit_keys(torch.tensor([seed]))[1], 10)
    for e, want in enumerate(jax.random.split(fit_key, 10)):
        assert pair((k0, k1), e) == key_data(want)
    data = 0x9E3779B9
    folded = fi.fold_in(fi.init_and_fit_keys(torch.tensor([seed]))[0], data)
    assert pair(folded) == key_data(jax.random.fold_in(init_key, np.uint32(data)))
    got = fi.random_bits(fi.init_and_fit_keys(torch.tensor([seed]))[0], 1000)[0].numpy()
    want = np.asarray(jax.random.bits(init_key, (1000,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 144, 576, 768, 4096])
def test_permutation_matches_jax(n):
    assert fi.shuffle_rounds(n) == (0 if n == 1 else 2 if n == 4096 else 1)
    for seed in (0, 7):
        _, fit_key = jax.random.split(jax.random.PRNGKey(seed))
        keys = jax.random.split(fit_key, 3)
        want = np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])
        got = fleet.epoch_permutations(seed, n, 3)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _jax_init(module, seed, sample):
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, module.init(init_key, sample)["params"])


@pytest.mark.parametrize("tags", [10, 50])
def test_feedforward_init_matches_module_init(tags):
    jmodule = jax_factory("AutoEncoder", "feedforward_hourglass")(n_features=tags)
    module = lookup_factory("AutoEncoder", "feedforward_hourglass")(n_features=tags)
    stacked = fleet.fleet_init(module, np.array(SEEDS, np.uint32), device="cpu")
    names = [f"dense_{i}" for i in range(6)] + ["out"]
    for d, seed in enumerate(SEEDS):
        ref = _jax_init(jmodule, seed, jnp.zeros((1, tags), jnp.float32))
        assert sorted(ref) == sorted(names)
        for (W, b), name in zip(stacked, names):
            assert ulps(ref[name]["kernel"], W[d].numpy()) <= ULP_BOUND, (seed, name)
            np.testing.assert_array_equal(b[d].numpy(), ref[name]["bias"])


def test_lstm_init_matches_module_init():
    tags = 50
    jmodule = jax_factory("LSTMAutoEncoder", "lstm_hourglass")(n_features=tags, lookback_window=3)
    module = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(n_features=tags, lookback_window=3)
    seed = 7
    ref = _jax_init(jmodule, seed, jnp.zeros((1, 3, tags), jnp.float32))
    cells, (W, b) = fleet.fleet_init(module, np.array([seed], np.uint32), device="cpu")
    for i, (ki, kh, bias) in enumerate(cells):
        scope = ref[f"OptimizedLSTMCell_{i}"]
        want_ki = np.concatenate([scope[f"i{c}"]["kernel"] for c in "ifgo"], axis=-1)
        want_kh = np.concatenate([scope[f"h{c}"]["kernel"] for c in "ifgo"], axis=-1)
        want_b = np.concatenate([scope[f"h{c}"]["bias"] for c in "ifgo"], axis=-1)
        assert ulps(want_ki, ki[0].numpy()) <= ULP_BOUND, i
        assert r12(want_kh, kh[0].numpy()) <= QR_TOL, i
        np.testing.assert_array_equal(bias[0].numpy(), want_b)
    assert ulps(ref["out"]["kernel"], W[0].numpy()) <= ULP_BOUND
    np.testing.assert_array_equal(b[0].numpy(), ref["out"]["bias"])


@pytest.mark.parametrize("lstm", [False, True], ids=["dense", "lstm"])
def test_fleet_draws_match_jax_draws(lstm):
    dims = fleet.LSTMDims([10, 8, 7, 10]) if lstm else [10, 8, 7, 5, 5, 7, 8, 10]
    n_totals = [144, 512, 768]
    for seed in (0, 2 ** 32 - 1):
        want_params, want_perms = jax_draws(seed, dims, n_totals, 3)
        got_params, got_perms = fleet.fleet_draws(seed, dims, n_totals, 3)
        assert sorted(got_perms) == sorted(want_perms)
        for n in n_totals:
            np.testing.assert_array_equal(got_perms[n], want_perms[n])
        if lstm:
            (want_cells, want_head), (got_cells, got_head) = want_params, got_params
            for (wi, wh, wb), (gi, gh, gb) in zip(want_cells, got_cells):
                assert ulps(wi, gi) <= ULP_BOUND
                assert r12(wh, gh) <= QR_TOL
                np.testing.assert_array_equal(gb, wb)
            want_params, got_params = [want_head], [got_head]
        for (wW, wb), (gW, gb) in zip(want_params, got_params):
            assert ulps(wW, gW) <= ULP_BOUND
            np.testing.assert_array_equal(gb, wb)


def test_one_launch_draws_each_seed_as_alone():
    """``draw_fleet`` of several seeds stacks what each seed draws alone,
    bit for bit (JAX's ``vmap`` of ``module.init``)."""
    dims = fleet.LSTMDims([6, 4, 6])
    seeds = [3, 11, 2 ** 31 + 5]
    (cells, head), perms = fleet.draw_fleet(seeds, dims, [40, 96], 2, device="cpu")
    for d, seed in enumerate(seeds):
        (c1, h1), p1 = fleet.draw_fleet([seed], dims, [40, 96], 2, device="cpu")
        for a, b in zip([t for cell in cells for t in cell] + list(head),
                        [t for cell in c1 for t in cell] + list(h1)):
            torch.testing.assert_close(a[d], b[0], rtol=0, atol=0)
        for n in (40, 96):
            assert torch.equal(perms[n][d], p1[n][0])


def test_plain_version_takes_cpu_tensors_only():
    leaves = fleet.chain_leaves([3, 2, 3])
    values, perms = fi.fleet_init(torch.tensor([1, 2]), leaves, [5], 2)
    assert values.shape == (2, 12) and values.dtype == torch.float32
    assert perms[0].shape == (2, 2, 5) and perms[0].dtype == torch.int32
    with pytest.raises(ValueError, match="cuda or cpu"):
        fi.fleet_init(torch.tensor([1], device="meta"), leaves, [5], 2)
    with pytest.raises(ValueError, match="1-D integer"):
        fi.fleet_init(torch.tensor([1.0]), leaves, [5], 2)
    # the bound: the bytes written against the hashes' operations
    assert fi.bound_bytes(2, 12, [5], 2) == 4 * 2 + 4 * 2 * 12 + 4 * 2 * 2 * 5
    assert fi.bound_ops(2, 12, [5], 2) == 115 * (2 * 12 + 2 * 2 * 5)


# -- the kernel's permutation schedule, emulated -------------------------------
#
# csrc/fleet_init.cu sorts each round's unique unsigned keys (bits_i << 32)
# | i, padded to P = padded_keys(n) with ~0, by one bitonic network: a warp
# of 32 lanes x K registers holds each 32 K-key segment (key e in lane e //
# K, register e % K) for the first stages and the last ten of every later
# level, the stages between run over the whole block's (or cluster's) keys.
# The emulation below runs the same stages in the same places, and round
# 2 gathers round 1's permutation by the sorted low words.

PAD = np.uint64(2 ** 64 - 1)


def _warp_stage(v, base, k, j):
    """Stage (k, j) over segments ``v`` (segments, 32 lanes, K registers)
    whose first keys sit at ``base`` of the network."""
    K = v.shape[2]
    lane = np.arange(32)
    e = base[:, None, None] + lane[None, :, None] * K + np.arange(K)[None, None, :]
    ascending = (e & k) == 0
    if j < K:  # within a thread: registers r and r | j
        rs = [r for r in range(K) if not r & j]
        qs = [r | j for r in rs]
        a, b, up = v[:, :, rs], v[:, :, qs], ascending[:, :, rs]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        v[:, :, rs], v[:, :, qs] = np.where(up, lo, hi), np.where(up, hi, lo)
    else:  # across lanes: the shuffle with lane ^ (j / K)
        m = j // K
        other = v[:, lane ^ m, :]
        keep_min = ((lane & m) == 0)[None, :, None] == ascending
        v[:] = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))


def kernel_sort(keys: np.ndarray, segment: int) -> np.ndarray:
    """The kernel's network over P = len(keys) uint64 keys, a warp holding
    each ``segment`` (32 K) of them in registers."""
    P = len(keys)
    K = segment // 32
    v = keys.copy().reshape(P // segment, 32, K)
    base = np.arange(P // segment) * segment
    log = segment.bit_length() - 1
    for sk in range(1, log + 1):  # warp_sort: every stage of levels 2 .. 32 K
        for sj in range(sk - 1, -1, -1):
            _warp_stage(v, base, 1 << sk, 1 << sj)
    k = 2 * segment
    while k <= P:
        flat = v.reshape(P)
        j = k // 2
        while j >= segment:  # in shared memory, or across the cluster's blocks
            i = np.flatnonzero((np.arange(P) & j) == 0)
            a, b = flat[i], flat[i + j]
            up = (i & k) == 0
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            flat[i], flat[i + j] = np.where(up, lo, hi), np.where(up, hi, lo)
            j //= 2
        for sj in range(log - 1, -1, -1):  # warp_merge: level k's last stages
            _warp_stage(v, base, k, 1 << sj)
        k *= 2
    return v.reshape(P)


def kernel_segment(n: int, perms: int) -> int:
    """The keys a warp holds in registers where ``perms`` permutations of
    ``n`` items take the launch plan's path: all P on the warp path; on the
    block and cluster paths 32 K, K a block's keys over its 512 threads
    (a launch with such a job), from 1 to 32."""
    (job,) = fi.launch_plan(perms, 1, [n], 0).jobs
    if job.path == fi.WARP:
        return 32 << (job.log_p - 5)
    return 32 * min(32, max(1, job.chunk // fi._THREADS))


def kernel_permutation(key, n: int, perms: int = 1, signed: bool = False) -> np.ndarray:
    """``permutation(key, n)`` by the kernel's schedule for a launch of
    ``perms`` such permutations; ``signed`` sorts the same keys as int64
    (the pitfall)."""
    x = np.arange(n)
    for r in range(fi.shuffle_rounds(n)):
        k0, k1 = fi.split(key, 2)
        key, sub = (k0[..., 0], k1[..., 0]), (k0[..., 1], k1[..., 1])
        bits = fi.random_bits(sub, n).numpy().reshape(-1).astype(np.uint64)
        keys = np.full(fi.padded_keys(n), PAD, np.uint64)
        keys[:n] = (bits << np.uint64(32)) | np.arange(n, dtype=np.uint64)
        ordered = (np.sort(keys.view(np.int64)).view(np.uint64) if signed
                   else kernel_sort(keys, kernel_segment(n, perms)))
        low = (ordered[:n] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        x = low if r == 0 else x[low]
    return x


def _jax_epoch_keys(seed, epochs):
    _, fit_key = jax.random.split(jax.random.PRNGKey(seed))
    return jax.random.split(fit_key, epochs)


@pytest.mark.parametrize("n", [1, 2, 144, 768, fi.WARP_KEYS, fi.WARP_KEYS + 1, 1625, 1626, 4096, 52_560])
def test_kernel_schedule_matches_jax(n):
    """The warp path's longest length and the next one, the last one-round
    length and the first two-round one, the block path and a year of
    10-minute rows over a cluster, each as a launch of one permutation and
    of many (a warp each up to 1,024 keys): bit for bit
    ``jax.random.permutation``."""
    assert fi.path_of(fi.WARP_KEYS) == fi.WARP and fi.path_of(fi.WARP_KEYS + 1) == fi.BLOCK
    assert fi.path_of(fi.WARP_KEYS, 1) == fi.BLOCK and fi.path_of(fi.BLOCK_MIN_KEYS // 2, 1) == fi.WARP and fi.path_of(fi.BLOCK_MIN_KEYS // 2 + 1, 1) == fi.BLOCK
    assert fi.shuffle_rounds(1625) == 1 and fi.shuffle_rounds(1626) == 2
    for seed in (0, 7):
        epoch_key = fi.split(fi.init_and_fit_keys(torch.tensor([seed]))[1], 2)
        for e, want_key in enumerate(_jax_epoch_keys(seed, 2)):
            key = (epoch_key[0][..., e], epoch_key[1][..., e])
            want = np.asarray(jax.random.permutation(want_key, n))
            for perms in (1, fi.WARP_PATH_PERMS):
                np.testing.assert_array_equal(kernel_permutation(key, n, perms), want)


def test_signed_keys_would_sort_wrongly():
    """The same composite keys as signed int64 put every key whose bits
    are 2**31 or more first: the permutation is no longer JAX's."""
    n = 768
    (want_key,) = _jax_epoch_keys(0, 1)
    k0, k1 = fi.split(fi.init_and_fit_keys(torch.tensor([0]))[1], 1)
    key = (k0[..., 0], k1[..., 0])
    want = np.asarray(jax.random.permutation(want_key, n))
    np.testing.assert_array_equal(kernel_permutation(key, n), want)
    assert not np.array_equal(kernel_permutation(key, n, signed=True), want)


def test_launch_plan_lays_out_every_path():
    """Warp jobs take a permutation a warp: eight a block of 256 threads
    where every job takes the warp path (the last block of 205 x 5 holds
    one), sixteen a block of 512 beside a block or cluster job; block
    jobs take one block, cluster jobs a whole cluster each, first in the
    grid; the grid is whole clusters; past MAX_ITEMS the card's plan
    raises naming the roadmap item, and the plain version on the CPU
    still draws the permutation."""
    warp_only = fi.launch_plan(205, 5, [768], 0)
    (warp,) = warp_only.jobs
    assert (warp.path, warp.blocks, warp.rounds, warp.log_p) == (fi.WARP, 129, 1, 10)
    assert warp_only.threads == 256
    plan = fi.launch_plan(3, 3, [768, 1025, 52_560, fi.MAX_ITEMS, 100], 367)
    short, block, year, longest, tiny = plan.jobs
    assert (short.path, short.blocks, short.chunk) == (fi.BLOCK, 9, 1024)
    assert (block.path, block.blocks, block.chunk, block.log_p) == (fi.BLOCK, 9, 2048, 11)
    assert plan.cluster == fi.CLUSTER_BLOCKS
    assert (year.path, year.rounds, year.chunk, year.first_block) == (fi.CLUSTER, 2, 8192, 0)
    assert (longest.chunk, longest.first_block) == (fi.CHUNK_KEYS, 72)
    assert (short.first_block, block.first_block) == (144, 153)
    assert (tiny.path, tiny.first_block, tiny.blocks) == (fi.WARP, 162, 1)  # 16 warps a block
    assert plan.value_first_block == 163 and plan.blocks == 168 and plan.blocks % plan.cluster == 0
    assert plan.smem_bytes == 8 * (fi.CHUNK_KEYS + fi.CHUNK_KEYS // 32) + 4 * fi.CHUNK_KEYS
    assert plan.threads == 512
    # beside a cluster job many short permutations take a warp each
    short, cluster = fi.launch_plan(205, 5, [768, 8193], 0).jobs
    assert (short.path, short.blocks, cluster.path) == (fi.WARP, 65, fi.CLUSTER)
    bench = fi.launch_plan(512, 10, [144, 512, 768], 367)
    assert bench.cluster == 1 and {j.path for j in bench.jobs} == {fi.WARP} and bench.threads == 256
    assert fi.launch_plan(1, 10, [576], 58_512).threads == 512  # an LSTM seed: a block job
    with pytest.raises(NotImplementedError, match="item 20"):
        fi.launch_plan(1, 1, [fi.MAX_ITEMS + 1], 0)
    _, (perm,) = fi.fleet_init(torch.tensor([1]), [], [fi.MAX_ITEMS + 1], 1)
    assert torch.equal(perm[0, 0].sort().values, torch.arange(fi.MAX_ITEMS + 1, dtype=torch.int32))
