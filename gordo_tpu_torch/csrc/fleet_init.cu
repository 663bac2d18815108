// fleet_init: the JAX package's keys, initial params and epoch permutations
// for many seeds in one launch (K11).
//
// Replaces the XLA programs of fleet init: `fleet_keys`
// (gordo_tpu/parallel/fleet.py:190, PRNGKey(seed) then split), `fleet_init`
// (:199, `module.init(k, x)["params"]` under vmap), the per-epoch keys
// `jax.random.split(rng, cfg.epochs)` (gordo_tpu/train/fit.py:230) and
// `jax.random.permutation(key, n_total)` (train/fit.py:170).  For seed s:
//
//   init_key, fit_key = split(PRNGKey(s))                   threefry2x32
//   leaf value j      = f(bits(fold_in(init_key, sha1(path)), j))
//       f = clip(sqrt2 * erfinv(uniform(a, b)), ±nextafter(2, 0)) * stddev
//           (lecun_normal) or sqrt2 * erfinv(uniform(nextafter(-1, 0), 1))
//           (the normals an orthogonal kernel's QR takes)
//   perm[e]           = permutation(split(fit_key, epochs)[e], n)
//       rounds of: key, sub = split(key); stable sort of (bits(sub, i), x_i)
//
// Threefry, split, fold-in and partitionable random bits are jax 0.9.0's
// (jax/_src/prng.py); `uniform` is the mantissa trick and one fused
// multiply-add, and erfinv XLA's f32 ErfInv polynomial (Giles) in XLA's
// operation order with the fused multiply-adds XLA:CPU contracts it to, so
// only log1pf differs from XLA's own (a few ulp).  The SHA-1 of each leaf's
// flax scope path is computed once on the host (it depends on the path
// alone); the per-seed fold-ins run here.
//
// Bound: at the bench's bucket (512 seeds of the 10-tag hourglass, 367
// kernel values each, the four fit lengths of 576 rows under
// TimeSeriesSplit(3) and batch 256, 144, 512, 512 and 768 padded rows,
// over 10 epochs) the launch writes 0.75 MB of values and 29 MB of
// permutations: ~9 us at 3.35 TB/s.  It hashes one threefry2x32 (~115
// 32-bit integer ops) per value and per sort key of every round: ~0.86 G
// ops, ~13 us at 67 T 32-bit ops/s (the fp32 rate; the card has no faster
// 32-bit integer path), so the hashing bounds it.  The sort's compares
// come on top: a bitonic network over P keys has log P (log P + 1) / 2
// stages of P / 2 compare-exchanges.
//
// Design.  A round of `permutation` is a stable sort of fresh 32-bit bits
// b_i carrying x.  The unsigned 64-bit keys (b_i << 32) | i are unique and
// sort in the stable sort's order, so any sort of them gives that round's
// order in their low words: round 1's permutation is the low words (x is
// arange(n)), round 2's is round 1's permutation gathered by them.  (As
// signed keys they would sort wrongly wherever b_i >= 2^31.)  The keys are
// padded to P, a power of two of at least 32, with ~0, which sorts after
// every real key, and sorted by one bitonic network: stage (k, j) pairs
// key i with i ^ j and orders the pair ascending where bit k of i is
// clear.  Each key's hash is computed as it is loaded, so nothing but the
// permutation is written.  A warp holds a segment of 32 K keys in
// registers, key e of it in lane e / K, register e % K: stages with j < K
// compare within a thread, the others across lanes by shuffles.  The
// stage loops run at run time: unrolled over every stage, a 1,024-key
// sort is ~10,000 instructions run once each, and a warp waits on their
// fetch (PERF.md).  Where the stages run depends on P and on how many
// permutations a launch has:
//
// - P <= 1,024 in a launch of at least 1,024 such permutations (the
//   bench's 144, 512 and 768, one round), or P < 256: a warp owns a
//   permutation (K = P / 32), one a warp of the block, no barrier.  The
//   low words leave through a skewed stage in shared memory, so the
//   stores are coalesced.  Throughput: the fewest instructions.
// - Else P <= 8,192 (an LSTM fit's ten epochs, up to 1,625 items one
//   round, then two): one block, the keys in shared memory (a pad every
//   32 keys keeps a warp's rows off one bank), each warp one segment of P
//   / 16 keys (K up to 32).  The warps sort their segments in registers,
//   then each later level runs its stages j >= 32 K in shared memory
//   between barriers and its last stages in registers again.  Latency:
//   sixteen warps a permutation.
// - P > 8,192 (a year of 10-minute rows, 52,560, two rounds): a
//   thread-block cluster of C = min(8, P / 8,192) blocks on
//   neighbouring SMs, each holding P / C keys; the stages whose partners
//   lie in another block (6 of 136 a round at a year) compare through
//   distributed shared memory between cluster barriers, each block of the
//   pair taking half.  Round 1's permutation stays where it was sorted,
//   and round 2 gathers it across the cluster.  The longest permutation
//   is 8 x 16,384 = 131,072 items; the wrapper raises past it.
//
// Every launch is a cluster launch (of one block where no job needs more).
// A launch whose permutations all take the warp path runs blocks of 256
// threads, two an SM: short blocks retire and refill sooner (on an H100
// 80GB HBM3 at 700 W, the bench's bucket 0.18 ms against 0.20 in blocks
// of 512).  Any other runs blocks
// of 512, one an SM: more warps a permutation (a year 0.17 ms against
// 0.22 in blocks of 256).  Both are 16 warps an SM at 128 registers
// (PERF.md, scripts/kernel_variants.py).
//
// The values: a block draws 1,024 values of one seed; the seed's init key
// is hashed once a block and each leaf's key once a block, so a value
// costs its one hash of bits.  The QR of each orthogonal kernel stays
// torch.linalg.qr on the device: JAX leaves it to XLA's and LAPACK's QR,
// outside anything that is a kernel of the package.
//
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace cg = cooperative_groups;

// the most threads a block (the register limit: 128 a thread); a launch
// takes `threads`, blockDim.x in the device code
#define FI_MAX_THREADS 512
#define FI_MAX_LEAVES 128
#define FI_MAX_JOBS 16
#define FI_WARP_KEYS 1024                            // 32 lanes x 32 registers
#define FI_WARP_STAGE (FI_WARP_KEYS + FI_WARP_KEYS / 32)  // a warp's skewed output stage
#define FI_VALUES_PER_BLOCK 1024

// a job's path: a warp, a block or a cluster of blocks a permutation
#define FI_WARP 0
#define FI_BLOCK 1
#define FI_CLUSTER 2

// Mirrored field by field by `_LeafArgs`, `_JobArgs` and `_Args` in
// gordo_tpu_torch/kernels/fleet_init.py; fleet_init_args_size() lets the
// wrapper check the two agree.
struct InitLeaf {
  uint32_t fold;  // flax's fold-in data: sha1(path, counter)[:4], big endian
  int kind;       // 0 truncated normal (lecun), 1 normal, 2 the raw bits
  int size;       // rows x cols
  int offset;     // into a seed's row of values
  float scale;    // lecun stddev (1 for a normal leaf)
};

struct PermJob {
  int n;            // items
  int rounds;       // ceil(3 ln n / ln(2^32 - 1)): 0 (n 1), 1 or 2
  int log_p;        // the keys padded to P = 2^log_p
  int path;         // FI_WARP, FI_BLOCK or FI_CLUSTER
  int chunk;        // keys a block holds (FI_BLOCK: P; FI_CLUSTER: P / cluster)
  int first_block;  // the job's blocks in the grid: [first_block, +blocks)
  int blocks;
  int* out;         // (d, epochs, n)
};

struct FleetInitArgs {
  const long long* seeds;  // (d,) int64: a seed is its low 32 bits
  int d;
  int n_values;
  float* values;     // (d, n_values)
  int n_leaves;
  InitLeaf leaves[FI_MAX_LEAVES];
  int epochs;
  int n_jobs;
  PermJob jobs[FI_MAX_JOBS];
  int value_first_block;      // d * value_blocks_per_seed value blocks from here
  int value_blocks_per_seed;
  int blocks;                 // the grid, a multiple of `cluster`
  int cluster;                // blocks of a cluster
  int threads;                // threads a block: 256 or FI_MAX_THREADS
  int smem_bytes;
  float trunc_lo, trunc_span;  // erf(-2/sqrt2), erf(2/sqrt2) - erf(-2/sqrt2)
  float norm_lo, norm_span;    // nextafter(-1, 0), 1 - nextafter(-1, 0)
  float clip_lo, clip_hi;      // nextafter(-2, inf), nextafter(2, -inf)
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// 32 random bits at count i of key (k0, k1), partitionable mode
__device__ __forceinline__ uint32_t random_bits(uint32_t k0, uint32_t k1, uint32_t i) {
  uint32_t y0, y1;
  threefry(k0, k1, 0u, i, y0, y1);
  return y0 ^ y1;
}

// XLA's f32 ErfInv, operation for operation (FMAs where XLA:CPU contracts)
__device__ __forceinline__ float erf_inv(float u) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                        0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
                        1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
                        0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
                        2.83297682f};
  const float w = -log1pf(__fmul_rn(u, -u));
  const bool lt = w < 5.0f;
  const float ww = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(__fsqrt_rn(w), -3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, ww, lt ? lt5[i] : ge5[i]);
  return fabsf(u) == 1.0f ? __fmul_rn(u, __int_as_float(0x7f800000)) : __fmul_rn(p, u);
}

__device__ __forceinline__ float leaf_value(const FleetInitArgs& a, const InitLeaf& leaf,
                                            uint32_t bits) {
  const float sqrt2 = __int_as_float(0x3FB504F3);
  if (leaf.kind == 2) return __uint_as_float(bits);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  if (leaf.kind == 0) {
    const float u = fmaxf(a.trunc_lo, __fmaf_rn(f, a.trunc_span, a.trunc_lo));
    const float v = fminf(fmaxf(__fmul_rn(sqrt2, erf_inv(u)), a.clip_lo), a.clip_hi);
    return __fmul_rn(v, leaf.scale);
  }
  const float u = fmaxf(a.norm_lo, __fmaf_rn(f, a.norm_span, a.norm_lo));
  return __fmul_rn(sqrt2, erf_inv(u));
}

// -- the values ----------------------------------------------------------

// Values [lo, lo + FI_VALUES_PER_BLOCK) of one seed: its init key hashed
// once, each leaf's key once (the leaf table copied to shared memory),
// then one hash of bits a value.
__device__ void draw_values(const FleetInitArgs& a, int vb) {
  __shared__ uint32_t init_key[2];
  __shared__ uint32_t leaf_key[FI_MAX_LEAVES][2];
  __shared__ InitLeaf leaf[FI_MAX_LEAVES];
  const int t = threadIdx.x;
  const int di = vb / a.value_blocks_per_seed;
  const int lo = (vb % a.value_blocks_per_seed) * FI_VALUES_PER_BLOCK;
  const int hi = min(a.n_values, lo + FI_VALUES_PER_BLOCK);
  if (t == 0) threefry(0u, (uint32_t)a.seeds[di], 0u, 0u, init_key[0], init_key[1]);  // split(PRNGKey(s))[0]
  __syncthreads();
  if (t < a.n_leaves) {  // fold_in(init_key, fold)
    leaf[t] = a.leaves[t];
    threefry(init_key[0], init_key[1], 0u, leaf[t].fold, leaf_key[t][0], leaf_key[t][1]);
  }
  __syncthreads();
  int l = 0;
  for (int j = lo + t; j < hi; j += blockDim.x) {
    while (l + 1 < a.n_leaves && j >= leaf[l + 1].offset) ++l;
    a.values[(size_t)di * a.n_values + j] =
        leaf_value(a, leaf[l], random_bits(leaf_key[l][0], leaf_key[l][1], (uint32_t)(j - leaf[l].offset)));
  }
}

// -- the permutations -----------------------------------------------------

// the key of a permutation: split(split(PRNGKey(s))[1], epochs)[e]
__device__ __forceinline__ void epoch_key(const FleetInitArgs& a, int di, int e, uint32_t& k0,
                                          uint32_t& k1) {
  uint32_t f0, f1;
  threefry(0u, (uint32_t)a.seeds[di], 0u, 1u, f0, f1);
  threefry(f0, f1, 0u, (uint32_t)e, k0, k1);
}

// key, sub = split(key): a round's bits are random_bits(sub, i)
__device__ __forceinline__ void next_round(uint32_t& k0, uint32_t& k1, uint32_t& s0, uint32_t& s1) {
  uint32_t n0, n1;
  threefry(k0, k1, 0u, 0u, n0, n1);
  threefry(k0, k1, 0u, 1u, s0, s1);
  k0 = n0;
  k1 = n1;
}

// item i's unique key of a round, ~0 past n
__device__ __forceinline__ uint64_t sort_key(uint32_t s0, uint32_t s1, int i, int n) {
  return i < n ? ((uint64_t)random_bits(s0, s1, (uint32_t)i) << 32) | (uint32_t)i : ~0ull;
}

// A permutation of n <= 32 K items (one round) by the calling warp.
template <int K>
__device__ void warp_permutation(const FleetInitArgs& a, const PermJob& job, int p, uint32_t* stage) {
  const int lane = threadIdx.x & 31;
  const int n = job.n;
  int* out = job.out + (size_t)p * n;
  if (job.rounds == 0) {
    for (int i = lane; i < n; i += 32) out[i] = i;
    return;
  }
  uint32_t k0, k1, s0, s1;
  epoch_key(a, p / a.epochs, p % a.epochs, k0, k1);
  next_round(k0, k1, s0, s1);
  uint64_t v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = sort_key(s0, s1, lane * K + r, n);
  warp_sort<K>(v, 0);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = lane * K + r;
    stage[i + (i >> 5)] = (uint32_t)v[r];
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) out[i] = (int)stage[i + (i >> 5)];
}

// Every 32 K-key segment of the block's keys loaded into a warp's
// registers, run through `stages`, stored back.
template <int K, typename Stages>
__device__ __forceinline__ void each_segment(uint64_t* keys, int chunk, Stages stages) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int seg = warp * 32 * K; seg < chunk; seg += blockDim.x * K) {
    uint64_t v[K];
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = keys[kpad(seg + lane * K + r)];
    stages(v, seg);
#pragma unroll
    for (int r = 0; r < K; ++r) keys[kpad(seg + lane * K + r)] = v[r];
  }
}

// The network over the P = C chunk keys of a cluster (C 1: one block);
// this block holds indices rank * chunk ..., its warps segments of 32 K
// (K = min(32, chunk / blockDim.x): each warp one segment up to 16,384
// keys a block of 512).  On return every key is in place and every block of the
// cluster has passed a barrier.
template <int K>
__device__ void sort_keys(uint64_t* keys, int chunk, int log_p, int C, int rank) {
  constexpr int SEG = 32 * K;
  const int base = rank * chunk;
  const int P = 1 << log_p;
  __syncthreads();
  each_segment<K>(keys, chunk, [&](uint64_t(&v)[K], int seg) { warp_sort<K>(v, base + seg); });
  for (int k = 2 * SEG; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= SEG; j >>= 1) {
      if (j >= chunk) {
        // the partner block is rank ^ (j / chunk); the block of the pair
        // holding the lower indices orders the first half of the pairs,
        // the other the second half
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        const int step = j / chunk;
        const bool upper = rank & step;
        uint64_t* other = cluster.map_shared_rank(keys, rank ^ step);
        uint64_t* lo = upper ? other : keys;
        uint64_t* hi = upper ? keys : other;
        const int lo_base = (rank & ~step) * chunk;
        const int from = upper ? chunk / 2 : 0;
        for (int i = from + threadIdx.x; i < from + chunk / 2; i += blockDim.x)
          order_shared(lo + kpad(i), hi + kpad(i), ((lo_base + i) & k) == 0);
        cluster.sync();
        continue;
      }
      __syncthreads();
      for (int q = threadIdx.x; q < chunk / 2; q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        order_shared(keys + kpad(i), keys + kpad(i + j), ((base + i) & k) == 0);
      }
    }
    __syncthreads();
    each_segment<K>(keys, chunk, [&](uint64_t(&v)[K], int seg) { warp_merge<K>(v, base + seg, k); });
  }
  if (C > 1) {
    cg::this_cluster().sync();
    return;
  }
  __syncthreads();
}

__device__ void sort_chunk(uint64_t* keys, int chunk, int log_p, int C, int rank) {
  // K: each warp one segment (some idle below 32 keys a warp), or several at K 32
  switch (max(1, chunk / (int)blockDim.x)) {
    case 1: sort_keys<1>(keys, chunk, log_p, C, rank); break;
    case 2: sort_keys<2>(keys, chunk, log_p, C, rank); break;
    case 4: sort_keys<4>(keys, chunk, log_p, C, rank); break;
    case 8: sort_keys<8>(keys, chunk, log_p, C, rank); break;
    case 16: sort_keys<16>(keys, chunk, log_p, C, rank); break;
    default: sort_keys<32>(keys, chunk, log_p, C, rank); break;
  }
}

// A permutation by a block (C 1) or by the cluster of C blocks this one
// belongs to (rank `rank`).
__device__ void block_permutation(const FleetInitArgs& a, const PermJob& job, int local, uint8_t* smem) {
  const int C = job.path == FI_CLUSTER ? a.cluster : 1;
  const int p = local / C, rank = local % C;
  const int chunk = job.chunk, n = job.n, base = rank * chunk;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  int* x = reinterpret_cast<int*>(keys + kpad(chunk));  // round 1's permutation, this block's part
  int* out = job.out + (size_t)p * n;
  uint32_t k0, k1, s0, s1;
  epoch_key(a, p / a.epochs, p % a.epochs, k0, k1);
  next_round(k0, k1, s0, s1);
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) keys[kpad(i)] = sort_key(s0, s1, base + i, n);
  sort_chunk(keys, chunk, job.log_p, C, rank);
  if (job.rounds == 1) {
    for (int i = threadIdx.x; i < chunk && base + i < n; i += blockDim.x) out[base + i] = (int)(uint32_t)keys[kpad(i)];
    return;
  }
  // round 2 sorts new keys of the positions 0 .. n - 1 and gathers round
  // 1's permutation by their low words
  next_round(k0, k1, s0, s1);
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    x[i] = (int)(uint32_t)keys[kpad(i)];
    keys[kpad(i)] = sort_key(s0, s1, base + i, n);
  }
  sort_chunk(keys, chunk, job.log_p, C, rank);
  const int log_chunk = 31 - __clz(chunk);
  for (int i = threadIdx.x; i < chunk && base + i < n; i += blockDim.x) {
    const uint32_t src = (uint32_t)keys[kpad(i)];
    out[base + i] = C > 1 ? *cg::this_cluster().map_shared_rank(x + (src & (chunk - 1)), (int)(src >> log_chunk))
                          : x[src];
  }
  if (C > 1) cg::this_cluster().sync();  // no block leaves while another reads its x
}

__device__ void draw_permutation(const FleetInitArgs& a, const PermJob& job, int local, uint8_t* smem) {
  if (job.path != FI_WARP) {
    block_permutation(a, job, local, smem);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int p = local * (blockDim.x >> 5) + warp;
  if (p >= a.d * a.epochs) return;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem) + warp * FI_WARP_STAGE;
  switch (job.log_p) {
    case 5: warp_permutation<1>(a, job, p, stage); break;
    case 6: warp_permutation<2>(a, job, p, stage); break;
    case 7: warp_permutation<4>(a, job, p, stage); break;
    case 8: warp_permutation<8>(a, job, p, stage); break;
    case 9: warp_permutation<16>(a, job, p, stage); break;
    default: warp_permutation<32>(a, job, p, stage); break;
  }
}

// `__grid_constant__`: the device functions take the arguments by reference
// without a copy to local memory.  At most 128 registers a thread: 16
// warps an SM in blocks of 256 or of 512.
__global__ void __launch_bounds__(FI_MAX_THREADS, 1)
    fleet_init_kernel(const __grid_constant__ FleetInitArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = (int)blockIdx.x;
  if (b >= a.value_first_block) {
    if (b < a.value_first_block + a.d * a.value_blocks_per_seed) draw_values(a, b - a.value_first_block);
    return;
  }
  for (int j = 0; j < a.n_jobs; ++j) {
    const int first = a.jobs[j].first_block;
    if (b >= first && b < first + a.jobs[j].blocks) {
      draw_permutation(a, a.jobs[j], b - first, smem);
      return;
    }
  }
}

extern "C" int fleet_init_args_size() { return (int)sizeof(FleetInitArgs); }

extern "C" const char* fleet_init_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising, as a cluster launch of
// `cluster` blocks; the shared-memory limit is raised once a device, not
// on every launch.  Returns cudaGetLastError().
extern "C" int fleet_init_launch(const FleetInitArgs* a, void* stream) {
  static int smem_set[64];
  if (a->blocks == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || a->smem_bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(fleet_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = a->smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a->blocks);
  cfg.blockDim = dim3((unsigned)a->threads);
  cfg.dynamicSmemBytes = (size_t)a->smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fleet_init_kernel, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
