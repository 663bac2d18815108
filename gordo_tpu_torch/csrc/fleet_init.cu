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
// 32-bit integer path), so the hashing bounds it; the sort's 8 radix
// passes over shared memory come on top.
//
// Design, simple and right first: blocks [0, value_blocks) draw one value
// per thread (its seed's init key, its leaf's key and its bits: three
// hashes, nothing shared); every later block owns one (length, seed,
// epoch) permutation and runs its rounds as a stable LSD radix sort of
// (key, index) pairs, 8 passes of 4 bits.  A thread owns a contiguous
// chunk of the items, so counting its digits into its own histogram
// column, a digit-major exclusive scan of the 16 x 256 counts, and an
// in-order scatter keep the sort stable.  The pairs live in shared memory
// when the longest permutation's two buffers fit (16 bytes an item: 13,000
// items and more), else in global scratch the wrapper allocates (a year of
// 10-minute rows, 52,560, takes that route).  The QR of each orthogonal
// kernel stays torch.linalg.qr on the device: JAX leaves it to XLA's and
// LAPACK's QR, outside anything that is a kernel of the package.

#include <cuda_runtime.h>
#include <stdint.h>

#define FI_THREADS 256
#define FI_MAX_LEAVES 128
#define FI_MAX_JOBS 16
#define FI_RADIX 16
#define FI_PASSES 8

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
  int n;          // items
  int rounds;     // ceil(3 ln n / ln(2^32 - 1))
  int* out;       // (d, epochs, n)
  int* scratch;   // (d * epochs, 4, n) when sorting in global memory
};

struct FleetInitArgs {
  const int* seeds;  // (d,) uint32 bits
  int d;
  int n_values;
  float* values;     // (d, n_values)
  int n_leaves;
  InitLeaf leaves[FI_MAX_LEAVES];
  int epochs;
  int n_jobs;
  PermJob jobs[FI_MAX_JOBS];
  int value_blocks;
  int shared_sort;
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

__device__ void draw_value(const FleetInitArgs& a) {
  const long long t = (long long)blockIdx.x * FI_THREADS + threadIdx.x;
  if (t >= (long long)a.d * a.n_values) return;
  const int di = (int)(t / a.n_values);
  const int j = (int)(t % a.n_values);
  int l = 0;
  while (l + 1 < a.n_leaves && j >= a.leaves[l + 1].offset) ++l;
  const InitLeaf leaf = a.leaves[l];
  uint32_t ik0, ik1, lk0, lk1;
  threefry(0u, (uint32_t)a.seeds[di], 0u, 0u, ik0, ik1);  // split(PRNGKey(s))[0]
  threefry(ik0, ik1, 0u, leaf.fold, lk0, lk1);             // fold_in(init_key, fold)
  a.values[t] = leaf_value(a, leaf, random_bits(lk0, lk1, (uint32_t)(j - leaf.offset)));
}

// Exclusive scan of one value per thread across the block.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < FI_THREADS / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < FI_THREADS / 32) warp_sums[lane] = s;  // inclusive
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0u : warp_sums[warp - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - v;
}

// One stable pass over 4 bits at `shift`: (sk, sv) -> (dk, dv).
__device__ void radix_pass(const uint32_t* sk, const int* sv, uint32_t* dk, int* dv, int n,
                           int shift, uint32_t* hist, uint32_t* warp_sums) {
  const int t = threadIdx.x;
  const int chunk = (n + FI_THREADS - 1) / FI_THREADS;
  const int lo = min(n, t * chunk), hi = min(n, lo + chunk);
#pragma unroll
  for (int g = 0; g < FI_RADIX; ++g) hist[g * FI_THREADS + t] = 0u;
  for (int i = lo; i < hi; ++i) ++hist[((sk[i] >> shift) & (FI_RADIX - 1)) * FI_THREADS + t];
  __syncthreads();
  // digit-major exclusive scan of the 16 x 256 counts: thread t owns 16
  // consecutive entries
  uint32_t* mine = hist + t * FI_RADIX;
  uint32_t run = 0u;
#pragma unroll
  for (int g = 0; g < FI_RADIX; ++g) {
    const uint32_t c = mine[g];
    mine[g] = run;
    run += c;
  }
  const uint32_t base = block_exclusive_scan(run, warp_sums);
#pragma unroll
  for (int g = 0; g < FI_RADIX; ++g) mine[g] += base;
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const uint32_t k = sk[i];
    const uint32_t pos = hist[((k >> shift) & (FI_RADIX - 1)) * FI_THREADS + t]++;
    dk[pos] = k;
    dv[pos] = sv[i];
  }
  __syncthreads();
}

__device__ void draw_permutation(const FleetInitArgs& a, int pb, uint32_t* smem) {
  __shared__ uint32_t warp_sums[FI_THREADS / 32];
  int j = 0;
  while (pb >= a.d * a.epochs) {  // the blocks of job j come after job j-1's
    pb -= a.d * a.epochs;
    ++j;
  }
  const PermJob job = a.jobs[j];
  const int di = pb / a.epochs, e = pb % a.epochs;
  const int n = job.n;
  uint32_t* hist = smem;
  uint32_t *ka, *kb;
  int *va, *vb;
  if (a.shared_sort) {
    ka = smem + FI_RADIX * FI_THREADS;
    va = (int*)(ka + n);
    kb = (uint32_t*)(va + n);
    vb = (int*)(kb + n);
  } else {
    ka = (uint32_t*)(job.scratch + (size_t)pb * 4 * n);
    va = (int*)(ka + n);
    kb = (uint32_t*)(va + n);
    vb = (int*)(kb + n);
  }
  uint32_t f0, f1, k0, k1;
  threefry(0u, (uint32_t)a.seeds[di], 0u, 1u, f0, f1);  // split(PRNGKey(s))[1]
  threefry(f0, f1, 0u, (uint32_t)e, k0, k1);             // split(fit_key, epochs)[e]
  for (int i = threadIdx.x; i < n; i += FI_THREADS) va[i] = i;
  for (int r = 0; r < job.rounds; ++r) {
    uint32_t n0, n1, s0, s1;
    threefry(k0, k1, 0u, 0u, n0, n1);  // key, sub = split(key)
    threefry(k0, k1, 0u, 1u, s0, s1);
    k0 = n0;
    k1 = n1;
    for (int i = threadIdx.x; i < n; i += FI_THREADS) ka[i] = random_bits(s0, s1, (uint32_t)i);
    __syncthreads();
    for (int p = 0; p < FI_PASSES; p += 2) {
      radix_pass(ka, va, kb, vb, n, 4 * p, hist, warp_sums);
      radix_pass(kb, vb, ka, va, n, 4 * (p + 1), hist, warp_sums);
    }
  }
  int* out = job.out + ((size_t)di * a.epochs + e) * n;
  for (int i = threadIdx.x; i < n; i += FI_THREADS) out[i] = va[i];
}

__global__ void __launch_bounds__(FI_THREADS) fleet_init_kernel(const FleetInitArgs a) {
  extern __shared__ uint32_t smem[];
  if ((int)blockIdx.x < a.value_blocks) {
    draw_value(a);
  } else {
    draw_permutation(a, (int)blockIdx.x - a.value_blocks, smem);
  }
}

extern "C" int fleet_init_args_size() { return (int)sizeof(FleetInitArgs); }

extern "C" const char* fleet_init_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fleet_init_launch(const FleetInitArgs* a, void* stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fleet_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = a->value_blocks;
  for (int j = 0; j < a->n_jobs; ++j) blocks += (long long)a->d * a->epochs;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fleet_init_kernel<<<(unsigned)blocks, FI_THREADS, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
