// scaler_quantiles: RobustScaler stats of many machines over many row
// lists: NaN-aware linear percentiles, each value taken through the
// chain's earlier steps as it loads.
//
// Replaces `RobustScaler.compute_stats` (gordo_tpu/ops/scalers.py:207-217)
// as `fleet.exact` and `fleet.padded` run it, vmapped per machine
// (gordo_tpu/parallel/anomaly.py:196-214 `_make_scale_chain`, :1124 and
// :1327 the detector scaler on y).  Per machine, row list and column, with
// the non-NaN values sorted as v[0..count):
//
//   jnp.nanpercentile(v, (lo, 50, hi)), as jax._src.numpy.reductions.
//   _quantile computes it with squash_nans=True, in float32:
//     pos = q * (count - 1)             q = p / 100, taken in f32 on the host
//     l = floor(pos), h = ceil(pos)     each clamped to [0, count - 1]
//     hw = pos - floor(pos), lw = 1 - hw
//     quantile = fma(v[h], hw, v[l] * lw)  (XLA:CPU fuses the program's
//                                          v[l] * lw + v[h] * hw so)
//   center = q50, scale = max(q_hi - q_lo, 1e-12)   (the max keeps a NaN)
//   with_centering=False: center 0; with_scaling=False: scale 1.
//
// An all-NaN column has count 0: index 0 reads the NaN key, and the
// column's stats are NaN.  The chain prefix (scaler_prefix.cuh) applies
// the earlier steps' maps at load, so a MinMax step with a negative scale
// reverses the order before the selection, as the reference's sort of the
// transformed values does.
//
// Bound: each value is read once from device memory; the selection runs in
// shared memory.  Bound by device memory.
//
// Design: one block per (column, machine, row list).  The block loads the
// column's rows of its row list into shared memory as order-preserving
// 32-bit keys (a float's bits with the sign folded so that unsigned order
// is float order, -0 before +0; every NaN maps to the largest key, so it
// ranks last), and counts the non-NaN values.  The statistic needs six
// order statistics, not the sorted column, so each is found by a radix
// selection: four passes of an 8-bit digit, each a 256-bin histogram of
// the keys that share the digits chosen so far (shared-memory atomics) and
// one warp's scan to pick the digit holding the wanted rank.  The keys
// never move, so the block needs only n keys of shared memory, no second
// buffer and no padding to a power of two: QS_MAX_ROWS (57,344 rows,
// 229,376 bytes) covers a year of 10-minute rows (52,560).  Ranks that
// coincide are selected once.
//
// The grid variant (`scaler_quantiles_grid_kernel`) takes Q fractions from
// device memory instead of Robust's three and writes every quantile,
// (M, G, Q, F): `QuantileTransformer.fit`'s grid (gordo_tpu/ops/
// scalers.py:240-246, jnp.nanpercentile at jnp.linspace(0, 100, Q)) and
// `SimpleImputer(strategy="median")`'s fill (:288-299, jnp.nanmedian, the
// same _quantile at q = 0.5 with method "midpoint": (v[l] + v[h]) * 0.5).
// Its linear interpolation rounds as the Robust kernel's does, as XLA:CPU's
// program does (measured bit for bit against the JAX package; on a column
// far from zero against its spread, separate roundings moved Robust's
// scale by ulps of the level).  The keys load as above but through no chain prefix
// (the transforms' fits take rows that chain_apply has transformed).
// Bound as above: each value read once, the Q * F outputs written once.
//
// Its first design selected the 2Q ranks one after another by the same
// radix selection, in one block per (column, machine, fit): 800 dependent
// sweeps of the column's keys at Q 100, with ten blocks on 132 SMs for
// one machine's fit.  It ran 29x slower than torch.nanquantile at a year
// of rows (PERF.md).  So the grid now sorts each column once and reads
// every rank from the sorted keys (`scaler_quantiles_grid_sort_kernel`):
//
// - The column's keys (as above; past the row list, the NaN key, which
//   sorts last and is never a rank below the count) are padded to P, a
//   power of two >= QS_SORT_MIN, and sorted by a bitonic network: a
//   comparison network needs no scratch buffer and no stable scatter, so
//   each key needs 4 bytes of shared memory, and it is exact (equal keys
//   are equal values, every NaN one key).
// - A column of up to QS_SORT_CHUNK (8,192) keys is one block.  A longer
//   one (a year, 52,560 rows, P 65,536) is one thread-block cluster of
//   P / QS_SORT_CHUNK blocks (at most 8) on neighbouring SMs, each holding
//   8,192 keys (32 KB).  The network's stages whose partners lie 8,192 or
//   more apart compare a key with one in another block's shared memory
//   (distributed shared memory, `map_shared_rank`), between cluster
//   barriers; every other stage is local.  Of 136 stages at a year, 6
//   cross blocks.  So a machine's ten columns take 80 SMs, not 10.
// - The ranks and their interpolation are the selection's, read from the
//   sorted keys by every thread of the cluster in parallel (each rank's
//   key from the block that holds its position).  So the outputs are the
//   selection's bit for bit.
//
// The median (SimpleImputer's, one q: two ranks) of a column that one
// block sorts keeps the selection, whose four sweeps for two ranks cost
// less than a sort there (0.0184 against 0.0247 ms at 576 x 10 on an
// H100 80GB HBM3 at 700 W); past one block the sort wins (0.111 against
// 0.199 ms at a year).  The launcher picks by the number of fractions
// (QS_SELECT_MAX_Q) and the longest row list.
//
// Robust takes the same sort past one sort chunk
// (`scaler_quantiles_sort_kernel`, `cluster_sort` below): at a year its
// column's block of 256 threads ran up to 24 radix sweeps over 52,560
// shared-memory keys, 0.34 ms, about torch.nanquantile's time; the
// cluster's sort takes 0.11 ms.  The keys load through the chain prefix,
// so a MinMax step with a negative scale reverses the order before the
// sort as before the selection; one thread then reads the six ranks
// through distributed shared memory and interpolates as the selection
// does (`quantile_ranks`, `interpolate`, shared by every kernel here), so
// the outputs are the selection's bit for bit.  Up to one chunk the
// selection stays: at 512 x 576 x 10 over four row lists the sort, a
// block of 512 threads a column, took 0.82 ms against the selection's
// 0.38 (the launcher's `sort_above`, the wrapper's ROBUST_SORT_ABOVE).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "scaler_prefix.cuh"

namespace cg = cooperative_groups;

#define QS_MAX_FITS 16
#define QS_THREADS 256
#define QS_MAX_ROWS 57344
#define QS_SORT_CHUNK 8192    // keys one block of the sort holds
#define QS_SORT_THREADS 1024
#define QS_SORT_MIN 64        // the shortest sort, one warp of pairs
#define QS_SELECT_MAX_Q 1     // up to this many fractions, the selection

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/scaler_quantiles.py.
struct ScalerQuantilesArgs {
  const float* x;      // (M, N, F)
  const int* rows;     // the row lists, concatenated (null: each a range from fit_row_off)
  float* center;       // (M, G, F)
  float* scale;        // (M, G, F)
  int m;
  int n;
  int f;
  int g;
  int fit_rows[QS_MAX_FITS];
  int fit_row_off[QS_MAX_FITS];
  float q[3];          // lo / 100, 0.5, hi / 100 in f32
  int with_centering;
  int with_scaling;
  ScalerPrefix prefix;
};

__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The key of rank `k` (0-based, k < n) among `keys[0..n)`.  Every thread
// of the block calls it and gets the same key.
__device__ unsigned select_rank(const unsigned* keys, int n, int k, unsigned* hist, int* sel) {
  unsigned prefix = 0u, mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned key = keys[i];
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned c[8];
      unsigned sum = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[lane * 8 + i];
        sum += c[i];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      unsigned run = incl - sum;
      if ((unsigned)k >= run && (unsigned)k < incl) {
        for (int i = 0; i < 8; ++i) {
          if ((unsigned)k < run + c[i]) {
            sel[0] = lane * 8 + i;
            sel[1] = k - (int)run;
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    // `sel` is written again only after the next pass's two barriers, which
    // every thread reaches after reading it here
    prefix |= (unsigned)sel[0] << shift;
    mask |= 255u << shift;
    k = sel[1];
  }
  return prefix;
}

__device__ __forceinline__ float floor_eps(float v) {
  return v != v ? v : fmaxf(v, 1e-12f);
}

// The two ranks of the quantile at fraction `q` among cm1 + 1 sorted
// values and their weights, as _quantile takes them in f32.
struct QuantileRanks {
  int lo, hi;
  float lw, hw;
};

__device__ __forceinline__ QuantileRanks quantile_ranks(float q, float cm1) {
  const float pos = __fmul_rn(q, cm1);
  const float lo = floorf(pos);
  const float hi = ceilf(pos);
  QuantileRanks r;
  r.hw = __fsub_rn(pos, lo);
  r.lw = __fsub_rn(1.0f, r.hw);
  r.lo = (int)fmaxf(0.0f, fminf(lo, cm1));
  r.hi = (int)fmaxf(0.0f, fminf(hi, cm1));
  return r;
}

// The quantile from its two values: the linear interpolation as XLA:CPU
// fuses it, or nanmedian's midpoint.
__device__ __forceinline__ float interpolate(const QuantileRanks& r, float v_lo, float v_hi, bool midpoint) {
  return midpoint ? __fmul_rn(__fadd_rn(v_lo, v_hi), 0.5f) : __fmaf_rn(v_hi, r.hw, __fmul_rn(v_lo, r.lw));
}

// Robust's stats from its three quantiles (lo, 50, hi)
__device__ __forceinline__ void robust_stats(const float* qv, int with_centering, int with_scaling,
                                             float* center, float* scale) {
  *center = with_centering ? qv[1] : 0.0f;
  *scale = with_scaling ? floor_eps(__fsub_rn(qv[2], qv[0])) : 1.0f;
}

__global__ void __launch_bounds__(QS_THREADS) scaler_quantiles_kernel(const ScalerQuantilesArgs a) {
  extern __shared__ unsigned keys[];
  __shared__ unsigned hist[256];
  __shared__ int sel[2];
  __shared__ int s_count;
  const int col = blockIdx.x;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int t = threadIdx.x;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + col;
  const size_t at = ((size_t)mach * a.g + fit) * F + col;
  if (t == 0) s_count = 0;
  __syncthreads();
  int count = 0;
  for (int i = t; i < n; i += blockDim.x) {
    const float v = prefix_apply(a.prefix, at, __ldg(xm + (size_t)rows[i] * F));
    keys[i] = order_key(v);
    count += v == v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if ((t & 31) == 0) atomicAdd(&s_count, count);
  __syncthreads();
  // the counts are float32 in the reference (summed in q's dtype)
  const float cm1 = __fsub_rn((float)s_count, 1.0f);
  QuantileRanks r[3];
  int rank[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[i] = quantile_ranks(a.q[i], cm1);
    rank[2 * i] = r[i].lo;
    rank[2 * i + 1] = r[i].hi;
  }
  float value[6];
  for (int i = 0; i < 6; ++i) {
    int same = -1;
    for (int j = 0; j < i; ++j)
      if (rank[j] == rank[i]) same = j;
    value[i] = same >= 0 ? value[same] : key_value(select_rank(keys, n, rank[i], hist, sel));
  }
  if (t == 0) {
    float qv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) qv[i] = interpolate(r[i], value[2 * i], value[2 * i + 1], false);
    robust_stats(qv, a.with_centering, a.with_scaling, a.center + at, a.scale + at);
  }
}

// Mirrored field by field by `_GridArgs` in gordo_tpu_torch/kernels/scaler_quantiles.py.
struct ScalerGridArgs {
  const float* x;      // (M, N, F)
  const int* rows;     // the row lists, concatenated (null: each a range from fit_row_off)
  const float* q;      // (Q,) fractions in [0, 1], ascending
  float* out;          // (M, G, Q, F)
  int m;
  int n;
  int f;
  int g;
  int fit_rows[QS_MAX_FITS];
  int fit_row_off[QS_MAX_FITS];
  int nq;
  int midpoint;        // 1: nanmedian's (v[l] + v[h]) * 0.5; 0: linear
};

__global__ void __launch_bounds__(QS_THREADS) scaler_quantiles_grid_kernel(const ScalerGridArgs a) {
  extern __shared__ unsigned keys[];
  __shared__ unsigned hist[256];
  __shared__ int sel[2];
  __shared__ int s_count;
  const int col = blockIdx.x;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int t = threadIdx.x;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + col;
  if (t == 0) s_count = 0;
  __syncthreads();
  int count = 0;
  for (int i = t; i < n; i += blockDim.x) {
    const float v = __ldg(xm + (size_t)rows[i] * F);
    keys[i] = order_key(v);
    count += v == v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if ((t & 31) == 0) atomicAdd(&s_count, count);
  __syncthreads();
  const float cm1 = __fsub_rn((float)s_count, 1.0f);
  float* out = a.out + (((size_t)mach * a.g + fit) * a.nq) * F + col;
  int last_rank = -1;
  float last_value = 0.f;
  for (int k = 0; k < a.nq; ++k) {
    const QuantileRanks r = quantile_ranks(__ldg(a.q + k), cm1);
    float v_lo, v_hi;
    if (r.lo == last_rank) {
      v_lo = last_value;
    } else {
      v_lo = key_value(select_rank(keys, n, r.lo, hist, sel));
      last_rank = r.lo;
      last_value = v_lo;
    }
    if (r.hi == last_rank) {
      v_hi = last_value;
    } else {
      v_hi = key_value(select_rank(keys, n, r.hi, hist, sel));
      last_rank = r.hi;
      last_value = v_hi;
    }
    if (t == 0) out[(size_t)k * F] = interpolate(r, v_lo, v_hi, a.midpoint);
  }
}

__device__ __forceinline__ void compare_swap(unsigned* x, unsigned* y, bool ascending) {
  const unsigned u = *x, v = *y;
  if ((u > v) == ascending) {
    *x = v;
    *y = u;
  }
}

// The sort of one column over a cluster of C blocks, each holding `chunk`
// keys, positions rank * chunk .. of the P = C * chunk sorted: block rank
// loads the keys of rows rank * chunk .. through `value(i)` (row i of the
// row list, as the statistic takes it) and the NaN key past the list, and
// counts its non-NaN values into `s_count`; on return the cluster's keys
// are sorted and every block's count is in place.
template <typename Value>
__device__ void cluster_sort(cg::cluster_group& cluster, unsigned* keys, int chunk, int n, Value value,
                             int* s_count) {
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int base = rank * chunk;
  const int P = chunk * C;
  if (t == 0) *s_count = 0;
  __syncthreads();
  int count = 0;
  for (int i = t; i < chunk; i += nt) {
    unsigned key = 0xFFFFFFFFu;
    if (base + i < n) {
      const float v = value(base + i);
      key = order_key(v);
      count += v == v;
    }
    keys[i] = key;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if ((t & 31) == 0) atomicAdd(s_count, count);

  // the bitonic network over the cluster's P keys: pair (i, i + j), i with
  // bit j clear, ascending where bit k of i is clear
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= chunk) {
        // the partner is block rank + j / chunk: the lower block of the
        // pair compares and writes both keys
        cluster.sync();
        const int step = j / chunk;
        if ((rank & step) == 0) {
          unsigned* other = cluster.map_shared_rank(keys, rank + step);
          for (int i = t; i < chunk; i += nt) compare_swap(keys + i, other + i, ((base + i) & k) == 0);
        }
        cluster.sync();
      } else {
        __syncthreads();
        for (int e = t; e < chunk / 2; e += nt) {
          const int i = ((e & ~(j - 1)) << 1) | (e & (j - 1));
          compare_swap(keys + i, keys + i + j, ((base + i) & k) == 0);
        }
      }
    }
  }
  cluster.sync();  // every block's keys sorted and counted
}

// the cluster's non-NaN values, minus one, in f32 as the reference takes it
__device__ __forceinline__ float sorted_count_m1(cg::cluster_group& cluster, int* s_count) {
  int total = 0;
  for (int r = 0; r < (int)cluster.num_blocks(); ++r) total += *cluster.map_shared_rank(s_count, r);
  return __fsub_rn((float)total, 1.0f);
}

// the value of sorted rank `r`, from the block that holds its position
__device__ __forceinline__ float sorted_value(cg::cluster_group& cluster, unsigned* keys, int chunk, int r) {
  return key_value(*cluster.map_shared_rank(keys + r % chunk, r / chunk));
}

// The grid: one cluster of C blocks per (column, machine, fit), grid (F *
// C, M, G); every thread of the cluster reads its fractions' ranks.
__global__ void __launch_bounds__(QS_SORT_THREADS)
scaler_quantiles_grid_sort_kernel(const ScalerGridArgs a, int chunk) {
  extern __shared__ unsigned keys[];
  __shared__ int s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col = blockIdx.x / C;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + col;
  cluster_sort(cluster, keys, chunk, n, [&](int i) { return __ldg(xm + (size_t)rows[i] * F); }, &s_count);
  const float cm1 = sorted_count_m1(cluster, &s_count);
  float* out = a.out + (((size_t)mach * a.g + fit) * a.nq) * F + col;
  for (int q = (int)cluster.block_rank() * blockDim.x + threadIdx.x; q < a.nq; q += C * blockDim.x) {
    const QuantileRanks r = quantile_ranks(__ldg(a.q + q), cm1);
    out[(size_t)q * F] = interpolate(r, sorted_value(cluster, keys, chunk, r.lo),
                                     sorted_value(cluster, keys, chunk, r.hi), a.midpoint);
  }
  cluster.sync();  // no block leaves while another may read its keys
}

// Robust past the selection: the column sorted as the grid sorts it, its
// values taken through the chain prefix as they load, then its three
// quantiles' six ranks read by one thread.
__global__ void __launch_bounds__(QS_SORT_THREADS)
scaler_quantiles_sort_kernel(const ScalerQuantilesArgs a, int chunk) {
  extern __shared__ unsigned keys[];
  __shared__ int s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int col = blockIdx.x / C;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + col;
  const size_t at = ((size_t)mach * a.g + fit) * F + col;
  cluster_sort(cluster, keys, chunk, n,
               [&](int i) { return prefix_apply(a.prefix, at, __ldg(xm + (size_t)rows[i] * F)); }, &s_count);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const float cm1 = sorted_count_m1(cluster, &s_count);
    float qv[3];
    for (int i = 0; i < 3; ++i) {
      const QuantileRanks r = quantile_ranks(a.q[i], cm1);
      qv[i] = interpolate(r, sorted_value(cluster, keys, chunk, r.lo), sorted_value(cluster, keys, chunk, r.hi),
                          false);
    }
    robust_stats(qv, a.with_centering, a.with_scaling, a.center + at, a.scale + at);
  }
  cluster.sync();  // no block leaves while another may read its keys
}

extern "C" int scaler_quantiles_args_size() { return (int)sizeof(ScalerQuantilesArgs); }

extern "C" int scaler_quantiles_grid_args_size() { return (int)sizeof(ScalerGridArgs); }

extern "C" int scaler_quantiles_max_rows() { return QS_MAX_ROWS; }

extern "C" const char* scaler_quantiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The sort of `kernel`'s columns: P the longest row list rounded up to a
// power of two, in clusters of P / QS_SORT_CHUNK blocks past one chunk.
template <typename Args>
static int sort_launch(void (*kernel)(const Args, int), const Args* a, int max_rows, cudaStream_t stream) {
  int P = QS_SORT_MIN;
  while (P < max_rows) P <<= 1;
  const int chunk = P < QS_SORT_CHUNK ? P : QS_SORT_CHUNK;
  const int C = P / chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->f * C, a->m, a->g);
  cfg.blockDim = dim3(chunk / 2 < QS_SORT_THREADS ? chunk / 2 : QS_SORT_THREADS);
  cfg.dynamicSmemBytes = (size_t)chunk * sizeof(unsigned);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *a, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches on `stream` without synchronising; `max_rows` is the longest row
// list: up to `sort_above` rows the selection (its keys fill the dynamic
// shared memory), past it the sort.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue past QS_MAX_ROWS.
extern "C" int scaler_quantiles_launch(const ScalerQuantilesArgs* a, int max_rows, int sort_above, void* stream) {
  if (max_rows < 1 || max_rows > QS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (max_rows > sort_above) return sort_launch(scaler_quantiles_sort_kernel, a, max_rows, (cudaStream_t)stream);
  const size_t smem = (size_t)max_rows * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(scaler_quantiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a->f, a->m, a->g);
  scaler_quantiles_kernel<<<grid, QS_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The grid variant, as scaler_quantiles_launch: the selection for up to
// QS_SELECT_MAX_Q fractions of row lists one block sorts, else the sort.
extern "C" int scaler_quantiles_grid_launch(const ScalerGridArgs* a, int max_rows, void* stream) {
  if (max_rows < 1 || max_rows > QS_MAX_ROWS || a->nq < 1) return (int)cudaErrorInvalidValue;
  if (a->nq > QS_SELECT_MAX_Q || max_rows > QS_SORT_CHUNK)
    return sort_launch(scaler_quantiles_grid_sort_kernel, a, max_rows, (cudaStream_t)stream);
  const size_t smem = (size_t)max_rows * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(scaler_quantiles_grid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a->f, a->m, a->g);
  scaler_quantiles_grid_kernel<<<grid, QS_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
