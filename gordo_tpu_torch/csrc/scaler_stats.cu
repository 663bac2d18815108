// scaler_stats: MinMax and Standard stats of many machines over many row
// lists, each value taken through the chain's earlier steps as it loads.
//
// Replaces `MinMaxScaler.compute_stats` (gordo_tpu/ops/scalers.py:139) and
// `StandardScaler.compute_stats` (:169-177) as the XLA programs
// `fleet.exact` and `fleet.padded` run them, vmapped per machine
// (gordo_tpu/parallel/anomaly.py:196-214 `_make_scale_chain` on each
// fold's and the full series' rows, :1124 and :1327 the detector scaler on
// y).  Per machine, row list and column, over the non-NaN values v:
//
//   MinMax:    lo = nanmin(v), hi = nanmax(v)                (NaN if all NaN)
//              scale  = (b - a) / max(hi - lo, 1e-12)         (max keeps a NaN)
//              offset = a - lo * scale                         (`offset_fma`: one FMA,
//              as the fleet programs' XLA fusion computes it after any
//              step or none; else a product and a difference, as the
//              reference's eager `fit` rounds them)
//   Standard:  mean = sum(v) / count                          (jnp.nanmean)
//              std  = max(sqrt(sum((v - mean)^2) / count), 1e-12)
//              (ddof 0, two passes as jnp.nanvar; with_mean=False gives a
//              mean of 0 and with_std=False a std of 1, the std still
//              taken around the true mean; both sums in XLA:CPU's order,
//              `scaler_standard_kernel` below)
//   Mean:      mean = sum(x) * (1 / N)                        (jnp.mean: PCA.fit's
//              mean, gordo_tpu/ops/scalers.py:331; a NaN gives a NaN mean)
//   NaN-mean:  mean = sum(v) / count                          (jnp.nanmean:
//              SimpleImputer(strategy="mean")'s fill, :291)
//              (both write the mean to out0 and the values summed to out1;
//              `scaler_mean_kernel` below)
//
// The chain prefix: step i of a pipeline's scaler chain takes its stats on
// step i-1's output (`_make_scale_chain`).  The kernel takes up to
// SS_MAX_PREFIX earlier steps' maps per fit and applies them to each value
// as it loads it, so the transformed rows are never written: a MinMax step
// as `x * a + b`, one FMA as XLA fuses it, a Standard or Robust step as
// `(x - a) / b`, each rounded (scaler_prefix.cuh).  A NaN (pad-up
// padding) stays NaN through the prefix and falls out of the stats.
//
// Bound: one pass (MinMax) or two (Standard) over the rows, a few flops
// per element: bound by device memory (each input row read once per row
// list).
//
// Design (MinMax): one block per (row list, machine), one instantiation
// with and one without a prefix (the MinMax of a chain's first step runs
// the loop it ran before chains).  The block's threads split into one
// group per column; each thread strides over the rows of its column, the
// groups' partials meet in shared memory, and one thread per column
// finishes the column.  NaN follows the JAX package: CUDA's
// fminf/fmaxf would skip NaN rows too, but an all-NaN column must come
// out NaN, and max(NaN, 1e-12) must stay NaN, which fmaxf would not do.

#include <cuda_runtime.h>
#include <math.h>

#include "scaler_prefix.cuh"
#include "xla_order.cuh"

#define SS_MAX_FITS 16
#define SS_THREADS 256
#define SS_MINMAX 0
#define SS_STANDARD 1
#define SS_MEAN 2
#define SS_NANMEAN 3
// the means' window sums in shared memory: 200 KiB, 1,588,736 rows a row
// list (scaler_stats_mean_max_rows)
#define SS_MEAN_SMEM (200 * 1024)

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/scaler_stats.py.
struct ScalerStatsArgs {
  const float* x;      // (M, N, F)
  const int* rows;     // the row lists, concatenated (null: each a range from fit_row_off)
  float* out0;         // (M, G, F): MinMax scale, Standard mean
  float* out1;         // (M, G, F): MinMax offset, Standard std
  int m;
  int n;
  int f;
  int g;
  int fit_rows[SS_MAX_FITS];
  int fit_row_off[SS_MAX_FITS];
  int stat;            // SS_MINMAX, SS_STANDARD, SS_MEAN or SS_NANMEAN
  float range_lo;      // MinMax: feature_range a
  float range_span;    // MinMax: b - a
  int offset_fma;      // MinMax: the offset a - lo * scale as one FMA (the fleet programs')
  int with_mean;       // Standard
  int with_std;        // Standard
  ScalerPrefix prefix;
  float* part2;        // past one block: the level-2 window sums (scratch)
  int* ints;           // past one block: counts and tickets, zero between launches
};

__device__ __forceinline__ float floor_eps(float v) {
  return v != v ? v : fmaxf(v, 1e-12f);
}

// a value of the column through the prefix, when the instantiation has one
template <bool PREFIX>
__device__ __forceinline__ float load_value(const ScalerStatsArgs& a, const float* p, size_t at) {
  const float v = __ldg(p);
  return PREFIX ? prefix_apply(a.prefix, at, v) : v;
}

template <bool PREFIX>
__global__ void __launch_bounds__(SS_THREADS) scaler_minmax_kernel(const ScalerStatsArgs a) {
  __shared__ float s_a[SS_THREADS];
  __shared__ float s_b[SS_THREADS];
  __shared__ int s_any[SS_THREADS];
  const int fit = blockIdx.x;
  const int mach = blockIdx.y;
  const int t = threadIdx.x;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F;
  const size_t stat_row = ((size_t)mach * a.g + fit) * F;
  // `per` threads per column, `cols` columns per pass
  const int per = F < SS_THREADS ? SS_THREADS / F : 1;
  const int cols = SS_THREADS / per;
  const int c = t / per;
  const int sub = t - c * per;
  for (int j0 = 0; j0 < F; j0 += cols) {
    const int j = j0 + c;
    const bool mine = c < cols && j < F;
    float pa = INFINITY, pb = -INFINITY;
    int any = 0;
    if (mine) {
      for (int r = sub; r < n; r += per) {
        const float v = load_value<PREFIX>(a, xm + (size_t)rows[r] * F + j, stat_row + j);
        if (v == v) {
          pa = fminf(pa, v);
          pb = fmaxf(pb, v);
          any = 1;
        }
      }
    }
    s_a[t] = pa;
    s_b[t] = pb;
    s_any[t] = any;
    __syncthreads();
    if (mine && sub == 0) {
      for (int k = 1; k < per; ++k) {
        pa = fminf(pa, s_a[t + k]);
        pb = fmaxf(pb, s_b[t + k]);
        any |= s_any[t + k];
      }
      if (!any) pa = pb = NAN;
      const float sc = __fdiv_rn(a.range_span, floor_eps(__fsub_rn(pb, pa)));
      a.out0[stat_row + j] = sc;
      a.out1[stat_row + j] = a.offset_fma ? fmaf(-pa, sc, a.range_lo)
                                          : __fsub_rn(a.range_lo, __fmul_rn(pa, sc));
    }
    __syncthreads();
  }
}

// The means (SS_MEAN, SS_NANMEAN) and the Standard statistic's two sums
// run in XLA:CPU's window order (xla_order.cuh), so that a mean is the JAX
// package's bit for bit; XLA multiplies jnp.mean's sum by 1 / N.  A
// NaN-mean adds 0 for a NaN (jnp.nansum) and divides by the count.
//
// Design, a row list that one block covers (up to SS_THREADS windows of
// its longest row list: a fold of 576 rows, 8,192 rows at most): one block
// per (column group, machine, row list).  A group holds as many of the F
// columns as give each thread about one window (the launcher's choice,
// within shared memory: a fold of 576 rows has 18 windows a column, so 10
// tags are one group).  Each thread sums whole windows in order, the
// window sums go to shared memory, level after level, and one thread a
// column adds the last XO_WINDOW or fewer in order.
//
// Past one block (a year, 52,560 rows: 1,643 windows a column), a block
// per column left ten blocks of 132 SMs busy, each thread summing six
// windows of strided single-column loads: 0.16 ms at a year, four times
// torch.mean.  A cluster of 8 blocks per column group, each block its
// range of level-2 windows in turn, came to 0.12 ms (the mean) and 0.21
// ms (the Standard statistic): eight SMs a row list, each waiting on its
// tiles' loads one after another.  So past one block each level-2 window
// (1,024 rows) is a block of its own, `scaler_window_tile_kernel` below:
// the same windows, the same order, fifty-two blocks at a year.

// The block's column group: `nc` columns from `col0`, the group size
// ceil(F / groups) as the launcher chose the groups.
struct ColumnGroup {
  int col0;
  int nc;
};

__device__ __forceinline__ ColumnGroup column_group(int F) {
  const int size = (F + gridDim.x - 1) / gridDim.x;
  const int col0 = blockIdx.x * size;
  return {col0, min(size, F - col0)};
}

__global__ void __launch_bounds__(SS_THREADS) scaler_mean_kernel(const ScalerStatsArgs a) {
  extern __shared__ float part[];
  __shared__ float s_sum[SS_THREADS];
  __shared__ int s_count[SS_THREADS];
  const ColumnGroup g = column_group(a.f);
  if (g.nc <= 0) return;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + g.col0;
  const size_t at = ((size_t)mach * a.g + fit) * F + g.col0;
  auto value = [&](int c, int i) { return __ldg(xm + (size_t)rows[i] * F + c); };
  const bool skip_nan = a.stat == SS_NANMEAN;
  if (skip_nan) {
    for (int c = threadIdx.x; c < g.nc; c += blockDim.x) s_count[c] = 0;
    __syncthreads();
    xla_order_sums<true>(g.nc, n, value, part, s_sum, s_count);
  } else {
    xla_order_sums<false>(g.nc, n, value, part, s_sum, s_count);
  }
  for (int c = threadIdx.x; c < g.nc; c += blockDim.x) {
    const float cnt = skip_nan ? (float)s_count[c] : (float)n;
    a.out0[at + c] = skip_nan ? __fdiv_rn(s_sum[c], cnt) : __fmul_rn(s_sum[c], __fdiv_rn(1.0f, cnt));
    a.out1[at + c] = cnt;
  }
}

// The Standard statistic, jnp.nanmean and jnp.nanstd as XLA:CPU sums
// them, the values taken through the prefix as they load (once a pass),
// NaN adding 0.  On a column whose level is large against its spread (a
// pressure of 100 +- 1) another order moves the mean by a few ulps of the
// level, which the scaled column carries as an error of the same size
// against its spread.
template <bool PREFIX>
__global__ void __launch_bounds__(SS_THREADS) scaler_standard_kernel(const ScalerStatsArgs a) {
  extern __shared__ float part[];
  __shared__ float s_mean[SS_THREADS];
  __shared__ float s_ss[SS_THREADS];
  __shared__ int s_count[SS_THREADS];
  const ColumnGroup g = column_group(a.f);
  if (g.nc <= 0) return;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + g.col0;
  const size_t at = ((size_t)mach * a.g + fit) * F + g.col0;
  auto value = [&](int c, int i) { return load_value<PREFIX>(a, xm + (size_t)rows[i] * F + c, at + c); };
  for (int c = threadIdx.x; c < g.nc; c += blockDim.x) s_count[c] = 0;
  __syncthreads();
  xla_order_sums<true>(g.nc, n, value, part, s_mean, s_count);
  // 0 / 0 is NaN for an all-NaN column, as jnp.nanmean gives
  for (int c = threadIdx.x; c < g.nc; c += blockDim.x) s_mean[c] = __fdiv_rn(s_mean[c], (float)s_count[c]);
  __syncthreads();
  xla_order_sums<false>(g.nc, n, [&](int c, int i) {
    const float v = value(c, i);
    const float d = __fsub_rn(v, s_mean[c]);
    return v == v ? __fmul_rn(d, d) : 0.f;
  }, part, s_ss, s_count);
  for (int c = threadIdx.x; c < g.nc; c += blockDim.x) {
    // jnp.nanvar: NaN where no value counts
    const float var = s_count[c] > 0 ? __fdiv_rn(s_ss[c], (float)s_count[c]) : NAN;
    a.out0[at + c] = a.with_mean ? s_mean[c] : 0.f;
    a.out1[at + c] = a.with_std ? floor_eps(__fsqrt_rn(var)) : 1.f;
  }
}

#define SS_TILE_ROWS (XO_WINDOW * XO_WINDOW)  // the rows of one level-2 window
#define SS_TILE_COLS 16                      // columns a tile at most

// A row list's windows: `level1` windows of XO_WINDOW values, the first
// `lo1` values before row 0 (padding), and `level2` windows of level-1
// sums, the first `lo2` before window 0; a list of XO_WINDOW or fewer
// level-1 windows has one level-2 window, summed in order, as XLA sums
// XO_WINDOW or fewer values.
struct Windows {
  int level1, lo1, level2, lo2;
};

__host__ __device__ __forceinline__ Windows windows_of(int n) {
  Windows w;
  w.level1 = xo_windows(n);
  w.lo1 = (w.level1 * XO_WINDOW - n) / 2;
  w.level2 = w.level1 > XO_WINDOW ? xo_windows(w.level1) : 1;
  w.lo2 = w.level1 > XO_WINDOW ? (w.level2 * XO_WINDOW - w.level1) / 2 : 0;
  return w;
}

// the tile kernel's shared memory, floats, for `size` columns and row
// lists of up to `l2max` level-2 windows: the tile, and for the block that
// finishes, the level-2 sums and the levels above
__host__ __device__ __forceinline__ int tile_smem_floats(int size, int l2max) {
  return SS_TILE_ROWS * size + XO_WINDOW + size * l2max + xo_part_floats(size, 1, l2max) + size;
}

// The means and the Standard statistic of row lists past one block, in
// XLA's window order, one block per (level-2 window, column group,
// machine, row list): grid (level2 * groups, M, G), 32 threads a column of
// the group.  The block loads its window's 1,024 rows of the group's
// columns into shared memory, a coalesced tile (consecutive threads on
// consecutive values of a row, a row after another; one float of padding
// every 32 rows, so that the warp reading a column reads 32 banks); warp c
// then sums column c, lane l the level-1 window l in order, and the lanes'
// sums in lane order are the level-2 window's sum, which goes to the
// scratch `part2`.  The last block of a (column group, machine, row list)
// to finish (a __threadfence, then an atomic ticket) reads every level-2
// sum and finishes the levels above (xla_order_sums), then sets its
// ticket and counts back to 0, so that the scratch is zero for the next
// launch.  The Standard statistic takes two launches: the first writes
// the mean to out0 (the count stays in the scratch), the second sums the
// squared deviations from it.  A padding value is 0 for the mean (jnp.mean
// sums it as x + 0) and NaN where NaN adds 0 and is not counted (the
// NaN-mean, the Standard statistic), so that each window is the
// single-block kernels' window bit for bit.
template <int STAT, bool PREFIX, bool SECOND>
__global__ void __launch_bounds__(SS_TILE_COLS * 32)
scaler_window_tile_kernel(const ScalerStatsArgs a, int size, int l2max) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int F = a.f;
  const int groups = (F + size - 1) / size;
  const int group = blockIdx.x % groups;
  const int j = blockIdx.x / groups;  // the level-2 window
  const int col0 = group * size;
  const int nc = min(size, F - col0);
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int n = a.fit_rows[fit];
  const Windows w = windows_of(n);
  if (j >= w.level2) return;
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F + col0;
  const size_t slot = (size_t)mach * a.g + fit;
  const size_t at = slot * F + col0;
  float* sums = a.part2 + at * l2max;  // column c's level-2 sums at c * l2max
  int* counts = a.ints + at;           // the column's non-NaN values
  int* ticket = a.ints + (size_t)a.m * a.g * F + slot * groups + group;

  float* tile = smem;                                  // SS_TILE_ROWS rows, row stride `size`
  float* top = tile + SS_TILE_ROWS * size + XO_WINDOW; // the level-2 sums, size x l2max
  float* part = top + size * l2max;                    // the levels above
  float* res = part + xo_part_floats(size, 1, l2max);  // each column's sum
  const int t = threadIdx.x;
  const int c = t >> 5;  // warp c sums column c
  const int lane = t & 31;

  const int p0 = (j * XO_WINDOW - w.lo2) * XO_WINDOW - w.lo1;  // the tile's first row
  const float pad = STAT == SS_MEAN ? 0.f : NAN;
#pragma unroll 32
  for (int e = t; e < SS_TILE_ROWS * nc; e += blockDim.x) {
    const int r = e / nc;
    const int cc = e - r * nc;
    const int p = p0 + r;
    float v = pad;
    if (p >= 0 && p < n) v = load_value<PREFIX>(a, xm + (size_t)rows[p] * F + cc, at + cc);
    tile[r * size + (r >> 5) + cc] = v;
  }
  __syncthreads();
  if (c < nc) {
    const float m = SECOND ? __ldcg(a.out0 + at + c) : 0.f;  // the first launch's mean
    const float* col = tile + lane * XO_WINDOW * size + lane + c;
    float s = 0.f;
    int count = 0;
#pragma unroll 8
    for (int i = 0; i < XO_WINDOW; ++i) {
      float v = col[i * size];
      if (SECOND) {
        const float d = __fsub_rn(v, m);
        v = v == v ? __fmul_rn(d, d) : 0.f;
      } else if (STAT != SS_MEAN) {
        count += v == v;
        v = v == v ? v : 0.f;
      }
      s = __fadd_rn(s, v);
    }
    float s2 = 0.f;
    for (int l = 0; l < XO_WINDOW; ++l) s2 = __fadd_rn(s2, __shfl_sync(0xffffffffu, s, l));
    if (!SECOND && STAT != SS_MEAN) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
    }
    if (lane == 0) {
      sums[c * l2max + j] = s2;
      if (!SECOND && STAT != SS_MEAN) atomicAdd(counts + c, count);
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ticket, 1) == w.level2 - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: every level-2 sum of the group's columns in order, and
  // the levels above (read from L2, past this SM's L1)
  for (int i = t; i < nc * w.level2; i += blockDim.x) {
    const int cc = i / w.level2;
    const int jj = i - cc * w.level2;
    top[cc * l2max + jj] = __ldcg(sums + cc * l2max + jj);
  }
  __syncthreads();
  xla_order_sums<false>(nc, w.level2, [&](int cc, int i) { return top[cc * l2max + i]; }, part, res, nullptr);
  for (int cc = t; cc < nc; cc += blockDim.x) {
    const int cnt = STAT == SS_MEAN ? n : __ldcg(counts + cc);
    if (STAT == SS_STANDARD && !SECOND) {
      // 0 / 0 is NaN for an all-NaN column, as jnp.nanmean gives
      a.out0[at + cc] = __fdiv_rn(res[cc], (float)cnt);
      continue;
    }
    if (STAT == SS_STANDARD) {
      // jnp.nanvar: NaN where no value counts
      const float var = cnt > 0 ? __fdiv_rn(res[cc], (float)cnt) : NAN;
      const float mean = __ldcg(a.out0 + at + cc);
      a.out0[at + cc] = a.with_mean ? mean : 0.f;
      a.out1[at + cc] = a.with_std ? floor_eps(__fsqrt_rn(var)) : 1.f;
    } else {
      const float cnt_f = (float)cnt;
      a.out0[at + cc] = STAT == SS_NANMEAN ? __fdiv_rn(res[cc], cnt_f) : __fmul_rn(res[cc], __fdiv_rn(1.0f, cnt_f));
      a.out1[at + cc] = cnt_f;
    }
    counts[cc] = 0;
  }
  if (t == 0) *ticket = 0;
}

// The tile kernel for the longest row list `longest`: groups of `size`
// columns within SS_MEAN_SMEM, one launch (two for the Standard
// statistic).  `part2` holds M * G * F level-2 windows of the longest row
// list, `ints` M * G * 2F zeros.
template <int STAT, bool PREFIX>
static int tile_launches(const ScalerStatsArgs* a, int longest, cudaStream_t stream) {
  const int l2max = windows_of(longest).level2;
  int size = a->f < SS_TILE_COLS ? a->f : SS_TILE_COLS;
  while (size > 1 && (size_t)tile_smem_floats(size, l2max) * sizeof(float) > SS_MEAN_SMEM) --size;
  const int groups = (a->f + size - 1) / size;
  size = (a->f + groups - 1) / groups;
  const size_t smem = (size_t)tile_smem_floats(size, l2max) * sizeof(float);
  if (smem > SS_MEAN_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(groups * l2max, a->m, a->g);
  void (*first)(const ScalerStatsArgs, int, int) = scaler_window_tile_kernel<STAT, PREFIX, false>;
  cudaError_t err = cudaFuncSetAttribute(first, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  first<<<grid, 32 * size, smem, stream>>>(*a, size, l2max);
  if (STAT == SS_STANDARD) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    void (*second)(const ScalerStatsArgs, int, int) = scaler_window_tile_kernel<STAT, PREFIX, true>;
    err = cudaFuncSetAttribute(second, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    second<<<grid, 32 * size, smem, stream>>>(*a, size, l2max);
  }
  return (int)cudaGetLastError();
}

extern "C" int scaler_stats_args_size() { return (int)sizeof(ScalerStatsArgs); }

// The longest row list whose two levels of window sums, ceil(n / 32) and
// ceil(ceil(n / 32) / 32) floats, fit SS_MEAN_SMEM.
extern "C" int scaler_stats_mean_max_rows() {
  const int floats = SS_MEAN_SMEM / (int)sizeof(float);
  int level1 = floats;
  while (level1 + xo_windows(level1) > floats) --level1;
  return level1 * XO_WINDOW;
}

extern "C" const char* scaler_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int scaler_stats_launch(const ScalerStatsArgs* a, void* stream) {
  dim3 grid(a->g, a->m);
  cudaStream_t s = (cudaStream_t)stream;
  const bool prefix = a->prefix.n > 0;
  if (a->stat == SS_MINMAX && !prefix)
    scaler_minmax_kernel<false><<<grid, SS_THREADS, 0, s>>>(*a);
  else if (a->stat == SS_MINMAX)
    scaler_minmax_kernel<true><<<grid, SS_THREADS, 0, s>>>(*a);
  else if (prefix && (a->stat == SS_MEAN || a->stat == SS_NANMEAN))
    return (int)cudaErrorInvalidValue;
  else {
    // the window-ordered sums: past one block's threads a window each, a
    // block per (level-2 window, column group, machine, row list); else
    // one block per (column group, machine, row list), a group as many
    // columns as give each thread about one window of its longest row
    // list and fit the window sums in shared memory
    int longest = 0;
    for (int i = 0; i < a->g; ++i) longest = a->fit_rows[i] > longest ? a->fit_rows[i] : longest;
    const int level1 = xo_windows(longest);
    if (level1 > SS_THREADS) {
      if (a->stat == SS_MEAN) return tile_launches<SS_MEAN, false>(a, longest, s);
      if (a->stat == SS_NANMEAN) return tile_launches<SS_NANMEAN, false>(a, longest, s);
      if (prefix) return tile_launches<SS_STANDARD, true>(a, longest, s);
      return tile_launches<SS_STANDARD, false>(a, longest, s);
    }
    const size_t column_smem = (size_t)xo_part_floats(1, 1, longest) * sizeof(float);
    int nc = SS_THREADS / level1 > 1 ? SS_THREADS / level1 : 1;
    nc = nc < a->f ? nc : a->f;
    nc = (size_t)nc * column_smem <= SS_MEAN_SMEM ? nc : (int)(SS_MEAN_SMEM / column_smem);
    const int groups = (a->f + nc - 1) / nc;
    nc = (a->f + groups - 1) / groups;  // the size column_group() derives
    const size_t smem = (size_t)nc * column_smem;
    void (*kernel)(const ScalerStatsArgs) = scaler_mean_kernel;
    if (a->stat == SS_STANDARD && prefix) kernel = scaler_standard_kernel<true>;
    if (a->stat == SS_STANDARD && !prefix) kernel = scaler_standard_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // a thread a window of the group, at least a warp
    const int tasks = nc * level1;
    const int threads = tasks < SS_THREADS ? (tasks + 31) / 32 * 32 : SS_THREADS;
    kernel<<<dim3(groups, a->m, a->g), threads, smem, s>>>(*a);
  }
  return (int)cudaGetLastError();
}
