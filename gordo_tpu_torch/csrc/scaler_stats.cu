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
// Design (MinMax): min and max do not depend on order, so any tree gives
// the same bits.  Three paths, chosen on the host (`launch_plan` in
// gordo_tpu_torch/kernels/scaler_stats.py, which fills the `mm_*` fields):
//   nested: every row list a range from the same row and no prefix (the
//     build's pipeline and detector calls, TimeSeriesSplit's folds and the
//     whole series): a block per machine reads the longest range once, in
//     segments between the lists' ends, and each list's stats combine the
//     segments up to its end, in list order;
//   list: with a prefix (each fit's maps differ) or index lists, a block
//     per (row list, machine);
//   split: past ONE_BLOCK_ROWS rows, a block per (chunk of `mm_chunk_rows`
//     positions, machine, row list); the blocks' partials meet in a
//     scratch by integer atomics and the last block of a (machine, list)
//     (an atomic ticket) finishes it and leaves the scratch zero.
// Loads are coalesced: `mm_vec` 4 (a range whose rows start 16-byte
// aligned, fo <= 256) reads float4s, consecutive threads on consecutive
// values, a thread's stride a multiple of fo so that its four values keep
// their columns (blocks of 128 threads on the nested and list paths, 256
// on the split path: the faster on an H100, PERF.md); `mm_vec` 1 reads a
// row's columns on consecutive threads (columns in groups of `mm_cw`,
// blocks of 256).  A prefix's stats are loaded once a thread (its columns
// are fixed).  A thread keeps a min and a max a column it reads
// (fminf/fmaxf skip NaN); lanes of a warp that share a column (a period of
// `mm_period` lanes, at most 16) combine by shuffles, and one lane a
// column adds its pair to the block's by shared-memory atomics on
// order-preserving keys.  NaN follows the JAX package: an
// all-NaN column comes out NaN, and max(NaN, 1e-12) stays NaN, which
// fmaxf would not keep.

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
  int* ints;           // past one block: counts, keys and tickets, zero between launches
  // MinMax: the plan's path and layout (kernels/scaler_stats.py::launch_plan)
  int mm_path;         // MM_NESTED, MM_LIST or MM_SPLIT
  int mm_vec;          // 4: float4 loads along a range; 1: a row's columns on consecutive threads
  int mm_active;       // threads that load
  int mm_cw;           // columns a group (mm_vec 4: every column)
  int mm_period;       // lanes after which a warp's columns repeat
  int mm_nseg;         // nested: segments
  int mm_chunk_rows;   // split: positions a block
  int mm_threads;      // a block's threads
  int mm_seg_end[SS_MAX_FITS];   // nested: each segment's end position, ascending
  int mm_list_seg[SS_MAX_FITS];  // nested: each row list's last segment
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

#define MM_NESTED 0
#define MM_LIST 1
#define MM_SPLIT 2
#define MM_THREADS 256  // a MinMax block at most (the plan's `mm_threads`)
#define MM_FULL 0xffffffffu

// an order-preserving key of a float that is not NaN: a larger value has
// a larger key, and 0 is below every key (the neutral of a max); a min is
// kept as the max of ~key (0 again its neutral)
__device__ __forceinline__ unsigned mm_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float mm_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// scale and offset from the keys of a column's max and ~min (0: no value,
// so NaN, as the JAX package's nanmin of an all-NaN column)
__device__ __forceinline__ void mm_write(const ScalerStatsArgs& a, size_t at, unsigned hk, unsigned nk) {
  float lo = NAN, hi = NAN;
  if (hk) {
    hi = mm_value(hk);
    lo = mm_value(~nk);
  }
  const float sc = __fdiv_rn(a.range_span, floor_eps(__fsub_rn(hi, lo)));
  a.out0[at] = sc;
  a.out1[at] = a.offset_fma ? fmaf(-lo, sc, a.range_lo) : __fsub_rn(a.range_lo, __fmul_rn(lo, sc));
}

// thread t's column of its value v (mm_vec 4: of its float4; else its
// column within the group)
template <int V>
__device__ __forceinline__ int mm_column(const ScalerStatsArgs& a, int t, int v) {
  return V == 4 ? (4 * t + v) % a.f : t % a.mm_cw;
}

// a thread's columns' prefix stats, loaded once (its columns are fixed):
// step i's a and b of the column of value v
template <int V>
struct MinMaxPrefix {
  float a[V][SP_MAX_PREFIX], b[V][SP_MAX_PREFIX];
};

template <int V, bool PREFIX>
__device__ __forceinline__ void mm_prefix_load(const ScalerStatsArgs& a, size_t at, const int (&col)[V],
                                               MinMaxPrefix<V>& p) {
  if (!PREFIX) return;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int i = 0; i < SP_MAX_PREFIX; ++i)
      if (i < a.prefix.n) {
        p.a[v][i] = ld(static_cast<const float*>(a.prefix.a[i]) + at + col[v]);
        p.b[v][i] = ld(static_cast<const float*>(a.prefix.b[i]) + at + col[v]);
      }
}

// value v of a thread through the prefix (prefix_apply's steps and
// roundings, the stats from registers), then into its min and max
template <int V, bool PREFIX>
__device__ __forceinline__ void mm_take(const ScalerStatsArgs& a, const MinMaxPrefix<V>& p, int v, float x,
                                        float (&lo)[V], float (&hi)[V]) {
  if (PREFIX) {
#pragma unroll
    for (int i = 0; i < SP_MAX_PREFIX; ++i)
      if (i < a.prefix.n) x = step_apply(a.prefix.form[i], x, p.a[v][i], p.b[v][i]);
  }
  lo[v] = fminf(lo[v], x);
  hi[v] = fmaxf(hi[v], x);
}

// a float4 of a range from `base`, values at or past `end` NaN (skipped)
__device__ __forceinline__ float4 mm_load4(const float* base, int e, int end) {
  if (e + 4 <= end) return __ldg(reinterpret_cast<const float4*>(base + e));
  float x[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) x[v] = e + v < end ? __ldg(base + e + v) : NAN;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// the min (lo) and max (hi) of this thread's values of positions [p0, p1)
// of a row list: V 4, a range from row `start` (float4s at 4t + k * 4 *
// mm_active of the range's values); V 1, rows[i] at column col0 + t % cw
template <int V, bool PREFIX>
__device__ __forceinline__ void mm_scan(const ScalerStatsArgs& a, const float* xm, RowList rows, int start,
                                        int p0, int p1, int col0, size_t at, float (&lo)[V], float (&hi)[V]) {
  const int t = threadIdx.x;
  const int F = a.f;
  if (t >= a.mm_active) return;
  int col[V];
#pragma unroll
  for (int v = 0; v < V; ++v) col[v] = V == 4 ? mm_column<V>(a, t, v) : col0 + t % a.mm_cw;
  if (V == 1 && col[0] >= F) return;
  MinMaxPrefix<V> p;
  mm_prefix_load<V, PREFIX>(a, at, col, p);
  if (V == 4) {
    const float* base = xm + (size_t)start * F;
    const int e1 = p1 * F;
#pragma unroll 4
    for (int e = p0 * F + 4 * t; e < e1; e += 4 * a.mm_active) {
      const float4 q = mm_load4(base, e, e1);
      mm_take<V, PREFIX>(a, p, 0, q.x, lo, hi);
      mm_take<V, PREFIX>(a, p, 1 % V, q.y, lo, hi);
      mm_take<V, PREFIX>(a, p, 2 % V, q.z, lo, hi);
      mm_take<V, PREFIX>(a, p, 3 % V, q.w, lo, hi);
    }
  } else {
    const int step = a.mm_active / a.mm_cw;
#pragma unroll 4
    for (int i = p0 + t / a.mm_cw; i < p1; i += step)
      mm_take<V, PREFIX>(a, p, 0, __ldg(xm + (size_t)rows[i] * F + col[0]), lo, hi);
  }
}

// the block's pairs: a warp's lanes that share a column combine by
// shuffles (a period of mm_period lanes, when it is at most 16), then one
// lane a column (every lane past that) adds its pair to the group's keys
// (`keys` the max keys, `keys + cw` the ~min keys, by column within the
// group); every thread of the block calls it
template <int V>
__device__ __forceinline__ void mm_reduce(const ScalerStatsArgs& a, float (&lo)[V], float (&hi)[V], unsigned* keys) {
  const int period = a.mm_period;
  const int lane = threadIdx.x & 31;
  if (period <= 16) {
    for (int d = period; d < 32; d <<= 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        lo[v] = fminf(lo[v], __shfl_down_sync(MM_FULL, lo[v], d));
        hi[v] = fmaxf(hi[v], __shfl_down_sync(MM_FULL, hi[v], d));
      }
    }
    if (lane >= period) return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (lo[v] <= hi[v]) {  // else no value was read (a thread's start values, or NaN alone)
      const int c = mm_column<V>(a, threadIdx.x, v);
      atomicMax(keys + c, mm_key(hi[v]));
      atomicMax(keys + a.mm_cw + c, ~mm_key(lo[v]));
    }
  }
}

template <int V, bool PREFIX, int PATH>
__global__ void __launch_bounds__(MM_THREADS) scaler_minmax_kernel(const __grid_constant__ ScalerStatsArgs a) {
  extern __shared__ unsigned mm_keys[];  // a segment's max keys, then its ~min keys, by column of the group
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int F = a.f;
  const int fit = PATH == MM_NESTED ? 0 : PATH == MM_LIST ? blockIdx.x : blockIdx.z;
  const int mach = PATH == MM_NESTED ? blockIdx.x : blockIdx.y;
  int p0 = 0, p1 = a.fit_rows[fit];
  if (PATH == MM_SPLIT) {
    p0 = blockIdx.x * a.mm_chunk_rows;
    if (p0 >= p1) return;  // this row list has fewer chunks
    p1 = min(p1, p0 + a.mm_chunk_rows);
  }
  const RowList rows = row_list(a.rows, a.fit_row_off[fit]);
  const float* xm = a.x + (size_t)mach * a.n * F;
  const size_t at = ((size_t)mach * a.g + fit) * F;
  const int nseg = PATH == MM_NESTED ? a.mm_nseg : 1;
  const int cw = a.mm_cw;
  for (int col0 = 0; col0 < F; col0 += cw) {
    for (int i = t; i < 2 * nseg * cw; i += blockDim.x) mm_keys[i] = 0u;
    __syncthreads();
    for (int k = 0; k < nseg; ++k) {
      float lo[V], hi[V];
#pragma unroll
      for (int v = 0; v < V; ++v) lo[v] = INFINITY, hi[v] = -INFINITY;
      const int q0 = PATH == MM_NESTED ? (k ? a.mm_seg_end[k - 1] : 0) : p0;
      const int q1 = PATH == MM_NESTED ? a.mm_seg_end[k] : p1;
      mm_scan<V, PREFIX>(a, xm, rows, rows.start, q0, q1, col0, at, lo, hi);
      mm_reduce<V>(a, lo, hi, mm_keys + 2 * k * cw);
    }
    __syncthreads();
    const int nc = min(cw, F - col0);
    for (int c = t; c < nc; c += blockDim.x) {
      if (PATH == MM_NESTED) {
        // each row list's segments in list order: its stats those of
        // every segment up to its end
        for (int g = 0; g < a.g; ++g) {
          unsigned hk = 0u, nk = 0u;
          for (int k = 0; k <= a.mm_list_seg[g]; ++k) {
            hk = max(hk, mm_keys[2 * k * cw + c]);
            nk = max(nk, mm_keys[(2 * k + 1) * cw + c]);
          }
          mm_write(a, ((size_t)mach * a.g + g) * F + col0 + c, hk, nk);
        }
      } else if (PATH == MM_LIST) {
        mm_write(a, at + col0 + c, mm_keys[c], mm_keys[cw + c]);
      } else if (mm_keys[c]) {
        unsigned* keys = reinterpret_cast<unsigned*>(a.ints) + 2 * (at + col0 + c);
        atomicMax(keys, mm_keys[c]);
        atomicMax(keys + 1, mm_keys[cw + c]);
      }
    }
    __syncthreads();
  }
  if (PATH != MM_SPLIT) return;
  // the last chunk of this (machine, row list) to finish writes its stats
  // and leaves its keys and ticket zero
  __threadfence();
  __syncthreads();
  int* ticket = a.ints + 2 * (size_t)a.m * a.g * F + (size_t)mach * a.g + fit;
  const int chunks = (a.fit_rows[fit] + a.mm_chunk_rows - 1) / a.mm_chunk_rows;
  if (t == 0) s_last = atomicAdd(ticket, 1) == chunks - 1;
  __syncthreads();
  if (!s_last) return;
  for (int c = t; c < F; c += blockDim.x) {
    unsigned* keys = reinterpret_cast<unsigned*>(a.ints) + 2 * (at + c);
    const unsigned hk = atomicExch(keys, 0u);
    const unsigned nk = atomicExch(keys + 1, 0u);
    mm_write(a, at + c, hk, nk);
  }
  if (t == 0) *ticket = 0;
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

// MinMax by the plan's path: grid (machines) nested, (row lists,
// machines) list, (chunks, machines, row lists) split; 2 keys a column of
// a group and segment in shared memory
template <int V, bool PREFIX, int PATH>
static int minmax_path(const ScalerStatsArgs* a, dim3 grid, cudaStream_t s) {
  const size_t smem = (size_t)2 * (PATH == MM_NESTED ? a->mm_nseg : 1) * a->mm_cw * sizeof(unsigned);
  scaler_minmax_kernel<V, PREFIX, PATH><<<grid, a->mm_threads, smem, s>>>(*a);
  return (int)cudaGetLastError();
}

template <int V>
static int minmax_vec(const ScalerStatsArgs* a, cudaStream_t s) {
  const bool prefix = a->prefix.n > 0;
  if (a->mm_path == MM_NESTED) {
    if (prefix) return (int)cudaErrorInvalidValue;
    return minmax_path<V, false, MM_NESTED>(a, dim3(a->m), s);
  }
  if (a->mm_path == MM_LIST) {
    const dim3 grid(a->g, a->m);
    return prefix ? minmax_path<V, true, MM_LIST>(a, grid, s) : minmax_path<V, false, MM_LIST>(a, grid, s);
  }
  int longest = 0;
  for (int i = 0; i < a->g; ++i) longest = a->fit_rows[i] > longest ? a->fit_rows[i] : longest;
  const dim3 grid((longest + a->mm_chunk_rows - 1) / a->mm_chunk_rows, a->m, a->g);
  return prefix ? minmax_path<V, true, MM_SPLIT>(a, grid, s) : minmax_path<V, false, MM_SPLIT>(a, grid, s);
}

static int minmax_launch(const ScalerStatsArgs* a, cudaStream_t s) {
  if (a->mm_cw < 1 || (a->mm_vec == 1 && a->mm_active < a->mm_cw) || a->mm_threads < 32 || a->mm_threads > MM_THREADS || a->mm_threads % 32 || a->mm_active > a->mm_threads || a->mm_nseg < 1 ||
      a->mm_nseg > SS_MAX_FITS || (a->mm_path == MM_SPLIT && a->mm_chunk_rows < 1))
    return (int)cudaErrorInvalidValue;
  return a->mm_vec == 4 ? minmax_vec<4>(a, s) : minmax_vec<1>(a, s);
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
  cudaStream_t s = (cudaStream_t)stream;
  const bool prefix = a->prefix.n > 0;
  if (a->stat == SS_MINMAX)
    return minmax_launch(a, s);
  if (prefix && (a->stat == SS_MEAN || a->stat == SS_NANMEAN))
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
