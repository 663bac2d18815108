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
//              offset = a - lo * scale
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
// as `x * a + b`, a Standard or Robust step as `(x - a) / b` (the
// reference's form, each step rounded on its own, __fmul_rn/__fadd_rn/
// __fdiv_rn so that no FMA is contracted).  A NaN (pad-up padding) stays
// NaN through the prefix and falls out of the stats.
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
  const int* rows;     // the row lists, concatenated
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
  int with_mean;       // Standard
  int with_std;        // Standard
  ScalerPrefix prefix;
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
  const int* rows = a.rows + a.fit_row_off[fit];
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
      a.out1[stat_row + j] = __fsub_rn(a.range_lo, __fmul_rn(pa, sc));
    }
    __syncthreads();
  }
}

// The means (SS_MEAN, SS_NANMEAN) and the Standard statistic's two sums
// run in XLA:CPU's order, so that a mean is the JAX package's bit for bit:
// XLA's tree-reduction rewrite splits a reduction over more than SS_WINDOW
// values into windows of SS_WINDOW, padded with zeros to a multiple of it
// (half the padding in front, the rest behind), sums each window in order,
// and reduces the window sums the same way; XLA then multiplies jnp.mean's
// sum by 1 / N (a division by a constant).  A NaN-mean adds 0 for a NaN
// (jnp.nansum) and divides by the count.
//
// Design: one block per (column group, machine, row list).  A group holds
// as many of the F columns as give each thread about one window (the
// launcher's choice, within shared memory: a fold of 576 rows has 18
// windows a column, so 10 tags are one group; a year's 1,643 windows a
// column one column a group).  Each thread sums whole windows in order,
// thread t taking column t % nc of window t / nc, so that a warp's loads
// are the columns of the same rows; the window sums go to shared memory,
// level after level, and one thread a column adds the last SS_WINDOW or
// fewer in order.  Bound by device memory, each value read once a pass.
#define SS_WINDOW 32

// the window sums of each of the block's `nc` columns, `n` values each
// read by `at(c, i)`, into `out` (column c's at out + c * stride, ceil(n /
// W) of them), the padding's zeros skipped (x + 0 = x).  COUNT: a NaN adds
// 0 and each column's other values are counted into `cnt`.
template <bool COUNT, typename At>
__device__ void window_sums(int nc, int n, At at, float* out, int stride, int* cnt) {
  const int m = (n + SS_WINDOW - 1) / SS_WINDOW * SS_WINDOW;
  const int lo = (m - n) / 2;
  for (int task = threadIdx.x; task < nc * (m / SS_WINDOW); task += blockDim.x) {
    const int c = task % nc;
    const int i0 = task / nc * SS_WINDOW - lo;  // the window's first value
    const int j1 = min(SS_WINDOW, n - i0);
    float s = 0.f;
    int k = 0;
#pragma unroll 8
    for (int j = max(0, -i0); j < j1; ++j) {
      float v = at(c, i0 + j);
      if (COUNT) {
        k += v == v;
        v = v == v ? v : 0.f;
      }
      s = __fadd_rn(s, v);
    }
    out[c * stride + task / nc] = s;
    if (COUNT) atomicAdd(cnt + c, k);
  }
}

// The sum of each of the block's `nc` columns in XLA's window order into
// `res` (shared, nc floats), and with COUNT each column's non-NaN values
// into `cnt` (shared, zeroed before), which every thread sees on return.
// `part` holds the window sums: nc * ceil(n / W) floats, then nc *
// ceil(ceil(n / W) / W) for the levels above (the two halves in turn).
template <bool COUNT, typename At>
__device__ void xla_order_sums(int nc, int n, At at, float* part, float* res, int* cnt) {
  const int level1 = (n + SS_WINDOW - 1) / SS_WINDOW;
  float* cur = part;
  float* nxt = part + nc * level1;
  int s_cur = level1, s_nxt = (level1 + SS_WINDOW - 1) / SS_WINDOW;
  int len = n;
  const bool leaves = n > SS_WINDOW;
  if (leaves) {
    window_sums<COUNT>(nc, len, at, cur, s_cur, cnt);
    len = level1;
    __syncthreads();
    while (len > SS_WINDOW) {
      window_sums<false>(nc, len, [&](int c, int i) { return cur[c * s_cur + i]; }, nxt, s_nxt, cnt);
      len = (len + SS_WINDOW - 1) / SS_WINDOW;
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      const int s_tmp = s_cur;
      s_cur = s_nxt;
      s_nxt = s_tmp;
      __syncthreads();
    }
  }
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    float s = 0.f;
    int k = 0;
    for (int i = 0; i < len; ++i) {
      float v = leaves ? cur[c * s_cur + i] : at(c, i);
      if (COUNT && !leaves) {
        k += v == v;
        v = v == v ? v : 0.f;
      }
      s = __fadd_rn(s, v);
    }
    res[c] = s;
    if (COUNT && !leaves) cnt[c] = k;
  }
  __syncthreads();
}

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
  const int* rows = a.rows + a.fit_row_off[fit];
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
  const int* rows = a.rows + a.fit_row_off[fit];
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

extern "C" int scaler_stats_args_size() { return (int)sizeof(ScalerStatsArgs); }

// The longest row list whose two levels of window sums, ceil(n / 32) and
// ceil(ceil(n / 32) / 32) floats, fit SS_MEAN_SMEM.
extern "C" int scaler_stats_mean_max_rows() {
  const int floats = SS_MEAN_SMEM / (int)sizeof(float);
  int level1 = floats;
  while (level1 + (level1 + SS_WINDOW - 1) / SS_WINDOW > floats) --level1;
  return level1 * SS_WINDOW;
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
    // the window-ordered sums: one block per (column group, machine, row
    // list), a group as many columns as give each thread about one window
    // of its longest row list and fit the window sums in shared memory
    int longest = 0;
    for (int i = 0; i < a->g; ++i) longest = a->fit_rows[i] > longest ? a->fit_rows[i] : longest;
    const int level1 = (longest + SS_WINDOW - 1) / SS_WINDOW;
    const size_t column_smem = (size_t)(level1 + (level1 + SS_WINDOW - 1) / SS_WINDOW) * sizeof(float);
    if (column_smem > SS_MEAN_SMEM) return (int)cudaErrorInvalidValue;
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
