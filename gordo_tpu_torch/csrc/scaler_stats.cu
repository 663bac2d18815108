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
//              taken around the true mean)
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
// Design: one block per (row list, machine), one instantiation per
// statistic, with or without a prefix (the MinMax of a chain's first step
// runs the loop it ran before chains).  The block's threads split
// into one group per column; each thread strides over the rows of its
// column, the groups' partials meet in shared memory, and one thread per
// column finishes the column (Standard: the mean goes back through shared
// memory for the second pass).  NaN follows the JAX package: CUDA's
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

template <int STAT, bool PREFIX>
__global__ void __launch_bounds__(SS_THREADS) scaler_stats_kernel(const ScalerStatsArgs a) {
  __shared__ float s_a[SS_THREADS];
  __shared__ float s_b[SS_THREADS];
  __shared__ int s_any[SS_THREADS];
  __shared__ float s_mean[SS_THREADS];
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
    float pa = 0.f, pb = 0.f;
    int any = 0;
    if (STAT == SS_MINMAX) {
      pa = INFINITY;
      pb = -INFINITY;
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
    } else if (mine) {  // Standard, first pass: the sum and the count
      for (int r = sub; r < n; r += per) {
        const float v = load_value<PREFIX>(a, xm + (size_t)rows[r] * F + j, stat_row + j);
        if (v == v) {
          pa = __fadd_rn(pa, v);
          ++any;
        }
      }
    }
    s_a[t] = pa;
    s_b[t] = pb;
    s_any[t] = any;
    __syncthreads();
    if (mine && sub == 0) {
      for (int k = 1; k < per; ++k) {
        if (STAT == SS_MINMAX) {
          pa = fminf(pa, s_a[t + k]);
          pb = fmaxf(pb, s_b[t + k]);
          any |= s_any[t + k];
        } else {
          pa = __fadd_rn(pa, s_a[t + k]);
          any += s_any[t + k];
        }
      }
      if (STAT == SS_MINMAX) {
        if (!any) pa = pb = NAN;
        const float sc = __fdiv_rn(a.range_span, floor_eps(__fsub_rn(pb, pa)));
        a.out0[stat_row + j] = sc;
        a.out1[stat_row + j] = __fsub_rn(a.range_lo, __fmul_rn(pa, sc));
      } else {
        // 0 / 0 is NaN for an all-NaN column, as jnp.nanmean gives
        s_mean[c] = __fdiv_rn(pa, (float)any);
        s_any[t] = any;
      }
    }
    if (STAT == SS_STANDARD) {
      __syncthreads();
      const float mean = mine ? s_mean[c] : 0.f;
      const int count = mine ? s_any[c * per] : 0;
      float ss = 0.f;
      if (mine) {  // second pass: the squared deviations from the mean
        for (int r = sub; r < n; r += per) {
          const float v = load_value<PREFIX>(a, xm + (size_t)rows[r] * F + j, stat_row + j);
          if (v == v) {
            const float d = __fsub_rn(v, mean);
            ss = __fadd_rn(ss, __fmul_rn(d, d));
          }
        }
      }
      __syncthreads();
      s_a[t] = ss;
      __syncthreads();
      if (mine && sub == 0) {
        for (int k = 1; k < per; ++k) ss = __fadd_rn(ss, s_a[t + k]);
        // jnp.nanvar: NaN where no value counts
        const float var = count > 0 ? __fdiv_rn(ss, (float)count) : NAN;
        const float std = floor_eps(__fsqrt_rn(var));
        a.out0[stat_row + j] = a.with_mean ? mean : 0.f;
        a.out1[stat_row + j] = a.with_std ? std : 1.f;
      }
    }
    __syncthreads();
  }
}

// The means (SS_MEAN, SS_NANMEAN) sum in XLA:CPU's order, so that a mean
// is the JAX package's bit for bit: XLA's tree-reduction rewrite splits a
// reduction over more than SS_WINDOW values into windows of SS_WINDOW,
// padded with zeros to a multiple of it (half the padding in front, the
// rest behind), sums each window in order, and reduces the window sums the
// same way; XLA then multiplies jnp.mean's sum by 1 / N (a division by a
// constant).  One block per (column, machine, row list): each thread sums
// whole windows in order into shared memory, level after level, and one
// thread finishes the last SS_WINDOW or fewer.  A NaN-mean adds 0 for a
// NaN (jnp.nansum) and divides by the count.  Bound by device memory, each
// value read once (the column's loads are strided by F).
#define SS_WINDOW 32

// the window sums of `n` values read by `at(i)` into `out`, ceil(n / W)
// of them, the padding's zeros skipped (x + 0 = x)
template <typename At>
__device__ void window_sums(int n, At at, float* out) {
  const int m = (n + SS_WINDOW - 1) / SS_WINDOW * SS_WINDOW;
  const int lo = (m - n) / 2;
  for (int b = threadIdx.x; b < m / SS_WINDOW; b += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < SS_WINDOW; ++j) {
      const int i = b * SS_WINDOW + j - lo;
      if (i >= 0 && i < n) s = __fadd_rn(s, at(i));
    }
    out[b] = s;
  }
}

__global__ void __launch_bounds__(SS_THREADS) scaler_mean_kernel(const ScalerStatsArgs a) {
  extern __shared__ float part[];   // ceil(n / W) + ceil(n / W^2) floats
  __shared__ int s_count;
  const int col = blockIdx.x;
  const int mach = blockIdx.y;
  const int fit = blockIdx.z;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const int* rows = a.rows + a.fit_row_off[fit];
  const float* xm = a.x + (size_t)mach * a.n * F + col;
  const size_t at = ((size_t)mach * a.g + fit) * F + col;
  const bool skip_nan = a.stat == SS_NANMEAN;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = __ldg(xm + (size_t)rows[i] * F);
    count += v == v;
  }
  atomicAdd(&s_count, count);
  float* cur = part;
  float* nxt = part + (n + SS_WINDOW - 1) / SS_WINDOW;
  int len = n;
  if (len > SS_WINDOW) {
    window_sums(len, [&](int i) {
      const float v = __ldg(xm + (size_t)rows[i] * F);
      return skip_nan && v != v ? 0.f : v;
    }, cur);
    len = (len + SS_WINDOW - 1) / SS_WINDOW;
    __syncthreads();
    while (len > SS_WINDOW) {
      window_sums(len, [&](int i) { return cur[i]; }, nxt);
      len = (len + SS_WINDOW - 1) / SS_WINDOW;
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      __syncthreads();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    const bool leaves = n > SS_WINDOW;
    for (int i = 0; i < len; ++i) {
      float v = leaves ? cur[i] : __ldg(xm + (size_t)rows[i] * F);
      if (!leaves && skip_nan && v != v) v = 0.f;
      s = __fadd_rn(s, v);
    }
    const float cnt = skip_nan ? (float)s_count : (float)n;
    a.out0[at] = skip_nan ? __fdiv_rn(s, cnt) : __fmul_rn(s, __fdiv_rn(1.0f, cnt));
    a.out1[at] = cnt;
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
    scaler_stats_kernel<SS_MINMAX, false><<<grid, SS_THREADS, 0, s>>>(*a);
  else if (a->stat == SS_MINMAX)
    scaler_stats_kernel<SS_MINMAX, true><<<grid, SS_THREADS, 0, s>>>(*a);
  else if (a->stat == SS_STANDARD && !prefix)
    scaler_stats_kernel<SS_STANDARD, false><<<grid, SS_THREADS, 0, s>>>(*a);
  else if (a->stat == SS_STANDARD)
    scaler_stats_kernel<SS_STANDARD, true><<<grid, SS_THREADS, 0, s>>>(*a);
  else if ((a->stat == SS_MEAN || a->stat == SS_NANMEAN) && !prefix) {
    int longest = 0;
    for (int i = 0; i < a->g; ++i) longest = a->fit_rows[i] > longest ? a->fit_rows[i] : longest;
    const int level1 = (longest + SS_WINDOW - 1) / SS_WINDOW;
    const size_t smem = (size_t)(level1 + (level1 + SS_WINDOW - 1) / SS_WINDOW) * sizeof(float);
    if (smem > SS_MEAN_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(scaler_mean_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    scaler_mean_kernel<<<dim3(a->f, a->m, a->g), SS_THREADS, smem, s>>>(*a);
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
