// scaler_stats: MinMax stats of many machines over many row lists.
//
// Replaces `MinMaxScaler.compute_stats` (gordo_tpu/ops/scalers.py:139) as
// the XLA program `fleet.exact` runs it, vmapped per machine
// (gordo_tpu/parallel/anomaly.py:196 `_make_scale_chain` on each fold's
// and the full series' rows, :1124 the detector scaler on y).  Per machine,
// row list and column:
//
//   lo = nanmin(x[rows, j]),  hi = nanmax(x[rows, j])    (NaN if all NaN)
//   scale  = (b - a) / max(hi - lo, 1e-12)                (max keeps a NaN)
//   offset = a - lo * scale
//
// Bound: one pass over the rows, a compare or two per element: bound by
// device memory (each input row read once per row list).
//
// Design: one block per (row list, machine).  The block's threads split
// into one group per column; each thread strides over the rows of its
// column, the groups' partials meet in shared memory, and one thread per
// column writes its stats.  NaN follows the JAX package: NaN rows are
// skipped by the min and max (CUDA's fminf/fmaxf would skip them too, but
// an all-NaN column must come out NaN, and max(NaN, 1e-12) must stay NaN,
// which fmaxf would not do).  offset uses __fmul_rn/__fsub_rn (no FMA
// contraction), as the reference rounds it.

#include <cuda_runtime.h>
#include <math.h>

#define SS_MAX_FITS 16
#define SS_THREADS 256

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/scaler_stats.py.
struct ScalerStatsArgs {
  const float* x;      // (M, N, F)
  const int* rows;     // the row lists, concatenated
  float* scale;        // (M, G, F)
  float* offset;       // (M, G, F)
  int m;
  int n;
  int f;
  int g;
  int fit_rows[SS_MAX_FITS];
  int fit_row_off[SS_MAX_FITS];
  float range_lo;      // feature_range a
  float range_span;    // b - a
};

__global__ void __launch_bounds__(SS_THREADS) scaler_stats_kernel(const ScalerStatsArgs a) {
  __shared__ float s_lo[SS_THREADS];
  __shared__ float s_hi[SS_THREADS];
  __shared__ int s_any[SS_THREADS];
  const int fit = blockIdx.x;
  const int mach = blockIdx.y;
  const int t = threadIdx.x;
  const int F = a.f;
  const int n = a.fit_rows[fit];
  const int* rows = a.rows + a.fit_row_off[fit];
  const float* xm = a.x + (size_t)mach * a.n * F;
  // `per` threads per column, `cols` columns per pass
  const int per = F < SS_THREADS ? SS_THREADS / F : 1;
  const int cols = SS_THREADS / per;
  const int c = t / per;
  const int sub = t - c * per;
  for (int j0 = 0; j0 < F; j0 += cols) {
    const int j = j0 + c;
    float lo = INFINITY, hi = -INFINITY;
    int any = 0;
    if (c < cols && j < F) {
      for (int r = sub; r < n; r += per) {
        const float v = __ldg(xm + (size_t)rows[r] * F + j);
        if (v == v) {
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
          any = 1;
        }
      }
    }
    s_lo[t] = lo;
    s_hi[t] = hi;
    s_any[t] = any;
    __syncthreads();
    if (c < cols && j < F && sub == 0) {
      for (int k = 1; k < per; ++k) {
        lo = fminf(lo, s_lo[t + k]);
        hi = fmaxf(hi, s_hi[t + k]);
        any |= s_any[t + k];
      }
      if (!any) lo = hi = NAN;
      const float span = hi - lo;
      const float den = span != span ? span : fmaxf(span, 1e-12f);
      const float sc = a.range_span / den;
      const size_t o = ((size_t)mach * a.g + fit) * F + j;
      a.scale[o] = sc;
      a.offset[o] = __fsub_rn(a.range_lo, __fmul_rn(lo, sc));
    }
    __syncthreads();
  }
}

extern "C" int scaler_stats_args_size() { return (int)sizeof(ScalerStatsArgs); }

extern "C" const char* scaler_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int scaler_stats_launch(const ScalerStatsArgs* a, void* stream) {
  dim3 grid(a->g, a->m);
  scaler_stats_kernel<<<grid, SS_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
