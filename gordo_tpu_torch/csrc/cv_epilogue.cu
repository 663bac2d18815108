// cv_epilogue: thresholds and CV metrics of each (machine, fold).
//
// Replaces the fold epilogue of the XLA program `fleet.exact`
// (gordo_tpu/parallel/anomaly.py:1155-1170): `_smoothed_max` (:175) over
// `_trailing_rolling_min` (:162) of the detector-scaled tag errors and of
// their L2 total, and the four metrics of gordo_tpu/ops/metrics.py:26-52;
// and that of the pad-up program `fleet.padded` (:1380-1390, K8):
// `_masked_smoothed_max` (:185) and the row-weighted metrics (metrics.py:
// 67-104) under a row mask.  The pad-up build's mask is always a suffix
// (its folds are contiguous blocks, parallel/anomaly.py:653-690), so the
// masked maxima and 0/1-weighted metrics are those over each slot's first
// n rows: one kernel takes both, with a count per slot.  Per slot (one
// machine's out-of-fold rows of one fold), over its first n rows:
//
//   feat_max[j] = max_r min_{r-W < r' <= r, r' >= 0} tag[r', j]   (W = 6)
//   total_max   = the same over total[r]
//   ev  = mean_j(1 - var(y_j - p_j) / max(var(y_j), 1e-12))
//   r2  = mean_j(1 - sum (y_j - p_j)^2 / max(sum (y_j - mean y_j)^2, 1e-12))
//   mse = mean (y - p)^2,  mae = mean |y - p|
//
// A slot with n = 0 gets what the masked forms give with no row: maxima 0,
// explained variance and r2 1, mse and mae 0, and has = 0 (else 1), the
// flag the fold means are weighted by.
//
// NaN follows XLA: a NaN in a window makes its min NaN, and a NaN min makes
// the max NaN (CUDA's fminf/fmaxf would drop it); max(NaN, 1e-12) stays NaN.
// The masked epilogue (`masked`, K8) then maps a maximum that is not finite
// to 0, as `_masked_smoothed_max` does (:193); the exact one (K4) keeps it.
// The first W-1 rows take the min over the rows that exist (pandas'
// min_periods=1): the window never reaches before row 0.
//
// Bound: each input element is read once for the maxima and twice for the
// two-pass variances, a few operations each: bound by device memory.
//
// Design: one block per slot.  The block's threads split into one group
// per column (the tags, then the total); each thread strides over its
// column's rows, and the groups' partials meet in shared memory.  A rolling
// min reads its window from L1.  Variances take two passes (means first),
// so nothing cancels.

#include <cuda_runtime.h>
#include <math.h>

#define CE_THREADS 256
#define CE_EPS 1e-12f

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/cv_epilogue.py.
struct CvEpilogueArgs {
  const float* tag;     // (S, nt, fo) detector-scaled |pred - y|
  const float* total;   // (S, nt)     its L2 norm over tags
  const float* pred;    // (S, nt, fo) out-of-fold predictions
  const float* y;       // (S, nt, fo) raw targets
  const int* n_rows;    // (S,) valid rows of each slot, 0 .. nt
  float* feat_max;      // (S, fo)
  float* total_max;     // (S,)
  float* metrics;       // (S, 4): explained variance, r2, mse, mae
  float* has;           // (S,) 1 where the slot has a row, else 0
  int s;
  int nt;
  int fo;
  int window;
  int masked;           // 1: K8, a non-finite maximum of a slot with rows is 0
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__global__ void __launch_bounds__(CE_THREADS) cv_epilogue_kernel(const CvEpilogueArgs a) {
  __shared__ float part[4][CE_THREADS];
  __shared__ float col[6][CE_THREADS];  // per column: the sums the metrics need
  const int slot = blockIdx.x;
  const int t = threadIdx.x;
  const int fo = a.fo;
  const int n = a.n_rows[slot];
  const float* tag = a.tag + (size_t)slot * a.nt * fo;
  const float* total = a.total + (size_t)slot * a.nt;
  const float* pred = a.pred + (size_t)slot * a.nt * fo;
  const float* y = a.y + (size_t)slot * a.nt * fo;
  if (n == 0) {  // uniform over the block: no barrier is skipped by part of it
    for (int j = t; j < fo; j += CE_THREADS) a.feat_max[(size_t)slot * fo + j] = 0.f;
    if (t == 0) {
      float* out = a.metrics + (size_t)slot * 4;
      a.total_max[slot] = 0.f;
      out[0] = 1.f;
      out[1] = 1.f;
      out[2] = 0.f;
      out[3] = 0.f;
      a.has[slot] = 0.f;
    }
    return;
  }
  if (t == 0) a.has[slot] = 1.f;

  // smoothed maxima over fo + 1 columns (the tags, then the total)
  {
    const int ncol = fo + 1;
    const int per = ncol < CE_THREADS ? CE_THREADS / ncol : 1;
    const int cols = CE_THREADS / per;
    const int c = t / per;
    const int sub = t - c * per;
    for (int j0 = 0; j0 < ncol; j0 += cols) {
      const int j = j0 + c;
      float mx = -INFINITY;
      if (c < cols && j < ncol) {
        const float* src = j < fo ? tag + j : total;
        const int stride = j < fo ? fo : 1;
        for (int r = sub; r < n; r += per) {
          float mn = INFINITY;
          for (int k = max(0, r - a.window + 1); k <= r; ++k)
            mn = nan_min(mn, __ldg(src + (size_t)k * stride));
          mx = nan_max(mx, mn);
        }
      }
      part[0][t] = mx;
      __syncthreads();
      if (c < cols && j < ncol && sub == 0) {
        for (int k = 1; k < per; ++k) mx = nan_max(mx, part[0][t + k]);
        if (a.masked && !isfinite(mx)) mx = 0.f;
        if (j < fo)
          a.feat_max[(size_t)slot * fo + j] = mx;
        else
          a.total_max[slot] = mx;
      }
      __syncthreads();
    }
  }

  // metrics over fo columns: pass 1 sums, pass 2 centred squares
  const int per = fo < CE_THREADS ? CE_THREADS / fo : 1;
  const int cols = CE_THREADS / per;
  const int c = t / per;
  const int sub = t - c * per;
  float ev_acc = 0.f, r2_acc = 0.f, sq_acc = 0.f, abs_acc = 0.f;  // thread 0's
  const float nf = (float)n;
  for (int j0 = 0; j0 < fo; j0 += cols) {
    const int j = j0 + c;
    const bool mine = c < cols && j < fo;
    float sy = 0.f, sd = 0.f, sd2 = 0.f, sad = 0.f;
    if (mine) {
      for (int r = sub; r < n; r += per) {
        const float yv = __ldg(y + (size_t)r * fo + j);
        const float dv = yv - __ldg(pred + (size_t)r * fo + j);
        sy += yv;
        sd += dv;
        sd2 += dv * dv;
        sad += fabsf(dv);
      }
    }
    part[0][t] = sy;
    part[1][t] = sd;
    part[2][t] = sd2;
    part[3][t] = sad;
    __syncthreads();
    if (mine && sub == 0) {
      for (int k = 1; k < per; ++k) {
        sy += part[0][t + k];
        sd += part[1][t + k];
        sd2 += part[2][t + k];
        sad += part[3][t + k];
      }
      col[0][c] = sy / nf;  // mean y
      col[1][c] = sd / nf;  // mean (y - p)
      col[2][c] = sd2;
      col[3][c] = sad;
    }
    __syncthreads();
    float vy = 0.f, vd = 0.f;
    if (mine) {
      const float my = col[0][c], md = col[1][c];
      for (int r = sub; r < n; r += per) {
        const float yv = __ldg(y + (size_t)r * fo + j);
        const float cy = yv - my;
        const float cd = (yv - __ldg(pred + (size_t)r * fo + j)) - md;
        vy += cy * cy;
        vd += cd * cd;
      }
    }
    part[0][t] = vy;
    part[1][t] = vd;
    __syncthreads();
    if (mine && sub == 0) {
      for (int k = 1; k < per; ++k) {
        vy += part[0][t + k];
        vd += part[1][t + k];
      }
      col[4][c] = vy;
      col[5][c] = vd;
    }
    __syncthreads();
    if (t == 0) {
      for (int k = 0; k < cols && j0 + k < fo; ++k) {
        const float ss_tot = col[4][k];
        const float var_y = ss_tot / nf;
        const float var_d = col[5][k] / nf;
        ev_acc += 1.f - var_d / (var_y != var_y ? var_y : fmaxf(var_y, CE_EPS));
        r2_acc += 1.f - col[2][k] / (ss_tot != ss_tot ? ss_tot : fmaxf(ss_tot, CE_EPS));
        sq_acc += col[2][k];
        abs_acc += col[3][k];
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    float* out = a.metrics + (size_t)slot * 4;
    out[0] = ev_acc / (float)fo;
    out[1] = r2_acc / (float)fo;
    out[2] = sq_acc / (nf * (float)fo);
    out[3] = abs_acc / (nf * (float)fo);
  }
}

extern "C" int cv_epilogue_args_size() { return (int)sizeof(CvEpilogueArgs); }

extern "C" const char* cv_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int cv_epilogue_launch(const CvEpilogueArgs* a, void* stream) {
  cv_epilogue_kernel<<<a->s, CE_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
