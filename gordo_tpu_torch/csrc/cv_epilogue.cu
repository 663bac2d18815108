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
// The metrics' sums run in XLA:CPU's window order (xla_order.cuh), as the
// JAX programs take them: on targets far from zero against their spread
// (a level of 1e4) another order moved r2 by 3e-5 and explained variance
// by 6e-5.  K4 sums each column over its n rows, a mean the sum times 1 /
// n; jnp.var centres its argument again, so explained variance takes three
// passes (mean, centred sum, centred squares); mse and mae are means of
// the whole n x fo array (xla_order_sum2).  K8 sums each column over the
// slot's nt rows, those past n adding 0 (the weighted forms' w * x), a
// weighted mean dividing by n; its mse and mae are means over the columns
// of per-column means.  The per-column scores' mean over the fo columns is
// their sum in order times 1 / fo (XLA's program may fuse that last sum
// and vectorise it: an ulp of a score, PERF.md).
//
// Bound: each input element is read once, a few operations each: by
// device memory (0.008 ms at 1,536 slots of 144 x 10).  In practice the
// window order's serial sums bound it: a window is 32 dependent adds (K4's
// mse and mae windows 32 rows x fo, 320), and with a dozen blocks on an
// SM each such chain waits for its issue slots.
//
// Design: one block of 128 threads per slot.  The slot's scores, totals,
// targets, differences (and for K4 their squares) are staged in shared
// memory where they fit (48 KB; a fold of 144 rows of 10 tags takes 25
// KB): read straight from device memory, each thread's loads waited on one
// another at the slot's first touch.  The maxima: the threads split into
// one group per column (the tags, then the total), each thread strides
// over its column's rows, each row's window loaded ahead of its min; min
// and max that keep a NaN are one instruction each.  The metrics: columns
// in chunks that fit shared memory, each pass a window of 32 rows of one
// column a thread, two to four sums at once (xla_order_sums), K4 in three
// passes and K8 in two, each form its own instantiation.  K4's mse and
// mae windows run in the last warp, two threads a window (squares, then
// absolute values), while the other three warps run the maxima and the
// passes on a named barrier of their own.  K4 runs at 64 registers a
// thread and K8 at 40, the faster of the launch bounds measured for each
// (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

#include "xla_order.cuh"

#define CE_THREADS 128
#define CE_EPS 1e-12f
#define CE_MAX_SMEM (200 * 1024)
#define CE_STAGE_SMEM (48 * 1024)  // a slot staged in shared memory up to this much

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
  int chunk;            // columns a pass of the metrics (shared memory)
  int staged;           // 1: the slot's y and y - pred staged in shared memory
};


// min and max that keep a NaN, one instruction each (PTX min.NaN,
// max.NaN; sm_80 and later)
__device__ __forceinline__ float nan_min(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? NAN : fminf(a, b);
#endif
}

__device__ __forceinline__ float nan_max(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? NAN : fmaxf(a, b);
#endif
}

// jnp.maximum(v, 1e-12), which keeps a NaN
__device__ __forceinline__ float floor_eps(float v) { return v != v ? v : fmaxf(v, CE_EPS); }

// the dynamic shared memory's parts (floats): the sums' levels, a pass's
// sums (4 a column), eight values a column across the passes, the four
// per-column scores of every column, mse and mae's windows, and the
// staged slot
__host__ __device__ __forceinline__ int ce_part_floats(int nt, int fo, int chunk) {
  int p = xo_part_floats(chunk, 4, nt);
  const int p2 = xo_sum2_part_floats(nt, fo, 2);
  const int p3 = xo_part_floats(1, 4, fo);
  p = p > p2 ? p : p2;
  return p > p3 ? p : p3;
}

__host__ __device__ __forceinline__ int ce_smem_floats(int nt, int fo, int chunk, int staged, int masked) {
  return ce_part_floats(nt, fo, chunk) + 4 * chunk + 8 * chunk + 4 * fo + 4 + xo_sum2_part_floats(nt, fo, 2) +
         (staged ? (masked ? 3 : 4) * nt * fo + nt : 0);
}

// K4's mse and mae windows (every column one window, fo <= XO_WINDOW): a
// window of 32 rows is a contiguous range of the slot's row-major values,
// summed in order, its squares into w[task] and its absolute values into
// w[R + task], each sum a task q of 2R (the two chains of a window on two
// threads).  STAGED: `sqs` and `ds` the staged squares and differences;
// else `ys` and `ds` the targets and predictions in device memory.
// `first` this thread's first task, `step` its stride.
template <bool STAGED>
__device__ __forceinline__ void sum2_windows(const float* sqs, const float* ds, const float* ys, int n, int fo,
                                             int R, int wr, int lr, int first, int step, float* w) {
  constexpr int B = 16;  // values loaded ahead of their adds
  for (int q = first; q < 2 * R; q += step) {
    const int task = q < R ? q : q - R;
    const bool squares = q < R;
    const int e1 = min(n, task * wr - lr + wr) * fo;
    const float* src = STAGED && squares ? sqs : ds;
    float s = 0.f;
    int e = max(0, task * wr - lr) * fo;
    for (; e + B <= e1; e += B) {
      float v[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (STAGED) {
          v[u] = squares ? src[e + u] : fabsf(src[e + u]);
        } else {
          const float d = __fsub_rn(__ldg(ys + e + u), __ldg(ds + e + u));
          v[u] = squares ? __fmul_rn(d, d) : fabsf(d);
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) s = __fadd_rn(s, v[u]);
    }
    for (; e < e1; ++e) {
      float v;
      if (STAGED) {
        v = squares ? src[e] : fabsf(src[e]);
      } else {
        const float d = __fsub_rn(__ldg(ys + e), __ldg(ds + e));
        v = squares ? __fmul_rn(d, d) : fabsf(d);
      }
      s = __fadd_rn(s, v);
    }
    w[q] = s;
  }
}

template <int CE_MIN_BLOCKS, bool MASKED>
__global__ void __launch_bounds__(CE_THREADS, CE_MIN_BLOCKS) cv_epilogue_kernel(const CvEpilogueArgs a) {
  __shared__ float s_max[CE_THREADS];
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

  extern __shared__ float smem[];
  float* part = smem;
  float* res = part + ce_part_floats(a.nt, fo, a.chunk);  // a pass's sums, 4 x chunk
  float* cv = res + 4 * a.chunk;                           // 8 x chunk, below
  float* per = cv + 8 * a.chunk;                           // 4 x fo: ev, r2, mse, mae a column
  float* fin = per + 4 * fo;
  float* win2 = fin + 4;                                   // K4's mse and mae windows
  const int L = MASKED ? a.nt : n;  // the sums' layout: the padded fold, or the real rows
  // the slot's scores, totals, targets and differences, staged in shared
  // memory where they fit (the maxima and every pass of the metrics read
  // them: from device memory each thread's loads waited one after another
  // on the slot's first touch), else read from device memory
  const float* ys = y;
  const float* ds = pred;
  const float* tags = tag;
  const float* tots = total;
  float* sq = nullptr;  // the staged squared differences (K4's mse windows)
  if (a.staged) {
    float* sy = win2 + xo_sum2_part_floats(a.nt, fo, 2);
    float* sd = sy + a.nt * fo;
    float* st = sd + a.nt * fo;
    float* so = st + a.nt * fo;
    sq = so + a.nt;
#pragma unroll 12
    for (int e = t; e < n * fo; e += CE_THREADS) {
      const float yv = __ldg(y + e);
      const float pv = __ldg(pred + e);
      const float d = __fsub_rn(yv, pv);
      st[e] = __ldg(tag + e);
      sy[e] = yv;
      sd[e] = d;
      if (!MASKED) sq[e] = __fmul_rn(d, d);
    }
    for (int r = t; r < n; r += CE_THREADS) so[r] = __ldg(total + r);
    ys = sy;
    ds = sd;
    tags = st;
    tots = so;
    __syncthreads();
  }
  const bool diffs = a.staged != 0;  // ds holds y - pred, not pred
  int R, wr, lr;  // K4's mse and mae windows, when every column is one window
  xo_dim(n, R, wr, lr);
  const bool rows_only = !MASKED && fo <= XO_WINDOW;
  // K4's mse and mae windows are long serial sums: the last warp runs them
  // while the team of the other warps runs the maxima and the passes
  const bool split = rows_only && CE_THREADS >= 64;
  const Team team{split ? CE_THREADS - 32 : CE_THREADS};
  if (t >= team.n) {
    if (diffs)
      sum2_windows<true>(sq, ds, ys, n, fo, R, wr, lr, t - team.n, CE_THREADS - team.n, win2);
    else
      sum2_windows<false>(sq, ds, ys, n, fo, R, wr, lr, t - team.n, CE_THREADS - team.n, win2);
  } else {
    // smoothed maxima over fo + 1 columns (the tags, then the total)
    {
      const int thr = team.n;
      const int ncol = fo + 1;
      const int per = ncol < thr ? thr / ncol : 1;
      const int cols = thr / per;
      const int c = t / per;
      const int sub = t - c * per;
      for (int j0 = 0; j0 < ncol; j0 += cols) {
        const int j = j0 + c;
        float mx = -INFINITY;
        if (c < cols && j < ncol) {
          const float* src = j < fo ? tags + j : tots;
          const int stride = j < fo ? fo : 1;
          for (int r = sub; r < n; r += per) {
            float mn = INFINITY;
            if (a.window <= 8) {
              // the window's values loaded ahead of the min (any order: a
              // NaN wins whatever its place, and the scores hold no -0)
              float v[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) v[u] = u < a.window && r >= u ? src[(size_t)(r - u) * stride] : INFINITY;
#pragma unroll
              for (int u = 0; u < 8; ++u) mn = nan_min(mn, v[u]);
            } else {
              for (int k = max(0, r - a.window + 1); k <= r; ++k) mn = nan_min(mn, src[(size_t)k * stride]);
            }
            mx = nan_max(mx, mn);
          }
        }
        s_max[t] = mx;
        team.sync();
        if (c < cols && j < ncol && sub == 0) {
          for (int k = 1; k < per; ++k) mx = nan_max(mx, s_max[t + k]);
          if (MASKED && !isfinite(mx)) mx = 0.f;
          if (j < fo)
            a.feat_max[(size_t)slot * fo + j] = mx;
          else
            a.total_max[slot] = mx;
        }
        team.sync();
      }
    }

    // the metrics, in XLA's order, `chunk` columns a pass
    const float nf = (float)n;
    const float inv_n = __fdiv_rn(1.f, nf);
    auto mean = [&](float s) { return MASKED ? __fdiv_rn(s, nf) : __fmul_rn(s, inv_n); };
    for (int j0 = 0; j0 < fo; j0 += a.chunk) {
      const int nc = min(a.chunk, fo - j0);
      float* my = cv;
      float* md = cv + a.chunk;
      float* sdd = cv + 2 * a.chunk;
      float* sad = cv + 3 * a.chunk;
      float* mcy = cv + 4 * a.chunk;
      float* mcd = cv + 5 * a.chunk;
      float* den = cv + 6 * a.chunk;
      float* num = cv + 7 * a.chunk;
      auto yv = [&](int c, int i) { return ys[(size_t)i * fo + j0 + c]; };
      auto dv = [&](int c, int i) {
        const float v = ds[(size_t)i * fo + j0 + c];
        return diffs ? v : __fsub_rn(yv(c, i), v);
      };
      if (MASKED) {
        // pass 1: y, d = y - p, d^2, |d| (the rows past n add 0)
        xla_order_sums<false>(nc, L, [&](int c, int i) {
          Vals<4> v = {{0.f, 0.f, 0.f, 0.f}};
          if (i < n) {
            const float d = dv(c, i);
            v = {{yv(c, i), d, __fmul_rn(d, d), fabsf(d)}};
          }
          return v;
        }, part, res, nullptr, team);
        for (int c = t; c < nc; c += team.n) {
          my[c] = mean(res[c]);
          md[c] = mean(res[nc + c]);
          sdd[c] = res[2 * nc + c];
          sad[c] = res[3 * nc + c];
        }
        team.sync();
        // pass 2: the centred squares
        xla_order_sums<false>(nc, L, [&](int c, int i) {
          Vals<2> v = {{0.f, 0.f}};
          if (i < n) {
            const float cy = __fsub_rn(yv(c, i), my[c]);
            const float cd = __fsub_rn(dv(c, i), md[c]);
            v = {{__fmul_rn(cy, cy), __fmul_rn(cd, cd)}};
          }
          return v;
        }, part, res, nullptr, team);
        for (int c = t; c < nc; c += team.n) {
          const float ss_tot = res[c];
          per[j0 + c] = __fsub_rn(1.f, __fdiv_rn(mean(res[nc + c]), floor_eps(mean(ss_tot))));
          per[fo + j0 + c] = __fsub_rn(1.f, __fdiv_rn(sdd[c], floor_eps(ss_tot)));
          per[2 * fo + j0 + c] = __fdiv_rn(sdd[c], nf);
          per[3 * fo + j0 + c] = __fdiv_rn(sad[c], nf);
        }
      } else {
        // pass 1: y, d = y - p, d^2
        xla_order_sums<false>(nc, L, [&](int c, int i) {
          const float d = dv(c, i);
          return Vals<3>{{yv(c, i), d, __fmul_rn(d, d)}};
        }, part, res, nullptr, team);
        for (int c = t; c < nc; c += team.n) {
          my[c] = mean(res[c]);
          md[c] = mean(res[nc + c]);
          sdd[c] = res[2 * nc + c];
        }
        team.sync();
        // pass 2: the centred values cy = y - mean y, cd = d - mean d
        xla_order_sums<false>(nc, L, [&](int c, int i) {
          const float cy = __fsub_rn(yv(c, i), my[c]);
          return Vals<3>{{__fmul_rn(cy, cy), cy, __fsub_rn(dv(c, i), md[c])}};
        }, part, res, nullptr, team);
        for (int c = t; c < nc; c += team.n) {
          den[c] = res[c];  // ss_tot
          mcy[c] = mean(res[nc + c]);
          mcd[c] = mean(res[2 * nc + c]);
        }
        team.sync();
        // pass 3: jnp.var's own centring of cy and cd
        xla_order_sums<false>(nc, L, [&](int c, int i) {
          const float ey = __fsub_rn(__fsub_rn(yv(c, i), my[c]), mcy[c]);
          const float ed = __fsub_rn(__fsub_rn(dv(c, i), md[c]), mcd[c]);
          return Vals<2>{{__fmul_rn(ey, ey), __fmul_rn(ed, ed)}};
        }, part, res, nullptr, team);
        for (int c = t; c < nc; c += team.n) {
          per[j0 + c] = __fsub_rn(1.f, __fdiv_rn(mean(res[nc + c]), floor_eps(mean(res[c]))));
          per[fo + j0 + c] = __fsub_rn(1.f, __fdiv_rn(sdd[c], floor_eps(den[c])));
        }
      }
      team.sync();
    }
  }
  __syncthreads();
  // the scores' means over the columns; K4's mse and mae over every value
  xla_order_sums<false>(1, fo, [&](int, int i) {
    return Vals<4>{{per[i], per[fo + i], MASKED ? per[2 * fo + i] : 0.f, MASKED ? per[3 * fo + i] : 0.f}};
  }, part, fin, nullptr);
  const float inv_fo = __fdiv_rn(1.f, (float)fo);
  float* out = a.metrics + (size_t)slot * 4;
  if (t == 0) {
    out[0] = __fmul_rn(fin[0], inv_fo);
    out[1] = __fmul_rn(fin[1], inv_fo);
    if (MASKED) {
      out[2] = __fmul_rn(fin[2], inv_fo);
      out[3] = __fmul_rn(fin[3], inv_fo);
    }
  }
  if (MASKED) return;
  __syncthreads();
  if (rows_only) {
    if (!split) {
      if (diffs)
        sum2_windows<true>(sq, ds, ys, n, fo, R, wr, lr, t, CE_THREADS, win2);
      else
        sum2_windows<false>(sq, ds, ys, n, fo, R, wr, lr, t, CE_THREADS, win2);
      __syncthreads();
    }
    xo_sum2_finish<2>(R, 1, win2, fin);
  } else {
    xla_order_sum2(n, fo, [&](int r, int c) {
      const float v = ds[(size_t)r * fo + c];
      const float d = diffs ? v : __fsub_rn(ys[(size_t)r * fo + c], v);
      return Vals<2>{{__fmul_rn(d, d), fabsf(d)}};
    }, part, fin);
  }
  if (t == 0) {
    const float inv_all = __fdiv_rn(1.f, (float)n * (float)fo);
    out[2] = __fmul_rn(fin[0], inv_all);
    out[3] = __fmul_rn(fin[1], inv_all);
  }
}

extern "C" int cv_epilogue_args_size() { return (int)sizeof(CvEpilogueArgs); }

extern "C" const char* cv_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The metrics' column chunk of nt-row slots of fo columns: every column in
// one pass where shared memory allows, else fewer (0: not even one).
static int ce_chunk(int nt, int fo, int staged, int masked) {
  int chunk = fo;
  while (chunk > 0 && (size_t)ce_smem_floats(nt, fo, chunk, staged, masked) * sizeof(float) > CE_MAX_SMEM) --chunk;
  return chunk;
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue where one column's sums do not fit.
extern "C" int cv_epilogue_launch(const CvEpilogueArgs* a, void* stream) {
  CvEpilogueArgs args = *a;
  // stage the slot where every column fits one pass beside it
  args.staged = (size_t)ce_smem_floats(a->nt, a->fo, a->fo, 1, a->masked) * sizeof(float) <= CE_STAGE_SMEM;
  args.chunk = ce_chunk(a->nt, a->fo, args.staged, a->masked);
  if (args.chunk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ce_smem_floats(a->nt, a->fo, args.chunk, args.staged, a->masked) * sizeof(float);
  // the launch bounds measured fastest on an H100 (PERF.md): K4 at 64
  // registers a thread, K8 at 40
  void (*kernel)(const CvEpilogueArgs) =
      a->masked ? cv_epilogue_kernel<12, true> : cv_epilogue_kernel<8, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a->s, CE_THREADS, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
