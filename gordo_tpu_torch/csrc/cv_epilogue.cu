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
// mse and mae windows 32 rows x fo, 320), and each slot's sums wait on
// one another pass after pass.
//
// Two paths, chosen on the host (`launch_plan` in
// gordo_tpu_torch/kernels/cv_epilogue.py, which fills `path` and the
// launch's shape):
//
// The warp path (`cv_epilogue_warp_kernel`; fo <= 32, rows <= 1,024, a
// window of at most 8 rows, the slot staged within 48 KB): a slot is a
// block of two warps, at most 18 KB of shared memory at 144 x 10, so that
// twelve slots share an SM and 1,536 slots are resident at once (one wave;
// the launch bound caps a thread at 80 registers).  The slot's targets,
// predictions, scores and totals are staged by cp.async (16 bytes a copy
// where the slot's rows align, copy_async.cuh), the targets and
// predictions with 4 floats of padding after every 32 rows, so that the
// lanes reading one column in 32-row windows read other banks; one
// barrier makes the copies visible, and from there each warp runs on its
// own with warp-level synchronisation only.  Warp 1 starts K4's mse and mae
// windows first, a lane a window, both sums of the window on the lane
// (float4 or float2 loads where fo allows), and sums the windows in order
// by shuffles; then the maxima: a lane a (column, run of rows), the
// column's rolling minimum over the window sliding down the lane's rows in
// registers (8 rows a step, every index fixed at compile time), the runs'
// maxima combined by shuffles.  Warp 0 runs the metrics' passes: a lane a
// (column, 32-row window), the column's windows on consecutive lanes, as
// many columns a round as fit the warp (six at 144 rows); each lane sums
// its window in order, each column's window sums are added in order by
// shuffles on every lane of the column, which then holds the column's
// means for its next pass (K4 three passes, K8 two).  The per-column
// scores meet in shared memory, summed over the columns in order.
//
// The block path (`cv_epilogue_kernel`, the first design, for the rest):
// one block of 128 threads per slot.  The slot's scores, totals, targets,
// differences (and for K4 their squares) are staged in shared memory
// where they fit (48 KB), else read from device memory.  The maxima: the
// threads split into one group per column, each thread strides over its
// column's rows.  The metrics: columns in chunks that fit shared memory,
// each pass a window of 32 rows of one column a thread, two to four sums
// at once (xla_order_sums), K4 in three passes and K8 in two.  K4's mse
// and mae windows run in the last warp while the other three warps run
// the maxima and the passes on a named barrier of their own.  K4 runs at
// 64 registers a thread and K8 at 40.

#include <cuda_runtime.h>
#include <math.h>

#include "copy_async.cuh"
#include "xla_order.cuh"

#define CE_THREADS 128
#define CE_EPS 1e-12f
#define CE_PATH_WARP 0
#define CE_PATH_BLOCK 1

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/cv_epilogue.py.
struct CvEpilogueArgs {
  const float* tag;     // (S, nt, fo) detector-scaled |pred - y|
  const float* total;   // (S, nt)     its L2 norm over tags
  const float* pred;    // (S, nt, fo) out-of-fold predictions
  const float* y;       // (S, nt, fo) raw targets
  const int* n_rows;    // (S,) valid rows of each slot, 0 .. nt (null: every slot nt)
  float* feat_max;      // (S, fo)
  float* total_max;     // (S,)
  float* metrics;       // (S, 4): explained variance, r2, mse, mae
  float* has;           // (S,) 1 where the slot has a row, else 0
  int s;
  int nt;
  int fo;
  int window;
  int masked;           // 1: K8, a non-finite maximum of a slot with rows is 0
  int chunk;            // block path: columns a pass of the metrics (shared memory)
  int staged;           // block path: 1, the slot's y and y - pred staged in shared memory
  int path;             // CE_PATH_WARP or CE_PATH_BLOCK
  int vec;              // warp path: floats a load of K4's mse and mae windows (4, 2 or 1)
  int stage16;          // warp path: bit 0, rows of fo staged 16 bytes a copy; bit 1, the totals
  int smem_bytes;       // dynamic shared memory of a block
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
  const int n = a.n_rows ? a.n_rows[slot] : a.nt;
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

// ---------------------------------------------------------------------------
// The warp path

#define CW_THREADS 64     // two warps a slot
#define CW_MIN_BLOCKS 12  // slots an SM (1,536 slots of 144 x 10 in one wave)
#define CW_PAD 4         // floats after every 32 staged rows of y and pred
#define CW_FULL 0xffffffffu

__host__ __device__ __forceinline__ int cw_round4(int v) { return (v + 3) & ~3; }

// floats of a slot's staged y (or pred): nt rows of fo, CW_PAD after every 32
__host__ __device__ __forceinline__ int cw_rows_floats(int nt, int fo) {
  return cw_round4(nt * fo + CW_PAD * ((nt + 31) >> 5));
}

// the warp path's shared memory (floats): y, pred, the scores, the totals,
// and four per-column scores
__host__ __device__ __forceinline__ int cw_smem_floats(int nt, int fo) {
  return 2 * cw_rows_floats(nt, fo) + cw_round4(nt * fo) + cw_round4(nt) + 4 * fo;
}

// row r's first value in the staged y or pred
__device__ __forceinline__ int cw_at(int r, int fo) { return r * fo + CW_PAD * (r >> 5); }

// cp.async copies of `count` floats of src into dst, `pad` floats of gap in
// dst after every `block` floats (a multiple of 4); 16 bytes a copy where
// `v16` (src and dst 16-byte aligned), else 4
__device__ __forceinline__ void cw_stage(float* dst, const float* src, int count, int block, int pad, bool v16) {
  const int t = threadIdx.x;
  for (int e0 = 0, b = 0; e0 < count; e0 += block, ++b) {
    const int e1 = min(count, e0 + block);
    float* d = dst + pad * b;
    int e4 = e0;
    if (v16) {
      e4 = e0 + ((e1 - e0) & ~3);
      for (int e = e0 + 4 * t; e < e4; e += 4 * CW_THREADS) copy_async16(d + e, src + e);
    }
    for (int e = e4 + t; e < e1; e += CW_THREADS) copy_async(d + e, src + e);
  }
}

// `len` staged values of y and pred from ys and ps (a multiple of V, V
// floats aligned), their differences' squares summed in order into sq and
// their absolute values into ab
template <int V>
__device__ __forceinline__ void cw_run(const float* ys, const float* ps, int len, float& sq, float& ab) {
  constexpr int B = 16;  // values loaded ahead of their adds
  int k = 0;
  for (; k + B <= len; k += B) {
    float d[B];
#pragma unroll
    for (int u = 0; u < B; u += V) {
      float y[V], p[V];
      if (V == 4) {
        const float4 a = *reinterpret_cast<const float4*>(ys + k + u);
        const float4 b = *reinterpret_cast<const float4*>(ps + k + u);
        y[0] = a.x, y[1] = a.y, y[2 % V] = a.z, y[3 % V] = a.w;
        p[0] = b.x, p[1] = b.y, p[2 % V] = b.z, p[3 % V] = b.w;
      } else if (V == 2) {
        const float2 a = *reinterpret_cast<const float2*>(ys + k + u);
        const float2 b = *reinterpret_cast<const float2*>(ps + k + u);
        y[0] = a.x, y[1 % V] = a.y;
        p[0] = b.x, p[1 % V] = b.y;
      } else {
        y[0] = ys[k + u];
        p[0] = ps[k + u];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) d[u + v] = __fsub_rn(y[v], p[v]);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      sq = __fadd_rn(sq, __fmul_rn(d[u], d[u]));
      ab = __fadd_rn(ab, fabsf(d[u]));
    }
  }
  for (; k < len; ++k) {
    const float d = __fsub_rn(ys[k], ps[k]);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
    ab = __fadd_rn(ab, fabsf(d));
  }
}

// K4's mse and mae (fo <= XO_WINDOW: every row window one 2-D window):
// lane w sums window w (rows 32w - lo .. 32w - lo + 31 within [0, n)),
// row-major, its squares and its absolute values; the windows' sums are
// added in order, then scaled by 1 / (n fo), as xla_order_sum2 and
// xo_sum2_finish take them
template <int V>
__device__ void cw_sum2(const float* ys, const float* ps, int n, int fo, int l1, int lo, int lane, float* out) {
  float sq = 0.f, ab = 0.f;
  if (lane < l1) {
    const int r1 = min(n, 32 * lane - lo + 32);
    for (int r = max(0, 32 * lane - lo); r < r1;) {
      const int rb = min(r1, (r | 31) + 1);  // a run within one 32-row block of the staging
      const int at = cw_at(r, fo);
      cw_run<V>(ys + at, ps + at, (rb - r) * fo, sq, ab);
      r = rb;
    }
  }
  float tsq = 0.f, tab = 0.f;
  for (int w = 0; w < l1; ++w) {
    tsq = __fadd_rn(tsq, __shfl_sync(CW_FULL, sq, w));
    tab = __fadd_rn(tab, __shfl_sync(CW_FULL, ab, w));
  }
  if (lane == 0) {
    const float inv_all = __fdiv_rn(1.f, (float)n * (float)fo);
    out[2] = __fmul_rn(tsq, inv_all);
    out[3] = __fmul_rn(tab, inv_all);
  }
}

// max over rows [r0, r1) of the min over the W rows up to each (rows >= 0)
// of src[row * stride]; r0 a multiple of 8, so that row r's value lives in
// h[r & 7] / v[r & 7], every index fixed at compile time
template <int W>
__device__ __forceinline__ float cw_window_max(const float* src, int stride, int r0, int r1) {
  float mx = -INFINITY;
  if (r0 >= r1) return mx;
  float h[8];  // the previous 8 rows
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = INFINITY;
#pragma unroll
  for (int u = 1; u < W; ++u)
    if (r0 - u >= 0) h[8 - u] = src[(r0 - u) * stride];
  for (int r = r0; r < r1; r += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = r + i < r1 ? src[(r + i) * stride] : INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mn = v[i];
#pragma unroll
      for (int u = 1; u < W; ++u) mn = nan_min(mn, i >= u ? v[i - u] : h[8 + i - u]);
      if (r + i < r1) mx = nan_max(mx, mn);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = v[i];
  }
  return mx;
}

__device__ __forceinline__ float cw_window_max(int window, const float* src, int stride, int r0, int r1) {
  switch (window) {
    case 1: return cw_window_max<1>(src, stride, r0, r1);
    case 2: return cw_window_max<2>(src, stride, r0, r1);
    case 3: return cw_window_max<3>(src, stride, r0, r1);
    case 4: return cw_window_max<4>(src, stride, r0, r1);
    case 5: return cw_window_max<5>(src, stride, r0, r1);
    case 6: return cw_window_max<6>(src, stride, r0, r1);
    case 7: return cw_window_max<7>(src, stride, r0, r1);
    default: return cw_window_max<8>(src, stride, r0, r1);
  }
}

// the smoothed maxima of the fo tags and the total: lane (s, c) takes
// column j0 + c over its run s of rows, runs of a multiple of 8 rows; the
// runs of a column are combined by shuffles
template <bool MASKED>
__device__ void cw_maxima(const float* tg, const float* to, int n, int fo, int window, int lane, float* feat_max,
                          float* total_max) {
  const int ncol = fo + 1;
  const int cols = min(ncol, 32);  // columns a round
  const int runs = 32 / cols;
  const int s = lane / cols, c = lane - s * cols;
  const int len = ((n + runs - 1) / runs + 7) & ~7;
  const int r0 = min(n, s * len), r1 = min(n, r0 + len);
  for (int j0 = 0; j0 < ncol; j0 += cols) {
    const int j = j0 + c;
    float mx = -INFINITY;
    if (s < runs && j < ncol)
      mx = j < fo ? cw_window_max(window, tg + j, fo, r0, r1) : cw_window_max(window, to, 1, r0, r1);
    for (int d = cols; d < 32; d <<= 1) mx = nan_max(mx, __shfl_down_sync(CW_FULL, mx, d));
    if (s == 0 && j < ncol) {
      if (MASKED && !isfinite(mx)) mx = 0.f;
      if (j < fo)
        feat_max[j] = mx;
      else
        *total_max = mx;
    }
  }
}

// The metrics' passes: lane (cl, w) sums column j0 + cl's window w, rows
// 32w - lo .. 32w - lo + 31 within [0, n); the window's rows before and
// after the staging's 32-row boundary are two runs of stride fo (window 0
// has only the second).  `add(at, sums)` adds the row's values at staged
// index `at` into the lane's sums.
template <int K, typename Add>
__device__ __forceinline__ void cw_window(int n, int fo, int j, int w, int lo, bool on, float (&sums)[K], Add add) {
#pragma unroll
  for (int q = 0; q < K; ++q) sums[q] = 0.f;
  if (!on) return;
  const int ra = 32 * w - lo;     // the window's first row
  const int rb = min(n, 32 * w);  // the block boundary (rows before it in block w - 1)
  const int re = min(n, ra + 32);
  int at = cw_at(max(ra, 0), fo) + j;
#pragma unroll 4
  for (int r = max(ra, 0); r < rb; ++r, at += fo) add(at, sums);
  at = cw_at(max(rb, max(ra, 0)), fo) + j;
#pragma unroll 4
  for (int r = max(rb, max(ra, 0)); r < re; ++r, at += fo) add(at, sums);
}

// each column's sum of its lanes' window sums in order, on every lane of
// the column (its windows on lanes base .. base + l1 - 1)
__device__ __forceinline__ float cw_column_sum(float s, int base, int l1) {
  float acc = 0.f;
  for (int k = 0; k < l1; ++k) acc = __fadd_rn(acc, __shfl_sync(CW_FULL, s, (base + k) & 31));
  return acc;
}

template <bool MASKED>
__device__ void cw_passes(const float* ys, const float* ps, int n, int fo, int l1, int lo, int lane, float* per,
                          float* out) {
  const int cols = 32 / l1;  // columns a round
  const int cl = lane / l1, w = lane - cl * l1;
  const int base = cl * l1;
  const float nf = (float)n;
  const float inv_n = __fdiv_rn(1.f, nf);
  auto mean = [&](float s) { return MASKED ? __fdiv_rn(s, nf) : __fmul_rn(s, inv_n); };
  for (int j0 = 0; j0 < fo; j0 += cols) {
    const int j = j0 + cl;
    const bool on = cl < cols && j < fo;
    if (MASKED) {
      // pass 1: y, d = y - p, d^2, |d| (the rows past n add 0)
      float s[4];
      cw_window<4>(n, fo, j, w, lo, on, s, [&](int at, float(&a)[4]) {
        const float y = ys[at], d = __fsub_rn(y, ps[at]);
        a[0] = __fadd_rn(a[0], y);
        a[1] = __fadd_rn(a[1], d);
        a[2] = __fadd_rn(a[2], __fmul_rn(d, d));
        a[3] = __fadd_rn(a[3], fabsf(d));
      });
      const float my = mean(cw_column_sum(s[0], base, l1));
      const float md = mean(cw_column_sum(s[1], base, l1));
      const float sdd = cw_column_sum(s[2], base, l1);
      const float sad = cw_column_sum(s[3], base, l1);
      // pass 2: the centred squares
      float c2[2];
      cw_window<2>(n, fo, j, w, lo, on, c2, [&](int at, float(&a)[2]) {
        const float y = ys[at];
        const float cy = __fsub_rn(y, my), cd = __fsub_rn(__fsub_rn(y, ps[at]), md);
        a[0] = __fadd_rn(a[0], __fmul_rn(cy, cy));
        a[1] = __fadd_rn(a[1], __fmul_rn(cd, cd));
      });
      const float ss_tot = cw_column_sum(c2[0], base, l1);
      const float ss_d = cw_column_sum(c2[1], base, l1);
      if (on && w == 0) {
        per[j] = __fsub_rn(1.f, __fdiv_rn(mean(ss_d), floor_eps(mean(ss_tot))));
        per[fo + j] = __fsub_rn(1.f, __fdiv_rn(sdd, floor_eps(ss_tot)));
        per[2 * fo + j] = __fdiv_rn(sdd, nf);
        per[3 * fo + j] = __fdiv_rn(sad, nf);
      }
    } else {
      // pass 1: y, d = y - p, d^2
      float s[3];
      cw_window<3>(n, fo, j, w, lo, on, s, [&](int at, float(&a)[3]) {
        const float y = ys[at], d = __fsub_rn(y, ps[at]);
        a[0] = __fadd_rn(a[0], y);
        a[1] = __fadd_rn(a[1], d);
        a[2] = __fadd_rn(a[2], __fmul_rn(d, d));
      });
      const float my = mean(cw_column_sum(s[0], base, l1));
      const float md = mean(cw_column_sum(s[1], base, l1));
      const float sdd = cw_column_sum(s[2], base, l1);
      // pass 2: the centred values cy = y - mean y, cd = d - mean d
      float s2[3];
      cw_window<3>(n, fo, j, w, lo, on, s2, [&](int at, float(&a)[3]) {
        const float y = ys[at];
        const float cy = __fsub_rn(y, my);
        a[0] = __fadd_rn(a[0], __fmul_rn(cy, cy));
        a[1] = __fadd_rn(a[1], cy);
        a[2] = __fadd_rn(a[2], __fsub_rn(__fsub_rn(y, ps[at]), md));
      });
      const float den = cw_column_sum(s2[0], base, l1);
      const float mcy = mean(cw_column_sum(s2[1], base, l1));
      const float mcd = mean(cw_column_sum(s2[2], base, l1));
      // pass 3: jnp.var's own centring of cy and cd
      float s3[2];
      cw_window<2>(n, fo, j, w, lo, on, s3, [&](int at, float(&a)[2]) {
        const float y = ys[at];
        const float ey = __fsub_rn(__fsub_rn(y, my), mcy);
        const float ed = __fsub_rn(__fsub_rn(__fsub_rn(y, ps[at]), md), mcd);
        a[0] = __fadd_rn(a[0], __fmul_rn(ey, ey));
        a[1] = __fadd_rn(a[1], __fmul_rn(ed, ed));
      });
      const float sey = cw_column_sum(s3[0], base, l1);
      const float sed = cw_column_sum(s3[1], base, l1);
      if (on && w == 0) {
        per[j] = __fsub_rn(1.f, __fdiv_rn(mean(sed), floor_eps(mean(sey))));
        per[fo + j] = __fsub_rn(1.f, __fdiv_rn(sdd, floor_eps(den)));
      }
    }
  }
  __syncwarp();
  // the scores' means over the columns: each the sum in order times 1 / fo
  if (lane < (MASKED ? 4 : 2)) {
    float acc = 0.f;
    for (int c = 0; c < fo; ++c) acc = __fadd_rn(acc, per[lane * fo + c]);
    out[lane] = __fmul_rn(acc, __fdiv_rn(1.f, (float)fo));
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(CW_THREADS, CW_MIN_BLOCKS) cv_epilogue_warp_kernel(const __grid_constant__ CvEpilogueArgs a) {
  extern __shared__ __align__(16) float cw_smem[];
  const int slot = blockIdx.x;
  const int t = threadIdx.x;
  const int fo = a.fo, nt = a.nt;
  const int n = a.n_rows ? a.n_rows[slot] : a.nt;
  float* out = a.metrics + (size_t)slot * 4;
  if (n == 0) {  // uniform over the block
    for (int j = t; j < fo; j += CW_THREADS) a.feat_max[(size_t)slot * fo + j] = 0.f;
    if (t == 0) {
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
  float* ys = cw_smem;
  float* ps = ys + cw_rows_floats(nt, fo);
  float* tg = ps + cw_rows_floats(nt, fo);
  float* to = tg + cw_round4(nt * fo);
  float* per = to + cw_round4(nt);
  const size_t off = (size_t)slot * nt * fo;
  const bool v16 = a.stage16 & 1;
  cw_stage(ys, a.y + off, n * fo, 32 * fo, CW_PAD, v16);
  cw_stage(ps, a.pred + off, n * fo, 32 * fo, CW_PAD, v16);
  cw_stage(tg, a.tag + off, n * fo, n * fo, 0, v16);
  cw_stage(to, a.total + (size_t)slot * nt, n, n, 0, a.stage16 & 2);
  copy_async_commit();
  copy_async_wait<0>();
  __syncthreads();  // the one barrier: every copy visible to both warps

  const int lane = t & 31;
  const int L = MASKED ? nt : n;  // the sums' layout: the padded fold, or the real rows
  const int l1 = (L + 31) >> 5;
  const int lo = (32 * l1 - L) >> 1;
  if (t >= 32) {
    // K4's long serial windows first, then the maxima
    if (!MASKED) {
      if (a.vec == 4)
        cw_sum2<4>(ys, ps, n, fo, l1, lo, lane, out);
      else if (a.vec == 2)
        cw_sum2<2>(ys, ps, n, fo, l1, lo, lane, out);
      else
        cw_sum2<1>(ys, ps, n, fo, l1, lo, lane, out);
    }
    cw_maxima<MASKED>(tg, to, n, fo, a.window, lane, a.feat_max + (size_t)slot * fo, a.total_max + slot);
  } else {
    cw_passes<MASKED>(ys, ps, n, fo, l1, lo, lane, per, out);
  }
}

extern "C" int cv_epilogue_args_size() { return (int)sizeof(CvEpilogueArgs); }

extern "C" const char* cv_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dynamic shared memory `smem` for `kernel` (and for the warp path, whose
// slots share an SM's shared memory, the largest carveout; the block path
// keeps the default, its unstaged slots read through L1), then the launch
template <typename Kernel>
static int ce_launch(Kernel kernel, const CvEpilogueArgs* a, int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
  if (err == cudaSuccess && a->path == CE_PATH_WARP)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a->s, threads, a->smem_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Launches on `stream` without synchronising, by the path and the shared
// memory the plan chose (kernels/cv_epilogue.py::launch_plan); returns
// cudaGetLastError().
extern "C" int cv_epilogue_launch(const CvEpilogueArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->path == CE_PATH_WARP)
    return a->masked ? ce_launch(cv_epilogue_warp_kernel<true>, a, CW_THREADS, s)
                     : ce_launch(cv_epilogue_warp_kernel<false>, a, CW_THREADS, s);
  // the launch bounds measured fastest on an H100 (PERF.md): K4 at 64
  // registers a thread, K8 at 40
  return a->masked ? ce_launch(cv_epilogue_kernel<12, true>, a, CE_THREADS, s)
                   : ce_launch(cv_epilogue_kernel<8, false>, a, CE_THREADS, s);
}
