// stream_step: one arriving row of one machine's stream, scored (K9).
//
// Replaces the XLA program `serve.stream_step` (gordo_tpu/serve/stream.py:175
// `_stream_step_fn`, registered :275).  The carried state is a raw-input
// ring (H = offset + W rows, newest last; W = max(detector window, 1)), the
// count of rows ever ingested and the tag scores of the ring's W scored
// rows (W x fo, float).  Per arriving row x:
//
//   ring'  = ring[1:] ++ [x];  count' = count + 1       (into the other half
//                                                       of a double buffer)
//   the newest row (or, for an LSTM, lstm_layer's state of the newest
//   window) through the dense stack, scored against its raw target:
//   tag = |d(p) - d(y)|  (d the detector scaler's step);
//   tags' = tags[1:] ++ [tag]  (into the other half of a double buffer)
//   each row's total = L2(tag) at the row's position in the window
//   n_valid = clip(count' - offset, 0, W): the newest n_valid raw scores
//   are real, the older ones masked to NaN
//   verdict = nanmedian over the W (masked) raw scores of each tag and of
//   the total;  valid = count' > offset;  conf = total / max(thr, 1e-12)
//
// A row's tag scores depend on that row alone, so they are carried as the
// row ages; its total does not (row_l2 starts its sum at the tag given by
// the row's position), so every total is summed again each step, fo adds a
// row.  Without carried tags (`tags_in` null) the step scores all W rows:
// the mode that primes the carried tags when a stream binds or rebinds.
// Both modes give the same bits: a row's dense stack, tag scores and total
// are the same instructions on the same values whichever tile holds it.
//
// At steady state (count' >= H) the verdict is bit for bit what the port's
// request path gives for the newest of the same H rows (fleet_score, then
// rolling_median): the dense stack, the tag scores, the L2 sum (from the
// tag given by the row's index) and the confidence's divisor are
// dense_rows.cuh's, the code fleet_score runs, and the median is
// rolling_median's (s[(c-1)/2] + s[c/2]) * 0.5 over the c non-NaN values.
//
// A feedforward chain is one launch: ring shift, scaler, dense stack,
// scores, median.  An LSTM chain launches it twice: first the ring shift
// alone (`score` 0), then, after one lstm_layer per layer over the shifted
// ring's newest window (all W windows when priming), the scoring with the
// LSTM's `out` head as the dense stack and the layers' last state as its
// input (`h`).
//
// A fused transform chain (SimpleImputer, PCA and the scalers; the JAX
// package's `Xc = chain(ring)`, gordo_tpu/serve/stream.py:227-228) takes
// three launches as well: the ring shift alone, then chain_apply over the
// shifted ring's newest row (or an LSTM's newest window; the whole ring
// when priming), then the scoring with the chain's output as `h` and the
// raw ring rows as targets.  The chain is not a prefix inside this kernel:
// chain_apply is the kernel the request path runs, so the stream's chain
// outputs, and with them its verdicts, are the request path's bit for bit.
//
// Bound: a step moves the ring (2 H F values), the carried tags (2 W fo),
// the chain's weights and stats, and writes a few dozen floats: a few
// microseconds of bytes at most, so a step is bound by its launch and its
// single block's latency.
//
// Design: one block.  The ring and the carried tags are copied shifted by
// all threads; the newest row is scored as fleet_score scores a tile (or,
// priming, the W rows in tiles of R rows), into a series-major fo x W
// buffer of tag scores in shared memory, beside which every row's total is
// summed (tags_l2).  Each series' median is read from its W values sorted
// by one warp, the series spread over the block's warps: masked and NaN
// values become +inf and are counted out, and a bitonic network sorts the
// values in registers (K a lane, 32 K >= W: compare-exchanges inside a
// lane, or across lanes by shuffles), or past 1,024 values in place in
// shared memory, with the values past W taken as +inf.  The two middle
// values of the sorted series are the two the request path's
// rolling_median takes.  Storage types as fleet_score's (T: f32 or bf16
// for the ring, weights and stats; `h` and the tags are f32).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "copy_async.cuh"
#include "dense_rows.cuh"

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/stream_step.py;
// stream_step_args_size() lets the wrapper check the two agree.
struct StreamStepArgs {
  const void* ring_in;      // (H, F) T
  const void* x;            // (F,) T: the arriving row, or null: ring_in is already shifted
  void* ring_out;           // (H, F) T: ring_in shifted with x last (when x is set)
  int* count;               // (1,) rows ingested; + 1 when x is set
  const float* h;           // rows of an LSTM's last-layer state (or a transform chain's output)
                            // from window position h_first on, or null: the ring's rows
  ScalerPrefix scalers;     // the pipeline's scaler steps, stats (F,) T (ring rows only; n 0: none)
  DenseChain chain;         // the dense stack (an LSTM's `out` head), T
  ScalerPrefix det;         // the detector scaler, one step, stats (fo,) T
  const float* agg_thr;     // (1,) aggregate threshold, or null: no confidence
  const float* tags_in;     // (W, fo) the carried tag scores before this step, or null: score all W rows
  float* tags_out;          // (W, fo) the tag scores after this step, or null: not kept
  float* verdict;           // (fo + 3,): tag scores, total, confidence, valid (0 / 1)
  int H;
  int F;
  int W;
  int mode_offset;          // ring rows before the first scored row's target
  int score;                // 0: shift the ring only
  int h_first;              // the window position of h's first row
  int rows_per_tile;        // R, a multiple of DR_RPT
  int max_dim;
  int wbuf_floats;
  int smem_bytes;
  int sort_k;               // values a lane sorts (32 sort_k >= W), 0: sort in shared memory
  int bf16;                 // T is __nv_bfloat16
};

template <typename T>
__device__ __forceinline__ float ring_value(const StreamStepArgs& a, int row, int j) {
  // row `row` of the ring after this step's shift
  const T* ring = static_cast<const T*>(a.ring_in);
  if (!a.x) return ld(ring + (size_t)row * a.F + j);
  return row == a.H - 1 ? ld(static_cast<const T*>(a.x) + j) : ld(ring + (size_t)(row + 1) * a.F + j);
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// the value at `i` of a series of W, +inf where it is masked or NaN;
// `*valid` counts the others
__device__ __forceinline__ float sort_value(const float* s, int i, int W, int first, int* valid) {
  if (i >= W || i < first) return INFINITY;
  const float v = s[i];
  if (isnan(v)) return INFINITY;
  ++*valid;
  return v;
}

__device__ __forceinline__ void order(float& lo, float& hi) {
  const float a = lo;
  lo = fminf(a, hi);
  hi = fmaxf(a, hi);
}

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n >> 1); }

// Median of one series of W values `s` (shared memory), sorted by the
// calling warp in registers: value e of the padded series (32 K of them)
// sits in lane e / K, slot e % K.  A bitonic network in which every
// compare-exchange puts the smaller value at the lower index: stage k
// first pairs e with e ^ (k - 1) (the block of k reversed), then with e ^ j
// for j = k / 4 .. 1.  Every loop runs over exponents with constant
// bounds, so it unrolls and v stays in registers (indexed at run time, the
// array would sit in local memory).
template <int K>
__device__ float median_in_registers(const float* s, int W, int first) {
  constexpr int LOG_P = 5 + log2_of(K);
  const int lane = threadIdx.x & 31;
  float v[K];
  int valid = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = sort_value(s, lane * K + r, W, first, &valid);
  const int n = __reduce_add_sync(0xffffffffu, valid);
  if (n == 0) return nan_f();
#pragma unroll
  for (int sk = 1; sk <= LOG_P; ++sk) {
    const int k = 1 << sk;
    if (k <= K) {
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (!(r & (k >> 1))) order(v[r], v[r ^ (k - 1)]);
    } else {
      float o[K];
#pragma unroll
      for (int r = 0; r < K; ++r) o[r] = __shfl_xor_sync(0xffffffffu, v[r ^ (K - 1)], k / K - 1);
      const bool lower = !(lane & (k / (2 * K)));
#pragma unroll
      for (int r = 0; r < K; ++r) v[r] = lower ? fminf(v[r], o[r]) : fmaxf(v[r], o[r]);
    }
#pragma unroll
    for (int sj = LOG_P - 2; sj >= 0; --sj) {
      if (sj > sk - 2) continue;  // (a constant trip count, so the loop unrolls)
      const int j = 1 << sj;
      if (j < K) {
#pragma unroll
        for (int r = 0; r < K; ++r)
          if (!(r & j)) order(v[r], v[r | j]);
      } else {
        const bool lower = !(lane & (j / K));
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const float o = __shfl_xor_sync(0xffffffffu, v[r], j / K);
          v[r] = lower ? fminf(v[r], o) : fmaxf(v[r], o);
        }
      }
    }
  }
  float mid[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = m ? n >> 1 : (n - 1) >> 1;
    float mine = v[0];
#pragma unroll
    for (int r = 1; r < K; ++r)
      if (r == e % K) mine = v[r];
    mid[m] = __shfl_sync(0xffffffffu, mine, e / K);
  }
  return (mid[0] + mid[1]) * 0.5f;
}

// The same network run by the calling warp in place on `s` (shared
// memory) for series past 1,024 values (K 32): the pairs of each step
// spread over the lanes, the values past W taken as +inf (a pair whose
// upper index is past W leaves both in place).
__device__ float median_in_shared(float* s, int W, int first) {
  const int lane = threadIdx.x & 31;
  int valid = 0;
  for (int i = lane; i < W; i += 32) s[i] = sort_value(s, i, W, first, &valid);
  const int n = __reduce_add_sync(0xffffffffu, valid);
  if (n == 0) return nan_f();
  int P = 1;
  while (P < W) P <<= 1;
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int p = lane; p < P / 2; p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int q = j == (k >> 1) ? i ^ (k - 1) : i + j;
        if (q < W) order(s[i], s[q]);
      }
      __syncwarp();
    }
  }
  return (s[(n - 1) >> 1] + s[n >> 1]) * 0.5f;
}

// sort_k: the wrapper's `sort_k` (kernels/stream_step.py), 0 past K 32
__device__ float series_median(float* s, int W, int first, int sort_k) {
  switch (sort_k) {
    case 1: return median_in_registers<1>(s, W, first);
    case 2: return median_in_registers<2>(s, W, first);
    case 4: return median_in_registers<4>(s, W, first);
    case 8: return median_in_registers<8>(s, W, first);
    case 16: return median_in_registers<16>(s, W, first);
    case 32: return median_in_registers<32>(s, W, first);
    default: return median_in_shared(s, W, first);
  }
}

// The carried step's newest row (ring row H - 1, or h's row of window
// position W - 1) scored by the calling warp: the scaler steps, the dense
// stack (warp_dense_row), the tag scores into `raw` (and `tags_out`), and
// the row's total.  The same instructions as the tile loop's for the row.
template <typename T>
__device__ void score_newest_row(const StreamStepArgs& a, float* wbuf, const float* sdet, float* raw,
                                 float* xin, float* xout, float* y) {
  const int lane = threadIdx.x & 31;
  const int W = a.W;
  const int fo = a.chain.dims[a.chain.n_layers];
  const int f_in = a.chain.dims[0];
  const int row = a.mode_offset + W - 1;
  with_chain<T>(a.scalers, [&](auto apply) {
    for (int j = lane; j < f_in; j += 32)
      xin[j] = a.h ? __ldg(a.h + (size_t)(W - 1 - a.h_first) * f_in + j) : apply(j, ring_value<T>(a, row, j));
  });
  for (int j = lane; j < fo; j += 32) y[j] = ring_value<T>(a, row, j);
  const float* out = warp_dense_row<T>(a.chain, 0, wbuf, xin, xout);
  with_form(a.det.form[0], [&](auto form) {
    for (int j = lane; j < fo; j += 32) {
      const float t = tag_score(decltype(form)::value, out[j], y[j], sdet[j], sdet[fo + j]);
      raw[j * W + W - 1] = t;
      if (a.tags_out) a.tags_out[(size_t)(W - 1) * fo + j] = t;
    }
  });
  __syncwarp();
  if (lane == 0) raw[fo * W + W - 1] = tags_l2(raw + W - 1, W, fo, W - 1);
}

template <typename T>
__global__ void __launch_bounds__(DR_THREADS, 1) stream_step_kernel(const StreamStepArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_count;
  const int F = a.F;
  if (threadIdx.x == 0) s_count = a.count[0] + (a.x ? 1 : 0);
  if (a.x) {
    const T* src = static_cast<const T*>(a.ring_in);
    T* dst = static_cast<T*>(a.ring_out);
    for (int e = threadIdx.x; e < a.H * F; e += DR_THREADS)
      dst[e] = e < (a.H - 1) * F ? src[e + F] : static_cast<const T*>(a.x)[e - (a.H - 1) * F];
  }
  __syncthreads();
  if (a.x && threadIdx.x == 0) a.count[0] = s_count;
  if (!a.score) return;

  const int W = a.W;
  const int R = a.rows_per_tile;
  const int D = a.max_dim;
  const int fo = a.chain.dims[a.chain.n_layers];
  const int f_in = a.chain.dims[0];
  const int ns = fo + 1;  // series: the tags, then the total

  float* wbuf = smem;                   // weights, as fleet_score
  float* sdet = wbuf + a.wbuf_floats;   // detector stats a (fo), b (fo)
  float* raw = sdet + 2 * fo;           // ns x W raw scores, series-major
  float* yraw = raw + ns * W;           // R x fo targets
  float* bufa = yraw + R * fo;          // R x D activations
  float* bufb = bufa + R * D;           // R x D activations

  const T* ds = static_cast<const T*>(a.det.a[0]);
  const T* dof = static_cast<const T*>(a.det.b[0]);
  for (int j = threadIdx.x; j < fo; j += DR_THREADS) {
    sdet[j] = ld(ds + j);
    sdet[fo + j] = ld(dof + j);
  }
  if (a.tags_in) {
    // carried: the older rows' tag scores, one position older, and float
    // weights copied without waiting (cp.async: every copy in flight at
    // once, where loads into registers would wait a layer at a time);
    // then one warp scores the newest row while the others write the
    // older tags out and sum their totals at their new positions
    for (int e = threadIdx.x; e < (W - 1) * fo; e += DR_THREADS) {
      const int p = e / fo;
      copy_async(raw + (e - p * fo) * W + p, a.tags_in + fo + e);
    }
    if (a.chain.weights_resident) {
      if constexpr (std::is_same<T, float>::value) dense_copy_resident(a.chain, 0, wbuf);
      else dense_load_resident<T>(a.chain, 0, wbuf);
    }
    copy_async_commit();
    copy_async_wait<0>();
    __syncthreads();  // stats, resident weights and the older tags in shared memory
    if (threadIdx.x < 32) {
      score_newest_row<T>(a, wbuf, sdet, raw, bufa, bufb, yraw);
    } else {
      for (int p = threadIdx.x - 32; p < W - 1; p += DR_THREADS - 32)
        raw[fo * W + p] = tags_l2(raw + p, W, fo, p);
      if (a.tags_out) {
        for (int e = threadIdx.x - 32; e < (W - 1) * fo; e += DR_THREADS - 32) {
          const int p = e / fo;
          a.tags_out[e] = raw[(e - p * fo) * W + p];
        }
      }
    }
  } else {
    if (a.chain.weights_resident) dense_load_resident<T>(a.chain, 0, wbuf);
    // priming: every row, in tiles of R rows as fleet_score scores a tile
    for (int t0 = 0; t0 < W; t0 += R) {
      const int rows = min(R, W - t0);
      __syncthreads();  // the previous tile's readers of yraw and bufa are done
      with_chain<T>(a.scalers, [&](auto apply) {
        walk2d(R, f_in, [&](int r, int j) {
          float v = 0.f;
          if (r < rows) {
            if (a.h) {
              v = __ldg(a.h + (size_t)(t0 + r - a.h_first) * f_in + j);
            } else {
              v = ring_value<T>(a, a.mode_offset + t0 + r, j);
              v = apply(j, v);
            }
          }
          bufa[r * D + j] = v;
        });
      });
      walk2d(R, fo, [&](int r, int j) {
        yraw[r * fo + j] = r < rows ? ring_value<T>(a, a.mode_offset + t0 + r, j) : 0.f;
      });
      const float* in = dense_rows<T>(a.chain, 0, wbuf, bufa, bufb, R, D);
      __syncthreads();
      with_form(a.det.form[0], [&](auto form) {
        walk2d(rows, fo, [&](int r, int j) {
          const float t = tag_score(decltype(form)::value, in[r * D + j], yraw[r * fo + j], sdet[j], sdet[fo + j]);
          raw[j * W + t0 + r] = t;
          if (a.tags_out) a.tags_out[(size_t)(t0 + r) * fo + j] = t;
        });
      });
    }
    __syncthreads();
    for (int p = threadIdx.x; p < W; p += DR_THREADS) raw[fo * W + p] = tags_l2(raw + p, W, fo, p);
  }
  __syncthreads();

  // the masked nanmedian of each series over its W raw scores, a warp a series
  const int count = s_count;
  const int n_valid = min(max(count - a.mode_offset, 0), W);
  const int first = W - n_valid;  // older positions are warm-up: NaN
  for (int c = threadIdx.x >> 5; c < ns; c += DR_THREADS / 32) {
    const float med = series_median(raw + (size_t)c * W, W, first, a.sort_k);
    if ((threadIdx.x & 31) == 0) {
      a.verdict[c] = med;
      if (c == fo) {
        a.verdict[fo + 1] = a.agg_thr ? med / conf_divisor(__ldg(a.agg_thr)) : nan_f();
        a.verdict[fo + 2] = count > a.mode_offset ? 1.f : 0.f;
      }
    }
  }
}

extern "C" int stream_step_args_size() { return (int)sizeof(StreamStepArgs); }

extern "C" const char* stream_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <typename T>
static int launch(const StreamStepArgs* a, cudaStream_t stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  stream_step_kernel<T><<<1, DR_THREADS, a->smem_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

__global__ void stream_step_empty_kernel() {}

// An empty kernel on `stream`: the card's launch floor, against which a
// step's time is read (not a step: it is counted nowhere).
extern "C" int stream_step_empty_launch(void* stream) {
  stream_step_empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int stream_step_launch(const StreamStepArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return a->bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
