// stream_step: one arriving row of one machine's stream, scored (K9).
//
// Replaces the XLA program `serve.stream_step` (gordo_tpu/serve/stream.py:175
// `_stream_step_fn`, registered :275).  The carried state is a raw-input
// ring (H = offset + W rows, newest last; W = max(detector window, 1)) and
// the count of rows ever ingested.  Per arriving row x:
//
//   ring'  = ring[1:] ++ [x];  count' = count + 1       (into the other half
//                                                       of a double buffer)
//   the W newest rows (or, for an LSTM, lstm_layer's state of the ring's W
//   windows) through the dense stack, scored against the raw ring rows
//   from `offset` on:  tag = |d(p) - d(y)|,  total = L2(tag)  (d the detector scaler's step)
//   n_valid = clip(count' - offset, 0, W): the newest n_valid raw scores
//   are real, the older ones masked to NaN
//   verdict = nanmedian over the W (masked) raw scores of each tag and of
//   the total;  valid = count' > offset;  conf = total / max(thr, 1e-12)
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
// ring, the scoring with the LSTM's `out` head as the dense stack and the
// layers' last state as its input (`h`).
//
// A fused transform chain (SimpleImputer, PCA and the scalers; the JAX
// package's `Xc = chain(ring)`, gordo_tpu/serve/stream.py:227-228) takes
// three launches as well: the ring shift alone, then chain_apply over the
// shifted ring's H rows, then the scoring with the chain's output as `h`
// and the raw ring rows as targets.  The chain is not a prefix inside this
// kernel: chain_apply is the kernel the request path runs, so the stream's
// chain outputs, and with them its verdicts, are the request path's bit for
// bit; a copy of the chain's forms here would be a second implementation to
// hold to it.  The price is two more launches and the chain over all H rows
// a step where one new row would do (ROADMAP and PERF.md keep a one-launch
// prefix as an open item).
//
// Bound: a step moves the ring (2 H F values), the chain's weights and
// stats, and writes a few dozen floats; a few microseconds of bytes at
// most, so a step is bound by its launch and its single block's latency.
//
// Design: one block.  The ring is copied shifted by all threads; the W
// rows are scored in tiles of R rows as fleet_score scores a tile, into a
// W x (fo + 1) buffer of raw scores in shared memory; the median of each
// series takes each value's rank among the series' valid non-NaN values
// (ties by position) in parallel over (series, value) pairs, and the two
// values of middle rank give it.  Storage types as fleet_score's (T: f32
// or bf16 for the ring, weights and stats; `h` is f32).

#include <cuda_runtime.h>
#include <math.h>

#include "dense_rows.cuh"

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/stream_step.py;
// stream_step_args_size() lets the wrapper check the two agree.
struct StreamStepArgs {
  const void* ring_in;      // (H, F) T
  const void* x;            // (F,) T: the arriving row, or null: ring_in is already shifted
  void* ring_out;           // (H, F) T: ring_in shifted with x last (when x is set)
  int* count;               // (1,) rows ingested; + 1 when x is set
  const float* h;           // (W, f_in) an LSTM's last-layer state, or null: the ring's W newest rows
  ScalerPrefix scalers;     // the pipeline's scaler steps, stats (F,) T (ring rows only; n 0: none)
  DenseChain chain;         // the dense stack (an LSTM's `out` head), T
  ScalerPrefix det;         // the detector scaler, one step, stats (fo,) T
  const float* agg_thr;     // (1,) aggregate threshold, or null: no confidence
  float* verdict;           // (fo + 3,): tag scores, total, confidence, valid (0 / 1)
  int H;
  int F;
  int W;
  int mode_offset;          // ring rows before the first scored row's target
  int score;                // 0: shift the ring only
  int rows_per_tile;        // R, a multiple of DR_RPT
  int max_dim;
  int wbuf_floats;
  int smem_bytes;
  int bf16;                 // T is __nv_bfloat16
};

template <typename T>
__device__ __forceinline__ float ring_value(const StreamStepArgs& a, int row, int j) {
  // row `row` of the ring after this step's shift
  const T* ring = static_cast<const T*>(a.ring_in);
  if (!a.x) return ld(ring + (size_t)row * a.F + j);
  return row == a.H - 1 ? ld(static_cast<const T*>(a.x) + j) : ld(ring + (size_t)(row + 1) * a.F + j);
}

template <typename T>
__global__ void __launch_bounds__(DR_THREADS) stream_step_kernel(const StreamStepArgs a) {
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
  float* raw = sdet + 2 * fo;           // W x ns raw scores
  float* yraw = raw + W * ns;           // R x fo targets, then squared tags
  float* bufa = yraw + R * fo;          // R x D activations
  float* bufb = bufa + R * D;           // R x D activations
  float* lo = bufb + R * D;             // ns: the lower middle value of each series
  float* hi = lo + ns;                  // ns: the upper one
  int* cnt = reinterpret_cast<int*>(hi + ns);  // ns: valid non-NaN values

  const T* ds = static_cast<const T*>(a.det.a[0]);
  const T* dof = static_cast<const T*>(a.det.b[0]);
  for (int j = threadIdx.x; j < fo; j += DR_THREADS) {
    sdet[j] = ld(ds + j);
    sdet[fo + j] = ld(dof + j);
  }
  if (a.chain.weights_resident) dense_load_resident<T>(a.chain, 0, wbuf);

  for (int t0 = 0; t0 < W; t0 += R) {
    const int rows = min(R, W - t0);
    __syncthreads();  // the previous tile's readers of yraw and bufa are done
    with_chain<T>(a.scalers, [&](auto apply) {
      walk2d(R, f_in, [&](int r, int j) {
        float v = 0.f;
        if (r < rows) {
          if (a.h) {
            v = __ldg(a.h + (size_t)(t0 + r) * f_in + j);
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
        raw[(t0 + r) * ns + j] = t;
        yraw[r * fo + j] = t * t;
      });
    });
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += DR_THREADS)
      raw[(t0 + r) * ns + fo] = row_l2(yraw + r * fo, fo, t0 + r);
  }
  __syncthreads();

  // the masked nanmedian of each series over its W raw scores
  const int count = s_count;
  const int n_valid = min(max(count - a.mode_offset, 0), W);
  const int first = W - n_valid;  // older positions are warm-up: NaN
  for (int c = threadIdx.x; c < ns; c += DR_THREADS) {
    int k = 0;
    for (int i = first; i < W; ++i) k += !isnan(raw[i * ns + c]);
    cnt[c] = k;
    lo[c] = hi[c] = __int_as_float(0x7fc00000);
  }
  __syncthreads();
  walk2d(ns, W, [&](int c, int i) {
    const float v = raw[i * ns + c];
    if (i < first || isnan(v)) return;
    int rank = 0;
    for (int k = first; k < W; ++k) {
      const float u = raw[k * ns + c];
      rank += (u < v) || (u == v && k < i);  // NaN compares false
    }
    const int n = cnt[c];
    if (rank == ((n - 1) >> 1)) lo[c] = v;
    if (rank == (n >> 1)) hi[c] = v;
  });
  __syncthreads();
  for (int c = threadIdx.x; c < ns; c += DR_THREADS) {
    const float med = cnt[c] > 0 ? (lo[c] + hi[c]) * 0.5f : __int_as_float(0x7fc00000);
    a.verdict[c] = med;
    if (c == fo) {
      a.verdict[fo + 1] = a.agg_thr ? med / conf_divisor(__ldg(a.agg_thr)) : __int_as_float(0x7fc00000);
      a.verdict[fo + 2] = count > a.mode_offset ? 1.f : 0.f;
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

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int stream_step_launch(const StreamStepArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return a->bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
