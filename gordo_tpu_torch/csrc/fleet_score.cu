// fleet_score: fused anomaly scoring of a bucket of feedforward detectors.
//
// Replaces the XLA programs `serve.fleet` / `serve.fleet_subset`
// (gordo_tpu/serve/fleet_scorer.py:51 `_fleet_score_core`, :120
// `_fleet_score_subset_core`) and the single-machine `serve.score`
// (gordo_tpu/serve/scorer.py:211 `_score_program_fn`) for the
// feedforward / MinMax chain, and the LSTM chain's head (below); a
// detector window is rolling_median's.  Per machine and row:
//
//   xs    = chain(x)                                (the pipeline's scaler steps)
//   h     = act_l(h @ W_l + b_l)  for every layer   (dense stack)
//   tag   = |d(h) - d(y)|                           (d the detector scaler's step,
//                                                    y = x or given targets)
//   total = sqrt(sum_j tag_j^2)
//   conf  = total / max(threshold, 1e-12)
//
// With no layers it is the epilogue alone (`anomaly.scores`,
// gordo_tpu/anomaly/diff.py:41-48, on a prediction already computed): x is
// the prediction, which is not written again, and y the raw request rows
// from the model's offset on.  A TransformedTargetRegressor or a
// MultiOutputRegressor serves so: its model output comes from the model
// launch (a MultiOutputRegressor's columns as the machines of one stack)
// and the target's inverse, then this launch scores it.  At 512 x 2048 x
// 10 it moves ~134 MB (x and y read, tag, total and confidence written),
// ~0.040 ms at 3.35 TB/s.
//
// Bound: the H100's fp32 ridge is ~20 FLOP per byte (67 TFLOP/s over
// 3.35 TB/s).  At the default model's width (10 tags, 367 weights) a row
// costs 2*367 FLOP against 40 bytes in and 88 bytes out, ~5.7 FLOP/byte,
// so the kernel is bound by device memory.  At 128 tags (60,558 weights)
// a row costs ~121 kFLOP against ~1.5 kB, ~78 FLOP/byte: bound by fp32
// arithmetic.
//
// Design: one block per (dispatch slot, tile of R rows).  The block's
// first pass loads what it needs from device memory into shared memory:
// the tile's rows (pipeline-scaled into one activation buffer, raw into
// another for the detector's y), the detector stats, and, when they fit
// (the default model's 367 weights do), all layers' weights.  Wider models (the
// 128-tag hourglass has 242 KB of weights, over a block's 227 KB) stream
// their layers through shared memory one at a time.  Activations
// ping-pong between two shared buffers, so no intermediate layer touches
// device memory.  Each thread computes RPT rows of one output column,
// reusing each weight RPT times.  The epilogue runs elementwise over all
// lanes from shared memory with coalesced stores, then one thread per row
// sums the squared tags.  Device memory sees each input read once and
// each output written once.
//
// At the default width a block's life is mostly waiting on short chains
// of dependent shared-memory loads and FMAs (din <= 10 per output): on an
// H100 the kernel's time scaled with the number of blocks, not with the
// activations or the epilogue.  So the row tile is as large as shared
// memory allows (256 rows at 10 tags), work is handed out by walk2d (no
// division per item), and no lane idles in the epilogue.  Issuing the
// global reads as cp.async instead of loads made no difference there.
//
// Reduced-precision serving (K10, gordo_tpu/serve/precision.py): the rows,
// weights, biases and the scaler steps' and detector's stats may be stored in
// bf16; the kernel widens each value to f32 as it loads it, and computes,
// keeps in shared memory and writes f32, as at f32 (the thresholds stay
// f32).  Template parameters: TX, the type of x (float for an LSTM head,
// whose input is lstm_layer's f32 state), and T, that of everything else
// stored.  At bf16 the bytes in halve and the bound falls with them.  The
// dense stack and the epilogue's arithmetic are dense_rows.cuh's, shared
// with stream_step.cu.

#include <cuda_runtime.h>
#include <math.h>

#include "dense_rows.cuh"

// The LSTM detectors use it as their head and epilogue: x is the last LSTM
// layer's final-step state (m, windows, H), the one layer is the `out`
// Dense, there is no pipeline scaler, and y is the raw request rows from
// the model's offset on (y_n rows per slot, starting at row y_row0).
//
// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/fleet_score.py;
// fleet_score_args_size() lets the wrapper check the two agree.
struct FleetScoreArgs {
  const void* x;            // (m, n, f) rows of each dispatch slot, TX
  const void* y;            // (m, y_n, f_out) targets from row y_row0, T, or null: y = x
  const int* idx;           // (m,) stacked machine of each slot, or null: slot
  const int* n_rows;        // (m,) valid rows of each slot, or null: n
  ScalerPrefix scalers;     // the pipeline's scaler steps, stats (M, f) T; n 0: none
  DenseChain chain;         // the dense stack, T
  ScalerPrefix det;         // the detector scaler, one step, stats (M, f_out) T; n 0: prediction only
  const float* agg_thr;     // (M,) aggregate thresholds, or null: no confidence
  float* pred;              // (m, n, f_out), or null: not written
  float* tag;               // (m, n, f_out)  written with the detector scaler
  float* total;             // (m, n)         written with the detector scaler
  float* conf;              // (m, n)         written when agg_thr is set
  int m;
  int n;
  int f;
  int y_n;                  // rows per slot of y
  int y_row0;               // y row of output row 0
  int rows_per_block;       // R, a multiple of DR_RPT
  int max_dim;              // widest of dims[]
  int wbuf_floats;          // all layers' W and b if resident, else the largest layer's
  int smem_bytes;
  int x_bf16;               // TX is __nv_bfloat16
  int bf16;                 // T is __nv_bfloat16
};

template <typename TX, typename T>
__global__ void __launch_bounds__(DR_THREADS)
fleet_score_kernel(const FleetScoreArgs a) {
  extern __shared__ float smem[];
  const int slot = blockIdx.y;
  const int mach = a.idx ? a.idx[slot] : slot;
  const int R = a.rows_per_block;
  const int row0 = blockIdx.x * R;
  const int n_valid = a.n_rows ? a.n_rows[slot] : a.n;
  if (row0 >= n_valid) return;  // uniform over the block
  const int rows = min(R, n_valid - row0);
  const int F = a.f;
  const int D = a.max_dim;
  const int fo = a.chain.dims[a.chain.n_layers];
  const bool det = a.det.n > 0;

  float* wbuf = smem;                  // weights: W then b, layer after layer
  float* sdet = wbuf + a.wbuf_floats;  // detector stats a (fo), b (fo)
  float* yraw = sdet + 2 * fo;         // R x fo raw targets (detector only)
  float* bufa = yraw + (det ? R * fo : 0);  // R x D activations
  float* bufb = bufa + R * D;              // R x D activations

  // device memory → shared: rows, stats, resident weights
  const size_t row_base = (size_t)slot * a.n + row0;
  const TX* xt = static_cast<const TX*>(a.x) + row_base * F;
  const size_t at = (size_t)mach * F;  // the machine's scaler stats
  // without y, F == fo and the raw rows are the targets
  const bool y_is_x = det && !a.y;
  with_chain<T>(a.scalers, [&](auto apply) {
    walk2d(R, F, [&](int r, int j) {
      float v = 0.f;
      float t = 0.f;
      if (r < rows) {
        v = ld(xt + r * F + j);
        t = v;
        v = apply(at + j, v);
      }
      bufa[r * D + j] = v;
      if (y_is_x) yraw[r * fo + j] = t;
    });
  });
  if (det && a.y) {
    const T* yt = static_cast<const T*>(a.y) + ((size_t)slot * a.y_n + a.y_row0 + row0) * fo;
    walk2d(R, fo, [&](int r, int j) {
      yraw[r * fo + j] = r < rows ? ld(yt + r * fo + j) : 0.f;
    });
  }
  if (det) {
    const T* ds = static_cast<const T*>(a.det.a[0]) + (size_t)mach * fo;
    const T* dof = static_cast<const T*>(a.det.b[0]) + (size_t)mach * fo;
    for (int j = threadIdx.x; j < fo; j += DR_THREADS) {
      sdet[j] = ld(ds + j);
      sdet[fo + j] = ld(dof + j);
    }
  }
  if (a.chain.weights_resident) dense_load_resident<T>(a.chain, mach, wbuf);

  const float* in = dense_rows<T>(a.chain, mach, wbuf, bufa, bufb, R, D);
  __syncthreads();

  // epilogue from shared memory, elementwise over every lane; `in` holds
  // the predictions, and each y element, once read, holds its tag's square
  with_form(det ? a.det.form[0] : SP_AFFINE, [&](auto form) {
    walk2d(rows, fo, [&](int r, int j) {
      const float p = in[r * D + j];
      const size_t o = (row_base + r) * fo + j;
      if (a.pred) a.pred[o] = p;
      if (det) {
        const float t = tag_score(decltype(form)::value, p, yraw[r * fo + j], sdet[j], sdet[fo + j]);
        a.tag[o] = t;
        yraw[r * fo + j] = t * t;
      }
    });
  });
  if (det) {
    __syncthreads();
    // the L2 norm over tags: one thread per row
    for (int r = threadIdx.x; r < rows; r += DR_THREADS) {
      const float total = row_l2(yraw + r * fo, fo, row0 + r);
      a.total[row_base + r] = total;
      if (a.agg_thr) a.conf[row_base + r] = total / conf_divisor(__ldg(a.agg_thr + mach));
    }
  }
}

extern "C" int fleet_score_args_size() { return (int)sizeof(FleetScoreArgs); }

extern "C" const char* fleet_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <typename TX, typename T>
static int launch(const FleetScoreArgs* a, cudaStream_t stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fleet_score_kernel<TX, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a->n + a->rows_per_block - 1) / a->rows_per_block, a->m);
  fleet_score_kernel<TX, T><<<grid, DR_THREADS, a->smem_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Instantiations: f32 throughout; bf16 storage; f32 x (an LSTM head's
// state) over bf16 storage.
extern "C" int fleet_score_launch(const FleetScoreArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!a->bf16) return launch<float, float>(a, s);
  if (a->x_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return launch<float, __nv_bfloat16>(a, s);
}
