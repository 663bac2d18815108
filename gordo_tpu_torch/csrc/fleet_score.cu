// fleet_score: fused anomaly scoring of a bucket of feedforward detectors.
//
// Replaces the XLA programs `serve.fleet` / `serve.fleet_subset`
// (gordo_tpu/serve/fleet_scorer.py:51 `_fleet_score_core`, :120
// `_fleet_score_subset_core`) and the single-machine `serve.score`
// (gordo_tpu/serve/scorer.py:211 `_score_program_fn`) for the
// feedforward / MinMax chain, and the LSTM chain's head (below); a
// detector window is rolling_median's.  Per machine and row:
//
//   xs    = x * scale + offset                      (pipeline MinMax)
//   h     = act_l(h @ W_l + b_l)  for every layer   (dense stack)
//   tag   = |(h * ds + do) - (y * ds + do)|         (detector MinMax, y = x
//                                                    or given targets)
//   total = sqrt(sum_j tag_j^2)
//   conf  = total / max(threshold, 1e-12)
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

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"

#define FS_MAX_LAYERS 16
#define FS_THREADS 256
#define FS_RPT 4

// The LSTM detectors use it as their head and epilogue: x is the last LSTM
// layer's final-step state (m, windows, H), the one layer is the `out`
// Dense, there is no pipeline scaler, and y is the raw request rows from
// the model's offset on (y_n rows per slot, starting at row y_row0).
//
// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/fleet_score.py;
// fleet_score_args_size() lets the wrapper check the two agree.
struct FleetScoreArgs {
  const float* x;           // (m, n, f) raw rows of each dispatch slot
  const float* y;           // (m, y_n, f_out) targets from row y_row0, or null: y = x
  const int* idx;           // (m,) stacked machine of each slot, or null: slot
  const int* n_rows;        // (m,) valid rows of each slot, or null: n
  const float* scale;       // (M, f) pipeline MinMax, or null: none
  const float* offset;      // (M, f)
  const float* w[FS_MAX_LAYERS];  // (M, dims[l], dims[l+1])
  const float* b[FS_MAX_LAYERS];  // (M, dims[l+1])
  const float* det_scale;   // (M, f) detector MinMax, or null: prediction only
  const float* det_offset;  // (M, f)
  const float* agg_thr;     // (M,) aggregate thresholds, or null: no confidence
  float* pred;              // (m, n, f_out)
  float* tag;               // (m, n, f_out)  written when det_scale is set
  float* total;             // (m, n)         written when det_scale is set
  float* conf;              // (m, n)         written when agg_thr is set
  int m;
  int n;
  int f;
  int y_n;                  // rows per slot of y
  int y_row0;               // y row of output row 0
  int n_layers;
  int dims[FS_MAX_LAYERS + 1];
  int act[FS_MAX_LAYERS];
  int rows_per_block;       // R, a multiple of FS_RPT
  int max_dim;              // widest of dims[]
  int weights_resident;     // 1: all layers sit in shared memory at once
  int wbuf_floats;          // all layers' W and b if resident, else the largest layer's
  int smem_bytes;
};

// Calls body(q, c) for each pair of [0, nq) x [0, nc) that falls to this
// thread when the block's threads walk the pairs in row-major order (c
// fastest, so neighbouring threads touch neighbouring addresses).  The
// pair advances by FS_THREADS without a division per step.
template <typename Body>
__device__ __forceinline__ void walk2d(int nq, int nc, Body body) {
  int q = threadIdx.x / nc;
  int c = threadIdx.x - q * nc;
  const int dq = FS_THREADS / nc;
  const int dc = FS_THREADS - dq * nc;
  while (q < nq) {
    body(q, c);
    q += dq;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++q;
    }
  }
}

__global__ void __launch_bounds__(FS_THREADS)
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
  const int fo = a.dims[a.n_layers];
  const bool det = a.det_scale != nullptr;

  float* wbuf = smem;                  // weights: W then b, layer after layer
  float* sdet = wbuf + a.wbuf_floats;  // detector scale (fo), offset (fo)
  float* yraw = sdet + 2 * fo;         // R x fo raw targets (detector only)
  float* bufa = yraw + (det ? R * fo : 0);  // R x D activations
  float* bufb = bufa + R * D;              // R x D activations

  // device memory → shared: rows, stats, resident weights
  const size_t row_base = (size_t)slot * a.n + row0;
  const float* xt = a.x + row_base * F;
  const float* sc = a.scale ? a.scale + (size_t)mach * F : nullptr;
  const float* of = a.scale ? a.offset + (size_t)mach * F : nullptr;
  // without y, F == fo and the raw rows are the targets
  const bool y_is_x = det && !a.y;
  walk2d(R, F, [&](int r, int j) {
    float v = 0.f;
    float t = 0.f;
    if (r < rows) {
      v = __ldg(xt + r * F + j);
      t = v;
      if (sc) v = v * __ldg(sc + j) + __ldg(of + j);
    }
    bufa[r * D + j] = v;
    if (y_is_x) yraw[r * fo + j] = t;
  });
  if (det && a.y) {
    const float* yt = a.y + ((size_t)slot * a.y_n + a.y_row0 + row0) * fo;
    walk2d(R, fo, [&](int r, int j) {
      yraw[r * fo + j] = r < rows ? __ldg(yt + r * fo + j) : 0.f;
    });
  }
  if (det) {
    for (int j = threadIdx.x; j < fo; j += FS_THREADS) {
      sdet[j] = __ldg(a.det_scale + (size_t)mach * fo + j);
      sdet[fo + j] = __ldg(a.det_offset + (size_t)mach * fo + j);
    }
  }
  if (a.weights_resident) {
    int off = 0;
    for (int l = 0; l < a.n_layers; ++l) {
      const int nw = a.dims[l] * a.dims[l + 1];
      const int nb = a.dims[l + 1];
      const float* W = a.w[l] + (size_t)mach * nw;
      const float* B = a.b[l] + (size_t)mach * nb;
#pragma unroll 4
      for (int e = threadIdx.x; e < nw; e += FS_THREADS) wbuf[off + e] = __ldg(W + e);
      for (int e = threadIdx.x; e < nb; e += FS_THREADS) wbuf[off + nw + e] = __ldg(B + e);
      off += nw + nb;
    }
  }

  float* in = bufa;
  float* out = bufb;
  const int groups = R / FS_RPT;
  int woff = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l];
    const int dout = a.dims[l + 1];
    const int code = a.act[l];
    __syncthreads();  // `in` written; streamed: earlier readers of wbuf done
    if (!a.weights_resident) {
      const float* W = a.w[l] + (size_t)mach * din * dout;
      const float* B = a.b[l] + (size_t)mach * dout;
#pragma unroll 4
      for (int e = threadIdx.x; e < din * dout; e += FS_THREADS) wbuf[e] = __ldg(W + e);
      for (int e = threadIdx.x; e < dout; e += FS_THREADS) wbuf[din * dout + e] = __ldg(B + e);
      __syncthreads();
    }
    const float* wl = wbuf + woff;
    walk2d(groups, dout, [&](int g, int j) {
      const float* arow = in + g * FS_RPT * D;
      float acc[FS_RPT];
#pragma unroll
      for (int r = 0; r < FS_RPT; ++r) acc[r] = 0.f;
      for (int k = 0; k < din; ++k) {
        const float w = wl[k * dout + j];
#pragma unroll
        for (int r = 0; r < FS_RPT; ++r) acc[r] = fmaf(arow[r * D + k], w, acc[r]);
      }
      const float bj = wl[din * dout + j];
      float* orow = out + g * FS_RPT * D;
#pragma unroll
      for (int r = 0; r < FS_RPT; ++r) orow[r * D + j] = act_fn(code, acc[r] + bj);
    });
    if (a.weights_resident) woff += din * dout + dout;
    float* t = in;
    in = out;
    out = t;
  }
  __syncthreads();

  // epilogue from shared memory, elementwise over every lane; `in` holds
  // the predictions, and each y element, once read, holds its tag's square
  walk2d(rows, fo, [&](int r, int j) {
    const float p = in[r * D + j];
    const size_t o = (row_base + r) * fo + j;
    a.pred[o] = p;
    if (det) {
      const float s = sdet[j];
      const float c = sdet[fo + j];
      const float t = fabsf((p * s + c) - (yraw[r * fo + j] * s + c));
      a.tag[o] = t;
      yraw[r * fo + j] = t * t;
    }
  });
  if (det) {
    __syncthreads();
    // the L2 norm over tags: one thread per row
    for (int r = threadIdx.x; r < rows; r += FS_THREADS) {
      // each row starts at another tag, so neighbouring rows read
      // different banks
      float sq = 0.f;
      int j = r % fo;
      for (int n = 0; n < fo; ++n) {
        sq += yraw[r * fo + j];
        if (++j == fo) j = 0;
      }
      const float total = sqrtf(sq);
      a.total[row_base + r] = total;
      if (a.agg_thr) a.conf[row_base + r] = total / fmaxf(__ldg(a.agg_thr + mach), 1e-12f);
    }
  }
}

extern "C" int fleet_score_args_size() { return (int)sizeof(FleetScoreArgs); }

extern "C" const char* fleet_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fleet_score_launch(const FleetScoreArgs* a, void* stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fleet_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a->n + a->rows_per_block - 1) / a->rows_per_block, a->m);
  fleet_score_kernel<<<grid, FS_THREADS, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
