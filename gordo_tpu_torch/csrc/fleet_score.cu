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
// Design: two paths, which the wrapper's launch plan picks by width; each
// output keeps the FMA chain of dense_rows.cuh (acc = fmaf(in[k], W[k][j],
// acc) for k ascending from 0, then act(acc + b[j])), tag_score and
// row_l2's sum from tag `row % fo` in rotation, so either path's outputs
// are those of stream_step's dense_rows and warp_dense_row bit for bit.
//
// The row path (every width <= FS_NARROW_MAX: the default 10-8-7-5-5-7-8-10
// hourglass, chain C's 8-in model, the epilogue alone at 10 tags).  A
// block copies its machine's weights once into shared memory, each
// layer's W rows padded to a multiple of four columns, with the detector's
// and scaler steps' stats (its first tile's rows in flight meanwhile),
// then walks a run of its slot's tiles of R rows,
// FS_ROW_RPT rows a thread where the grid fills the SMs and there are
// layers, else one (more blocks for a short request, less serial work a
// thread for the epilogue alone): the next tile's raw rows (and targets) load by
// 16-byte cp.async copies into the other of two buffers while this one's
// are scored.  A thread widens its rows into its own rows of shared
// memory, takes them through the scaler steps and every layer (the
// layer's outputs in registers, per term one float4 of weights, a
// broadcast, feeding each of its rows; the loop over a layer's inputs at run
// time, over its outputs unrolled in fours, so that no FMA past the
// padding is issued), and scores its tags and totals there.  Tag scores
// are staged in shared memory and leave in 16-byte stores, predictions
// in coalesced ones from the rows, so no thread writes a 4-byte value at
// a 40-byte stride.  The parent design ran each layer as a block-wide pass
// over shared memory with a barrier before it, an FMA waiting on its
// shared loads: at 512 x 2048 x 10 it ran at 19% of its byte bound.  This
// one is bound by its instructions (tanhf and the 367 FMAs a row among
// them: PERF.md).
//
// The tile path (wider models: the 128-tag hourglass, whose 242 KB of
// weights stream through shared memory a layer at a time, and the LSTM
// head, 42 -> 50).  A block of FS_TILE_THREADS takes R rows (a multiple of
// FS_RT, at most 64, two blocks an SM where shared memory allows; a grid
// short of SMs spreads its rows over every SM, one block each), loaded
// by cp.async (bf16 eight loads in flight a thread); activations
// ping-pong between two shared buffers, and each thread computes a
// register tile of FS_RT rows by FS_CT columns: per term one float4 of
// weights (neighbouring threads, neighbouring columns) and FS_RT
// activations (a warp's broadcasts) feed FS_RT x FS_CT FMAs, where the
// parent's 4-rows-by-1-column item spent 1.25 shared loads an FMA and
// loaded each value before storing it (a memory latency a value).  The
// epilogue runs elementwise over all lanes with coalesced stores, then one
// thread per row sums the squared tags.  Device memory sees each input
// read once and each output written once.
//
// Reduced-precision serving (K10, gordo_tpu/serve/precision.py): the rows,
// weights, biases and the scaler steps' and detector's stats may be stored in
// bf16; the kernel widens each value to f32 as it loads it, and computes,
// keeps in shared memory and writes f32, as at f32 (the thresholds stay
// f32).  Template parameters: TX, the type of x (float for an LSTM head,
// whose input is lstm_layer's f32 state), and T, that of everything else
// stored.  At bf16 the bytes in halve and the bound falls with them.  The
// activations and the epilogue's arithmetic are dense_rows.cuh's, shared
// with stream_step.cu.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "dense_rows.cuh"
#include "spans.cuh"

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
  int rows_per_block;       // R: the row path's threads, the tile path's rows (a multiple of FS_RT)
  int max_dim;              // widest of dims[]
  int wbuf_floats;          // all layers' padded W and b if resident, else the largest layer's
  int smem_bytes;
  int x_bf16;               // TX is __nv_bfloat16
  int bf16;                 // T is __nv_bfloat16
  int path;                 // FS_PATH_TILE or FS_PATH_ROWS
  int blocks_per_slot;      // grid columns: the tile path's tiles; the row path's blocks, each a run of tiles
  int row_rpt;              // the row path's rows a thread: 1, or FS_ROW_RPT
};

#define FS_PATH_TILE 0
#define FS_PATH_ROWS 1
#define FS_NARROW_MAX 16   // the row path's widest layer
#ifndef FS_ROW_THREADS
#define FS_ROW_THREADS 256 // the row path's largest block (a row a thread)
#endif
#ifndef FS_TILE_THREADS
#define FS_TILE_THREADS 256
#endif
#define FS_ROW_STRIDE 17   // a row's floats in the row path's shared memory: odd, so a warp's rows take 32 banks
#define FS_ROW_RPT 2       // the row path's most rows a thread
#define FS_RT 4            // rows of a tile-path thread's register tile
#define FS_CT 4            // its columns (one float4 of weights)

// layer l of machine `mach` into `wl`: W as din rows of pad4(dout) floats,
// then b as one more, zeros past dout, so that four columns are one float4
// (floats by cp.async: the caller commits and waits before its barrier)
template <typename T>
__device__ __forceinline__ void load_layer_padded(const DenseChain& ch, int l, int mach, float* wl, int tid,
                                                  int nt) {
  const int din = ch.dims[l];
  const int dout = ch.dims[l + 1];
  const T* W = static_cast<const T*>(ch.w[l]) + (size_t)mach * din * dout;
  const T* B = static_cast<const T*>(ch.b[l]) + (size_t)mach * dout;
  const int dp = pad4(dout);
  auto src = [&](int k, int j) { return k < din ? W + k * dout + j : B + j; };
  if constexpr (std::is_same<T, float>::value) {
    walk_nt(din + 1, dp, tid, nt, [&](int k, int j) {
      float* d = wl + k * dp + j;
      if (j >= dout) *d = 0.f;
      else copy_async(d, src(k, j));
    });
  } else {
    walk_batched<8>(
        din + 1, dp, tid, nt, [&](int k, int j) { return j < dout ? ld(src(k, j)) : 0.f; },
        [&](int k, int j, float v) { wl[k * dp + j] = v; });
  }
}

__device__ __forceinline__ int padded_layer_floats(const DenseChain& ch, int l) {
  return (ch.dims[l] + 1) * pad4(ch.dims[l + 1]);
}

// body(act), act(x) the activation of `code`: tanh and linear (the default
// model's) compiled apart from the others' switch
template <typename Body>
__device__ __forceinline__ void with_act(int code, Body body) {
  if (code == ACT_TANH) body([](float v) { return act_fn(ACT_TANH, v); });
  else if (code == ACT_LINEAR) body([](float v) { return v; });
  else body([code](float v) { return act_fn(code, v); });
}

// RPT rows' layer: each h[u] [0, din) -> [0, dout), each row's activations
// in shared memory (the thread's own rows), the layer's outputs in
// registers, four columns of padded weights `wl` (load_layer_padded) a
// float4 broadcast that feeds every row; DQ = pad4(dout) / 4, so that no
// FMA past the padding is issued
template <int DQ, int RPT, typename Act>
__device__ __forceinline__ void row_layer(float* const (&h)[RPT], const float* wl, int din, int dout, Act act) {
  constexpr int dp = 4 * DQ;
  float o[RPT][dp];
#pragma unroll
  for (int u = 0; u < RPT; ++u)
#pragma unroll
    for (int j = 0; j < dp; ++j) o[u][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < din; ++k) {
    float a[RPT];
#pragma unroll
    for (int u = 0; u < RPT; ++u) a[u] = h[u][k];
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(wl + k * dp + 4 * q);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < RPT; ++u) o[u][4 * q + i] = fmaf(a[u], wv[i], o[u][4 * q + i]);
    }
  }
  const float* bl = wl + din * dp;
#pragma unroll
  for (int j = 0; j < dp; ++j) {
    if (j < dout) {
      const float bj = bl[j];
#pragma unroll
      for (int u = 0; u < RPT; ++u) h[u][j] = act(o[u][j] + bj);
    }
  }
}

template <int RPT, typename Act>
__device__ __forceinline__ void row_layer_any(float* const (&h)[RPT], const float* wl, int din, int dout, Act act) {
  switch ((dout + 3) >> 2) {
    case 1: row_layer<1>(h, wl, din, dout, act); break;
    case 2: row_layer<2>(h, wl, din, dout, act); break;
    case 3: row_layer<3>(h, wl, din, dout, act); break;
    default: row_layer<4>(h, wl, din, dout, act); break;
  }
}

template <typename TX, typename T, int RPT>
__global__ void __launch_bounds__(FS_ROW_THREADS) fleet_score_rows_kernel(const __grid_constant__ FleetScoreArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int R = a.rows_per_block;  // RPT rows a thread
  const int n_valid = a.n_rows ? a.n_rows[slot] : a.n;
  const int tiles = (n_valid + R - 1) / R;
  if ((int)blockIdx.x >= tiles) return;  // uniform over the block
  const int mach = a.idx ? a.idx[slot] : slot;
  const int F = a.f;
  const int fo = a.chain.dims[a.chain.n_layers];
  const bool det = a.det.n > 0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  constexpr int S = FS_ROW_STRIDE;

  float* wbuf = smem;                                  // every layer, padded
  float* sdet = wbuf + a.wbuf_floats;                  // detector stats a, b
  float* sst = sdet + 2 * FS_NARROW_MAX;               // the scaler steps' stats a, b, step after step
  float* hs = sst + 2 * FS_NARROW_MAX * SP_MAX_STEPS;  // R rows of S: each row's activations
  float* ts = hs + R * S;                              // R x fo tag scores (detector)
  // two buffers of a tile's raw rows (TX) and targets (T), 16-byte aligned
  char* raw = reinterpret_cast<char*>(ts + (det ? pad4(R * fo) : 0));
  const int x_bytes = (R * F * (int)sizeof(TX) + 15) & ~15;
  const int y_bytes = a.y ? (R * fo * (int)sizeof(T) + 15) & ~15 : 0;

  // tile t's raw rows (and targets) into buffer `buf`, in flight until the
  // next wait
  auto fetch = [&](int t, int buf) {
    const int row0 = t * R;
    const int rows = min(R, n_valid - row0);
    char* rb = raw + buf * (x_bytes + y_bytes);
    copy_raw(rb, static_cast<const TX*>(a.x) + ((size_t)slot * a.n + row0) * F, rows * F * (int)sizeof(TX), tid, nt);
    if (a.y)
      copy_raw(rb + x_bytes, static_cast<const T*>(a.y) + ((size_t)slot * a.y_n + a.y_row0 + row0) * fo,
               rows * fo * (int)sizeof(T), tid, nt);
    copy_async_commit();
  };
  // the first tile's rows in flight while the weights and stats load
  fetch(blockIdx.x, 0);
  for (int l = 0, off = 0; l < a.chain.n_layers; off += padded_layer_floats(a.chain, l), ++l)
    load_layer_padded<T>(a.chain, l, mach, wbuf + off, tid, nt);
  copy_async_commit();
  if (det) {
    const T* ds = static_cast<const T*>(a.det.a[0]) + (size_t)mach * fo;
    const T* dof = static_cast<const T*>(a.det.b[0]) + (size_t)mach * fo;
    for (int j = tid; j < fo; j += nt) {
      sdet[j] = ld(ds + j);
      sdet[FS_NARROW_MAX + j] = ld(dof + j);
    }
  }
  walk_nt(a.scalers.n, F, tid, nt, [&](int i, int c) {
    sst[2 * FS_NARROW_MAX * i + c] = ld(static_cast<const T*>(a.scalers.a[i]) + (size_t)mach * F + c);
    sst[2 * FS_NARROW_MAX * i + FS_NARROW_MAX + c] = ld(static_cast<const T*>(a.scalers.b[i]) + (size_t)mach * F + c);
  });

  // each block walks its slot's tiles blockIdx.x, + gridDim.x, ...; the
  // next tile's rows load while this one's are scored
  for (int t = blockIdx.x, buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    copy_async_wait<0>();
    __syncthreads();  // this tile's rows in; the last tile's stores done
    if (t + (int)gridDim.x < tiles) fetch(t + gridDim.x, buf ^ 1);
    const int row0 = t * R;
    const int rows = min(R, n_valid - row0);
    const size_t row_base = (size_t)slot * a.n + row0;
    const TX* xraw = reinterpret_cast<const TX*>(raw + buf * (x_bytes + y_bytes));
    const T* yraw = reinterpret_cast<const T*>(raw + buf * (x_bytes + y_bytes) + x_bytes);
    // the thread's rows tid, tid + nt, ... (those past the tile's rows are
    // computed on stale values and never stored)
    if (tid < rows) {
      float* h[RPT];
#pragma unroll
      for (int u = 0; u < RPT; ++u) h[u] = hs + (tid + u * nt) * S;
      for (int c = 0; c < F; ++c)
#pragma unroll
        for (int u = 0; u < RPT; ++u) h[u][c] = widen(xraw[(tid + u * nt) * F + c]);
      // the scaler steps in turn (with_chain's arithmetic), their stats
      // from shared memory
      for (int i = 0; i < a.scalers.n; ++i) {
        const float* sa = sst + 2 * FS_NARROW_MAX * i;
        with_form(a.scalers.form[i], [&](auto form) {
          for (int c = 0; c < F; ++c)
#pragma unroll
            for (int u = 0; u < RPT; ++u)
              h[u][c] = step_apply(decltype(form)::value, h[u][c], sa[c], sa[FS_NARROW_MAX + c]);
        });
      }
      for (int l = 0, off = 0; l < a.chain.n_layers; off += padded_layer_floats(a.chain, l), ++l)
        with_act(a.chain.act[l],
                 [&](auto act) { row_layer_any<RPT>(h, wbuf + off, a.chain.dims[l], a.chain.dims[l + 1], act); });
      if (det) {
        with_form(a.det.form[0], [&](auto form) {
          // without y, F == fo and the raw rows are the targets; the tags
          // in row_l2's rotation, from tag (row0 + r) % fo, each square
          // rounded before it is added (tags_l2)
          for (int r = tid; r < rows; r += nt) {
            const float* h = hs + r * S;
            float s = 0.f;
            int j = (row0 + r) % fo;
            for (int n = 0; n < fo; ++n) {
              const float y = a.y ? widen(yraw[r * fo + j]) : widen(xraw[r * F + j]);
              const float tg = tag_score(decltype(form)::value, h[j], y, sdet[j], sdet[FS_NARROW_MAX + j]);
              ts[r * fo + j] = tg;
              s = __fadd_rn(s, __fmul_rn(tg, tg));
              if (++j == fo) j = 0;
            }
            const float total = sqrtf(s);
            a.total[row_base + r] = total;
            if (a.agg_thr) a.conf[row_base + r] = total / conf_divisor(__ldg(a.agg_thr + mach));
          }
        });
      }
    }
    __syncthreads();
    if (a.pred) walk_nt(rows, fo, tid, nt, [&](int r, int j) { a.pred[(row_base + r) * fo + j] = hs[r * S + j]; });
    if (det) store_span(a.tag + row_base * fo, ts, rows * fo, tid, nt);
  }
}

// The dense stack of machine `mach` over the R rows (a multiple of FS_RT)
// of `in` (row stride D) in register tiles; activations ping-pong between
// `in` and `out`.  Starts with a barrier, so the caller's writes to `in`
// (and, resident, to wbuf) need none of their own; returns the buffer
// holding the last layer's output, which the caller reads after a
// barrier.  A streamed chain loads each layer into wbuf in turn.
template <typename T>
__device__ __forceinline__ float* dense_tile(const DenseChain& ch, int mach, float* wbuf, float* in, float* out,
                                             int R, int D) {
  const int tid = threadIdx.x;
  int woff = 0;
  for (int l = 0; l < ch.n_layers; ++l) {
    const int din = ch.dims[l];
    const int dout = ch.dims[l + 1];
    const int dp = pad4(dout);
    __syncthreads();  // `in` written; streamed: earlier readers of wbuf done
    if (!ch.weights_resident) {
      load_layer_padded<T>(ch, l, mach, wbuf, tid, FS_TILE_THREADS);
      copy_async_commit();
      copy_async_wait<0>();
      __syncthreads();
    }
    const float* wl = wbuf + woff;
    const float* bl = wl + din * dp;
    const int ncg = dp / FS_CT;
    const int items = R / FS_RT * ncg;
    with_act(ch.act[l], [&](auto act) {
      for (int it = tid; it < items; it += FS_TILE_THREADS) {
        const int rg = it / ncg;
        const int j0 = (it - rg * ncg) * FS_CT;
        const float* xr = in + rg * FS_RT * D;
        float acc[FS_RT][FS_CT];
#pragma unroll
        for (int rr = 0; rr < FS_RT; ++rr)
#pragma unroll
          for (int jj = 0; jj < FS_CT; ++jj) acc[rr][jj] = 0.f;
#pragma unroll 4
        for (int k = 0; k < din; ++k) {
          const float4 w4 = *reinterpret_cast<const float4*>(wl + k * dp + j0);
          const float wv[FS_CT] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int rr = 0; rr < FS_RT; ++rr) {
            const float v = xr[rr * D + k];
#pragma unroll
            for (int jj = 0; jj < FS_CT; ++jj) acc[rr][jj] = fmaf(v, wv[jj], acc[rr][jj]);
          }
        }
        float* orow = out + rg * FS_RT * D;
#pragma unroll
        for (int jj = 0; jj < FS_CT; ++jj) {
          const int j = j0 + jj;
          if (j < dout) {
            const float bj = bl[j];
#pragma unroll
            for (int rr = 0; rr < FS_RT; ++rr) orow[rr * D + j] = act(acc[rr][jj] + bj);
          }
        }
      }
    });
    if (ch.weights_resident) woff += (din + 1) * dp;
    float* t = in;
    in = out;
    out = t;
  }
  return in;
}

template <typename TX, typename T>
__global__ void __launch_bounds__(FS_TILE_THREADS) fleet_score_tile_kernel(const __grid_constant__ FleetScoreArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
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
  const int tid = threadIdx.x;
  constexpr int NT = FS_TILE_THREADS;

  float* wbuf = smem;                  // weights, padded: every layer, or the current one
  float* sdet = wbuf + a.wbuf_floats;  // detector stats a (fo), b (fo)
  float* yraw = sdet + 2 * fo;         // R x fo raw targets (detector only)
  float* bufa = yraw + (det ? R * fo : 0);  // R x D activations
  float* bufb = bufa + R * D;              // R x D activations

  // device memory → shared: rows, targets, stats, resident weights
  const size_t row_base = (size_t)slot * a.n + row0;
  gather_rows(bufa, D, static_cast<const TX*>(a.x) + row_base * F, rows, F, tid, NT);
  if (det && a.y)
    gather_rows(yraw, fo, static_cast<const T*>(a.y) + ((size_t)slot * a.y_n + a.y_row0 + row0) * fo, rows, fo, tid,
                NT);
  if (det) {
    const T* ds = static_cast<const T*>(a.det.a[0]) + (size_t)mach * fo;
    const T* dof = static_cast<const T*>(a.det.b[0]) + (size_t)mach * fo;
    for (int j = tid; j < fo; j += NT) {
      sdet[j] = ld(ds + j);
      sdet[fo + j] = ld(dof + j);
    }
  }
  if (a.chain.weights_resident)
    for (int l = 0, off = 0; l < a.chain.n_layers; off += padded_layer_floats(a.chain, l), ++l)
      load_layer_padded<T>(a.chain, l, mach, wbuf + off, tid, NT);
  copy_async_commit();
  copy_async_wait<0>();
  __syncthreads();
  // the pipeline's scaler steps on the rows, in place (rows past the tile
  // zero); without y, F == fo and the raw rows are the targets
  const bool y_is_x = det && !a.y;
  const size_t at = (size_t)mach * F;  // the machine's scaler stats
  with_chain<T>(a.scalers, [&](auto apply) {
    walk_nt(R, F, tid, NT, [&](int r, int j) {
      float v = 0.f;
      if (r < rows) {
        v = bufa[r * D + j];
        if (y_is_x) yraw[r * fo + j] = v;
        v = apply(at + j, v);
      }
      bufa[r * D + j] = v;
    });
  });

  const float* in = dense_tile<T>(a.chain, mach, wbuf, bufa, bufb, R, D);
  __syncthreads();

  // epilogue from shared memory, elementwise over every lane; `in` holds
  // the predictions, and each y element, once read, holds its tag's square
  with_form(det ? a.det.form[0] : SP_AFFINE, [&](auto form) {
    walk_nt(rows, fo, tid, NT, [&](int r, int j) {
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
    for (int r = tid; r < rows; r += NT) {
      const float total = row_l2(yraw + r * fo, fo, row0 + r);
      a.total[row_base + r] = total;
      if (a.agg_thr) a.conf[row_base + r] = total / conf_divisor(__ldg(a.agg_thr + mach));
    }
  }
}

extern "C" int fleet_score_args_size() { return (int)sizeof(FleetScoreArgs); }

// the row path's widest layer, largest block and rows a thread, the tile
// path's rows a thread
extern "C" int fleet_score_limits(int* out) {
  out[0] = FS_NARROW_MAX;
  out[1] = FS_ROW_THREADS;
  out[2] = FS_ROW_RPT;
  out[3] = FS_RT;
  return 0;
}

extern "C" const char* fleet_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <typename Kernel>
static int launch_with(Kernel kernel, const FleetScoreArgs* a, int threads, cudaStream_t stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(a->blocks_per_slot, a->m);
  kernel<<<grid, threads, a->smem_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <typename TX, typename T>
static int launch(const FleetScoreArgs* a, cudaStream_t stream) {
  if (a->path == FS_PATH_ROWS && a->row_rpt == 2)
    return launch_with(fleet_score_rows_kernel<TX, T, 2>, a, a->rows_per_block / 2, stream);
  if (a->path == FS_PATH_ROWS) return launch_with(fleet_score_rows_kernel<TX, T, 1>, a, a->rows_per_block, stream);
  return launch_with(fleet_score_tile_kernel<TX, T>, a, FS_TILE_THREADS, stream);
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a plan the path cannot take.
// Instantiations: f32 throughout; bf16 storage; f32 x (an LSTM head's
// state) over bf16 storage.
extern "C" int fleet_score_launch(const FleetScoreArgs* a, void* stream) {
  const int tiles = (a->n + a->rows_per_block - 1) / a->rows_per_block;
  if (a->path == FS_PATH_ROWS ? (a->max_dim > FS_NARROW_MAX || a->row_rpt < 1 || a->row_rpt > FS_ROW_RPT ||
                                 a->rows_per_block < 32 * a->row_rpt ||
                                 a->rows_per_block > a->row_rpt * FS_ROW_THREADS ||
                                 a->rows_per_block % (32 * a->row_rpt) ||
                                 a->blocks_per_slot < 1 || a->blocks_per_slot > tiles)
                              : (a->path != FS_PATH_TILE || a->rows_per_block < FS_RT || a->rows_per_block % FS_RT ||
                                 a->blocks_per_slot != tiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!a->bf16) return launch<float, float>(a, s);
  if (a->x_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return launch<float, __nv_bfloat16>(a, s);
}
