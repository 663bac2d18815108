// lstm_layer: one LSTM layer of a bucket of LSTM detectors, over every
// window of every dispatch slot, with the layer's activation applied.
//
// Replaces `_fused_lstm_layer` (gordo_tpu/models/factories/lstm.py:92) and
// the activation the module applies after it (lstm.py:171), as the XLA
// serving programs run them under `serve.score` / `serve.fleet`
// (gordo_tpu/serve/scorer.py:211, gordo_tpu/serve/fleet_scorer.py:51), and
// `make_windows` (gordo_tpu/ops/windows.py:18), which the first layer
// fuses into its loads.  Per machine, window b and step t:
//
//   x_t  = layer 0: chain(rows[b + t])         (the pipeline's scaler steps)
//          later:   in[b, t]                       (previous layer's func(h))
//   xp   = x_t @ W_i                               (computed first)
//   z    = (h @ W_h + bias) + xp                   (gates i, f, g, o)
//   c    = sigmoid(f) * c + sigmoid(i) * tanh(g)   (c, h start at 0, f32)
//   h    = sigmoid(o) * tanh(c)
//   out  = func(h) for every step, or for the last step only (last layer)
//
// Every output is one FMA chain in a fixed order, whatever the tile: xp
// over k = 0 .. in-1, h @ W_h over k = 0 .. H-1, each from 0, then the
// two sums as written.  So a window's output does not depend on the tile,
// block or launch it falls in (the stream's ring and the request path give
// the same bits), and is the parent design's bit for bit.
//
// Bound: at the bench's LSTM (50 tags, lookback 12, widths 42-33-25-25-
// 33-42) a window-step costs 8H(in + H) FLOP for the two products against
// at most 4(in + H) bytes of input and output, ~2H FLOP per byte: every
// layer is bound by fp32 arithmetic (the H100's ridge is ~20 FLOP/byte).
// The first layer's input product depends on the row alone (windows
// overlap), so the function needs it once per row: 64 x 4096 x 50, six
// layers, 4.56 ms at 67 TFLOP/s.
//
// Design: one block per (dispatch slot, tile of Tw = G * WPT windows), G
// groups of H threads; thread (q, j) owns hidden unit j of the WPT windows
// q*WPT .. q*WPT+WPT-1 of the tile and keeps their c in registers.
//
// - The weights sit in shared memory k-major with the four gates of a unit
//   side by side (`[k][4j + gate]`), so one float4 load gives thread j its
//   four gate weights of row k; the tile's h_{t-1} (and a later layer's
//   x_t) sit transposed (`[k][window]`), so one float4 broadcast gives
//   four windows' values.  Each row k of a product costs a thread one
//   weight load and WPT / 4 broadcasts for 4 * WPT FMAs: at WPT 8, 32 FMAs
//   per three loads, where the parent design read four weight float4s for
//   every four windows (64 FMAs per eight loads).  On the H100 a float4
//   load of 32 distinct addresses took ~4x a broadcast, so the weight load
//   sets the rate.  (Tried and measured slower: 16 windows a thread, which
//   costs registers or an xp table in shared memory and so occupancy; the
//   weights in flax's layout as four scalar loads a row.)
// - The first layer's input product is hoisted out of the recurrence
//   (serving): before the step loop the block takes the tile's Tw + L - 1
//   rows through the scaler chain once and computes xp of each row once
//   (the parent recomputed it, chain included, for every window that holds
//   the row: up to L times); the step loop reads xp[window + t] from shared
//   memory.  A later layer's input differs per window and step, so its
//   product stays in the loop, with the same register tile; its x_t tile
//   is copied asynchronously (cp.async), x_{t+1}'s while step t computes.
// - The weights are staged four values a load, several loads in flight
//   (a block's staging was ~6% of its time at the bench, ~10 us of 172).
// - The launch plan (kernels/lstm_layer.py) picks WPT by the windows: 8
//   where the launch has enough tiles to fill the card, 2 where it has few
//   (the stream's one machine of 144 windows: 72 blocks rather than the
//   parent's 3), and the groups by the layer: up to 12 for a hoisted first
//   layer (its L - 1 extra rows amortised over larger tiles), up to 6 for
//   the others, measured best of 2 to 12.
// - One barrier a step: x_t and h are double-buffered.
// - What bounds it now (per-block %globaltimer clocks at the bench, layer
//   42 -> 33): the products ~56% of a block's time, the epilogue's five
//   transcendentals per unit-window (and the activation of the output)
//   ~37%, staging ~6%, barriers under 1%.  Each activation is the
//   reference's accurate expf / tanhf, so that outputs keep their bits.
//

// Training mode (`win` set): the slots are the fits of a fleet build and
// each slot's windows are one minibatch, given by window id: window w of
// the slot is rows rows[row_off + w .. row_off + w + L - 1] of machine
// x_mach of x (a fit's gathered rows; the first layer), or position w of
// the previous layer's output.  The first n_windows[slot] windows are the
// minibatch's real ones; the rest are not computed.  Minibatch windows
// share no rows in general, so the first layer's input product stays in
// the loop.  Each step's gates (after their sigmoid / tanh) and c go to
// `gates` and `cell`, which is all the backward (lstm_layer_bwd.cu) needs:
// it recomputes h = o * tanh(c) bit for bit.  The weights are the slot's
// own (no idx).
//
// Reduced-precision serving (K10): the weights, the bias, the pipeline
// stats and the first layer's rows may be stored in bf16 (T); they are
// widened to f32 as they are loaded into shared memory, and the gates,
// c, h and the output stay f32, as the JAX module computes its LSTM in
// f32 from bf16-cast params.  Training mode is f32 only.

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"
#include "copy_async.cuh"
#include "scaler_prefix.cuh"
#include "storage.cuh"

#define LL_THREADS 512

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/lstm_layer.py;
// lstm_layer_args_size() lets the wrapper check the two agree.
struct LstmLayerArgs {
  const void* x;           // rows_input: (m, n, in) raw rows, T; else (m, nw, L, in) float
  ScalerPrefix scalers;    // the pipeline's scaler steps, stats (M, in) T (rows_input only; n 0: none)
  const void* w_i;         // (M, in, 4H), T
  const void* w_h;         // (M, H, 4H), T
  const void* bias;        // (M, 4H), T
  const int* idx;          // (m,) stacked machine of each slot, or null: slot
  const int* n_windows;    // (m,) valid windows of each slot, or null: nw
  float* out;              // last: (m, nw, H); else (m, nw, L, H)
  const int* win;          // training: (m, nw) window ids of each slot, or null
  const int* rows;         // training, first layer: the fits' row lists, concatenated
  const int* row_off;      // (m,) where each slot's row list starts in `rows`
  const int* x_mach;       // (m,) the machine of x (M, n, in) each slot reads
  float* gates;            // training: (m, nw, L, 4H) gates i, f, g, o after activation
  float* cell;             // training: (m, nw, L, H) c of every step
  int m;
  int n;                   // rows per slot of x (rows_input)
  int nw;                  // windows per slot of the output
  int lookback;            // L
  int in;
  int hidden;              // H
  int rows_input;
  int last;
  int act;
  int groups;              // G; the block has G * H threads and Tw = G * WPT windows
  int wpt;                 // WPT, windows per thread: 8 or 2
  int hoist;               // serving, first layer: xp of each row before the step loop
  int tile_pad;            // row stride of the transposed tiles h^T, x^T (>= Tw)
  int rows_pad;            // hoist: row stride of the tile's rows^T (>= Tw + L - 1, rounded to 4)
  int smem_bytes;
  int bf16;                // T is __nv_bfloat16 (serving only)
};

// four consecutive values of device memory at T, widened (p 16-byte
// aligned for float)
template <typename T>
__device__ __forceinline__ void ld4(const T* p, float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ld(p + i);
}

template <>
__device__ __forceinline__ void ld4<float>(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// rows x 4H weights (flax's gate blocks i, f, g, o) into shared memory with
// the four gates of a unit side by side, `[k][4j + gate]`: four values a
// load, several loads in flight
template <typename T>
__device__ __forceinline__ void stage_gates(float* dst, const T* src, int rows, int H) {
  const int H4 = 4 * H;
#pragma unroll 4
  for (int e = 4 * threadIdx.x; e < rows * H4; e += 4 * blockDim.x) {
    float v[4];
    ld4(src + e, v);
    const int k = e / H4;
    const int cc = e - k * H4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gate = (cc + i) / H;
      dst[k * H4 + 4 * (cc + i - gate * H) + gate] = v[i];
    }
  }
}

// WPT consecutive floats of a transposed tile row, as vector loads
template <int WPT>
__device__ __forceinline__ void load_row(const float* p, float (&v)[WPT]) {
  if constexpr (WPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < WPT; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WPT; i += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
    }
  }
}

template <int WPT>
__device__ __forceinline__ void store_row(float* p, const float (&v)[WPT]) {
  if constexpr (WPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < WPT; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < WPT; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  }
}

// acc[w][gate] += sum over k < K of v[k][w] * w4[k][gate], k in order:
// the WPT windows' values of row k from `vt` (row stride `vs`), the four
// gate weights of unit j from `wt` (row stride 4H)
template <int WPT>
__device__ __forceinline__ void gate_product(float (&acc)[WPT][4], const float* vt, int vs,
                                             const float* wt, int H4, int K) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(wt + (size_t)k * H4);
    float v[WPT];
    load_row<WPT>(vt + k * vs, v);
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      acc[q][0] = fmaf(v[q], w.x, acc[q][0]);
      acc[q][1] = fmaf(v[q], w.y, acc[q][1]);
      acc[q][2] = fmaf(v[q], w.z, acc[q][2]);
      acc[q][3] = fmaf(v[q], w.w, acc[q][3]);
    }
  }
}

// TRAIN: the training mode (minibatch windows by id, saves); a template
// parameter, so the serving instantiation carries none of it.  T: the
// storage type of the weights, stats and first-layer rows.  WPT: windows
// per thread.
template <bool TRAIN, typename T, int WPT>
__global__ void __launch_bounds__(LL_THREADS)
lstm_layer_kernel(const LstmLayerArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int mach = a.idx ? a.idx[slot] : slot;
  const int H = a.hidden;
  const int H4 = 4 * H;
  const int IN = a.in;
  const int L = a.lookback;
  const int TS = a.tile_pad;
  const int Tw = a.groups * WPT;
  const int w0 = blockIdx.x * Tw;
  const int nw_slot = a.n_windows ? a.n_windows[slot] : a.nw;
  if (w0 >= nw_slot) return;  // uniform over the block
  const int tiles = min(Tw, nw_slot - w0);  // valid windows of this tile
  const bool hoist = !TRAIN && a.hoist;

  float* wh = smem;                   // H x 4H, [k][4j + gate]
  float* wi = wh + H * H4;            // IN x 4H, [k][4j + gate]
  float* sb = wi + IN * H4;           // 4H, [4j + gate]
  float* hbuf = sb + H4;              // 2 x H x TS: h^T of the tile
  float* xbuf = hbuf + 2 * H * TS;    // in the loop: 2 x IN x TS, x_t^T of the tile
  float* xr = xbuf;                   // hoist: IN x RS, the tile's rows^T
  float* xp_rows = xr + IN * a.rows_pad;  // hoist: RS x 4H, xp of each row, [r][4j + gate]

  // a later layer's x_t tile (float, no chain) is copied asynchronously,
  // x_{t+1}'s while step t computes; x_0's while the weights load
  const bool copied = !hoist && !a.rows_input;
  const float* xw = copied ? static_cast<const float*>(a.x) + ((size_t)slot * a.nw + w0) * L * IN : nullptr;
  auto copy_x = [&](int t) {
    float* xb = xbuf + (t & 1) * IN * TS;
    for (int e = threadIdx.x; e < Tw * IN; e += blockDim.x) {
      const int wl = e / IN;
      const int k = e - wl * IN;
      if (wl < tiles) {
        copy_async(xb + k * TS + wl, xw + ((size_t)wl * L + t) * IN + k);
      } else {
        xb[k * TS + wl] = 0.f;  // windows past the slot's end read zeros
      }
    }
    copy_async_commit();
  };
  if (copied) copy_x(0);

  // weights, gates of a unit side by side
  stage_gates(wi, static_cast<const T*>(a.w_i) + (size_t)mach * IN * H4, IN, H);
  stage_gates(wh, static_cast<const T*>(a.w_h) + (size_t)mach * H * H4, H, H);
  const T* Bs = static_cast<const T*>(a.bias) + (size_t)mach * H4;
  for (int e = threadIdx.x; e < H4; e += blockDim.x) {
    const int gate = e / H;
    sb[4 * (e - gate * H) + gate] = ld(Bs + e);
  }
  for (int e = threadIdx.x; e < H * TS; e += blockDim.x) hbuf[e] = 0.f;  // h_{-1}

  const int xm = TRAIN ? a.x_mach[slot] : slot;
  const size_t at = (size_t)mach * IN;  // the machine's scaler stats
  const int j = threadIdx.x % H;
  const int g = threadIdx.x / H;
  const int wq = g * WPT;  // this thread's first window in the tile

  if (hoist) {
    // the tile's rows w0 .. w0 + R - 1, each through the chain once; rows
    // past them (to RS) read zeros
    const int RS = a.rows_pad;
    const int R = tiles + L - 1;
    with_chain<T>(a.scalers, [&](auto apply) {
      for (int e = threadIdx.x; e < RS * IN; e += blockDim.x) {
        const int r = e / IN;
        const int k = e - r * IN;
        float v = 0.f;
        if (r < R) {
          v = ld(static_cast<const T*>(a.x) + ((size_t)slot * a.n + w0 + r) * IN + k);
          v = apply(at + k, v);
        }
        xr[k * RS + r] = v;
      }
    });
    __syncthreads();
    // xp of every row, four rows a pass, each an FMA chain over k in order
    for (int r4 = 4 * g; r4 < RS; r4 += 4 * a.groups) {
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) acc[q][gate] = 0.f;
      gate_product<4>(acc, xr + r4, RS, wi + 4 * j, H4, IN);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(xp_rows + (size_t)(r4 + q) * H4 + 4 * j) =
            make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    }
  }

  float c[WPT];
#pragma unroll
  for (int q = 0; q < WPT; ++q) c[q] = 0.f;

  for (int t = 0; t < L; ++t) {
    float* xb = xbuf + (t & 1) * IN * TS;
    const float* hprev = hbuf + (t & 1) * H * TS;
    float* hnext = hbuf + ((t + 1) & 1) * H * TS;
    if (copied) {
      copy_async_wait<0>();  // x_t's copies (this thread's)
    } else if (!hoist) {
      // the first layer's rows of step t (training; serving where the
      // hoist does not fit), through the chain, transposed; windows past
      // the slot's end read zeros
      with_chain<T>(a.scalers, [&](auto apply) {
        for (int e = threadIdx.x; e < Tw * IN; e += blockDim.x) {
          const int wl = e / IN;
          const int k = e - wl * IN;
          float v = 0.f;
          if (wl < tiles) {
            const size_t row =
                TRAIN ? (size_t)xm * a.n + a.rows[a.row_off[slot] + a.win[(size_t)slot * a.nw + w0 + wl] + t]
                      : (size_t)slot * a.n + w0 + wl + t;
            v = apply(at + k, ld(static_cast<const T*>(a.x) + row * IN + k));
          }
          xb[k * TS + wl] = v;
        }
      });
    }
    __syncthreads();
    // every thread has passed step t-1, so x_{t+1}'s buffer is free
    if (copied && t + 1 < L) copy_x(t + 1);

    const float4 bias = *reinterpret_cast<const float4*>(sb + 4 * j);
    float xp[WPT][4];
    float hh[WPT][4];
#pragma unroll
    for (int q = 0; q < WPT; ++q)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        xp[q][gate] = 0.f;
        hh[q][gate] = 0.f;
      }
    if (hoist) {
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xp_rows + (size_t)(wq + q + t) * H4 + 4 * j);
        xp[q][0] = v.x;
        xp[q][1] = v.y;
        xp[q][2] = v.z;
        xp[q][3] = v.w;
      }
    } else {
      gate_product<WPT>(xp, xb + wq, TS, wi + 4 * j, H4, IN);  // xp = x_t @ W_i
    }
    gate_product<WPT>(hh, hprev + wq, TS, wh + 4 * j, H4, H);  // h @ W_h

    float hv[WPT];
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      const float zi = (hh[q][0] + bias.x) + xp[q][0];
      const float zf = (hh[q][1] + bias.y) + xp[q][1];
      const float zg = (hh[q][2] + bias.z) + xp[q][2];
      const float zo = (hh[q][3] + bias.w) + xp[q][3];
      const float ig = sigmoid_f(zi);
      const float fg = sigmoid_f(zf);
      const float gg = tanhf(zg);
      const float og = sigmoid_f(zo);
      c[q] = __fadd_rn(__fmul_rn(fg, c[q]), __fmul_rn(ig, gg));
      const float h = __fmul_rn(og, tanhf(c[q]));
      hv[q] = h;
      const int wl = wq + q;
      if (TRAIN && wl < tiles) {
        const size_t st = ((size_t)slot * a.nw + w0 + wl) * L + t;
        float* gp = a.gates + st * H4;
        gp[j] = ig;
        gp[H + j] = fg;
        gp[2 * H + j] = gg;
        gp[3 * H + j] = og;
        a.cell[st * H + j] = c[q];
      }
      if (wl < tiles && (!a.last || t == L - 1)) {
        const size_t w = (size_t)slot * a.nw + w0 + wl;
        const float o = act_fn(a.act, h);
        if (a.last) {
          a.out[w * H + j] = o;
        } else {
          a.out[(w * L + t) * H + j] = o;
        }
      }
    }
    store_row<WPT>(hnext + j * TS + wq, hv);
  }
}

extern "C" int lstm_layer_args_size() { return (int)sizeof(LstmLayerArgs); }

extern "C" const char* lstm_layer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <bool TRAIN, typename T, int WPT>
static int launch(const LstmLayerArgs* a, cudaStream_t stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_layer_kernel<TRAIN, T, WPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int tw = a->groups * WPT;
  dim3 grid((a->nw + tw - 1) / tw, a->m);
  lstm_layer_kernel<TRAIN, T, WPT><<<grid, a->groups * a->hidden, a->smem_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <bool TRAIN, typename T>
static int launch_wpt(const LstmLayerArgs* a, cudaStream_t stream) {
  if (a->wpt == 8) return launch<TRAIN, T, 8>(a, stream);
  if (a->wpt == 2) return launch<TRAIN, T, 2>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Training mode when `win` is set (`win`, `rows`, `row_off`, `x_mach`,
// `gates` and `cell` all set, `idx` null; f32 only); serving at f32 or,
// with `bf16`, over bf16 storage.
extern "C" int lstm_layer_launch(const LstmLayerArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->win) return launch_wpt<true, float>(a, s);
  return a->bf16 ? launch_wpt<false, __nv_bfloat16>(a, s) : launch_wpt<false, float>(a, s);
}
