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
// Bound: at the bench's LSTM (50 tags, lookback 12, widths 42-33-25-25-
// 33-42) a window-step costs 8H(in + H) FLOP for the two products against
// at most 4(in + H) bytes of input and output, ~2H FLOP per byte: every
// layer is bound by fp32 arithmetic (the H100's ridge is ~20 FLOP/byte).
// The input product is computed per window, as JAX does (overlapping
// windows of layer 0 share rows, so it could be per row: a later PR's).
//
// Design: one block per (dispatch slot, tile of Tw windows).  The layer's
// W_i, W_h (transposed, one gate column per row) and bias sit in shared
// memory for the block's life (50 -> 42: 65 KB); all six layers (232 KB)
// would not fit a block, so each layer is one launch.  Thread (g, j) owns
// hidden unit j of the WPT windows of group g: it computes the four gate
// columns j, H+j, 2H+j, 3H+j for them and keeps their c in registers.
// Each weight float4 it loads from shared memory serves WPT windows; the
// windows' inputs and states are float4 broadcasts (every thread of a
// group reads the same row).  Per step the tile's inputs x_t go into one
// of two shared buffers and h into one of two others, so one barrier per
// step orders everything.  Row strides are padded to 4 (mod 8) floats so
// the weights' float4 reads by neighbouring units hit distinct banks.
//
// Training mode (`win` set): the slots are the fits of a fleet build and
// each slot's windows are one minibatch, given by window id: window w of
// the slot is rows rows[row_off + w .. row_off + w + L - 1] of machine
// x_mach of x (a fit's gathered rows; the first layer), or position w of
// the previous layer's output.  The first n_windows[slot] windows are the
// minibatch's real ones; the rest are not computed.  Each step's gates
// (after their sigmoid / tanh) and c go to `gates` and `cell`, which is
// all the backward (lstm_layer_bwd.cu) needs: it recomputes h = o *
// tanh(c) bit for bit.  The weights are the slot's own (no idx).
//
// Reduced-precision serving (K10): the weights, the bias, the pipeline
// stats and the first layer's rows may be stored in bf16 (T); they are
// widened to f32 as they are loaded into shared memory, and the gates,
// c, h and the output stay f32, as the JAX module computes its LSTM in
// f32 from bf16-cast params.  Training mode is f32 only.

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"
#include "scaler_prefix.cuh"
#include "storage.cuh"

#define LL_THREADS 512
#define LL_WPT 4

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
  int in_pad;
  int h_pad;
  int smem_bytes;
  int bf16;                // T is __nv_bfloat16 (serving only)
};

// TRAIN: the training mode (minibatch windows by id, saves); a template
// parameter, so the serving instantiation carries none of it.  T: the
// storage type of the weights, stats and first-layer rows.
template <bool TRAIN, typename T>
__global__ void __launch_bounds__(LL_THREADS)
lstm_layer_kernel(const LstmLayerArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int mach = a.idx ? a.idx[slot] : slot;
  const int H = a.hidden;
  const int H4 = 4 * H;
  const int IN = a.in;
  const int IP = a.in_pad;
  const int HP = a.h_pad;
  const int L = a.lookback;
  const int Tw = a.groups * LL_WPT;
  const int w0 = blockIdx.x * Tw;
  const int nw_slot = a.n_windows ? a.n_windows[slot] : a.nw;
  if (w0 >= nw_slot) return;  // uniform over the block
  const int tiles = min(Tw, nw_slot - w0);  // valid windows of this tile

  float* wi_t = smem;                  // 4H x IP
  float* wh_t = wi_t + H4 * IP;        // 4H x HP
  float* sb = wh_t + H4 * HP;          // 4H
  float* xbuf = sb + H4;               // 2 x Tw x IP
  float* hbuf = xbuf + 2 * Tw * IP;    // 2 x Tw x HP

  // weights, transposed, zero in the padding
  const T* Wi = static_cast<const T*>(a.w_i) + (size_t)mach * IN * H4;
  const T* Wh = static_cast<const T*>(a.w_h) + (size_t)mach * H * H4;
  const T* Bs = static_cast<const T*>(a.bias) + (size_t)mach * H4;
  for (int e = threadIdx.x; e < H4 * IP; e += blockDim.x) {
    const int c = e / IP;
    const int k = e - c * IP;
    wi_t[e] = k < IN ? ld(Wi + (size_t)k * H4 + c) : 0.f;
  }
  for (int e = threadIdx.x; e < H4 * HP; e += blockDim.x) {
    const int c = e / HP;
    const int k = e - c * HP;
    wh_t[e] = k < H ? ld(Wh + (size_t)k * H4 + c) : 0.f;
  }
  for (int e = threadIdx.x; e < H4; e += blockDim.x) sb[e] = ld(Bs + e);
  for (int e = threadIdx.x; e < 2 * Tw * HP; e += blockDim.x) hbuf[e] = 0.f;

  const int xm = TRAIN ? a.x_mach[slot] : slot;
  const size_t at = (size_t)mach * IN;  // the machine's scaler stats

  const int j = threadIdx.x % H;
  const int g = threadIdx.x / H;
  float c[LL_WPT];
#pragma unroll
  for (int q = 0; q < LL_WPT; ++q) c[q] = 0.f;

  for (int t = 0; t < L; ++t) {
    float* xb = xbuf + (t & 1) * Tw * IP;
    const float* hprev = hbuf + (t & 1) * Tw * HP;
    float* hnext = hbuf + ((t + 1) & 1) * Tw * HP;
    // the tile's inputs of step t; windows past the slot's end read zeros
    with_chain<T>(a.scalers, [&](auto apply) {
      for (int e = threadIdx.x; e < Tw * IP; e += blockDim.x) {
        const int wl = e / IP;
        const int k = e - wl * IP;
        float v = 0.f;
        if (k < IN && wl < tiles) {
          if (a.rows_input) {
            const size_t row =
                TRAIN ? (size_t)xm * a.n + a.rows[a.row_off[slot] + a.win[(size_t)slot * a.nw + w0 + wl] + t]
                      : (size_t)slot * a.n + w0 + wl + t;
            v = ld(static_cast<const T*>(a.x) + row * IN + k);
            v = apply(at + k, v);
          } else {
            v = __ldg(static_cast<const float*>(a.x) + (((size_t)slot * a.nw + w0 + wl) * L + t) * IN + k);
          }
        }
        xb[e] = v;
      }
    });
    __syncthreads();

    float xp[4][LL_WPT];
    float hh[4][LL_WPT];
#pragma unroll
    for (int q = 0; q < LL_WPT; ++q) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        xp[gate][q] = 0.f;
        hh[gate][q] = 0.f;
      }
    }
    // xp = x_t @ W_i
    for (int k = 0; k < IP; k += 4) {
      float4 w[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        w[gate] = *reinterpret_cast<const float4*>(wi_t + (gate * H + j) * IP + k);
#pragma unroll
      for (int q = 0; q < LL_WPT; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xb + (g * LL_WPT + q) * IP + k);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          float s = xp[gate][q];
          s = fmaf(v.x, w[gate].x, s);
          s = fmaf(v.y, w[gate].y, s);
          s = fmaf(v.z, w[gate].z, s);
          s = fmaf(v.w, w[gate].w, s);
          xp[gate][q] = s;
        }
      }
    }
    // h @ W_h
    for (int k = 0; k < HP; k += 4) {
      float4 w[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        w[gate] = *reinterpret_cast<const float4*>(wh_t + (gate * H + j) * HP + k);
#pragma unroll
      for (int q = 0; q < LL_WPT; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(hprev + (g * LL_WPT + q) * HP + k);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          float s = hh[gate][q];
          s = fmaf(v.x, w[gate].x, s);
          s = fmaf(v.y, w[gate].y, s);
          s = fmaf(v.z, w[gate].z, s);
          s = fmaf(v.w, w[gate].w, s);
          hh[gate][q] = s;
        }
      }
    }
    const float bi = sb[j], bf = sb[H + j], bg = sb[2 * H + j], bo = sb[3 * H + j];
#pragma unroll
    for (int q = 0; q < LL_WPT; ++q) {
      const float zi = (hh[0][q] + bi) + xp[0][q];
      const float zf = (hh[1][q] + bf) + xp[1][q];
      const float zg = (hh[2][q] + bg) + xp[2][q];
      const float zo = (hh[3][q] + bo) + xp[3][q];
      const float ig = sigmoid_f(zi);
      const float fg = sigmoid_f(zf);
      const float gg = tanhf(zg);
      const float og = sigmoid_f(zo);
      c[q] = __fadd_rn(__fmul_rn(fg, c[q]), __fmul_rn(ig, gg));
      const float h = __fmul_rn(og, tanhf(c[q]));
      const int wl = g * LL_WPT + q;
      hnext[wl * HP + j] = h;
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
  }
}

extern "C" int lstm_layer_args_size() { return (int)sizeof(LstmLayerArgs); }

extern "C" const char* lstm_layer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <bool TRAIN, typename T>
static int launch(const LstmLayerArgs* a, cudaStream_t stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_layer_kernel<TRAIN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int tw = a->groups * LL_WPT;
  dim3 grid((a->nw + tw - 1) / tw, a->m);
  lstm_layer_kernel<TRAIN, T><<<grid, a->groups * a->hidden, a->smem_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Training mode when `win` is set (`win`, `rows`, `row_off`, `x_mach`,
// `gates` and `cell` all set, `idx` null; f32 only); serving at f32 or,
// with `bf16`, over bf16 storage.
extern "C" int lstm_layer_launch(const LstmLayerArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a->win) return launch<true, float>(a, s);
  return a->bf16 ? launch<false, __nv_bfloat16>(a, s) : launch<false, float>(a, s);
}
