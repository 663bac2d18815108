// lstm_head_fit: the LSTM detector's `out` head, its loss and its gradient,
// for the minibatch of every slot of a fleet build's lockstep fit.
//
// Replaces, inside the XLA program `fleet.exact` (gordo_tpu/parallel/
// anomaly.py:1093 `one_fit` -> gordo_tpu/train/fit.py:160 `make_epoch_fn`),
// the LSTM module's head (gordo_tpu/models/factories/lstm.py:173, a Dense
// on the last layer's last step), the weighted mse of `make_loss_fn`
// (fit.py:119) and their part of `jax.value_and_grad`.  Per slot, over its
// n_windows real windows w (padding windows weigh 0, so they add nothing
// to the loss or to any gradient and are skipped):
//
//   pred   = act(h_w @ W + b)            h_w: the last layer's last step
//   y_w    = y[x_mach, rows[row_off + win[w] + shift]]   (raw targets)
//   loss   = sum_w mean_j (pred - y_w)^2 / max(n_windows, 1)
//   dpred  = act'(((1 / max(n_windows, 1)) / Fo) * (2 * (pred - y_w)))
//   dW     = sum_w h_w^T dpred;  db = sum_w dpred;  dh_w = dpred @ W^T
//
// Bound: 4 * H * Fo FLOP a window (the product and its two gradients: 42 x
// 50 at the bench's LSTM) against H + Fo floats of input, ~8 FLOP a byte:
// at 256 slots x 64 windows it is a few microseconds either way, so the
// launch, not the work, sets its time.
//
// Design: one block per slot.  W and the real windows' h are staged in
// shared memory by cp.async while each window's target row is looked up
// once (rows[win + shift]); a thread fetches its tile's targets into
// registers before its products, so no global load waits inside an FMA
// chain.  Each thread carries a 4 x 4 tile of outputs, 16 independent
// chains sharing their loads: predictions (4 windows x 4 outputs, chains
// over k), dW (4 units x 4 outputs, chains over the real windows) and dh
// (4 windows x 4 units, chains over o), every chain in the parent's order;
// a tile's windows, and dh's units, lie a quarter of their range apart.
// The loads run along the chain where the layout allows it: four steps of
// k (h and W rows) in the predictions, four of o in dh.  A warp takes 4 x
// 8 tiles, so that its lanes' loads fall in distinct banks at the bench's
// 42 -> 50 head.  db and each window's loss are one sum a thread, the
// slot's loss thread 0's sum in window order.  The plan picks one of two
// layouts: rows padded to 16 bytes, read as float4 (V 4), where they fit;
// else the parent's layout (W rows at the odd stride Fo | 1, the rest
// unpadded) read a float at a time (V 1), so the kernel takes every head
// and batch the parent took.  A tile past the edge reads clamped rows or
// padding and stores nothing there.  No float atomics, so a slot's result
// does not depend on the others.  A slot with no real window (a pad-up
// group's step past the machine's length) writes a loss of 0 and zero
// gradients, on which Adam still steps.

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"
#include "copy_async.cuh"

#ifndef HF_THREADS
#define HF_THREADS 256  // threads a block (a slot)
#endif

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/lstm_head_fit.py;
// lstm_head_fit_args_size() lets the wrapper check the two agree.
struct LstmHeadFitArgs {
  const float* h;          // (m, nw, H) the last layer's last step, after its activation
  const float* w;          // (m, H, Fo)
  const float* b;          // (m, Fo)
  const float* y;          // (M, n, Fo) raw targets
  const int* win;          // (m, nw) window ids of each slot's minibatch
  const int* rows;         // the fits' row lists, concatenated
  const int* row_off;      // (m,) where each slot's row list starts in `rows`
  const int* x_mach;       // (m,) the machine of y each slot reads
  const int* n_windows;    // (m,) real windows of each slot (at the front)
  float* loss;             // (m,)
  float* dw;               // (m, H, Fo)
  float* db;               // (m, Fo)
  float* dh;               // (m, nw, H)
  int m;
  int n;                   // rows per machine of y
  int nw;
  int hidden;              // H
  int fo;
  int shift;               // target row of window w: rows[win[w] + shift]
  int act;
  int vec;                 // 4: rows padded to 16 bytes, read as float4; 1: the parent's layout
  int smem_bytes;
};

// a tile's four indices from `first`, clamped to the last valid one
__device__ __forceinline__ void clamp4(int (&ix)[4], int first, int last) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ix[i] = min(first + i, last);
}

// a tile's four indices first, first + step, ..., clamped to the last
// valid one: a warp's neighbouring tiles then read neighbouring rows, whose
// 16-byte pieces fall in distinct banks
__device__ __forceinline__ void spread4(int (&ix)[4], int first, int step, int last) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ix[i] = min(first + i * step, last);
}

// four consecutive floats: one 16-byte load (V 4, 16-byte aligned) or four
template <int V>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (V == 4) return *reinterpret_cast<const float4*>(p);
  else return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Item t of a phase over A x B tiles, a warp's 32 items 4 tiles along A by
// 8 along B; false past the edge.
__device__ __forceinline__ bool tile_of(int t, int A, int B, int& ta, int& tb) {
  const int lane = t & 31, g = t >> 5, gb = (B + 7) >> 3;
  ta = (g / gb) * 4 + (lane >> 3);
  tb = (g % gb) * 8 + (lane & 7);
  return ta < A && tb < B;
}

__device__ __forceinline__ int tile_items(int A, int B) { return 32 * ((A + 3) >> 2) * ((B + 7) >> 3); }

template <int V>
__global__ void __launch_bounds__(HF_THREADS)
lstm_head_fit_kernel(const LstmHeadFitArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int slot = blockIdx.x;
  const int H = a.hidden;
  const int FO = a.fo;
  // row strides: W (H x WS), h (nw x HS), dpred (nw x DS)
  const int WS = V == 4 ? (FO + 3) & ~3 : FO | 1;
  const int HS = V == 4 ? (H + 3) & ~3 : H;
  const int DS = V == 4 ? (FO + 3) & ~3 : FO;
  const int nreal = a.n_windows[slot];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  float* ws = smem;                   // H x WS
  float* hsm = ws + H * WS;           // nw x HS
  float* dp = hsm + a.nw * HS;        // nw x DS: dpred
  float* ysq = dp + a.nw * DS;        // nw x Fo: targets, then squared errors
  float* row_loss = ysq + a.nw * FO;  // nw: window losses

  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const float* W = a.w + (size_t)slot * H * FO;
  for (int k = warp; k < H; k += nwarps)
    for (int o = lane; o < FO; o += 32) copy_async(ws + k * WS + o, W + k * FO + o);
  const float* hg = a.h + (size_t)slot * a.nw * H;
  for (int wl = warp; wl < nreal; wl += nwarps)
    for (int k = lane; k < H; k += 32) copy_async(hsm + wl * HS + k, hg + wl * H + k);
  // each window's target row, looked up once, then copied: window wl by
  // warp wl % nwarps, its row looked up by lane wl / nwarps
  const int* rows = a.rows + a.row_off[slot];
  const int* wins = a.win + (size_t)slot * a.nw;
  const float* yg = a.y + (size_t)(a.x_mach ? a.x_mach[slot] : slot) * a.n * FO;
  for (int base = 0; base < nreal; base += 32 * nwarps) {
    const int mine = base + lane * nwarps + warp;
    const int r = mine < nreal ? rows[wins[mine] + a.shift] : 0;
    for (int l = 0; l < 32; ++l) {
      const int wl = base + l * nwarps + warp;
      if (wl >= nreal) break;  // the whole warp alike
      const int rl = __shfl_sync(0xffffffffu, r, l);
      for (int o = lane; o < FO; o += 32) copy_async(ysq + wl * FO + o, yg + (size_t)rl * FO + o);
    }
  }
  copy_async_commit();
  copy_async_wait<0>();
  __syncthreads();

  const float* B = a.b + (size_t)slot * FO;
  const float inv_fo = 1.f / (float)FO;
  const float coef = __fmul_rn(__fdiv_rn(1.f, fmaxf((float)nreal, 1.f)), inv_fo);
  const int OT = (FO + 3) >> 2, KT = (H + 3) >> 2, WT = (nreal + 3) >> 2;
  const int H4 = H & ~3, FO4 = FO & ~3;
  // predictions, squared errors and dpred: tiles of 4 windows x 4 outputs
  for (int t = tid; t < tile_items(WT, OT); t += nthr) {
    int wt, ot;
    if (!tile_of(t, WT, OT, wt, ot)) continue;
    const int o0 = ot * 4;
    int wi[4], oi[4];
    spread4(wi, wt, WT, nreal - 1);
    clamp4(oi, o0, FO - 1);
    float bias[4], acc[4][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = __ldg(B + oi[j]);
    int k = 0;
    for (; k < H4; k += 4) {
      float4 hv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = ld4<V>(hsm + wi[i] * HS + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wv[kk] = ld4<V>(ws + (k + kk) * WS + o0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(at(hv[i], kk), at(wv[kk], j), acc[i][j]);
    }
    for (; k < H; ++k) {
      const float4 wv = ld4<V>(ws + k * WS + o0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = hsm[wi[i] * HS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv, at(wv, j), acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int wl = wt + i * WT;
        if (wl >= nreal || o0 + j >= FO) continue;
        const float pred = act_fn(a.act, __fadd_rn(acc[i][j], bias[j]));
        const float diff = __fsub_rn(pred, ysq[wl * FO + o0 + j]);
        ysq[wl * FO + o0 + j] = __fmul_rn(diff, diff);
        dp[wl * DS + o0 + j] = act_grad(a.act, __fmul_rn(coef, __fmul_rn(2.f, diff)), pred);
      }
  }
  __syncthreads();

  // db and each window's loss (one serial sum each), then dW tiles (4
  // units x 4 outputs) and dh tiles (4 windows x 4 units)
  float* dwg = a.dw + (size_t)slot * H * FO;
  float* dhg = a.dh + (size_t)slot * a.nw * H;
  const int n_dw = tile_items(KT, OT), n_dh = tile_items(WT, KT);
  const int sums = (FO + nreal + 31) & ~31;  // items before the tiles, a whole number of warps
  for (int t = tid - sums; t < n_dw + n_dh; t += nthr) {
    if (t < FO - sums) {
      const int o = t + sums;
      float s = 0.f;
#pragma unroll 8
      for (int wl = 0; wl < nreal; ++wl) s = __fadd_rn(s, dp[wl * DS + o]);
      a.db[(size_t)slot * FO + o] = s;
    } else if (t < 0) {
      const int wl = t + sums - FO;
      if (wl >= nreal) continue;
      float s = 0.f;
#pragma unroll 8
      for (int o = 0; o < FO; ++o) s = __fadd_rn(s, ysq[wl * FO + o]);
      row_loss[wl] = __fmul_rn(s, inv_fo);
    } else if (t < n_dw) {
      int kt, ot;
      if (!tile_of(t, KT, OT, kt, ot)) continue;
      const int k0 = kt * 4, o0 = ot * 4;
      float acc[4][4] = {};
      for (int wl = 0; wl < nreal; ++wl) {
        const float4 hv = ld4<V>(hsm + wl * HS + k0);
        const float4 dv = ld4<V>(dp + wl * DS + o0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(at(hv, i), at(dv, j), acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + i < H && o0 + j < FO) dwg[(k0 + i) * FO + o0 + j] = acc[i][j];
    } else {
      int wt, kt;
      if (!tile_of(t - n_dw, WT, KT, wt, kt)) continue;
      int wi[4], ki[4];
      spread4(wi, wt, WT, nreal - 1);
      spread4(ki, kt, KT, H - 1);
      float acc[4][4] = {};
      int o = 0;
      for (; o < FO4; o += 4) {
        float4 dv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = ld4<V>(dp + wi[i] * DS + o);
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ld4<V>(ws + ki[j] * WS + o);
#pragma unroll
        for (int oo = 0; oo < 4; ++oo)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(at(dv[i], oo), at(wv[j], oo), acc[i][j]);
      }
      for (; o < FO; ++o) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dp[wi[i] * DS + o], ws[ki[j] * WS + o], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (wt + i * WT < nreal && kt + j * KT < H) dhg[(wt + i * WT) * H + kt + j * KT] = acc[i][j];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int wl = 0; wl < nreal; ++wl) s = __fadd_rn(s, row_loss[wl]);
    a.loss[slot] = __fdiv_rn(s, fmaxf((float)nreal, 1.f));
  }
}

extern "C" int lstm_head_fit_args_size() { return (int)sizeof(LstmHeadFitArgs); }

extern "C" const char* lstm_head_fit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int lstm_head_fit_launch(const LstmHeadFitArgs* a, void* stream) {
  auto kernel = a->vec == 4 ? lstm_head_fit_kernel<4> : lstm_head_fit_kernel<1>;
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a->m, HF_THREADS, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
