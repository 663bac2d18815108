// lstm_layer_bwd: backpropagation through the steps of one LSTM layer, for
// every window of the minibatch of every slot of a fleet build's lockstep
// fit, with the derivative of the layer's activation fused in.
//
// Replaces the VJP of `_fused_lstm_layer` (gordo_tpu/models/factories/
// lstm.py:92) and of the activation after it (lstm.py:171), as
// `jax.value_and_grad` runs them inside `make_epoch_fn` (gordo_tpu/train/
// fit.py:164) under the XLA program `fleet.exact` (gordo_tpu/parallel/
// anomaly.py:1093 `one_fit`).  Per slot, window w (its first n_windows
// real windows only) and step t = L-1 .. 0, from what the training-mode
// forward (lstm_layer.cu) saved, the gates i, f, g, o and c:
//
//   h    = o * tanh(c_t)                      (recomputed, bit for bit)
//   dh   = act'(dout_t) + dh_rec              (dout only at t = L-1 when the
//                                              layer is the last)
//   do   = dh * tanh(c_t);  dc = tanh'(o * dh) + dc_next
//   di   = dc * g;  dg = i * dc;  df = dc * c_{t-1};  dc_next = f * dc
//   dz   = (di * i(1-i), df * f(1-f), tanh'(dg), do * o(1-o))
//   dh_rec (into t-1) = dz @ W_h^T;   dx_t = dz @ W_i^T  (not into layer 0)
//   dW_i += x_t^T dz;  dW_h += h_{t-1}^T dz;  dbias += dz
//
// with the derivatives in the forms JAX transposes them to (tanh'(v) =
// u + u * y with u = v * (1 - y); sigmoid'(v) = v * (y * (1 - y))).  Window
// w of layer 0 is rows rows[row_off + w + t] of machine x_mach, taken
// through the slot's scaler steps as they load, as in the forward.
//
// Bound: per window-step the three products (dh_rec, dx, and the two
// weight gradients) cost 8H(in + H) FLOP, as much as the forward, with
// layer 0's input-side product once per distinct row (chip_smoke.py's
// `lstm_fit_bound` counts the whole fit); fp32 arithmetic bounds it, as
// it does the forward.
//
// Design: one block per slot, for the whole minibatch, so every weight
// gradient is summed in one fixed order (windows of a tile, then steps,
// then tiles) with no float atomics: a slot's gradient does not depend on
// the other slots, or on how many there are.  A slot whose minibatch has
// no real window (n_windows 0: a step of a pad-up group's fit past the
// machine's length) still writes its gradients, as zeros: Adam steps on
// them.  The layer's W_h (and W_i
// when dx is wanted) sit in shared memory as rows of odd stride, beside
// the gradient accumulators (50 -> 42: W_h 28 KB, dW_i 34 KB, dW_h
// 28 KB).  Thread (g, j) owns unit j of window g of the current tile of
// `groups` windows: it keeps that window's dc in a register, writes its
// four dz, and after one barrier computes its dh_rec; the block's threads
// then share the dx outputs and the gradient entries (each thread owns a
// fixed set of entries and adds the tile's windows to them in order).  Two
// barriers a step.

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"
#include "scaler_prefix.cuh"

#define LB_THREADS 512

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/lstm_layer_bwd.py;
// lstm_layer_bwd_args_size() lets the wrapper check the two agree.
struct LstmLayerBwdArgs {
  const float* x;          // first layer: (M, n, in) raw rows; else (m, nw, L, in)
  ScalerPrefix scalers;    // first layer: the scaler steps, stats (m, in) float each slot's; n 0: none
  const int* win;          // (m, nw) window ids of each slot's minibatch
  const int* rows;         // first layer: the fits' row lists, concatenated
  const int* row_off;      // (m,) where each slot's row list starts in `rows`
  const int* x_mach;       // (m,) the machine of x each slot reads
  const int* n_windows;    // (m,) real windows of each slot (at the front)
  const float* w_i;        // (m, in, 4H)
  const float* w_h;        // (m, H, 4H)
  const float* gates;      // (m, nw, L, 4H) from the forward
  const float* cell;       // (m, nw, L, H)
  const float* dout;       // last: (m, nw, H); else (m, nw, L, H)
  float* dx;               // (m, nw, L, in), or null (layer 0)
  float* dw_i;             // (m, in, 4H)
  float* dw_h;             // (m, H, 4H)
  float* dbias;            // (m, 4H)
  int m;
  int n;                   // rows per machine of x (first layer)
  int nw;                  // window positions per slot
  int lookback;            // L
  int in;
  int hidden;              // H
  int rows_input;
  int last;
  int act;
  int groups;              // windows of a tile; the block has groups * H threads
  int smem_bytes;
};

__global__ void __launch_bounds__(LB_THREADS)
lstm_layer_bwd_kernel(const LstmLayerBwdArgs a) {
  extern __shared__ float smem[];
  const int slot = blockIdx.x;
  const int H = a.hidden;
  const int H4 = 4 * H;
  const int HS = H4 | 1;  // odd row stride of the weights in shared memory
  const int IN = a.in;
  const int L = a.lookback;
  const int TW = a.groups;
  const bool want_dx = a.dx != nullptr;
  const int nreal = a.n_windows[slot];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  float* whs = smem;                                // H x HS
  float* wis = whs + H * HS;                        // IN x HS (want_dx)
  float* gwi = wis + (want_dx ? IN * HS : 0);       // IN x 4H
  float* gwh = gwi + IN * H4;                       // H x 4H
  float* gb = gwh + H * H4;                         // 4H
  float* dz = gb + H4;                              // TW x 4H
  float* xs = dz + TW * H4;                         // TW x IN
  float* hs = xs + TW * IN;                         // TW x H
  float* dhr = hs + TW * H;                         // TW x H

  const float* Wh = a.w_h + (size_t)slot * H * H4;
  const float* Wi = a.w_i + (size_t)slot * IN * H4;
  for (int e = tid; e < H * H4; e += nthr) {
    const int r = e / H4;
    whs[r * HS + (e - r * H4)] = __ldg(Wh + e);
  }
  if (want_dx) {
    for (int e = tid; e < IN * H4; e += nthr) {
      const int r = e / H4;
      wis[r * HS + (e - r * H4)] = __ldg(Wi + e);
    }
  }
  for (int e = tid; e < (IN + H + 1) * H4; e += nthr) gwi[e] = 0.f;  // gwi, gwh, gb
  // a slot with no real window (a pad-up group's) skips the loop below and
  // writes the zeros out at once, each thread entries that others zeroed
  __syncthreads();

  const int xm = a.x_mach ? a.x_mach[slot] : slot;
  const size_t at = (size_t)slot * IN;  // the slot's scaler stats
  const int* wins = a.win + (size_t)slot * a.nw;
  const int* rows = a.rows_input ? a.rows + a.row_off[slot] : nullptr;
  const int j = tid % H;
  const int g = tid / H;

  for (int w0 = 0; w0 < nreal; w0 += TW) {
    const int tn = min(TW, nreal - w0);
    const bool mine = g < tn;
    const size_t base = ((size_t)slot * a.nw + w0 + g) * L;  // this thread's window
    float dc = 0.f;
    if (mine) dhr[g * H + j] = 0.f;
    for (int t = L - 1; t >= 0; --t) {
      // phase A: the tile's inputs of step t, h_{t-1}, and dz
      with_chain<float>(a.scalers, [&](auto apply) {
        for (int e = tid; e < tn * IN; e += nthr) {
          const int wl = e / IN;
          const int k = e - wl * IN;
          float v;
          if (a.rows_input) {
            const int row = rows[wins[w0 + wl] + t];
            v = __ldg(a.x + ((size_t)xm * a.n + row) * IN + k);
            v = apply(at + k, v);
          } else {
            v = __ldg(a.x + (((size_t)slot * a.nw + w0 + wl) * L + t) * IN + k);
          }
          xs[wl * IN + k] = v;
        }
      });
      if (mine) {
        const float* gt = a.gates + (base + t) * H4;
        const float ig = gt[j], fg = gt[H + j], gg = gt[2 * H + j], og = gt[3 * H + j];
        const float ct = a.cell[(base + t) * H + j];
        const float cp = t > 0 ? a.cell[(base + t - 1) * H + j] : 0.f;
        const float tc = tanhf(ct);
        float dh = dhr[g * H + j];
        if (!a.last || t == L - 1) {
          const float y = act_fn(a.act, __fmul_rn(og, tc));
          const float d = a.last ? a.dout[((size_t)slot * a.nw + w0 + g) * H + j]
                                 : a.dout[(base + t) * H + j];
          dh = __fadd_rn(act_grad(a.act, d, y), dh);
        }
        const float d_o = __fmul_rn(dh, tc);
        const float dtc = __fmul_rn(og, dh);
        const float u = __fmul_rn(dtc, __fsub_rn(1.f, tc));
        dc = __fadd_rn(__fadd_rn(u, __fmul_rn(u, tc)), dc);
        const float d_i = __fmul_rn(dc, gg);
        const float d_g = __fmul_rn(ig, dc);
        const float d_f = __fmul_rn(dc, cp);
        float* dzw = dz + g * H4;
        dzw[j] = __fmul_rn(d_i, __fmul_rn(ig, __fsub_rn(1.f, ig)));
        dzw[H + j] = __fmul_rn(d_f, __fmul_rn(fg, __fsub_rn(1.f, fg)));
        const float ug = __fmul_rn(d_g, __fsub_rn(1.f, gg));
        dzw[2 * H + j] = __fadd_rn(ug, __fmul_rn(ug, gg));
        dzw[3 * H + j] = __fmul_rn(d_o, __fmul_rn(og, __fsub_rn(1.f, og)));
        dc = __fmul_rn(fg, dc);
        float hp = 0.f;
        if (t > 0) hp = __fmul_rn(a.gates[(base + t - 1) * H4 + 3 * H + j], tanhf(cp));
        hs[g * H + j] = hp;
      }
      __syncthreads();

      // phase B: dh into step t-1, dx of step t, the weight gradients
      if (mine && t > 0) {
        const float* dzw = dz + g * H4;
        const float* wr = whs + j * HS;
        float s = 0.f;
        for (int c = 0; c < H4; ++c) s = fmaf(dzw[c], wr[c], s);
        dhr[g * H + j] = s;
      }
      if (want_dx) {
        for (int e = tid; e < tn * IN; e += nthr) {
          const int wl = e / IN;
          const int k = e - wl * IN;
          const float* dzw = dz + wl * H4;
          const float* wr = wis + k * HS;
          float s = 0.f;
          for (int c = 0; c < H4; ++c) s = fmaf(dzw[c], wr[c], s);
          a.dx[(((size_t)slot * a.nw + w0 + wl) * L + t) * IN + k] = s;
        }
      }
      for (int e = tid; e < IN * H4; e += nthr) {
        const int k = e / H4;
        const int c = e - k * H4;
        float acc = gwi[e];
        for (int wl = 0; wl < tn; ++wl) acc = fmaf(xs[wl * IN + k], dz[wl * H4 + c], acc);
        gwi[e] = acc;
      }
      if (t > 0) {  // h_{-1} = 0 adds nothing
        for (int e = tid; e < H * H4; e += nthr) {
          const int k = e / H4;
          const int c = e - k * H4;
          float acc = gwh[e];
          for (int wl = 0; wl < tn; ++wl) acc = fmaf(hs[wl * H + k], dz[wl * H4 + c], acc);
          gwh[e] = acc;
        }
      }
      for (int c = tid; c < H4; c += nthr) {
        float acc = gb[c];
        for (int wl = 0; wl < tn; ++wl) acc = __fadd_rn(acc, dz[wl * H4 + c]);
        gb[c] = acc;
      }
      __syncthreads();
    }
  }

  float* dwi = a.dw_i + (size_t)slot * IN * H4;
  float* dwh = a.dw_h + (size_t)slot * H * H4;
  float* db = a.dbias + (size_t)slot * H4;
  for (int e = tid; e < IN * H4; e += nthr) dwi[e] = gwi[e];
  for (int e = tid; e < H * H4; e += nthr) dwh[e] = gwh[e];
  for (int e = tid; e < H4; e += nthr) db[e] = gb[e];
}

extern "C" int lstm_layer_bwd_args_size() { return (int)sizeof(LstmLayerBwdArgs); }

extern "C" const char* lstm_layer_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int lstm_layer_bwd_launch(const LstmLayerBwdArgs* a, void* stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_layer_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_layer_bwd_kernel<<<a->m, a->groups * a->hidden, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
