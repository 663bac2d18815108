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
// `lstm_step_cost`); fp32 arithmetic bounds it: 0.51 ms for one lockstep
// step of the bench's LSTM build (256 slots x 64 windows, six layers).
//
// Design: only the recurrence dz -> dh_rec -> dc is serial, so a call runs
// three kernels on its stream, and the products that are not serial run
// with the whole card's parallelism (the parent design ran every product
// inside the serial loop, one block a slot: 8.6 ms a lockstep step).
//
// (a) lstm_bwd_recur_kernel: the recurrence, one block per (slot, tile of
//     G * 4 windows), since windows are independent in it.  Thread (q, j)
//     owns unit j of four windows of the tile: it keeps their dc and
//     dh_rec in registers, loads their saves (gates, c, dout) a step ahead
//     so that the loads run under the step before, writes their dz to
//     shared memory and to `dz` (m, nw, L, 4H), and their h = o * tanh(c)
//     to `hs` (m, nw, L, H), and after the step's one barrier computes
//     their dh_rec = dz @ W_h^T from W_h's row j (shared memory, a float4
//     for every four columns, odd stride) and the four windows' dz
//     (broadcasts), each an FMA chain over the 4H columns in order.  dz is
//     double-buffered.  (A 4 x 4 register tile of windows and units for
//     dh_rec, with two barriers a step and the saves loaded when needed,
//     took 0.32 ms a layer against this design's 0.27 on the H100.)
// (b) lstm_bwd_wgrad_kernel: per slot dW_i = X^T dZ, dW_h = H_{t-1}^T dZ and
//     dbias = 1^T dZ over the slot's n_windows x L (window, step) rows, one
//     block per slot and as many of the 4H gate columns as 512 threads take
//     (all 168 at the bench's 50 -> 42).  The block stages 32 rows of
//     [x_t | h_{t-1} | 1] and of dz at a time with asynchronous copies
//     (cp.async), the next 32 while it sums these (x through the slot's
//     scaler steps for layer 0 once it lands; h_{t-1} the recurrence's
//     `hs`), and each thread sums a 4 x 8 tile of the gradient over the
//     rows in their order (window by window, step by step): every entry of
//     a slot's gradient is one FMA chain in an order fixed by the slot's
//     real windows alone, not by the grid or the other slots, with no float
//     atomics.  A slot with no real window (a step of a pad-up group's fit
//     past the machine's length) writes zeros: Adam steps on them.
// (c) lstm_bwd_dx_kernel (not for layer 0): dx = dZ W_i^T, `dx_blocks`
//     blocks per slot (four), each W_i in shared memory and its rows' dz staged
//     32 at a time, asynchronously and double-buffered; each thread a 4 x 4
//     tile, each entry an FMA chain over the 4H columns in order.
//
// (a) and (c) keep the parent design's order, so dz, dh_rec and dx are its
// bits; (b) sums window by window where the parent summed by tiles of
// windows, step by step (held to the plain version at 1e-4).

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"
#include "copy_async.cuh"
#include "scaler_prefix.cuh"

#define LB_THREADS 512
#define LB_WPT 4        // windows a thread of (a) owns
#define LB_ROWS 32      // (window, step) rows (b) stages at a time, twice

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
  float* dz;               // (m, nw, L, 4H) scratch: (a) writes, (b) and (c) read
  float* hs;               // (m, nw, L, H) scratch: h of every step, (a) writes, (b) reads
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
  int groups;              // (a): G; the block has G * H threads and G * LB_WPT windows
  int w_pad;               // (a), (c): row stride of W_h, W_i in shared memory (>= 4H)
  int k_pad;               // (b): row stride of the staged [x | h | 1] rows (>= in + H + 1, a multiple of 4)
  int grad_cols;           // (b): gate columns a block sums (a multiple of 8)
  int dx_rows;             // (c): rows a block stages at a time, twice
  int dx_blocks;           // (c): blocks a slot's rows are shared among
  int recur_smem;
  int wgrad_smem;
  int dx_smem;
};

// (a) the recurrence
__global__ void __launch_bounds__(LB_THREADS)
lstm_bwd_recur_kernel(const LstmLayerBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int H = a.hidden;
  const int H4 = 4 * H;
  const int WS = a.w_pad;
  const int L = a.lookback;
  const int TW = a.groups * LB_WPT;
  const int w0 = blockIdx.x * TW;
  const int nreal = a.n_windows[slot];
  if (w0 >= nreal) return;  // uniform over the block
  const int tn = min(TW, nreal - w0);

  float* whs = smem;              // H x WS, W_h's rows
  float* dzs = whs + H * WS;      // 2 x TW x 4H
  const float* Wh = a.w_h + (size_t)slot * H * H4;
  for (int e = threadIdx.x; e < H * H4; e += blockDim.x) {
    const int r = e / H4;
    whs[r * WS + (e - r * H4)] = __ldg(Wh + e);
  }

  const int j = threadIdx.x % H;
  const int q = threadIdx.x / H;
  const int wq = q * LB_WPT;
  // what step t of window wl needs of the saves and of dout, loaded a step
  // ahead, so that the loads run under the step before
  struct Saves {
    float ig, fg, gg, og, ct, cp, d;
  };
  auto load = [&](int t, int wl, Saves& s) {
    if (wl >= tn) return;
    const size_t base = ((size_t)slot * a.nw + w0 + wl) * L;
    const float* gt = a.gates + (base + t) * H4;
    s.ig = gt[j];
    s.fg = gt[H + j];
    s.gg = gt[2 * H + j];
    s.og = gt[3 * H + j];
    s.ct = a.cell[(base + t) * H + j];
    s.cp = t > 0 ? a.cell[(base + t - 1) * H + j] : 0.f;
    s.d = 0.f;
    if (!a.last || t == L - 1)
      s.d = a.last ? a.dout[((size_t)slot * a.nw + w0 + wl) * H + j] : a.dout[(base + t) * H + j];
  };
  Saves cur[LB_WPT], nxt[LB_WPT];
  float dc[LB_WPT], dhr[LB_WPT];
#pragma unroll
  for (int i = 0; i < LB_WPT; ++i) {
    dc[i] = dhr[i] = 0.f;
    load(L - 1, wq + i, cur[i]);
  }

  for (int t = L - 1; t >= 0; --t) {
    float* dzt = dzs + (t & 1) * TW * H4;
#pragma unroll
    for (int i = 0; i < LB_WPT; ++i) {
      const int wl = wq + i;
      if (wl >= tn) break;
      const Saves& s = cur[i];
      const float tc = tanhf(s.ct);
      const float h = __fmul_rn(s.og, tc);  // the forward's h, bit for bit
      a.hs[(((size_t)slot * a.nw + w0 + wl) * L + t) * H + j] = h;
      float dh = dhr[i];
      if (!a.last || t == L - 1) dh = __fadd_rn(act_grad(a.act, s.d, act_fn(a.act, h)), dh);
      const float d_o = __fmul_rn(dh, tc);
      const float dtc = __fmul_rn(s.og, dh);
      const float u = __fmul_rn(dtc, __fsub_rn(1.f, tc));
      const float dcv = __fadd_rn(__fadd_rn(u, __fmul_rn(u, tc)), dc[i]);
      const float d_i = __fmul_rn(dcv, s.gg);
      const float d_g = __fmul_rn(s.ig, dcv);
      const float d_f = __fmul_rn(dcv, s.cp);
      const float ug = __fmul_rn(d_g, __fsub_rn(1.f, s.gg));
      const float z0 = __fmul_rn(d_i, __fmul_rn(s.ig, __fsub_rn(1.f, s.ig)));
      const float z1 = __fmul_rn(d_f, __fmul_rn(s.fg, __fsub_rn(1.f, s.fg)));
      const float z2 = __fadd_rn(ug, __fmul_rn(ug, s.gg));
      const float z3 = __fmul_rn(d_o, __fmul_rn(s.og, __fsub_rn(1.f, s.og)));
      dc[i] = __fmul_rn(s.fg, dcv);
      float* dzw = dzt + wl * H4;
      dzw[j] = z0;
      dzw[H + j] = z1;
      dzw[2 * H + j] = z2;
      dzw[3 * H + j] = z3;
      float* dzg = a.dz + (((size_t)slot * a.nw + w0 + wl) * L + t) * H4;
      dzg[j] = z0;
      dzg[H + j] = z1;
      dzg[2 * H + j] = z2;
      dzg[3 * H + j] = z3;
    }
    if (t == 0) break;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < LB_WPT; ++i) load(t - 1, wq + i, nxt[i]);
    // dh into step t-1: each window's dz against W_h's row j, columns in order
    float acc[LB_WPT];
#pragma unroll
    for (int i = 0; i < LB_WPT; ++i) acc[i] = 0.f;
    const float* wr = whs + j * WS;
    const float* dzq = dzt + wq * H4;
#pragma unroll 2
    for (int c = 0; c < H4; c += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wr + c);
#pragma unroll
      for (int i = 0; i < LB_WPT; ++i) {
        const float4 d = *reinterpret_cast<const float4*>(dzq + i * H4 + c);
        float s = acc[i];
        s = fmaf(d.x, w.x, s);
        s = fmaf(d.y, w.y, s);
        s = fmaf(d.z, w.z, s);
        s = fmaf(d.w, w.w, s);
        acc[i] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < LB_WPT; ++i) {
      dhr[i] = acc[i];
      cur[i] = nxt[i];
    }
  }
}

// (b) the weight gradients of `grad_cols` gate columns of a slot
__global__ void __launch_bounds__(LB_THREADS)
lstm_bwd_wgrad_kernel(const LstmLayerBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int CS = a.grad_cols;
  const int c0 = blockIdx.x * CS;
  const int H = a.hidden;
  const int H4 = 4 * H;
  const int IN = a.in;
  const int L = a.lookback;
  const int K = IN + H + 1;  // [x_t | h_{t-1} | 1]
  const int KP = a.k_pad;
  const int R = a.n_windows[slot] * L;  // the slot's real (window, step) rows
  const int tid = threadIdx.x;
  float* as = smem;                       // 2 x LB_ROWS x KP
  float* ds = as + 2 * LB_ROWS * KP;      // 2 x LB_ROWS x CS

  // this thread's tile: k 4kt .. 4kt+3, columns c0 + 8ct .. c0 + 8ct + 7
  const int ct = tid % (CS / 8);
  const int kt = tid / (CS / 8);
  const bool mine = kt < KP / 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const int xm = a.x_mach ? a.x_mach[slot] : slot;
  const size_t at = (size_t)slot * IN;  // the slot's scaler stats
  const int* wins = a.win + (size_t)slot * a.nw;
  const int* rows = a.rows_input ? a.rows + a.row_off[slot] : nullptr;
  const size_t slot_rows = (size_t)slot * a.nw * L;

  // the columns past h_{t-1}, the same in every row: 1, then zeros
  for (int e = tid; e < 2 * LB_ROWS * (KP - IN - H); e += blockDim.x) {
    const int r = e / (KP - IN - H);
    const int k = IN + H + (e - r * (KP - IN - H));
    as[r * KP + k] = k == IN + H ? 1.f : 0.f;
  }
  // rows r0 .. r0 + rn - 1 into buffer `b`, every copy asynchronous: x_t
  // (layer 0: the row gathered, taken through the chain once it lands),
  // h_{t-1} (the recurrence's `hs`; zero at t = 0) and the block's dz
  // columns (zero past 4H)
  auto stage = [&](int r0, int b) {
    const int rn = min(LB_ROWS, R - r0);
    float* ab = as + b * LB_ROWS * KP;
    float* db = ds + b * LB_ROWS * CS;
    for (int e = tid; e < rn * IN; e += blockDim.x) {
      const int r = e / IN;
      const int k = e - r * IN;
      const size_t gr = slot_rows + r0 + r;
      const float* src = a.rows_input
          ? a.x + ((size_t)xm * a.n + rows[wins[(r0 + r) / L] + (r0 + r) % L]) * IN + k
          : a.x + gr * IN + k;
      copy_async(ab + r * KP + k, src);
    }
    for (int e = tid; e < rn * H; e += blockDim.x) {
      const int r = e / H;
      const int u = e - r * H;
      const size_t gr = slot_rows + r0 + r;
      if ((r0 + r) % L == 0) {
        ab[r * KP + IN + u] = 0.f;
      } else {
        copy_async(ab + r * KP + IN + u, a.hs + (gr - 1) * H + u);
      }
    }
    for (int e = tid; e < rn * (CS / 4); e += blockDim.x) {
      const int r = e / (CS / 4);
      const int c = 4 * (e - r * (CS / 4));
      float* dst = db + r * CS + c;
      if (c0 + c < H4) {
        copy_async16(dst, a.dz + (slot_rows + r0 + r) * H4 + c0 + c);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    copy_async_commit();
  };
  // layer 0: this thread's x values of buffer `b`, once its copies landed
  auto chain_rows = [&](int r0, int b) {
    if (!a.rows_input || a.scalers.n == 0) return;
    const int rn = min(LB_ROWS, R - r0);
    float* ab = as + b * LB_ROWS * KP;
    with_chain<float>(a.scalers, [&](auto apply) {
      for (int e = tid; e < rn * IN; e += blockDim.x) {
        const int r = e / IN;
        const int k = e - r * IN;
        ab[r * KP + k] = apply(at + k, ab[r * KP + k]);
      }
    });
  };

  if (R > 0) stage(0, 0);
  for (int r0 = 0, b = 0; r0 < R; r0 += LB_ROWS, b ^= 1) {
    const int rn = min(LB_ROWS, R - r0);
    if (r0 + LB_ROWS < R) {
      stage(r0 + LB_ROWS, b ^ 1);  // the next rows' copies run under this chunk's sums
      copy_async_wait<1>();
    } else {
      copy_async_wait<0>();
    }
    chain_rows(r0, b);
    __syncthreads();
    const float* ab = as + b * LB_ROWS * KP;
    const float* db = ds + b * LB_ROWS * CS;
    for (int r = 0; r < (mine ? rn : 0); ++r) {
      const float4 x4 = *reinterpret_cast<const float4*>(ab + r * KP + 4 * kt);
      const float4 d0 = *reinterpret_cast<const float4*>(db + r * CS + 8 * ct);
      const float4 d1 = *reinterpret_cast<const float4*>(db + r * CS + 8 * ct + 4);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(xv[i], dv[c], acc[i][c]);
    }
    __syncthreads();  // buffer b is staged again two chunks on
  }

  if (!mine) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * kt + i;
    if (k >= K) break;
    float* out = k < IN ? a.dw_i + ((size_t)slot * IN + k) * H4
                 : k < IN + H ? a.dw_h + ((size_t)slot * H + k - IN) * H4
                              : a.dbias + (size_t)slot * H4;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + 8 * ct + c;
      if (col < H4) out[col] = acc[i][c];
    }
  }
}

// (c) dx of a share of a slot's rows, `dx_rows` rows at a time
__global__ void __launch_bounds__(LB_THREADS)
lstm_bwd_dx_kernel(const LstmLayerBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int H4 = 4 * a.hidden;
  const int IN = a.in;
  const int WS = a.w_pad;
  const int RX = a.dx_rows;
  const int R = a.n_windows[slot] * a.lookback;
  const int share = (R + gridDim.x - 1) / gridDim.x;
  const int begin = blockIdx.x * share;
  const int end = min(R, begin + share);
  if (begin >= end) return;  // uniform over the block
  const int tid = threadIdx.x;
  float* wis = smem;            // IN x WS, W_i's rows
  float* dzs = wis + IN * WS;   // 2 x RX x WS, the rows' dz
  const float* Wi = a.w_i + (size_t)slot * IN * H4;
  for (int e = 4 * tid; e < IN * H4; e += 4 * blockDim.x) {
    const int r = e / H4;
    *reinterpret_cast<float4*>(wis + r * WS + (e - r * H4)) = __ldg(reinterpret_cast<const float4*>(Wi + e));
  }
  const size_t slot_rows = (size_t)slot * a.nw * a.lookback;
  const int kq = (IN + 3) / 4;
  // rows r0 .. into buffer b, asynchronously
  auto stage = [&](int r0, int b) {
    const int rn = min(RX, end - r0);
    const float* src = a.dz + (slot_rows + r0) * H4;
    for (int e = 4 * tid; e < rn * H4; e += 4 * blockDim.x) {
      const int r = e / H4;
      copy_async16(dzs + (b * RX + r) * WS + (e - r * H4), src + e);
    }
    copy_async_commit();
  };
  stage(begin, 0);
  for (int r0 = begin, b = 0; r0 < end; r0 += RX, b ^= 1) {
    const int rn = min(RX, end - r0);
    if (r0 + RX < end) {
      stage(r0 + RX, b ^ 1);  // the next rows' copies run under these rows' sums
      copy_async_wait<1>();
    } else {
      copy_async_wait<0>();
    }
    __syncthreads();
    const float* dzr = dzs + b * RX * WS;
    // this thread's tiles: rows 4rt .. 4rt+3, inputs 4kt .. 4kt+3
    for (int tile = tid; tile < (RX / 4) * kq; tile += blockDim.x) {
      const int rt = tile / kq;
      const int kt = tile - rt * kq;
      if (4 * rt >= rn) continue;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
      const float* dp = dzr + 4 * rt * WS;
      const float* wp = wis + 4 * kt * WS;
      // rows past IN read row 4kt again (their sums are not written)
      const int kstep[4] = {0, 4 * kt + 1 < IN ? WS : 0, 4 * kt + 2 < IN ? 2 * WS : 0,
                            4 * kt + 3 < IN ? 3 * WS : 0};
#pragma unroll 2
      for (int c = 0; c < H4; c += 4) {
        float4 d[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i] = *reinterpret_cast<const float4*>(dp + i * WS + c);
          w[i] = *reinterpret_cast<const float4*>(wp + kstep[i] + c);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float s = acc[i][k];
            s = fmaf(d[i].x, w[k].x, s);
            s = fmaf(d[i].y, w[k].y, s);
            s = fmaf(d[i].z, w[k].z, s);
            s = fmaf(d[i].w, w[k].w, s);
            acc[i][k] = s;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * rt + i >= rn) break;
        float* o = a.dx + (slot_rows + r0 + 4 * rt + i) * IN;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * kt + k < IN) o[4 * kt + k] = acc[i][k];
      }
    }
    __syncthreads();  // buffer b is staged again two chunks on
  }
}

extern "C" int lstm_layer_bwd_args_size() { return (int)sizeof(LstmLayerBwdArgs); }

extern "C" const char* lstm_layer_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Launches (a), then (b) and (c), on `stream` without synchronising;
// returns the first error, cudaGetLastError() after each launch.
extern "C" int lstm_layer_bwd_launch(const LstmLayerBwdArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = allow_smem(lstm_bwd_recur_kernel, a->recur_smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(lstm_bwd_wgrad_kernel, a->wgrad_smem)) != cudaSuccess) return (int)err;
  const int tw = a->groups * LB_WPT;
  lstm_bwd_recur_kernel<<<dim3((a->nw + tw - 1) / tw, a->m), a->groups * a->hidden, a->recur_smem, s>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lstm_bwd_wgrad_kernel<<<dim3((4 * a->hidden + a->grad_cols - 1) / a->grad_cols, a->m),
                          ((a->k_pad / 4) * (a->grad_cols / 8) + 31) / 32 * 32, a->wgrad_smem, s>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a->dx) {
    if ((err = allow_smem(lstm_bwd_dx_kernel, a->dx_smem)) != cudaSuccess) return (int)err;
    const int threads = min(LB_THREADS, ((a->dx_rows / 4) * ((a->in + 3) / 4) + 31) / 32 * 32);
    lstm_bwd_dx_kernel<<<dim3(a->dx_blocks, a->m), threads, a->dx_smem, s>>>(*a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
