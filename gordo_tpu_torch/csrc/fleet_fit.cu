// fleet_fit: every epoch and minibatch of many fits of many machines'
// feedforward autoencoders, Adam included, in one launch.
//
// Replaces the training half of the XLA program `fleet.exact`
// (gordo_tpu/parallel/anomaly.py:1093 `one_fit`, vmapped over machines),
// that is `make_fit_fn` / `make_epoch_fn` (gordo_tpu/train/fit.py:217,
// :160) with `optax.adam` (:110) inside, the single-machine `train.fit`,
// the resumable `train.stateful_fit` (gordo_tpu/train/checkpoint.py:165,
// `make_stateful_fit_fn` at train/fit.py:192) and the generic `fleet.fit`
// (gordo_tpu/parallel/fleet.py:314, arbitrary row weights).  Per machine
// and fit, for each epoch and minibatch:
//
//   rows  = perm[e][s*bs : (s+1)*bs]        (rows >= n are padding, w = 0)
//   x     = chain(X[row])                   (the fit's scaler steps, applied at load)
//   pred  = dense stack (tanh / linear)
//   loss  = sum_rows(w * mean_j (pred - y)^2) / max(sum_rows w, 1)
//   grads = backward of loss; Adam (optax's op order) on every leaf
//
// and the epoch's loss, sum_b(loss_b * sum w_b) / max(sum w, 1), into the
// history.  A row's weight w is 1 for its fit's first `counts` rows and 0
// after (`counts`: the fit's row count in an exact group, less in the
// pad-up program `fleet.padded`, parallel/anomaly.py:1292 `one_fit`, where
// the fit's rows are a contiguous block and the machine's padding a
// suffix), or, when the caller gives `wrow`, that machine's real-valued
// weight of the row (`fleet.fit`'s `w`).  Rows of weight 0 carry exactly
// zero gradient and loss terms, so the kernel skips them, and a 0/1
// `wrow` gives the bits of the equivalent `counts`: a weight of 1
// multiplies nothing.  A minibatch with no real row still takes its Adam
// step, on a zero gradient, as `make_epoch_fn` does (its loss divides by
// max(sum w, 1)).
//
// Resuming (`train.stateful_fit`): the launch runs the epochs of the
// permutations it is given, from the Adam moments `mu0`/`nu0` and step
// count `count0` of each (machine, fit), and from params per (machine,
// fit) when `params_per_fit` is set; it can write the final moments and
// count.  Nothing in a step depends on which epoch a launch starts at:
// the bias corrections come from the running count alone, so a fit run
// as chunks of epochs, each from the last one's outputs, is the single
// launch bit for bit.
//
// Bound: at the bench shape (512 machines, the default 10-8-7-5-5-7-8-10
// hourglass, TimeSeriesSplit(3) folds plus the final fit over 576 rows,
// 10 epochs) one launch does ~2,042 FLOP (forward, backward deltas, weight
// gradients) for each of 14,400 real row visits per machine, plus Adam,
// ~15.3 GFLOP: ~0.23 ms of fp32 at 67 TFLOP/s, against ~27 MB of rows,
// targets, weights, fitted weights and, resuming, two moments in and out
// per parameter (~8 us at 3.35 TB/s).  So the arithmetic bounds it
// (chip_smoke.py's `fleet_fit_bound` counts it), but its real limit is the
// chain of 10 to 30 dependent Adam steps of each fit: every step needs the
// previous one's weights, so a step's latency is what to cut.
//
// Design: one block per (fit, machine), for the block's whole life, the
// fits with the most steps launched first (`fit_order`), so that the last
// blocks to start are the short fits.  The machine's weights and Adam
// moments (3 x 417 floats at the default width) and the current
// minibatch's activations and deltas stay in shared memory across every
// step; nothing but the rows, the state in and out and the final weights
// touches device memory.  The minibatch lies feature-major (a column of
// `row_stride` floats a feature, padded so that columns start on
// different banks), and each warp owns 32 of its slots: rows r .. r + 3
// of a feature are one float4.  A step is:
//   1. each thread takes one slot of the minibatch; each warp packs its
//      rows of nonzero weight to the front of its 32 (ballot), the warps'
//      weights are summed (per warp, then the warps in order), and each
//      thread loads its row through the scaler steps into the first
//      layer's columns (a warp's rows past its last real one, up to a
//      multiple of four, are zeros);
//   2. each warp alone, a warp barrier between layers, runs its rows'
//      forward pass, a lane computing (eight rows, one output) at a time:
//      two float4s of inputs and one weight per 8 FMAs, in the order of the
//      input index, as a row's own loop would; then each row's loss and the last
//      layer's deltas by its own thread (padding rows' deltas zero); then
//      the backward pass, each layer's weight gradients summed over the
//      warp's rows in order (a partial sum a parameter) and the deltas of
//      the layer before it; a lane walks its items (rows x outputs,
//      parameters, rows x inputs) without a division an item;
//   3. after one block barrier, each thread owns some parameters: it adds
//      the warps' partial sums in warp order and takes the Adam step.
// Two block barriers a step; a warp waits for no other warp between
// them.  Where n_warps partial sums of every parameter do not fit beside
// the columns (`warp_partials` 0, very wide layers with small
// minibatches), every layer's deltas are kept instead and each gradient
// is summed in step 3 over the warps' rows in the same order.  The
// pipeline's scaler steps apply to each value as it loads, each in its own
// form (scaler_prefix.cuh; a MinMax step one FMA, as XLA's fleet program
// fuses its `X * scale + offset`), so the transformed rows are never
// written.

#include <cuda_runtime.h>
#include <math.h>

#include "scaler_prefix.cuh"

#define FF_MAX_LAYERS 16
#define FF_MAX_FITS 16
#define FF_MAX_WARPS 32

enum { ACT_LINEAR = 0, ACT_TANH = 1 };

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/fleet_fit.py;
// fleet_fit_args_size() lets the wrapper check the two agree.
struct FleetFitArgs {
  const float* x;        // (M, N, F) raw rows
  const float* y;        // (M, N, Fo) raw targets
  const int* rows;       // the fits' row lists, concatenated
  ScalerPrefix chain;    // the scaler steps of each fit, stats (M, G, F) float
  const int* perms;      // (D, perm_len): per fit, epochs x n_total row permutations
  const int* draw;       // (M,) row of params0 each machine uses
  const int* perm_draw;  // (M,) row of perms each machine uses
  const int* counts;     // (M, G) real rows of each machine's fit
  const float* wrow;     // (M, N) row weights, or null: 1 below counts, 0 after
  const float* mu0;      // (M, G, P) Adam moments to start from, or null: 0
  const float* nu0;      // (M, G, P)
  const int* count0;     // (M, G) Adam steps already taken, or null: 0
  const float* w0[FF_MAX_LAYERS];  // (D, dims[l], dims[l+1]) initial kernels,
                                   // (D, G, ...) when params_per_fit
  const float* b0[FF_MAX_LAYERS];  // (D, dims[l+1]), (D, G, ...)
  float* w[FF_MAX_LAYERS];         // (M, G, dims[l], dims[l+1]) fitted kernels
  float* b[FF_MAX_LAYERS];         // (M, G, dims[l+1])
  float* history;        // (M, G, epochs)
  float* mu;             // (M, G, P) final Adam moments, or null: not written
  float* nu;             // (M, G, P)
  int* count;            // (M, G) final Adam count, or null
  int params_per_fit;
  int m;
  int n;
  int g;
  int n_layers;
  int epochs;
  int perm_len;
  int dims[FF_MAX_LAYERS + 1];
  int act[FF_MAX_LAYERS];
  int fit_bs[FF_MAX_FITS];        // minibatch rows
  int fit_steps[FF_MAX_FITS];     // minibatches per epoch
  int fit_row_off[FF_MAX_FITS];   // where the fit's row list starts in `rows`
  int fit_perm_off[FF_MAX_FITS];  // where the fit's permutations start in a perms row
  float lr;
  float b1;
  float b2;
  float eps;
  float one_b1;     // 1 - b1 and 1 - b2, rounded from double as optax's
  float one_b2;     // Python-float constants are
  int n_params;     // P: every kernel and bias of one machine
  int fit_order[FF_MAX_FITS];       // the fits, most steps first: block b trains fit_order[b / m]
  int warp_partials;  // 1: each warp's partial sums kept (n_warps x P floats); 0: every layer's deltas
  int row_stride;   // floats of a feature's column of the minibatch (a multiple of 4,
                    // 4 more than a multiple of 32 where it fits: columns start on
                    // different banks)
  int smem_bytes;
};

__device__ __forceinline__ float act_fn(int code, float v) {
  return code == ACT_TANH ? tanhf(v) : v;
}

// d(loss)/d(pre-activation) from d(loss)/d(output) `c` and the output `a`;
// tanh as JAX differentiates it: c * (1 + a) * (1 - a), transposed.
__device__ __forceinline__ float act_grad(int code, float c, float a) {
  if (code == ACT_TANH) {
    const float v = c * (1.f - a);
    return v + v * a;
  }
  return c;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// acc += x * w for four rows, each one FMA (x first, as a row's loop has it)
__device__ __forceinline__ void fma4(float4 x, float w, float4& acc) {
  acc.x = fmaf(x.x, w, acc.x);
  acc.y = fmaf(x.y, w, acc.y);
  acc.z = fmaf(x.z, w, acc.z);
  acc.w = fmaf(x.w, w, acc.w);
}

// Calls body(q, c) for each pair of [0, nq) x [0, nc) that falls to the
// calling lane when its warp walks the pairs in row-major order (c
// fastest), advancing by 32 without a division per pair.
template <typename Body>
__device__ __forceinline__ void lane_walk(int nq, int nc, Body body) {
  const int lane = threadIdx.x & 31;
  int q = lane / nc;
  int c = lane - q * nc;
  const int dq = 32 / nc;
  const int dc = 32 - dq * nc;
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

__global__ void fleet_fit_kernel(const FleetFitArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int fit = a.fit_order[blockIdx.x / a.m];
  const int mach = blockIdx.x % a.m;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  const int L = a.n_layers;
  const int P = a.n_params;
  const int F = a.dims[0];
  const int Fo = a.dims[L];
  const int BS = a.row_stride;
  const size_t slot = (size_t)mach * a.g + fit;
  const int n = a.counts[slot];
  const int bs = a.fit_bs[fit];
  const int steps = a.fit_steps[fit];
  const int n_total = steps * bs;
  const int d = a.draw[mach];
  const size_t pslot = a.params_per_fit ? (size_t)d * a.g + fit : (size_t)d;

  // Columns first (16-byte aligned): each layer's input, then the deltas
  // (two buffers, layer l's output deltas in buffer l % 2, the last
  // layer's output before its deltas; or, without warp partials, one
  // column block a layer), then the warps' partial sums and the state.
  // The offsets sit in shared memory: indexed by a layer known at run
  // time, a thread's own array would sit in local memory.
  __shared__ int a_off[FF_MAX_LAYERS];      // each layer input's first column
  __shared__ int d_off[FF_MAX_LAYERS];      // each layer output's deltas
  __shared__ int p_off[FF_MAX_LAYERS + 1];  // each layer's first parameter
  __shared__ int s_cols;
  if (t == 0) {
    int sa = 0, po = 0, widest[2] = {0, 0};
    for (int l = 0; l < L; ++l) {
      a_off[l] = sa;
      sa += a.dims[l] * BS;
      p_off[l] = po;
      po += a.dims[l] * a.dims[l + 1] + a.dims[l + 1];
      if (l & 1) widest[1] = max(widest[1], a.dims[l + 1]);
      else widest[0] = max(widest[0], a.dims[l + 1]);
    }
    p_off[L] = po;
    for (int l = 0; l < L; ++l) {
      if (a.warp_partials) {
        d_off[l] = sa + ((l & 1) ? widest[0] * BS : 0);
      } else {
        d_off[l] = sa;
        sa += a.dims[l + 1] * BS;
      }
    }
    s_cols = a.warp_partials ? sa + (widest[0] + widest[1]) * BS : sa;
  }
  __syncthreads();
  float* cols = smem;
  float* partial = cols + s_cols;             // n_warps x P, with warp partials
  float* params = partial + (a.warp_partials ? nwarps * P : 0);  // P: W0, b0, W1, b1, ...
  float* mu = params + P;                     // P
  float* nu = mu + P;                         // P
  int* warp_cnt = (int*)(nu + P);             // FF_MAX_WARPS
  float* warp_loss = (float*)(warp_cnt + FF_MAX_WARPS);  // FF_MAX_WARPS
  float* warp_w = warp_loss + FF_MAX_WARPS;   // FF_MAX_WARPS

  for (int l = 0; l < L; ++l) {
    const int nw = a.dims[l] * a.dims[l + 1];
    const int nb = a.dims[l + 1];
    const float* W = a.w0[l] + pslot * nw;
    const float* B = a.b0[l] + pslot * nb;
    for (int e = t; e < nw; e += T) params[p_off[l] + e] = W[e];
    for (int e = t; e < nb; e += T) params[p_off[l] + nw + e] = B[e];
  }
  for (int q = t; q < P; q += T) {
    mu[q] = a.mu0 ? a.mu0[slot * P + q] : 0.f;
    nu[q] = a.nu0 ? a.nu0[slot * P + q] : 0.f;
  }

  const float* wm = a.wrow ? a.wrow + (size_t)mach * a.n : nullptr;
  const int* rows = a.rows + a.fit_row_off[fit];
  // the fit's total weight, the history's divisor: its real rows, or the
  // sum of its rows' weights (per warp, then the warps in order)
  float w_total = (float)n;
  if (wm) {
    float part = 0.f;
    for (int p = t; p < n; p += T) part += __ldg(wm + rows[p]);
    for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
    if (lane == 0) warp_w[warp] = part;
    __syncthreads();
    w_total = 0.f;
    for (int k = 0; k < nwarps; ++k) w_total += warp_w[k];
    __syncthreads();  // warp_w is reused by the first step
  }

  const float* xm = a.x + (size_t)mach * a.n * F;
  const float* ym = a.y + (size_t)mach * a.n * Fo;
  const size_t at = ((size_t)mach * a.g + fit) * F;  // the fit's stats
  const int* perm = a.perms + (size_t)a.perm_draw[mach] * a.perm_len + a.fit_perm_off[fit];
  const float one_b1 = a.one_b1;
  const float one_b2 = a.one_b2;
  const float inv_fo = 1.f / (float)Fo;
  const int r0 = warp * 32;  // this warp's first row
  int count = a.count0 ? a.count0[slot] : 0;

  for (int e = 0; e < a.epochs; ++e) {
    float epoch_acc = 0.f;  // thread 0's
    for (int s = 0; s < steps; ++s) {
      // 1. which of this warp's slots are real rows (weight != 0), packed
      // to the front of its 32
      int p = n;
      if (t < bs) p = perm[(size_t)e * n_total + s * bs + t];
      float wr = 0.f;
      if (t < bs && p < n) wr = wm ? __ldg(wm + rows[p]) : 1.f;
      const bool valid = wr != 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      float wsum = wr;
      for (int o = 16; o > 0; o >>= 1) wsum += __shfl_down_sync(0xffffffffu, wsum, o);
      if (lane == 0) {
        warp_cnt[warp] = __popc(ballot);
        warp_w[warp] = wsum;
      }
      ++count;
      const float bc1 = 1.f - powf(a.b1, (float)count);
      const float bc2 = 1.f - powf(a.b2, (float)count);
      __syncthreads();  // the last step's Adam done; the warps' weights visible
      float bw = 0.f;  // the minibatch's sum of weights (its real rows for 0/1 weights)
      for (int k = 0; k < nwarps; ++k) bw += warp_w[k];
      const int cnt = __popc(ballot);
      const int groups = (cnt + 3) >> 2;
      const int row = r0 + __popc(ballot & ((1u << lane) - 1u));  // this thread's row
      const int src = valid ? rows[p] : 0;
      if (valid) {
        const float* xr = xm + (size_t)src * F;
        with_chain<float>(a.chain, [&](auto apply) {
          for (int j = 0; j < F; ++j) cols[a_off[0] + j * BS + row] = apply(at + j, __ldg(xr + j));
        });
      }
      if (lane >= cnt && lane < 4 * groups)
        for (int j = 0; j < F; ++j) cols[a_off[0] + j * BS + r0 + lane] = 0.f;

      // 2. this warp's rows: the forward pass, four rows and one output a lane
      for (int l = 0; l < L; ++l) {
        const int din = a.dims[l], dout = a.dims[l + 1], code = a.act[l];
        const float* W = params + p_off[l];
        const float* B = W + din * dout;
        const float* in = cols + a_off[l] + r0;
        float* out = cols + (l + 1 < L ? a_off[l + 1] : d_off[L - 1]) + r0;
        __syncwarp();
        lane_walk((groups + 1) >> 1, dout, [&](int gp, int j) {
          // rows 8 gp .. 8 gp + 7 (the second four where the warp has them)
          const bool two = 2 * gp + 1 < groups;
          float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
          for (int i = 0; i < din; ++i) {
            const float w = W[i * dout + j];
            fma4(ld4(in + i * BS + 8 * gp), w, a0);
            if (two) fma4(ld4(in + i * BS + 8 * gp + 4), w, a1);
          }
          const float bj = B[j];
          st4(out + j * BS + 8 * gp, make_float4(act_fn(code, a0.x + bj), act_fn(code, a0.y + bj),
                                                 act_fn(code, a0.z + bj), act_fn(code, a0.w + bj)));
          if (two)
            st4(out + j * BS + 8 * gp + 4, make_float4(act_fn(code, a1.x + bj), act_fn(code, a1.y + bj),
                                                       act_fn(code, a1.z + bj), act_fn(code, a1.w + bj)));
        });
      }
      __syncwarp();

      // the loss and the last layer's deltas, by the thread of each row:
      // mse and its gradient, ((w / max(sum w, 1)) / Fo) * (2 * (pred - y))
      float row_loss = 0.f;
      float* pred = cols + d_off[L - 1];
      if (valid) {
        const float* yr = ym + (size_t)src * Fo;
        const float coef = ((1.f / fmaxf(bw, 1.f)) * wr) * inv_fo;
        float sq = 0.f;
        for (int j = 0; j < Fo; ++j) {
          const float pv = pred[j * BS + row];
          const float diff = pv - __ldg(yr + j);
          sq += diff * diff;
          pred[j * BS + row] = act_grad(a.act[L - 1], coef * (2.f * diff), pv);
        }
        row_loss = (sq * inv_fo) * wr;
      }
      if (lane >= cnt && lane < 4 * groups)
        for (int j = 0; j < Fo; ++j) pred[j * BS + r0 + lane] = 0.f;
      for (int o = 16; o > 0; o >>= 1) row_loss += __shfl_down_sync(0xffffffffu, row_loss, o);
      if (lane == 0) warp_loss[warp] = row_loss;

      // the backward pass: each layer's gradient over this warp's rows,
      // then the deltas of the layer before it
      for (int l = L - 1; l >= 0; --l) {
        const int din = a.dims[l], dout = a.dims[l + 1];
        const float* act_in = cols + a_off[l] + r0;
        const float* dl = cols + d_off[l] + r0;
        __syncwarp();
        if (a.warp_partials) {
          // parameter (i, j) = (q / dout, q % dout), q = lane, lane + 32, ...;
          // i == din: bias j
          float* part = partial + (size_t)warp * P + p_off[l];
          lane_walk(din + 1, dout, [&](int i, int j) {
            const float* dj = dl + j * BS;
            float g = 0.f;
            if (i < din) {
              const float* ai = act_in + i * BS;
              for (int r = 0; r < 4 * groups; r += 4) {
                const float4 av = ld4(ai + r), dv = ld4(dj + r);
                g = fmaf(av.x, dv.x, g);
                g = fmaf(av.y, dv.y, g);
                g = fmaf(av.z, dv.z, g);
                g = fmaf(av.w, dv.w, g);
              }
            } else {
              for (int r = 0; r < 4 * groups; r += 4) {
                const float4 dv = ld4(dj + r);
                g += dv.x;
                g += dv.y;
                g += dv.z;
                g += dv.w;
              }
            }
            part[i * dout + j] = g;
          });
        }
        if (l >= 1) {
          const float* W = params + p_off[l];
          const int code = a.act[l - 1];
          float* dprev = cols + d_off[l - 1] + r0;
          lane_walk((groups + 1) >> 1, din, [&](int gp, int i) {
            const bool two = 2 * gp + 1 < groups;
            float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
            for (int j = 0; j < dout; ++j) {
              const float w = W[i * dout + j];
              fma4(ld4(dl + j * BS + 8 * gp), w, a0);
              if (two) fma4(ld4(dl + j * BS + 8 * gp + 4), w, a1);
            }
            for (int h = 0; h < (two ? 2 : 1); ++h) {
              const float4 acc = h ? a1 : a0;
              const float4 av = ld4(act_in + i * BS + 8 * gp + 4 * h);
              st4(dprev + i * BS + 8 * gp + 4 * h,
                  make_float4(act_grad(code, acc.x, av.x), act_grad(code, acc.y, av.y),
                              act_grad(code, acc.z, av.z), act_grad(code, acc.w, av.w)));
            }
          });
        }
      }
      __syncthreads();  // every warp's partial sums (or every layer's deltas)

      // 3. each parameter's gradient, the warps added in order, and Adam
      int l = 0;
      for (int q = t; q < P; q += T) {
        while (l + 1 < L && q >= p_off[l + 1]) ++l;
        float g = 0.f;
        if (a.warp_partials) {
          for (int w = 0; w < nwarps; ++w) g += partial[(size_t)w * P + q];
        } else {
          const int dout = a.dims[l + 1], k = q - p_off[l];
          const bool weight = k < a.dims[l] * dout;
          const float* ai = cols + a_off[l] + (k / dout) * BS;
          const float* dj = cols + d_off[l] + (weight ? k % dout : k - a.dims[l] * dout) * BS;
          for (int w = 0; w < nwarps; ++w) {
            for (int r = 32 * w; r < 32 * w + ((warp_cnt[w] + 3) & ~3); r += 4) {
              const float4 dv = ld4(dj + r);
              if (weight) {
                const float4 av = ld4(ai + r);
                g = fmaf(av.x, dv.x, g);
                g = fmaf(av.y, dv.y, g);
                g = fmaf(av.z, dv.z, g);
                g = fmaf(av.w, dv.w, g);
              } else {
                g += dv.x;
                g += dv.y;
                g += dv.z;
                g += dv.w;
              }
            }
          }
        }
        const float m1 = one_b1 * g + a.b1 * mu[q];
        const float m2 = one_b2 * (g * g) + a.b2 * nu[q];
        mu[q] = m1;
        nu[q] = m2;
        const float update = (m1 / bc1) / (sqrtf(m2 / bc2) + a.eps);
        params[q] = params[q] + (-a.lr) * update;
      }
      if (t == 0) {
        float batch = 0.f;
        for (int k = 0; k < nwarps; ++k) batch += warp_loss[k];
        epoch_acc += (batch / fmaxf(bw, 1.f)) * bw;
      }
      // the sums above read the warps' row counts, which the next step rewrites
      if (!a.warp_partials) __syncthreads();
    }
    if (t == 0) a.history[slot * a.epochs + e] = epoch_acc / fmaxf(w_total, 1.f);
  }
  __syncthreads();

  if (a.mu) {
    for (int q = t; q < P; q += T) {
      a.mu[slot * P + q] = mu[q];
      a.nu[slot * P + q] = nu[q];
    }
    if (t == 0) a.count[slot] = count;
  }

  for (int l = 0; l < L; ++l) {
    const int nw = a.dims[l] * a.dims[l + 1];
    const int nb = a.dims[l + 1];
    float* W = a.w[l] + slot * nw;
    float* B = a.b[l] + slot * nb;
    for (int e = t; e < nw; e += T) W[e] = params[p_off[l] + e];
    for (int e = t; e < nb; e += T) B[e] = params[p_off[l] + nw + e];
  }
}

extern "C" int fleet_fit_args_size() { return (int)sizeof(FleetFitArgs); }

extern "C" const char* fleet_fit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fleet_fit_launch(const FleetFitArgs* a, int threads, void* stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fleet_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fleet_fit_kernel<<<a->g * a->m, threads, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
