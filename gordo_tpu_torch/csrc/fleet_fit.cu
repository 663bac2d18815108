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
// previous one's weights.
//
// Design: one block per (fit, machine), for the block's whole life.  The
// machine's weights, its Adam moments (3 x 417 floats at the default
// width) and the current minibatch's activations and deltas stay in
// shared memory across every step; nothing but the rows, the state in
// and out and the final weights touches device memory.  A step is:
//   1. each thread takes one row of the minibatch; the rows of nonzero
//      weight are packed to the front (ballot + per-warp counts), so the
//      reductions below run over them only, and their weights are summed
//      (per warp, then the warps in order);
//   2. each thread runs its row's forward pass, loss and backward deltas
//      alone (no barrier between layers: a row depends on nothing else);
//   3. after one barrier, each thread owns some of the weights: it sums
//      their gradient over the minibatch's rows and applies Adam in place.
// Two barriers per step.  Row storage has an odd stride, so the threads of
// a warp (one row each) hit distinct banks.  The pipeline's scaler steps
// apply to each value as it loads, each in its own form (scaler_prefix.cuh;
// a MinMax step one FMA, as XLA's fleet program fuses its `X * scale +
// offset`), so the transformed rows are never written.

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
  int row_stride;   // floats of shared memory per minibatch row (odd)
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

__global__ void fleet_fit_kernel(const FleetFitArgs a) {
  extern __shared__ float smem[];
  const int fit = blockIdx.x;
  const int mach = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int L = a.n_layers;
  const int P = a.n_params;
  const int F = a.dims[0];
  const int Fo = a.dims[L];
  const size_t slot = (size_t)mach * a.g + fit;
  const int n = a.counts[slot];
  const int bs = a.fit_bs[fit];
  const int steps = a.fit_steps[fit];
  const int n_total = steps * bs;
  const int d = a.draw[mach];
  const size_t pslot = a.params_per_fit ? (size_t)d * a.g + fit : (size_t)d;

  float* params = smem;                       // P: W0, b0, W1, b1, ...
  float* mu = params + P;                     // P
  float* nu = mu + P;                         // P
  int* warp_cnt = (int*)(nu + P);             // FF_MAX_WARPS
  float* warp_loss = (float*)(warp_cnt + FF_MAX_WARPS);  // FF_MAX_WARPS
  float* warp_w = warp_loss + FF_MAX_WARPS;   // FF_MAX_WARPS
  float* rowbuf = warp_w + FF_MAX_WARPS;      // blockDim.x x row_stride

  // per-row layout: [inputs of layers 0..L-1 | outputs' deltas of layers 0..L-1]
  int a_off[FF_MAX_LAYERS], d_off[FF_MAX_LAYERS], p_off[FF_MAX_LAYERS];
  {
    int sa = 0, po = 0;
    for (int l = 0; l < L; ++l) {
      a_off[l] = sa;
      sa += a.dims[l];
      p_off[l] = po;
      po += a.dims[l] * a.dims[l + 1] + a.dims[l + 1];
    }
    int sd = sa;
    for (int l = 0; l < L; ++l) {
      d_off[l] = sd;
      sd += a.dims[l + 1];
    }
  }

  for (int l = 0; l < L; ++l) {
    const int nw = a.dims[l] * a.dims[l + 1];
    const int nb = a.dims[l + 1];
    const float* W = a.w0[l] + pslot * nw;
    const float* B = a.b0[l] + pslot * nb;
    for (int e = t; e < nw; e += blockDim.x) params[p_off[l] + e] = W[e];
    for (int e = t; e < nb; e += blockDim.x) params[p_off[l] + nw + e] = B[e];
  }
  for (int q = t; q < P; q += blockDim.x) {
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
    for (int p = t; p < n; p += blockDim.x) part += __ldg(wm + rows[p]);
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
  int count = a.count0 ? a.count0[slot] : 0;

  for (int e = 0; e < a.epochs; ++e) {
    float epoch_acc = 0.f;  // thread 0's
    for (int s = 0; s < steps; ++s) {
      // 1. which rows are real (weight != 0), packed to the front
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
      __syncthreads();  // last step's Adam done; counts visible
      int base = 0, cnt = 0;
      float bw = 0.f;  // the minibatch's sum of weights (cnt for 0/1 weights)
      for (int k = 0; k < nwarps; ++k) {
        const int c = warp_cnt[k];
        if (k < warp) base += c;
        cnt += c;
        bw += warp_w[k];
      }

      // 2. this thread's row: forward, loss, backward deltas
      float row_loss = 0.f;
      if (valid) {
        float* R = rowbuf + (size_t)(base + __popc(ballot & ((1u << lane) - 1u))) * a.row_stride;
        const int src = rows[p];
        const float* xr = xm + (size_t)src * F;
        with_chain<float>(a.chain, [&](auto apply) {
          for (int j = 0; j < F; ++j) R[j] = apply(at + j, __ldg(xr + j));
        });
        for (int l = 0; l < L; ++l) {
          const int din = a.dims[l], dout = a.dims[l + 1];
          const float* W = params + p_off[l];
          const float* B = W + din * dout;
          const float* in = R + a_off[l];
          float* out = l + 1 < L ? R + a_off[l + 1] : R + d_off[L - 1];
          for (int j = 0; j < dout; ++j) {
            float acc = 0.f;
            for (int i = 0; i < din; ++i) acc = fmaf(in[i], W[i * dout + j], acc);
            out[j] = act_fn(a.act[l], acc + B[j]);
          }
        }
        // mse and its gradient: ((w / max(sum w, 1)) / Fo) * (2 * (pred - y))
        float* pred = R + d_off[L - 1];
        const float* yr = ym + (size_t)src * Fo;
        const float coef = ((1.f / fmaxf(bw, 1.f)) * wr) * inv_fo;
        float sq = 0.f;
        for (int j = 0; j < Fo; ++j) {
          const float diff = pred[j] - __ldg(yr + j);
          sq += diff * diff;
          pred[j] = act_grad(a.act[L - 1], coef * (2.f * diff), pred[j]);
        }
        row_loss = (sq * inv_fo) * wr;
        for (int l = L - 1; l >= 1; --l) {
          const int din = a.dims[l], dout = a.dims[l + 1];
          const float* W = params + p_off[l];
          const float* dl = R + d_off[l];
          const float* act_in = R + a_off[l];
          float* dprev = R + d_off[l - 1];
          for (int i = 0; i < din; ++i) {
            float acc = 0.f;
            for (int j = 0; j < dout; ++j) acc = fmaf(W[i * dout + j], dl[j], acc);
            dprev[i] = act_grad(a.act[l - 1], acc, act_in[i]);
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) row_loss += __shfl_down_sync(0xffffffffu, row_loss, o);
      if (lane == 0) warp_loss[warp] = row_loss;
      __syncthreads();  // every row's activations and deltas stored

      // 3. gradient of each owned weight over the real rows, then Adam
      ++count;
      const float bc1 = 1.f - powf(a.b1, (float)count);
      const float bc2 = 1.f - powf(a.b2, (float)count);
      int l = 0;
      for (int q = t; q < P; q += blockDim.x) {
        while (l + 1 < L && q >= p_off[l + 1]) ++l;
        const int din = a.dims[l], dout = a.dims[l + 1];
        const int k = q - p_off[l];
        float g = 0.f;
        if (k < din * dout) {
          const float* ai = rowbuf + a_off[l] + k / dout;
          const float* dj = rowbuf + d_off[l] + k % dout;
          for (int r = 0; r < cnt; ++r)
            g = fmaf(ai[(size_t)r * a.row_stride], dj[(size_t)r * a.row_stride], g);
        } else {
          const float* dj = rowbuf + d_off[l] + (k - din * dout);
          for (int r = 0; r < cnt; ++r) g += dj[(size_t)r * a.row_stride];
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
    }
    if (t == 0) a.history[slot * a.epochs + e] = epoch_acc / fmaxf(w_total, 1.f);
  }
  __syncthreads();

  if (a.mu) {
    for (int q = t; q < P; q += blockDim.x) {
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
    for (int e = t; e < nw; e += blockDim.x) W[e] = params[p_off[l] + e];
    for (int e = t; e < nb; e += blockDim.x) B[e] = params[p_off[l] + nw + e];
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
  dim3 grid(a->g, a->m);
  fleet_fit_kernel<<<grid, threads, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
