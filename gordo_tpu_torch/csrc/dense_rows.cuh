// The per-row body that fleet_score.cu and stream_step.cu share: loads at
// the storage type, the pipeline's scaler steps (scaler_prefix.cuh), the
// dense stack over a tile of
// rows in shared memory, the detector's tag score, the L2 total and the
// confidence's threshold.  Both kernels include this one copy, so a
// streamed verdict is computed by the same instructions as the request
// path's scores (which is what makes the two bit for bit equal).
//
// Storage types (storage.cuh): float, or __nv_bfloat16 for
// reduced-precision serving; every value is widened to float as it is
// loaded, and all arithmetic and shared memory are float.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "activations.cuh"
#include "copy_async.cuh"
#include "scaler_prefix.cuh"
#include "storage.cuh"

#define DR_MAX_LAYERS 16
#define DR_THREADS 256
#define DR_RPT 4

// Calls body(q, c) for each pair of [0, nq) x [0, nc) that falls to this
// thread when the block's threads walk the pairs in row-major order (c
// fastest, so neighbouring threads touch neighbouring addresses).  The
// pair advances by DR_THREADS without a division per step.
template <typename Body>
__device__ __forceinline__ void walk2d(int nq, int nc, Body body) {
  int q = threadIdx.x / nc;
  int c = threadIdx.x - q * nc;
  const int dq = DR_THREADS / nc;
  const int dc = DR_THREADS - dq * nc;
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

// the chain's layers: W (M, dims[l], dims[l+1]) and b (M, dims[l+1]) at
// the storage type, one activation code each
struct DenseChain {
  const void* w[DR_MAX_LAYERS];
  const void* b[DR_MAX_LAYERS];
  int n_layers;
  int dims[DR_MAX_LAYERS + 1];
  int act[DR_MAX_LAYERS];
  int weights_resident;  // 1: all layers sit in shared memory at once
};

// all layers' W then b of machine `mach` into wbuf, layer after layer
template <typename T>
__device__ __forceinline__ void dense_load_resident(const DenseChain& ch, int mach, float* wbuf) {
  int off = 0;
  for (int l = 0; l < ch.n_layers; ++l) {
    const int nw = ch.dims[l] * ch.dims[l + 1];
    const int nb = ch.dims[l + 1];
    const T* W = static_cast<const T*>(ch.w[l]) + (size_t)mach * nw;
    const T* B = static_cast<const T*>(ch.b[l]) + (size_t)mach * nb;
#pragma unroll 4
    for (int e = threadIdx.x; e < nw; e += DR_THREADS) wbuf[off + e] = ld(W + e);
    for (int e = threadIdx.x; e < nb; e += DR_THREADS) wbuf[off + nw + e] = ld(B + e);
    off += nw + nb;
  }
}

// dense_load_resident for float weights by cp.async: the copies do not
// wait, so every layer's are in flight at once; the caller commits and
// waits (copy_async.cuh) before its barrier
__device__ __forceinline__ void dense_copy_resident(const DenseChain& ch, int mach, float* wbuf) {
  int off = 0;
  for (int l = 0; l < ch.n_layers; ++l) {
    const int nw = ch.dims[l] * ch.dims[l + 1];
    const int nb = ch.dims[l + 1];
    const float* W = static_cast<const float*>(ch.w[l]) + (size_t)mach * nw;
    const float* B = static_cast<const float*>(ch.b[l]) + (size_t)mach * nb;
    for (int e = threadIdx.x; e < nw; e += DR_THREADS) copy_async(wbuf + off + e, W + e);
    for (int e = threadIdx.x; e < nb; e += DR_THREADS) copy_async(wbuf + off + nw + e, B + e);
    off += nw + nb;
  }
}

// The dense stack of machine `mach` over the R rows (a multiple of DR_RPT)
// of `in` (row stride D); activations ping-pong between `in` and `out`.
// Starts with a barrier, so the caller's writes to `in` (and, resident,
// to wbuf) need none of their own; returns the buffer holding the last
// layer's output, which the caller reads after a barrier.  Each thread
// computes DR_RPT rows of one output column, reusing each weight DR_RPT
// times; a streamed chain loads each layer into wbuf in turn.
template <typename T>
__device__ __forceinline__ float* dense_rows(const DenseChain& ch, int mach, float* wbuf, float* in,
                                             float* out, int R, int D) {
  const int groups = R / DR_RPT;
  int woff = 0;
  for (int l = 0; l < ch.n_layers; ++l) {
    const int din = ch.dims[l];
    const int dout = ch.dims[l + 1];
    const int code = ch.act[l];
    __syncthreads();  // `in` written; streamed: earlier readers of wbuf done
    if (!ch.weights_resident) {
      const T* W = static_cast<const T*>(ch.w[l]) + (size_t)mach * din * dout;
      const T* B = static_cast<const T*>(ch.b[l]) + (size_t)mach * dout;
#pragma unroll 4
      for (int e = threadIdx.x; e < din * dout; e += DR_THREADS) wbuf[e] = ld(W + e);
      for (int e = threadIdx.x; e < dout; e += DR_THREADS) wbuf[din * dout + e] = ld(B + e);
      __syncthreads();
    }
    const float* wl = wbuf + woff;
    walk2d(groups, dout, [&](int g, int j) {
      const float* arow = in + g * DR_RPT * D;
      float acc[DR_RPT];
#pragma unroll
      for (int r = 0; r < DR_RPT; ++r) acc[r] = 0.f;
      for (int k = 0; k < din; ++k) {
        const float w = wl[k * dout + j];
#pragma unroll
        for (int r = 0; r < DR_RPT; ++r) acc[r] = fmaf(arow[r * D + k], w, acc[r]);
      }
      const float bj = wl[din * dout + j];
      float* orow = out + g * DR_RPT * D;
#pragma unroll
      for (int r = 0; r < DR_RPT; ++r) orow[r * D + j] = act_fn(code, acc[r] + bj);
    });
    if (ch.weights_resident) woff += din * dout + dout;
    float* t = in;
    in = out;
    out = t;
  }
  return in;
}

// One row `in` through the dense stack of machine `mach` by the calling
// warp alone, a warp barrier between layers: each lane computes outputs
// j = lane, lane + 32, ... by the FMAs dense_rows runs for a row of its
// tile, in the same order, so the row's outputs are dense_rows' bit for
// bit.  `in` and `out` hold max_dim floats; with the weights not resident
// the warp loads each layer into wbuf in turn.  Returns the buffer holding
// the last layer's output, which the warp reads after a warp barrier.
template <typename T>
__device__ __forceinline__ float* warp_dense_row(const DenseChain& ch, int mach, float* wbuf, float* in,
                                                 float* out) {
  const int lane = threadIdx.x & 31;
  int woff = 0;
  for (int l = 0; l < ch.n_layers; ++l) {
    const int din = ch.dims[l];
    const int dout = ch.dims[l + 1];
    const int code = ch.act[l];
    if (!ch.weights_resident) {
      const T* W = static_cast<const T*>(ch.w[l]) + (size_t)mach * din * dout;
      const T* B = static_cast<const T*>(ch.b[l]) + (size_t)mach * dout;
      for (int e = lane; e < din * dout; e += 32) wbuf[e] = ld(W + e);
      for (int e = lane; e < dout; e += 32) wbuf[din * dout + e] = ld(B + e);
    }
    __syncwarp();  // `in` written; streamed: this layer's weights loaded
    const float* wl = wbuf + woff;
    for (int j = lane; j < dout; j += 32) {
      float acc = 0.f;
      for (int k = 0; k < din; ++k) acc = fmaf(in[k], wl[k * dout + j], acc);
      out[j] = act_fn(code, acc + wl[din * dout + j]);
    }
    __syncwarp();  // `out` written; streamed: the readers of wbuf done
    if (ch.weights_resident) woff += din * dout + dout;
    float* t = in;
    in = out;
    out = t;
  }
  return in;
}

// The detector's score of one tag, its scaler a step of `form` with stats
// a, b applied to the prediction and the target alike: |d(p) - d(y)|, a
// MinMax as one FMA each, as XLA:CPU fuses `anomaly.scores`' `y * scale +
// offset`; a Standard or Robust scaler as (v - a) / b.
__device__ __forceinline__ float tag_score(int form, float p, float y, float a, float b) {
  return fabsf(__fsub_rn(step_apply(form, p, a, b), step_apply(form, y, a, b)));
}

// The L2 norm of a row's fo squared tag scores `sq`, summed from the tag
// given by the row's index in its slot (`row`), so neighbouring rows read
// different banks and a row's sum does not depend on how rows are tiled.
__device__ __forceinline__ float row_l2(const float* sq, int fo, int row) {
  float s = 0.f;
  int j = row % fo;
  for (int n = 0; n < fo; ++n) {
    s += sq[j];
    if (++j == fo) j = 0;
  }
  return sqrtf(s);
}

// row_l2 of a row whose fo tag scores lie `stride` apart (`tags[j *
// stride]`): the same additions in the same order, each square rounded
// before it is added as row_l2's stored squares are, so a total computed
// from carried tag scores is row_l2's bit for bit.
__device__ __forceinline__ float tags_l2(const float* tags, int stride, int fo, int row) {
  float s = 0.f;
  int j = row % fo;
  for (int n = 0; n < fo; ++n) {
    const float t = tags[(size_t)j * stride];
    s = __fadd_rn(s, __fmul_rn(t, t));
    if (++j == fo) j = 0;
  }
  return sqrtf(s);
}

// The confidence's divisor: max(threshold, 1e-12), NaN kept (jnp.maximum).
__device__ __forceinline__ float conf_divisor(float t) { return isnan(t) ? t : fmaxf(t, 1e-12f); }
