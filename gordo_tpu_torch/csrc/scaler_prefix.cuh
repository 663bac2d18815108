// A pipeline's scaler chain, applied step by step to each value as a
// kernel loads it, each step in its own form (gordo_tpu/parallel/
// anomaly.py:196-224 `_make_scale_chain`, `_make_apply_chain`;
// gordo_tpu/ops/scalers.py:148,180,220 the steps' `apply`).
//
// The stat kernels (scaler_stats.cu, scaler_quantiles.cu) take the steps
// before the one whose stats they compute (at most SP_MAX_PREFIX), so that
// step i's stats are taken on step i-1's output without writing the
// transformed rows.  The kernels that load scaled rows take the whole
// chain: fleet_fit.cu, fleet_score.cu, stream_step.cu and the first layer
// of lstm_layer.cu and lstm_layer_bwd.cu; fleet_score.cu and
// stream_step.cu also take the detector scaler as a chain of one step, on
// the prediction and the target alike (gordo_tpu/anomaly/diff.py:41-48).
// Folding a chain into one `x * scale + offset` would cancel on a column
// whose level is large against its spread (a pressure of 100 +- 1, a
// temperature in kelvin), where each step in turn rounds as the reference
// does.
//
// Each step keeps the reference's form and its own roundings: MinMax as
// `x * a + b` (its stats scale and offset), Standard and Robust as
// `(x - a) / b` (mean and std; center and scale).  The intrinsics fix each
// rounding.  An AFFINE step is one FMA (`__fmaf_rn`): every XLA program
// that applies a MinMax step fuses its `x * scale + offset` into one
// (XLA:CPU emits the product and the sum in one loop fusion and contracts
// them), as measured bit for bit on the CPU for each path the kernels
// take: the stats of a later step in `fleet.exact` and `fleet.padded`,
// the fits' scaled rows, the LSTM fleet build's windows and the LSTM
// served by `serve.score` (tests/test_torch_uncentred_chain.py,
// tests/test_torch_affine_rounding.py).  The single path and the generic
// fleet API transform their rows eagerly, two roundings as the JAX single
// path takes them, and give the kernels no chain.  A NaN stays NaN.
//
// The stats are (M, G, F) for the stat kernels and the fits (one set per
// machine and fit), (M, F) for the serving kernels, at the kernel's
// storage type T (float, or __nv_bfloat16 for reduced-precision serving,
// widened as loaded); `at` indexes a value's stats.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "storage.cuh"

#define SP_MAX_STEPS 5
#define SP_MAX_PREFIX (SP_MAX_STEPS - 1)
#define SP_AFFINE 0
#define SP_CENTER 1

// Mirrored field by field by `ScalerChain` in gordo_tpu_torch/kernels/scaler_stats.py.
struct ScalerPrefix {
  int n;                         // steps, 0..SP_MAX_STEPS (0: the identity)
  int form[SP_MAX_STEPS];        // SP_AFFINE or SP_CENTER
  const void* a[SP_MAX_STEPS];   // T, (M, G, F) or (M, F) each
  const void* b[SP_MAX_STEPS];   // T
};

// one step of form `form` with stats `pa`, `pb`
__device__ __forceinline__ float step_apply(int form, float v, float pa, float pb) {
  if (form == SP_AFFINE) return __fmaf_rn(v, pa, pb);
  return __fdiv_rn(__fsub_rn(v, pa), pb);
}

// `v` through the chain's steps, `at` the index of its stats
template <typename T = float>
__device__ __forceinline__ float prefix_apply(const ScalerPrefix& p, size_t at, float v) {
  for (int i = 0; i < p.n; ++i)
    v = step_apply(p.form[i], v, ld(static_cast<const T*>(p.a[i]) + at),
                   ld(static_cast<const T*>(p.b[i]) + at));
  return v;
}

// body(apply), `apply(at, v)` the chain's map of `v` with the stats at
// `at`, chosen once, outside body's loops: no step (the identity), one
// AFFINE step (a MinMax alone: the default pipeline's chain, its two
// pointers in registers), or the step loop above, so that the loop's
// registers and its division stay off the common chains' path (the loop
// in their path, rolled or unrolled, cost the serving kernels registers
// and time on the H100: PERF.md).
template <typename T, typename Body>
__device__ __forceinline__ void with_chain(const ScalerPrefix& p, Body body) {
  if (p.n == 0) {
    body([](size_t, float v) { return v; });
  } else if (p.n == 1 && p.form[0] == SP_AFFINE) {
    const T* A = static_cast<const T*>(p.a[0]);
    const T* B = static_cast<const T*>(p.b[0]);
    body([=](size_t at, float v) { return step_apply(SP_AFFINE, v, ld(A + at), ld(B + at)); });
  } else {
    body([&](size_t at, float v) { return prefix_apply<T>(p, at, v); });
  }
}

// A stat kernel's row list: the row list's indices in device memory, or,
// where every row list of a launch is a range of consecutive rows (a
// TimeSeriesSplit fold, the whole series), none (`idx` null: row i is
// `start + i`, so no index is uploaded or loaded)
struct RowList {
  const int* idx;
  int start;
  __device__ __forceinline__ int operator[](int i) const { return idx ? __ldg(idx + i) : start + i; }
};

// fit `fit`'s row list from a launch's `rows` (null for ranges) and its
// offset into them (the range's first row for ranges)
__device__ __forceinline__ RowList row_list(const int* rows, int off) {
  return {rows ? rows + off : nullptr, off};
}

// body(form) with `decltype(form)::value` a compile-time step form equal
// to `form_value`, so that a loop over one step's map carries only its
// own form's code
template <typename Body>
__device__ __forceinline__ void with_form(int form_value, Body body) {
  if (form_value == SP_AFFINE)
    body(std::integral_constant<int, SP_AFFINE>());
  else
    body(std::integral_constant<int, SP_CENTER>());
}
