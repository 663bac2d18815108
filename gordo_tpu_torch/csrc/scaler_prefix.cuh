// The chain prefix of the scaler-stat kernels (scaler_stats.cu,
// scaler_quantiles.cu): the maps of a pipeline's earlier scaler steps,
// applied to each value as the kernel loads it, so that step i's stats are
// taken on step i-1's output (gordo_tpu/parallel/anomaly.py:196-214
// `_make_scale_chain`) without writing the transformed rows.
//
// Each step keeps the reference's form and its own roundings: MinMax as
// `x * a + b` (its stats scale and offset), Standard and Robust as
// `(x - a) / b` (mean and std; center and scale).  The intrinsics keep the
// compiler from contracting a multiply and an add into an FMA.  A NaN stays
// NaN.

#pragma once

#include <cuda_runtime.h>

#define SP_MAX_PREFIX 4
#define SP_AFFINE 0
#define SP_CENTER 1

// Mirrored field by field by `_Prefix` in gordo_tpu_torch/kernels/scaler_stats.py.
struct ScalerPrefix {
  int n;                          // earlier steps, 0..SP_MAX_PREFIX
  int form[SP_MAX_PREFIX];        // SP_AFFINE or SP_CENTER
  const float* a[SP_MAX_PREFIX];  // (M, G, F) each
  const float* b[SP_MAX_PREFIX];  // (M, G, F) each
};

// `v` through the prefix's steps; `at` indexes (machine, fit, column) in
// the (M, G, F) stats
__device__ __forceinline__ float prefix_apply(const ScalerPrefix& p, size_t at, float v) {
  for (int i = 0; i < p.n; ++i) {
    const float pa = __ldg(p.a[i] + at);
    const float pb = __ldg(p.b[i] + at);
    v = p.form[i] == SP_AFFINE ? __fadd_rn(__fmul_rn(v, pa), pb)
                               : __fdiv_rn(__fsub_rn(v, pa), pb);
  }
  return v;
}
