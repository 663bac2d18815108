// Activation functions of the port's kernels, with flax semantics: gelu is
// the tanh approximation, leaky_relu has slope 0.01, elu has alpha 1.  The
// codes are ACT_CODES in gordo_tpu_torch/kernels/fleet_score.py.  Accurate
// expf/tanhf throughout (no fast-math intrinsics).

#pragma once

#include <math.h>

enum {
  ACT_LINEAR = 0,
  ACT_TANH = 1,
  ACT_RELU = 2,
  ACT_SIGMOID = 3,
  ACT_ELU = 4,
  ACT_SELU = 5,
  ACT_SOFTPLUS = 6,
  ACT_LEAKY_RELU = 7,
  ACT_GELU = 8,
};

// jax.nn.sigmoid
__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float act_fn(int code, float x) {
  switch (code) {
    case ACT_TANH:
      return tanhf(x);
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_SIGMOID:
      return sigmoid_f(x);
    case ACT_ELU:
      return x > 0.f ? x : expm1f(x);
    case ACT_SELU:
      return 1.0507009873554804934193349852946f *
             (x > 0.f ? x : 1.6732632423543772848170429916717f * expm1f(x));
    case ACT_SOFTPLUS:
      return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    case ACT_LEAKY_RELU:
      return x >= 0.f ? x : 0.01f * x;
    case ACT_GELU:  // tanh approximation, flax's default
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    default:
      return x;
  }
}
