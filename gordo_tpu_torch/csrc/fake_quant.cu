// fake_quant: int8 fake quantisation of one parameter or stats leaf, for
// int8 serving (K10).
//
// Replaces `_fake_quant_int8` (gordo_tpu/serve/precision.py:131), which
// `cast_params` (:142) applies to every float leaf inside the serving
// programs.  The port runs it once, when a model or bucket loads.  Per
// leaf a (a float32 or bfloat16 tensor):
//
//   scale = max(max |a|, 1e-12) / 127
//   q     = clip(round(a / scale), -127, 127)     (round half to even)
//   out   = bf16(q * scale)
//
// On a bf16 leaf the JAX program computes in bf16: XLA widens each
// operation to f32 and rounds its result to bf16, so the scale and a /
// scale are rounded to bf16 here too (the product q * scale is exact in
// f32).  NaN propagates as in XLA: a NaN in the leaf makes the scale and
// every output NaN.  The input is viewed as (n_outer, groups, cols): the
// `groups` column blocks of its last axis are separate leaves (an LSTM's
// gate blocks, kept apart in the reference's parameter tree), every
// leading axis belongs to the leaf (a bucket's stacked leaf takes one scale
// across its machines, as the reference's bucket path does).
//
// Bound: it reads each input once for the maximum and once more for the
// output (from L2 at these sizes) and writes 2 bytes each: bound by bytes.
//
// Design: one block per group: a strided max-|a| with a warp-shuffle
// reduction, then an elementwise pass over the same elements.  Leaves are
// at most a few hundred thousand elements, and it runs at load time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define FQ_THREADS 1024

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/fake_quant.py;
// fake_quant_args_size() lets the wrapper check the two agree.
struct FakeQuantArgs {
  const void* a;           // (n_outer, groups, cols) float or bf16
  __nv_bfloat16* out;      // (n_outer, groups, cols)
  long long n_outer;
  int groups;
  int cols;
  int in_bf16;             // 1: a is bfloat16
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_elem(const FakeQuantArgs& a, size_t i) {
  return a.in_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.a)[i])
                   : reinterpret_cast<const float*>(a.a)[i];
}

__global__ void __launch_bounds__(FQ_THREADS) fake_quant_kernel(const FakeQuantArgs a) {
  __shared__ float part[FQ_THREADS / 32];
  const int g = blockIdx.x;
  const long long n = a.n_outer * a.cols;
  const size_t row_stride = (size_t)a.groups * a.cols;
  float m = 0.f;
  for (long long e = threadIdx.x; e < n; e += FQ_THREADS) {
    const long long o = e / a.cols;
    const int c = (int)(e - o * a.cols);
    m = nan_max(m, fabsf(load_elem(a, o * row_stride + (size_t)g * a.cols + c)));
  }
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
  for (int w = 1; w < FQ_THREADS / 32; ++w) m = nan_max(m, part[w]);
  // jnp.maximum keeps NaN; on a bf16 leaf 1e-12 is a bf16 constant
  const float floor_ = a.in_bf16 ? bf16_round(1e-12f) : 1e-12f;
  float s = isnan(m) ? m : fmaxf(m, floor_);
  s = s / 127.f;
  if (a.in_bf16) s = bf16_round(s);
  for (long long e = threadIdx.x; e < n; e += FQ_THREADS) {
    const long long o = e / a.cols;
    const int c = (int)(e - o * a.cols);
    const size_t i = o * row_stride + (size_t)g * a.cols + c;
    float d = load_elem(a, i) / s;
    if (a.in_bf16) d = bf16_round(d);
    float q = rintf(d);
    // comparisons keep NaN, as jnp.clip does (fminf/fmaxf would drop it)
    q = q > 127.f ? 127.f : (q < -127.f ? -127.f : q);
    a.out[i] = __float2bfloat16_rn(q * s);
  }
}

extern "C" int fake_quant_args_size() { return (int)sizeof(FakeQuantArgs); }

extern "C" const char* fake_quant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fake_quant_launch(const FakeQuantArgs* a, void* stream) {
  fake_quant_kernel<<<a->groups, FQ_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
