// fake_quant: int8 fake quantisation of the parameter and stats leaves of a
// load, for int8 serving (K10).
//
// Replaces `_fake_quant_int8` (gordo_tpu/serve/precision.py:131), which
// `cast_params` (:142) applies to every float leaf inside the serving
// programs.  The port runs it once, when a model or bucket loads: every
// float leaf of the load in one launch.  Per leaf a (a float32 or bfloat16
// tensor):
//
//   scale = max(max |a|, 1e-12) / 127
//   q     = clip(round(a / scale), -127, 127)     (round half to even)
//   out   = bf16(q * scale)
//
// On a bf16 leaf the JAX program computes in bf16: XLA widens each
// operation to f32 and rounds its result to bf16, so the scale and a /
// scale are rounded to bf16 here too (the product q * scale is exact in
// f32).  NaN propagates as in XLA: a NaN in the leaf makes the scale and
// every output NaN.  A leaf is viewed as (n_outer, groups, cols): the
// `groups` column blocks of its last axis are separate leaves (an LSTM's
// gate blocks, kept apart in the reference's parameter tree), every
// leading axis belongs to the leaf (a bucket's stacked leaf takes one scale
// across its machines, as the reference's bucket path does).  A (leaf,
// group) pair is a unit: one scale.
//
// Bound: each input read once and each output written once (2 bytes):
// bound by bytes, 0.28 us for the 512-machine default bucket's 18 leaves.
// A load is a few kilobytes to a few megabytes, so what a load costs is
// its launches and its latency.
//
// Design: one launch a load (up to FQ_MAX_LEAVES leaves and FQ_MAX_UNITS
// units; the wrapper splits a longer list), a cluster launch of
// FQ_CLUSTER blocks a cluster.  A unit of more than FQ_BIG elements takes
// a whole cluster: each block takes the max-|a| of its eighth, the blocks
// exchange their maxima through distributed shared memory between two
// cluster barriers, and each writes its eighth.  Smaller units take one
// block each, FQ_CLUSTER of them to a cluster.  A thread walks its
// elements with one division in all (no 64-bit division an element).
//
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// FQ_THREADS and FQ_BIG may be set at build time (the wrapper's BIG
// must match FQ_BIG)
#ifndef FQ_THREADS
#define FQ_THREADS 512
#endif
#define FQ_CLUSTER 8
#ifndef FQ_BIG
#define FQ_BIG 4096
#endif
#define FQ_MAX_LEAVES 48
#define FQ_MAX_UNITS 192

// Mirrored field by field by `_Leaf`, `_Unit` and `_Args` in
// gordo_tpu_torch/kernels/fake_quant.py; fake_quant_args_size() lets the
// wrapper check the two agree.
struct QuantLeaf {
  const void* a;              // (n_outer, groups, cols) float or bf16
  __nv_bfloat16* out;         // (n_outer, groups, cols)
  int n_outer;
  int groups;
  int cols;
  int in_bf16;                // 1: a is bfloat16
};

struct QuantUnit {
  int leaf;
  int group;
};

struct FakeQuantArgs {
  int n_leaves;
  int n_units;
  int n_big;  // units [0, n_big) take a cluster each, the rest a block each
  QuantLeaf leaves[FQ_MAX_LEAVES];
  QuantUnit units[FQ_MAX_UNITS];
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// f(i) for each index i of the unit's elements (group g of leaf l) that
// this block takes: all of them, or the `slice`-th FQ_CLUSTER-th of a big
// unit.  Element u of the unit (row u / cols, column u % cols) is found
// by one division a thread; each step of FQ_THREADS elements then moves
// the row and column by constants.
template <typename F>
__device__ __forceinline__ void each_element(const QuantLeaf& l, int g, bool big, int slice, F f) {
  const unsigned cols = (unsigned)l.cols;
  const unsigned count = (unsigned)l.n_outer * cols;
  const unsigned per = big ? (count + FQ_CLUSTER - 1) / FQ_CLUSTER : count;
  const unsigned lo = min(count, slice * per), hi = min(count, lo + per);
  const size_t stride = (size_t)l.groups * cols;  // one row of the leaf
  const unsigned step_rows = FQ_THREADS / cols, step_cols = FQ_THREADS - step_rows * cols;
  unsigned u = lo + threadIdx.x;
  const unsigned row = u / cols;
  unsigned c = u - row * cols;
  size_t i = row * stride + (size_t)g * cols + c;
#pragma unroll 4
  for (; u < hi; u += FQ_THREADS) {
    f(i);
    c += step_cols;
    i += step_rows * stride + step_cols;
    if (c >= cols) {
      c -= cols;
      i += stride - cols;
    }
  }
}

__device__ __forceinline__ float load_elem(const QuantLeaf& l, size_t i) {
  return l.in_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(l.a)[i])
                   : reinterpret_cast<const float*>(l.a)[i];
}

__global__ void __launch_bounds__(FQ_THREADS) fake_quant_kernel(const __grid_constant__ FakeQuantArgs a) {
  __shared__ float part[FQ_THREADS / 32];
  __shared__ float block_max;
  const int cq = blockIdx.x / FQ_CLUSTER, rank = blockIdx.x % FQ_CLUSTER;
  const bool big = cq < a.n_big;
  const int unit = big ? cq : a.n_big + (cq - a.n_big) * FQ_CLUSTER + rank;
  if (!big && unit >= a.n_units) return;  // the last cluster's spare blocks
  const QuantLeaf& l = a.leaves[a.units[unit].leaf];
  const int g = a.units[unit].group;
  float m = 0.f;
  const int slice = big ? rank : 0;
  each_element(l, g, big, slice, [&](size_t i) { m = nan_max(m, fabsf(load_elem(l, i))); });
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = part[0];
    for (int w = 1; w < FQ_THREADS / 32; ++w) b = nan_max(b, part[w]);
    block_max = b;
  }
  if (big) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    m = *cluster.map_shared_rank(&block_max, 0);
    for (int r = 1; r < FQ_CLUSTER; ++r) m = nan_max(m, *cluster.map_shared_rank(&block_max, r));
    cluster.sync();  // no block leaves while another reads its maximum
  } else {
    __syncthreads();
    m = block_max;
  }
  // jnp.maximum keeps NaN; on a bf16 leaf 1e-12 is a bf16 constant
  const float floor_ = l.in_bf16 ? bf16_round(1e-12f) : 1e-12f;
  float s = isnan(m) ? m : fmaxf(m, floor_);
  s = s / 127.f;
  if (l.in_bf16) s = bf16_round(s);
  each_element(l, g, big, slice, [&](size_t i) {
    float d = load_elem(l, i) / s;
    if (l.in_bf16) d = bf16_round(d);
    float q = rintf(d);
    // comparisons keep NaN, as jnp.clip does (fminf/fmaxf would drop it)
    q = q > 127.f ? 127.f : (q < -127.f ? -127.f : q);
    l.out[i] = __float2bfloat16_rn(q * s);
  });
}

extern "C" int fake_quant_args_size() { return (int)sizeof(FakeQuantArgs); }

extern "C" int fake_quant_limits(int which) {
  return which == 0 ? FQ_MAX_LEAVES : which == 1 ? FQ_MAX_UNITS : which == 2 ? FQ_BIG : FQ_CLUSTER;
}

extern "C" const char* fake_quant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fake_quant_launch(const FakeQuantArgs* a, void* stream) {
  if (a->n_units == 0) return 0;
  const int clusters = a->n_big + (a->n_units - a->n_big + FQ_CLUSTER - 1) / FQ_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * FQ_CLUSTER));
  cfg.blockDim = dim3(FQ_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FQ_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fake_quant_kernel, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
