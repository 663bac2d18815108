// chain_apply: a pipeline's transform steps applied to request or training
// rows, (n, F) -> (n, F'), each step in the reference's own form and order.
//
// Replaces the eager jnp transforms of the JAX package's single-machine
// path (gordo_tpu/pipeline.py:61-64 `_transform_until_final`, and the same
// steps inside `serve.score`, gordo_tpu/serve/scorer.py:240-241):
//
//   AFFINE    MinMax                 x * a + b
//   CENTER    Standard, Robust       (x - a) / b
//   IMPUTE    SimpleImputer          isnan(x) ? a : x          (ops/scalers.py:303-305)
//   MUL, ADD  multiplier, adder      x * c, x + c              (ops/transformer_funcs.py:11-20)
//   LOG1P, EXPM1                     log1p(x), expm1(x)        (:22-25)
//   PCA       PCA                    (x - a) @ C^T, F -> k     (ops/scalers.py:338-340;
//                                    b holds C^T, (F, k), so that the
//                                    threads of a row's outputs read
//                                    neighbouring components)
//   QUANTILE  QuantileTransformer    jnp.interp(x, grid_col, qs) per column,
//                                    then for a normal output
//                                    ndtri(clip(u, 1e-6, 1 - 1e-6))  (:248-260)
//
// Each step rounds as the JAX package's eager step does on XLA:CPU: the
// separate operations with the intrinsics that forbid contraction, and an
// FMA exactly where XLA:CPU fuses one (jnp.interp's `fp[i-1] + (delta / dx)
// * df`, and `y * x + p` in jnp.polyval inside jax.scipy.special._ndtri;
// both measured bit for bit against the JAX package on the CPU).  The
// interpolation follows jax._src.numpy.lax_numpy._interp:
//
//   i = clip(searchsorted(xp, x, side='right'), 1, Q - 1)   (NaN x: i = Q - 1)
//   dx = xp[i] - xp[i-1]; |dx| <= spacing(eps_f32) takes fp[i-1] (tied grid
//   values, the common case on quantised sensors), else fp[i-1] + (delta /
//   dx) * df; x < xp[0] gives fp[0] and x > xp[Q-1] gives fp[Q-1].
//
// so a NaN x gives fp[Q-2] when the grid's last two entries tie, else NaN, as
// the reference does.  `qs` is jnp.linspace(0, 1, Q) as XLA computes it,
// carried from the host.  ndtri follows jax._src.scipy.special._ndtri's
// Cephes branches with its float32 constants; log and sqrt are CUDA's logf
// (1 ulp) and the correctly rounded square root.
//
// Bound: each input value is read once and each output written once; a
// quantile step reads O(log Q) grid entries per value from the L1/L2
// cache, a PCA step does 2 F k operations per row.  At the widths of the
// main path (F <= 128) this is bound by device memory.
//
// Design: one block per tile of CA_ROWS rows.  The tile is loaded into
// shared memory (coalesced: the rows are contiguous) and every step runs on
// it there, all threads striding over the tile's (row, column) values; a
// PCA step writes its k outputs per row into the second buffer, and the
// buffers swap.  The steps' stats stay in global memory, read through the
// read-only cache: a quantile grid of Q <= 1,000 entries per column would
// not fit a block's shared memory at 128 columns.  The last buffer is
// written out coalesced.  Steps run in order with a barrier between them.

#include <cuda_runtime.h>
#include <math.h>

#define CA_MAX_STEPS 8
#define CA_THREADS 256
#define CA_ROWS 32
#define CA_MAX_WIDTH 128
#define CA_MAX_Q 1000

#define CA_AFFINE 0
#define CA_CENTER 1
#define CA_IMPUTE 2
#define CA_MUL 3
#define CA_ADD 4
#define CA_LOG1P 5
#define CA_EXPM1 6
#define CA_PCA 7
#define CA_QUANTILE 8

// Mirrored field by field by `_Step` in gordo_tpu_torch/kernels/chain_apply.py.
struct ChainStep {
  int form;
  int width_in;
  int width_out;
  int q;           // QUANTILE: grid entries
  int normal;      // QUANTILE: output_distribution == "normal"
  float c;         // MUL, ADD: the constant
  const float* a;  // AFFINE/CENTER: (F,) scale or mean; IMPUTE: fill; PCA: mean; QUANTILE: grid (Q, F)
  const float* b;  // AFFINE/CENTER: (F,) offset or std; PCA: components^T (F, k); QUANTILE: qs (Q,)
};

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/chain_apply.py.
struct ChainApplyArgs {
  const float* x;  // (n, f)
  float* out;      // (n, f_out)
  int n;
  int f;
  int f_out;
  int max_width;
  int n_steps;
  ChainStep steps[CA_MAX_STEPS];
};

// jnp.polyval's Horner loop, whose `y * x + p` XLA:CPU fuses into an FMA
__device__ __forceinline__ float polyval(const float* c, int n, float x) {
  float y = 0.f;
  for (int i = 0; i < n; ++i) y = __fmaf_rn(y, x, c[i]);
  return y;
}

// the Cephes constants of jax._src.scipy.special._ndtri, as its
// np.array(..., dtype=float32) rounds the doubles
__constant__ float CA_P0[5] = {(float)-5.99633501014107895267E1, (float)9.80010754185999661536E1,
                           (float)-5.66762857469070293439E1, (float)1.39312609387279679503E1,
                           (float)-1.23916583867381258016E0};
__constant__ float CA_Q0[9] = {1.0f, (float)1.95448858338141759834E0, (float)4.67627912898881538453E0,
                           (float)8.63602421390890590575E1, (float)-2.25462687854119370527E2,
                           (float)2.00260212380060660359E2, (float)-8.20372256168333339912E1,
                           (float)1.59056225126211695515E1, (float)-1.18331621121330003142E0};
__constant__ float CA_P1[9] = {(float)4.05544892305962419923E0, (float)3.15251094599893866154E1,
                           (float)5.71628192246421288162E1, (float)4.40805073893200834700E1,
                           (float)1.46849561928858024014E1, (float)2.18663306850790267539E0,
                           (float)-1.40256079171354495875E-1, (float)-3.50424626827848203418E-2,
                           (float)-8.57456785154685413611E-4};
__constant__ float CA_Q1[9] = {1.0f, (float)1.57799883256466749731E1, (float)4.53907635128879210584E1,
                           (float)4.13172038254672030440E1, (float)1.50425385692907503408E1,
                           (float)2.50464946208309415979E0, (float)-1.42182922854787788574E-1,
                           (float)-3.80806407691578277194E-2, (float)-9.33259480895457427372E-4};
__constant__ float CA_P2[9] = {(float)3.23774891776946035970E0, (float)6.91522889068984211695E0,
                           (float)3.93881025292474443415E0, (float)1.33303460815807542389E0,
                           (float)2.01485389549179081538E-1, (float)1.23716634817820021358E-2,
                           (float)3.01581553508235416007E-4, (float)2.65806974686737550832E-6,
                           (float)6.23974539184983293730E-9};
__constant__ float CA_Q2[9] = {1.0f, (float)6.02427039364742014255E0, (float)3.67983563856160859403E0,
                           (float)1.37702099489081330271E0, (float)2.16236993594496635890E-1,
                           (float)1.34204006088543189037E-2, (float)3.28014464682127739104E-4,
                           (float)2.89247864745380683936E-6, (float)6.79019408009981274425E-9};

// jax._src.scipy.special._ndtri in float32
__device__ float ndtri(float p) {
  const float one_minus_exp_m2 = (float)0.8646647167633873;  // -expm1(-2) and 1 - exp(-2)
  const float exp_m2 = (float)0.1353352832366127;
  const float sqrt_2pi = (float)2.5066282746310002;
  const float mcp = p > one_minus_exp_m2 ? __fsub_rn(1.0f, p) : p;
  const float s = mcp == 0.0f ? 0.5f : mcp;
  float x;
  if (s > exp_m2) {
    const float w = __fsub_rn(s, 0.5f);
    const float ww = __fmul_rn(w, w);
    const float r = __fdiv_rn(polyval(CA_P0, 5, ww), polyval(CA_Q0, 9, ww));
    x = __fmul_rn(__fadd_rn(w, __fmul_rn(__fmul_rn(w, ww), r)), -sqrt_2pi);
  } else {
    const float z = __fsqrt_rn(__fmul_rn(-2.0f, logf(s)));
    const float first = __fsub_rn(z, __fdiv_rn(logf(z), z));
    const float iz = __fdiv_rn(1.0f, z);
    const float second = z >= 8.0f ? __fdiv_rn(__fdiv_rn(polyval(CA_P2, 9, iz), polyval(CA_Q2, 9, iz)), z)
                                   : __fdiv_rn(__fdiv_rn(polyval(CA_P1, 9, iz), polyval(CA_Q1, 9, iz)), z);
    x = __fsub_rn(first, second);
  }
  x = p > one_minus_exp_m2 ? x : -x;
  if (p == 0.0f) return -INFINITY;
  if (p == 1.0f) return INFINITY;
  return x;
}

// jnp.interp(x, xp, fp) over one column of a (Q, F) grid (stride F)
__device__ float interp(float x, const float* xp, int stride, const float* fp, int Q) {
  // searchsorted(side='right'): the count of entries <= x; a NaN compares
  // false and lands past the end, as it does in the reference
  int lo = 0, hi = Q;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(__ldg(xp + (size_t)mid * stride) > x)) lo = mid + 1;
    else hi = mid;
  }
  const int i = min(max(lo, 1), Q - 1);
  const float x0 = __ldg(xp + (size_t)(i - 1) * stride);
  const float x1 = __ldg(xp + (size_t)i * stride);
  const float f0 = fp[i - 1];
  const float df = __fsub_rn(fp[i], f0);
  const float dx = __fsub_rn(x1, x0);
  const float delta = __fsub_rn(x, x0);
  // np.spacing(np.finfo(float32).eps) = 2^-46
  float f = fabsf(dx) <= 1.4210854715202004e-14f ? f0 : __fmaf_rn(__fdiv_rn(delta, dx), df, f0);
  if (x < __ldg(xp)) f = fp[0];
  if (x > __ldg(xp + (size_t)(Q - 1) * stride)) f = fp[Q - 1];
  return f;
}

// jnp.clip(u, 1e-6, 1 - 1e-6): a NaN stays NaN
__device__ __forceinline__ float clip_unit(float u) {
  const float lo = (float)1e-6, hi = (float)(1.0 - 1e-6);
  if (u != u) return u;
  return fminf(fmaxf(u, lo), hi);
}

__device__ __forceinline__ float elementwise(const ChainStep& s, int col, float v) {
  switch (s.form) {
    case CA_AFFINE: return __fadd_rn(__fmul_rn(v, __ldg(s.a + col)), __ldg(s.b + col));
    case CA_CENTER: return __fdiv_rn(__fsub_rn(v, __ldg(s.a + col)), __ldg(s.b + col));
    case CA_IMPUTE: return v != v ? __ldg(s.a + col) : v;
    case CA_MUL: return __fmul_rn(v, s.c);
    case CA_ADD: return __fadd_rn(v, s.c);
    case CA_LOG1P: return log1pf(v);
    case CA_EXPM1: return expm1f(v);
    default: return v;
  }
}

__global__ void __launch_bounds__(CA_THREADS) chain_apply_kernel(const ChainApplyArgs a) {
  extern __shared__ float smem[];
  __shared__ float s_qs[CA_MAX_Q];
  float* cur = smem;
  float* nxt = smem + CA_ROWS * a.max_width;
  const int W = a.max_width;
  const int r0 = blockIdx.x * CA_ROWS;
  const int rows = min(CA_ROWS, a.n - r0);
  const int t = threadIdx.x;
  for (int i = t; i < rows * a.f; i += blockDim.x) {
    const int r = i / a.f, c = i - r * a.f;
    cur[r * W + c] = __ldg(a.x + (size_t)(r0 + r) * a.f + c);
  }
  __syncthreads();
  for (int k = 0; k < a.n_steps; ++k) {
    const ChainStep& s = a.steps[k];
    const int w = s.width_in;
    if (s.form == CA_PCA) {
      const int ko = s.width_out;
      for (int i = t; i < rows * ko; i += blockDim.x) {
        const int r = i / ko, j = i - r * ko;
        float acc = 0.f;
        for (int c = 0; c < w; ++c)
          acc = __fmaf_rn(__fsub_rn(cur[r * W + c], __ldg(s.a + c)), __ldg(s.b + (size_t)c * ko + j), acc);
        nxt[r * W + j] = acc;
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    } else if (s.form == CA_QUANTILE) {
      for (int i = t; i < s.q; i += blockDim.x) s_qs[i] = __ldg(s.b + i);
      __syncthreads();
      for (int i = t; i < rows * w; i += blockDim.x) {
        const int r = i / w, c = i - r * w;
        float u = interp(cur[r * W + c], s.a + c, w, s_qs, s.q);
        if (s.normal) u = ndtri(clip_unit(u));
        cur[r * W + c] = u;
      }
      __syncthreads();
    } else {
      for (int i = t; i < rows * w; i += blockDim.x) {
        const int r = i / w, c = i - r * w;
        cur[r * W + c] = elementwise(s, c, cur[r * W + c]);
      }
      __syncthreads();
    }
  }
  for (int i = t; i < rows * a.f_out; i += blockDim.x) {
    const int r = i / a.f_out, c = i - r * a.f_out;
    a.out[(size_t)(r0 + r) * a.f_out + c] = cur[r * W + c];
  }
}

extern "C" int chain_apply_args_size() { return (int)sizeof(ChainApplyArgs); }

extern "C" int chain_apply_limits(int* out) {
  out[0] = CA_MAX_STEPS;
  out[1] = CA_MAX_WIDTH;
  out[2] = CA_MAX_Q;
  return 0;
}

extern "C" const char* chain_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments past the kernel's limits.
extern "C" int chain_apply_launch(const ChainApplyArgs* a, void* stream) {
  if (a->n < 1 || a->n_steps < 1 || a->n_steps > CA_MAX_STEPS || a->max_width < 1 ||
      a->max_width > CA_MAX_WIDTH)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a->n_steps; ++k)
    if (a->steps[k].form == CA_QUANTILE && (a->steps[k].q < 2 || a->steps[k].q > CA_MAX_Q))
      return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * CA_ROWS * a->max_width * sizeof(float);
  const int blocks = (a->n + CA_ROWS - 1) / CA_ROWS;
  chain_apply_kernel<<<blocks, CA_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
