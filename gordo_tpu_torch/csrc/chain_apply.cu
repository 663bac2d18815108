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
// and the inverses that TransformedTargetRegressor.predict runs on a
// prediction (gordo_tpu/pipeline.py:168-172): MinMax's (x - offset) / scale
// is CENTER, Standard's x * std + mean and Robust's x * scale + center are
// AFFINE, and
//
//   PCA_INV       PCA                x @ C + mean, k -> F      (ops/scalers.py:343-344;
//                                    b holds C, (k, F): the dot, then
//                                    the mean added, two roundings)
//   QUANTILE_INV  QuantileTransformer for a normal output ndtr(x) first
//                                    (norm.cdf, no clip), then
//                                    jnp.interp(u, qs, grid_col)  (:262-274)
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
// the reference does.  QUANTILE's xp is the grid column and fp the qs;
// QUANTILE_INV swaps the two.  ndtr follows jax.scipy.special.ndtr: 0.5 *
// (1 + erf(w)) below |w| = sqrt(2)/2, else 0.5 * (2 - erfc(|w|)) or 0.5 *
// erfc(|w|), w = x * sqrt(2)/2, with the erf and erfc that XLA compiles for
// float32 (their polynomials and constants as jaxlib's HLO shows them; the
// Horner steps one FMA each; subnormal results flushed to zero, as XLA:CPU
// computes with denormals off).  Its exp is taken in double and rounded
// once (the plain version's too), where XLA's is its own float32
// approximation, so the tails (|x| > sqrt(2)) stand a few ulp off the
// reference's.  `qs` is jnp.linspace(0, 1, Q) as XLA computes it,
// carried from the host.  ndtri follows jax._src.scipy.special._ndtri's
// Cephes branches with its float32 constants; log and sqrt are CUDA's logf
// (1 ulp) and the correctly rounded square root.
//
// A machine axis (the fleet scorer's buckets, ``serve.fleet`` and
// ``serve.fleet_subset`` over a fused chain, gordo_tpu/serve/fleet_scorer.py:
// 51-98, 120-154): the rows are (m, n, F), one slot a machine's request, and
// each step's stats may be stacked along a leading machine axis (a_stride,
// b_stride: values per machine; 0 for one set of stats for every row, the
// single-machine call, which sees all leading axes as rows of one slot).
// Slot s reads machine idx[s] (default s) and only its first n_rows[s] rows
// (default n); the rows past them are neither read nor written.
//
// Storage types (K10 over K12): T the rows and the stats, which the
// scorer's stacks and the stream always store at one type (float, or
// __nv_bfloat16 for reduced-precision serving), TO the output.  Every value
// is widened to float as it is loaded and all arithmetic is float.  The
// output goes out at the type the next kernel reads: float32 for
// fleet_score and stream_step (which read an f32 input over bf16 weights),
// and the storage type for lstm_layer's first layer (which reads its rows
// at the weights' type).  So three instantiations: <float, float>,
// <bf16, float> and <bf16, bf16>, each with and without the PCA step's
// register tile (below).
//
// Bound: each input value is read once and each output written once; a
// quantile step reads O(log Q) grid entries per value from the L1/L2
// cache, a PCA or PCA_INV step does 2 F k operations per row.  At the widths of the
// main path (F <= 128) this is bound by device memory: at 4,096 x 128 with
// k = 128, 4 MB of rows in and out (1.3 us at 3.35 TB/s) against 134
// MFLOP of fp32 FMAs (2.0 us at 67 TFLOP/s), so the PCA step alone is
// just above the ridge and bound by its arithmetic.
//
// Design: three paths, which the wrapper's launch plan picks from the
// steps and widths; every path rounds each form as below, so a chain's
// outputs do not depend on the path.
//
// The elementwise path, for a chain of elementwise steps alone (AFFINE,
// CENTER, IMPUTE, MUL, ADD, LOG1P, EXPM1: every affine inverse a TTR runs,
// a scaler chain that does not fold).  A block takes a tile of rows of one
// slot, a contiguous span of values; it reads its machine's stats of every
// step once into shared memory, and after that one barrier each thread
// takes four values at a time with one 16-byte load (8 bytes at bf16) and
// one store, where the rows and the output are aligned and the output is
// contiguous, each value's column advancing without a division, every
// step applied in registers.  The parent ran such a chain through the
// tile below: an integer division a value, a barrier a step, each value's
// stats a 4-byte read of their own.
//
// The row path, for a chain with a PCA or PCA_INV step and no quantile
// step, every width at most CA_NARROW_MAX (chain C, Imputer -> PCA(8) ->
// MinMax at 10 tags; chain A; PCA_INV k 8 -> 10).  A block reads its
// machine's stats of every step (a PCA step's components padded to a
// multiple of four columns) into shared memory once, its first tile's rows
// in flight meanwhile, then walks a run of its slot's tiles of R rows, one
// a thread, through a ring of
// CA_ROW_STAGES raw tiles: the next tile's rows load by 16-byte cp.async
// copies (bf16 as they are) while this one's go through the chain.  A
// thread widens its row into its own row of shared memory and takes it
// through every step there (a PCA step's outputs in registers, the
// components read as float4 broadcasts, the loop over its inputs at run
// time, over its outputs unrolled in fours), and the outputs leave in
// coalesced stores.
//
// The tile path, for chains with a quantile step or wider than
// CA_NARROW_MAX (the k 128 PCA of the 128-tag shape):
// one block per tile of R rows of one slot (grid: tiles x slots;
// R = 32..256, the most whose two buffers of R x max_width floats stay
// within 32 KB and that still give two blocks an SM).  A FeatureUnion's
// branches each write their own columns of one wider output (out_stride,
// out_col), so no branch output is copied again.  The tile is loaded into shared memory (coalesced: the
// rows are contiguous) and every step runs on it there, all threads
// striding over the tile's (row, column) values; a PCA step writes its k
// outputs per row (PCA_INV its F) into the second buffer, and the buffers
// swap.  The other
// steps' stats stay in global memory, read through the read-only cache: a
// quantile grid of Q <= 1,000 entries per column would not fit a block's
// shared memory at 128 columns.  The last buffer is written out coalesced.
// Steps run in order with a barrier between them.
//
// A PCA or PCA_INV step is a small product, (R, w) by (w, k).  Its first
// version gave each thread one output, a w-long chain of FMAs that read a
// component from global memory for every term: at k 128 it ran at 0.69%
// of its bound, 5.9x slower than torch.addmm (PERF.md).  So the step's
// components (up to 128 x 128 floats, 64 KB, the machine's own on a
// stacked call) are staged in shared memory once per block, past the two
// tile buffers (dynamic shared memory over 48 KB: two blocks of 96 KB an
// SM at 128 columns), each row padded to a multiple of CA_CT columns with
// zeros; PCA centres the tile in place first (the same `x - mean` the
// terms took one by one).  Each thread then computes a CA_RT x CA_CT tile
// of outputs in registers: per term it reads CA_RT values of the tile
// (one row of a warp: a broadcast) and CA_CT components (one float4), and
// does CA_RT x CA_CT FMAs.  Every output keeps its accumulation order, c
// ascending, one __fmaf_rn a term, and PCA_INV adds the mean after, so
// the outputs are the one-output-a-thread version's bit for bit.  Tensor
// cores would round otherwise, so the step stays on fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "spans.cuh"
#include "storage.cuh"

#define CA_MAX_STEPS 8
#define CA_THREADS 256
#define CA_MAX_WIDTH 128
#define CA_MAX_Q 1000
#define CA_MAX_SLOTS 65535
#define CA_COMP_BATCH 8    // loads in flight a thread as a PCA step's components load
#define CA_RT 4            // rows of a PCA step's register tile
#define CA_CT 4            // columns of it (one float4 of components)
#define CA_SMEM_LIMIT 232448
#define CA_NARROW_MAX 16   // the row path's widest step
#define CA_ROW_STRIDE 17   // a row's floats in the row path's shared memory: odd, so a warp's rows take 32 banks
#ifndef CA_ROW_STAGES
#define CA_ROW_STAGES 2    // raw tiles in the row path's ring: this one and the next ones in flight
#endif
#ifndef CA_EW_BATCH
#define CA_EW_BATCH 4      // groups of four values in flight a thread on the elementwise path
#endif

#define CA_PATH_TILE 0
#define CA_PATH_ELEMENTWISE 1
#define CA_PATH_ROWS 2

#define CA_AFFINE 0
#define CA_CENTER 1
#define CA_IMPUTE 2
#define CA_MUL 3
#define CA_ADD 4
#define CA_LOG1P 5
#define CA_EXPM1 6
#define CA_PCA 7
#define CA_QUANTILE 8
#define CA_PCA_INV 9
#define CA_QUANTILE_INV 10

// Mirrored field by field by `_Step` in gordo_tpu_torch/kernels/chain_apply.py.
struct ChainStep {
  int form;
  int width_in;
  int width_out;
  int q;                // QUANTILE, QUANTILE_INV: grid entries
  int normal;           // QUANTILE, QUANTILE_INV: output_distribution == "normal"
  float c;              // MUL, ADD: the constant
  const void* a;        // T.  AFFINE/CENTER: (F,) scale or mean; IMPUTE: fill; PCA, PCA_INV: mean;
                        //     QUANTILE, QUANTILE_INV: grid (Q, F)
  const void* b;        // T.  AFFINE/CENTER: (F,) offset or std; PCA: components^T (F, k);
                        //     PCA_INV: components (k, F); QUANTILE, QUANTILE_INV: qs (Q,)
  long long a_stride;   // values of `a` per machine; 0: one set for every slot
  long long b_stride;
};

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/chain_apply.py.
struct ChainApplyArgs {
  const void* x;        // (m, n, f) T
  void* out;            // (m, n, out_stride) TO, of which columns out_col .. out_col + f_out
  const int* idx;       // (m,) the machine of each slot, or null: slot s is machine s
  const int* n_rows;    // (m,) valid rows of each slot, or null: n
  int m;
  int n;
  int f;
  int f_out;
  int max_width;
  int rows_per_tile;
  int n_steps;
  int bf16;             // T (rows and stats) is __nv_bfloat16
  int out_bf16;         // TO is __nv_bfloat16; needs bf16
  int out_stride;       // values per output row (f_out, or a FeatureUnion's whole width)
  int out_col;          // the first output column written
  int path;             // CA_PATH_TILE, CA_PATH_ELEMENTWISE or CA_PATH_ROWS
  int vec;              // elementwise path: rows and output 16-byte aligned, the output contiguous
  int blocks_per_slot;  // grid columns: a tile each, or on the row path a run of tiles each
  ChainStep steps[CA_MAX_STEPS];
};

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// XLA's float32 erf and erfc polynomials (jaxlib's compiled HLO)
__constant__ float CA_ERF_A[5] = {(float)0.00022905065861350646, (float)0.0034082910107109506,
                              (float)0.050955695062380861, (float)0.18520832239976145,
                              (float)1.128379143519084};
__constant__ float CA_ERF_B[7] = {(float)-1.1791602954361697e-7, (float)0.000023547966471313185,
                              (float)0.0010179625278914885, (float)0.014070470171167667,
                              (float)0.11098505178285362, (float)0.49746925110067538, 1.0f};
__constant__ float CA_ERFC_E[7] = {(float)7.85386146e-05, (float)-0.000801019371, (float)0.00518832775,
                               (float)-0.0268538129, (float)0.112835854, (float)-0.37612626,
                               (float)1.12837911};
__constant__ float CA_ERFC_P[9] = {(float)0.0232682, (float)-0.138703942, (float)0.368742466,
                               (float)-0.582473278, (float)0.621000469, (float)-0.494451523,
                               (float)0.340488, (float)-0.274112701, (float)0.563825965};
__constant__ float CA_ERFC_R[8] = {(float)-10.477664, (float)12.9772, (float)-7.49551868,
                               (float)2.92101908, (float)-1.01526523, (float)0.42184633,
                               (float)-0.282076746, (float)0.564189494};

__device__ __forceinline__ float flush(float v) { return fabsf(v) < 1.17549435e-38f ? 0.f : v; }

// (ndtr calls it for |x| < sqrt(2)/2 only, never with a NaN)
__device__ __forceinline__ float erf_xla(float x) {
  const float c = (float)3.7439211627767994;
  x = fminf(fmaxf(x, -c), c);
  const float x2 = __fmul_rn(x, x);
  return __fdiv_rn(__fmul_rn(x, polyval(CA_ERF_A, 5, x2)), polyval(CA_ERF_B, 7, x2));
}

// erfc of x >= 0 (ndtr's |w|); NaN stays NaN
__device__ __forceinline__ float erfc_xla(float x) {
  const float x2 = __fmul_rn(x, x);
  if (x < 1.0f) return __fmaf_rn(-x, polyval(CA_ERFC_E, 7, x2), 1.0f);
  const float z = -x2;
  if (z < (float)-88.7228394) return 0.f;
  const float y = __fdiv_rn(1.0f, x2);
  const float p = x < 2.0f ? polyval(CA_ERFC_P, 9, y) : polyval(CA_ERFC_R, 8, y);
  // exp in double, rounded once: the plain version's exp, to the bit
  return flush(__fmul_rn(__fmul_rn(flush((float)exp((double)z)), __fdiv_rn(1.0f, x)), p));
}

// jax.scipy.special.ndtr in float32
__device__ float ndtr(float x) {
  const float h = 0.70710677f;  // float32(0.5) * float32(sqrt(2))
  const float w = __fmul_rn(x, h);
  const float z = fabsf(w);
  float y;
  if (z < h) {
    y = __fadd_rn(1.0f, erf_xla(w));
  } else {
    const float t = erfc_xla(z);
    y = w > 0.f ? __fsub_rn(2.0f, t) : t;
  }
  return flush(__fmul_rn(0.5f, y));
}

// jnp.interp(x, xp, fp) with Q entries; xp(i) and fp(i) give entry i
template <typename XP, typename FP>
__device__ float interp(float x, int Q, XP xp, FP fp) {
  // searchsorted(side='right'): the count of entries <= x; a NaN compares
  // false and lands past the end, as it does in the reference
  int lo = 0, hi = Q;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(xp(mid) > x)) lo = mid + 1;
    else hi = mid;
  }
  const int i = min(max(lo, 1), Q - 1);
  const float x0 = xp(i - 1);
  const float x1 = xp(i);
  const float f0 = fp(i - 1);
  const float df = __fsub_rn(fp(i), f0);
  const float dx = __fsub_rn(x1, x0);
  const float delta = __fsub_rn(x, x0);
  // np.spacing(np.finfo(float32).eps) = 2^-46
  float f = fabsf(dx) <= 1.4210854715202004e-14f ? f0 : __fmaf_rn(__fdiv_rn(delta, dx), df, f0);
  if (x < xp(0)) f = fp(0);
  if (x > xp(Q - 1)) f = fp(Q - 1);
  return f;
}

// jnp.clip(u, 1e-6, 1 - 1e-6): a NaN stays NaN
__device__ __forceinline__ float clip_unit(float u) {
  const float lo = (float)1e-6, hi = (float)(1.0 - 1e-6);
  if (u != u) return u;
  return fminf(fmaxf(u, lo), hi);
}

// an elementwise step of form `form` on v, with its stats a, b (AFFINE,
// CENTER; IMPUTE's fill a) and constant c (MUL, ADD), as `elementwise`
// below rounds it: the elementwise and row paths' map
__device__ __forceinline__ float ew_apply(int form, float v, float a, float b, float c) {
  switch (form) {
    case CA_AFFINE: return __fadd_rn(__fmul_rn(v, a), b);
    case CA_CENTER: return __fdiv_rn(__fsub_rn(v, a), b);
    case CA_IMPUTE: return v != v ? a : v;
    case CA_MUL: return __fmul_rn(v, c);
    case CA_ADD: return __fadd_rn(v, c);
    case CA_LOG1P: return log1pf(v);
    case CA_EXPM1: return expm1f(v);
    default: return v;
  }
}

// the tile path's: `a` and `b` are this slot's machine's stats
template <typename T>
__device__ __forceinline__ float elementwise(const ChainStep& s, const T* a, const T* b, int col, float v) {
  switch (s.form) {
    case CA_AFFINE: return __fadd_rn(__fmul_rn(v, ld(a + col)), ld(b + col));
    case CA_CENTER: return __fdiv_rn(__fsub_rn(v, ld(a + col)), ld(b + col));
    case CA_IMPUTE: return v != v ? ld(a + col) : v;
    case CA_MUL: return __fmul_rn(v, s.c);
    case CA_ADD: return __fadd_rn(v, s.c);
    case CA_LOG1P: return log1pf(v);
    case CA_EXPM1: return expm1f(v);
    default: return v;
  }
}

// body(form) with `decltype(form)::value` the elementwise form `form_value`
// as a compile-time constant, so that a loop over values carries one form
template <typename Body>
__device__ __forceinline__ void with_ew_form(int form_value, Body body) {
  switch (form_value) {
    case CA_AFFINE: body(std::integral_constant<int, CA_AFFINE>()); break;
    case CA_CENTER: body(std::integral_constant<int, CA_CENTER>()); break;
    case CA_IMPUTE: body(std::integral_constant<int, CA_IMPUTE>()); break;
    case CA_MUL: body(std::integral_constant<int, CA_MUL>()); break;
    case CA_ADD: body(std::integral_constant<int, CA_ADD>()); break;
    case CA_LOG1P: body(std::integral_constant<int, CA_LOG1P>()); break;
    default: body(std::integral_constant<int, CA_EXPM1>()); break;
  }
}

__device__ __forceinline__ bool has_a(int form) { return form <= CA_IMPUTE || form == CA_PCA || form == CA_PCA_INV; }
__device__ __forceinline__ bool has_b(int form) { return form <= CA_CENTER; }

// PCA: the chain has a PCA or PCA_INV step.  Its register tile takes 48
// registers a thread (five blocks an SM); a chain without one runs an
// instantiation without the tile, at the 32 registers and eight blocks an
// SM that its elementwise steps, bound by device memory, had before.
template <typename T, typename TO, bool PCA>
__global__ void __launch_bounds__(CA_THREADS, PCA ? 5 : 8) chain_apply_kernel(const ChainApplyArgs a) {
  extern __shared__ float smem[];
  __shared__ float s_qs[CA_MAX_Q];
  const int slot = blockIdx.y;
  const int n_valid = a.n_rows ? a.n_rows[slot] : a.n;
  const int r0 = blockIdx.x * a.rows_per_tile;
  if (r0 >= n_valid) return;  // the whole block: no barrier is skipped by part of it
  const size_t mach = a.idx ? a.idx[slot] : slot;
  const int W = a.max_width;
  float* cur = smem;
  float* nxt = smem + a.rows_per_tile * W;
  const int rows = min(a.rows_per_tile, n_valid - r0);
  const size_t row0 = (size_t)slot * a.n + r0;
  const int t = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  for (int i = t; i < rows * a.f; i += blockDim.x) {
    const int r = i / a.f, c = i - r * a.f;
    cur[r * W + c] = ld(x + (row0 + r) * a.f + c);
  }
  __syncthreads();
  for (int k = 0; k < a.n_steps; ++k) {
    const ChainStep& s = a.steps[k];
    const T* sa = static_cast<const T*>(s.a) + mach * s.a_stride;
    const T* sb = static_cast<const T*>(s.b) + mach * s.b_stride;
    const int w = s.width_in;
    if (PCA && (s.form == CA_PCA || s.form == CA_PCA_INV)) {
      const int ko = s.width_out;
      const int kp = (ko + CA_CT - 1) / CA_CT * CA_CT;
      const bool inv = s.form == CA_PCA_INV;
      float* comp = smem + 2 * a.rows_per_tile * W;  // (w, kp), 16-byte aligned
      // CA_COMP_BATCH loads in flight a thread before it stores any: a
      // store to shared memory through a generic pointer may alias a later
      // load for all the compiler knows, so a load and store at a time
      // would wait a full memory latency each (the k 128 step at 4,096 x
      // 128 took 0.0300 ms that way, 0.0255 batched, on an H100 80GB HBM3
      // at 700 W)
      for (int i0 = t; i0 < w * kp; i0 += CA_COMP_BATCH * blockDim.x) {
        float v[CA_COMP_BATCH];
#pragma unroll
        for (int u = 0; u < CA_COMP_BATCH; ++u) {
          const int i = i0 + u * blockDim.x;
          const int c = i / kp, j = i - c * kp;
          v[u] = i < w * kp && j < ko ? ld(sb + (size_t)c * ko + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < CA_COMP_BATCH; ++u)
          if (i0 + u * blockDim.x < w * kp) comp[i0 + u * blockDim.x] = v[u];
      }
      if (!inv)
        for (int i = t; i < rows * w; i += blockDim.x) {
          const int r = i / w, c = i - r * w;
          cur[r * W + c] = __fsub_rn(cur[r * W + c], ld(sa + c));
        }
      __syncthreads();
      // tiles past the last row read stale rows of the buffer and write nothing
      const int ncg = kp / CA_CT;
      const int n_tiles = (rows + CA_RT - 1) / CA_RT * ncg;
      for (int tile = t; tile < n_tiles; tile += blockDim.x) {
        const int rg = tile / ncg;
        const int r0 = rg * CA_RT, j0 = (tile - rg * ncg) * CA_CT;
        float acc[CA_RT][CA_CT];
#pragma unroll
        for (int rr = 0; rr < CA_RT; ++rr)
#pragma unroll
          for (int jj = 0; jj < CA_CT; ++jj) acc[rr][jj] = 0.f;
        const float* xr = cur + r0 * W;
        for (int c = 0; c < w; ++c) {
          const float4 b4 = *reinterpret_cast<const float4*>(comp + c * kp + j0);
          const float bv[CA_CT] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int rr = 0; rr < CA_RT; ++rr) {
            const float v = xr[rr * W + c];
#pragma unroll
            for (int jj = 0; jj < CA_CT; ++jj) acc[rr][jj] = __fmaf_rn(v, bv[jj], acc[rr][jj]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < CA_RT; ++rr) {
          if (r0 + rr >= rows) break;
#pragma unroll
          for (int jj = 0; jj < CA_CT; ++jj) {
            const int j = j0 + jj;
            if (j < ko) nxt[(r0 + rr) * W + j] = inv ? __fadd_rn(acc[rr][jj], ld(sa + j)) : acc[rr][jj];
          }
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    } else if (s.form == CA_QUANTILE || s.form == CA_QUANTILE_INV) {
      for (int i = t; i < s.q; i += blockDim.x) s_qs[i] = ld(sb + i);
      __syncthreads();
      for (int i = t; i < rows * w; i += blockDim.x) {
        const int r = i / w, c = i - r * w;
        const T* col = sa + c;
        auto grid = [&](int e) { return ld(col + (size_t)e * w); };
        auto qs = [&](int e) { return s_qs[e]; };
        float u;
        if (s.form == CA_QUANTILE) {
          u = interp(cur[r * W + c], s.q, grid, qs);
          if (s.normal) u = ndtri(clip_unit(u));
        } else {
          const float v = cur[r * W + c];
          u = interp(s.normal ? ndtr(v) : v, s.q, qs, grid);
        }
        cur[r * W + c] = u;
      }
      __syncthreads();
    } else {
      for (int i = t; i < rows * w; i += blockDim.x) {
        const int r = i / w, c = i - r * w;
        cur[r * W + c] = elementwise(s, sa, sb, c, cur[r * W + c]);
      }
      __syncthreads();
    }
  }
  TO* out = static_cast<TO*>(a.out);
  for (int i = t; i < rows * a.f_out; i += blockDim.x) {
    const int r = i / a.f_out, c = i - r * a.f_out;
    st(out + (row0 + r) * a.out_stride + a.out_col + c, cur[r * W + c]);
  }
}

// four values from `p` (16 bytes of floats, 8 of bf16, aligned), widened
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// each value rounded as st() rounds it
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) = q;
}

// The elementwise path (the header's first): a tile of rows of one slot,
// its stats of every step in shared memory, four values a load.
template <typename T, typename TO>
__global__ void __launch_bounds__(CA_THREADS) chain_apply_ew_kernel(const __grid_constant__ ChainApplyArgs a) {
  __shared__ float s_st[CA_MAX_STEPS][2][CA_MAX_WIDTH];
  const int slot = blockIdx.y;
  const int n_valid = a.n_rows ? a.n_rows[slot] : a.n;
  const int r0 = blockIdx.x * a.rows_per_tile;
  if (r0 >= n_valid) return;
  const size_t mach = a.idx ? a.idx[slot] : slot;
  const int F = a.f;
  const int t = threadIdx.x;
  for (int k = 0; k < a.n_steps; ++k) {
    const ChainStep& s = a.steps[k];
    const T* sa = static_cast<const T*>(s.a) + mach * s.a_stride;
    const T* sb = static_cast<const T*>(s.b) + mach * s.b_stride;
    for (int c = t; c < F; c += CA_THREADS) {
      if (has_a(s.form)) s_st[k][0][c] = ld(sa + c);
      if (has_b(s.form)) s_st[k][1][c] = ld(sb + c);
    }
  }
  __syncthreads();
  const int rows = min(a.rows_per_tile, n_valid - r0);
  const size_t row0 = (size_t)slot * a.n + r0;
  const int count = rows * F;
  const T* x = static_cast<const T*>(a.x) + row0 * F;
  TO* out = static_cast<TO*>(a.out);
  // the steps over values v[u] of columns c[u], in registers
  auto apply = [&](auto& v, const auto& c) {
    for (int k = 0; k < a.n_steps; ++k) {
      const float* sa = s_st[k][0];
      const float* sb = s_st[k][1];
      const float cst = a.steps[k].c;
      with_ew_form(a.steps[k].form, [&](auto form) {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = ew_apply(decltype(form)::value, v[u], sa[c[u]], sb[c[u]], cst);
      });
    }
  };
  if (a.vec) {
    // values before the first 16-byte boundary and past the last whole
    // group go one a thread; the groups between, four a load
    TO* o = out + row0 * F;
    const int head = min((int)((4 - (row0 * F & 3)) & 3), count);
    const int groups = (count - head) >> 2;
    const int tail = head + 4 * groups;
    const int i1 = t < head ? t : t >= 4 && t - 4 < count - tail ? tail + t - 4 : -1;
    if (i1 >= 0) {
      float v[4] = {ld(x + i1), 0.f, 0.f, 0.f};
      const int c[4] = {i1 % F, 0, 0, 0};
      apply(v, c);
      st(o + i1, v[0]);
    }
    const int dc = 4 * CA_THREADS % F;
    int c0 = (head + 4 * t) % F;
    for (int g0 = t; g0 < groups; g0 += CA_EW_BATCH * CA_THREADS) {
      float v[CA_EW_BATCH][4];
#pragma unroll
      for (int b = 0; b < CA_EW_BATCH; ++b) {
        const int g = g0 + b * CA_THREADS;
        if (g < groups) load4(x + head + 4 * g, v[b]);
      }
#pragma unroll
      for (int b = 0; b < CA_EW_BATCH; ++b) {
        const int g = g0 + b * CA_THREADS;
        if (g < groups) {
          int c[4] = {c0, 0, 0, 0};
#pragma unroll
          for (int u = 1; u < 4; ++u) c[u] = c[u - 1] + 1 == F ? 0 : c[u - 1] + 1;
          apply(v[b], c);
          store4(o + head + 4 * g, v[b]);
        }
        c0 += dc;
        if (c0 >= F) c0 -= F;
      }
    }
  } else {
    walk_nt(rows, F, t, CA_THREADS, [&](int r, int c) {
      float v[4] = {ld(x + r * F + c), 0.f, 0.f, 0.f};
      const int cs[4] = {c, 0, 0, 0};
      apply(v, cs);
      st(out + (row0 + r) * a.out_stride + a.out_col + c, v[0]);
    });
  }
}

// A PCA (or, `inv`, PCA_INV) step on one row `h` (shared memory, its
// own): each output a chain of FMAs, c ascending, from 0, as the tile's;
// the padded components `comp` (w, 4 DQ) read as float4 broadcasts, DQ =
// pad4(ko) / 4, so that no FMA past the padding is issued
template <int DQ>
__device__ __forceinline__ void pca_row(float* h, const float* mean, const float* comp, int w, int ko, bool inv) {
  constexpr int kp = 4 * DQ;
  float o[kp];
#pragma unroll
  for (int j = 0; j < kp; ++j) o[j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < w; ++c) {
    const float v = inv ? h[c] : __fsub_rn(h[c], mean[c]);
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const float4 b4 = *reinterpret_cast<const float4*>(comp + c * kp + 4 * q);
      o[4 * q] = __fmaf_rn(v, b4.x, o[4 * q]);
      o[4 * q + 1] = __fmaf_rn(v, b4.y, o[4 * q + 1]);
      o[4 * q + 2] = __fmaf_rn(v, b4.z, o[4 * q + 2]);
      o[4 * q + 3] = __fmaf_rn(v, b4.w, o[4 * q + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < kp; ++j)
    if (j < ko) h[j] = inv ? __fadd_rn(o[j], mean[j]) : o[j];
}

// The row path (the header's second): R rows of one slot a tile, one a
// thread, each row (CA_ROW_STRIDE floats of shared memory, its own)
// through every step, the step's outputs in registers; a block walks a run
// of its slot's tiles through a ring of CA_ROW_STAGES raw tiles, the next
// ones' rows loading while it applies the chain to this one's.
template <typename T, typename TO>
__global__ void __launch_bounds__(CA_THREADS) chain_apply_rows_kernel(const __grid_constant__ ChainApplyArgs a) {
  __shared__ float s_a[CA_MAX_STEPS][CA_NARROW_MAX];
  __shared__ __align__(16) float s_b[CA_MAX_STEPS][CA_NARROW_MAX * CA_NARROW_MAX];
  extern __shared__ float4 dyn4[];
  const int R = a.rows_per_tile;
  float* hs = reinterpret_cast<float*>(dyn4);                    // R rows of CA_ROW_STRIDE
  char* raw = reinterpret_cast<char*>(hs + R * CA_ROW_STRIDE);   // CA_ROW_STAGES tiles of raw rows (T)
  const int slot = blockIdx.y;
  const int n_valid = a.n_rows ? a.n_rows[slot] : a.n;
  const int tiles = (n_valid + R - 1) / R;
  if ((int)blockIdx.x >= tiles) return;
  const size_t mach = a.idx ? a.idx[slot] : slot;
  const int t = threadIdx.x;
  const int x_bytes = (R * a.f * (int)sizeof(T) + 15) & ~15;
  // tile `tile`'s raw rows into ring slot `buf` (none past the slot's
  // tiles), one copy group a call
  auto fetch = [&](int tile, int buf) {
    if (tile < tiles)
      copy_raw(raw + buf * x_bytes, static_cast<const T*>(a.x) + ((size_t)slot * a.n + tile * R) * a.f,
               min(R, n_valid - tile * R) * a.f * (int)sizeof(T), t, R);
    copy_async_commit();
  };
  // the first tiles' rows in flight while the stats load
  for (int s = 0; s < CA_ROW_STAGES - 1; ++s) fetch(blockIdx.x + s * gridDim.x, s);
  for (int k = 0; k < a.n_steps; ++k) {
    const ChainStep& s = a.steps[k];
    const T* sa = static_cast<const T*>(s.a) + mach * s.a_stride;
    const T* sb = static_cast<const T*>(s.b) + mach * s.b_stride;
    if (s.form == CA_PCA || s.form == CA_PCA_INV) {
      // the mean (PCA's of its inputs, PCA_INV's of its outputs), then
      // the components (w, ko) padded to kp columns of zeros
      const int ko = s.width_out;
      const int kp = pad4(ko);
      for (int c = t; c < (s.form == CA_PCA ? s.width_in : ko); c += R) s_a[k][c] = ld(sa + c);
      walk_batched<4>(
          s.width_in, kp, t, R, [&](int c, int j) { return j < ko ? ld(sb + (size_t)c * ko + j) : 0.f; },
          [&](int c, int j, float v) { s_b[k][c * kp + j] = v; });
    } else {
      for (int c = t; c < s.width_in; c += R) {
        if (has_a(s.form)) s_a[k][c] = ld(sa + c);
        if (has_b(s.form)) s_b[k][c] = ld(sb + c);
      }
    }
  }
  TO* out = static_cast<TO*>(a.out);
  for (int tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
    copy_async_wait<CA_ROW_STAGES - 2>();
    __syncthreads();  // this tile's rows in; the last tile's rows read and stores done
    fetch(tile + (CA_ROW_STAGES - 1) * gridDim.x, (i + CA_ROW_STAGES - 1) % CA_ROW_STAGES);
    const int buf = i % CA_ROW_STAGES;
    const int rows = min(R, n_valid - tile * R);
    const size_t row0 = (size_t)slot * a.n + tile * R;
    if (t < rows) {
      float* h = hs + t * CA_ROW_STRIDE;
      const T* xr = reinterpret_cast<const T*>(raw + buf * x_bytes) + t * a.f;
      for (int c = 0; c < a.f; ++c) h[c] = widen(xr[c]);
      for (int k = 0; k < a.n_steps; ++k) {
        const ChainStep& s = a.steps[k];
        const int w = s.width_in;
        const float* sa = s_a[k];
        const float* sb = s_b[k];
        if (s.form == CA_PCA || s.form == CA_PCA_INV) {
          const bool inv = s.form == CA_PCA_INV;
          switch ((s.width_out + 3) >> 2) {
            case 1: pca_row<1>(h, sa, sb, w, s.width_out, inv); break;
            case 2: pca_row<2>(h, sa, sb, w, s.width_out, inv); break;
            case 3: pca_row<3>(h, sa, sb, w, s.width_out, inv); break;
            default: pca_row<4>(h, sa, sb, w, s.width_out, inv); break;
          }
        } else {
          const float cst = s.c;
          with_ew_form(s.form, [&](auto form) {
            for (int c = 0; c < w; ++c) h[c] = ew_apply(decltype(form)::value, h[c], sa[c], sb[c], cst);
          });
        }
      }
    }
    __syncthreads();
    walk_nt(rows, a.f_out, t, R, [&](int r, int c) {
      st(out + (row0 + r) * a.out_stride + a.out_col + c, hs[r * CA_ROW_STRIDE + c]);
    });
  }
}

extern "C" int chain_apply_args_size() { return (int)sizeof(ChainApplyArgs); }

extern "C" int chain_apply_limits(int* out) {
  out[0] = CA_MAX_STEPS;
  out[1] = CA_MAX_WIDTH;
  out[2] = CA_MAX_Q;
  out[3] = CA_MAX_SLOTS;
  out[4] = CA_NARROW_MAX;
  out[5] = CA_THREADS;
  return 0;
}

extern "C" const char* chain_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dynamic shared memory: the two tile buffers, then the largest PCA or
// PCA_INV step's padded components
static size_t smem_bytes(const ChainApplyArgs* a) {
  size_t comp = 0;
  for (int k = 0; k < a->n_steps; ++k) {
    const ChainStep& s = a->steps[k];
    if (s.form == CA_PCA || s.form == CA_PCA_INV) {
      const size_t kp = (size_t)(s.width_out + CA_CT - 1) / CA_CT * CA_CT;
      comp = comp > s.width_in * kp ? comp : s.width_in * kp;
    }
  }
  return ((size_t)2 * a->rows_per_tile * a->max_width + comp) * sizeof(float);
}

template <typename T, typename TO, bool PCA>
static int launch_with(const ChainApplyArgs* a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(chain_apply_kernel<T, TO, PCA>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a->blocks_per_slot, a->m);
  chain_apply_kernel<T, TO, PCA><<<grid, CA_THREADS, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// the row path's dynamic shared memory: the rows, the ring of raw tiles
template <typename T>
static size_t rows_smem(const ChainApplyArgs* a) {
  return (size_t)a->rows_per_tile * CA_ROW_STRIDE * sizeof(float) +
         CA_ROW_STAGES * (((size_t)a->rows_per_tile * a->f * sizeof(T) + 15) & ~(size_t)15);
}

template <typename T, typename TO>
static int launch(const ChainApplyArgs* a, cudaStream_t stream) {
  const dim3 grid(a->blocks_per_slot, a->m);
  if (a->path == CA_PATH_ELEMENTWISE) {
    chain_apply_ew_kernel<T, TO><<<grid, CA_THREADS, 0, stream>>>(*a);
    return (int)cudaGetLastError();
  }
  if (a->path == CA_PATH_ROWS) {
    const size_t smem = rows_smem<T>(a);
    // with the kernel's static stats, over 48 KB a block only by the opt-in
    if (smem + sizeof(float) * CA_MAX_STEPS * CA_NARROW_MAX * (CA_NARROW_MAX + 1) > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(chain_apply_rows_kernel<T, TO>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    chain_apply_rows_kernel<T, TO><<<grid, a->rows_per_tile, smem, stream>>>(*a);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes(a);
  const bool pca = smem > (size_t)2 * a->rows_per_tile * a->max_width * sizeof(float);
  return pca ? launch_with<T, TO, true>(a, smem, stream) : launch_with<T, TO, false>(a, smem, stream);
}

// whether the plan's path takes the chain: the elementwise path elementwise
// steps alone (and 16-byte access only to a contiguous output), the row
// path no quantile step and widths up to CA_NARROW_MAX, the tile path a
// tile within its shared memory
static bool path_takes(const ChainApplyArgs* a) {
  const int tiles = (a->n + a->rows_per_tile - 1) / a->rows_per_tile;
  if (a->path == CA_PATH_ROWS ? a->blocks_per_slot < 1 || a->blocks_per_slot > tiles : a->blocks_per_slot != tiles)
    return false;
  bool elementwise = true, quantile = false;
  for (int k = 0; k < a->n_steps; ++k) {
    const int form = a->steps[k].form;
    elementwise = elementwise && form <= CA_EXPM1;
    quantile = quantile || form == CA_QUANTILE || form == CA_QUANTILE_INV;
  }
  switch (a->path) {
    case CA_PATH_ELEMENTWISE:
      return elementwise && a->f == a->f_out && (!a->vec || (a->out_stride == a->f_out && a->out_col == 0));
    case CA_PATH_ROWS:
      return !quantile && a->max_width <= CA_NARROW_MAX && a->rows_per_tile >= 32 &&
             a->rows_per_tile <= CA_THREADS && a->rows_per_tile % 32 == 0;
    case CA_PATH_TILE:
      return a->rows_per_tile % CA_RT == 0 &&
             (size_t)2 * a->rows_per_tile * a->max_width * sizeof(float) <= 48 * 1024 &&
             smem_bytes(a) + CA_MAX_Q * sizeof(float) <= CA_SMEM_LIMIT;
    default:
      return false;
  }
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments past the kernel's limits or a
// path that does not take the chain.
extern "C" int chain_apply_launch(const ChainApplyArgs* a, void* stream) {
  if (a->n < 1 || a->m < 1 || a->m > CA_MAX_SLOTS || a->n_steps < 1 || a->n_steps > CA_MAX_STEPS ||
      a->max_width < 1 || a->max_width > CA_MAX_WIDTH || a->rows_per_tile < 1 || (a->out_bf16 && !a->bf16) ||
      a->out_col < 0 || a->out_col + a->f_out > a->out_stride || !path_takes(a))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a->n_steps; ++k)
    if ((a->steps[k].form == CA_QUANTILE || a->steps[k].form == CA_QUANTILE_INV) &&
        (a->steps[k].q < 2 || a->steps[k].q > CA_MAX_Q))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!a->bf16) return launch<float, float>(a, s);
  if (a->out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return launch<__nv_bfloat16, float>(a, s);
}
