// rolling_median: the detector's trailing rolling median over the tag
// scores and the total score of every dispatch slot, and the confidence
// of the smoothed total.
//
// Replaces `_rolling_median` and `_rolling_median_blocked`
// (gordo_tpu/serve/scorer.py:165,178), which give identical results, and
// the confidence of the smoothed total (scorer.py:272).  Per slot, series
// (each tag, then the total) and row r < n_rows:
//
//   med  = nanmedian(s[max(0, r - w + 1) .. r])    (rows before 0 are NaN)
//   conf = med_total / max(threshold, 1e-12)
//
// jnp.nanmedian is nanquantile(q=0.5, method="midpoint"): NaNs are
// dropped and the result is (lo + hi) * 0.5 in float32 of the two middle
// values of the c values left (lo = hi for odd c); no values give NaN.
//
// Bound: each input and output crosses device memory once, about 2 x 4
// bytes per element against a few hundred compares: bound by bytes.
//
// Design: thread (slot, series, chunk of R rows) keeps the sorted
// non-NaN values of its current window in shared memory and slides it
// down its rows: each step drops the row that leaves (binary search, shift
// down) and inserts the row that enters (shift up), so an output costs
// O(w) shared-memory moves instead of a selection over the window; a
// chunk first fills the w - 1 rows before its start.  A block is one warp
// of 32 neighbouring series (coalesced loads of a row); its sorted buffers
// interleave by lane (value k of lane l at k * 32 + l), so the lanes' moves
// never share a bank.  A window of w rows takes 128 w bytes of shared
// memory per block: w <= 1816.

#include <cuda_runtime.h>
#include <math.h>

#define RM_LANES 32

// Mirrored field by field by `_Args` in gordo_tpu_torch/kernels/rolling_median.py;
// rolling_median_args_size() lets the wrapper check the two agree.
struct RollingMedianArgs {
  const float* tag;       // (m, n, f) tag scores
  const float* total;     // (m, n) total scores
  const int* idx;         // (m,) stacked machine of each slot, or null: slot
  const int* n_rows;      // (m,) valid rows of each slot, or null: n
  const float* agg_thr;   // (M,) aggregate thresholds, or null: no confidence
  float* tag_out;         // (m, n, f)
  float* total_out;       // (m, n)
  float* conf;            // (m, n)  written when agg_thr is set
  int m;
  int n;
  int f;
  int window;
  int chunk_rows;         // R
  int smem_bytes;
};

__device__ __forceinline__ float load_series(const RollingMedianArgs& a, int slot, int c, int r) {
  const size_t row = (size_t)slot * a.n + r;
  return c < a.f ? __ldg(a.tag + row * a.f + c) : __ldg(a.total + row);
}

__global__ void __launch_bounds__(RM_LANES)
rolling_median_kernel(const RollingMedianArgs a) {
  extern __shared__ float smem[];
  const int slot = blockIdx.y;
  const int lane = threadIdx.x;
  const int c = blockIdx.z * RM_LANES + lane;  // series: tags, then the total
  const int n_valid = a.n_rows ? a.n_rows[slot] : a.n;
  const int r_begin = blockIdx.x * a.chunk_rows;
  if (r_begin >= n_valid || c > a.f) return;
  const int r_end = min(r_begin + a.chunk_rows, n_valid);
  const int w = a.window;
  float* s = smem + lane;  // value k at s[k * RM_LANES]
  int cnt = 0;

  auto insert = [&](float v) {
    int i = cnt;
    while (i > 0 && s[(i - 1) * RM_LANES] > v) {
      s[i * RM_LANES] = s[(i - 1) * RM_LANES];
      --i;
    }
    s[i * RM_LANES] = v;
    ++cnt;
  };
  auto remove = [&](float v) {
    // the first value >= v is v itself: it entered the window earlier
    int lo = 0, hi = cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[mid * RM_LANES] < v) lo = mid + 1; else hi = mid;
    }
    for (int i = lo; i + 1 < cnt; ++i) s[i * RM_LANES] = s[(i + 1) * RM_LANES];
    --cnt;
  };

  int first = max(0, r_begin - w + 1);  // first row in the window
  for (int r = first; r < r_begin; ++r) {
    const float v = load_series(a, slot, c, r);
    if (!isnan(v)) insert(v);
  }
  float thr = 0.f;
  if (a.agg_thr && c == a.f) {
    const float t = __ldg(a.agg_thr + (a.idx ? a.idx[slot] : slot));
    thr = isnan(t) ? t : fmaxf(t, 1e-12f);
  }
  for (int r = r_begin; r < r_end; ++r) {
    const int lo_row = max(0, r - w + 1);
    for (; first < lo_row; ++first) {
      const float u = load_series(a, slot, c, first);
      if (!isnan(u)) remove(u);
    }
    const float v = load_series(a, slot, c, r);
    if (!isnan(v)) insert(v);
    float med = __int_as_float(0x7fc00000);  // NaN: no values
    if (cnt > 0) med = (s[((cnt - 1) >> 1) * RM_LANES] + s[(cnt >> 1) * RM_LANES]) * 0.5f;
    const size_t row = (size_t)slot * a.n + r;
    if (c < a.f) {
      a.tag_out[row * a.f + c] = med;
    } else {
      a.total_out[row] = med;
      if (a.agg_thr) a.conf[row] = med / thr;
    }
  }
}

extern "C" int rolling_median_args_size() { return (int)sizeof(RollingMedianArgs); }

extern "C" const char* rolling_median_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int rolling_median_launch(const RollingMedianArgs* a, void* stream) {
  if (a->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rolling_median_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a->n + a->chunk_rows - 1) / a->chunk_rows, a->m, (a->f + 1 + RM_LANES - 1) / RM_LANES);
  rolling_median_kernel<<<grid, RM_LANES, a->smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
