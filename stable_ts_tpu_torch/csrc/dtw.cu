// DTW cost matrix: C[i, j] = x[i-1, j-1] + min(C[i-1, j-1], C[i-1, j], C[i, j-1])
// with C[0, 0] = 0 and INF (1e30) borders.
//
// Replaces stable_ts_tpu/ops/dtw.py:_dtw_row_kernel (dtw_cost_pallas).
// It computes the same row algebra (dtw.py:8-14): with
//   A[j] = min(C[i-1, j-1], C[i-1, j])  and  S[j] = x[i-1, 0] + ... + x[i-1, j-1],
//   C[i, j] = S[j] + min_{k <= j} (A[k] - S[k-1]),
// so each row is one prefix sum and one prefix min instead of M serial steps.
//
// What bounds it on the card: latency. The rows depend on each other, and
// one row is only ~1500 numbers, so the work per launch is tiny; what costs
// is the chain of N dependent row steps. One block per matrix carries the
// previous row in shared memory and walks the rows in order; each row is
// two block-wide scans over M columns (512 threads, up to 8 contiguous
// columns each, warp shuffles between them). No row goes back to device
// memory except as the output.
//
// The prefix sums run in f64 and round to f32 once per entry, so the result
// does not depend on the scan's order: the plain version's sequential
// cumsum in f64 gives the same f32 values, and the traceback's strict-<
// comparisons see identical costs. The prefix min is exact in any order.
#include "common.cuh"

namespace {

constexpr int DTW_THREADS = 512;
constexpr int DTW_MAX_PER_THREAD = 8;  // M <= 4096
constexpr float DTW_INF = 1e30f;

struct SumD {
  __device__ __forceinline__ double operator()(double a, double b) const { return a + b; }
};
struct MinF {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Exclusive scan of one value per thread over the block (in thread order).
// warp_tot: DTW_THREADS / 32 entries of shared memory.
template <typename V, typename Op>
__device__ __forceinline__ V block_exclusive_scan(V val, V identity, Op op, V* warp_tot) {
  constexpr int NW = DTW_THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V incl = val;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl = op(n, incl);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    V w = lane < NW ? warp_tot[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V n = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w = op(n, w);
    }
    if (lane < NW) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  V excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = identity;
  const V res = warp == 0 ? excl : op(warp_tot[warp - 1], excl);
  __syncthreads();  // warp_tot is reused by the next scan
  return res;
}

__global__ void __launch_bounds__(DTW_THREADS)
dtw_cost_kernel(const float* __restrict__ x, float* __restrict__ cost, int n, int m) {
  extern __shared__ float prev[];  // row i-1, m + 1 entries
  __shared__ double sum_tot[DTW_THREADS / 32];
  __shared__ float min_tot[DTW_THREADS / 32];

  const int tid = threadIdx.x;
  const float* xb = x + static_cast<long long>(blockIdx.x) * n * m;
  float* cb = cost + static_cast<long long>(blockIdx.x) * (n + 1) * (m + 1);
  const int per = (m + DTW_THREADS - 1) / DTW_THREADS;
  const int c0 = tid * per;  // this thread's columns: j = c0 + 1 .. c0 + per

  for (int j = tid; j <= m; j += DTW_THREADS) {
    const float r0 = j == 0 ? 0.f : DTW_INF;
    prev[j] = r0;
    cb[j] = r0;
  }
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    const float* xr = xb + static_cast<long long>(i - 1) * m;
    double loc[DTW_MAX_PER_THREAD];
    float a[DTW_MAX_PER_THREAD];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < DTW_MAX_PER_THREAD; ++e) {
      const int c = c0 + e;  // column j = c + 1
      const bool in = e < per && c < m;
      run += in ? static_cast<double>(xr[c]) : 0.0;
      loc[e] = run;
      a[e] = in ? fminf(prev[c], prev[c + 1]) : DTW_INF;
    }
    const double off = block_exclusive_scan(run, 0.0, SumD(), sum_tot);

    // g[j] = A[j] - S[j-1]; local prefix min, then across threads
    float s[DTW_MAX_PER_THREAD], g_min[DTW_MAX_PER_THREAD];
    float running = INFINITY;
#pragma unroll
    for (int e = 0; e < DTW_MAX_PER_THREAD; ++e) {
      s[e] = static_cast<float>(off + loc[e]);
      const float s_prev = static_cast<float>(e == 0 ? off : off + loc[e - 1]);
      const bool in = e < per && c0 + e < m;
      running = fminf(running, in ? a[e] - s_prev : INFINITY);
      g_min[e] = running;
    }
    const float moff = block_exclusive_scan(running, INFINITY, MinF(), min_tot);

    // every read of prev for this row happened before the scans' barriers
    float* crow = cb + static_cast<long long>(i) * (m + 1);
    if (tid == 0) {
      prev[0] = DTW_INF;
      crow[0] = DTW_INF;
    }
#pragma unroll
    for (int e = 0; e < DTW_MAX_PER_THREAD; ++e) {
      const int c = c0 + e;
      if (e < per && c < m) {
        const float r = fminf(s[e] + fminf(moff, g_min[e]), DTW_INF);
        prev[c + 1] = r;
        crow[c + 1] = r;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// x: (batch, n, m) f32 contiguous; cost: (batch, n + 1, m + 1) f32.
extern "C" int dtw_cost(const void* x, void* cost, int batch, int n, int m,
                        void* stream) {
  if (m < 1 || m > DTW_THREADS * DTW_MAX_PER_THREAD || n < 0 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(m + 1) * sizeof(float);
  dtw_cost_kernel<<<batch, DTW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(cost), n, m);
  return static_cast<int>(cudaGetLastError());
}
