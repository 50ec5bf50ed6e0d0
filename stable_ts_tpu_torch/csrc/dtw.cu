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
// is the chain of N dependent rows (226 at the timing pass's largest
// shape). Of a row's work only the prefix min depends on the previous row:
// the x row's load and its prefix sums S do not. So the block splits them.
//
// One block per matrix (batch rides the grid), two roles:
// - Producer warps (eight, or four for wide rows) take one row each in
//   turn. A warp copies its x row with cp.async into the row's stage of a
//   ring of shared memory, one of its rows ahead, then turns it in place into
//   SP[c] = S[c - 1] (SP[0] = 0): each lane a contiguous chunk of f64 sums,
//   a warp scan of the chunks' totals, each sum rounded to f32 once. It
//   hands the stage over on an mbarrier (full); when the consumers are done
//   with it (done) the stage holds the finished row, which the warp copies
//   to `cost` with coalesced stores before it refills the stage. No barrier
//   joins the producers, and no producer work sits on the chain.
// - One consumer warpgroup walks the chain with the previous row in
//   registers, each thread PER contiguous columns. The warps form a
//   wavefront over the column blocks: warp k works on row i while warp k-1
//   may be rows ahead. A warp takes A and its local prefix minima from its
//   own registers and its left lane's (a shuffle) and scans them across its
//   lanes before it needs anything from the warp on its left; then it waits
//   for that warp's carry (the prefix minimum of every column left of it,
//   and C[i-1, j-1] - S[j-1] for its first column j: min(a, b) - s =
//   min(a - s, b - s) exactly in floating point), passes its own carry on
//   at once (one 64-bit shared store, tagged with the row), and finishes
//   the row, which it writes back into the stage. No block barrier sits on
//   the chain, and the consumers touch no device memory.
//
// The prefix sums run in f64 and round to f32 once per entry, as the plain
// version's f64 cumsum does, so both produce the same f32 values, and the
// traceback's strict-< comparisons see identical costs. The prefix min is
// exact in any order.
#include "common.cuh"

namespace {

constexpr int DTW_CONSUMERS = 128;  // one warpgroup walks the row chain
constexpr int DTW_NW = DTW_CONSUMERS / 32;
constexpr int DTW_MAX_M = 4096;
constexpr float DTW_INF = 1e30f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// Shared memory: STAGES stages of W + 4 floats (W = DTW_CONSUMERS * PER
// columns), one row each: x (at X_AT), then SP, then the finished row
// (column c at c). Fewer stages for wide rows keep it under 227 KB; a
// producer warp keeps two, so that it copies one row while the consumers
// still hold the other.
template <int PER>
struct DtwSmem {
  static constexpr int W = DTW_CONSUMERS * PER;
  static constexpr int STAGES = PER <= 24 ? 16 : 8;
  static constexpr int STAGE = W + 4;
  static constexpr int FLOATS = STAGES * STAGE;
  static constexpr int PRODUCERS = STAGES / 2;  // warps
  static constexpr int THREADS = DTW_CONSUMERS + 32 * PRODUCERS;
  // Up to 1536 columns a producer lane keeps its chunk's sums in registers
  // (one f32 -> f64 conversion a value, x copied 16 bytes at a time to
  // [4, m + 4)); wider rows take two passes over the chunk in place, x at
  // [1, m + 1).
  static constexpr bool IN_REGS = PER <= 12;
  static constexpr int CHUNK = 4 * PER + 1;  // the most columns a lane sums
  static constexpr int X_AT = IN_REGS ? 4 : 1;
};

template <int PER>
__global__ void __launch_bounds__(DtwSmem<PER>::THREADS, 1)
dtw_cost_kernel(const float* __restrict__ x, float* __restrict__ cost, int n, int m) {
  using L = DtwSmem<PER>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ uint64_t full[L::STAGES], done[L::STAGES];
  // carry[k][s]: warp k's carry for the row in stage s, tagged (row << 32 | bits)
  __shared__ unsigned long long carry[DTW_NW - 1][L::STAGES];

  const int tid = threadIdx.x, lane = tid & 31;
  const float* xb = x + static_cast<long long>(blockIdx.x) * n * m;
  float* cb = cost + static_cast<long long>(blockIdx.x) * (n + 1) * (m + 1);

  // columns past m never reach `cost` and feed only columns past m; zeros
  // (and then the rows' finite values) keep them finite
  for (int k = tid; k < L::FLOATS; k += L::THREADS) smem[k] = 0.f;
  if (tid < (DTW_NW - 1) * L::STAGES) (&carry[0][0])[tid] = ~0ull;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);       // the row's producer warp
      mbar_init(&done[s], DTW_NW);  // one arrival a consumer warp
    }
  }
  __syncthreads();

  if (tid < DTW_CONSUMERS) {
    // -- consumers: the row chain, a wavefront of warps over column blocks ---------------
    const int warp = tid >> 5, c0 = tid * PER;  // columns c0 .. c0 + PER - 1 (cost col c + 1)
    float prev[PER];                           // C[i-1, c + 1] of this thread's columns
#pragma unroll
    for (int e = 0; e < PER; ++e) prev[e] = DTW_INF;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int s = i % L::STAGES;
      float* st = smem + s * L::STAGE;
      mbar_wait(&full[s], (i / L::STAGES) & 1);
      float sp[PER + 1];  // SP[c0 .. c0 + PER]: S of column c is sp[c - c0 + 1]
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(st + c0 + 4 * q);
        sp[4 * q] = v.x;
        sp[4 * q + 1] = v.y;
        sp[4 * q + 2] = v.z;
        sp[4 * q + 3] = v.w;
      }
      sp[PER] = st[c0 + PER];

      // C[i-1, c0] from the left lane; a warp's first lane takes it through
      // the left warp's carry (only C[i-1, 0] is its own)
      float left = __shfl_up_sync(FULL_MASK, prev[PER - 1], 1);
      if (lane == 0) left = (warp == 0 && i == 0) ? 0.f : DTW_INF;
      float gmin[PER];
      float run = fminf(left, prev[0]) - sp[0];
      gmin[0] = run;
#pragma unroll
      for (int e = 1; e < PER; ++e) {
        run = fminf(run, fminf(prev[e - 1], prev[e]) - sp[e]);
        gmin[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nb = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl = fminf(incl, nb);
      }
      float excl = __shfl_up_sync(FULL_MASK, incl, 1);
      if (lane == 0) excl = DTW_INF;
      // what this warp hands every later column: its minima, and the next
      // warp's first column's C[i-1, j-1] - S[j-1]
      const float own = __shfl_sync(FULL_MASK, fminf(incl, prev[PER - 1] - sp[PER]), 31);

      float cin = DTW_INF;
      if (warp > 0) {
        const volatile unsigned long long* slot = &carry[warp - 1][s];
        unsigned long long v;
        do {
          v = *slot;
        } while (static_cast<unsigned>(v >> 32) != static_cast<unsigned>(i));
        cin = __uint_as_float(static_cast<unsigned>(v));
      }
      if (warp < DTW_NW - 1)  // every lane alike: a one-lane section costs the chain more
        *reinterpret_cast<volatile unsigned long long*>(&carry[warp][s]) =
            (static_cast<unsigned long long>(i) << 32) | __float_as_uint(fminf(cin, own));

      const float moff = fminf(cin, excl);
#pragma unroll
      for (int e = 0; e < PER; ++e) prev[e] = fminf(sp[e + 1] + fminf(moff, gmin[e]), DTW_INF);
      // every lane of this warp has read its SP (the right warp writes its
      // first SP only after this warp's carry); the row goes where SP was
      __syncwarp();
#pragma unroll
      for (int q = 0; q < PER / 4; ++q)
        *reinterpret_cast<float4*>(st + c0 + 4 * q) =
            make_float4(prev[4 * q], prev[4 * q + 1], prev[4 * q + 2], prev[4 * q + 3]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&done[s]);
    }
    return;
  }

  // -- producers: x rows in, prefix sums, finished rows out --------------------------
  const int pw = (tid - DTW_CONSUMERS) >> 5;
  // each lane a contiguous chunk of columns, an odd number of them: the
  // lanes' reads then fall on 32 different banks
  const int chunk = (m + 31) / 32 | 1, b0 = min(lane * chunk, m), b1 = min(b0 + chunk, m);

  if (pw == 0)
    for (int j = lane; j <= m; j += 32) cb[j] = j == 0 ? 0.f : DTW_INF;

  // copy finished row i (cost row i + 1) out of its stage
  auto store_row = [&](int i) {
    const int s = i % L::STAGES;
    mbar_wait(&done[s], (i / L::STAGES) & 1);
    const float* st = smem + s * L::STAGE;
    float* crow = cb + static_cast<long long>(i + 1) * (m + 1);
    for (int j = lane; j < m; j += 32) crow[j + 1] = st[j];
    if (lane == 0) crow[0] = DTW_INF;
    __syncwarp();  // every lane has read the row before the stage refills
  };
  // x row i into its stage at X_AT, once the row before it there is out
  const bool vec = L::IN_REGS && m % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  auto fetch_row = [&](int i) {
    if (i >= L::STAGES) store_row(i - L::STAGES);
    float* dst = smem + (i % L::STAGES) * L::STAGE + L::X_AT;
    const float* src = xb + static_cast<long long>(i) * m;
    if (vec) {
      for (int c = 4 * lane; c < m; c += 128) cp_async16(dst + c, src + c);
    } else {
      for (int c = lane; c < m; c += 32) cp_async4(dst + c, src + c);
    }
    cp_async_commit();
  };

  if (pw < n) fetch_row(pw);
#pragma unroll 1
  for (int i = pw; i < n; i += L::PRODUCERS) {
    float* st = smem + (i % L::STAGES) * L::STAGE;
    cp_async_wait<0>();
    __syncwarp();
    // S[c] = off + loc[c]: off the lane's exclusive prefix over the warp,
    // loc its own running sum, both f64, rounded to f32 once
    auto warp_offset = [&](double total) {
      double incl = total;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double nb = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += nb;
      }
      const double off = __shfl_up_sync(FULL_MASK, incl, 1);
      return lane == 0 ? 0.0 : off;
    };
    if constexpr (L::IN_REGS) {
      double loc[L::CHUNK];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < L::CHUNK; ++k) {
        if (b0 + k < b1) run += static_cast<double>(st[b0 + k + L::X_AT]);
        loc[k] = run;
      }
      const double off = warp_offset(run);
      __syncwarp();  // every lane has read its x before S lands on it
#pragma unroll
      for (int k = 0; k < L::CHUNK; ++k)
        if (b0 + k < b1) st[b0 + k + 1] = static_cast<float>(off + loc[k]);
    } else {
      double run = 0.0;
      for (int c = b0; c < b1; ++c) run += static_cast<double>(st[c + 1]);
      const double off = warp_offset(run);
      // S[c] in place of x[c] at c + 1: each lane reads before it writes, its own chunk
      double loc = 0.0;
      for (int c = b0; c < b1; ++c) {
        loc += static_cast<double>(st[c + 1]);
        st[c + 1] = static_cast<float>(off + loc);
      }
    }
    if (lane == 0) st[0] = 0.f;
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[i % L::STAGES]);
    if (i + L::PRODUCERS < n) fetch_row(i + L::PRODUCERS);
  }
  // the rows no later fill of their stage copied out
  for (int i = pw; i < n; i += L::PRODUCERS)
    if (i + L::STAGES >= n) store_row(i);
}

template <int PER>
int launch(const float* x, float* cost, int batch, int n, int m, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(DtwSmem<PER>::FLOATS) * sizeof(float);
  const cudaError_t e = allow_dynamic_smem(dtw_cost_kernel<PER>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dtw_cost_kernel<PER><<<batch, DtwSmem<PER>::THREADS, smem, stream>>>(x, cost, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, n, m) f32 contiguous; cost: (batch, n + 1, m + 1) f32.
extern "C" int dtw_cost(const void* x, void* cost, int batch, int n, int m,
                        void* stream) {
  if (m < 1 || m > DTW_MAX_M || n < 0 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* cp = static_cast<float*>(cost);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the fewest columns a consumer thread can hold
  if (m <= DTW_CONSUMERS * 4) return launch<4>(xp, cp, batch, n, m, st);
  if (m <= DTW_CONSUMERS * 8) return launch<8>(xp, cp, batch, n, m, st);
  if (m <= DTW_CONSUMERS * 12) return launch<12>(xp, cp, batch, n, m, st);
  if (m <= DTW_CONSUMERS * 16) return launch<16>(xp, cp, batch, n, m, st);
  if (m <= DTW_CONSUMERS * 24) return launch<24>(xp, cp, batch, n, m, st);
  return launch<32>(xp, cp, batch, n, m, st);
}
