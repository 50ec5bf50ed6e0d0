// Weight-only int8 matmul: out = (x @ q^T) * scale, f32 accumulation.
//
// Replaces stable_ts_tpu/ops/woq_matmul.py:_kernel (int8_matmul), the
// product of every quantized (dq) linear: x (M, K) f32 or bf16 against the
// int8 weight q with one f32 scale per output column, applied once after
// the K-sum (it factors out of it). The weight is kept as torch's (N, K)
// row-major int8, so output column n's K weights are one contiguous row.
// No dequantized copy of the weight exists; int8 widens to f32 in
// registers.
//
// What bounds it on the card, and the two regimes of the one entry:
//   - Decode (M <= WOQ_GEMV_MAX_M): bytes. A step multiplies one or a few
//     rows by each weight once, 2 M operations per weight byte. One warp per
//     output column reads the column's K bytes with 16-byte loads, widens
//     them to f32 and multiplies them against the x rows held in shared
//     memory (in K tiles of WOQ_KT values, up to WOQ_GEMV_ROWS rows per
//     block; more rows take more blocks, each reading the weight again),
//     reduces across the warp and scales the sum once.
//   - M > WOQ_GEMV_MAX_M (the encoder, the timing pass, prefill): operations.
//     A WOQ_TM x WOQ_TN output tile per block, K in steps of WOQ_TK through
//     shared memory (x widened to f32, the int8 weight widened to f32), a
//     4 x 4 register tile per thread, on the CUDA cores' f32 FMA (67 TFLOP/s
//     peak on an H100 SXM). Feeding the tensor cores with bf16 tiles widened
//     from int8 in shared memory is the faster design, for a later change.
// K must be a multiple of 16 (16-byte weight rows); the wrapper checks.
#include "common.cuh"

namespace {

constexpr int WOQ_THREADS = 256;
constexpr int WOQ_WARPS = WOQ_THREADS / 32;
constexpr int WOQ_GEMV_MAX_M = 16;   // rows taken by the decode regime
constexpr int WOQ_GEMV_ROWS = 8;     // x rows per block in the decode regime
constexpr int WOQ_KT = 1024;         // K values of x per shared tile (decode)
constexpr int WOQ_TM = 64, WOQ_TN = 64, WOQ_TK = 32;  // tiled regime

// Decode regime: one warp per output column, RB x rows per block.
template <typename T, int RB>
__global__ void __launch_bounds__(WOQ_THREADS)
woq_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, float* __restrict__ out,
                int m, int n, int k) {
  __shared__ __align__(16) float xs[RB][WOQ_KT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * WOQ_WARPS + warp;
  const int r0 = blockIdx.y * RB;
  const int rows = min(RB, m - r0);
  const int8_t* qrow = q + static_cast<long long>(col) * k;

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < k; k0 += WOQ_KT) {
    const int kt = min(WOQ_KT, k - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < rows * kt; i += WOQ_THREADS)
      xs[i / kt][i % kt] = to_float(x[static_cast<long long>(r0 + i / kt) * k + k0 + i % kt]);
    __syncthreads();
    if (col < n) {
      for (int c = lane * 16; c < kt; c += 32 * 16) {
        float w[16];
        load16(qrow + k0 + c, w);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < rows) {
            const float4* xr = reinterpret_cast<const float4*>(&xs[r][c]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 xv = xr[j];
              acc[r] = fmaf(xv.x, w[4 * j], acc[r]);
              acc[r] = fmaf(xv.y, w[4 * j + 1], acc[r]);
              acc[r] = fmaf(xv.z, w[4 * j + 2], acc[r]);
              acc[r] = fmaf(xv.w, w[4 * j + 3], acc[r]);
            }
          }
        }
      }
    }
  }
  if (col < n) {
    const float s = scale[col];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rows) {
        float f = acc[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(FULL_MASK, f, o);
        if (lane == 0) out[static_cast<long long>(r0 + r) * n + col] = f * s;
      }
    }
  }
}

// Tiled regime: a WOQ_TM x WOQ_TN output tile per block, 4 x 4 per thread.
template <typename T>
__global__ void __launch_bounds__(WOQ_THREADS)
woq_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int m, int n, int k) {
  constexpr int VN = Vec16<T>::N;        // x values per 16-byte load
  // K-major tiles: a thread reads 4 consecutive rows (columns) as one float4
  __shared__ __align__(16) float xs[WOQ_TK][WOQ_TM + 4];
  __shared__ __align__(16) float ws[WOQ_TK][WOQ_TN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * WOQ_TM, n0 = blockIdx.x * WOQ_TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += WOQ_TK) {
    for (int i = tid; i < WOQ_TM * (WOQ_TK / VN); i += WOQ_THREADS) {
      const int r = i / (WOQ_TK / VN), c = (i % (WOQ_TK / VN)) * VN;
      float v[VN];
      if (m0 + r < m && k0 + c < k) {
        load16(x + static_cast<long long>(m0 + r) * k + k0 + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) xs[c + e][r] = v[e];
    }
    for (int i = tid; i < WOQ_TN * (WOQ_TK / 16); i += WOQ_THREADS) {
      const int r = i / (WOQ_TK / 16), c = (i % (WOQ_TK / 16)) * 16;
      float v[16];
      if (n0 + r < n && k0 + c < k) {
        load16(q + static_cast<long long>(n0 + r) * k + k0 + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) ws[c + e][r] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WOQ_TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) out[static_cast<long long>(row) * n + col] = acc[i][j] * scale[col];
    }
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int m,
           int n, int k, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (m <= WOQ_GEMV_MAX_M) {
    const int cols = (n + WOQ_WARPS - 1) / WOQ_WARPS;
    if (m == 1) {
      woq_gemv_kernel<T, 1><<<dim3(cols, 1), WOQ_THREADS, 0, stream>>>(xp, qp, sp, op, m, n, k);
    } else {
      const dim3 grid(cols, (m + WOQ_GEMV_ROWS - 1) / WOQ_GEMV_ROWS);
      woq_gemv_kernel<T, WOQ_GEMV_ROWS><<<grid, WOQ_THREADS, 0, stream>>>(xp, qp, sp, op, m, n, k);
    }
  } else {
    const dim3 grid((n + WOQ_TN - 1) / WOQ_TN, (m + WOQ_TM - 1) / WOQ_TM);
    woq_tiled_kernel<T><<<grid, WOQ_THREADS, 0, stream>>>(xp, qp, sp, op, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) contiguous f32 or bf16 (dtype code); q (N, K) contiguous int8;
// scale (N,) f32; out (M, N) f32. K % 16 == 0, all pointers 16-byte aligned.
extern "C" int woq_matmul(const void* x, const void* q, const void* scale,
                          void* out, int dtype, int m, int n, int k,
                          void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_BF16: return launch<__nv_bfloat16>(x, q, scale, out, m, n, k, st);
    case DT_F32: return launch<float>(x, q, scale, out, m, n, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
