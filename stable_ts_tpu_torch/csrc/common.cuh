// Shared helpers of the package's CUDA kernels (built by _build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes: keep in step with _build.py (DTYPE_F32, DTYPE_BF16, DTYPE_I8)
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch and jnp casts
}

// f32 -> bf16 -> f32, round to nearest even
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

// One 16-byte load at p (16-byte aligned), widened to Vec16<T>::N floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_float(e[i]);
}

// Elements of T in one 8-byte vector, and one 8-byte load (8-byte aligned).
template <typename T> struct Vec8 { static constexpr int N = 8 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec8<T>::N; ++i) out[i] = to_float(e[i]);
}

// Let a kernel take ``bytes`` of dynamic shared memory: a block whose static
// plus dynamic shared memory passes 48 KB needs this opt-in.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// Reduce v over the block (NT threads, a multiple of 32); every thread gets
// the result. scratch: NT / 32 floats of shared memory.
template <int NT, typename Op>
__device__ __forceinline__ float block_reduce(float v, float identity, Op op, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL_MASK, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < NT / 32 ? scratch[lane] : identity;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = op(w, __shfl_xor_sync(FULL_MASK, w, o));
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  const float r = scratch[0];
  __syncthreads();  // scratch may be reused right after
  return r;
}
