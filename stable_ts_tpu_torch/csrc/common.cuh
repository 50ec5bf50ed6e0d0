// Shared helpers of the package's CUDA kernels (built by _build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes: keep in step with _build.py (DTYPE_F32, DTYPE_BF16, DTYPE_I8,
// DTYPE_I4)
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I4 = 3 };

constexpr unsigned FULL_MASK = 0xffffffffu;

// Two int4 values in one byte (the port's packed int4 layout): dim 2i in the
// low nibble, dim 2i + 1 in the high nibble, each sign-extended on load.
struct Int4x2 {
  int8_t raw;
};

// Logical values per storage element of T: 2 for packed int4, else 1.
template <typename T> struct Pack { static constexpr int V = 1; };
template <> struct Pack<Int4x2> { static constexpr int V = 2; };

// p advanced by ``values`` logical values (a multiple of Pack<T>::V).
template <typename T>
__device__ __forceinline__ const T* at(const T* p, long long values) {
  return p + values / Pack<T>::V;
}

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

// Logical values of T in BYTES bytes.
template <typename T, int BYTES> struct VecB {
  static constexpr int N = BYTES / static_cast<int>(sizeof(T)) * Pack<T>::V;
};
template <typename T> struct Vec16 { static constexpr int N = VecB<T, 16>::N; };

template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = unsigned; };

// One BYTES-byte load at p (BYTES-aligned), widened to VecB<T, BYTES>::N
// floats in logical order.
template <int BYTES, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  using Raw = typename RawVec<BYTES>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  if constexpr (Pack<T>::V == 2) {
    // little-endian: nibble n of 32-bit word i is logical value 8 i + n;
    // shift it to the top, then an arithmetic shift sign-extends it
    const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        out[8 * i + n] = static_cast<float>(static_cast<int>(w[i] << (28 - 4 * n)) >> 28);
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VecB<T, BYTES>::N; ++i) out[i] = to_float(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) { load_vec<16>(p, out); }

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
