// Streamed vocab projection: logits = x @ emb^T, f32 accumulation.
//
// Replaces stable_ts_tpu/ops/vocab_proj.py:_kernel (vocab_logits_kernel),
// the tied-embedding logits of every beam and sampled decode step: x (M, d)
// in the embedding's dtype (bf16 or f32) against emb (V, d), giving (M, V)
// f32 logits.
//
// What bounds it on the card: bytes. A step streams the whole (V, d) table
// (133 MB in bf16 at large-v3) for a handful of rows, about 2 M operations
// per byte. So the table is read in one pass, as it is stored, with 16-byte
// loads: each block owns VP_TILE vocab rows, each warp VP_TILE / VP_WARPS of
// them, a row read once across the lanes and multiplied against every x row
// of the block's chunk (held in shared memory as f32), the sums reduced
// across the warp and each logit written once. No transposed or widened
// copy of the table exists. A chunk holds at most VP_ROWS rows; larger M
// takes more chunks, each reading the table again.
#include "common.cuh"

namespace {

constexpr int VP_THREADS = 256;
constexpr int VP_WARPS = VP_THREADS / 32;
constexpr int VP_TILE = 64;   // vocab rows per block
constexpr int VP_ROWS = 16;   // x rows per block

template <typename T>
__global__ void __launch_bounds__(VP_THREADS)
vocab_proj_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                  float* __restrict__ out, int m, int d, int n_vocab) {
  constexpr int VN = Vec16<T>::N;
  extern __shared__ float xs[];  // min(m, VP_ROWS) * d
  const int r0 = blockIdx.y * VP_ROWS;
  const int rows = min(VP_ROWS, m - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < rows * d; i += VP_THREADS)
    xs[i] = to_float(x[static_cast<long long>(r0) * d + i]);
  __syncthreads();

  const int chunks = d / VN;
  const int v_begin = blockIdx.x * VP_TILE + warp * (VP_TILE / VP_WARPS);
  const int v_end = min(v_begin + VP_TILE / VP_WARPS, n_vocab);
  for (int v = v_begin; v < v_end; ++v) {
    const T* row = emb + static_cast<long long>(v) * d;
    float acc[VP_ROWS];
#pragma unroll
    for (int r = 0; r < VP_ROWS; ++r) acc[r] = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float e[VN];
      load16(row + c * VN, e);
#pragma unroll
      for (int r = 0; r < VP_ROWS; ++r) {
        if (r < rows) {
          // d % VN == 0 and VN % 4 == 0: 16-byte aligned shared reads
          const float4* xr = reinterpret_cast<const float4*>(xs + r * d + c * VN);
#pragma unroll
          for (int j = 0; j < VN / 4; ++j) {
            const float4 q = xr[j];
            acc[r] = fmaf(q.x, e[4 * j], acc[r]);
            acc[r] = fmaf(q.y, e[4 * j + 1], acc[r]);
            acc[r] = fmaf(q.z, e[4 * j + 2], acc[r]);
            acc[r] = fmaf(q.w, e[4 * j + 3], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < VP_ROWS; ++r) {
      if (r < rows) {
        float f = acc[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(FULL_MASK, f, o);
        if (lane == 0) out[static_cast<long long>(r0 + r) * n_vocab + v] = f;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* emb, void* out, int m, int d,
           int n_vocab, cudaStream_t stream) {
  if (d % Vec16<T>::N != 0) return static_cast<int>(cudaErrorInvalidValue);
  // only the rows a block holds, so a one-row step keeps blocks small
  const size_t smem = static_cast<size_t>(m < VP_ROWS ? m : VP_ROWS) * d * sizeof(float);
  const cudaError_t e = allow_dynamic_smem(vocab_proj_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_vocab + VP_TILE - 1) / VP_TILE, (m + VP_ROWS - 1) / VP_ROWS);
  vocab_proj_kernel<T><<<grid, VP_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(emb), static_cast<float*>(out),
      m, d, n_vocab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, d) and emb (V, d): contiguous, the same dtype (bf16 or f32), rows of
// 16-byte multiples; out (M, V) f32.
extern "C" int vocab_proj(const void* x, const void* emb, void* out, int dtype,
                          int m, int d, int n_vocab, void* stream) {
  if (m < 1 || n_vocab < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_BF16: return launch<__nv_bfloat16>(x, emb, out, m, d, n_vocab, st);
    case DT_F32: return launch<float>(x, emb, out, m, d, n_vocab, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
