// Decode attention: one query row per (batch row, head) against a cache.
//
// Replaces two TPU kernels of stable_ts_tpu:
//   - ops/self_attn.py:_kernel (self_attn_decode): keys j <= pos of the
//     int8 row cache of the decode step's self-attention;
//   - ops/cross_attn.py:_kernel (cross_attn_decode, the g = 1 8-bit
//     branch): keys j < s of the precomputed cross-attention K/V.
//
// What bounds it on the card: bytes. A decode step reads each cache row
// once and does 2 multiply-adds per byte, far below the ~295 FLOP/byte the
// H100 needs before compute matters. So the kernel reads every K and V row
// exactly once, with 16-byte loads along d (the row-major (.., S, d) layout
// makes a head's slice of a row contiguous), widens int8/bf16 to f32 in
// registers with the per-position dequant scale applied to the logit and
// weight rows, and never writes a dequantized copy or the logits to device
// memory. Softmax runs in f32 in shared memory.
//
// One block per (head, batch row); 128 threads:
//   1. each thread scores key rows j = tid, tid + 128, ... (q . k_j) * ks[j];
//   2. block max / sum -> unnormalized weights p_j * vs[j] in shared memory;
//   3. V: the head's d_head slice of a row is CPR 16-byte chunks; 128 / CPR
//      row groups each accumulate a partial sum over their rows, reduced in
//      shared memory; out = sum / l.
// The cross entry rounds the query and the weights to bf16 before the two
// products, as the TPU kernel does for its MXU (cross_attn.py:107,129);
// the self entry keeps them in f32, as the XLA cache path does.
#include "common.cuh"

namespace {

constexpr int DEC_THREADS = 128;

template <typename T, int DH, bool ROUND>
__global__ void __launch_bounds__(DEC_THREADS)
decode_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, float* __restrict__ out,
                   int n_head, int n_keys, long long kv_bs, long long kv_rs,
                   long long sc_bs) {
  constexpr int VN = Vec16<T>::N;        // elements per 16-byte chunk
  constexpr int CPR = DH / VN;           // chunks per head row
  constexpr int GROUPS = DEC_THREADS / CPR;
  static_assert(DH % VN == 0, "d_head must fill whole 16-byte chunks");

  extern __shared__ float p[];           // n_keys scores, then weights
  __shared__ float qs[DH];
  __shared__ float part[GROUPS][DH];
  __shared__ float scratch[DEC_THREADS / 32];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int d = n_head * DH;
  const T* kb = k + b * kv_bs + h * DH;
  const T* vb = v + b * kv_bs + h * DH;
  const float* ksb = ks ? ks + b * sc_bs : nullptr;
  const float* vsb = vs ? vs + b * sc_bs : nullptr;

  if (tid < DH) {
    const float qv = q[(long long)b * d + h * DH + tid];
    qs[tid] = ROUND ? round_bf16(qv) : qv;
  }
  __syncthreads();

  // 1. scores
  float lmax = -INFINITY;
  for (int j = tid; j < n_keys; j += DEC_THREADS) {
    const T* row = kb + j * kv_rs;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      float kv[VN];
      load16(row + c * VN, kv);
#pragma unroll
      for (int e = 0; e < VN; ++e) acc = fmaf(qs[c * VN + e], kv[e], acc);
    }
    const float s = ksb ? acc * ksb[j] : acc;
    p[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_reduce<DEC_THREADS>(lmax, -INFINITY, MaxOp(), scratch);

  // 2. weights
  float lsum = 0.f;
  for (int j = tid; j < n_keys; j += DEC_THREADS) {
    const float e = expf(p[j] - m);
    lsum += e;
    const float w = vsb ? e * vsb[j] : e;
    p[j] = ROUND ? round_bf16(w) : w;
  }
  const float l = block_reduce<DEC_THREADS>(lsum, 0.f, SumOp(), scratch);

  // 3. weighted sum of V rows
  const int chunk = tid % CPR, group = tid / CPR;
  float acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
  for (int j = group; j < n_keys; j += GROUPS) {
    float vv[VN];
    load16(vb + j * kv_rs + chunk * VN, vv);
    const float w = p[j];
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] = fmaf(w, vv[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < VN; ++e) part[group][chunk * VN + e] = acc[e];
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
    for (int g = 0; g < GROUPS; ++g) o += part[g][tid];
    out[(long long)b * d + h * DH + tid] = o / l;
  }
}

template <typename T, bool ROUND>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* out, int batch, int n_head, int d_head,
           int n_keys, long long kv_bs, long long kv_rs, long long sc_bs,
           cudaStream_t stream) {
  const dim3 grid(n_head, batch);
  const size_t smem = static_cast<size_t>(n_keys) * sizeof(float);
#define DEC_LAUNCH(DH)                                                        \
  decode_attn_kernel<T, DH, ROUND><<<grid, DEC_THREADS, smem, stream>>>(       \
      static_cast<const float*>(q), static_cast<const T*>(k),                 \
      static_cast<const T*>(v), static_cast<const float*>(ks),                \
      static_cast<const float*>(vs), static_cast<float*>(out), n_head, n_keys, \
      kv_bs, kv_rs, sc_bs)
  switch (d_head) {
    case 32: DEC_LAUNCH(32); break;
    case 64: DEC_LAUNCH(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEC_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <bool ROUND>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, void* out, int dtype, int batch, int n_head,
             int d_head, int n_keys, long long kv_bs, long long kv_rs,
             long long sc_bs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_I8:
      return launch<int8_t, ROUND>(q, k, v, ks, vs, out, batch, n_head, d_head,
                                   n_keys, kv_bs, kv_rs, sc_bs, st);
    case DT_BF16:
      return launch<__nv_bfloat16, ROUND>(q, k, v, ks, vs, out, batch, n_head,
                                          d_head, n_keys, kv_bs, kv_rs, sc_bs, st);
    case DT_F32:
      return launch<float, ROUND>(q, k, v, ks, vs, out, batch, n_head, d_head,
                                  n_keys, kv_bs, kv_rs, sc_bs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements: row (b, j) of head h starts at
// k + b * kv_bs + j * kv_rs + h * d_head; its scale at ks[b * sc_bs + j].
// ks / vs may be null (a float cache: scale 1).
extern "C" int self_attn_decode(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, void* out,
                                int dtype, int batch, int n_head, int d_head,
                                int n_keys, long long kv_bs, long long kv_rs,
                                long long sc_bs, void* stream) {
  return dispatch<false>(q, k, v, ks, vs, out, dtype, batch, n_head, d_head,
                         n_keys, kv_bs, kv_rs, sc_bs, stream);
}

extern "C" int cross_attn_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs, void* out,
                                 int dtype, int batch, int n_head, int d_head,
                                 int n_keys, long long kv_bs, long long kv_rs,
                                 long long sc_bs, void* stream) {
  return dispatch<true>(q, k, v, ks, vs, out, dtype, batch, n_head, d_head,
                        n_keys, kv_bs, kv_rs, sc_bs, stream);
}
