// Flash attention forward: out = softmax(q k^T * scale) v, non-causal.
//
// Replaces the TPU's Pallas flash attention (jax.experimental.pallas.ops.
// tpu.flash_attention, called from stable_ts_tpu/models/whisper/model.py:
// _flash_self_attention for the encoder and _flash_cross_attention for the
// teacher-forced timing pass). The TPU padded the sequence to 128 and
// masked the pad with segment ids; here the kernel masks keys j >= S itself
// and never stores query rows t >= T, so nothing is padded.
//
// What bounds it on the card: operations. At Whisper's 1500 x 1500 x 64
// per head the scores are 1500 FLOP per byte of Q/K/V read. The point of
// the design is the same as on the TPU: the (T, S) scores never reach
// device memory. This first version runs the products on the f32 CUDA
// cores, not the tensor cores (wgmma comes in a later change):
//   - one block per (64-query tile, head, batch row), one thread per query
//     row, the row's scaled q and its f32 accumulator in registers;
//   - K and V stream through shared memory in 64-key tiles, loaded with
//     16-byte vector loads and widened to f32 (every thread then reads the
//     same key row: a shared-memory broadcast);
//   - online softmax in f32, updated once per 16 keys.
// Rows are addressed by (batch, row) strides so q/k/v may be views of
// (B, T, n_head * d_head) projections: no head split or merge copies.
// For the backward (flash_attn_bwd.cu) the kernel can also write each
// row's logsumexp, m + log(l), which the TPU kernel keeps as its l and m
// residuals; inference passes a null pointer and writes nothing more.
#include "common.cuh"

namespace {

constexpr int FA_BQ = 64;   // query rows per block = threads per block
constexpr int FA_BK = 64;   // keys per shared-memory tile
constexpr int FA_SUB = 16;  // keys per online-softmax update

template <typename T, int DH>
__global__ void __launch_bounds__(FA_BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len,
                 int s_len, long long q_sb, long long q_st, long long k_sb,
                 long long k_st, long long v_sb, long long v_st,
                 long long o_sb, long long o_st, float scale) {
  constexpr int VN = Vec16<T>::N;
  constexpr int CPR = DH / VN;  // 16-byte chunks per head row
  static_assert(DH % VN == 0, "d_head must fill whole 16-byte chunks");
  __shared__ __align__(16) float ks[FA_BK][DH];
  __shared__ __align__(16) float vs[FA_BK][DH];

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * FA_BQ + tid;
  const bool live = row < t_len;        // rows past T compute, never store
  const int row_c = live ? row : t_len - 1;

  const T* qb = q + b * q_sb + h * DH;
  const T* kb = k + b * k_sb + h * DH;
  const T* vb = v + b * v_sb + h * DH;

  float qr[DH];
#pragma unroll
  for (int c = 0; c < CPR; ++c) {
    load16(qb + row_c * q_st + c * VN, qr + c * VN);
  }
#pragma unroll
  for (int e = 0; e < DH; ++e) qr[e] *= scale;

  float acc[DH];
#pragma unroll
  for (int e = 0; e < DH; ++e) acc[e] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < FA_BK * CPR; idx += FA_BQ) {
      const int r = idx / CPR, c = idx % CPR;
      const int j = t0 + r;
      float kv[VN], vv[VN];
      if (j < s_len) {
        load16(kb + j * k_st + c * VN, kv);
        load16(vb + j * v_st + c * VN, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[r][c * VN + e] = kv[e];
        vs[r][c * VN + e] = vv[e];
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int sub = 0; sub < FA_BK; sub += FA_SUB) {
      float s[FA_SUB];
      float smax = m;
#pragma unroll
      for (int jj = 0; jj < FA_SUB; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DH; ++e) dot = fmaf(qr[e], ks[sub + jj][e], dot);
        s[jj] = (t0 + sub + jj < s_len) ? dot : -INFINITY;
        smax = fmaxf(smax, s[jj]);
      }
      // smax is finite: key 0 is always real and comes first
      const float corr = expf(m - smax);
      m = smax;
      l *= corr;
#pragma unroll
      for (int e = 0; e < DH; ++e) acc[e] *= corr;
#pragma unroll
      for (int jj = 0; jj < FA_SUB; ++jj) {
        const float pj = expf(s[jj] - m);
        l += pj;
#pragma unroll
        for (int e = 0; e < DH; ++e) acc[e] = fmaf(pj, vs[sub + jj][e], acc[e]);
      }
    }
  }

  if (live) {
    const float inv = 1.f / l;
    T* ob = o + b * o_sb + row * o_st + h * DH;
#pragma unroll
    for (int e = 0; e < DH; ++e) ob[e] = from_float<T>(acc[e] * inv);
    // lse is (B, H, T) f32: gridDim.y is the head count
    if (lse != nullptr) lse[(static_cast<long long>(b) * gridDim.y + h) * t_len + row] = m + logf(l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int n_head, int t_len, int s_len, int d_head, long long q_sb,
           long long q_st, long long k_sb, long long k_st, long long v_sb,
           long long v_st, long long o_sb, long long o_st, float scale,
           cudaStream_t stream) {
  const dim3 grid((t_len + FA_BQ - 1) / FA_BQ, n_head, batch);
#define FA_LAUNCH(DH)                                                      \
  flash_fwd_kernel<T, DH><<<grid, FA_BQ, 0, stream>>>(                     \
      static_cast<const T*>(q), static_cast<const T*>(k),                  \
      static_cast<const T*>(v), static_cast<T*>(o), lse, t_len, s_len, q_sb, \
      q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, scale)
  switch (d_head) {
    case 32: FA_LAUNCH(32); break;
    case 64: FA_LAUNCH(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o: row t of head h of batch b starts at ptr + b * sb + t * st +
// h * d_head (strides in elements); dtype is f32 or bf16 for all four.
// lse: null, or an f32 (B, H, T) array that receives each row's logsumexp
// of the scaled scores.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int batch, int n_head,
                              int t_len, int s_len, int d_head, long long q_sb,
                              long long q_st, long long k_sb, long long k_st,
                              long long v_sb, long long v_st, long long o_sb,
                              long long o_st, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_len <= 0 || s_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case DT_BF16:
      return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), batch,
                                   n_head, t_len, s_len,
                                   d_head, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                   o_sb, o_st, scale, st);
    case DT_F32:
      return launch<float>(q, k, v, o, static_cast<float*>(lse), batch, n_head,
                           t_len, s_len, d_head,
                           q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st,
                           scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
