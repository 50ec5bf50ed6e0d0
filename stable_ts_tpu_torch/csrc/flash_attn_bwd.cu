// Flash attention backward: dK and dV (flash_attn_bwd_dkv) and dQ
// (flash_attn_bwd_dq) of out = softmax(q k^T * scale) v, non-causal.
//
// Replaces the backward of the TPU's Pallas flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd,
// which launches _flash_attention_bwd_dkv and _flash_attention_bwd_dq),
// reached through its custom_vjp when the train step differentiates
// stable_ts_tpu/models/whisper/model.py:_flash_self_attention (encoder) and
// _flash_cross_attention (decoder cross-attention).
//
// Given the forward's logsumexp lse = m + log(l) per (batch, head, query
// row) (flash_attn.cu writes it) and D_i = sum_e dO_ie O_ie (the caller
// computes it, as the TPU's wrapper does outside its kernels), with
// P = exp(scale q k^T - lse):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Both entries recompute P from lse, as the TPU's two kernels do, so the
// (T, S) matrices never reach device memory and nothing needs atomics:
// each output row is summed by one thread in a fixed order, and a rerun
// gives the same bits. Keys j >= S and query rows i >= T are masked here
// (the TPU padded to 128 and masked with segment ids).
//
// What bounds it on the card: operations (8 T S d for dkv, 6 T S d for
// dq; at Whisper's 1500 x 1500 x 64 per head that is ~1000 FLOP per byte
// read). This first version runs on the f32 CUDA cores, as the forward
// does (wgmma comes with the redesign):
//   - dkv: one block per (64-key tile, head, batch row), one thread per key
//     row. Its dK and dV sums stay in registers (2 d_head floats). Its own
//     k and v rows live in shared memory, each padded by 4 floats so that
//     the 16-byte reads of a warp's rows fall in distinct banks: k, v, dK
//     and dV all in registers would take 4 d_head = 256 floats at d_head
//     64, more than a thread's 255 registers. Q (scaled) and dO stream
//     through shared memory in 32-row tiles, 16-byte loads widened to f32;
//     every thread then reads the same query row (a broadcast).
//   - dq: one block per (64-query tile, head, batch row), one thread per
//     query row; dQ in registers, the row's scaled q and its dO in padded
//     shared memory; K and V stream through in 32-key tiles.
//   - scores in groups (8 queries for dkv, 16 keys for dq): each 16-byte
//     read of an owned row serves the whole group.
// Both blocks take ~51 KB of shared memory at d_head 64, so they opt in
// to more than 48 KB (allow_dynamic_smem). nvcc -Xptxas -v for sm_90a:
// dkv 198 registers, dq 168 at d_head 64 (160 and 128 at 32), no spills.
#include "common.cuh"

namespace {

constexpr int BW_ROWS = 64;  // owned rows per block = threads per block
constexpr int BW_TILE = 32;  // streamed rows per shared-memory tile
constexpr int BW_PAD = 4;    // floats after each owned row (bank spread)
constexpr int DKV_GROUP = 8;   // queries per score group (dkv)
constexpr int DQ_GROUP = 16;   // keys per score group (dq)
// d_head chunks per unrolled step of the score loop: unrolled fully, the
// compiler keeps every chunk's loads in flight at once and spills ~4 KB a
// thread (255 registers); by 4 nothing spills
constexpr int SCORE_UNROLL = 4;

// rows [row0, row0 + rows) of src (row stride st) into dst (row stride ld
// floats), widened to f32 and multiplied by mult; rows >= n are zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long st, int row0, int rows,
                                          int n, float mult) {
  constexpr int VN = Vec16<T>::N;
  constexpr int CPR = DH / VN;  // 16-byte chunks per head row
  static_assert(DH % VN == 0, "d_head must fill whole 16-byte chunks");
  for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
    const int r = idx / CPR, c = idx % CPR;
    const int j = row0 + r;
    float x[VN];
    if (j < n) {
      load16(src + j * st + c * VN, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c * VN);
#pragma unroll
    for (int e = 0; e < VN / 4; ++e)
      out[e] = make_float4(x[4 * e] * mult, x[4 * e + 1] * mult,
                           x[4 * e + 2] * mult, x[4 * e + 3] * mult);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

template <int DH>
constexpr size_t dkv_smem() {
  return (2 * BW_ROWS * (DH + BW_PAD) + 2 * BW_TILE * DH + 2 * BW_TILE) * sizeof(float);
}

template <int DH>
constexpr size_t dq_smem() {
  return (2 * BW_ROWS * (DH + BW_PAD) + 2 * BW_TILE * DH) * sizeof(float);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int batch, n_head, t_len, s_len;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DH>
__global__ void __launch_bounds__(BW_ROWS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len,
                     long long q_sb, long long q_st, long long k_sb, long long k_st,
                     long long v_sb, long long v_st, float scale) {
  constexpr int LD = DH + BW_PAD;
  constexpr int C4 = DH / 4;
  constexpr int G = DKV_GROUP;
  static_assert(BW_TILE % G == 0, "a tile holds whole query groups");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [BW_ROWS][LD] own k rows
  float* vs = ks + BW_ROWS * LD;       // [BW_ROWS][LD] own v rows
  float* qs = vs + BW_ROWS * LD;       // [BW_TILE][DH] scale * q
  float* os = qs + BW_TILE * DH;       // [BW_TILE][DH] dO
  float* ls = os + BW_TILE * DH;       // [BW_TILE] lse (+inf past T)
  float* dl = ls + BW_TILE;            // [BW_TILE] D (0 past T)

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, n_head = gridDim.y;
  const int key0 = blockIdx.x * BW_ROWS;
  const long long d = static_cast<long long>(n_head) * DH;
  const long long bh = static_cast<long long>(b) * n_head + h;
  const T* qb = q + b * q_sb + h * DH;
  const T* ob = dout + static_cast<long long>(b) * t_len * d + h * DH;  // dO: contiguous (B, T, d)
  const float* lb = lse + bh * t_len;
  const float* db = delta + bh * t_len;

  load_rows<T, DH>(ks, LD, k + b * k_sb + h * DH, k_st, key0, BW_ROWS, s_len, 1.f);
  load_rows<T, DH>(vs, LD, v + b * v_sb + h * DH, v_st, key0, BW_ROWS, s_len, 1.f);
  const float4* kr = reinterpret_cast<const float4*>(ks + tid * LD);
  const float4* vr = reinterpret_cast<const float4*>(vs + tid * LD);

  float dka[DH], dva[DH];
#pragma unroll
  for (int e = 0; e < DH; ++e) dka[e] = dva[e] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += BW_TILE) {
    __syncthreads();  // the previous tile is consumed
    load_rows<T, DH>(qs, DH, qb, q_st, t0, BW_TILE, t_len, scale);
    load_rows<T, DH>(os, DH, ob, d, t0, BW_TILE, t_len, 1.f);
    if (tid < BW_TILE) {
      const int i = t0 + tid;
      ls[tid] = i < t_len ? lb[i] : INFINITY;  // p = exp(s - inf) = 0
      dl[tid] = i < t_len ? db[i] : 0.f;
    }
    __syncthreads();
    const int n_rows = min(BW_TILE, t_len - t0);
#pragma unroll 1
    for (int g0 = 0; g0 < n_rows; g0 += G) {
      const float4* qg = reinterpret_cast<const float4*>(qs + g0 * DH);
      const float4* og = reinterpret_cast<const float4*>(os + g0 * DH);
      float s[G], dp[G];
#pragma unroll
      for (int ii = 0; ii < G; ++ii) s[ii] = dp[ii] = 0.f;
#pragma unroll SCORE_UNROLL
      for (int c = 0; c < C4; ++c) {
        const float4 kc = kr[c], vc = vr[c];
#pragma unroll
        for (int ii = 0; ii < G; ++ii) {
          s[ii] = dot4(qg[ii * C4 + c], kc, s[ii]);
          dp[ii] = dot4(og[ii * C4 + c], vc, dp[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < G; ++ii) {
        const float p = expf(s[ii] - ls[g0 + ii]);
        s[ii] = p;                              // P_ij
        dp[ii] = p * (dp[ii] - dl[g0 + ii]);    // dS_ij
      }
#pragma unroll
      for (int ii = 0; ii < G; ++ii) {
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          axpy4(s[ii], og[ii * C4 + c], dva + 4 * c);
          axpy4(dp[ii], qg[ii * C4 + c], dka + 4 * c);  // q carries the scale
        }
      }
    }
  }

  const int row = key0 + tid;
  if (row < s_len) {
    const long long at = (static_cast<long long>(b) * s_len + row) * d + h * DH;
    T* kb = dk + at;  // dK, dV: contiguous (B, S, d)
    T* vb = dv + at;
#pragma unroll
    for (int e = 0; e < DH; ++e) {
      kb[e] = from_float<T>(dka[e]);
      vb[e] = from_float<T>(dva[e]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(BW_ROWS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_len, int s_len, long long q_sb,
                    long long q_st, long long k_sb, long long k_st, long long v_sb,
                    long long v_st, float scale) {
  constexpr int LD = DH + BW_PAD;
  constexpr int C4 = DH / 4;
  constexpr int G = DQ_GROUP;
  static_assert(BW_TILE % G == 0, "a tile holds whole key groups");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BW_ROWS][LD] own rows of scale * q
  float* os = qs + BW_ROWS * LD;       // [BW_ROWS][LD] own dO rows
  float* ks = os + BW_ROWS * LD;       // [BW_TILE][DH] k tile
  float* vs = ks + BW_TILE * DH;       // [BW_TILE][DH] v tile

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, n_head = gridDim.y;
  const int row0 = blockIdx.x * BW_ROWS;
  const int row = row0 + tid;
  const bool live = row < t_len;  // rows past T compute on zeros, never store
  const long long d = static_cast<long long>(n_head) * DH;
  const long long bh = static_cast<long long>(b) * n_head + h;
  const T* kb = k + b * k_sb + h * DH;
  const T* vb = v + b * v_sb + h * DH;

  load_rows<T, DH>(qs, LD, q + b * q_sb + h * DH, q_st, row0, BW_ROWS, t_len, scale);
  load_rows<T, DH>(os, LD, dout + static_cast<long long>(b) * t_len * d + h * DH, d, row0, BW_ROWS,
                   t_len, 1.f);
  const float lse_i = live ? lse[bh * t_len + row] : 0.f;
  const float d_i = live ? delta[bh * t_len + row] : 0.f;
  const float4* qr = reinterpret_cast<const float4*>(qs + tid * LD);
  const float4* orow = reinterpret_cast<const float4*>(os + tid * LD);

  float acc[DH];
#pragma unroll
  for (int e = 0; e < DH; ++e) acc[e] = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += BW_TILE) {
    __syncthreads();  // the previous tile is consumed (and the own rows written)
    load_rows<T, DH>(ks, DH, kb, k_st, s0, BW_TILE, s_len, 1.f);
    load_rows<T, DH>(vs, DH, vb, v_st, s0, BW_TILE, s_len, 1.f);
    __syncthreads();
#pragma unroll 1
    for (int g0 = 0; g0 < BW_TILE; g0 += G) {
      const float4* kg = reinterpret_cast<const float4*>(ks + g0 * DH);
      const float4* vg = reinterpret_cast<const float4*>(vs + g0 * DH);
      float s[G], dp[G];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll SCORE_UNROLL
      for (int c = 0; c < C4; ++c) {
        const float4 qc = qr[c], oc = orow[c];
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          s[jj] = dot4(qc, kg[jj * C4 + c], s[jj]);
          dp[jj] = dot4(oc, vg[jj * C4 + c], dp[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const float p = (s0 + g0 + jj < s_len) ? expf(s[jj] - lse_i) : 0.f;
        dp[jj] = p * (dp[jj] - d_i);  // dS_ij
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
#pragma unroll
        for (int c = 0; c < C4; ++c) axpy4(dp[jj], kg[jj * C4 + c], acc + 4 * c);
      }
    }
  }

  if (live) {
    T* out = dq + (static_cast<long long>(b) * t_len + row) * d + h * DH;  // dQ: (B, T, d)
#pragma unroll
    for (int e = 0; e < DH; ++e) out[e] = from_float<T>(acc[e] * scale);
  }
}

template <typename T, int DH>
int launch(const BwdArgs& a, bool want_dq) {
  if (want_dq) {
    constexpr size_t smem = dq_smem<DH>();
    const cudaError_t e = allow_dynamic_smem(flash_bwd_dq_kernel<T, DH>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.t_len + BW_ROWS - 1) / BW_ROWS, a.n_head, a.batch);
    flash_bwd_dq_kernel<T, DH><<<grid, BW_ROWS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.dq), a.t_len, a.s_len, a.q_sb, a.q_st, a.k_sb, a.k_st,
        a.v_sb, a.v_st, a.scale);
  } else {
    constexpr size_t smem = dkv_smem<DH>();
    const cudaError_t e = allow_dynamic_smem(flash_bwd_dkv_kernel<T, DH>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.s_len + BW_ROWS - 1) / BW_ROWS, a.n_head, a.batch);
    flash_bwd_dkv_kernel<T, DH><<<grid, BW_ROWS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t_len, a.s_len, a.q_sb,
        a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const BwdArgs& a, int dtype, int d_head, bool want_dq) {
  if (a.t_len <= 0 || a.s_len <= 0 || a.lse == nullptr || a.delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 1000 + d_head) {
    case DT_F32 * 1000 + 32: return launch<float, 32>(a, want_dq);
    case DT_F32 * 1000 + 64: return launch<float, 64>(a, want_dq);
    case DT_BF16 * 1000 + 32: return launch<__nv_bfloat16, 32>(a, want_dq);
    case DT_BF16 * 1000 + 64: return launch<__nv_bfloat16, 64>(a, want_dq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v: row t of head h of batch b starts at ptr + b * sb + t * st +
// h * d_head (strides in elements), as in flash_attn_fwd. dout and the
// outputs (dq; dk, dv) are contiguous (B, rows, n_head * d_head); lse and
// delta are f32 (B, H, T). dtype (f32 or bf16) is that of q, k, v, dout
// and the outputs.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int batch, int n_head,
                                  int t_len, int s_len, int d_head, long long q_sb,
                                  long long q_st, long long k_sb, long long k_st,
                                  long long v_sb, long long v_st, float scale,
                                  void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv, batch, n_head,
                  t_len, s_len, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, d_head, false);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int dtype, int batch, int n_head, int t_len,
                                 int s_len, int d_head, long long q_sb, long long q_st,
                                 long long k_sb, long long k_st, long long v_sb,
                                 long long v_st, float scale, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr, batch,
                  n_head, t_len, s_len, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, d_head, true);
}
