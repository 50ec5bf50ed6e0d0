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
//   dV = P^T dO,  dP = dO V^T,  dS = scale P * (dP - D),
//   dQ = dS K,  dK = dS^T Q
// (the scale inside dS, as the Pallas kernels compute it). Both entries
// recompute P from lse, as the TPU's two kernels do, so the (T, S) matrices
// never reach device memory and nothing needs atomics: each output row is
// summed by one block in a fixed order, and a rerun gives the same bits.
// Keys j >= S and query rows i >= T are masked here (the TPU padded to 128
// and masked with segment ids).
//
// What bounds it on the card: operations at the encoder shape (8 T S d for
// dkv, 6 T S d for dq; at Whisper's 1500 x 1500 x 64 per head ~1000 FLOP
// per byte read), bytes at the cross shapes (T = 63 tokens a row against
// 1500 frames in the train step).
//
// bf16 (the port's large-v3 train step): tensor cores (hopper.cuh), as
// the forward (flash_attn.cu); every product on wgmma, bf16 in, f32 sums.
//   - dkv: one block per (64-key tile, head, batch row); its K and V tiles
//     arrive once by TMA, Q and dO stream through a 2-stage ring by TMA (3-D
//     tensor maps: rows past T arrive as zeros per batch row), the tile's
//     lse and D through the same stage, written by the producer warp's lanes
//     (lse = +inf past T, so P = 0 there). Per query tile: S^T = K Q^T and
//     dP^T = V dO^T (m64n64k16, both operands from shared memory); P^T and
//     dS^T = scale P^T (dP^T - D) in f32 on the accumulator layout, lse and
//     D per column; then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//     rounded to bf16 where the Pallas kernel rounds them
//     (flash_attention.py:900, :918) and passed in registers as A fragments,
//     dO and Q MN-major B operands (transpose-B). Blocks: 24 x 20 heads x 2
//     = 960 at both train-step shapes.
//   - dq: one block per (64-query tile, head, batch row); its Q and dO tiles
//     once, K and V streamed. Per key tile: S = Q K^T, dP = dO V^T; P and
//     dS in f32 (keys >= S masked to P = 0); dQ += dS K with dS rounded to
//     bf16 (flash_attention.py:1258), K MN-major. Blocks: encoder 960, cross
//     T = 63 at B = 2 40 (under a third of the 132 SMs).
//   - Shared memory per block at d_head 64: dkv 32 KB own + 2 stages of
//     (16 KB + 512 B) = 49 KB, dq 16 KB own + 2 x 16 KB = 48 KB, plus
//     barriers and 1 KB of alignment slack: both opt in to more than 48 KB
//     (allow_dynamic_smem).
// f32 (the tiny test model, and the f32 kernel checks): the CUDA cores, as
// the f32 forward:
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
#include "hopper.cuh"

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

// -- bf16: wgmma tiles fed by TMA ------------------------------------------------

constexpr int BW_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory layouts (byte offsets from a 1024-aligned base). dkv: the
// block's K and V tiles, then per stage a Q and a dO tile and the tile's
// lse (times log2 e) and D; dq: the block's Q and dO tiles, then per stage a
// K and a V tile.
template <int DH>
struct DkvSmem {
  static constexpr int TILE = hop::ROWS * DH * 2;
  static constexpr int K = 0, V = TILE;
  static constexpr int Q = 2 * TILE;                     // [BW_STAGES] tiles
  static constexpr int DO = Q + BW_STAGES * TILE;        // [BW_STAGES] tiles
  static constexpr int LSE = DO + BW_STAGES * TILE;      // [BW_STAGES][ROWS] f32
  static constexpr int DELTA = LSE + BW_STAGES * hop::ROWS * 4;
  static constexpr int BAR = DELTA + BW_STAGES * hop::ROWS * 4;  // own, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * BW_STAGES) + 1024;
};

template <int DH>
struct DqSmem {
  static constexpr int TILE = hop::ROWS * DH * 2;
  static constexpr int Q = 0, DO = TILE;
  static constexpr int K = 2 * TILE;                     // [BW_STAGES] tiles
  static constexpr int V = K + BW_STAGES * TILE;         // [BW_STAGES] tiles
  static constexpr int BAR = V + BW_STAGES * TILE;       // own, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * BW_STAGES) + 1024;
};

// the block's 64 rows of ``out`` (B, n, n_head * DH contiguous), rows >= n
// skipped, from an m64n{DH} accumulator
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DH / 2],
                                           int b, int h, int n_head, int row0, int n) {
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= n) continue;
    __nv_bfloat16* o = out + (static_cast<long long>(b) * n + row) * n_head * DH + h * DH + c;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

// dK and dV of the block's 64 keys: walk every 64-query tile,
//   S^T = K Q^T, dP^T = V dO^T   (wgmma m64n64k16, both from shared memory)
//   P^T = exp(scale S^T - lse), dS^T = scale P^T (dP^T - D)   (f32)
//   dV += bf16(P^T) dO, dK += bf16(dS^T) Q   (A in registers, B MN-major)
template <int DH>
__global__ void __launch_bounds__(hop::THREADS)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int t_len, int s_len, float scale) {
  using L = DkvSmem<DH>;
  constexpr int RB = DH * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023) & ~1023u;
  // the generic address of the same base, for the lse and D rows
  uint8_t* const gbase = smem_raw + (base - hop::smem_u32(smem_raw));
  const uint32_t bar_own = base + L::BAR, full = bar_own + 8, empty = full + 8 * BW_STAGES;
  const int h = blockIdx.y, b = blockIdx.z, n_head = gridDim.y, key0 = blockIdx.x * hop::ROWS;
  const int n_tiles = (t_len + hop::ROWS - 1) / hop::ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = static_cast<long long>(b) * n_head + h;
  // full: the producer's lane 0 (with the bytes), then all 32 lanes (lse, D)
  hop::init_ring<BW_STAGES>(bar_own, 33);

  // producer: own K, V once; Q and dO by TMA, lse and D by the lanes
  if (warp == hop::CONSUMERS / 32) {
    if (lane == 0) {
      hop::mbar_arrive_expect(bar_own, 2 * L::TILE);
      hop::tma_load_3d(base + L::K, &kmap, bar_own, h * DH, key0, b);
      hop::tma_load_3d(base + L::V, &vmap, bar_own, h * DH, key0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % BW_STAGES;
      hop::mbar_wait(empty + 8 * st, ((i / BW_STAGES) & 1) ^ 1);
      if (lane == 0) {
        hop::mbar_arrive_expect(full + 8 * st, 2 * L::TILE);
        hop::tma_load_3d(base + L::Q + st * L::TILE, &qmap, full + 8 * st, h * DH,
                         i * hop::ROWS, b);
        hop::tma_load_3d(base + L::DO + st * L::TILE, &omap, full + 8 * st, h * DH,
                         i * hop::ROWS, b);
      }
      float* ls = reinterpret_cast<float*>(gbase + L::LSE) + st * hop::ROWS;
      float* ds = reinterpret_cast<float*>(gbase + L::DELTA) + st * hop::ROWS;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = i * hop::ROWS + lane + 32 * e;
        const bool live = row < t_len;
        // rows past T: P = exp2(s - inf) = 0, so dS = 0 too
        ls[lane + 32 * e] = live ? lse[bh * t_len + row] * LOG2E : INFINITY;
        ds[lane + 32 * e] = live ? delta[bh * t_len + row] : 0.f;
      }
      hop::mbar_arrive(full + 8 * st);
    }
    return;
  }

  const int c = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  float dka[DH / 2], dva[DH / 2], sa[32], pa[32];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) dka[e] = dva[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sa[e] = pa[e] = 0.f;

  hop::mbar_wait(bar_own, 0);
#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % BW_STAGES;
    const uint32_t qt = base + L::Q + st * L::TILE, ot = base + L::DO + st * L::TILE;
    hop::mbar_wait(full + 8 * st, (i / BW_STAGES) & 1);

    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hop::wgmma_ss_n64(sa, hop::desc<RB>(base + L::K + 32 * kk), hop::desc<RB>(qt + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hop::wgmma_ss_n64(pa, hop::desc<RB>(base + L::V + 32 * kk), hop::desc<RB>(ot + 32 * kk), kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(sa);
    hop::fence_regs(pa);

    // columns are queries: their lse and D from this stage's rows
    const float* ls = reinterpret_cast<const float*>(gbase + L::LSE) + st * hop::ROWS + c;
    const float* ds = reinterpret_cast<const float*>(gbase + L::DELTA) + st * hop::ROWS + c;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * jj);
      const float2 dj = *reinterpret_cast<const float2*>(ds + 8 * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sa[4 * jj + e], sl2, -(e % 2 ? lj.y : lj.x)));
        sa[4 * jj + e] = p;                                              // P^T
        pa[4 * jj + e] = p * (pa[4 * jj + e] - (e % 2 ? dj.y : dj.x)) * scale;  // dS^T
      }
    }
    uint32_t pf[4][4], sf[4][4];
    hop::to_frags(sa, pf);
    hop::to_frags(pa, sf);

    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::wgmma_rs<DH>(dva, pf[kk], hop::desc<RB>(ot + 16 * RB * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::wgmma_rs<DH>(dka, sf[kk], hop::desc<RB>(qt + 16 * RB * kk));
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(dva);
    hop::fence_regs(dka);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + 8 * st);
  }
  store_rows<DH>(dk, dka, b, h, n_head, key0, s_len);
  store_rows<DH>(dv, dva, b, h, n_head, key0, s_len);
}

// dQ of the block's 64 queries: walk every 64-key tile,
//   S = Q K^T, dP = dO V^T   (wgmma m64n64k16, both from shared memory)
//   P = exp(scale S - lse) (0 at keys >= S), dS = scale P (dP - D)   (f32)
//   dQ += bf16(dS) K   (A in registers, B MN-major)
template <int DH>
__global__ void __launch_bounds__(hop::THREADS)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int t_len,
                   int s_len, float scale) {
  using L = DqSmem<DH>;
  constexpr int RB = DH * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_own = base + L::BAR, full = bar_own + 8, empty = full + 8 * BW_STAGES;
  const int h = blockIdx.y, b = blockIdx.z, n_head = gridDim.y, row0 = blockIdx.x * hop::ROWS;
  const int n_tiles = (s_len + hop::ROWS - 1) / hop::ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = static_cast<long long>(b) * n_head + h;
  hop::init_ring<BW_STAGES>(bar_own, 1);

  if (warp == hop::CONSUMERS / 32) {  // producer: own Q, dO once; K, V by TMA
    if (lane == 0) {
      hop::mbar_arrive_expect(bar_own, 2 * L::TILE);
      hop::tma_load_3d(base + L::Q, &qmap, bar_own, h * DH, row0, b);
      hop::tma_load_3d(base + L::DO, &omap, bar_own, h * DH, row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % BW_STAGES;
        hop::mbar_wait(empty + 8 * st, ((j / BW_STAGES) & 1) ^ 1);
        hop::mbar_arrive_expect(full + 8 * st, 2 * L::TILE);
        hop::tma_load_3d(base + L::K + st * L::TILE, &kmap, full + 8 * st, h * DH,
                         j * hop::ROWS, b);
        hop::tma_load_3d(base + L::V + st * L::TILE, &vmap, full + 8 * st, h * DH,
                         j * hop::ROWS, b);
      }
    }
    return;
  }

  const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];  // rows r and r + 8; rows past T are never stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    const bool live = row < t_len;
    lse2[i] = live ? lse[bh * t_len + row] * LOG2E : 0.f;
    dl[i] = live ? delta[bh * t_len + row] : 0.f;
  }
  float dqa[DH / 2], sa[32], pa[32];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) dqa[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sa[e] = pa[e] = 0.f;

  hop::mbar_wait(bar_own, 0);
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % BW_STAGES;
    const uint32_t kt = base + L::K + st * L::TILE, vt = base + L::V + st * L::TILE;
    hop::mbar_wait(full + 8 * st, (j / BW_STAGES) & 1);

    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hop::wgmma_ss_n64(sa, hop::desc<RB>(base + L::Q + 32 * kk), hop::desc<RB>(kt + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hop::wgmma_ss_n64(pa, hop::desc<RB>(base + L::DO + 32 * kk), hop::desc<RB>(vt + 32 * kk), kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(sa);
    hop::fence_regs(pa);

    const bool ragged = (j + 1) * hop::ROWS > s_len;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sa[4 * jj + e], sl2, -lse2[e / 2]));
        if (ragged && j * hop::ROWS + 8 * jj + c + e % 2 >= s_len) p = 0.f;  // zero-filled keys
        pa[4 * jj + e] = p * (pa[4 * jj + e] - dl[e / 2]) * scale;  // dS
      }
    uint32_t sf[4][4];
    hop::to_frags(pa, sf);

    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::wgmma_rs<DH>(dqa, sf[kk], hop::desc<RB>(kt + 16 * RB * kk));
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(dqa);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + 8 * st);
  }
  store_rows<DH>(dq, dqa, b, h, n_head, row0, t_len);
}

template <int DH>
int launch_wgmma(const BwdArgs& a, bool want_dq) {
  CUtensorMap qm, km, vm, om;
  const int width = a.n_head * DH;
  const long long d = width;  // dO: contiguous (B, T, d)
  int err = hop::rows_map(&qm, a.q, a.batch, a.t_len, width, DH, a.q_st, a.q_sb);
  if (err == 0) err = hop::rows_map(&km, a.k, a.batch, a.s_len, width, DH, a.k_st, a.k_sb);
  if (err == 0) err = hop::rows_map(&vm, a.v, a.batch, a.s_len, width, DH, a.v_st, a.v_sb);
  if (err == 0) err = hop::rows_map(&om, a.dout, a.batch, a.t_len, width, DH, d, a.t_len * d);
  if (err != 0) return err;
  if (want_dq) {
    constexpr int smem = DqSmem<DH>::BYTES;
    const cudaError_t e = allow_dynamic_smem(flash_bwd_dq_wgmma<DH>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.t_len + hop::ROWS - 1) / hop::ROWS, a.n_head, a.batch);
    flash_bwd_dq_wgmma<DH><<<grid, hop::THREADS, smem, a.stream>>>(
        qm, km, vm, om, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.t_len, a.s_len,
        a.scale);
  } else {
    constexpr int smem = DkvSmem<DH>::BYTES;
    const cudaError_t e = allow_dynamic_smem(flash_bwd_dkv_wgmma<DH>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.s_len + hop::ROWS - 1) / hop::ROWS, a.n_head, a.batch);
    flash_bwd_dkv_wgmma<DH><<<grid, hop::THREADS, smem, a.stream>>>(
        qm, km, vm, om, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), a.t_len, a.s_len, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
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
    case DT_BF16 * 1000 + 32: return launch_wgmma<32>(a, want_dq);
    case DT_BF16 * 1000 + 64: return launch_wgmma<64>(a, want_dq);
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
