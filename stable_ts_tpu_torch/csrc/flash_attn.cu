// Flash attention forward: out = softmax(q k^T * scale) v, non-causal.
//
// Replaces the TPU's Pallas flash attention (jax.experimental.pallas.ops.
// tpu.flash_attention, called from stable_ts_tpu/models/whisper/model.py:
// _flash_self_attention for the encoder and _flash_cross_attention for the
// teacher-forced timing pass and the train step). The TPU padded the
// sequence to 128 and masked the pad with segment ids; here the kernels mask
// keys j >= S themselves and never store query rows t >= T, so nothing is
// padded. Rows are addressed by (batch, row) strides so q/k/v may be views of
// (B, T, n_head * d_head) projections: no head split or merge copies. For the
// backward (flash_attn_bwd.cu) the kernels can also write each row's
// logsumexp, m + log(l), which the TPU kernel keeps as its l and m residuals;
// inference passes a null pointer.
//
// What bounds it on the card: operations at the encoder shape (1500 x 1500 x
// 64 per head: 1500 FLOP per byte of Q/K/V read), bytes at the cross shapes
// (T = 1..230 tokens against 1500 frames). The point of the design is the
// same as on the TPU: the (T, S) scores never reach device memory.
//
// bf16 (every path of the port's large-v3 model): tensor cores (hopper.cuh).
//   - One block per (64-query tile, head, batch row): one consumer warpgroup
//     owns the 64 rows, one producer warp feeds it. Blocks: encoder 24 x 20
//     heads x B (480 at B = 1, 960 at B = 2; 3.6 / 7.3 per SM), cross T = 230
//     4 x 20 = 80, T = 63 at B = 2 40, T = 1 20 (one wave on 132 SMs).
//   - The producer loads the Q tile once and streams 64-key K and V tiles
//     through a 2-stage ring by TMA (3-D tensor maps over (width, rows, batch),
//     so rows past T or S arrive as zeros per batch row), each stage a full
//     and an empty mbarrier: tile j + 1's copy overlaps tile j's products.
//   - S = Q K^T on wgmma m64n64k16 (Q and K from shared memory, both K-major,
//     f32 sums); keys >= S masked to -inf; online softmax in f32 on the
//     accumulator layout (a thread holds 2 rows: max and sum over the 4-lane
//     quad); P = exp(s - m) rounded to bf16 where the Pallas kernel rounds it
//     (flash_attention.py:471) and passed in registers as the A fragments of
//     O += P V (wgmma m64n{d_head}k16, V an MN-major B: transpose-B). P never
//     touches shared memory. O / l rounds to bf16 once.
//   - Shared memory per block: Q + 2 stages of K and V (40 KB at d_head 64,
//     20 KB at 32) plus barriers and 1 KB of alignment slack.
// f32 (the tiny test model, and the f32 kernel checks): the CUDA cores, one
// thread per query row (TF32 tensor cores would not hold the 1e-4 checks):
//   - one block per (64-query tile, head, batch row), the row's scaled q and
//     its f32 accumulator in registers;
//   - K and V stream through shared memory in 64-key tiles, loaded with
//     16-byte vector loads (every thread then reads the same key row: a
//     shared-memory broadcast);
//   - online softmax in f32, updated once per 16 keys.
#include "common.cuh"
#include "hopper.cuh"

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

// -- bf16: wgmma tiles fed by TMA ------------------------------------------------

constexpr int FW_STAGES = 2;

// shared-memory layout (byte offsets from a 1024-aligned base)
template <int DH>
struct FwdSmem {
  static constexpr int TILE = hop::ROWS * DH * 2;  // one 64-row bf16 tile
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;                // [FW_STAGES] tiles
  static constexpr int V = K + FW_STAGES * TILE;    // [FW_STAGES] tiles
  static constexpr int BAR = V + FW_STAGES * TILE;  // q, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * FW_STAGES) + 1024;  // + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(hop::THREADS)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int t_len, int s_len, long long o_sb,
                long long o_st, float scale) {
  using L = FwdSmem<DH>;
  constexpr int RB = DH * 2;  // bytes per tile row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + L::BAR, full = bar_q + 8, empty = full + 8 * FW_STAGES;
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * hop::ROWS;
  const int n_tiles = (s_len + hop::ROWS - 1) / hop::ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  hop::init_ring<FW_STAGES>(bar_q, 1);

  if (warp == hop::CONSUMERS / 32) {  // producer
    if (lane == 0) {
      hop::mbar_arrive_expect(bar_q, L::TILE);
      hop::tma_load_3d(base + L::Q, &qmap, bar_q, h * DH, row0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % FW_STAGES;
        hop::mbar_wait(empty + 8 * st, ((j / FW_STAGES) & 1) ^ 1);
        hop::mbar_arrive_expect(full + 8 * st, 2 * L::TILE);
        hop::tma_load_3d(base + L::K + st * L::TILE, &kmap, full + 8 * st, h * DH,
                         j * hop::ROWS, b);
        hop::tma_load_3d(base + L::V + st * L::TILE, &vmap, full + 8 * st, h * DH,
                         j * hop::ROWS, b);
      }
    }
    return;
  }

  // consumer warpgroup: rows r and r + 8 of the tile, columns 8 jj + c + {0, 1}
  const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
  const float sl2 = scale * 1.4426950408889634f;  // exp(x scale) = exp2(x sl2)
  float acc[DH / 2], s[32];
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns

  hop::mbar_wait(bar_q, 0);
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FW_STAGES;
    const uint32_t kt = base + L::K + st * L::TILE, vt = base + L::V + st * L::TILE;
    hop::mbar_wait(full + 8 * st, (j / FW_STAGES) & 1);

    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hop::wgmma_ss_n64(s, hop::desc<RB>(base + L::Q + 32 * kk), hop::desc<RB>(kt + 32 * kk), kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(s);

    if ((j + 1) * hop::ROWS > s_len) {  // the ragged last tile
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * hop::ROWS + 8 * jj + c + e >= s_len)
            s[4 * jj + e] = s[4 * jj + 2 + e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
    float corr[2], neg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
      // finite: key 0 is real and comes first; exp2(-inf) = 0 on the first tile
      corr[i] = exp2f((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
      neg[i] = -mx[i] * sl2;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[4 * jj + e], sl2, neg[e / 2]));
        s[4 * jj + e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * jj + e] *= corr[e / 2];
    uint32_t pa[4][4];
    hop::to_frags(s, pa);

    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::wgmma_rs<DH>(acc, pa[kk], hop::desc<RB>(vt + 16 * RB * kk));
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 2);
    const int row = row0 + r + 8 * i;
    if (row >= t_len) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* ob = o + b * o_sb + row * o_st + h * DH + c;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * i] * inv, acc[4 * jj + 2 * i + 1] * inv);
    // lse is (B, H, T) f32: gridDim.y is the head count
    if (lse != nullptr && c == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * t_len + row] = m[i] * scale + logf(l[i]);
  }
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int n_head, int t_len, int s_len, long long q_sb, long long q_st,
                 long long k_sb, long long k_st, long long v_sb, long long v_st,
                 long long o_sb, long long o_st, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const int width = n_head * DH;
  int err = hop::rows_map(&qm, q, batch, t_len, width, DH, q_st, q_sb);
  if (err == 0) err = hop::rows_map(&km, k, batch, s_len, width, DH, k_st, k_sb);
  if (err == 0) err = hop::rows_map(&vm, v, batch, s_len, width, DH, v_st, v_sb);
  if (err != 0) return err;
  constexpr int smem = FwdSmem<DH>::BYTES;
  const cudaError_t e = allow_dynamic_smem(flash_fwd_wgmma<DH>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t_len + hop::ROWS - 1) / hop::ROWS, n_head, batch);
  flash_fwd_wgmma<DH><<<grid, hop::THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, t_len, s_len, o_sb, o_st, scale);
  return static_cast<int>(cudaGetLastError());
}

// the CUDA-core kernel, f32 only
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
               int n_head, int t_len, int s_len, int d_head, long long q_sb,
               long long q_st, long long k_sb, long long k_st, long long v_sb,
               long long v_st, long long o_sb, long long o_st, float scale,
               cudaStream_t stream) {
  using T = float;
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
// h * d_head (strides in elements); dtype is f32 or bf16 for all four (bf16
// takes the tensor-core kernel, f32 the CUDA-core one); d_head 32 or 64.
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
  float* l = static_cast<float*>(lse);
  switch (dtype * 1000 + d_head) {
    case DT_BF16 * 1000 + 32:
      return launch_wgmma<32>(q, k, v, o, l, batch, n_head, t_len, s_len, q_sb, q_st, k_sb,
                              k_st, v_sb, v_st, o_sb, o_st, scale, st);
    case DT_BF16 * 1000 + 64:
      return launch_wgmma<64>(q, k, v, o, l, batch, n_head, t_len, s_len, q_sb, q_st, k_sb,
                              k_st, v_sb, v_st, o_sb, o_st, scale, st);
    case DT_F32 * 1000 + 32:
    case DT_F32 * 1000 + 64:
      return launch_f32(q, k, v, o, l, batch, n_head, t_len, s_len, d_head, q_sb, q_st, k_sb,
                        k_st, v_sb, v_st, o_sb, o_st, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
