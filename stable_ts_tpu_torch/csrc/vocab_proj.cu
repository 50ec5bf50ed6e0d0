// Streamed vocab projection: logits = x @ emb^T, f32 accumulation.
//
// Replaces stable_ts_tpu/ops/vocab_proj.py:_kernel (vocab_logits_kernel),
// the tied-embedding logits of every beam and sampled decode step: x (M, d)
// in the embedding's dtype (bf16 or f32) against emb (V, d), giving (M, V)
// f32 logits, M <= 256.
//
// What bounds it on the card: bytes. A step streams the whole (V, d) table
// (133 MB in bf16 at large-v3) for a handful of rows, about 2 M operations
// per byte. So the table is read from device memory exactly once, as it is
// stored, for any M; x (at most 640 KB) is re-read from L2.
//
// bf16 (vocab_proj_wgmma): the products run on the tensor cores with A and B
// swapped. A 64-row tile of the embedding (64 vocab ids x 64 of d, bf16,
// 128-byte swizzle) is wgmma's A operand, K-major exactly as TMA copies it
// from the table; the x rows are the B operand, N = M rounded up to 8, 16,
// 32 or 64, and above 64 up to four N = 64 tiles over the same embedding
// stage. TMA fills x rows >= M, vocab rows >= V and d columns >= d with
// zeros, so no padded copy of either operand exists. One producer warp keeps
// a ring of VW_STAGES stages (an embedding tile and its x tiles) in flight;
// one consumer warpgroup sums the products in f32 registers in a fixed
// order (reruns are bit-identical). The grid walks the vocabulary in tiles
// of 64 ids. The accumulator's rows are vocab ids, so it is staged through
// shared memory (the drained ring) and each row of out (M, V) is written
// with coalesced stores.
//
// f32 (vocab_proj_kernel): CUDA cores. Each block owns VP_TILE vocab rows,
// each warp VP_TILE / VP_WARPS of them, a row read once across the lanes
// and multiplied against every x row of the block's chunk (held in shared
// memory as f32), the sums reduced across the warp and each logit written
// once. A chunk holds at most VP_ROWS rows; larger M takes more chunks, each
// reading the table again.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// -- bf16: wgmma tiles fed by TMA ------------------------------------------------

constexpr int VW_STAGES = 4;
constexpr int VW_BK = 64;   // d values per stage: one 128-byte swizzled row

// shared-memory layout (byte offsets from a 1024-aligned base); every tile
// starts on a 1024-byte boundary
template <int N, int NT>
struct VocabSmem {
  static constexpr int A = hop::ROWS * VW_BK * 2;  // 64 embedding rows, 8 KB
  static constexpr int B = NT * N * VW_BK * 2;     // NT x tiles of N rows
  static constexpr int STAGE = A + B;
  static constexpr int BAR = VW_STAGES * STAGE;    // init_ring's barriers: own (unused), full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * VW_STAGES) + 1024;  // + alignment slack
  static constexpr int STG = 65;                   // staging row pitch in floats
  static_assert(NT * N * STG * 4 <= BAR, "the drained ring holds the staging tile");
};

template <int N, int NT>
__global__ void __launch_bounds__(hop::THREADS)
vocab_proj_wgmma(const __grid_constant__ CUtensorMap emap,
                 const __grid_constant__ CUtensorMap xmap, float* __restrict__ out, int m,
                 int d, int n_vocab) {
  using L = VocabSmem<N, NT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + L::BAR + 8, empty = full + 8 * VW_STAGES;
  const int v0 = blockIdx.x * hop::ROWS;
  const int n_k = (d + VW_BK - 1) / VW_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  hop::init_ring<VW_STAGES>(base + L::BAR, 1);

  if (warp == hop::CONSUMERS / 32) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % VW_STAGES;
        const uint32_t stage = base + st * L::STAGE;
        hop::mbar_wait(empty + 8 * st, ((kt / VW_STAGES) & 1) ^ 1);
        hop::mbar_arrive_expect(full + 8 * st, L::STAGE);
        hop::tma_load_3d(stage, &emap, full + 8 * st, kt * VW_BK, v0, 0);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          hop::tma_load_3d(stage + L::A + t * N * VW_BK * 2, &xmap, full + 8 * st, kt * VW_BK,
                           t * N, 0);
      }
    }
    return;
  }

  // consumer warpgroup: vocab rows r and r + 8 of the tile, x rows 8 j + c + {0, 1}
  float acc[NT][N / 2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[t][e] = 0.f;

#pragma unroll 1
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % VW_STAGES;
    const uint32_t stage = base + st * L::STAGE;
    hop::mbar_wait(full + 8 * st, (kt / VW_STAGES) & 1);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < VW_BK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        hop::wgmma_ss<N>(acc[t], hop::desc<128>(stage + 32 * kk),
                         hop::desc<128>(stage + L::A + t * N * VW_BK * 2 + 32 * kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < NT; ++t) hop::fence_regs(acc[t]);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + 8 * st);
  }

  // stage the (x row, vocab id) sums in the drained ring, then write each
  // logit row's 64 ids with coalesced stores
  asm volatile("bar.sync 1, %0;" ::"n"(hop::CONSUMERS) : "memory");
  float* stg = reinterpret_cast<float*>(smem_raw + (base - raw));
  const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          stg[(t * N + 8 * j + c + e) * L::STG + r + 8 * i] = acc[t][4 * j + 2 * i + e];
  asm volatile("bar.sync 1, %0;" ::"n"(hop::CONSUMERS) : "memory");
  for (int idx = threadIdx.x; idx < m * hop::ROWS; idx += hop::CONSUMERS) {
    const int row = idx / hop::ROWS, col = idx % hop::ROWS;
    if (v0 + col < n_vocab)
      out[static_cast<long long>(row) * n_vocab + v0 + col] = stg[row * L::STG + col];
  }
}

template <int N, int NT>
int launch_wgmma(const void* x, const void* emb, void* out, int m, int d, int n_vocab,
                 cudaStream_t stream) {
  CUtensorMap em, xm;
  int err = hop::rows_map(&em, emb, 1, n_vocab, d, VW_BK, d, 0);
  if (err == 0) err = hop::rows_map(&xm, x, 1, m, d, VW_BK, d, 0, N);
  if (err != 0) return err;
  constexpr int smem = VocabSmem<N, NT>::BYTES;
  const cudaError_t e = allow_dynamic_smem(vocab_proj_wgmma<N, NT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_vocab + hop::ROWS - 1) / hop::ROWS);
  vocab_proj_wgmma<N, NT><<<grid, hop::THREADS, smem, stream>>>(
      em, xm, static_cast<float*>(out), m, d, n_vocab);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* emb, void* out, int m, int d, int n_vocab,
                cudaStream_t stream) {
  if (m <= 8) return launch_wgmma<8, 1>(x, emb, out, m, d, n_vocab, stream);
  if (m <= 16) return launch_wgmma<16, 1>(x, emb, out, m, d, n_vocab, stream);
  if (m <= 32) return launch_wgmma<32, 1>(x, emb, out, m, d, n_vocab, stream);
  if (m <= 64) return launch_wgmma<64, 1>(x, emb, out, m, d, n_vocab, stream);
  if (m <= 128) return launch_wgmma<64, 2>(x, emb, out, m, d, n_vocab, stream);
  if (m <= 192) return launch_wgmma<64, 3>(x, emb, out, m, d, n_vocab, stream);
  if (m <= 256) return launch_wgmma<64, 4>(x, emb, out, m, d, n_vocab, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- f32: CUDA cores -------------------------------------------------------------

constexpr int VP_THREADS = 256;
constexpr int VP_WARPS = VP_THREADS / 32;
constexpr int VP_TILE = 64;   // vocab rows per block
constexpr int VP_ROWS = 16;   // x rows per block

__global__ void __launch_bounds__(VP_THREADS)
vocab_proj_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                  float* __restrict__ out, int m, int d, int n_vocab) {
  constexpr int VN = Vec16<float>::N;
  extern __shared__ float xs[];  // min(m, VP_ROWS) * d
  const int r0 = blockIdx.y * VP_ROWS;
  const int rows = min(VP_ROWS, m - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < rows * d; i += VP_THREADS)
    xs[i] = x[static_cast<long long>(r0) * d + i];
  __syncthreads();

  const int chunks = d / VN;
  const int v_begin = blockIdx.x * VP_TILE + warp * (VP_TILE / VP_WARPS);
  const int v_end = min(v_begin + VP_TILE / VP_WARPS, n_vocab);
  for (int v = v_begin; v < v_end; ++v) {
    const float* row = emb + static_cast<long long>(v) * d;
    float acc[VP_ROWS];
#pragma unroll
    for (int r = 0; r < VP_ROWS; ++r) acc[r] = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float e[VN];
      load16(row + c * VN, e);
#pragma unroll
      for (int r = 0; r < VP_ROWS; ++r) {
        if (r < rows) {
          // d % VN == 0 and VN == 4: 16-byte aligned shared reads
          const float4 q = *reinterpret_cast<const float4*>(xs + r * d + c * VN);
          acc[r] = fmaf(q.x, e[0], acc[r]);
          acc[r] = fmaf(q.y, e[1], acc[r]);
          acc[r] = fmaf(q.z, e[2], acc[r]);
          acc[r] = fmaf(q.w, e[3], acc[r]);
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

int launch_f32(const void* x, const void* emb, void* out, int m, int d, int n_vocab,
               cudaStream_t stream) {
  if (d % Vec16<float>::N != 0) return static_cast<int>(cudaErrorInvalidValue);
  // only the rows a block holds, so a one-row step keeps blocks small
  const size_t smem = static_cast<size_t>(m < VP_ROWS ? m : VP_ROWS) * d * sizeof(float);
  const cudaError_t e = allow_dynamic_smem(vocab_proj_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_vocab + VP_TILE - 1) / VP_TILE, (m + VP_ROWS - 1) / VP_ROWS);
  vocab_proj_kernel<<<grid, VP_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb), static_cast<float*>(out),
      m, d, n_vocab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, d) and emb (V, d): contiguous, the same dtype (bf16 or f32), rows of
// 16-byte multiples, 16-byte aligned; 1 <= M <= 256; out (M, V) f32.
extern "C" int vocab_proj(const void* x, const void* emb, void* out, int dtype,
                          int m, int d, int n_vocab, void* stream) {
  if (m < 1 || m > 256 || n_vocab < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_BF16: return launch_bf16(x, emb, out, m, d, n_vocab, st);
    case DT_F32: return launch_f32(x, emb, out, m, d, n_vocab, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
