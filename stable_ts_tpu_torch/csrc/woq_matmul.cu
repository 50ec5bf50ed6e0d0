// Weight-only int8 matmul: out = (x @ q^T) * scale, f32 accumulation.
//
// Replaces stable_ts_tpu/ops/woq_matmul.py:27 _kernel (via int8_matmul
// :86), the product of every quantized (dq) linear: x (M, K) bf16 or f32
// against the int8 weight q with one f32 scale per output column, applied
// once after the K-sum (it factors out of it), exactly jnp.dot(x,
// q.astype(bf16), preferred_element_type=f32) * s. The weight is kept as
// torch's (N, K) row-major int8, so output column n's K weights are one
// contiguous row. No dequantized weight ever exists in device memory.
//
// What bounds it on the card: a decode step (M <= 16) multiplies one or a
// few rows by each weight once, about 2 M operations per weight byte, so
// bytes (a large-v3 dq step reads 734 MB of int8 weights); the encoder and
// the timing pass (M = 1500, 230) are operations (0.020 ms at 989 TFLOP/s
// for (1500, 1280) x (5120, 1280)).
//
// bf16 x (woq_wgmma_kernel): every product on the tensor cores, one kernel
// for both regimes. A 64-row slab of the weight (64 output columns x 64 of
// K, int8, 64-byte swizzled) is wgmma's A operand, taken from registers:
// each consumer thread reads its fragment bytes from shared memory (one
// 16-byte load per row and K step of 16, conflict-free under the swizzle),
// widens each pair of int8 exactly to a bf16 pair with no conversion
// instruction (each byte, biased by 128, in the mantissa of 2^23, the bias
// subtracted in f32, the two high halves packed), and issues wgmma with A
// in registers: the arrangement of CUTLASS's Hopper mixed-input GEMM,
// without a widened copy in shared memory. The x rows are the B operand,
// K-major as stored (128-byte swizzled). The tensor maps zero-fill x rows
// >= M, weight rows >= N and columns >= K, so no padded copy of either
// operand exists. One producer warp keeps a TMA ring of up to 4 stages in
// flight; the consumer warpgroups sum in f32 registers. The accumulator's
// rows are output columns, so the per-column scale is one multiply per
// row, applied after the sum.
//   - Decode (M <= 64): B is N = M rounded up to 8, 16, 32 or 64 x rows,
//     so the tensor cores take the extra rows of a beam or best_of step
//     (M = 5) nearly free. Here the card is bound by latency before bytes:
//     with one consumer warpgroup, each 4 KB slab waited on its widening
//     and on a short wgmma chain in turn. So four warpgroups run along K,
//     each widening and multiplying its own slab of a 256-wide stage into
//     its own (four independent) accumulators, summed in warpgroup order
//     through shared memory at the end.
//   - Encoder and timing pass (M > 64): two consumer warpgroups on 128
//     weight rows, three N = 64 tiles of x rows (192) over each stage. What
//     bounds this regime on the card is L2's rate as much as the tensor
//     cores: a 64 x 256 tile read 36 KB a stage for 2.1 MFLOP and ran at
//     L2's rate; 128 x 192 reads 32 KB for 3.1. This orientation (the
//     widened weight as A in registers) keeps one kernel for both regimes
//     and widens each weight byte once a stage in registers; the
//     conventional one (x as A, the weight widened into shared memory as B)
//     would add a shared-memory round trip and a barrier a stage.
//   - K is split across a thread-block cluster: the largest (at most 8
//     blocks) whose size divides the stages and keeps the grid within the
//     132 SMs (decode: N = 1280 gives only 20 column tiles, split 5). Each
//     block runs an equal share of the stages and stages its partial sums
//     in its drained ring; block b of the cluster sums x rows
//     b, b + split, ... over the blocks in rank order through distributed
//     shared memory, scales them and stores each row's columns coalesced.
//     No atomics and no scratch in device memory: reruns are
//     bit-identical. Unsplit, a block scales and stores from its registers.
//   - The sums differ from the twin's only in their order: int8 values are
//     exact in bf16 and a bf16 x bf16 product is exact in f32.
//
// f32 x (off the main path) keeps the CUDA-core kernels: woq_gemv_kernel
// for M <= WOQ_GEMV_MAX_M (a warp per output column, the weight widened to
// f32 in registers) and woq_tiled_kernel above (64 x 64 output tiles, 4 x 4
// per thread, f32 FMA).
// K must be a multiple of 16 (16-byte weight rows); the wrapper checks.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// -- bf16 x: wgmma with the widened weight as A ------------------------------------

constexpr int WQ_BK = 64;   // K values of a slab: one 64-byte weight row, one 128-byte x row

// shared-memory layout (byte offsets from a 1024-aligned base); every tile
// starts on a 1024-byte boundary. WG x WGK consumer warpgroups: WG along the
// weight rows (64 each), WGK along K (a stage holds WGK slabs, one a
// warpgroup).
template <int N, int NT, int WG, int WGK>
struct WoqSmem {
  static constexpr int CONSUMERS = 128 * WG * WGK;
  static constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
  static constexpr int WROWS = 64 * WG;            // weight rows (output columns) a block
  static constexpr int ASUB = WROWS * WQ_BK;       // a slab of the int8 weight tile
  static constexpr int XSUB = N * WQ_BK * 2;       // a slab of one x tile (N rows of 64 bf16)
  static constexpr int A = WGK * ASUB;
  static constexpr int STAGE = A + WGK * NT * XSUB;  // slab s of x tile t at A + (s NT + t) XSUB
  static constexpr int FIT = 160 * 1024 / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BAR = STAGES * STAGE;       // then init_ring's barriers
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static constexpr int STG = WROWS + 1;            // staging row pitch in floats
  // the K warpgroups' partial sums, after the staging tile
  static constexpr int RED_AT = (NT * N * STG * 4 + 1023) / 1024 * 1024;
  static constexpr int RED = (WGK - 1) * 128 * WG * NT * (N / 2) * 4;
  // independent accumulators of a decode tile (a wgmma of 8-16 columns is
  // mostly latency; 4 chains of them overlap)
  static constexpr int NACC = NT > 1 ? 1 : N <= 16 ? 4 : N == 32 ? 2 : 1;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(RED_AT + RED <= BAR, "the drained ring holds the staging tile and the partials");
};

// The two int8 values in bytes sh and sh + 1 of w (sh = 0 or 2) as a bf16
// pair, byte sh in the low half, with no conversion instruction: each byte,
// biased by 128, becomes the low mantissa byte of 2^23 and 2^23 + 128 is
// subtracted in f32, which is exact; an integer of at most 8 significant
// bits has a zero low half in f32, so its high half is its bf16.
__device__ __forceinline__ uint32_t widen_pair(uint32_t w, uint32_t sh) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | sh)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | (sh + 1))) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// The A fragments of the stage's four K steps from the swizzled int8 tile:
// rows r = 16 warp + lane / 4 and r + 8, K columns 16 kk + 2 (lane % 4) +
// {0, 1} (registers 0, 1) and + 8 (registers 2, 3).
__device__ __forceinline__ void weight_frags(const uint8_t* tile, int warp, int lane,
                                             uint32_t (&a)[WQ_BK / 16][4]) {
  const int c = lane % 4;
  const uint32_t sh = (c & 1) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + lane / 4 + 8 * i;
#pragma unroll
    for (int kk = 0; kk < WQ_BK / 16; ++kk) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(tile + r * WQ_BK + ((kk ^ ((r >> 1) & 3)) << 4));
      a[kk][i] = widen_pair(c < 2 ? w.x : w.y, sh);
      a[kk][2 + i] = widen_pair(c < 2 ? w.z : w.w, sh);
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// grid (split, column tiles, x tiles); the split blocks of one output tile
// form a cluster, block ``rank`` owning stages [rank T / split, (rank + 1)
// T / split) of the T = S / WGK, S = ceil(K / 64) slabs (WGK divides S and
// split divides T: no stage is partial, so no wgmma sits on a divergent
// path, and the blocks of a cluster run equal shares)
template <int N, int NT, int WG, int WGK>
__global__ void __launch_bounds__(WoqSmem<N, NT, WG, WGK>::THREADS)
woq_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, const float* __restrict__ scale,
                 float* __restrict__ out, int m, int n, int k) {
  using L = WoqSmem<N, NT, WG, WGK>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR + 8, empty = full + 8 * STAGES;
  const int n0 = blockIdx.y * L::WROWS;
  const int x0 = blockIdx.z * NT * N;
  const int stages = (k + WQ_BK - 1) / WQ_BK / WGK;
  const int t0 = rank * stages / split;
  const int n_k = (rank + 1) * stages / split - t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  hop::init_ring<STAGES>(base + L::BAR, 1, L::CONSUMERS / 32);

  if (warp == L::CONSUMERS / 32) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % STAGES;
        const uint32_t stage = base + st * L::STAGE;
        hop::mbar_wait(empty + 8 * st, ((kt / STAGES) & 1) ^ 1);
        hop::mbar_arrive_expect(full + 8 * st, L::STAGE);
#pragma unroll
        for (int sl = 0; sl < WGK; ++sl) {
          const int kc = ((t0 + kt) * WGK + sl) * WQ_BK;
          hop::tma_load_3d(stage + sl * L::ASUB, &wmap, full + 8 * st, kc, n0, 0);
#pragma unroll
          for (int t = 0; t < NT; ++t)
            hop::tma_load_3d(stage + L::A + (sl * NT + t) * L::XSUB, &xmap, full + 8 * st, kc,
                             x0 + t * N, 0);
        }
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup (wg, wk): weight rows 64 wg + r and + 8 of the
    // tile, x rows 8 j + c + {0, 1}, slab wk of each stage
    const int wg = (warp / 4) % WG, wk = warp / 4 / WG, wq = warp % 4;
    // NACC independent sums, so the short products of a decode tile do not
    // wait on each other; folded in a fixed order after the K loop
    constexpr int NACC = L::NACC;
    float part[NACC][NT][N / 2];
#pragma unroll
    for (int p = 0; p < NACC; ++p)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) part[p][t][e] = 0.f;

#pragma unroll 1
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % STAGES;
      const uint32_t stage = base + st * L::STAGE;
      hop::mbar_wait(full + 8 * st, (kt / STAGES) & 1);
      uint32_t a[WQ_BK / 16][4];
      weight_frags(gbase + st * L::STAGE + wk * L::ASUB + wg * hop::ROWS * WQ_BK, wq, lane, a);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WQ_BK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < NT; ++t)
          hop::wgmma_rs_k<N>(part[kk % NACC][t], a[kk],
                             hop::desc<128>(stage + L::A + (wk * NT + t) * L::XSUB + 32 * kk));
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      fence_u32(a);   // the fragments stay live (and unshared) until the products end
#pragma unroll
      for (int p = 0; p < NACC; ++p)
#pragma unroll
        for (int t = 0; t < NT; ++t) hop::fence_regs(part[p][t]);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(empty + 8 * st);
    }
#pragma unroll
    for (int p = 1; p < NACC; ++p)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) part[0][t][e] += part[p][t][e];
    float (&acc)[NT][N / 2] = part[0];

    if constexpr (WGK > 1) {
      // the K warpgroups' sums into warpgroup 0's, in order wk = 1, 2, ...
      float* red = reinterpret_cast<float*>(gbase + L::RED_AT);
      const int slot = (warp / 4) % WG * 128 + wq * 32 + lane;   // thread within its K group
      constexpr int PER = NT * (N / 2);
      asm volatile("bar.sync 2, %0;" ::"n"(L::CONSUMERS) : "memory");   // the ring is drained
      if (wk > 0) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < N / 2; ++e)
            red[((wk - 1) * 128 * WG + slot) * PER + t * (N / 2) + e] = acc[t][e];
      }
      asm volatile("bar.sync 2, %0;" ::"n"(L::CONSUMERS) : "memory");
      if (wk == 0) {
#pragma unroll
        for (int g = 1; g < WGK; ++g)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < N / 2; ++e)
              acc[t][e] += red[((g - 1) * 128 * WG + slot) * PER + t * (N / 2) + e];
      }
    }
    // the warpgroups of K group 0 store; the others go on to the cluster
    // barriers
    if (wk == 0) {
      const int r = wg * hop::ROWS + wq * 16 + lane / 4, c = 2 * (lane % 4);
      if (split == 1) {
        // the whole K-sum is here: scale and store straight from the
        // registers (a warp's store covers 8 columns of 4 rows: whole
        // 32-byte sectors)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = n0 + r + 8 * i;
          if (col >= n) continue;
          const float sc = scale[col];
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = x0 + t * N + 8 * j + c + e;
                if (row < m)
                  out[static_cast<long long>(row) * n + col] = acc[t][4 * j + 2 * i + e] * sc;
              }
        }
      } else {
        // stage the (x row, output column) partial sums in the drained ring
        asm volatile("bar.sync 1, %0;" ::"n"(128 * WG) : "memory");
        float* stg = reinterpret_cast<float*>(gbase);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                stg[(t * N + 8 * j + c + e) * L::STG + r + 8 * i] = acc[t][4 * j + 2 * i + e];
      }
    }
  }
  if (split == 1) return;
  cluster.sync();

  // block ``rank`` of the cluster owns the x rows rank, rank + split, ...:
  // it sums their partials over the cluster in rank order (the split loads
  // issued together), scales them and stores each row's columns coalesced
  constexpr int MAX_SPLIT = 8;
  const float* stg = reinterpret_cast<const float*>(gbase);
  const int rows = min(NT * N, m - x0);
  const int mine = rows > rank ? (rows - rank + split - 1) / split : 0;
  for (int idx = threadIdx.x; idx < mine * L::WROWS; idx += L::THREADS) {
    const int row = rank + (idx / L::WROWS) * split, col = idx % L::WROWS;
    if (n0 + col >= n) continue;
    float part[MAX_SPLIT];
#pragma unroll
    for (int rk = 0; rk < MAX_SPLIT; ++rk)
      part[rk] = rk < split ? cluster.map_shared_rank(stg, rk)[row * L::STG + col] : 0.f;
    float sum = part[0];
#pragma unroll
    for (int rk = 1; rk < MAX_SPLIT; ++rk)
      if (rk < split) sum += part[rk];
    out[static_cast<long long>(x0 + row) * n + n0 + col] = sum * scale[n0 + col];
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <int N, int NT, int WG, int WGK>
int launch_wgmma(const void* x, const void* q, const void* scale, void* out, int m, int n,
                 int k, cudaStream_t stream) {
  using L = WoqSmem<N, NT, WG, WGK>;
  CUtensorMap wm, xm;
  int err = hop::bytes_map(&wm, q, n, k, L::WROWS);
  if (err == 0) err = hop::rows_map(&xm, x, 1, m, k, WQ_BK, k, 0, N);
  if (err != 0) return err;
  const cudaError_t e = allow_dynamic_smem(woq_wgmma_kernel<N, NT, WG, WGK>, L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wtiles = (n + L::WROWS - 1) / L::WROWS;
  const int xtiles = (m + NT * N - 1) / (NT * N);
  const int stages = (k + WQ_BK - 1) / WQ_BK / WGK;
  // split K over the largest cluster (at most 8 blocks) whose size divides
  // the stages and keeps the grid within one block an SM
  int split = 1;
  for (int c = 2; c <= 8; ++c)
    if (stages % c == 0 && c * wtiles * xtiles <= 132) split = c;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, wtiles, xtiles);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, woq_wgmma_kernel<N, NT, WG, WGK>, wm, xm,
                                           static_cast<const float*>(scale),
                                           static_cast<float*>(out), m, n, k);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

// Decode (M <= 64): x tiles of N = M rounded up to 8, 16, 32 or 64 rows
// against 64 weight rows, and WGK = 4 warpgroups along K where 4 slabs
// divide K (Whisper's 1280 and 5120): a stage holds 256 of K and its four
// slabs are widened and multiplied at once, 16 warps a block. Encoder
// (M > 64): x tiles of 192 rows against 128 weight rows (two warpgroups),
// one slab a stage: 32 KB a stage for 3.1 MFLOP, where 64 x 256 read 36 KB
// for 2.1 and were held by L2's rate (a warpgroup's registers hold 168 a
// thread: four N = 64 tiles spilled).
template <int WGK>
int launch_decode(const void* x, const void* q, const void* scale, void* out, int m, int n,
                  int k, cudaStream_t stream) {
  if (m <= 8) return launch_wgmma<8, 1, 1, WGK>(x, q, scale, out, m, n, k, stream);
  if (m <= 16) return launch_wgmma<16, 1, 1, WGK>(x, q, scale, out, m, n, k, stream);
  if (m <= 32) return launch_wgmma<32, 1, 1, WGK>(x, q, scale, out, m, n, k, stream);
  return launch_wgmma<64, 1, 1, WGK>(x, q, scale, out, m, n, k, stream);
}

int launch_bf16(const void* x, const void* q, const void* scale, void* out, int m, int n, int k,
                cudaStream_t stream) {
  if (m > 64) return launch_wgmma<64, 3, 2, 1>(x, q, scale, out, m, n, k, stream);
  if (k % (4 * WQ_BK) == 0) return launch_decode<4>(x, q, scale, out, m, n, k, stream);
  return launch_decode<1>(x, q, scale, out, m, n, k, stream);
}

// -- f32 x: CUDA cores -----------------------------------------------------------------

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
int launch_fma(const void* x, const void* q, const void* scale, void* out, int m,
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
    case DT_BF16: return launch_bf16(x, q, scale, out, m, n, k, st);
    case DT_F32: return launch_fma<float>(x, q, scale, out, m, n, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
