// Greedy decode epilogue: vocab product + logit filters -> (B, 6) aggregates.
//
// Replaces stable_ts_tpu/ops/logit_epilogue.py:_kernel
// (fused_logit_aggregates). For each row r it computes the logits
// f[v] = x[r] . emb[v] (x cast to the embedding's dtype, products summed in
// f32), adds the suppress vector and the row's timestamp-silence mask, sets
// the grammar bans to -1e9 (ts_ban: every timestamp; text_ban: ids < eot;
// has_ts: timestamps below ts_begin + floor), and folds the result into
//   [m_text, a_text, s_text, m_ts, a_ts, s_ts]
// = (max, first argmax, sum of exp(f - max)) over the text ids [0, ts_begin)
// and over the timestamp ids [ts_begin, V). The (B, V) logits never reach
// device memory.
//
// What bounds it on the card: bytes. One step streams the whole (V, d)
// embedding (133 MB in bf16 at large-v3) for a handful of rows, about
// 2 * B multiply-adds per byte.
//
// bf16 (epilogue_wgmma): the product runs on the tensor cores as in
// vocab_proj.cu, A and B swapped. A 64-id x 64-of-d tile of the embedding
// (TMA, 128-byte swizzle) is wgmma's A operand, K-major as it is stored;
// the chunk's x rows are the B operand, N = B rounded up to 8, 16, 32 or
// 64 (more than 64 rows take more chunks, grid y). The grid is persistent:
// at most EPI_GRID blocks, each walking a contiguous range of 64-id tiles
// (as many as every other block, or one fewer: epi_parts), one
// producer warp keeping a ring of EPI_STAGES stages in flight across tile
// boundaries, one consumer warpgroup keeping one stage's products in flight
// while it waits for the next. After a tile's last stage the f32
// accumulator is filtered and folded where it lies, in registers: the
// suppress value and the row's silence value (both loaded before the
// tile's first product), the three bans, then a running (max, argmax,
// sumexp) per (x row, part). A thread holds ids r and r + 8 of each tile
// (r = 16 warp + lane / 4), so its own ids arrive in ascending order; the
// merges over lanes and warps compare ids on equal maxima (the lower id
// wins). TMA zero-fills ids >= V, x rows >= B and d columns >= d; those
// ids and rows are never folded. No logit reaches device memory. Each
// block writes one partial per (row, part), so a row has at most EPI_GRID
// partials in place of one per tile.
//
// f32 (epilogue_partial_kernel): CUDA cores. One block per (tile of
// EPI_TILE vocab rows, chunk of up to EPI_ROWS x rows). The chunk's x rows
// sit in shared memory as f32; each warp walks its EPI_TILE / EPI_WARPS
// vocab rows in ascending order, reads a row once with 16-byte loads across
// the lanes, sums the EPI_ROWS dot products with warp shuffles, filters,
// and folds each value online-softmax style with strictly-greater argmax
// replacement (the first maximum wins). The block merges its warps in
// order and writes one partial per (row, tile).
//
// Both end in epilogue_merge_kernel: one warp per row merges the
// partials, each lane a contiguous ascending range, then a fixed butterfly
// over the lanes. Every merge order is fixed, no atomics: reruns are
// bit-identical.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int EPI_THREADS = 256;
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_TILE = 64;             // vocab rows per block
constexpr int EPI_ROWS = 8;              // x rows per block
constexpr float EPI_MINF = -1e30f;       // fold identity
constexpr float EPI_NEG = -1e9f;         // grammar ban value

struct Fold {
  float m, a, s;
};

__device__ __forceinline__ Fold fold_identity() { return {EPI_MINF, 0.f, 0.f}; }

// one value (ids arrive in ascending order)
__device__ __forceinline__ void fold_push(Fold& f, float v, int id) {
  if (v > f.m) {
    f.s = f.s * expf(f.m - v) + 1.f;
    f.m = v;
    f.a = static_cast<float>(id);
  } else {
    f.s += expf(v - f.m);
  }
}

// merge two folds of disjoint id sets: on equal maxima the lower id wins
__device__ __forceinline__ Fold fold_merge(const Fold& x, const Fold& y) {
  const float m = fmaxf(x.m, y.m);
  Fold out;
  out.m = m;
  out.s = x.s * expf(x.m - m) + y.s * expf(y.m - m);
  out.a = (y.m > x.m || (y.m == x.m && y.a < x.a)) ? y.a : x.a;
  return out;
}

__device__ __forceinline__ Fold fold_shfl_xor(const Fold& f, int mask) {
  return {__shfl_xor_sync(FULL_MASK, f.m, mask), __shfl_xor_sync(FULL_MASK, f.a, mask),
          __shfl_xor_sync(FULL_MASK, f.s, mask)};
}

// the filters of one logit f of id v for x row ``row`` (flags fl: text_ban,
// ts_ban, has_ts, floor), in the twin's order: + suppress, + silence, bans
__device__ __forceinline__ float filtered(float f, float sup_v, float sil_v, bool has_sil,
                                          const int* fl, int grammar, int v, int ts_begin,
                                          int eot) {
  f = f + sup_v;
  if (has_sil) f = f + sil_v;
  if (grammar) {
    const bool is_ts = v >= ts_begin;
    if (fl[1] && is_ts) f = EPI_NEG;
    if (fl[0] && v < eot) f = EPI_NEG;
    if (fl[2] && is_ts && v < ts_begin + fl[3]) f = EPI_NEG;
  }
  return f;
}

__global__ void __launch_bounds__(EPI_THREADS)
epilogue_partial_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                        const float* __restrict__ sup,
                        const float* __restrict__ sil, long long sil_rs,
                        const int* __restrict__ flags, float* __restrict__ part,
                        int batch, int d, int n_vocab, int ts_begin, int eot,
                        int grammar, int n_tiles) {
  constexpr int VN = Vec16<float>::N;
  extern __shared__ float xs[];                       // EPI_ROWS * d
  __shared__ Fold wfold[EPI_WARPS][EPI_ROWS][2];

  const int tile = blockIdx.x, r0 = blockIdx.y * EPI_ROWS;
  const int n_rows = min(EPI_ROWS, batch - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < n_rows * d; i += EPI_THREADS)
    xs[i] = x[static_cast<long long>(r0) * d + i];
  __syncthreads();

  Fold fold[EPI_ROWS][2];
#pragma unroll
  for (int r = 0; r < EPI_ROWS; ++r) fold[r][0] = fold[r][1] = fold_identity();

  const int chunks = d / VN;
  const int v_begin = tile * EPI_TILE + warp * (EPI_TILE / EPI_WARPS);
  const int v_end = min(v_begin + EPI_TILE / EPI_WARPS, n_vocab);
  for (int v = v_begin; v < v_end; ++v) {
    const float* row = emb + static_cast<long long>(v) * d;
    float acc[EPI_ROWS];
#pragma unroll
    for (int r = 0; r < EPI_ROWS; ++r) acc[r] = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float e[VN];
      load16(row + c * VN, e);
#pragma unroll
      for (int r = 0; r < EPI_ROWS; ++r) {
        if (r < n_rows) {
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
    const bool is_ts = v >= ts_begin;
    const float sup_v = sup[v];
#pragma unroll
    for (int r = 0; r < EPI_ROWS; ++r) {
      if (r < n_rows) {
        float f = acc[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(FULL_MASK, f, o);
        const float sil_v = sil ? sil[(r0 + r) * sil_rs + v] : 0.f;
        f = filtered(f, sup_v, sil_v, sil != nullptr, grammar ? flags + (r0 + r) * 4 : nullptr,
                     grammar, v, ts_begin, eot);
        if (is_ts) fold_push(fold[r][1], f, v);
        else fold_push(fold[r][0], f, v);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < EPI_ROWS; ++r) {
      wfold[warp][r][0] = fold[r][0];
      wfold[warp][r][1] = fold[r][1];
    }
  }
  __syncthreads();
  if (tid < n_rows * 2) {
    const int r = tid >> 1, p = tid & 1;
    Fold acc = wfold[0][r][p];
    for (int w = 1; w < EPI_WARPS; ++w) acc = fold_merge(acc, wfold[w][r][p]);
    float* out = part + (static_cast<long long>(r0 + r) * n_tiles + tile) * 6 + p * 3;
    out[0] = acc.m;
    out[1] = acc.a;
    out[2] = acc.s;
  }
}

// -- bf16: wgmma tiles fed by TMA, a persistent grid ---------------------------

constexpr int EPI_STAGES = 8;
constexpr int EPI_BK = 64;      // d values per stage: one 128-byte swizzled row
constexpr int EPI_GRID = 132;   // at most one persistent block per H100 SM

// shared-memory layout (byte offsets from a 1024-aligned base); every tile
// starts on a 1024-byte boundary
template <int N>
struct EpiSmem {
  static constexpr int A = hop::ROWS * EPI_BK * 2;  // 64 embedding rows, 8 KB
  static constexpr int B = N * EPI_BK * 2;          // the chunk's x rows
  static constexpr int STAGE = A + B;
  static constexpr int BAR = EPI_STAGES * STAGE;    // init_ring's barriers: own (unused), full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * EPI_STAGES) + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle phase");
};

// blocks of the persistent grid for n_tiles tiles of 64 ids: the fewest
// tiles a block that fit EPI_GRID blocks, then the fewest blocks that take
// them, so that every block walks the same number of tiles or one fewer
// (811 tiles: 116 blocks of 7 or 6, where 132 blocks would leave 19 blocks
// a seventh tile while the rest idle)
inline int epi_parts(int n_tiles) {
  const int per_block = (n_tiles + EPI_GRID - 1) / EPI_GRID;
  return (n_tiles + per_block - 1) / per_block;
}

template <int N>
__global__ void __launch_bounds__(hop::THREADS)
epilogue_wgmma(const __grid_constant__ CUtensorMap emap, const __grid_constant__ CUtensorMap xmap,
               const float* __restrict__ sup, const float* __restrict__ sil, long long sil_rs,
               const int* __restrict__ flags, float* __restrict__ part, int batch, int d,
               int n_vocab, int ts_begin, int eot, int grammar, int n_tiles, int n_parts) {
  using L = EpiSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int fl_s[N][4];
  __shared__ Fold wf[hop::CONSUMERS / 32][N][2];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BAR + 8, empty = full + 8 * EPI_STAGES;
  const int blk = blockIdx.x, r0 = blockIdx.y * N;
  const int n_rows = min(N, batch - r0);
  // this block's tiles: a contiguous range, the same split on every run
  const int t0 = static_cast<int>(static_cast<long long>(blk) * n_tiles / n_parts);
  const int t1 = static_cast<int>(static_cast<long long>(blk + 1) * n_tiles / n_parts);
  const int n_k = (d + EPI_BK - 1) / EPI_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int q = threadIdx.x; q < N * 4; q += hop::THREADS) {
    const int row = q / 4;
    fl_s[row][q % 4] = grammar && row < n_rows ? flags[(r0 + row) * 4 + q % 4] : 0;
  }
  hop::init_ring<EPI_STAGES>(base + L::BAR, 1);  // its __syncthreads also publishes fl_s

  if (warp == hop::CONSUMERS / 32) {  // producer: the ring runs on across tiles
    if (lane == 0) {
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % EPI_STAGES;
          const uint32_t stage = base + st * L::STAGE;
          hop::mbar_wait(empty + 8 * st, ((it / EPI_STAGES) & 1) ^ 1);
          hop::mbar_arrive_expect(full + 8 * st, L::STAGE);
          hop::tma_load_3d(stage, &emap, full + 8 * st, kt * EPI_BK, t * hop::ROWS, 0);
          hop::tma_load_3d(stage + L::A, &xmap, full + 8 * st, kt * EPI_BK, r0, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroup: ids r and r + 8 of each tile, x rows 8 j + c + {0, 1}
  const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
  Fold fold[N / 8][2][2];  // [j][e][part: text, timestamps]
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) fold[j][e][0] = fold[j][e][1] = fold_identity();

  int it = 0;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    // the tile's gathers, issued before its products so their latency hides
    float sup_v[2], sil_v[2][N / 8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = t * hop::ROWS + r + 8 * i;
      const bool in = v < n_vocab;
      sup_v[i] = in ? sup[v] : 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + c + e;
          sil_v[i][j][e] = sil && in && col < n_rows ? sil[(r0 + col) * sil_rs + v] : 0.f;
        }
    }

    float acc[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) acc[k] = 0.f;
#pragma unroll 1
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int st = it % EPI_STAGES;
      const uint32_t stage = base + st * L::STAGE;
      hop::mbar_wait(full + 8 * st, (it / EPI_STAGES) & 1);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < EPI_BK / 16; ++kk)
        hop::wgmma_ss<N>(acc, hop::desc<128>(stage + 32 * kk),
                         hop::desc<128>(stage + L::A + 32 * kk), 1);
      hop::wgmma_commit();
      // the previous stage's products are done: hand its slot back
      hop::wgmma_wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0) hop::mbar_arrive(empty + 8 * ((it - 1) % EPI_STAGES));
    }
    hop::wgmma_wait_all();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + 8 * ((it - 1) % EPI_STAGES));

    // filters and fold, on plain registers (no wgmma on a divergent path)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = t * hop::ROWS + r + 8 * i;
      if (v < n_vocab) {
        const bool is_ts = v >= ts_begin;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + c + e;
            if (col < n_rows) {
              const float f = filtered(acc[4 * j + 2 * i + e], sup_v[i], sil_v[i][j][e],
                                       sil != nullptr, fl_s[col], grammar, v, ts_begin, eot);
              if (is_ts) fold_push(fold[j][e][1], f, v);
              else fold_push(fold[j][e][0], f, v);
            }
          }
      }
    }
  }

  // merge the 8 lane groups of each warp (lanes that share lane % 4), then
  // the 4 warps in order, and write the block's partial of each (row, part)
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        Fold f = fold[j][e][p];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) f = fold_merge(f, fold_shfl_xor(f, o));
        if (lane < 4) wf[warp][8 * j + c + e][p] = f;
      }
  asm volatile("bar.sync 1, %0;" ::"n"(hop::CONSUMERS) : "memory");
  if (threadIdx.x < n_rows * 2) {
    const int col = threadIdx.x >> 1, p = threadIdx.x & 1;
    Fold f = wf[0][col][p];
#pragma unroll
    for (int w = 1; w < hop::CONSUMERS / 32; ++w) f = fold_merge(f, wf[w][col][p]);
    float* out = part + (static_cast<long long>(r0 + col) * n_parts + blk) * 6 + p * 3;
    out[0] = f.m;
    out[1] = f.a;
    out[2] = f.s;
  }
}

// one warp a row: each lane merges a contiguous ascending range of the
// partials, then a fixed butterfly over the lanes
__global__ void __launch_bounds__(32)
epilogue_merge_kernel(const float* __restrict__ part, float* __restrict__ out, int n_parts) {
  const int r = blockIdx.x, lane = threadIdx.x;
  const int per = (n_parts + 31) / 32, t0 = lane * per, t1 = min(t0 + per, n_parts);
  Fold acc[2] = {fold_identity(), fold_identity()};
  for (int t = t0; t < t1; ++t) {
    const float* p = part + (static_cast<long long>(r) * n_parts + t) * 6;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      acc[k] = fold_merge(acc[k], Fold{p[3 * k], p[3 * k + 1], p[3 * k + 2]});
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < 2; ++k) acc[k] = fold_merge(acc[k], fold_shfl_xor(acc[k], o));
  if (lane < 6) {
    const Fold& f = acc[lane / 3];
    const int k = lane % 3;
    out[r * 6 + lane] = k == 0 ? f.m : (k == 1 ? f.a : f.s);
  }
}

int merge(const void* part, void* out, int batch, int n_parts, cudaStream_t stream) {
  epilogue_merge_kernel<<<batch, 32, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n_parts);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_wgmma(const void* x, const void* emb, const void* sup, const void* sil,
                 long long sil_rs, const void* flags, void* part, void* out, int batch, int d,
                 int n_vocab, int ts_begin, int eot, int grammar, cudaStream_t stream) {
  CUtensorMap em, xm;
  int err = hop::rows_map(&em, emb, 1, n_vocab, d, EPI_BK, d, 0);
  if (err == 0) err = hop::rows_map(&xm, x, 1, batch, d, EPI_BK, d, 0, N);
  if (err != 0) return err;
  constexpr int smem = EpiSmem<N>::BYTES;
  cudaError_t e = allow_dynamic_smem(epilogue_wgmma<N>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (n_vocab + hop::ROWS - 1) / hop::ROWS;
  const int n_parts = epi_parts(n_tiles);
  const dim3 grid(n_parts, (batch + N - 1) / N);
  epilogue_wgmma<N><<<grid, hop::THREADS, smem, stream>>>(
      em, xm, static_cast<const float*>(sup), static_cast<const float*>(sil), sil_rs,
      static_cast<const int*>(flags), static_cast<float*>(part), batch, d, n_vocab, ts_begin,
      eot, grammar, n_tiles, n_parts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return merge(part, out, batch, n_parts, stream);
}

int launch_bf16(const void* x, const void* emb, const void* sup, const void* sil,
                long long sil_rs, const void* flags, void* part, void* out, int batch, int d,
                int n_vocab, int ts_begin, int eot, int grammar, cudaStream_t stream) {
  if (batch <= 8)
    return launch_wgmma<8>(x, emb, sup, sil, sil_rs, flags, part, out, batch, d, n_vocab,
                           ts_begin, eot, grammar, stream);
  if (batch <= 16)
    return launch_wgmma<16>(x, emb, sup, sil, sil_rs, flags, part, out, batch, d, n_vocab,
                            ts_begin, eot, grammar, stream);
  if (batch <= 32)
    return launch_wgmma<32>(x, emb, sup, sil, sil_rs, flags, part, out, batch, d, n_vocab,
                            ts_begin, eot, grammar, stream);
  return launch_wgmma<64>(x, emb, sup, sil, sil_rs, flags, part, out, batch, d, n_vocab,
                          ts_begin, eot, grammar, stream);
}

int launch_f32(const void* x, const void* emb, const void* sup, const void* sil,
               long long sil_rs, const void* flags, void* part, void* out, int batch, int d,
               int n_vocab, int ts_begin, int eot, int grammar, cudaStream_t stream) {
  if (d % Vec16<float>::N != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_vocab + EPI_TILE - 1) / EPI_TILE;
  const size_t smem = static_cast<size_t>(EPI_ROWS) * d * sizeof(float);
  const cudaError_t e = allow_dynamic_smem(epilogue_partial_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_tiles, (batch + EPI_ROWS - 1) / EPI_ROWS);
  epilogue_partial_kernel<<<grid, EPI_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb),
      static_cast<const float*>(sup), static_cast<const float*>(sil), sil_rs,
      static_cast<const int*>(flags), static_cast<float*>(part), batch, d,
      n_vocab, ts_begin, eot, grammar, n_tiles);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return static_cast<int>(le);
  return merge(part, out, batch, n_tiles, stream);
}

}  // namespace

// x (B, d) and emb (V, d): contiguous, same dtype (bf16 or f32), rows of
// 16-byte multiples, 16-byte aligned bases; sup (V,)
// f32; sil: f32 rows of stride sil_rs, or null (no silence mask); flags
// (B, 4) int32 [text_ban, ts_ban, has_ts, ts_floor], read only when
// grammar != 0; part: scratch of epilogue_partial_floats(B, V) f32; out
// (B, 6) f32.
extern "C" int logit_epilogue(const void* x, const void* emb, const void* sup,
                              const void* sil, long long sil_rs,
                              const void* flags, void* part, void* out,
                              int dtype, int batch, int d, int n_vocab,
                              int ts_begin, int eot, int grammar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_BF16:
      return launch_bf16(x, emb, sup, sil, sil_rs, flags, part, out, batch, d, n_vocab,
                         ts_begin, eot, grammar, st);
    case DT_F32:
      return launch_f32(x, emb, sup, sil, sil_rs, flags, part, out, batch, d, n_vocab,
                        ts_begin, eot, grammar, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the scratch either kernel needs: f32 writes one partial per (row, tile of
// EPI_TILE ids), bf16 one per (row, block of its grid), at most one a tile
extern "C" long long epilogue_partial_floats(int batch, int n_vocab) {
  return static_cast<long long>(batch) * ((n_vocab + EPI_TILE - 1) / EPI_TILE) * 6;
}
