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
// Design. Pass 1: one block per (tile of EPI_TILE vocab rows, chunk of up
// to EPI_ROWS x rows). The chunk's x rows sit in shared memory as f32;
// each warp walks its EPI_TILE / EPI_WARPS vocab rows in ascending order,
// reads a row once with 16-byte loads across the lanes, sums the EPI_ROWS
// dot products with warp shuffles, filters, and folds each value into a
// running (max, argmax, sumexp) per row and part, online-softmax style with
// strictly-greater argmax replacement (the first maximum wins). The block
// merges its warps in ascending order and writes one partial per (row,
// tile). Pass 2: one block per row merges the tiles' partials, each thread
// a contiguous ascending range, then a fixed pairwise tree whose left side
// (lower ids) wins ties. The merge order is fixed, so the result is
// deterministic. Ids >= V are never read: they count as the -1e30 identity.
#include "common.cuh"

namespace {

constexpr int EPI_THREADS = 256;
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_TILE = 64;             // vocab rows per block
constexpr int EPI_ROWS = 8;              // x rows per block
constexpr int MERGE_THREADS = 256;
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

// lo holds lower ids than hi: lo keeps the argmax on a tie
__device__ __forceinline__ Fold fold_merge(const Fold& lo, const Fold& hi) {
  const float m = fmaxf(lo.m, hi.m);
  Fold out;
  out.m = m;
  out.s = lo.s * expf(lo.m - m) + hi.s * expf(hi.m - m);
  out.a = hi.m > lo.m ? hi.a : lo.a;
  return out;
}

template <typename T>
__global__ void __launch_bounds__(EPI_THREADS)
epilogue_partial_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                        const float* __restrict__ sup,
                        const float* __restrict__ sil, long long sil_rs,
                        const int* __restrict__ flags, float* __restrict__ part,
                        int batch, int d, int n_vocab, int ts_begin, int eot,
                        int grammar, int n_tiles) {
  constexpr int VN = Vec16<T>::N;
  extern __shared__ float xs[];                       // EPI_ROWS * d
  __shared__ Fold wfold[EPI_WARPS][EPI_ROWS][2];

  const int tile = blockIdx.x, r0 = blockIdx.y * EPI_ROWS;
  const int n_rows = min(EPI_ROWS, batch - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < n_rows * d; i += EPI_THREADS)
    xs[i] = to_float(x[static_cast<long long>(r0) * d + i]);
  __syncthreads();

  Fold fold[EPI_ROWS][2];
#pragma unroll
  for (int r = 0; r < EPI_ROWS; ++r) fold[r][0] = fold[r][1] = fold_identity();

  const int chunks = d / VN;
  const int v_begin = tile * EPI_TILE + warp * (EPI_TILE / EPI_WARPS);
  const int v_end = min(v_begin + EPI_TILE / EPI_WARPS, n_vocab);
  for (int v = v_begin; v < v_end; ++v) {
    const T* row = emb + static_cast<long long>(v) * d;
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
        f = f + sup_v;
        if (sil) f = f + sil[(r0 + r) * sil_rs + v];
        if (grammar) {
          const int* fl = flags + (r0 + r) * 4;   // text_ban, ts_ban, has_ts, floor
          if (fl[1] && is_ts) f = EPI_NEG;
          if (fl[0] && v < eot) f = EPI_NEG;
          if (fl[2] && is_ts && v < ts_begin + fl[3]) f = EPI_NEG;
        }
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

__global__ void __launch_bounds__(MERGE_THREADS)
epilogue_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int n_tiles) {
  __shared__ Fold tree[2][MERGE_THREADS];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int per = (n_tiles + MERGE_THREADS - 1) / MERGE_THREADS;
  const int t0 = tid * per, t1 = min(t0 + per, n_tiles);
  Fold acc[2] = {fold_identity(), fold_identity()};
  for (int t = t0; t < t1; ++t) {
    const float* p = part + (static_cast<long long>(r) * n_tiles + t) * 6;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      acc[k] = fold_merge(acc[k], Fold{p[3 * k], p[3 * k + 1], p[3 * k + 2]});
  }
  tree[0][tid] = acc[0];
  tree[1][tid] = acc[1];
  __syncthreads();
  for (int stride = 1; stride < MERGE_THREADS; stride <<= 1) {
    if (tid % (2 * stride) == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        tree[k][tid] = fold_merge(tree[k][tid], tree[k][tid + stride]);
    }
    __syncthreads();
  }
  if (tid < 6) {
    const Fold& f = tree[tid / 3][0];
    const int k = tid % 3;
    out[r * 6 + tid] = k == 0 ? f.m : (k == 1 ? f.a : f.s);
  }
}

template <typename T>
int launch(const void* x, const void* emb, const void* sup, const void* sil,
           long long sil_rs, const void* flags, void* part, void* out,
           int batch, int d, int n_vocab, int ts_begin, int eot, int grammar,
           cudaStream_t stream) {
  if (d % Vec16<T>::N != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_vocab + EPI_TILE - 1) / EPI_TILE;
  const size_t smem = static_cast<size_t>(EPI_ROWS) * d * sizeof(float);
  cudaError_t e = allow_dynamic_smem(epilogue_partial_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_tiles, (batch + EPI_ROWS - 1) / EPI_ROWS);
  epilogue_partial_kernel<T><<<grid, EPI_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(emb),
      static_cast<const float*>(sup), static_cast<const float*>(sil), sil_rs,
      static_cast<const int*>(flags), static_cast<float*>(part), batch, d,
      n_vocab, ts_begin, eot, grammar, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  epilogue_merge_kernel<<<batch, MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, d) and emb (V, d): contiguous, same dtype (bf16 or f32); sup (V,)
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
      return launch<__nv_bfloat16>(x, emb, sup, sil, sil_rs, flags, part, out,
                                   batch, d, n_vocab, ts_begin, eot, grammar, st);
    case DT_F32:
      return launch<float>(x, emb, sup, sil, sil_rs, flags, part, out, batch, d,
                           n_vocab, ts_begin, eot, grammar, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long epilogue_partial_floats(int batch, int n_vocab) {
  return static_cast<long long>(batch) * ((n_vocab + EPI_TILE - 1) / EPI_TILE) * 6;
}
