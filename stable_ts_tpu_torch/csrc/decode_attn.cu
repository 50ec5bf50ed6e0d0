// Decode attention: one query row per (batch row, head) against a cache.
//
// Replaces four TPU kernels of stable_ts_tpu:
//   - ops/self_attn.py:_kernel (self_attn_decode): keys j <= pos of the
//     int8 row cache of the decode step's self-attention;
//   - ops/self_attn.py:_kernel_beam (self_attn_decode with anc): the same,
//     but beam row r reads key j from the cache row of its window group that
//     anc[r, j] names (the beam loop reshuffles that table, never the cache);
//   - ops/cross_attn.py:_kernel, the g = 1 8-bit branch (cross_attn_decode):
//     keys j < s of the precomputed cross-attention K/V;
//   - ops/cross_attn.py:_kernel, the q_per_kv = g > 1 branch: g query rows
//     (the beams or best_of candidates of one window) share their window's
//     cross K/V.
//
// What bounds it on the card: bytes. A decode step reads each cache row
// once and does 2 multiply-adds per byte (2 g with g query rows per row),
// far below the ~295 FLOP/byte the H100 needs before compute matters. So the
// kernels read every K and V row exactly once per block, with 16-byte loads
// along d (the row-major (.., S, d) layout makes a head's slice of a row
// contiguous), widen int8/bf16 to f32 in registers with the per-position
// dequant scale applied to the logit and weight rows, and never write a
// dequantized copy or the logits to device memory. Softmax runs in f32 in
// shared memory.
//
// decode_attn_kernel: one block per (head, batch row); 128 threads:
//   1. each thread scores key rows j = tid, tid + 128, ... (q . k_j) * ks[j];
//   2. block max / sum -> unnormalized weights p_j * vs[j] in shared memory;
//   3. V: the head's d_head slice of a row is CPR 16-byte chunks; 128 / CPR
//      row groups each accumulate a partial sum over their rows, reduced in
//      shared memory; out = sum / l.
// The beam variant takes key j's row from (r / g) * g + anc[r, j] (a
// 4-byte read per key beside the 64-byte int8 head slice).
//
// cross_group_kernel: one block per (head, window, chunk of up to GMAX of
// the window's g query rows). Each K row is loaded once and scored against
// every query row of the chunk; each V row is loaded once (8-byte loads, so
// the GMAX x 8 accumulators stay in registers) and added into every row's
// sum. With g <= GMAX the window's K/V stream is read once for all g rows,
// which is what the TPU branch exists for.
//
// The cross entries round the query and the weights to bf16 before the two
// products, as the TPU kernel does for its MXU (cross_attn.py:107,118-120,
// 129); the self entries keep them in f32, as the XLA cache path does.
#include "common.cuh"

namespace {

constexpr int DEC_THREADS = 128;
constexpr int GMAX = 8;  // query rows per block of the cross group entry

template <typename T, int DH, bool ROUND, bool BEAM>
__global__ void __launch_bounds__(DEC_THREADS)
decode_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, float* __restrict__ out,
                   int n_head, int n_keys, long long kv_bs, long long kv_rs,
                   long long sc_bs, const int* __restrict__ anc,
                   long long anc_rs, int g) {
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
  const int* ancb = BEAM ? anc + b * anc_rs : nullptr;
  const int group0 = BEAM ? (b / g) * g : b;
  // the batch row that holds key j
  auto src = [&](int j) -> long long { return BEAM ? group0 + ancb[j] : b; };

  if (tid < DH) {
    const float qv = q[(long long)b * d + h * DH + tid];
    qs[tid] = ROUND ? round_bf16(qv) : qv;
  }
  __syncthreads();

  // 1. scores
  float lmax = -INFINITY;
  for (int j = tid; j < n_keys; j += DEC_THREADS) {
    const long long r = src(j);
    const T* row = k + r * kv_bs + j * kv_rs + h * DH;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      float kv[VN];
      load16(row + c * VN, kv);
#pragma unroll
      for (int e = 0; e < VN; ++e) acc = fmaf(qs[c * VN + e], kv[e], acc);
    }
    const float s = ks ? acc * ks[r * sc_bs + j] : acc;
    p[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_reduce<DEC_THREADS>(lmax, -INFINITY, MaxOp(), scratch);

  // 2. weights
  float lsum = 0.f;
  for (int j = tid; j < n_keys; j += DEC_THREADS) {
    const float e = expf(p[j] - m);
    lsum += e;
    const float w = vs ? e * vs[src(j) * sc_bs + j] : e;
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
    load16(v + src(j) * kv_bs + j * kv_rs + h * DH + chunk * VN, vv);
    const float w = p[j];
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] = fmaf(w, vv[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < VN; ++e) part[group][chunk * VN + e] = acc[e];
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
    for (int gi = 0; gi < GROUPS; ++gi) o += part[gi][tid];
    out[(long long)b * d + h * DH + tid] = o / l;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(DEC_THREADS)
cross_group_kernel(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, float* __restrict__ out,
                   int n_head, int n_keys, long long kv_bs, long long kv_rs,
                   long long sc_bs, int g) {
  constexpr int VN = Vec16<T>::N;        // K stage: 16-byte chunks
  constexpr int CPR = DH / VN;
  constexpr int V8 = Vec8<T>::N;         // V stage: 8-byte chunks
  constexpr int CPR8 = DH / V8;
  constexpr int GROUPS = DEC_THREADS / CPR8;
  static_assert(DH % VN == 0 && DH % V8 == 0, "d_head must fill whole chunks");

  extern __shared__ float p[];           // GMAX rows of n_keys scores / weights
  __shared__ float qs[GMAX][DH];
  __shared__ float part[GROUPS][DH];
  __shared__ float scratch[DEC_THREADS / 32];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int q0 = b * g + blockIdx.z * GMAX;          // first query row
  const int ng = min(GMAX, g - blockIdx.z * GMAX);   // query rows here
  const int d = n_head * DH;
  const T* kb = k + b * kv_bs + h * DH;
  const T* vb = v + b * kv_bs + h * DH;
  const float* ksb = ks ? ks + b * sc_bs : nullptr;
  const float* vsb = vs ? vs + b * sc_bs : nullptr;

  for (int i = tid; i < ng * DH; i += DEC_THREADS)
    qs[i / DH][i % DH] = round_bf16(q[(long long)(q0 + i / DH) * d + h * DH + i % DH]);
  __syncthreads();

  // 1. scores of every query row against each K row, read once
  float lmax[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) lmax[gi] = -INFINITY;
  for (int j = tid; j < n_keys; j += DEC_THREADS) {
    const T* row = kb + j * kv_rs;
    float acc[GMAX];
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) acc[gi] = 0.f;
    // one chunk's values live at a time, so the GMAX sums stay in registers
#pragma unroll 1
    for (int c = 0; c < CPR; ++c) {
      float kv[VN];
      load16(row + c * VN, kv);
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < ng) {
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[gi] = fmaf(qs[gi][c * VN + e], kv[e], acc[gi]);
        }
      }
    }
    const float sc = ksb ? ksb[j] : 1.f;
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < ng) {
        const float s = ksb ? acc[gi] * sc : acc[gi];
        p[gi * n_keys + j] = s;
        lmax[gi] = fmaxf(lmax[gi], s);
      }
    }
  }
  float m[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
    if (gi < ng) m[gi] = block_reduce<DEC_THREADS>(lmax[gi], -INFINITY, MaxOp(), scratch);

  // 2. weights, rounded to bf16 after the V scale
  float lsum[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) lsum[gi] = 0.f;
  for (int j = tid; j < n_keys; j += DEC_THREADS) {
    const float vsc = vsb ? vsb[j] : 1.f;
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < ng) {
        const float e = expf(p[gi * n_keys + j] - m[gi]);
        lsum[gi] += e;
        p[gi * n_keys + j] = round_bf16(vsb ? e * vsc : e);
      }
    }
  }
  float l[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
    if (gi < ng) l[gi] = block_reduce<DEC_THREADS>(lsum[gi], 0.f, SumOp(), scratch);

  // 3. each V row read once, added into every query row's sum
  const int chunk = tid % CPR8, group = tid / CPR8;
  float acc[GMAX][V8];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
#pragma unroll
    for (int e = 0; e < V8; ++e) acc[gi][e] = 0.f;
  for (int j = group; j < n_keys; j += GROUPS) {
    float vv[V8];
    load8(vb + j * kv_rs + chunk * V8, vv);
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < ng) {
        const float w = p[gi * n_keys + j];
#pragma unroll
        for (int e = 0; e < V8; ++e) acc[gi][e] = fmaf(w, vv[e], acc[gi][e]);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < ng) {
#pragma unroll
      for (int e = 0; e < V8; ++e) part[group][chunk * V8 + e] = acc[gi][e];
      __syncthreads();
      if (tid < DH) {
        float o = 0.f;
        for (int r = 0; r < GROUPS; ++r) o += part[r][tid];
        out[(long long)(q0 + gi) * d + h * DH + tid] = o / l[gi];
      }
      __syncthreads();
    }
  }
}

// Arguments of every entry, passed through to the launches.
struct DecodeArgs {
  const void *q, *k, *v, *ks, *vs;
  void* out;
  int batch, n_head, d_head, n_keys;
  long long kv_bs, kv_rs, sc_bs;
  const void* anc;
  long long anc_rs;
  int g;
  cudaStream_t stream;
};

template <typename T, bool ROUND, bool BEAM>
int launch_rows(const DecodeArgs& a) {
  const dim3 grid(a.n_head, a.batch);
  const size_t smem = static_cast<size_t>(a.n_keys) * sizeof(float);
#define DEC_LAUNCH(DH)                                                          \
  decode_attn_kernel<T, DH, ROUND, BEAM><<<grid, DEC_THREADS, smem, a.stream>>>( \
      static_cast<const float*>(a.q), static_cast<const T*>(a.k),               \
      static_cast<const T*>(a.v), static_cast<const float*>(a.ks),              \
      static_cast<const float*>(a.vs), static_cast<float*>(a.out), a.n_head,    \
      a.n_keys, a.kv_bs, a.kv_rs, a.sc_bs, static_cast<const int*>(a.anc),      \
      a.anc_rs, a.g)
  switch (a.d_head) {
    case 32: DEC_LAUNCH(32); break;
    case 64: DEC_LAUNCH(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEC_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_group_dh(const DecodeArgs& a) {
  const dim3 grid(a.n_head, a.batch, (a.g + GMAX - 1) / GMAX);
  const size_t smem = static_cast<size_t>(GMAX) * a.n_keys * sizeof(float);
  const cudaError_t e = allow_dynamic_smem(cross_group_kernel<T, DH>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cross_group_kernel<T, DH><<<grid, DEC_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<float*>(a.out), a.n_head,
      a.n_keys, a.kv_bs, a.kv_rs, a.sc_bs, a.g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_group(const DecodeArgs& a) {
  switch (a.d_head) {
    case 32: return launch_group_dh<T, 32>(a);
    case 64: return launch_group_dh<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

enum class Entry { kSelf, kCross, kBeam, kGroup };

template <Entry E, typename T>
int launch_entry(const DecodeArgs& a) {
  if constexpr (E == Entry::kSelf) return launch_rows<T, false, false>(a);
  else if constexpr (E == Entry::kCross) return launch_rows<T, true, false>(a);
  else if constexpr (E == Entry::kBeam) return launch_rows<T, false, true>(a);
  else return launch_group<T>(a);
}

template <Entry E>
int dispatch(int dtype, const DecodeArgs& a) {
  switch (dtype) {
    case DT_I8: return launch_entry<E, int8_t>(a);
    case DT_BF16: return launch_entry<E, __nv_bfloat16>(a);
    case DT_F32: return launch_entry<E, float>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements: row (b, j) of head h starts at
// k + b * kv_bs + j * kv_rs + h * d_head; its scale at ks[b * sc_bs + j].
// ks / vs may be null (a float cache: scale 1). q and out are contiguous
// (rows, n_head * d_head) f32.
extern "C" int self_attn_decode(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, void* out,
                                int dtype, int batch, int n_head, int d_head,
                                int n_keys, long long kv_bs, long long kv_rs,
                                long long sc_bs, void* stream) {
  return dispatch<Entry::kSelf>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                        n_keys, kv_bs, kv_rs, sc_bs, nullptr, 0, 1,
                                        static_cast<cudaStream_t>(stream)});
}

extern "C" int cross_attn_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs, void* out,
                                 int dtype, int batch, int n_head, int d_head,
                                 int n_keys, long long kv_bs, long long kv_rs,
                                 long long sc_bs, void* stream) {
  return dispatch<Entry::kCross>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                         n_keys, kv_bs, kv_rs, sc_bs, nullptr, 0, 1,
                                         static_cast<cudaStream_t>(stream)});
}

// Beam rows: batch = rows (a multiple of g); key j of row r is read from
// cache row (r / g) * g + anc[r * anc_rs + j], anc int32 in [0, g).
extern "C" int self_attn_decode_beam(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs, void* out,
                                     int dtype, int batch, int n_head, int d_head,
                                     int n_keys, long long kv_bs, long long kv_rs,
                                     long long sc_bs, const void* anc,
                                     long long anc_rs, int g, void* stream) {
  return dispatch<Entry::kBeam>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                        n_keys, kv_bs, kv_rs, sc_bs, anc, anc_rs, g,
                                        static_cast<cudaStream_t>(stream)});
}

// Window groups: batch = windows of the K/V; q and out hold batch * g rows,
// rows b * g ... b * g + g - 1 reading window b.
extern "C" int cross_attn_decode_group(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, void* out,
                                       int dtype, int batch, int n_head, int d_head,
                                       int n_keys, long long kv_bs, long long kv_rs,
                                       long long sc_bs, int g, void* stream) {
  return dispatch<Entry::kGroup>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                         n_keys, kv_bs, kv_rs, sc_bs, nullptr, 0, g,
                                         static_cast<cudaStream_t>(stream)});
}
