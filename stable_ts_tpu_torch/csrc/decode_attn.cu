// Decode attention: one step's query rows against a cache.
//
// Replaces four TPU kernels of stable_ts_tpu:
//   - ops/self_attn.py:_kernel (self_attn_decode): keys j <= pos of the
//     int8 row cache of the decode step's self-attention;
//   - ops/self_attn.py:_kernel_beam (self_attn_decode with anc): the same,
//     but beam row r reads key j from the cache row of its window group that
//     anc[r, j] names (the beam loop reshuffles that table, never the cache);
//   - ops/cross_attn.py:_kernel, all its branches: g = 1 (cross_attn_decode),
//     q_per_kv = g > 1, the g beams or best_of candidates of one window
//     sharing its cross K/V (cross_attn_decode_group), and bits = 4
//     (:60-75), the cross K/V as packed int4 (dtype code DT_I4, type Int4x2).
//
// What bounds it on the card: bytes. A decode step reads each cache row
// once and does 2 multiply-adds per byte (2 g with g query rows per row),
// far below the ~295 FLOP/byte the H100 needs before compute matters. So the
// kernels read every K and V row exactly once, with 16-byte loads along d
// (the row-major (.., S, d) layout makes a head's slice of a row
// contiguous), widen int8/bf16 to f32 in registers with the per-position
// dequant scale applied to the logit and weight rows, and never write a
// dequantized copy or the logits to device memory. Softmax runs in f32.
//
// decode_attn_kernel (the self and beam entries; replaces
// stable_ts_tpu/ops/self_attn.py:68 _kernel and :132 _kernel_beam): one
// block of 8 warps per (head, batch row). A step's head slice is small (at
// pos 200 of the int8 cache, 201 keys x 64 bytes of K and of V, 26 KB), so
// what bounds it is latency, not bytes: the number of dependent rounds to
// device memory, of block barriers and of serial passes. So:
//   1. each warp owns a contiguous eighth of the keys and issues 16-byte
//      cp.async copies of their whole K and V head slices (and 4-byte copies
//      of their scales) into its own shared memory at once: one round to
//      device memory, q loading into registers meanwhile. A warp's keys come
//      in chunks of 4 KB of K (RowChunk: 64 int8 keys at d_head 64, so the
//      whole 448-key slice of a decode is in flight at once),
//      double-buffered when an eighth holds more (float caches past 128 or
//      256 keys, up to MAX_KEYS);
//   2. the beam entry first reads its chunk's ancestry (4 bytes a key) in
//      one round, then copies each key from row (r / g) * g + anc[r, j];
//   3. each warp scores its keys (16 bytes a lane, a key row over 4-16
//      lanes, reduced by shuffles), keeps a running maximum, exp sum and
//      weighted V sum, rescaled when a chunk raises the maximum, and forms
//      each weight inside the V pass: no block-wide reduction, only warp
//      barriers, and int8 widens by a byte permute and an add a value (no
//      conversion instructions), one 4-byte word at a time;
//   4. one block barrier, then the 8 warps' (max, sum, o) merge in warp
//      order: no atomics, reruns are bit-identical.
// All math is f32, as the XLA cache path computes it; the twin's single
// softmax and this per-warp one differ only in f32 rounding. The self entry
// may read its position from device memory (pos_dev), so that one captured
// CUDA graph of the greedy step replays at every position: the launch is
// then sized for the whole cache, and each warp takes its share of the
// position's keys in the kernel, the same shares and chunks as a launch
// given that position on the host, so the two give the same bits. The
// g = 1 cross entry may likewise read its K/V and scale buffers' addresses
// from device memory (bases), so the graph reads each group's new buffers.
//
// cross_cluster_kernel (both cross entries, every K/V type): the CLUSTER
// key chunks of a window's heads in one thread-block cluster, block c owning
// keys [c per, (c + 1) per), per = ceil(s / CLUSTER). What bounds it is
// bytes: a greedy group's step reads 32 windows x 2 x 1500 x 1280 bytes of
// int8 K/V a layer (123 MB, 37 us at 3.35 TB/s) for 2 multiply-adds a byte.
// Two layouts of the grid, one kernel (the WIDE template argument), chosen
// by ops/cross_attn.py:head_group from the shape alone, as the number hg of
// heads a block reads:
//   - the row layout (hg = 1; one window, g > 1 query rows a window, and
//     groups too small to stream): a block per (chunk, head, window and
//     chunk of up to GMAX of its g query rows); it copies its chunk's K and
//     V head slices (64 bytes a row at d_head 64) into shared memory at
//     once with cp.async, so a short call is one round to memory;
//   - the wide layout (hg > 1, one query row a window): a block per
//     (chunk, group of hg heads, window). Short blocks of 64-byte slices
//     came in ~8 waves at 32 windows and read 1.0 TB/s; a wide block
//     streams whole spans of hg heads of its rows (at hg = n_head the whole
//     1280-byte rows, one contiguous tile) through a ring of WIDE_STAGES
//     shared-memory stages, K then V, filled by 1D bulk copies
//     (cp.async.bulk, an mbarrier a stage) that one producer warp keeps in
//     flight while 8 consumer warps compute; the producer runs on into V
//     while the consumers exchange maxima. head_group takes the widest hg
//     whose grid still gives every SM a block: 32 windows of large-v3 give
//     256 blocks of whole rows, all resident at once (3 a SM: the ring is
//     sized for that), where a narrower hg only adds blocks and barriers
//     for the same bytes. The K/V addresses are computed in the kernel,
//     from bases read on the device in the graph's entry, so the copies are
//     1D: a tensor map is built on the host, and passed by value it would
//     freeze the capture's addresses into the step graph.
// In both layouts the chunks then:
//   1. score their keys against every query row (q rounded to bf16), the
//      products of a key row summed in order over a thread's values (16 of
//      int8 or int4: the same sums in both layouts), then across the row's
//      threads by shuffles, times the K scale;
//   2. publish their maximum per query row and head, cluster barrier;
//   3. take the global maximum m over the CLUSTER chunks through
//      distributed shared memory (exact: a max does not depend on order);
//   4. form the weights bf16(exp(s - m) vs) with the GLOBAL m, as the TPU
//      kernel and the twin round them, the chunk sum l_c = sum exp(s - m)
//      and the unnormalized o_c, publish both, cluster barrier;
//   5. sum o_c and l_c over c = 0 ... CLUSTER - 1 in that fixed order
//      through distributed shared memory and write o / l (block 0 in the
//      row layout, block c its eighth of the outputs in the wide one);
//   6. a last cluster barrier, so no block exits while its shared memory
//      is still read.
// No atomics and no scratch in device memory, one launch a call: reruns are
// bit-identical. A flash-decoding split (a maximum per chunk, rescaled in a
// second pass) would round the weights at another point than the twin.
//
// The cross entries round the query and the weights to bf16 before the two
// products, as the TPU kernel does for its MXU (cross_attn.py:107,118-120,
// 129); the self entries keep them in f32, as the XLA cache path does.
//
// Packed int4 (the cross entries only). The TPU packs dim r and r + d/2 in
// one byte (split halves, to spare a sublane shuffle); in this row-major
// (.., S, d) layout that would give each head the low or high nibbles of
// d_head bytes, so a block would read twice the bytes it uses. The port
// packs adjacent dims instead (2i low nibble, 2i + 1 high), so head h's
// slice of a row is d_head / 2 contiguous bytes and the stream is half of
// int8's. Offsets inside a row count logical values (``at``); the batch and
// row strides count bytes. The values, their scales and the bf16 rounding
// points are the TPU kernel's.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DEC_THREADS = 128;
constexpr int GMAX = 8;     // query rows per block of the cross kernel
constexpr int CLUSTER = 8;  // key chunks of one head: the largest portable cluster

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// wait until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// bytes of one head's slice of a K or V row
template <typename T, int DH>
struct Slice {
  static constexpr int BYTES = DH * static_cast<int>(sizeof(T)) / Pack<T>::V;
};

constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int ROW_THREADS = 256;   // the self and beam entries: 8 warps a (head, row)
constexpr int ROW_WARPS = ROW_THREADS / 32;

// -- the self and beam entries: each warp an eighth of the keys, in flight at once ---

// keys of one chunk buffer of a warp: 4 KB of K head slices (and 4 of V)
template <typename T, int DH>
struct RowChunk {
  static constexpr int KEYS = 4096 / Slice<T, DH>::BYTES;
};

// The 16 bytes of T at p (16-byte aligned): s + their dot product with qv,
// and acc + w times them. int8 widens exactly without a conversion
// instruction (those issue at a quarter of the FMA rate), one 4-byte word
// at a time: each byte, biased by 128, becomes the low mantissa byte of
// 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ float widen_i8(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | b)) - 8388736.f;
}

template <typename T, int VN>
__device__ __forceinline__ float dot16(const T* p, const float (&qv)[VN], float s) {
  if constexpr (sizeof(T) == 1 && Pack<T>::V == 1) {
    // four partial sums, one a word: a chain of 4 FMAs, not 16
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float part[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
      part[i] = qv[4 * i] * widen_i8(u, 0);
#pragma unroll
      for (int b = 1; b < 4; ++b) part[i] = fmaf(qv[4 * i + b], widen_i8(u, b), part[i]);
    }
    s += (part[0] + part[1]) + (part[2] + part[3]);
  } else {
    float kv[VN];
    load16(p, kv);
#pragma unroll
    for (int e = 0; e < VN; ++e) s = fmaf(qv[e], kv[e], s);
  }
  return s;
}

template <typename T, int VN>
__device__ __forceinline__ void axpy16(const T* p, float w, float (&acc)[VN]) {
  if constexpr (sizeof(T) == 1 && Pack<T>::V == 1) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = wd[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[4 * i + b] = fmaf(w, widen_i8(u, b), acc[4 * i + b]);
    }
  } else {
    float vv[VN];
    load16(p, vv);
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] = fmaf(w, vv[e], acc[e]);
  }
}

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// bytes of one chunk buffer (K, V, their scales, and the beam's source
// rows), and of a warp's region (nbuf buffers and the chunk's weights)
__host__ __device__ inline int row_buffer_bytes(int chw, int rb, bool beam) {
  return round16(chw * (2 * rb + (beam ? 12 : 8)));
}
__host__ __device__ inline int row_region_bytes(int chw, int nbuf, int rb, bool beam) {
  return round16(nbuf * row_buffer_bytes(chw, rb, beam) + chw * 4);
}

// Issue, as one cp.async group, the copies of keys [j0, j0 + cnt) of head h
// into the chunk buffer at kb (K, V, their scales, the beam's source rows):
// key j from cache row row0 (self) or row0 + anc[j] (beam). One lane a
// 16-byte piece; the beam's ancestry is read first, in one round.
template <typename T, int DH, bool BEAM>
__device__ __forceinline__ void issue_chunk(uint8_t* kb, int chw, const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs, long long kv_bs,
                                            long long kv_rs, long long sc_bs,
                                            const int* __restrict__ ancb, int row0, int h,
                                            int j0, int cnt, int lane) {
  constexpr int RB = Slice<T, DH>::BYTES;
  constexpr int PPR = RB / 16;
  uint8_t* vb = kb + chw * RB;
  float* ksb = reinterpret_cast<float*>(vb + chw * RB);
  float* vsb = ksb + chw;
  int* srcb = reinterpret_cast<int*>(vsb + chw);
  if constexpr (BEAM) {
    for (int i = lane; i < cnt; i += 32) srcb[i] = row0 + ancb[j0 + i];
    __syncwarp();
  }
  for (int i = lane; i < cnt * PPR; i += 32) {
    const int key = i / PPR;
    const long long off = static_cast<long long>(BEAM ? srcb[key] : row0) * kv_bs +
                          (j0 + key) * kv_rs;
    const int piece = (i % PPR) * 16;
    cp_async16(kb + i * 16, reinterpret_cast<const uint8_t*>(at(k + off, h * DH)) + piece);
    cp_async16(vb + i * 16, reinterpret_cast<const uint8_t*>(at(v + off, h * DH)) + piece);
  }
  if (ks != nullptr) {
    for (int i = lane; i < cnt; i += 32) {
      const long long off = static_cast<long long>(BEAM ? srcb[i] : row0) * sc_bs + j0 + i;
      cp_async4(ksb + i, ks + off);
      cp_async4(vsb + i, vs + off);
    }
  }
  cp_async_commit();
}

template <typename T, int DH, bool BEAM, bool DEV_POS>
__global__ void __launch_bounds__(ROW_THREADS)
decode_attn_kernel(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, float* __restrict__ out,
                   int n_head, int n_keys, long long kv_bs, long long kv_rs,
                   long long sc_bs, const int* __restrict__ anc,
                   long long anc_rs, int g, int chw, int nbuf,
                   const long long* __restrict__ pos_dev) {
  constexpr int RB = Slice<T, DH>::BYTES;
  constexpr int PPR = RB / 16;               // 16-byte pieces of a head's row
  constexpr int VN = Vec16<T>::N;            // values of a piece
  constexpr int CPR = DH / VN;               // lanes scoring one key row
  constexpr int KPP = 32 / CPR;              // keys a warp scores per pass
  constexpr int VV = Vec16<T>::N;            // V values a lane takes (16 bytes)
  constexpr int CPV = DH / VV;               // lanes over one V row
  constexpr int RPV = 32 / CPV;              // V rows per pass
  static_assert(DH % VN == 0 && 32 % CPR == 0 && 32 % CPV == 0 && CPR == PPR,
                "d_head must fill whole 16-byte pieces");

  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ float wm[ROW_WARPS], wl[ROW_WARPS];
  __shared__ float wo[ROW_WARPS][DH];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = n_head * DH;
  // a position read on the device (a captured graph replays at every
  // position): n_keys was the cache length, which sized chw, nbuf and the
  // shared memory; the keys are the position's
  if constexpr (DEV_POS)
    n_keys = static_cast<int>(min(max(*pos_dev + 1, 1LL), static_cast<long long>(n_keys)));
  const int per = (n_keys + ROW_WARPS - 1) / ROW_WARPS;
  const int j_begin = min(warp * per, n_keys);
  const int total = min(per, n_keys - j_begin);   // this warp's keys (may be 0)
  const int n_chunks = (total + chw - 1) / chw;
  const int buf = row_buffer_bytes(chw, RB, BEAM);
  uint8_t* region = dyn + warp * row_region_bytes(chw, nbuf, RB, BEAM);
  float* p = reinterpret_cast<float*>(region + nbuf * buf);   // the chunk's scores
  // the self entry's keys all lie in row b; the beam's in row0 + anc[b, j]
  const int row0 = BEAM ? (b / g) * g : b;
  const int* ancb = BEAM ? anc + b * anc_rs : nullptr;

  if (n_chunks > 0)
    issue_chunk<T, DH, BEAM>(region, chw, k, v, ks, vs, kv_bs, kv_rs, sc_bs, ancb, row0, h,
                             j_begin, min(chw, total), lane);
  // this lane's piece of q, while the first chunk is in flight
  float qv[VN];
  const float* qrow = q + static_cast<long long>(b) * d + h * DH + (lane % CPR) * VN;
#pragma unroll
  for (int e = 0; e < VN; ++e) qv[e] = qrow[e];

  float m_run = -INFINITY, l_run = 0.f, acc[VV];
#pragma unroll
  for (int e = 0; e < VV; ++e) acc[e] = 0.f;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = j_begin + c * chw;
    const int cnt = min(chw, total - c * chw);
    if (c + 1 < n_chunks) {
      issue_chunk<T, DH, BEAM>(region + ((c + 1) % nbuf) * buf, chw, k, v, ks, vs, kv_bs,
                               kv_rs, sc_bs, ancb, row0, h, j0 + chw,
                               min(chw, total - (c + 1) * chw), lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const uint8_t* kb = region + (c % nbuf) * buf;
    const uint8_t* vb = kb + chw * RB;
    const float* ksb = reinterpret_cast<const float*>(vb + chw * RB);
    const float* vsb = ksb + chw;

    // scores (q . k_j) * ks[j] and the chunk's maximum
    float cmax = -INFINITY;
#pragma unroll 1
    for (int r0 = 0; r0 < cnt; r0 += KPP) {
      const int i = r0 + lane / CPR;
      float s = 0.f;
      if (i < cnt)
        s = dot16(at(reinterpret_cast<const T*>(kb + i * RB), (lane % CPR) * VN), qv, s);
#pragma unroll
      for (int o = CPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
      if (i < cnt) {
        if (ks != nullptr) s *= ksb[i];
        if (lane % CPR == 0) p[i] = s;
        cmax = fmaxf(cmax, s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(FULL_MASK, cmax, o));
    const float m_new = fmaxf(m_run, cmax);
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int e = 0; e < VV; ++e) acc[e] *= alpha;
    __syncwarp();

    // the weighted sum of V rows, RPV rows a pass, CPV lanes a row; each
    // lane forms its row's weight exp(s - m) * vs[j], the row's first lane
    // adds exp(s - m) to the sum
#pragma unroll 1
    for (int r0 = 0; r0 < cnt; r0 += RPV) {
      const int i = r0 + lane / CPV;
      if (i < cnt) {
        const float e = expf(p[i] - m_new);
        if (lane % CPV == 0) l_run += e;
        const float w = ks != nullptr ? e * vsb[i] : e;
        axpy16(at(reinterpret_cast<const T*>(vb + i * RB), (lane % CPV) * VV), w, acc);
      }
    }
    __syncwarp();   // the buffer and p are refilled next
  }

  // this warp's (max, sum, o): the row groups by shuffles
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l_run += __shfl_xor_sync(FULL_MASK, l_run, o);
#pragma unroll
  for (int e = 0; e < VV; ++e) {
#pragma unroll
    for (int o = CPV; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(FULL_MASK, acc[e], o);
  }
  if (lane < CPV) {
#pragma unroll
    for (int e = 0; e < VV; ++e) wo[warp][lane * VV + e] = acc[e];
  }
  if (lane == 0) {
    wm[warp] = m_run;
    wl[warp] = l_run;
  }
  __syncthreads();

  // the warps merged in order
  if (threadIdx.x < DH) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) m = fmaxf(m, wm[w]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) {
      const float f = wm[w] == -INFINITY ? 0.f : expf(wm[w] - m);
      l += wl[w] * f;
      o += wo[w][threadIdx.x] * f;
    }
    out[static_cast<long long>(b) * d + h * DH + threadIdx.x] = o / l;
  }
}

// -- the cross entries: keys split across a thread-block cluster ---------------------

// What a block publishes to its cluster (static shared memory): per-warp
// partials, so no block-wide reduction precedes a cluster barrier.
template <int DH>
struct Published {
  float peak[GMAX][DEC_WARPS];    // each warp's maximum score per query row
  float total[GMAX][DEC_WARPS];   // each warp's sum of exp(s - m)
  float o[GMAX][DH];              // the chunk's unnormalized weighted V sum
};

// The row layout (hg = 1): a block per (key chunk c, head, window and chunk
// of up to GMAX query rows), its chunk's K and V head slices copied at once.
template <typename T, int DH>
__device__ __forceinline__ void cross_rows(const float* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs,
                                           float* __restrict__ out, int n_head, int n_keys,
                                           long long kv_bs, long long kv_rs, long long sc_bs,
                                           int g, uint8_t* dyn) {
  constexpr int RB = Slice<T, DH>::BYTES;
  // scores: 16-byte chunks (8-byte for int4, so a chunk holds 16 values as
  // int8's does and the GMAX sums beside it stay in registers), CPR lanes per
  // key row
  constexpr int KB = 16 / Pack<T>::V;
  constexpr int VN = VecB<T, KB>::N;
  constexpr int CPR = DH / VN;
  constexpr int RPP = DEC_THREADS / CPR;   // key rows per pass
  // V: 8-byte chunks (4-byte for int4), at most 8 values each, so the GMAX x 8
  // sums stay in registers; CPR8 lanes per row, GROUPS rows per pass
  constexpr int VB = 8 / Pack<T>::V;
  constexpr int V8 = VecB<T, VB>::N;
  constexpr int CPR8 = DH / V8;
  constexpr int GROUPS = DEC_THREADS / CPR8;
  static_assert(DH % VN == 0 && DH % V8 == 0 && RB % 16 == 0 && CPR8 <= 32,
                "d_head must fill whole chunks");

  // dynamic: the K chunk, the V chunk, [ng][per] scores, the K and V scales
  __shared__ float qs[GMAX][DH];
  __shared__ float wpart[DEC_WARPS][GMAX][DH];
  __shared__ float mx[GMAX];
  __shared__ Published<DH> pub;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y;
  const int chunks_g = (g + GMAX - 1) / GMAX;
  const int b = blockIdx.z / chunks_g;
  const int q0 = b * g + (blockIdx.z % chunks_g) * GMAX;   // first query row
  const int ng = min(GMAX, b * g + g - q0);                // query rows here
  const int d = n_head * DH;
  const int per = (n_keys + CLUSTER - 1) / CLUSTER;
  const int j0 = min(c * per, n_keys);
  const int n = min(per, n_keys - j0);                     // this block's keys (may be 0)

  uint8_t* kbuf = dyn;
  uint8_t* vbuf = dyn + per * RB;
  float* p = reinterpret_cast<float*>(vbuf + per * RB);
  float* ksc = p + ng * per;
  float* vsc = ksc + per;

  // 1. the chunk's K and V head slices into shared memory, K first; the
  //    query rows and the scales (1 for a float cache) load meanwhile
  const T* krow = at(k + b * kv_bs + j0 * kv_rs, h * DH);
  const T* vrow = at(v + b * kv_bs + j0 * kv_rs, h * DH);
  constexpr int PPR = RB / 16;   // 16-byte pieces per row
  for (int i = tid; i < n * PPR; i += DEC_THREADS)
    cp_async16(kbuf + i * 16,
               reinterpret_cast<const uint8_t*>(krow + (i / PPR) * kv_rs) + (i % PPR) * 16);
  cp_async_commit();
  for (int i = tid; i < n * PPR; i += DEC_THREADS)
    cp_async16(vbuf + i * 16,
               reinterpret_cast<const uint8_t*>(vrow + (i / PPR) * kv_rs) + (i % PPR) * 16);
  cp_async_commit();
  for (int i = tid; i < ng * DH; i += DEC_THREADS)
    qs[i / DH][i % DH] = round_bf16(q[(long long)(q0 + i / DH) * d + h * DH + i % DH]);
  for (int r = tid; r < n; r += DEC_THREADS) {
    ksc[r] = ks ? ks[b * sc_bs + j0 + r] : 1.f;
    vsc[r] = vs ? vs[b * sc_bs + j0 + r] : 1.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // 2. scores of every query row: CPR lanes share a key row, reduced by
  //    shuffles; each warp publishes its maximum per query row
  const int chunk = tid % CPR;
  float lmax[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) lmax[gi] = -INFINITY;
  for (int r0 = 0; r0 < n; r0 += RPP) {
    const int r = r0 + tid / CPR;
    float kv[VN];
    if (r < n) {
      load_vec<KB>(at(reinterpret_cast<const T*>(kbuf + r * RB), chunk * VN), kv);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) kv[e] = 0.f;
    }
    const float sc = r < n ? ksc[r] : 0.f;
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < ng) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e) acc = fmaf(qs[gi][chunk * VN + e], kv[e], acc);
#pragma unroll
        for (int o = CPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, o);
        if (chunk == 0 && r < n) {
          const float s = acc * sc;
          p[gi * per + r] = s;
          lmax[gi] = fmaxf(lmax[gi], s);
        }
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < ng) {
      float m = lmax[gi];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
      if (lane == 0) pub.peak[gi][warp] = m;
    }
  }
  cluster.sync();

  // 3. the global maximum of each query row over the cluster's chunks
  if (tid < ng) {
    float m = -INFINITY;
#pragma unroll
    for (int cc = 0; cc < CLUSTER; ++cc) {
      const Published<DH>* other = cluster.map_shared_rank(&pub, cc);
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) m = fmaxf(m, other->peak[tid][w]);
    }
    mx[tid] = m;
  }
  __syncthreads();

  // 4. weights rounded to bf16 after the V scale, each warp's exp sum
  float lsum[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) lsum[gi] = 0.f;
  for (int r = tid; r < n; r += DEC_THREADS) {
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < ng) {
        const float e = expf(p[gi * per + r] - mx[gi]);
        lsum[gi] += e;
        p[gi * per + r] = round_bf16(e * vsc[r]);
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < ng) {
      float l = lsum[gi];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL_MASK, l, o);
      if (lane == 0) pub.total[gi][warp] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  //    ... and the chunk's weighted sum of V rows: each row read once and
  //    added into every query row's sum
  const int c8 = tid % CPR8, grp = tid / CPR8;
  float acc[GMAX][V8];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
#pragma unroll
    for (int e = 0; e < V8; ++e) acc[gi][e] = 0.f;
  for (int r = grp; r < n; r += GROUPS) {
    float vv[V8];
    load_vec<VB>(at(reinterpret_cast<const T*>(vbuf + r * RB), c8 * V8), vv);
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi < ng) {
        const float w = p[gi * per + r];
#pragma unroll
        for (int e = 0; e < V8; ++e) acc[gi][e] = fmaf(w, vv[e], acc[gi][e]);
      }
    }
  }
  // the row groups of a warp by shuffles, then the warps in order
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < ng) {
#pragma unroll
      for (int e = 0; e < V8; ++e) {
        float a = acc[gi][e];
#pragma unroll
        for (int o = CPR8; o < 32; o <<= 1) a += __shfl_xor_sync(FULL_MASK, a, o);
        if (lane < CPR8) wpart[warp][gi][c8 * V8 + e] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * DH; i += DEC_THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) o += wpart[w][i / DH][i % DH];
    pub.o[i / DH][i % DH] = o;
  }
  cluster.sync();

  // 5. block 0 combines the chunks in order c = 0 ... CLUSTER - 1: each
  //    row's exp sum once, then every output
  if (c == 0) {
    if (tid < ng) {
      float l = 0.f;
#pragma unroll
      for (int cc = 0; cc < CLUSTER; ++cc) {
        const Published<DH>* other = cluster.map_shared_rank(&pub, cc);
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) l += other->total[tid][w];
      }
      mx[tid] = l;   // the maxima are spent: the row sums take their place
    }
    __syncthreads();
    for (int i = tid; i < ng * DH; i += DEC_THREADS) {
      const int gi = i / DH, dd = i % DH;
      float o = 0.f;
#pragma unroll
      for (int cc = 0; cc < CLUSTER; ++cc) o += cluster.map_shared_rank(&pub, cc)->o[gi][dd];
      out[(long long)(q0 + gi) * d + h * DH + dd] = o / mx[gi];
    }
  }
  // 6. no block leaves while block 0 may still read its shared memory
  cluster.sync();
}

// -- the wide layout (hg > 1): whole spans of the window's rows, streamed -----------

constexpr int WIDE_CONSUMERS = 256;                 // 8 consumer warps
constexpr int WIDE_THREADS = WIDE_CONSUMERS + 32;   // plus one producer warp
constexpr int WIDE_STAGES = 3;                      // the ring's stages
constexpr int WIDE_STAGE_BYTES = 16384;             // bytes of one stage
// blocks a SM: with this ring, large-v3's 32-window grid (32 clusters of
// 8) is one wave of resident clusters; at two a SM only 30 fit
constexpr int WIDE_BLOCKS_PER_SM = 3;
constexpr int WIDE_VALUES = 16;                     // values of a row a thread takes

// bytes of the WIDE_VALUES values of T a consumer thread takes from a row
template <typename T>
struct WideChunk {
  static constexpr int BYTES = WIDE_VALUES * static_cast<int>(sizeof(T)) / Pack<T>::V;
};

// The WIDE_VALUES values of T at p (16-byte aligned) as f32; int8 widens by
// a byte permute and an add a value, as dot16 does.
template <typename T>
__device__ __forceinline__ void load_chunk(const uint8_t* p, float (&x)[WIDE_VALUES]) {
  if constexpr (sizeof(T) == 1 && Pack<T>::V == 1) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) x[4 * i + b] = widen_i8(u, b);
    }
  } else {
    constexpr int B = WideChunk<T>::BYTES;
    constexpr int L = B < 16 ? B : 16;   // bytes of one load
#pragma unroll
    for (int i = 0; i < B / L; ++i)
      load_vec<L>(reinterpret_cast<const T*>(p + i * L), x + i * VecB<T, L>::N);
  }
}

// bytes of the wide layout's dynamic shared memory, and its parts' offsets
struct WideSmem {
  int ring, p, ksc, vsc, mx, peak, total, o, bytes;
  __host__ __device__ WideSmem(int per, int hg, int dh) {
    ring = 128;                                   // the 2 WIDE_STAGES mbarriers before it
    p = ring + WIDE_STAGES * WIDE_STAGE_BYTES;    // [hg][per] scores, then weights
    ksc = p + 4 * hg * per;
    vsc = ksc + 4 * per;
    mx = vsc + 4 * per;                           // [hg] the global maxima
    peak = mx + 4 * hg;                           // published: [hg] the chunk's maxima,
    total = peak + 4 * hg;                        //   [hg] its exp sums,
    o = total + 4 * hg;                           //   [hg * dh] its weighted V sums
    bytes = o + 4 * hg * dh;
  }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WIDE_CONSUMERS) : "memory");
}

// A block per (key chunk c, group of hg heads, window): one query row (g = 1)
// against keys [c per, (c + 1) per) of the group's heads. The producer warp
// streams the chunk's K rows, then its V rows, through the ring, each stage
// a tile of whole spans of hg * d_head values: one bulk copy a tile where the
// spans are the whole contiguous rows, else one a row. Consumer thread t
// takes the WIDE_VALUES values (t % ch) of each span, ch = hg * d_head /
// WIDE_VALUES, so its query values stay in registers, and rows t / ch, t /
// ch + rgs, ... of a tile (rgs = WIDE_CONSUMERS / ch row groups).
template <typename T, int DH>
__device__ __forceinline__ void cross_wide(const float* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs,
                                           float* __restrict__ out, int n_head, int n_keys,
                                           long long kv_bs, long long kv_rs, long long sc_bs,
                                           int hg, uint8_t* dyn) {
  constexpr int CB = WideChunk<T>::BYTES;
  constexpr int CPR = DH / WIDE_VALUES;   // threads of one head's slice of a row
  static_assert(DH % WIDE_VALUES == 0 && 32 % CPR == 0, "d_head must fill whole chunks");
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = blockIdx.y * hg;   // the group's first head
  const int b = blockIdx.z;         // the window, and its one query row
  const int d = n_head * DH;
  const int per = (n_keys + CLUSTER - 1) / CLUSTER;
  const int j0 = min(c * per, n_keys);
  const int n = min(per, n_keys - j0);          // this block's keys (may be 0)
  const int seg = hg * Slice<T, DH>::BYTES;     // bytes of the group's span of a row
  const int tile = WIDE_STAGE_BYTES / seg;      // keys of a stage
  const int ntiles = (n + tile - 1) / tile;     // tiles of K, and as many of V
  const int ch = hg * CPR;                      // consumer threads across a span
  const int rgs = WIDE_CONSUMERS / ch;          // row groups

  const WideSmem lay(per, hg, DH);
  const uint32_t bars = hop::smem_u32(dyn);     // full[WIDE_STAGES], then empty[...]
  uint8_t* ring = dyn + lay.ring;
  float* p = reinterpret_cast<float*>(dyn + lay.p);
  float* ksc = reinterpret_cast<float*>(dyn + lay.ksc);
  float* vsc = reinterpret_cast<float*>(dyn + lay.vsc);
  float* mx = reinterpret_cast<float*>(dyn + lay.mx);
  float* peak = reinterpret_cast<float*>(dyn + lay.peak);
  float* total = reinterpret_cast<float*>(dyn + lay.total);
  float* po = reinterpret_cast<float*>(dyn + lay.o);
  if (tid == 0) {
    for (int st = 0; st < WIDE_STAGES; ++st) {
      hop::mbar_init(bars + 8 * st, 1);
      hop::mbar_init(bars + 8 * (WIDE_STAGES + st), WIDE_CONSUMERS / 32);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (warp == WIDE_CONSUMERS / 32) {
    // The producer. Its arrival at the cluster's first barrier comes first,
    // so the consumers' exchange of maxima never waits on the stream, which
    // runs on into V meanwhile.
    asm volatile("barrier.cluster.arrive;" ::: "memory");
    const bool whole = seg == kv_rs * static_cast<long long>(sizeof(T));
    const uint8_t* kbase = reinterpret_cast<const uint8_t*>(
        at(k + b * kv_bs + j0 * kv_rs, h0 * DH));
    const uint8_t* vbase = reinterpret_cast<const uint8_t*>(
        at(v + b * kv_bs + j0 * kv_rs, h0 * DH));
    const long long row = kv_rs * static_cast<long long>(sizeof(T));   // bytes
    for (int i = 0; i < 2 * ntiles; ++i) {
      const int st = i % WIDE_STAGES;
      if (i >= WIDE_STAGES) hop::mbar_wait(bars + 8 * (WIDE_STAGES + st), (i / WIDE_STAGES - 1) & 1);
      const int t0 = (i % ntiles) * tile;
      const int cnt = min(tile, n - t0);
      const uint8_t* src = (i < ntiles ? kbase : vbase) + t0 * row;
      const uint32_t dst = hop::smem_u32(ring + st * WIDE_STAGE_BYTES);
      const uint32_t full = bars + 8 * st;
      if (lane == 0) hop::mbar_arrive_expect(full, cnt * seg);
      __syncwarp();
      if (whole) {
        if (lane == 0) hop::bulk_load(dst, src, cnt * seg, full);
      } else {
        for (int r = lane; r < cnt; r += 32) hop::bulk_load(dst + r * seg, src + r * row, seg, full);
      }
    }
    asm volatile("barrier.cluster.wait;" ::: "memory");
    cluster.sync();   // the consumers' second and third barriers
    cluster.sync();
    return;
  }

  // the chunk's scales, and this thread's query values rounded to bf16
  for (int r = tid; r < n; r += WIDE_CONSUMERS) {
    ksc[r] = ks ? ks[b * sc_bs + j0 + r] : 1.f;
    vsc[r] = vs ? vs[b * sc_bs + j0 + r] : 1.f;
  }
  const int col = tid % ch, rg = tid / ch;
  const bool active = rg < rgs;     // ch * rgs threads take part
  const int h = col / CPR;          // the head within the group
  float qv[WIDE_VALUES];
  {
    const float* qrow = q + static_cast<long long>(b) * d + h0 * DH + col * WIDE_VALUES;
#pragma unroll
    for (int e = 0; e < WIDE_VALUES; ++e) qv[e] = active ? round_bf16(qrow[e]) : 0.f;
  }
  consumers_sync();

  // 1. K: each (key, head) score over CPR threads, reduced by shuffles in
  //    the row layout's order, times the K scale
#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % WIDE_STAGES;
    hop::mbar_wait(bars + 8 * st, (i / WIDE_STAGES) & 1);
    const uint8_t* buf = ring + st * WIDE_STAGE_BYTES;
    const int t0 = i * tile, cnt = min(tile, n - t0);
#pragma unroll 2
    for (int r0 = 0; r0 < cnt; r0 += rgs) {
      const int r = r0 + rg;
      const bool live = active && r < cnt;
      float acc = 0.f;
      if (live) {
        float x[WIDE_VALUES];
        load_chunk<T>(buf + r * seg + col * CB, x);
#pragma unroll
        for (int e = 0; e < WIDE_VALUES; ++e) acc = fmaf(qv[e], x[e], acc);
      }
#pragma unroll
      for (int o = CPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, o);
      if (live && col % CPR == 0) p[h * per + t0 + r] = acc * ksc[t0 + r];
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(bars + 8 * (WIDE_STAGES + st));
  }
  consumers_sync();

  // 2. each head's maximum over the chunk, a warp a head, published
  for (int hh = warp; hh < hg; hh += WIDE_CONSUMERS / 32) {
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, p[hh * per + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
    if (lane == 0) peak[hh] = m;
  }
  cluster.sync();

  // 3. the global maximum of each head over the cluster's chunks (exact)
  for (int hh = tid; hh < hg; hh += WIDE_CONSUMERS) {
    float m = -INFINITY;
#pragma unroll
    for (int cc = 0; cc < CLUSTER; ++cc) m = fmaxf(m, cluster.map_shared_rank(peak, cc)[hh]);
    mx[hh] = m;
  }
  consumers_sync();

  // 4. the weights bf16(exp(s - m) vs) with the GLOBAL m, and each head's
  //    exp sum, a warp a head
  for (int hh = warp; hh < hg; hh += WIDE_CONSUMERS / 32) {
    const float m = mx[hh];
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(p[hh * per + r] - m);
      l += e;
      p[hh * per + r] = round_bf16(e * vsc[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL_MASK, l, o);
    if (lane == 0) total[hh] = l;
  }
  consumers_sync();

  // 5. V: the weighted sum of the chunk's rows, WIDE_VALUES outputs a thread
  float acc[WIDE_VALUES];
#pragma unroll
  for (int e = 0; e < WIDE_VALUES; ++e) acc[e] = 0.f;
#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const int st = (ntiles + i) % WIDE_STAGES;
    hop::mbar_wait(bars + 8 * st, ((ntiles + i) / WIDE_STAGES) & 1);
    const uint8_t* buf = ring + st * WIDE_STAGE_BYTES;
    const int t0 = i * tile, cnt = min(tile, n - t0);
    if (active) {
      for (int r = rg; r < cnt; r += rgs) {
        const float w = p[h * per + t0 + r];
        float x[WIDE_VALUES];
        load_chunk<T>(buf + r * seg + col * CB, x);
#pragma unroll
        for (int e = 0; e < WIDE_VALUES; ++e) acc[e] = fmaf(w, x[e], acc[e]);
      }
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(bars + 8 * (WIDE_STAGES + st));
  }
  // the row groups in order, through the ring (every stage is spent)
  consumers_sync();
  float* red = reinterpret_cast<float*>(ring);   // [rgs][hg * DH]
  const int span = hg * DH;
  if (active) {
#pragma unroll
    for (int e = 0; e < WIDE_VALUES; ++e) red[rg * span + col * WIDE_VALUES + e] = acc[e];
  }
  consumers_sync();
  for (int i = tid; i < span; i += WIDE_CONSUMERS) {
    float o = 0.f;
    for (int gi = 0; gi < rgs; ++gi) o += red[gi * span + i];
    po[i] = o;
  }
  cluster.sync();

  // 6. block c combines its eighth of the outputs over the chunks in order
  //    c = 0 ... CLUSTER - 1: no atomics, reruns are bit-identical
  const int share = (span + CLUSTER - 1) / CLUSTER;
  const int end = min(span, (c + 1) * share);
  for (int i = c * share + tid; i < end; i += WIDE_CONSUMERS) {
    const int hh = i / DH;
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int cc = 0; cc < CLUSTER; ++cc) {
      l += cluster.map_shared_rank(total, cc)[hh];
      o += cluster.map_shared_rank(po, cc)[i];
    }
    out[static_cast<long long>(b) * d + h0 * DH + i] = o / l;
  }
  // 7. no block leaves while another may still read its shared memory
  cluster.sync();
}

template <typename T, int DH, bool INDIRECT, bool WIDE>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
__launch_bounds__(WIDE ? WIDE_THREADS : DEC_THREADS, WIDE ? WIDE_BLOCKS_PER_SM : 1)
cross_cluster_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, float* __restrict__ out, int n_head,
                     int n_keys, long long kv_bs, long long kv_rs, long long sc_bs, int g,
                     int hg, const char* const* __restrict__ bases) {
  extern __shared__ __align__(128) uint8_t dyn[];
  // the buffers' addresses read on the device (a captured graph reads each
  // group's cross K/V): k and v are then byte offsets into bases[0], ks
  // and vs into bases[1]
  if constexpr (INDIRECT) {
    const char* kvb = bases[0];
    const char* scb = bases[1];
    k = reinterpret_cast<const T*>(kvb + reinterpret_cast<size_t>(k));
    v = reinterpret_cast<const T*>(kvb + reinterpret_cast<size_t>(v));
    ks = reinterpret_cast<const float*>(scb + reinterpret_cast<size_t>(ks));
    vs = reinterpret_cast<const float*>(scb + reinterpret_cast<size_t>(vs));
  }
  if constexpr (WIDE)
    cross_wide<T, DH>(q, k, v, ks, vs, out, n_head, n_keys, kv_bs, kv_rs, sc_bs, hg, dyn);
  else
    cross_rows<T, DH>(q, k, v, ks, vs, out, n_head, n_keys, kv_bs, kv_rs, sc_bs, g, dyn);
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
  const long long* pos_dev;   // the self entry's position on the device, or null
  const char* const* bases;   // the g = 1 cross entry's buffer addresses, or null
  int hg = 1;                 // the g = 1 cross entry's heads a block
};

template <typename T, int DH, bool BEAM, bool DEV_POS>
int launch_rows_dh(const DecodeArgs& a) {
  constexpr int RB = Slice<T, DH>::BYTES;
  constexpr int KEYS = RowChunk<T, DH>::KEYS;
  // a warp's share of the keys in one chunk, or in double-buffered chunks
  // (with pos_dev, n_keys is the cache length: the largest share it can meet)
  const int per = (a.n_keys + ROW_WARPS - 1) / ROW_WARPS;
  const int chw = per < KEYS ? per : KEYS;
  const int nbuf = per > KEYS ? 2 : 1;
  const size_t smem = static_cast<size_t>(ROW_WARPS) * row_region_bytes(chw, nbuf, RB, BEAM);
  // static (the warps' partials) plus dynamic past 48 KB needs the opt-in
  constexpr size_t static_smem = sizeof(float) * ROW_WARPS * (DH + 2);
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t e = allow_dynamic_smem(decode_attn_kernel<T, DH, BEAM, DEV_POS>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.n_head, a.batch);
  decode_attn_kernel<T, DH, BEAM, DEV_POS><<<grid, ROW_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<float*>(a.out), a.n_head, a.n_keys, a.kv_bs, a.kv_rs, a.sc_bs,
      static_cast<const int*>(a.anc), a.anc_rs, a.g, chw, nbuf, a.pos_dev);
  return static_cast<int>(cudaGetLastError());
}

// the self entry given a device position runs its own instantiation, so
// the one given an int is the kernel it was
template <typename T, int DH, bool BEAM>
int launch_rows_pos(const DecodeArgs& a) {
  if constexpr (!BEAM) {
    if (a.pos_dev != nullptr) return launch_rows_dh<T, DH, false, true>(a);
  }
  return launch_rows_dh<T, DH, BEAM, false>(a);
}

template <typename T, bool BEAM>
int launch_rows(const DecodeArgs& a) {
  switch (a.d_head) {
    case 32: return launch_rows_pos<T, 32, BEAM>(a);
    case 64: return launch_rows_pos<T, 64, BEAM>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DH, bool INDIRECT>
int launch_cross_dh(const DecodeArgs& a) {
  const int per = (a.n_keys + CLUSTER - 1) / CLUSTER;
  if (a.hg > 1) {
    // the wide layout: one query row a window, hg heads a block
    const int seg = a.hg * Slice<T, DH>::BYTES;
    if (a.g != 1 || a.n_head % a.hg || seg > WIDE_STAGE_BYTES ||
        a.hg * (DH / WIDE_VALUES) > WIDE_CONSUMERS)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = WideSmem(per, a.hg, DH).bytes;
    auto kernel = cross_cluster_kernel<T, DH, INDIRECT, true>;
    const cudaError_t e = allow_dynamic_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(CLUSTER, a.n_head / a.hg, a.batch);
    kernel<<<grid, WIDE_THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<float*>(a.out), a.n_head,
        a.n_keys, a.kv_bs, a.kv_rs, a.sc_bs, 1, a.hg, a.bases);
    return static_cast<int>(cudaGetLastError());
  }
  const int ng = a.g < GMAX ? a.g : GMAX;
  // the K and V chunks, ng rows of scores, the K and V scales
  const size_t smem =
      static_cast<size_t>(per) * (2 * Slice<T, DH>::BYTES + (ng + 2) * sizeof(float));
  const cudaError_t e = allow_dynamic_smem(cross_cluster_kernel<T, DH, INDIRECT, false>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // grid x is the cluster: CLUSTER key chunks of one head
  const dim3 grid(CLUSTER, a.n_head, a.batch * ((a.g + GMAX - 1) / GMAX));
  cross_cluster_kernel<T, DH, INDIRECT, false><<<grid, DEC_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<float*>(a.out), a.n_head,
      a.n_keys, a.kv_bs, a.kv_rs, a.sc_bs, a.g, 1, a.bases);
  return static_cast<int>(cudaGetLastError());
}

// likewise the cross entry given its buffers' addresses on the device
template <typename T, int DH>
int launch_cross_bases(const DecodeArgs& a) {
  return a.bases != nullptr ? launch_cross_dh<T, DH, true>(a)
                            : launch_cross_dh<T, DH, false>(a);
}

template <typename T>
int launch_cross(const DecodeArgs& a) {
  switch (a.d_head) {
    case 32: return launch_cross_bases<T, 32>(a);
    case 64: return launch_cross_bases<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

enum class Entry { kSelf, kBeam, kCross };

template <Entry E, typename T>
int launch_entry(const DecodeArgs& a) {
  if constexpr (E == Entry::kSelf) return launch_rows<T, false>(a);
  else if constexpr (E == Entry::kBeam) return launch_rows<T, true>(a);
  else return launch_cross<T>(a);
}

template <Entry E>
int dispatch(int dtype, const DecodeArgs& a) {
  switch (dtype) {
    case DT_I4:  // packed int4: the cross entries only
      if constexpr (E == Entry::kCross)
        return launch_entry<E, Int4x2>(a);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    case DT_I8: return launch_entry<E, int8_t>(a);
    case DT_BF16: return launch_entry<E, __nv_bfloat16>(a);
    case DT_F32: return launch_entry<E, float>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in storage elements (bytes for int8 and packed int4): row
// (b, j) of head h starts h * d_head values after k + b * kv_bs + j * kv_rs;
// its scale is ks[b * sc_bs + j]. dtype DT_I4 (packed int4) is taken by the
// two cross entries only.
// ks / vs may be null (a float cache: scale 1). q and out are contiguous
// (rows, n_head * d_head) f32. The self entry's pos_dev, when not null, is
// an int64 position in device memory: the kernel attends its pos + 1 keys
// (at most n_keys, which is then the cache length that sizes the launch).
extern "C" int self_attn_decode(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, void* out,
                                int dtype, int batch, int n_head, int d_head,
                                int n_keys, long long kv_bs, long long kv_rs,
                                long long sc_bs, const void* pos_dev, void* stream) {
  return dispatch<Entry::kSelf>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                        n_keys, kv_bs, kv_rs, sc_bs, nullptr, 0, 1,
                                        static_cast<cudaStream_t>(stream),
                                        static_cast<const long long*>(pos_dev)});
}

// The g = 1 cross entry reads hg heads a block (a divisor of n_head; 1: the
// row layout). Its bases, when not null, is a device array of two
// addresses, the K/V buffer's and the scales': k and v are then byte
// offsets into the first, ks and vs into the second.
extern "C" int cross_attn_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs, void* out,
                                 int dtype, int batch, int n_head, int d_head,
                                 int n_keys, long long kv_bs, long long kv_rs,
                                 long long sc_bs, int hg, const void* bases, void* stream) {
  return dispatch<Entry::kCross>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                         n_keys, kv_bs, kv_rs, sc_bs, nullptr, 0, 1,
                                         static_cast<cudaStream_t>(stream), nullptr,
                                         static_cast<const char* const*>(bases), hg});
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
  return dispatch<Entry::kCross>(dtype, {q, k, v, ks, vs, out, batch, n_head, d_head,
                                         n_keys, kv_bs, kv_rs, sc_bs, nullptr, 0, g,
                                         static_cast<cudaStream_t>(stream)});
}
