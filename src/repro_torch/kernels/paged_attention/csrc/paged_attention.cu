// Paged decode attention for NVIDIA Hopper (sm_90a), in CUDA C++:
// split-KV decoding with a fixed-order merge.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py:paged_decode_attention
//   (its pl.pallas_call at kernel.py:134).
//
// What it computes: one new query token per sequence attends to the K/V
// entries of its own sequence, read through an int32 block table.  For
// sequence b and query head h = kh * G + g (G = H / K query heads share kv
// head kh):
//   s_t   = softcap(scale * q[b, h] . k_t),   scale = hd^-0.5
//   o[b,h] = sum_t softmax(s)_t v_t,  t in [lo, pos[b]]
// with k_t = kp[bt[b, t / bs], t % bs, kh] (v likewise) and
// lo = pos - window + 1 inside a sliding window (0 otherwise).  The softmax
// is fp32 and its denominator is clamped at 1e-30, as in the TPU kernel.
//
// What bounds it on this card: bytes.  A sequence reads (pos+1)*K*hd K and
// V elements and does about 4 flops per element read, far under the ~295
// flop/byte ridge of an H100 in bf16, so the products stay fp32 FMAs on the
// CUDA cores.  At a serving batch the bytes are few (0.84 us of HBM time at
// gemma-2b's decode shape), and what costs is latency: a grid too small to
// fill the SMs, and dependent trips to cold HBM.  At long contexts the
// pool's scattered blocks (8 KB at gemma-2b's block size) and, at G = 8,
// the fp32 score arithmetic keep it under the byte rate (PERF.md).
//
// Design: the positions of a sequence are cut into splits of split_len
// positions; a block of 8 warps works one (sequence, kv head, split), so
// the grid is (B * K) x n_split blocks.
//  * The wrapper (ops.py:split_plan) picks split_len from the shapes alone
//    (the table's width, B * K, the SM count), never from pos, which would
//    make the host wait on the card every step: at most one wave of blocks,
//    at least one pool block and 32 positions a split (64 from a table of
//    2,048 positions on), at most kMaxSplitLen.  A split wholly past the
//    frontier or wholly before the window exits at once.
//  * The split's block ids and q load beside pos.  Warp w takes the split's
//    rows w, w + 8, ...; each lane copies its own hd/32 slice of each row
//    with cp.async (4 to 32 bytes, as aligned as ops._check guarantees)
//    into a private ring of kLaneRingBytes in shared memory, K rows then V
//    rows, so a block starts with 4 KB of K and V in flight per warp and
//    holds no register for a load in flight.  A lane reads back only what
//    it copied, so the ring needs no barrier.
//  * Scores, two rows at a time: each lane dots its slice with the G query
//    rows (fp32 FMAs), a butterfly reduce-scatter across the warp leaves
//    head lane / (32/G) with its full sum, and the split's G x n scores go
//    to shared memory.  Then one max and one sum per head over the split
//    (no per-position online update), and P.V with each lane owning its hd
//    slice for all G heads; the 8 warps' sums are added in a fixed tree.
//  * Each live split of a multi-split row writes (m, l, acc[G][hd]) in fp32
//    to scratch that the wrapper allocates.  The last block of each group
//    of kGroup live splits to finish (an atomic ticket after
//    __threadfence, reset to 0 by that block) merges the group in split
//    order: the common max, then l and acc rescaled by exp(m - max) and
//    summed (where the output has fewer float4s than the block threads,
//    runs of splits are summed apart and the runs added in order).  One
//    group writes acc / max(l, 1e-30); more write a partial each, and the
//    last group to finish merges those likewise.  The same inputs give the
//    same bits on every call.  A row with one live split writes its output
//    directly, bitwise what the merge would give.
//  * Inactive rows (the whole table at scratch block 0, pos = 0) read one
//    entry and their output is discarded by the caller; a block id outside
//    the pool reads the scratch block, where the JAX gather would clamp.
// One launch a call; ops.paged_attention counts it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;              // query heads per kv head
constexpr int kMaxSplitLen = 512;     // positions a split holds (score buffer)
constexpr int kHeader = 16;           // floats before a partial's acc: m[8], l[8]
constexpr int kGroup = 16;            // live splits merged together first
constexpr int kMaxMerge = 256;        // partials one merge takes: groups too
constexpr int kMergeScratch = 2 * kMaxMerge * kMaxG + 2 * kMaxG + 4 * kThreads;
constexpr int kLaneRingBytes = 128;   // K/V bytes a lane keeps in flight
constexpr float kNegInf = -2.0e38f;

struct bf16_t {
  uint16_t bits;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_t x) {
  return __uint_as_float(uint32_t(x.bits) << 16);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16_t* p, float x) {
  p->bits = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Shared-memory layout and ring depth of one instantiation.
template <typename T, int HD, int GP>
struct Plan {
  static constexpr int HDIM = HD;
  static constexpr int EPL = HD / 32;                       // elements a lane owns
  static constexpr int CHL = EPL * int(sizeof(T));          // bytes a lane copies a row
  static constexpr int PIECE = CHL < 16 ? CHL : 16;         // one cp.async
  static constexpr int NP = CHL / PIECE;
  static constexpr int DEPTH = kLaneRingBytes / CHL;        // rows in flight a lane
  static constexpr int RING = DEPTH * CHL * kThreads;
  static constexpr int RED = 4 * GP * HD * 4;               // the warps' sum tree
  static constexpr int RING_BYTES = RING > RED ? RING : RED;
  static constexpr int SCORES = kMaxSplitLen * GP * 4;      // also stages q
  static constexpr int BASES = (kMaxSplitLen + 2) * 16;    // K, V offsets a column
  static constexpr int SMEM = RING_BYTES + SCORES + BASES;
  static constexpr int PSTRIDE = kHeader + GP * HD;         // floats a partial
  static_assert(DEPTH >= 4 && (DEPTH & (DEPTH - 1)) == 0, "ring depth");
  static_assert(HD <= kMaxSplitLen, "q is staged in the score buffer");
  static_assert(kMergeScratch * 4 <= RING_BYTES, "the merge's scratch is the ring");
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The EPL elements of one row slice in a lane's ring slot -> fp32.  The
// slot is NP pieces of PIECE bytes, kThreads * PIECE bytes apart.
template <typename T, int EPL, int PIECE, int NP>
__device__ __forceinline__ void slot_floats(const unsigned char* p,
                                            float (&out)[EPL]) {
  constexpr int kWords = EPL * int(sizeof(T)) / 4;
  uint32_t w[kWords];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const unsigned char* src = p + i * kThreads * PIECE;
    if constexpr (PIECE == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(src);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    } else if constexpr (PIECE == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(src);
    }
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) out[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {  // little-endian: low half first
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// v[g] holds a lane's partial dot product for head g.  Each of the first
// log2(GP) butterfly steps keeps half of the heads (the upper half where
// the lane's bit of the step is set) and adds the partner's copy of them;
// the last steps add the one value left.  Returns the whole warp's sum for
// head lane / (32 / GP).  The order of the adds is fixed.
template <int GP>
__device__ __forceinline__ float reduce_scatter(float (&v)[GP], int lane) {
  int off = 16;
#pragma unroll
  for (int c = GP; c > 1; c >>= 1, off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < c / 2; ++i) {
      const float keep = upper ? v[i + c / 2] : v[i];
      const float send = upper ? v[i] : v[i + c / 2];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// acc (float4 f of the output) of the partials [s0, s1) of one (b, kh),
// each scaled by its weight w[(s - s0) * GP + g] and added in index
// order; a batch of partials loads together so their trips to L2 overlap.
template <typename P, int GP, int NF>
__device__ __forceinline__ void merge_run(const float* base, const int (&f)[NF],
                                          int s0, int s1, int r0, const float* w,
                                          float4 (&a)[NF]) {
  constexpr int kBatch = NF == 2 ? 4 : 8;
  int g[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    g[i] = 4 * f[i] / P::HDIM;
    a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s = r0; s < s1; s += kBatch) {
    float4 xb[kBatch][NF];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s + u < s1)
#pragma unroll
        for (int i = 0; i < NF; ++i)
          xb[u][i] = __ldcg(reinterpret_cast<const float4*>(
                                base + (long long)(s + u) * P::PSTRIDE + kHeader) + f[i]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s + u < s1)
#pragma unroll
        for (int i = 0; i < NF; ++i) {
          const float wt = w[(s + u - s0) * GP + g[i]];
          a[i].x += wt * xb[u][i].x;
          a[i].y += wt * xb[u][i].y;
          a[i].z += wt * xb[u][i].z;
          a[i].w += wt * xb[u][i].w;
        }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 a, float den) {
  store(dst, a.x / den);
  store(dst + 1, a.y / den);
  store(dst + 2, a.z / den);
  store(dst + 3, a.w / den);
}

// One float4 f of a merge's result: acc / max(l, 1e-30) into out, or, where
// out is null, acc into the partial at pout.
template <typename T>
__device__ __forceinline__ void emit(T* out, float* pout, int f, float l, float4 a) {
  if (out != nullptr)
    store4(out + 4 * f, a, fmaxf(l, 1e-30f));
  else
    reinterpret_cast<float4*>(pout + kHeader)[f] = a;
}

// Merges the partials [s0, s1) of one (b, kh) (at base, PSTRIDE floats
// apart; at most kMaxMerge): the common max of each head, then l and acc
// rescaled by exp(m - max) and summed in index order.  Where the result
// has fewer float4s F than the block has threads, kThreads / F groups of
// threads each add a contiguous run of partials and the runs' sums are
// added in run order.  Writes acc / max(l, 1e-30) to out, or, where out is
// null, one more partial (max, l, acc) at pout.  Every thread of the block
// calls it; sm is kMergeScratch floats of shared memory.
template <typename T, typename P, int GP>
__device__ __forceinline__ void merge(const float* base, int s0, int s1, int G,
                                      float* sm, T* out, float* pout) {
  const int tid = threadIdx.x;
  const int n = s1 - s0;
  float* w = sm;                                  // [n][GP]: m, then weights
  float* ls = sm + kMaxMerge * GP;                // [n][GP]: l
  float* mx = sm + 2 * kMaxMerge * kMaxG;         // [GP]: the common max
  float* den = mx + kMaxG;                        // [GP]: the summed l
  for (int i = tid; i < n * GP; i += kThreads) {
    const float* ps = base + (long long)(s0 + i / GP) * P::PSTRIDE;
    w[i] = i % GP < G ? __ldcg(ps + i % GP) : 0.f;
    ls[i] = i % GP < G ? __ldcg(ps + kMaxG + i % GP) : 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int i = 0; i < n; ++i) m = fmaxf(m, w[i * GP + tid]);
    mx[tid] = m;
  }
  __syncthreads();
  for (int i = tid; i < n * GP; i += kThreads) w[i] = expf(w[i] - mx[i % GP]);
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
    for (int i = 0; i < n; ++i) l += w[i * GP + tid] * ls[i * GP + tid];
    den[tid] = l;
    if (out == nullptr) {
      pout[tid] = mx[tid];
      pout[kMaxG + tid] = l;
    }
  }
  __syncthreads();
  const int F = G * P::HDIM / 4;
  if (F > kThreads) {   // two float4s a thread, loaded in the same batches
    if constexpr (GP * P::HDIM / 4 > kThreads) {
      const int f[2] = {tid, min(tid + kThreads, F - 1)};
      float4 a[2];
      merge_run<P, GP, 2>(base, f, s0, s1, s0, w, a);
      emit(out, pout, f[0], den[4 * f[0] / P::HDIM], a[0]);
      if (tid + kThreads < F) emit(out, pout, f[1], den[4 * f[1] / P::HDIM], a[1]);
    }
  } else {
    const int runs = kThreads / F;
    const int per = (n + runs - 1) / runs;
    float4* ra = reinterpret_cast<float4*>(sm + 2 * kMaxMerge * kMaxG + 2 * kMaxG);
    if (tid < runs * F) {
      const int r0 = s0 + (tid / F) * per;
      const int f[1] = {tid % F};
      float4 a[1];
      merge_run<P, GP, 1>(base, f, s0, min(s1, r0 + per), r0, w, a);
      ra[tid] = a[0];
    }
    __syncthreads();
    if (tid < F) {
      float4 a = ra[tid];
      for (int k = 1; k < runs; ++k) {
        const float4 x = ra[k * F + tid];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      emit(out, pout, tid, den[4 * tid / P::HDIM], a);
    }
  }
  __syncthreads();
}

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(kThreads, GP <= 2 ? 3 : 2)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ pos, T* __restrict__ o,
                   float* __restrict__ part, int* __restrict__ tickets, int H,
                   int K, int bs, int bs_shift, int nbmax, int n_blocks,
                   long long ks_blk, long long ks_off, long long ks_head,
                   long long vs_blk, long long vs_off, long long vs_head,
                   int window, float softcap, float scale, int split_len,
                   int n_split) {
  using P = Plan<T, HD, GP>;
  constexpr int EPL = P::EPL;
  constexpr int DEPTH = P::DEPTH;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* s_sm = reinterpret_cast<float*>(smem + P::RING_BYTES);   // [n][GP]
  // element offsets of the split's pool blocks for this kv head, K and V
  long long* bases = reinterpret_cast<long long*>(smem + P::RING_BYTES + P::SCORES);
  __shared__ float m_s[GP], l_s[GP];
  __shared__ int merge_s;

  const int bk = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bk / K;
  const int kh = bk - b * K;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the split's block ids and q do not depend on pos: load them beside it
  auto column = [&](int t) { return bs_shift >= 0 ? t >> bs_shift : t / bs; };
  const int col0 = column(split * split_len);
  const int col1 = min(column(split * split_len + split_len - 1), nbmax - 1);
  const int* __restrict__ btb = bt + (long long)b * nbmax;
  const long long row0 = ((long long)b * H + (long long)kh * G) * HD;
  constexpr int kIds = (kMaxSplitLen + kThreads) / kThreads;   // columns a thread
  constexpr int kQ = (GP * HD + kThreads - 1) / kThreads;      // q elements a thread
  int idr[kIds];
  float qv[kQ];
#pragma unroll
  for (int k = 0; k < kIds; ++k)
    idr[k] = col0 + tid + k * kThreads <= col1 ? btb[col0 + tid + k * kThreads] : 0;
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    qv[k] = tid + k * kThreads < G * HD ? to_f32(q[row0 + tid + k * kThreads]) : 0.f;

  const int p = pos[b];
  const int t_hi = min(p, nbmax * bs - 1);
  const int t_lo = window > 0 ? max(0, p - window + 1) : 0;
  const int lo = max(split * split_len, t_lo);
  const int hi = min(split * split_len + split_len - 1, t_hi);
  if (lo > hi) {
    if (t_lo > t_hi && split == 0)   // no position at all: zeros
      for (int i = tid; i < G * HD; i += kThreads) store(o + row0 + i, 0.f);
    return;
  }
  const int first = t_lo / split_len;
  const int n_live = t_hi / split_len - first + 1;
  const int n = hi - lo + 1;

  // stage q (pre-scaled, as the plain version scales it) and the offsets
  // of the split's pool blocks for this kv head
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    if (tid + k * kThreads < G * HD) s_sm[tid + k * kThreads] = qv[k] * scale;
#pragma unroll
  for (int k = 0; k < kIds; ++k) {
    const int c = tid + k * kThreads;
    if (col0 + c <= col1) {
      const int id = (idr[k] >= 0 && idr[k] < n_blocks) ? idr[k] : 0;
      bases[2 * c] = id * ks_blk + kh * ks_head;
      bases[2 * c + 1] = id * vs_blk + kh * vs_head;
    }
  }
  __syncthreads();
  float qr[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = g < G ? s_sm[g * HD + lane * EPL + e] : 0.f;

  // job j < nw copies K row warp + 8j of the split, job nw + j its V row
  const int nw = n > warp ? (n - 1 - warp) / kWarps + 1 : 0;
  auto issue = [&](int j) {
    if (j < 2 * nw) {
      const bool is_k = j < nw;
      const int t = lo + warp + kWarps * (is_k ? j : j - nw);
      const int col = column(t);
      const long long off = t - col * bs;
      const T* src = (is_k ? kp + off * ks_off : vp + off * vs_off) +
                     bases[2 * (col - col0) + (is_k ? 0 : 1)] + lane * EPL;
      unsigned char* dst = ring + ((j % DEPTH) * P::NP * kThreads + tid) * P::PIECE;
#pragma unroll
      for (int i = 0; i < P::NP; ++i)
        cp_async<P::PIECE>(dst + i * kThreads * P::PIECE,
                           reinterpret_cast<const unsigned char*>(src) + i * P::PIECE);
    }
    cp_async_commit();   // one group a job, empty past the end
  };
  auto slot = [&](int j) {
    return ring + ((j % DEPTH) * P::NP * kThreads + tid) * P::PIECE;
  };
#pragma unroll
  for (int j = 0; j < DEPTH; ++j) issue(j);
  __syncthreads();   // every lane holds its q slice: scores may overwrite it

  // scores of the split's rows, each a whole warp's reduction, two rows
  // at a time; s_sm holds them head-major, [GP][kMaxSplitLen]
  const int hg = lane / (32 / GP);
  const bool writer = (lane & (32 / GP - 1)) == 0 && hg < G;
  for (int j = 0; j < nw; j += 2) {
    const bool two = j + 1 < nw;       // else job j + 1 is V row 0: read, unused
    cp_async_wait<DEPTH - 2>();
    float k0[EPL], k1[EPL];
    slot_floats<T, EPL, P::PIECE, P::NP>(slot(j), k0);
    slot_floats<T, EPL, P::PIECE, P::NP>(slot(j + 1), k1);
    float d0[GP], d1[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      d0[g] = 0.f;
      d1[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        d0[g] = fmaf(qr[g][e], k0[e], d0[g]);
        d1[g] = fmaf(qr[g][e], k1[e], d1[g]);
      }
    }
    float s0 = reduce_scatter<GP>(d0, lane);
    float s1 = reduce_scatter<GP>(d1, lane);
    if (softcap > 0.f) {
      s0 = softcap * tanhf(s0 / softcap);
      s1 = softcap * tanhf(s1 / softcap);
    }
    const int r = warp + kWarps * j;
    if (writer) {
      s_sm[hg * kMaxSplitLen + r] = s0;
      if (two) s_sm[hg * kMaxSplitLen + r + kWarps] = s1;
    }
    issue(j + DEPTH);
    if (two)
      issue(j + 1 + DEPTH);
    else
      cp_async_commit();               // V row 0's slot is still to be read
  }
  __syncthreads();

  // one max and one sum per head over the split; the scores become p
  for (int g = warp; g < G; g += kWarps) {
    float* sg = s_sm + g * kMaxSplitLen;
    float m = kNegInf;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, sg[r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(sg[r] - m);
      sg[r] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  __syncthreads();

  // P.V: each lane sums its hd slice for all heads over the warp's rows,
  // two rows at a time
  float acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  for (int j = nw; j < 2 * nw; j += 2) {
    const bool two = j + 1 < 2 * nw;
    cp_async_wait<DEPTH - 2>();
    float v0[EPL], v1[EPL];
    slot_floats<T, EPL, P::PIECE, P::NP>(slot(j), v0);
    slot_floats<T, EPL, P::PIECE, P::NP>(slot(j + 1), v1);
    if (!two)                          // the slot may never have been written
#pragma unroll
      for (int e = 0; e < EPL; ++e) v1[e] = 0.f;
    const int r = warp + kWarps * (j - nw);
    float p0[GP], p1[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      p0[g] = g < G ? s_sm[g * kMaxSplitLen + r] : 0.f;
      p1[g] = g < G && two ? s_sm[g * kMaxSplitLen + r + kWarps] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = fmaf(p1[g], v1[e], fmaf(p0[g], v0[e], acc[g][e]));
    issue(j + DEPTH);
    issue(j + 1 + DEPTH);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums in a fixed tree: 4+4, 2+2, 1+1, into warp 0, through
  // shared memory in vectors of V floats laid out lane-minor
  constexpr int V = EPL >= 4 ? 4 : 2;
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
      float* dst = red + (warp - half) * GP * HD;
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int c = 0; c < EPL / V; ++c)
          store_vec<V>(dst + ((g * (EPL / V) + c) * 32 + lane) * V, &acc[g][c * V]);
    }
    __syncthreads();
    if (warp < half) {
      const float* src = red + warp * GP * HD;
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int c = 0; c < EPL / V; ++c) {
          float x[V];
          load_vec<V>(src + ((g * (EPL / V) + c) * 32 + lane) * V, x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][c * V + e] += x[e];
        }
    }
    __syncthreads();
  }

  if (n_live == 1) {   // the merge of one split: acc / max(l, 1e-30)
    if (warp == 0) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g >= G) break;
        const float den = fmaxf(l_s[g], 1e-30f);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          store(o + row0 + g * HD + lane * EPL + e, acc[g][e] / den);
      }
    }
    return;
  }

  // the partial of this split; then the last block of its group of
  // kGroup live splits merges the group, and the last group to finish
  // merges the groups (one group: straight into the output)
  const int n_gmax = (n_split + kGroup - 1) / kGroup;
  float* base = part + (long long)bk * (n_split + n_gmax) * P::PSTRIDE;
  int* tk = tickets + bk * (1 + n_gmax);
  if (warp == 0) {
    float* mine = base + (long long)split * P::PSTRIDE;
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < EPL; ++e) mine[kHeader + g * HD + lane * EPL + e] = acc[g][e];
    }
    if (lane < G) {
      mine[lane] = m_s[lane];
      mine[kMaxG + lane] = l_s[lane];
    }
    __threadfence();
  }
  __syncthreads();
  const int grp = (split - first) / kGroup;
  const int g0 = first + grp * kGroup;
  const int g1 = min(first + n_live, g0 + kGroup);
  const int n_groups = (n_live + kGroup - 1) / kGroup;
  if (tid == 0)
    merge_s = g1 - g0 == 1 || atomicAdd(tk + 1 + grp, 1) == g1 - g0 - 1;
  __syncthreads();
  if (!merge_s) return;
  __threadfence();
  float* sm = reinterpret_cast<float*>(ring);
  int s0 = g0, s1 = g1;
  for (bool groups_done = false;; groups_done = true) {   // one call site
    const bool last = groups_done || n_groups == 1;
    merge<T, P, GP>(base, s0, s1, G, sm, last ? o + row0 : static_cast<T*>(nullptr),
                    base + (long long)(n_split + grp) * P::PSTRIDE);
    if (tid == 0) tk[groups_done ? 0 : 1 + grp] = 0;   // ready for the next call
    if (last) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) merge_s = atomicAdd(tk, 1) == n_groups - 1;
    __syncthreads();
    if (!merge_s) return;
    __threadfence();
    s0 = n_split;
    s1 = n_split + n_groups;
  }
}

template <typename T, int HD, int GP>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* pos, void* o, float* part, int* tickets, int B, int H,
           int K, int bs, int nbmax, int n_blocks, long long ks_blk,
           long long ks_off, long long ks_head, long long vs_blk,
           long long vs_off, long long vs_head, int window, float softcap,
           float scale, int split_len, int n_split, cudaStream_t stream) {
  using P = Plan<T, HD, GP>;
  auto kernel = paged_split_kernel<T, HD, GP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bs_shift = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;
  kernel<<<dim3(B * K, n_split), kThreads, P::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), part, tickets, H,
      K, bs, bs_shift, nbmax, n_blocks, ks_blk, ks_off, ks_head, vs_blk,
      vs_off, vs_head, window, softcap, scale, split_len, n_split);
  return static_cast<int>(cudaGetLastError());
}

#define PAGED_ARGS                                                           \
  q, kp, vp, bt, pos, o, part, tickets, B, H, K, bs, nbmax, n_blocks, ks_blk, \
      ks_off, ks_head, vs_blk, vs_off, vs_head, window, softcap, scale,      \
      split_len, n_split, stream

template <typename T, int HD>
int launch_g(int gp, const void* q, const void* kp, const void* vp,
             const int* bt, const int* pos, void* o, float* part, int* tickets,
             int B, int H, int K, int bs, int nbmax, int n_blocks,
             long long ks_blk, long long ks_off, long long ks_head,
             long long vs_blk, long long vs_off, long long vs_head, int window,
             float softcap, float scale, int split_len, int n_split,
             cudaStream_t stream) {
  switch (gp) {
    case 1: return launch<T, HD, 1>(PAGED_ARGS);
    case 2: return launch<T, HD, 2>(PAGED_ARGS);
    case 4: return launch<T, HD, 4>(PAGED_ARGS);
    case 8: return launch<T, HD, 8>(PAGED_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_hd(int hd, int gp, const void* q, const void* kp, const void* vp,
              const int* bt, const int* pos, void* o, float* part,
              int* tickets, int B, int H, int K, int bs, int nbmax,
              int n_blocks, long long ks_blk, long long ks_off,
              long long ks_head, long long vs_blk, long long vs_off,
              long long vs_head, int window, float softcap, float scale,
              int split_len, int n_split, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_g<T, 64>(gp, PAGED_ARGS);
    case 128: return launch_g<T, 128>(gp, PAGED_ARGS);
    case 256: return launch_g<T, 256>(gp, PAGED_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and o share it).  With
// n_groups = ceil(n_split / kGroup), part holds (B * K) x (n_split +
// n_groups) partials of kHeader + gp * hd floats (unused when n_split is
// 1), and tickets holds (B * K) x (1 + n_groups) zeros, which the kernel
// leaves zeroed.  gp is the power of two at or above G = H / K.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, void* o, float* part, int* tickets, int B, int H, int K,
    int hd, int bs, int nbmax, int n_blocks, long long ks_blk,
    long long ks_off, long long ks_head, long long vs_blk, long long vs_off,
    long long vs_head, int window, float softcap, float scale, int split_len,
    int n_split, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > kMaxG || bs <= 0 ||
      split_len <= 0 || split_len > kMaxSplitLen || n_split <= 0 ||
      n_split > kGroup * kMaxMerge ||
      (long long)split_len * n_split < (long long)nbmax * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  const int gp = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, gp, q, kp, vp, bt, pos, o, part, tickets, B,
                            H, K, bs, nbmax, n_blocks, ks_blk, ks_off, ks_head,
                            vs_blk, vs_off, vs_head, window, softcap, scale,
                            split_len, n_split, s);
  if (dtype == 1)
    return launch_hd<bf16_t>(hd, gp, q, kp, vp, bt, pos, o, part, tickets, B,
                             H, K, bs, nbmax, n_blocks, ks_blk, ks_off,
                             ks_head, vs_blk, vs_off, vs_head, window, softcap,
                             scale, split_len, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The number of SMs of a device (cudaDevAttrMultiProcessorCount), or -1.
extern "C" int paged_sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return n;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
