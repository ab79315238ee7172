// Forward flash attention for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:83
// flash_attention (pl.pallas_call at :108).  For batch b, query head h and
// kv head kh = h / (H / K) (GQA: K/V are read through kh, never copied per
// query head):
//   s[i, j] = softcap(scale * q[b, i, h] . k[b, j, kh]),   scale = hd^-0.5
//   o[b, i, h] = sum_j softmax_j(s[i, :] masked) v[b, j, kh]
// masked: j <= i (causal), j > i - window (window > 0), set to -2e38.  As
// in the TPU kernel: softcap is softcap * tanh(s / softcap), the running
// max starts at -2e38, the online softmax rescales by alpha = exp(m_prev -
// m_new), the denominator is clamped at 1e-30, and KV tiles wholly above
// the causal frontier or wholly before the window are skipped.  Scores,
// softmax and the accumulator are fp32, the output in q's type.  Two
// kernels, one per input type:
//
// fp32 (flash_fwd_kernel): the TPU kernel's fp32 arithmetic on CUDA cores
// (67 TFLOP/s).  Bound by operations: 4 * hd flops per (query, key) pair
// for 2 * hd * 4 bytes of K/V read once per tile.  One block of 256
// threads (16 x 16) per (batch, query head, tile of 64 queries), a loop
// over the tiles of 64 keys that can contribute.  The scaled Q tile (q *
// scale rounded to fp32, as the TPU kernel does), the K tile and then the
// V tile (in one buffer) and the probability tile live in dynamic shared
// memory, rows padded by 4 floats so that the 16-byte reads of a
// quarter-warp hit distinct banks.  Each thread computes a 4 x 4 block of
// scores (columns tx + 16 j) and owns 4 output rows x hd/16 columns of the
// accumulator in registers.  One warp per row runs the online softmax.
//
// bf16 (flash_bf16_kernel): both products on the tensor cores, wgmma
// m64nNk16 with bf16 inputs and fp32 sums.  Bound by bytes at gemma-2b
// prefill's shape, by operations over a long window (989 TFLOP/s).
//  * Block: two warpgroups of 64 query rows each; the block's 128 queries
//    share every K/V tile.  Query tiles are launched longest first, so
//    under a causal mask the tail of the grid is short tiles.
//  * Data movement: TMA (4-d tensor maps over Q, K and V, boxes of 64
//    head-dim columns x 64 queries or the key tile, positions past S
//    filled with zeros).  K and V go into a ring of two stages, each
//    with an mbarrier that counts the copy's bytes in.  One thread
//    issues a tile's copies: the first two at the start, then tile t + 2
//    from the last of the block's 8 warps to be done with tile t (a
//    count in shared memory), so tile t + 1 lands while tile t is
//    multiplied, no thread stalls on a copy, and no block-wide barrier
//    holds the two warpgroups in step.
//  * Shared memory holds bf16 in wgmma's 128-byte-swizzle layout, the one
//    TMA's SWIZZLE_128B writes: columns in slabs of 64, a slab rows x 128
//    bytes, 16-byte chunk c of row r at chunk c ^ (r % 8).  Q comes the
//    same way at the start.  The layout is the K-major A (Q) and B (K) of
//    S = Q K^T and the MN-major (transposed) B of O += P V.
//  * Registers: S (64 x BK) and O (64 x hd, 128 floats a thread at hd
//    256) are wgmma accumulators; the softmax runs on S in place (a row's
//    max and sum over the 4 lanes of a quad, by a fixed xor tree), and P
//    goes back into wgmma as register A fragments: an accumulator's
//    layout is an A fragment's, so no data moves.  Each softmax step
//    (scale, softcap, the mask, the max, exp and the split) is one
//    branch-free loop over the tile so that the scores' dependency chains
//    interleave; the mask runs only on tiles that cross the end of S, the
//    causal frontier or the window's edge for the warpgroup's rows, and
//    the rescale of O is skipped where alpha is 1 (exact).
//  * Key tile: 64 at hd 128 and 256, 128 at hd 64 (ops.py's TILES; Q + 2
//    stages: 193 KB at hd 256).
//  * Numerics, kept within the bound that held the fp32-on-CUDA-cores
//    version: bf16 x bf16 products are exact in fp32, so S differs from
//    an fp32 dot only by its summation order.  The fp32 score is
//    multiplied by scale after the product.  At hd 64 and 256 the scale
//    is a power of two, which commutes with every rounding: the score is
//    bitwise the one of q * scale (exact in bf16, as the TPU kernel folds
//    it) times k.  At hd 128 it is not, and the score lies about one fp32
//    ulp from the TPU kernel's (q * scale) . k.  s / softcap is s times
//    1 / softcap and o / l is o times 1 / l, each within an ulp; exp(x)
//    is 2^(x log2 e) on the SFU (ex2.approx, 2 ulp).  P is split into
//    p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both go through the
//    tensor cores into O: that keeps p to ~2^-17 relative where one bf16
//    rounding would move an output by up to 2^-9 max|v|.  The
//    denominator sums the fp32 p.
//  * The output is staged through the warpgroup's Q region and written
//    as 16-byte rows.
// Every reduction has a fixed order.  Positions past S (a ragged last
// tile) read zeros and are masked.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "../../csrc/common.cuh"

namespace {

using repro::bf16_t;
using repro::from_f;
using repro::load_pack;
using repro::Pack;
using repro::store_pack;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -2.0e38f;

template <int HD, int BQ, int BK>
struct Tile {
  static constexpr int RQ = BQ / 16;        // score and output rows a thread
  static constexpr int RK = BK / 16;        // score columns a thread
  static constexpr int NV = HD / 64;        // 4-wide output column groups
  static constexpr int RS = HD + 4;         // Q/K/V row stride in floats
  static constexpr int PS = BK + 4;         // probability row stride
  static constexpr int kFloats = BQ * RS + BK * RS + BQ * PS + 3 * BQ;
  static constexpr int kBytes = kFloats * 4;
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const Pack<T, 4> v = load_pack<T, 4>(p);
  return make_float4(to_f(v.v[0]), to_f(v.v[1]), to_f(v.v[2]), to_f(v.v[3]));
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [r0, r0 + n) of a (S, ., HD) tensor, starting at `base` with
// `stride` elements between positions, into smem rows of RS floats
// (times `mul`); rows at or past S are zeros
template <typename T, int HD, int RS, int N>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long stride, int r0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < N * HD / 4; i += kThreads) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      f = load4(base + (r0 + r) * stride + c);
      f.x = __fmul_rn(f.x, mul);
      f.y = __fmul_rn(f.y, mul);
      f.z = __fmul_rn(f.z, mul);
      f.w = __fmul_rn(f.w, mul);
    }
    *reinterpret_cast<float4*>(dst + r * RS + c) = f;
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int K, int n_qt, int causal, int window, float softcap,
                 float scale) {
  using L = Tile<HD, BQ, BK>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kv_s = q_s + BQ * L::RS;
  float* p_s = kv_s + BK * L::RS;
  float* m_s = p_s + BQ * L::PS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(K) * HD;
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * S * K + kh) * HD;
  const T* vb = v + (static_cast<long long>(b) * S * K + kh) * HD;

  load_rows<T, HD, L::RS, BQ>(q_s, qb, q_stride, q0, S, scale);
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[L::RQ][L::NV][4];
#pragma unroll
  for (int i = 0; i < L::RQ; ++i)
#pragma unroll
    for (int n = 0; n < L::NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  // the key tiles that can hold a visible key for queries [q0, q_last]
  const int q_last = min(q0 + BQ, S) - 1;
  int t_hi = (S - 1) / BK;
  if (causal) t_hi = min(t_hi, q_last / BK);
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                     // the last tile's PV is done
    load_rows<T, HD, L::RS, BK>(kv_s, kb, kv_stride, k0, S, 1.f);
    __syncthreads();

    float sc[L::RQ][L::RK];
#pragma unroll
    for (int i = 0; i < L::RQ; ++i)
#pragma unroll
      for (int j = 0; j < L::RK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[L::RQ], kv[L::RK];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * L::RQ + i) * L::RS + d);
#pragma unroll
      for (int j = 0; j < L::RK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * L::RS + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < L::RQ; ++i)
#pragma unroll
          for (int j = 0; j < L::RK; ++j)
            sc[i][j] = fmaf(get(qv[i], e), get(kv[j], e), sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < L::RQ; ++i) {
      const int r = ty * L::RQ + i;
#pragma unroll
      for (int j = 0; j < L::RK; ++j) {
        const int c = tx + 16 * j;
        const int qi = q0 + r, kj = k0 + c;
        float s = sc[i][j];
        if (softcap > 0.f) s = __fmul_rn(softcap, tanhf(__fdiv_rn(s, softcap)));
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        p_s[r * L::PS + c] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float sv[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        sv[j] = p_s[r * L::PS + lane + 32 * j];
        mx = fmaxf(mx, sv[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = expf(sv[j] - m_new);
        p_s[r * L::PS + lane + 32 * j] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(alpha, l_s[r]), sum);
        m_s[r] = m_new;
      }
    }
    load_rows<T, HD, L::RS, BK>(kv_s, vb, kv_stride, k0, S, 1.f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < L::RQ; ++i) {
      const float a = a_s[ty * L::RQ + i];
#pragma unroll
      for (int n = 0; n < L::NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = __fmul_rn(acc[i][n][e], a);
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[L::RQ];
#pragma unroll
      for (int i = 0; i < L::RQ; ++i) pr[i] = p_s[(ty * L::RQ + i) * L::PS + j];
#pragma unroll
      for (int n = 0; n < L::NV; ++n) {
        const float4 vv =
            *reinterpret_cast<const float4*>(kv_s + j * L::RS + n * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < L::RQ; ++i) {
          acc[i][n][0] = fmaf(pr[i], vv.x, acc[i][n][0]);
          acc[i][n][1] = fmaf(pr[i], vv.y, acc[i][n][1]);
          acc[i][n][2] = fmaf(pr[i], vv.z, acc[i][n][2]);
          acc[i][n][3] = fmaf(pr[i], vv.w, acc[i][n][3]);
        }
      }
    }
  }
  __syncthreads();

  T* ob = o + (static_cast<long long>(b) * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < L::RQ; ++i) {
    const int r = ty * L::RQ + i;
    if (q0 + r >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < L::NV; ++n) {
      Pack<T, 4> out;
#pragma unroll
      for (int e = 0; e < 4; ++e) out.v[e] = from_f<T>(__fdiv_rn(acc[i][n][e], den));
      store_pack(ob + (q0 + r) * q_stride + n * 64 + tx * 4, out);
    }
  }
}

template <typename T, int HD, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int K, int causal, int window, float softcap, float scale,
           cudaStream_t s) {
  using L = Tile<HD, BQ, BK>;
  auto kernel = flash_fwd_kernel<T, HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, K, n_qt, causal,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 tiles: 64 queries x 64 keys (151 KB of shared memory at hd 256)
constexpr int kBlkQ = 64;
constexpr int kBlkK = 64;

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kWG = 2;     // warpgroups a block, 64 query rows each

// the bf16 kernel's shape at head dim HD and key tile BK
template <int HD, int BK>
struct Bf16Tile {
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBlkQ = 64 * kWG;              // queries a block
  static constexpr int kChunks = HD / 8;              // 16-byte chunks a row
  static constexpr int kSlabs = HD / 64;              // 128-byte column slabs
  static constexpr int kQBytes = kBlkQ * HD * 2;
  static constexpr int kKVBytes = BK * HD * 2;        // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * 2 * kKVBytes;  // 2 stages, then
  static constexpr int kBytes = kBarOff + 32 + 1024;  // 3 mbarriers, 2 counts; align
  static constexpr int NPV = HD < 128 ? HD : 128;     // N of one P.V wgmma
  static constexpr int NO = HD / NPV;                 // P.V wgmmas a k-step
};

// Shared memory holds bf16 tiles in wgmma's 128-byte-swizzle layout, as
// TMA's SWIZZLE_128B writes them: the columns in slabs of 64 (128 bytes),
// each slab rows x 128 bytes, and the 16-byte chunk c of row r at chunk
// c ^ (r % 8) of the row (the tile 1024-byte aligned).

// The output staging layout (no swizzle): chunk c of row r at byte
// ((r / 8) * C + c) * 128 + (r % 8) * 16, so a warp's 4-byte writes of an
// accumulator fragment hit distinct banks.  Chunk index ci in that (byte)
// order is row (ci / (8 C)) * 8 + ci % 8, chunk (ci / 8) % C.
template <int C>
__device__ __forceinline__ int chunk_row(int ci) { return (ci / (8 * C)) * 8 + (ci & 7); }
template <int C>
__device__ __forceinline__ int chunk_col(int ci) { return (ci >> 3) % C; }

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait
// of more than ~10 s (a copy that never lands) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// a box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// K and V rows [k0, k0 + BK) of batch b, kv head kh into a stage (K, then
// V, each kSlabs slabs of BK rows): one thread asks TMA for 2 kSlabs
// boxes; rows at or past S arrive as zeros
template <int HD, int BK>
__device__ __forceinline__ void load_kv(uint32_t stage, uint32_t bar, const CUtensorMap* mk,
                                        const CUtensorMap* mv, int k0, int kh, int b) {
  using L = Bf16Tile<HD, BK>;
  mbar_expect_tx(bar, 2 * L::kKVBytes);
#pragma unroll
  for (int sl = 0; sl < L::kSlabs; ++sl) {
    tma_load(stage + sl * BK * 128, mk, bar, sl * 64, kh, k0, b);
    tma_load(stage + L::kKVBytes + sl * BK * 128, mv, bar, sl * 64, kh, k0, b);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// the byte offsets LBO (K-major: unused; MN-major: between 64-column
// slabs) and SBO (between groups of 8 rows: 1024)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)

// d (64 x 64 fp32) += A (64 x 16, K-major in shared memory) . B (16 x 64,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(a), "l"(b), "r"(1));
}
// d (64 x 128) += A (64 x 16) . B (16 x 128), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(1));
}
// d (64 x 64) += A (64 x 16 bf16 in registers) . B (16 x 64, MN-major in
// shared memory: the transposed operand)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 128) += A (64 x 16 in registers) . B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC64
#undef ACC32
#undef ACC8

// e^x as 2^(x log2 e) by the SFU's ex2.approx (2 ulp; results below
// 2^-126 flush to 0): within ~1e-6 of expf at the p that matter
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p0, p1 as p_hi = bf16(p) and p_lo = bf16(p - p_hi), each a bf16 pair
// (p0 in the low half)
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(p0, __low2float(h)),
                                    __fsub_rn(p1, __high2float(h))));
}

// A thread's share of a 64-row wgmma accumulator: element 4 j + 2 i + c is
// row 16 warp + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + c.
template <int HD, int BK>
__global__ void __launch_bounds__(128 * kWG, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16_t* __restrict__ o,
                  int S, int H, int K, int BH, int causal, int window, float softcap,
                  float scale) {
  using L = Bf16Tile<HD, BK>;
  constexpr int C = L::kChunks;
  constexpr int NS = BK / 2;               // score registers a thread
  constexpr int NPV = L::NPV;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // the swizzled tiles want 1024-byte alignment
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t kv_s = s_base + L::kQBytes;   // stage st: K, then V
  // stage st's mbarrier (its tile landed) at + 8 st, Q's at + 16, then a
  // count per stage of the warps done with it
  const uint32_t full = s_base + L::kBarOff, q_full = full + 16;
  int* done = reinterpret_cast<int*>(smem + L::kBarOff + 24);

  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int n_qt = (S + L::kBlkQ - 1) / L::kBlkQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * L::kBlkQ;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);

  // the key tiles that can hold a visible key for the block's queries
  const int q_last = min(q0 + L::kBlkQ, S) - 1;
  int t_hi = (S - 1) / BK;
  if (causal) t_hi = min(t_hi, q_last / BK);
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  if (tid == 0) {
    // the Q rows of each warpgroup with a row before S (past S: zeros) in
    // its own region, then the first two K/V tiles
    const int live_wgs = min(kWG, (S - q0 + 63) / 64);
    mbar_init(q_full, 1);
    mbar_expect_tx(q_full, live_wgs * 64 * HD * 2);
    for (int w = 0; w < live_wgs; ++w)
#pragma unroll
      for (int sl = 0; sl < L::kSlabs; ++sl)
        tma_load(s_base + w * 64 * HD * 2 + sl * 64 * 128, &map_q, q_full, sl * 64, h,
                 q0 + 64 * w, b);
    for (int st = 0; st < 2 && t_lo + st <= t_hi; ++st) {
      mbar_init(full + 8 * st, 1);
      done[st] = 0;
      load_kv<HD, BK>(kv_s + st * 2 * L::kKVBytes, full + 8 * st, &map_k, &map_v,
                      (t_lo + st) * BK, kh, b);
    }
  }
  __syncthreads();

  // each warpgroup: 64 query rows, waiting only for its tiles (no
  // block-wide barrier), so that one's softmax runs beside the
  // other's products
  const int w0 = q0 + 64 * wg;
  const bool live = w0 < S;
  int w_hi = (S - 1) / BK;
  if (causal) w_hi = min(w_hi, min(w0 + 63, S - 1) / BK);
  const int w_lo = window > 0 ? max(0, w0 - window + 1) / BK : 0;
  const long long q_stride = static_cast<long long>(H) * HD;
  const uint32_t q_s = s_base + wg * 64 * HD * 2;
  if (live) mbar_wait(q_full, 0);
  // s / softcap as s times the reciprocal: within an ulp of the
  // quotient, ~3e-6 of a score of 50 after the softcap's multiply
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  float acc[L::NO][NPV / 2];
#pragma unroll
  for (int n = 0; n < L::NO; ++n)
#pragma unroll
    for (int e = 0; e < NPV / 2; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = t_lo; t <= t_hi; ++t) {
    const int u = t - t_lo, st = u & 1;           // stage st's use u / 2
    const uint32_t k_s = kv_s + st * 2 * L::kKVBytes;
    const uint32_t v_s = k_s + L::kKVBytes;
    mbar_wait(full + 8 * st, (u >> 1) & 1);      // tile t has landed
    if (live && t >= w_lo && t <= w_hi) {        // else no products for these rows
      // S = Q K^T
      float sc[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) sc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)      // 16 columns: 32 bytes of a slab
        wgmma_ss(sc, smem_desc(q_s + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024),
                 smem_desc(k_s + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale and softcap; the mask only where the tile crosses the end
      // of S, the causal frontier or the window's edge for these 64 rows.
      // Each step is one branch-free loop over the tile's scores, so that
      // their long dependency chains (tanhf, expf) interleave.
      const int k0 = t * BK;
#pragma unroll
      for (int e = 0; e < NS; ++e) sc[e] = __fmul_rn(sc[e], scale);
      if (softcap > 0.f)
#pragma unroll
        for (int e = 0; e < NS; ++e) sc[e] = __fmul_rn(softcap, tanhf(__fmul_rn(sc[e], inv_cap)));
      if (k0 + BK > S || (causal && k0 + BK - 1 > w0) ||
          (window > 0 && k0 <= w0 + 63 - window))
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int qi = w0 + 16 * warp + g + 8 * ((e >> 1) & 1);
          const int kj = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
          const bool ok = kj < S && (!causal || kj <= qi) && (window == 0 || kj > qi - window);
          sc[e] = ok ? sc[e] : kNegInf;
        }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int e = 0; e < NS; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      // the online softmax over each row's quad (fixed xor order)
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = exp_sfu(m_run[i] - m_new);
        m_run[i] = m_new;
      }
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // A fragment register r of keys [16 kk, 16 kk + 16): elements
          // 8 kk + 2 r and + 1 of the accumulator, row i = r % 2
          const int e = 8 * kk + 2 * r, i = r & 1;
          const float p0 = exp_sfu(sc[e] - m_run[i]), p1 = exp_sfu(sc[e + 1] - m_run[i]);
          sum[i] = __fadd_rn(__fadd_rn(sum[i], p0), p1);
          split_bf16x2(p0, p1, p_hi[kk][r], p_lo[kk][r]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 1));
        sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 2));
        l_run[i] = __fadd_rn(__fmul_rn(alpha[i], l_run[i]), sum[i]);
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f)  // x 1 is exact: skip it
#pragma unroll
        for (int n = 0; n < L::NO; ++n)
#pragma unroll
          for (int e = 0; e < NPV / 2; ++e) acc[n][e] = __fmul_rn(acc[n][e], alpha[(e >> 1) & 1]);

      // O += P_hi V + P_lo V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < L::NO; ++n) {
          // keys 16 kk: two groups of 8 rows; columns n NPV: slab n NPV / 64
          const uint64_t dv = smem_desc(v_s + kk * 2 * 1024 + n * (NPV / 64) * BK * 128,
                                        BK * 128, 1024);
          wgmma_rs(acc[n], p_hi[kk], dv);
          wgmma_rs(acc[n], p_lo[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < L::NO; ++n) fence_regs(acc[n]);
    }
    // the last of the block's warps to be done with tile t refills its
    // stage with tile t + 2
    __syncwarp();
    if (lane == 0 && atomicAdd(done + st, 1) % (4 * kWG) == 4 * kWG - 1 && t + 2 <= t_hi)
      load_kv<HD, BK>(k_s, full + 8 * st, &map_k, &map_v, (t + 2) * BK, kh, b);
  }
  if (live) {
    // O / l through this warpgroup's Q region (core-matrix layout, whose
    // 4-byte writes from a warp hit distinct banks), then 16-byte rows out
    uint8_t* o_s = smem + wg * 64 * HD * 2;
    wg_barrier(1 + wg);              // every wgmma of this warpgroup has read Q
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // o / den as o times 1 / den: within an ulp before the bf16 rounding
      const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
      const int r = 16 * warp + g + 8 * i;
#pragma unroll
      for (int n = 0; n < L::NO; ++n)
#pragma unroll
        for (int j = 0; j < NPV / 8; ++j) {
          const int col = n * NPV + 8 * j + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(o_s + ((r >> 3) * C + (col >> 3)) * 128 +
                                            (r & 7) * 16 + (col & 7) * 2) =
              __floats2bfloat162_rn(__fmul_rn(acc[n][4 * j + 2 * i], inv),
                                    __fmul_rn(acc[n][4 * j + 2 * i + 1], inv));
        }
    }
    wg_barrier(1 + wg);
    bf16_t* ob = o + (static_cast<long long>(b) * S * H + h) * HD;
    for (int ci = t128; ci < 64 * C; ci += 128) {
      const int r = w0 + chunk_row<C>(ci);
      if (r < S)
        *reinterpret_cast<uint4*>(ob + r * q_stride + chunk_col<C>(ci) * 8) =
            *reinterpret_cast<const uint4*>(o_s + ci * 16);
    }
  }
}

// the bf16 kernel's key tile at head dim HD
template <int HD>
constexpr int bf16_kv_tile() { return HD == 64 ? 128 : 64; }

// cuTensorMapEncodeTiled (libcuda's), looked up through the runtime so
// that nothing links libcuda
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// Q, K or V (B, S, N, hd) as a 4-d tensor map (hd, N, S, B) whose boxes
// are 64 columns of one head at `rows` positions, written 128-byte
// swizzled; positions past S read as zeros
int tensor_map(CUtensorMap* map, const void* base, int B, int S, int N, int hd, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * N * hd, 2ull * S * N * hd};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int K, int causal, int window, float softcap,
                float scale, cudaStream_t s) {
  constexpr int BK = bf16_kv_tile<HD>();
  using L = Bf16Tile<HD, BK>;
  auto kernel = flash_bf16_kernel<HD, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + L::kBlkQ - 1) / L::kBlkQ;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap map_q, map_k, map_v;
  int e = tensor_map(&map_q, q, B, S, H, HD, 64);
  if (e == 0) e = tensor_map(&map_k, k, B, S, K, HD, BK);
  if (e == 0) e = tensor_map(&map_v, v, B, S, K, HD, BK);
  if (e != 0) return e;
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kBytes, s>>>(
      map_q, map_k, map_v, static_cast<bf16_t*>(o), S, H, K, B * H, causal, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32: q_blk = kv_blk = 64; bf16: q_blk = 64 kWG, kv_blk = bf16_kv_tile
template <int HD>
int launch_dtype(int dtype, int q_blk, int kv_blk, const void* q,
                 const void* k, const void* v, void* o, int B, int S, int H,
                 int K, int causal, int window, float softcap, float scale,
                 cudaStream_t s) {
  if (dtype == 0 && q_blk == kBlkQ && kv_blk == kBlkK)
    return launch<float, HD, kBlkQ, kBlkK>(q, k, v, o, B, S, H, K, causal,
                                           window, softcap, scale, s);
  if (dtype == 1 && q_blk == 64 * kWG && kv_blk == bf16_kv_tile<HD>())
    return launch_bf16<HD>(q, k, v, o, B, S, H, K, causal, window, softcap,
                           scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_hd(int dtype, int hd, int q_blk, int kv_blk, const void* q,
              const void* k, const void* v, void* o, int B, int S, int H,
              int K, int causal, int window, float softcap, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_dtype<64>(dtype, q_blk, kv_blk, q, k, v, o, B, S, H, K,
                              causal, window, softcap, scale, s);
    case 128:
      return launch_dtype<128>(dtype, q_blk, kv_blk, q, k, v, o, B, S, H, K,
                               causal, window, softcap, scale, s);
    case 256:
      return launch_dtype<256>(dtype, q_blk, kv_blk, q, k, v, o, B, S, H, K,
                               causal, window, softcap, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q and o are
// (B, S, H, hd), k and v (B, S, K, hd), all contiguous and 16-byte aligned
// (the wrapper checks); q_blk and kv_blk must be the dtype's tiles above.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int K, int hd, int q_blk,
                                      int kv_blk, int causal, int window,
                                      float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_hd(dtype, hd, q_blk, kv_blk, q, k, v, o, B, S, H, K, causal,
                   window, softcap, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
