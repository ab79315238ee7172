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
// fp32 (flash_tf32_kernel): both products on the tensor cores in 3xTF32,
// wgmma m64nNk8 with tf32 inputs and fp32 sums.  Each fp32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to
// nearest, ties away; the unit is never left to drop low bits), and a
// product is lo.hi + hi.lo + hi.hi, small terms first.  That keeps ~22
// bits of each operand, so the fp32 bound (2e-5) holds where one TF32
// product misses it by ~100x.  Bound by operations: 3 x 4 hd flops per
// visible (query, key) pair at the TF32 rate (495 TFLOP/s); the bytes
// (q, k, v read once, o written once) take under half of that time at
// the shapes timed.  What held the CUDA-core kernel back, and what this
// one does about it:
//  * CUDA cores only: both products are wgmma; the three products of a
//    k-step read the same shared-memory tiles, so the split costs shared
//    memory, not extra copies from device memory.
//  * Synchronous loads: K and V arrive by cp.async (rows past S
//    zero-filled), V(t) while Q K(t)^T is multiplied, K(t + 1) while the
//    softmax and P V(t) run.  Each thread splits the K chunks it copied,
//    in place (hi where the copy landed, lo beside it), so each element
//    is split once per block.
//  * Scores through shared memory: S is a wgmma accumulator and the
//    online softmax runs on it in registers (a row's max and sum over
//    the 4 lanes of a quad by a fixed xor tree); P goes back into wgmma
//    as register A fragments: the 8 keys of a k-step go to the MMA's
//    slots in the order (0, 2, 4, 6, 1, 3, 5, 7), so P's A fragment is
//    exactly the accumulator's registers (a thread holds keys 2c, 2c + 1
//    of a row), and V^T is written in that key order.  A sum over keys
//    does not depend on their order.
//  * K/V read again per query head: a block reads its kv head's tiles
//    (kh = h / (H / K), never copied per query head), from L2 for the
//    query heads after the first; serving several query heads from one
//    block was not tried.
//  * Layout: tf32 wgmma takes its shared-memory operands only K-major, so
//    K (keys x head dim) is used as stored and V is transposed: after
//    V(t) lands raw, each lane takes a key and writes V^T hi and lo with
//    the 128-byte swizzle (32 slots of one row a store).  Q is split once
//    into the same layout at hd 64 and 128 (each warpgroup takes 64 query
//    rows, A from shared memory); at hd 256 Q, split, would not fit
//    beside K and V (227 KB a block), so it stays raw and each warpgroup
//    splits its A fragments in registers at each use, on half the head
//    dim: the two warpgroups add their partial scores through shared
//    memory in the same order, and each keeps half of O.
//  * Numerics: q * scale is rounded to fp32 before the product, as the
//    TPU kernel folds it; softcap * tanhf(s * (1 / softcap)) (within an
//    ulp of the quotient; accurate tanhf); the mask sets -2e38, the
//    running max starts there, alpha = exp(m_prev - m_new); exp(x) is
//    2^(x log2 e) on the SFU (ex2.approx, 2 ulp); the denominator sums
//    the fp32 p and is clamped at 1e-30, o / l an IEEE quotient.  The
//    MMA truncates its fp32 sum, so a long chain of MMAs into one
//    accumulator drifts toward zero (one chain over all of hd 256 breaks
//    the 2e-5 bound on an H100 at scores of std 2): Q K^T sums each four
//    k-steps of 8, and P V each key tile, in a fresh accumulator that an
//    IEEE add then puts into S or O.  Every sum has a fixed order, so a
//    second call gives the same bits.
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

constexpr float kNegInf = -2.0e38f;

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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// fp32: both products on the tensor cores in 3xTF32 (wgmma)
// ---------------------------------------------------------------------------

// The fp32 kernel's shape at head dim HD.  Both products by wgmma, two
// warpgroups a block, on K split into hi and lo and on V^T likewise,
// both in shared memory in the 128-byte-swizzle layout (slabs of 32
// columns or keys, rows of 128 bytes, 16-byte chunk ch of row r at chunk
// ch ^ (r % 8)).  QSPLIT (hd 64, 128): Q is split once, into the same
// layout; each warpgroup takes 64 query rows over the whole head dim
// (128 queries a block).  Else (hd 256, where a split Q does not fit
// beside K and V): Q stays raw and is split at each use into register
// fragments; both warpgroups take the block's 64 rows, each on half the
// head dim (NH = 2): their partial scores are summed through shared
// memory, in the same order in both, and each keeps its half of O.
template <int HD>
struct Tf32Tile {
  static constexpr bool QSPLIT = HD != 256;
  static constexpr int BK = HD == 64 ? 64 : 32;
  static constexpr int NH = QSPLIT ? 1 : 2;
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlkQ = 64 * 2 / NH;           // queries a block
  static constexpr int HDW = HD / NH;                 // head-dim columns a warpgroup
  static constexpr int NT = BK / 8;                   // 8-key groups a tile
  static constexpr int NO = HDW / 8;                  // 8-column groups of a warp's O
  static constexpr int QS = HD + 4;                   // raw Q row stride, floats
  static constexpr int VS = HD + 4;                   // raw V row stride, floats
  // bytes from a 1024-aligned base: Q hi, lo (QSPLIT); K hi (the copy
  // lands there), lo; V^T hi, lo; raw Q (else); raw V
  static constexpr int kQB = QSPLIT ? kBlkQ * HD * 4 : 0, kKB = BK * HD * 4, kVTB = HD * BK * 4;
  static constexpr int kKHi = 2 * kQB, kKLo = kKHi + kKB;
  static constexpr int kVTHi = kKLo + kKB, kVTLo = kVTHi + kVTB;
  static constexpr int kQRaw = kVTLo + kVTB;
  static constexpr int kVRaw = kQRaw + (QSPLIT ? 0 : kBlkQ * QS * 4);
  static constexpr int kBytes = 1024 + kVRaw + BK * VS * 4;
  static_assert(kBytes <= 232448, "a Hopper block's shared memory");
  static_assert(NH == 1 || kWarps * 16 * BK * 4 <= kKB, "partial scores in K lo");
};

__device__ __forceinline__ void cp_async16(void* smem, const float* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// order this thread's shared-memory writes before the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Where the 16-byte chunk i (4 columns) of row r lands: in rows of RS
// floats (SW = false), or in the 128-byte-swizzle layout of a ROWS-row
// tile (SW = true: slabs of 32 columns, ROWS x 128 bytes, chunk ch of
// row r at chunk ch ^ (r % 8))
template <bool SW, int ROWS, int RS>
__device__ __forceinline__ int chunk_byte(int r, int i) {
  if constexpr (SW)
    return (i >> 3) * ROWS * 128 + r * 128 + (((i & 7) ^ (r & 7)) << 4);
  else
    return (r * RS + 4 * i) * 4;
}

// rows [r0, r0 + ROWS) of a (S, ., HD) fp32 tensor starting at `base`,
// `stride` floats between positions, into shared memory by 16-byte
// cp.async, chunk i by thread i % THREADS; rows at or past S are
// zero-filled
template <int HD, int ROWS, bool SW, int RS, int THREADS>
__device__ __forceinline__ void load_rows_async(uint8_t* dst, const float* base,
                                                long long stride, int r0, int S) {
  constexpr int C = HD / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool in = r0 + r < S;
    const float* src = in ? base + (r0 + r) * stride + 4 * c : base;
    cp_async16(dst + chunk_byte<SW, ROWS, RS>(r, c), src, in);
  }
}

// x as hi + lo: hi = tf32(x), lo = tf32(x - hi), each rounded to nearest
// (ties away) with its 13 low bits zero
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

// the chunks a thread copied with load_rows_async, times `mul` (1: as
// they are) and split in place: hi where the copy landed, lo at the same
// offset of `lo`
template <int HD, int ROWS, bool SW, int RS, int THREADS>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, float mul) {
  constexpr int C = HD / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
    const int off = chunk_byte<SW, ROWS, RS>(i / C, i % C);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split_tf32(__fmul_rn(x.x, mul), h.x, l.x);
    split_tf32(__fmul_rn(x.y, mul), h.y, l.y);
    split_tf32(__fmul_rn(x.z, mul), h.z, l.z);
    split_tf32(__fmul_rn(x.w, mul), h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Raw V rows (stride VS floats) -> V^T hi and lo, HD rows of BK keys in
// the 128-byte-swizzle layout (slabs of 32 keys, HD x 128 bytes); within
// each 8 keys key w goes to slot (w >> 1) + 4 (w & 1), the slot order of
// P's A fragment.  Lane l takes key l (+ 32 a pass), warp w the column
// groups w, w + WARPS, ...: a store writes 32 slots of one row.
template <int HD, int BK, int VS, int WARPS>
__device__ __forceinline__ void transpose_split(const float* raw, uint8_t* vt_hi,
                                                uint8_t* vt_lo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int pass = 0; pass < BK / 32; ++pass) {
    const int j = 32 * pass + lane, w = j & 7;
    const int slot = (j & 24) + (w >> 1) + 4 * (w & 1);     // within the slab
#pragma unroll 2
    for (int i = warp; i < HD / 4; i += WARPS) {
      const float4 x = *reinterpret_cast<const float4*>(raw + j * VS + 4 * i);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * i + e;
        const int off =
            pass * HD * 128 + n * 128 + (((slot >> 2) ^ (n & 7)) << 4) + (slot & 3) * 4;
        uint32_t hi, lo;
        split_tf32(xs[e], hi, lo);
        *reinterpret_cast<uint32_t*>(vt_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(vt_lo + off) = lo;
      }
    }
  }
}

#define ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC16 ACC8(0), ACC8(8)
#define ACC32 ACC16, ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define R16                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define R32                                                                     \
  R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31"
#define R64                                                                     \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
      "%60, %61, %62, %63"
// wgmma with tf32 inputs and fp32 sums, d (64 x N) (+)= A (64 x 8) . B
// (8 x N): B K-major in shared memory (desc), A likewise or in registers
// (a warp's 16 rows as mma.m16n8k8's A: thread (g, c) = (lane / 4, lane %
// 4) holds (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4)); scale_d 0
// starts d from zero.  A warp's share of d: element 4 j + 2 i + e is row
// 16 (warp % 4) + g + 8 i, column 8 j + 2 c + e.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" R16
               "}, %16, %17, p, 1, 1;\n}\n"
               : ACC16 : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" R16
               "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : ACC16 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" R32
               "}, %32, %33, p, 1, 1;\n}\n"
               : ACC32 : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" R32
               "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : ACC32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" R64
               "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : ACC64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
#undef R64
#undef R32
#undef R16
#undef ACC64
#undef ACC32
#undef ACC16
#undef ACC8

// a wgmma reads its register A fragments while it runs: keep them live
// (unchanged) up to the wait that covers it
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&ah)[N][4],
                                          const uint32_t (&al)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(ah[j][i]), "r"(al[j][i]) : "memory");
}

// k-steps of 8 whose products a fresh accumulator sums before one IEEE
// add into S (kKG) or, for P V, a tile's: the MMA truncates its fp32 sum,
// so a long chain of MMAs into one accumulator drifts (toward zero, by up
// to an ulp of the running sum an MMA); a fresh sum of a few k-steps errs
// only by ulps of itself, and the running sums round to nearest
constexpr int kKG = 4;

// A warp's share: query rows 16 r + g and + 8 of its warpgroup's (r =
// warp % 4), head-dim columns [HDW h, HDW (h + 1)) (h = warp / 4 if NH =
// 2, else 0).  Its S accumulator sc[n] holds keys 8 n + 2 c and + 1 of
// the tile; its O accumulator acc[n] columns HDW h + 8 n + 2 c and + 1.
template <int HD>
__global__ void __launch_bounds__(Tf32Tile<HD>::kThreads, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int H,
                  int K, int BH, int causal, int window, float softcap, float scale) {
  using L = Tf32Tile<HD>;
  constexpr int BK = L::BK, NT = L::NT, NO = L::NO, QS = L::QS, VS = L::VS;
  constexpr int HDW = L::HDW;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // the swizzled tiles want 1024-byte alignment
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sm_s = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  uint8_t* k_hi = sm + L::kKHi;
  uint8_t* k_lo = sm + L::kKLo;
  float* q_raw = reinterpret_cast<float*>(sm + L::kQRaw);
  float* v_raw = reinterpret_cast<float*>(sm + L::kVRaw);
  float* xch = reinterpret_cast<float*>(k_lo);          // NH = 2: partial scores

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = warp & 3;
  const int wh = L::NH > 1 ? wg : 0;                    // head-dim half
  const int g = lane >> 2, c = lane & 3;
  const int n_qt = (S + L::kBlkQ - 1) / L::kBlkQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * L::kBlkQ;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(K) * HD;
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<long long>(b) * S * K + kh) * HD;
  const float* vb = v + (static_cast<long long>(b) * S * K + kh) * HD;

  // the key tiles that can hold a visible key for the block's queries,
  // for this warpgroup's 64 rows and for this warp's 16
  const int q_last = min(q0 + L::kBlkQ, S) - 1;
  int t_hi = (S - 1) / BK;
  if (causal) t_hi = min(t_hi, q_last / BK);
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int g0 = q0 + (L::NH > 1 ? 0 : 64 * wg);
  int g_hi = (S - 1) / BK;
  if (causal) g_hi = min(g_hi, min(g0 + 63, S - 1) / BK);
  const int g_lo = window > 0 ? max(0, g0 - window + 1) / BK : 0;
  const int w0 = g0 + 16 * wr;
  const bool live = w0 < S;
  int w_hi = (S - 1) / BK;
  if (causal) w_hi = min(w_hi, min(w0 + 15, S - 1) / BK);
  const int w_lo = window > 0 ? max(0, w0 - window + 1) / BK : 0;

  if constexpr (L::QSPLIT)
    load_rows_async<HD, L::kBlkQ, true, 0, L::kThreads>(sm, qb, q_stride, q0, S);
  else
    load_rows_async<HD, L::kBlkQ, false, QS, L::kThreads>(sm + L::kQRaw, qb, q_stride, q0, S);
  cp_async_commit();
  load_rows_async<HD, BK, true, 0, L::kThreads>(k_hi, kb, kv_stride, t_lo * BK, S);
  cp_async_commit();
  cp_async_wait<1>();
  // q * scale rounded to fp32, each thread on the chunks it copied;
  // QSPLIT: split into hi and lo
  if constexpr (L::QSPLIT) {
    split_rows<HD, L::kBlkQ, true, 0, L::kThreads>(sm, sm + L::kQB, scale);
  } else {
    for (int i = tid; i < L::kBlkQ * (HD / 4); i += L::kThreads) {
      const int r = i / (HD / 4), col = (i % (HD / 4)) * 4;
      float4* p4 = reinterpret_cast<float4*>(q_raw + r * QS + col);
      float4 x = *p4;
      x.x = __fmul_rn(x.x, scale);
      x.y = __fmul_rn(x.y, scale);
      x.z = __fmul_rn(x.z, scale);
      x.w = __fmul_rn(x.w, scale);
      *p4 = x;
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  // raw Q (NH = 2): A rows g, g + 8, columns d + c and d + c + 4
  const float* qa = q_raw + (16 * wr + g) * QS + HDW * wh + c;
  float* mine = xch + (warp * NT * 4) * 32 + lane;
  const float* other = xch + (((warp + 4) % L::kWarps) * NT * 4) * 32 + lane;
  const uint32_t kh_s = sm_s + L::kKHi, kl_s = sm_s + L::kKLo;
  const uint32_t vh_s = sm_s + L::kVTHi + HDW * wh * 128, vl_s = vh_s + L::kVTB;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    cp_async_wait<0>();
    split_rows<HD, BK, true, 0, L::kThreads>(k_hi, k_lo, 1.f);
    fence_proxy_async();        // the tensor cores read what threads wrote
    __syncthreads();            // K(t) split; every warp is done with V(t - 1)
    load_rows_async<HD, BK, false, VS, L::kThreads>(reinterpret_cast<uint8_t*>(v_raw), vb,
                                                    kv_stride, k0, S);
    cp_async_commit();
    const bool act = live && t >= w_lo && t <= w_hi;
    const bool g_act = g0 < S && t >= g_lo && t <= g_hi;  // uniform in a warpgroup
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    if (g_act) {
      // S = Q K^T over this warpgroup's columns: a fresh accumulator a
      // group of kKG k-steps, then IEEE adds in order
      constexpr int NG = HDW / 8 / kKG;
      if constexpr (L::QSPLIT) {
        // A (Q) and B (K) from shared memory: every group at once
        float part[NG][NT * 4];
        const uint32_t qh = sm_s + 64 * wg * 128, ql = qh + L::kQB;
        wgmma_fence();
#pragma unroll
        for (int gi = 0; gi < NG; ++gi)
#pragma unroll
          for (int j = 0; j < kKG; ++j) {
            const int kk = gi * kKG + j;
            const uint32_t qo = (kk >> 2) * L::kBlkQ * 128 + (kk & 3) * 32;
            const uint32_t ko = (kk >> 2) * BK * 128 + (kk & 3) * 32;
            const uint64_t dqh = smem_desc(qh + qo, 16, 1024);
            const uint64_t dkh = smem_desc(kh_s + ko, 16, 1024);
            wgmma_tf32(part[gi], smem_desc(ql + qo, 16, 1024), dkh, j > 0);
            wgmma_tf32(part[gi], dqh, smem_desc(kl_s + ko, 16, 1024), 1);
            wgmma_tf32(part[gi], dqh, dkh, 1);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          fence_regs(part[gi]);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = __fadd_rn(sc[n][e], part[gi][4 * n + e]);
        }
      } else {
        // A (raw Q, split here) from registers: group gi + 1 is split
        // while group gi's products run (two sets of fragments and of
        // accumulators)
        uint32_t ah[2][kKG][4], al[2][kKG][4];
        float part[2][NT * 4];
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const int x = gi & 1;
#pragma unroll
          for (int j = 0; j < kKG; ++j) {
            const int d = 8 * (gi * kKG + j);
            split_tf32(qa[d], ah[x][j][0], al[x][j][0]);
            split_tf32(qa[8 * QS + d], ah[x][j][1], al[x][j][1]);
            split_tf32(qa[d + 4], ah[x][j][2], al[x][j][2]);
            split_tf32(qa[8 * QS + d + 4], ah[x][j][3], al[x][j][3]);
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kKG; ++j) {
            const int kk = HDW / 8 * wh + gi * kKG + j;
            const uint32_t ko = (kk >> 2) * BK * 128 + (kk & 3) * 32;
            const uint64_t dkh = smem_desc(kh_s + ko, 16, 1024);
            wgmma_tf32(part[x], al[x][j], dkh, j > 0);
            wgmma_tf32(part[x], ah[x][j], smem_desc(kl_s + ko, 16, 1024), 1);
            wgmma_tf32(part[x], ah[x][j], dkh, 1);
          }
          wgmma_commit();
          if (gi > 0) {             // group gi - 1 is done: into S, in order
            wgmma_wait<1>();
            keep_regs(ah[x ^ 1], al[x ^ 1]);
            fence_regs(part[x ^ 1]);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sc[n][e] = __fadd_rn(sc[n][e], part[x ^ 1][4 * n + e]);
          }
        }
        wgmma_wait<0>();
        keep_regs(ah[(NG - 1) & 1], al[(NG - 1) & 1]);
        fence_regs(part[(NG - 1) & 1]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = __fadd_rn(sc[n][e], part[(NG - 1) & 1][4 * n + e]);
      }
    }
    __syncthreads();            // every warp is done with K(t)
    if (t < t_hi)
      load_rows_async<HD, BK, true, 0, L::kThreads>(k_hi, kb, kv_stride, k0 + BK, S);
    cp_async_commit();
    if constexpr (L::NH > 1) {  // partial scores out, through K lo
      if (act)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = sc[n][e];
      __syncthreads();
    }
    if (act) {
      if constexpr (L::NH > 1)  // the two halves' sum, in the same order in both warps
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = other[(4 * n + e) * 32];
            sc[n][e] = wh == 0 ? __fadd_rn(sc[n][e], y) : __fadd_rn(y, sc[n][e]);
          }
      if (softcap > 0.f)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = __fmul_rn(softcap, tanhf(__fmul_rn(sc[n][e], inv_cap)));
      if (k0 + BK > S || (causal && k0 + BK - 1 > w0) ||
          (window > 0 && k0 <= w0 + 15 - window))
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = w0 + g + 8 * (e >> 1), kj = k0 + 8 * n + 2 * c + (e & 1);
            const bool ok = kj < S && (!causal || kj <= qi) && (window == 0 || kj > qi - window);
            sc[n][e] = ok ? sc[n][e] : kNegInf;
          }
      // the online softmax over each row's quad (fixed xor order)
      float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = exp_sfu(m_run[i] - m_new);
        m_run[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp_sfu(sc[n][e] - m_run[e >> 1]);
          sum[e >> 1] = __fadd_rn(sum[e >> 1], sc[n][e]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 1));
        sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 2));
        l_run[i] = __fadd_rn(__fmul_rn(alpha[i], l_run[i]), sum[i]);
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f)  // x 1 is exact: skip it
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], alpha[e >> 1]);
    } else {
      // rows that see none of the tile: p = 0 in their warpgroup's P V
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();            // V(t) landed, every thread's copies
    transpose_split<HD, BK, VS, L::kWarps>(v_raw, sm + L::kVTHi, sm + L::kVTLo);
    fence_proxy_async();
    __syncthreads();            // V^T(t) split
    if (g_act) {
      // O += P V over this warpgroup's columns: P (A) from the S
      // registers (a k-step's keys in the slot order (0, 2, 4, 6, 1, 3,
      // 5, 7), so P's A fragment is the accumulator's registers), V^T (B)
      // from shared memory; a fresh accumulator for the tile, then IEEE
      // adds into O
      uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        split_tf32(sc[kk][0], ph[kk][0], pl[kk][0]);
        split_tf32(sc[kk][2], ph[kk][1], pl[kk][1]);
        split_tf32(sc[kk][1], ph[kk][2], pl[kk][2]);
        split_tf32(sc[kk][3], ph[kk][3], pl[kk][3]);
      }
      float part[NO * 4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const uint32_t off = (kk >> 2) * HD * 128 + (kk & 3) * 32;
        const uint64_t dh = smem_desc(vh_s + off, 16, 1024);
        wgmma_tf32(part, pl[kk], dh, kk > 0);
        wgmma_tf32(part, ph[kk], smem_desc(vl_s + off, 16, 1024), 1);
        wgmma_tf32(part, ph[kk], dh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      if (act)
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], part[4 * n + e]);
    }
  }
  cp_async_wait<0>();

  if (live) {
    float* ob = o + (static_cast<long long>(b) * S * H + h) * HD + HDW * wh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = w0 + g + 8 * i;
      if (r >= S) continue;
      const float den = fmaxf(l_run[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(ob + r * q_stride + 8 * n + 2 * c) =
            make_float2(__fdiv_rn(acc[n][2 * i], den), __fdiv_rn(acc[n][2 * i + 1], den));
    }
  }
}

template <int HD>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B, int S,
                int H, int K, int causal, int window, float softcap, float scale,
                cudaStream_t s) {
  using L = Tf32Tile<HD>;
  auto kernel = flash_tf32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + L::kBlkQ - 1) / L::kBlkQ;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, K, B * H, causal,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

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

// fp32: Tf32Tile's kBlkQ and BK; bf16: q_blk = 64 kWG, kv_blk =
// bf16_kv_tile
template <int HD>
int launch_dtype(int dtype, int q_blk, int kv_blk, const void* q,
                 const void* k, const void* v, void* o, int B, int S, int H,
                 int K, int causal, int window, float softcap, float scale,
                 cudaStream_t s) {
  if (dtype == 0 && q_blk == Tf32Tile<HD>::kBlkQ && kv_blk == Tf32Tile<HD>::BK)
    return launch_tf32<HD>(q, k, v, o, B, S, H, K, causal, window, softcap,
                           scale, s);
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
