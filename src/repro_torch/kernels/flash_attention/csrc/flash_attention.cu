// Forward flash attention for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:83
// flash_attention (pl.pallas_call at :108).  For batch b, query head h and
// kv head kh = h / (H / K) (GQA: K/V are read through kh, never copied per
// query head):
//   s[i, j] = softcap(scale * q[b, i, h] . k[b, j, kh]),   scale = hd^-0.5
//   o[b, i, h] = sum_j softmax_j(s[i, :] masked) v[b, j, kh]
// masked: j <= i (causal), j > i - window (window > 0), set to -2e38.  As
// in the TPU kernel: q * scale is rounded to fp32 before the dot, softcap
// is softcap * tanh(s / softcap), the running max starts at -2e38, the
// online softmax rescales by alpha = exp(m_prev - m_new), the denominator
// is clamped at 1e-30, and KV tiles wholly above the causal frontier or
// wholly before the window are skipped.  Scores, softmax and PV are fp32,
// the output in q's type.
//
// What bounds it on this card: operations.  The two products are fp32 on
// CUDA cores (67 TFLOP/s); bf16/TF32 tensor cores (wgmma) would change the
// numerics and are left to a later change.  At hd 128-256 a query tile
// does 4 * hd flops per (query, key) pair for 2 * hd * 2-4 bytes of K/V
// read once per tile, far above the fp32 ridge.
//
// Design (simple and right first): one block of 256 threads (16 x 16) per
// (batch, query head, tile of BQ queries); a loop over the tiles of BK
// keys that can contribute.  The scaled Q tile, the K tile and then the V
// tile (in one buffer) and the probability tile live in dynamic shared
// memory, rows padded by 4 floats so that the 16-byte reads of a
// quarter-warp hit distinct banks.  Each thread computes a BQ/16 x BK/16
// block of scores (columns tx + 16 j) and owns BQ/16 output rows x hd/16
// columns of the accumulator in registers.  One warp per row runs the
// online softmax on the score tile.  Every reduction has a fixed order.
// Positions past S (a ragged last tile) read zeros and are masked.

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

// the tile sizes the library is built for: 64 queries x 64 keys (151 KB
// of shared memory at hd 256, fp32)
constexpr int kBlkQ = 64;
constexpr int kBlkK = 64;

template <typename T, int HD>
int launch_tiles(int q_blk, int kv_blk, const void* q, const void* k,
                 const void* v, void* o, int B, int S, int H, int K,
                 int causal, int window, float softcap, float scale,
                 cudaStream_t s) {
  if (q_blk != kBlkQ || kv_blk != kBlkK)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, HD, kBlkQ, kBlkK>(q, k, v, o, B, S, H, K, causal, window,
                                     softcap, scale, s);
}

template <typename T>
int launch_hd(int hd, int q_blk, int kv_blk, const void* q, const void* k,
              const void* v, void* o, int B, int S, int H, int K, int causal,
              int window, float softcap, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_tiles<T, 64>(q_blk, kv_blk, q, k, v, o, B, S, H, K,
                                 causal, window, softcap, scale, s);
    case 128:
      return launch_tiles<T, 128>(q_blk, kv_blk, q, k, v, o, B, S, H, K,
                                  causal, window, softcap, scale, s);
    case 256:
      return launch_tiles<T, 256>(q_blk, kv_blk, q, k, v, o, B, S, H, K,
                                  causal, window, softcap, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q and o are
// (B, S, H, hd), k and v (B, S, K, hd), all contiguous and aligned to 4
// elements (the wrapper checks).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int K, int hd, int q_blk,
                                      int kv_blk, int causal, int window,
                                      float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q_blk, kv_blk, q, k, v, o, B, S, H, K, causal,
                            window, softcap, scale, s);
  if (dtype == 1)
    return launch_hd<bf16_t>(hd, q_blk, kv_blk, q, k, v, o, B, S, H, K,
                             causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
