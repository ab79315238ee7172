// Paged decode attention for NVIDIA Hopper (sm_90a), in CUDA C++.
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
// is an fp32 online softmax whose denominator is clamped at 1e-30, as in
// the TPU kernel.
//
// What bounds it on this card: bytes.  A sequence reads (pos+1)*K*hd K and
// V elements and does about 4 flops per element read, far under the ~295
// flop/byte ridge of an H100 in bf16.
//
// Design (simple and right first):
//  * one thread block of 8 warps per (sequence, kv head);
//  * the G x hd query rows are staged in shared memory as fp32, pre-scaled,
//    and each lane keeps its hd/32 slice of them in registers;
//  * the loop runs over the live positions only, bounded by the frontier
//    and the window; the TPU kernel walked every table column and skipped
//    dead ones with pl.when;
//  * the pools are read in their own (n_blocks, bs, K, hd) layout through
//    strides, one vector load of hd/32 elements per lane per row; the TPU
//    wrapper's moveaxis + pad (kernel.py:103-112) would copy the whole pool
//    on every call and is not carried over;
//  * dot products are fp32 warp-shuffle reductions; each warp keeps its own
//    running max, denominator and accumulator over its positions, and the
//    warps are merged through shared memory in a fixed order, so the result
//    does not depend on scheduling;
//  * inactive rows (the whole table at scratch block 0, pos = 0) read one
//    garbage entry and their output is discarded by the caller.
// At 8 sequences and K = 1 only 8 blocks run on 132 SMs, so the kernel is
// far from its byte bound; splitting the positions of a sequence across
// blocks (flash-decoding) is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kUnroll = 2;     // positions a warp loads before computing
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

// EPL consecutive elements at p -> fp32.  p is aligned to EPL*sizeof(T)
// bytes (up to 16), which the wrapper checks.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[EPL]) {
  constexpr int kBytes = EPL * int(sizeof(T));
  constexpr int kWords = kBytes / 4;
  uint32_t w[kWords];
  if constexpr (kBytes % 16 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 x = __ldg(v + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_assert(kBytes == 4, "a row slice is 4, 8 or 16k bytes");
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ pos, T* __restrict__ o, int H,
                    int K, int bs, int nbmax, int n_blocks, long long ks_blk,
                    long long ks_off, long long ks_head, long long vs_blk,
                    long long vs_off, long long vs_head, int window,
                    float softcap, float scale) {
  constexpr int HD = 32 * EPL;
  __shared__ float q_s[kMaxG * HD];
  __shared__ float o_s[kMaxG * HD];
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];

  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int G = H / K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e0 = lane * EPL;

  const long long row0 = ((long long)b * H + (long long)kh * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads)
    q_s[i] = to_f32(q[row0 + i]) * scale;
  __syncthreads();

  float qr[kMaxG][EPL], acc[kMaxG][EPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = g < G ? q_s[g * HD + e0 + e] : 0.f;
      acc[g][e] = 0.f;
    }
  }

  const int p = pos[b];
  const int t_hi = min(p, nbmax * bs - 1);
  const int t_lo = window > 0 ? max(0, p - window + 1) : 0;
  const int* __restrict__ btb = bt + (long long)b * nbmax;

  for (int t0 = t_lo + warp * kUnroll; t0 <= t_hi; t0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t <= t_hi) {
        const int col = t / bs;
        int bid = btb[col];
        // an id outside the pool reads the scratch block, where the JAX
        // gather would clamp; the scheduler never writes such an id
        bid = (bid >= 0 && bid < n_blocks) ? bid : 0;
        const long long off = t - col * bs;
        load_row<T, EPL>(kp + bid * ks_blk + off * ks_off + kh * ks_head + e0,
                         kf[u]);
        load_row<T, EPL>(vp + bid * vs_blk + off * vs_off + kh * vs_head + e0,
                         vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u > t_hi) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kf[u][e], s);
        s = warp_sum(s);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * alpha + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(pr, vf[u][e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the warps: common max, rescale, then sum in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) m_s[warp][g] = m[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    const float a = expf(m[g] - mx);
    l[g] *= a;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] *= a;
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) l_s[warp][g] = l[g];
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float* dst = &o_s[g * HD + e0 + e];
          *dst = (w == 0 ? 0.f : *dst) + acc[g][e];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) den += l_s[w][g];
    store(o + row0 + i, o_s[i] / fmaxf(den, 1e-30f));
  }
}

template <typename T, int EPL>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* pos, void* o, int B, int H, int K, int bs, int nbmax,
           int n_blocks, long long ks_blk, long long ks_off, long long ks_head,
           long long vs_blk, long long vs_off, long long vs_head, int window,
           float softcap, float scale, cudaStream_t stream) {
  paged_decode_kernel<T, EPL><<<B * K, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), H, K, bs, nbmax,
      n_blocks, ks_blk, ks_off, ks_head, vs_blk, vs_off, vs_head, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kp, const void* vp,
              const int* bt, const int* pos, void* o, int B, int H, int K,
              int bs, int nbmax, int n_blocks, long long ks_blk,
              long long ks_off, long long ks_head, long long vs_blk,
              long long vs_off, long long vs_head, int window, float softcap,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 2>(q, kp, vp, bt, pos, o, B, H, K, bs, nbmax, n_blocks,
                          ks_blk, ks_off, ks_head, vs_blk, vs_off, vs_head,
                          window, softcap, scale, stream);
    case 128:
      return launch<T, 4>(q, kp, vp, bt, pos, o, B, H, K, bs, nbmax, n_blocks,
                          ks_blk, ks_off, ks_head, vs_blk, vs_off, vs_head,
                          window, softcap, scale, stream);
    case 256:
      return launch<T, 8>(q, kp, vp, bt, pos, o, B, H, K, bs, nbmax, n_blocks,
                          ks_blk, ks_off, ks_head, vs_blk, vs_off, vs_head,
                          window, softcap, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and o share it).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, void* o, int B, int H, int K, int hd, int bs, int nbmax,
    int n_blocks, long long ks_blk, long long ks_off, long long ks_head,
    long long vs_blk, long long vs_off, long long vs_head, int window,
    float softcap, float scale, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, kp, vp, bt, pos, o, B, H, K, bs, nbmax,
                            n_blocks, ks_blk, ks_off, ks_head, vs_blk, vs_off,
                            vs_head, window, softcap, scale, s);
  if (dtype == 1)
    return launch_hd<bf16_t>(hd, q, kp, vp, bt, pos, o, B, H, K, bs, nbmax,
                             n_blocks, ks_blk, ks_off, ks_head, vs_blk, vs_off,
                             vs_head, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
