// Multi-tensor optimizer passes for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/multi_tensor/kernel.py:
//   chunk_sumsq   (kernel.py:156; pl.pallas_call at :170 raw, :176 decayed)
//   fused_update  (kernel.py:211; pl.pallas_call at :245)
//   scale_apply   (kernel.py:273; pl.pallas_call at :293)
//   adam_update   (kernel.py:340; pl.pallas_call at :366)
//
// What they compute, over one flat bucket buffer of n elements viewed as
// (n / 1024, 1024) rows (n is a multiple of 65,536):
//   chunk_sumsq:  out[r] = sum_j x[r, j]^2, or of decay(x, p) when wd != 0
//   fused_update: ge = decay(g, p); u' = beta*u + a[r]*ge;
//                 o  = nesterov ? beta*u' + a[r]*ge : u';
//                 p' = (p - c*o) in p's type;  usq[r] = sum_j o[r, j]^2
//                 p and u are updated in place.  The deferred-apply mode
//                 (kernel.py:199-205, :228-231, :243-244: apply=False, for
//                 a trailing clip that rescales the step before applying
//                 it) writes o in fp32 to a separate buffer instead of p';
//                 p is read only for the decay (not at all when wd == 0)
//                 and never written.
//   adam_update:  (LAMB pass 1) m' = b1*m + (1-b1)*g; v' = b2*v + (1-b2)*g^2;
//                 u = (m'/bc1) / (sqrt(v'/bc2) + eps) [+ wd*p];
//                 row sums of u^2, p^2 and g^2; m and v in place, u fresh.
//   scale_apply:  (LAMB pass 2) s = a[r]*u; p' = (p - c*s) in p's type;
//                 row sums of s^2; p in place.
// decay(g, p) is g + wd*p with the plain version's roundings: for bf16 the
// product wd*p (wd already rounded to bf16 by the caller) rounds to bf16,
// and the sum rounds to bf16 before the cast to fp32 unless cast_g_first,
// where g is cast first and the sum is fp32.  wd == 0 reads g only.
// adam_update's wd*p rounds to p's type too, then adds in fp32.
//
// What bounds them on this card: bytes.  chunk_sumsq reads 1 or 2 elements,
// fused_update moves 5 (p, g, u read; p, u written; deferred: p, g, u
// read, o, u written, p not read when wd == 0), adam_update 7 (p, g, m, v
// read; m, v, u written) and scale_apply 3 (p, u read; p written), for a
// handful of flops each, far under the H100's flop/byte ridge.
//
// Design (simple and right first):
//  * one warp per 1024-element row, 8 rows per block; lane l loads 16
//    bytes at a time, elements e = k*32*V + l*V + c (V = 16 / sizeof(T)),
//    so each warp-wide load is 512 contiguous bytes;
//  * the row sum follows the plain version's pairwise halving exactly
//    (../../csrc/common.cuh: row_sum).  With __fmul_rn / __fadd_rn /
//    __fdiv_rn / __fsqrt_rn everywhere no FMA contraction or fast division
//    changes a bit, so kernel and plain version agree bitwise;
//  * a row's elements are all loaded before any arithmetic, which keeps
//    32 x 16 bytes per lane and operand in flight.  adam_update reuses the
//    moments' registers for the u^2 and g^2 sums once they are stored.
// Making them faster (TMA bulk copies, several rows per warp in flight) is
// later work; PERF.md holds their times against the byte bound.

#include "../../csrc/common.cuh"

namespace {

using repro::bf16_t;
using repro::copy16;
using repro::from_f;
using repro::kChunk;
using repro::round_to;
using repro::row_sum;
using repro::to_f;

constexpr int kWarps = 8;      // rows (warps) per block

enum Decay { kNone = 0, kCastFirst = 1, kCastAfter = 2 };

// Vector width: lane l holds elements e = k*32*V + l*V + c of a row, with
// V set by the narrower of the two element types (16 bytes of it per load;
// the wider type then loads 32).  The row sum's pairing (column j with
// j + width/2) does not depend on V.
template <typename A, typename B>
constexpr int kVec = 16 / (sizeof(A) < sizeof(B) ? sizeof(A) : sizeof(B));

// decay(g, p) = g + wd*p with the plain version's roundings: wd*p in p's
// type, the sum in g's type (g is p's type or fp32, so that is the
// promoted type) unless cast_g_first.
template <typename TG, typename TP, int D>
__device__ __forceinline__ float decay(TG g, TP p, float wd) {
  const float gf = to_f(g);
  if (D == kNone) return gf;
  const float wp = round_to<TP>(__fmul_rn(wd, to_f(p)));
  if (D == kCastFirst) return __fadd_rn(gf, wp);
  return round_to<TG>(__fadd_rn(gf, wp));
}

template <typename TX, typename TP, int D>
__global__ void __launch_bounds__(32 * kWarps)
chunk_sumsq_kernel(const TX* __restrict__ x, const TP* __restrict__ p, float wd,
                   float* __restrict__ out, long long n_rows) {
  constexpr int V = kVec<TX, TP>;
  constexpr int K = kChunk / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;                 // whole warps leave together
  const long long base = row * kChunk + lane * V;
  alignas(16) TX xv[K][V];
  alignas(16) TP pv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    copy16<sizeof(TX) * V>(xv[k], x + base + k * 32 * V);
    if constexpr (D != kNone) copy16<sizeof(TP) * V>(pv[k], p + base + k * 32 * V);
  }
  float s[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float v;
      if constexpr (D == kNone) v = to_f(xv[k][c]);
      else v = decay<TX, TP, D>(xv[k][c], pv[k][c], wd);
      s[k][c] = __fmul_rn(v, v);
    }
  const float r = row_sum<K, V>(s);
  if (lane == 0) out[row] = r;
}

// APPLY == false is the deferred mode: o goes to `out` (fp32) and p is
// neither written nor, without decay, read.
template <typename TP, typename TG, int D, bool NESTEROV, bool APPLY>
__global__ void __launch_bounds__(32 * kWarps)
fused_update_kernel(TP* __restrict__ p, const TG* __restrict__ g,
                    float* __restrict__ u, const float* __restrict__ a,
                    float lr_c, float beta, float wd, float* __restrict__ out,
                    float* __restrict__ usq, long long n_rows) {
  constexpr int V = kVec<TP, TG>;
  constexpr int K = kChunk / (32 * V);
  constexpr bool READ_P = APPLY || D != kNone;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long base = row * kChunk + lane * V;
  const float ar = a[row];
  alignas(16) TP pv[K][V];
  alignas(16) TG gv[K][V];
  alignas(16) float uv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (READ_P) copy16<sizeof(TP) * V>(pv[k], p + base + k * 32 * V);
    copy16<sizeof(TG) * V>(gv[k], g + base + k * 32 * V);
    copy16<sizeof(float) * V>(uv[k], u + base + k * 32 * V);
  }
  float s[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    alignas(16) float ov[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float ge;
      if constexpr (READ_P) ge = decay<TG, TP, D>(gv[k][c], pv[k][c], wd);
      else ge = to_f(gv[k][c]);
      const float age = __fmul_rn(ar, ge);
      const float un = __fadd_rn(__fmul_rn(beta, uv[k][c]), age);
      const float o = NESTEROV ? __fadd_rn(__fmul_rn(beta, un), age) : un;
      uv[k][c] = un;
      if constexpr (APPLY)
        pv[k][c] = from_f<TP>(__fsub_rn(to_f(pv[k][c]), __fmul_rn(lr_c, o)));
      else
        ov[c] = o;
      s[k][c] = __fmul_rn(o, o);
    }
    if constexpr (APPLY)
      copy16<sizeof(TP) * V>(p + base + k * 32 * V, pv[k]);
    else
      copy16<sizeof(float) * V>(out + base + k * 32 * V, ov);
    copy16<sizeof(float) * V>(u + base + k * 32 * V, uv[k]);
  }
  const float r = row_sum<K, V>(s);
  if (lane == 0) usq[row] = r;
}

// LAMB pass 2: s = a[r]*g; p' = (p - c*s) in p's type; ssq[r] = sum_j s^2.
// g is the f32 direction adam_update wrote; p is updated in place.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
scale_apply_kernel(T* __restrict__ p, const float* __restrict__ g,
                   const float* __restrict__ a, float lr_c,
                   float* __restrict__ ssq, long long n_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int K = kChunk / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long base = row * kChunk + lane * V;
  const float ar = a[row];
  alignas(16) T pv[K][V];
  alignas(16) float gv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    copy16<sizeof(T) * V>(pv[k], p + base + k * 32 * V);
    copy16<sizeof(float) * V>(gv[k], g + base + k * 32 * V);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float sc = __fmul_rn(ar, gv[k][c]);
      pv[k][c] = from_f<T>(__fsub_rn(to_f(pv[k][c]), __fmul_rn(lr_c, sc)));
      gv[k][c] = __fmul_rn(sc, sc);
    }
    copy16<sizeof(T) * V>(p + base + k * 32 * V, pv[k]);
  }
  const float r = row_sum<K, V>(gv);
  if (lane == 0) ssq[row] = r;
}

struct AdamScalars {
  float bc1, bc2, b1, b2, omb1, omb2, eps, wd;   // omb = 1 - b, from the host
};

// LAMB pass 1: both f32 moments in place, the bias-corrected direction
//   u = (m'/bc1) / (sqrt(v'/bc2) + eps) [+ wd*p]
// into a fresh f32 buffer, and the row sums of u^2, p^2 and g^2.
template <typename TP, typename TG, bool WD>
__global__ void __launch_bounds__(32 * kWarps)
adam_update_kernel(const TP* __restrict__ p, const TG* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ u, float* __restrict__ usq,
                   float* __restrict__ psq, float* __restrict__ gsq,
                   AdamScalars sc, long long n_rows) {
  constexpr int V = kVec<TP, TG>;
  constexpr int K = kChunk / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long base = row * kChunk + lane * V;
  alignas(16) TP pv[K][V];
  alignas(16) TG gv[K][V];
  alignas(16) float mv[K][V];
  alignas(16) float vv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    copy16<sizeof(TP) * V>(pv[k], p + base + k * 32 * V);
    copy16<sizeof(TG) * V>(gv[k], g + base + k * 32 * V);
    copy16<sizeof(float) * V>(mv[k], m + base + k * 32 * V);
    copy16<sizeof(float) * V>(vv[k], v + base + k * 32 * V);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    alignas(16) float ut[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float g32 = to_f(gv[k][c]);
      const float g2 = __fmul_rn(g32, g32);
      const float mn = __fadd_rn(__fmul_rn(sc.b1, mv[k][c]), __fmul_rn(sc.omb1, g32));
      const float vn = __fadd_rn(__fmul_rn(sc.b2, vv[k][c]), __fmul_rn(sc.omb2, g2));
      float d = __fdiv_rn(__fdiv_rn(mn, sc.bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, sc.bc2)), sc.eps));
      if (WD) d = __fadd_rn(d, round_to<TP>(__fmul_rn(sc.wd, to_f(pv[k][c]))));
      mv[k][c] = mn;
      vv[k][c] = vn;
      ut[c] = d;
    }
    copy16<sizeof(float) * V>(m + base + k * 32 * V, mv[k]);
    copy16<sizeof(float) * V>(v + base + k * 32 * V, vv[k]);
    copy16<sizeof(float) * V>(u + base + k * 32 * V, ut);
    // the moments are stored: their registers now hold u^2 and g^2
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float g32 = to_f(gv[k][c]);
      mv[k][c] = __fmul_rn(ut[c], ut[c]);
      vv[k][c] = __fmul_rn(g32, g32);
    }
  }
  const float su = row_sum<K, V>(mv);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float pf = to_f(pv[k][c]);
      mv[k][c] = __fmul_rn(pf, pf);
    }
  const float sp = row_sum<K, V>(mv);
  const float sg = row_sum<K, V>(vv);
  if (lane == 0) {
    usq[row] = su;
    psq[row] = sp;
    gsq[row] = sg;
  }
}

dim3 grid_for(long long n_rows) {
  return dim3(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
}

// The type pairs the engine passes, as (p's, g's) codes: 0 float32,
// 1 bfloat16.  g is p's type, or fp32 where a chain stage before the
// engine promoted the update (a bf16 bucket then takes fp32 updates).
enum Pair { kF32 = 0, kBF16 = 1, kBF16F32 = 2, kBadPair = -1 };

Pair pair_of(int dtype, int gdtype) {
  if (dtype == 0 && gdtype == 0) return kF32;
  if (dtype == 1 && gdtype == 1) return kBF16;
  if (dtype == 1 && gdtype == 0) return kBF16F32;
  return kBadPair;
}

template <typename TX, typename TP>
int sumsq(const void* x, const void* p, float wd, float* out, long long n_rows,
          cudaStream_t s) {
  const TX* xt = static_cast<const TX*>(x);
  const TP* pt = static_cast<const TP*>(p);
  if (p == nullptr)
    chunk_sumsq_kernel<TX, TX, kNone><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
        xt, nullptr, wd, out, n_rows);
  else
    chunk_sumsq_kernel<TX, TP, kCastAfter><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
        xt, pt, wd, out, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TG, int D, bool N, bool A>
int update(void* p, const void* g, float* u, const float* a, float lr_c,
           float beta, float wd, float* out, float* usq, long long n_rows,
           cudaStream_t s) {
  fused_update_kernel<TP, TG, D, N, A><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), u, a, lr_c, beta, wd, out,
      usq, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, typename TG, int D, bool N>
int update_a(void* p, const void* g, float* u, const float* a, float lr_c,
             float beta, float wd, float* out, float* usq, long long n_rows,
             cudaStream_t s) {
  return out == nullptr
             ? update<TP, TG, D, N, true>(p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s)
             : update<TP, TG, D, N, false>(p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
}

template <typename TP, typename TG, int D>
int update_n(int nesterov, void* p, const void* g, float* u, const float* a,
             float lr_c, float beta, float wd, float* out, float* usq,
             long long n_rows, cudaStream_t s) {
  return nesterov
             ? update_a<TP, TG, D, true>(p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s)
             : update_a<TP, TG, D, false>(p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
}

template <typename TP, typename TG>
int update_d(int decay_mode, int nesterov, void* p, const void* g, float* u,
             const float* a, float lr_c, float beta, float wd, float* out,
             float* usq, long long n_rows, cudaStream_t s) {
  switch (decay_mode) {
    case kNone:
      return update_n<TP, TG, kNone>(nesterov, p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
    case kCastFirst:
      return update_n<TP, TG, kCastFirst>(nesterov, p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
    case kCastAfter:
      return update_n<TP, TG, kCastAfter>(nesterov, p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of x; pdtype that of p (x is p's type
// or fp32, as g is in mt_fused_update).  p == nullptr: the raw sum of
// squares of x; otherwise of decay(x, p) with cast_g_first off.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mt_chunk_sumsq(int dtype, int pdtype, const void* x,
                              const void* p, float wd, float* out,
                              long long n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p == nullptr ? pair_of(dtype, dtype) : pair_of(pdtype, dtype)) {
    case kF32: return sumsq<float, float>(x, p, wd, out, n_rows, s);
    case kBF16: return sumsq<bf16_t, bf16_t>(x, p, wd, out, n_rows, s);
    case kBF16F32: return sumsq<float, bf16_t>(x, p, wd, out, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype of p, gdtype of g as above (u, a, out and usq are float32).
// decay_mode: 0 = wd off, 1 = cast g first, 2 = cast after the sum.
// out == nullptr applies the step to p; otherwise the deferred mode writes
// the direction o to out and leaves p as it is.
extern "C" int mt_fused_update(int dtype, int gdtype, void* p, const void* g,
                               float* u, const float* a, float lr_c,
                               float beta, float wd, int decay_mode,
                               int nesterov, float* out, float* usq,
                               long long n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pair_of(dtype, gdtype)) {
    case kF32:
      return update_d<float, float>(decay_mode, nesterov, p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
    case kBF16:
      return update_d<bf16_t, bf16_t>(decay_mode, nesterov, p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
    case kBF16F32:
      return update_d<bf16_t, float>(decay_mode, nesterov, p, g, u, a, lr_c, beta, wd, out, usq, n_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above (p's; g, a and ssq are float32).  p is updated in place.
extern "C" int mt_scale_apply(int dtype, void* p, const float* g,
                              const float* a, float lr_c, float* ssq,
                              long long n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    scale_apply_kernel<float><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
        static_cast<float*>(p), g, a, lr_c, ssq, n_rows);
  else if (dtype == 1)
    scale_apply_kernel<bf16_t><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
        static_cast<bf16_t*>(p), g, a, lr_c, ssq, n_rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dtype of p, gdtype of g as above (m, v, u and the partials are
// float32).  m and v are updated in place; has_wd == 0 skips the decay term.
extern "C" int mt_adam_update(int dtype, int gdtype, const void* p,
                              const void* g, float* m, float* v, float* u,
                              float* usq, float* psq, float* gsq, float bc1,
                              float bc2, float b1, float b2, float omb1,
                              float omb2, float eps, float wd, int has_wd,
                              long long n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamScalars sc{bc1, bc2, b1, b2, omb1, omb2, eps, wd};
  const dim3 grid = grid_for(n_rows);
#define REPRO_ADAM(TP, TG, W)                                               \
  adam_update_kernel<TP, TG, W><<<grid, 32 * kWarps, 0, s>>>(              \
      static_cast<const TP*>(p), static_cast<const TG*>(g), m, v, u, usq,  \
      psq, gsq, sc, n_rows)
  switch (pair_of(dtype, gdtype)) {
    case kF32:
      if (has_wd) REPRO_ADAM(float, float, true); else REPRO_ADAM(float, float, false);
      break;
    case kBF16:
      if (has_wd) REPRO_ADAM(bf16_t, bf16_t, true); else REPRO_ADAM(bf16_t, bf16_t, false);
      break;
    case kBF16F32:
      if (has_wd) REPRO_ADAM(bf16_t, float, true); else REPRO_ADAM(bf16_t, float, false);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ADAM
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
