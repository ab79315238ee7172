// Multi-tensor optimizer passes for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/multi_tensor/kernel.py:
//   chunk_sumsq   (kernel.py:156; pl.pallas_call at :170 raw, :176 decayed)
//   fused_update  (kernel.py:211; pl.pallas_call at :245)
//
// What they compute, over one flat bucket buffer of n elements viewed as
// (n / 1024, 1024) rows (n is a multiple of 65,536):
//   chunk_sumsq:  out[r] = sum_j x[r, j]^2, or of decay(x, p) when wd != 0
//   fused_update: ge = decay(g, p); u' = beta*u + a[r]*ge;
//                 o  = nesterov ? beta*u' + a[r]*ge : u';
//                 p' = (p - c*o) in p's type;  usq[r] = sum_j o[r, j]^2
//                 p and u are updated in place.
// decay(g, p) is g + wd*p with the plain version's roundings: for bf16 the
// product wd*p (wd already rounded to bf16 by the caller) rounds to bf16,
// and the sum rounds to bf16 before the cast to fp32 unless cast_g_first,
// where g is cast first and the sum is fp32.  wd == 0 reads g only.
//
// What bounds them on this card: bytes.  chunk_sumsq reads 1 or 2 elements
// and fused_update moves 5 (p, g, u read; p, u written) for a handful of
// flops each, far under the H100's flop/byte ridge.
//
// Design (simple and right first):
//  * one warp per 1024-element row, 8 rows per block; lane l loads 16
//    bytes at a time, elements e = k*32*V + l*V + c (V = 16 / sizeof(T)),
//    so each warp-wide load is 512 contiguous bytes;
//  * the row sum follows the plain version's pairwise halving exactly
//    (e + e+512, then +256, ... down to one value): the halvings over k
//    run inside a lane, the next five across lanes by shuffles, the last
//    ones inside lane 0 over c.  With __fmul_rn / __fadd_rn everywhere no
//    FMA contraction changes a bit, so kernel and plain version agree
//    bitwise;
//  * a row's elements are all loaded before any arithmetic, which keeps
//    32 x 16 bytes per lane and operand in flight.
// Making them faster (TMA bulk copies, several rows per warp in flight) is
// later work; PERF.md holds their times against the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16_t = __nv_bfloat16;

constexpr int kChunk = 1024;   // elements per row
constexpr int kWarps = 8;      // rows (warps) per block

enum Decay { kNone = 0, kCastFirst = 1, kCastAfter = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16_t x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16_t from_f<bf16_t>(float x) {
  return __float2bfloat16_rn(x);
}

// round to T and back: what a T-typed intermediate of the plain version does
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <typename T, int D>
__device__ __forceinline__ float decay(T g, T p, float wd) {
  const float gf = to_f(g);
  if (D == kNone) return gf;
  const float wp = round_to<T>(__fmul_rn(wd, to_f(p)));
  if (D == kCastFirst) return __fadd_rn(gf, wp);
  return round_to<T>(__fadd_rn(gf, wp));
}

// 16-byte-multiple vector copies between global memory and registers
template <int BYTES>
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  static_assert(BYTES % 16 == 0, "16-byte vectors");
#pragma unroll
  for (int i = 0; i < BYTES / 16; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// Sum of a 1024-element row held as s[k][c] by the 32 lanes of a warp, in
// the plain version's pairwise-halving order; the result is in lane 0.
template <int K, int V>
__device__ __forceinline__ float row_sum(float (&s)[K][V]) {
#pragma unroll
  for (int h = K / 2; h >= 1; h /= 2)
#pragma unroll
    for (int k = 0; k < h; ++k)
#pragma unroll
      for (int c = 0; c < V; ++c) s[k][c] = __fadd_rn(s[k][c], s[k + h][c]);
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
#pragma unroll
    for (int c = 0; c < V; ++c)
      s[0][c] = __fadd_rn(s[0][c], __shfl_down_sync(0xffffffffu, s[0][c], off));
#pragma unroll
  for (int h = V / 2; h >= 1; h /= 2)
#pragma unroll
    for (int c = 0; c < h; ++c) s[0][c] = __fadd_rn(s[0][c], s[0][c + h]);
  return s[0][0];
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
chunk_sumsq_kernel(const T* __restrict__ x, const T* __restrict__ p, float wd,
                   float* __restrict__ out, long long n_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int K = kChunk / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;                 // whole warps leave together
  const long long base = row * kChunk + lane * V;
  alignas(16) T xv[K][V];
  alignas(16) T pv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    copy16<sizeof(T) * V>(xv[k], x + base + k * 32 * V);
    if (D != kNone) copy16<sizeof(T) * V>(pv[k], p + base + k * 32 * V);
  }
  float s[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float v = D == kNone ? to_f(xv[k][c]) : decay<T, D>(xv[k][c], pv[k][c], wd);
      s[k][c] = __fmul_rn(v, v);
    }
  const float r = row_sum<K, V>(s);
  if (lane == 0) out[row] = r;
}

template <typename T, int D, bool NESTEROV>
__global__ void __launch_bounds__(32 * kWarps)
fused_update_kernel(T* __restrict__ p, const T* __restrict__ g,
                    float* __restrict__ u, const float* __restrict__ a,
                    float lr_c, float beta, float wd, float* __restrict__ usq,
                    long long n_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int K = kChunk / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long base = row * kChunk + lane * V;
  const float ar = a[row];
  alignas(16) T pv[K][V];
  alignas(16) T gv[K][V];
  alignas(16) float uv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    copy16<sizeof(T) * V>(pv[k], p + base + k * 32 * V);
    copy16<sizeof(T) * V>(gv[k], g + base + k * 32 * V);
    copy16<sizeof(float) * V>(uv[k], u + base + k * 32 * V);
  }
  float s[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float age = __fmul_rn(ar, decay<T, D>(gv[k][c], pv[k][c], wd));
      const float un = __fadd_rn(__fmul_rn(beta, uv[k][c]), age);
      const float o = NESTEROV ? __fadd_rn(__fmul_rn(beta, un), age) : un;
      uv[k][c] = un;
      pv[k][c] = from_f<T>(__fsub_rn(to_f(pv[k][c]), __fmul_rn(lr_c, o)));
      s[k][c] = __fmul_rn(o, o);
    }
    copy16<sizeof(T) * V>(p + base + k * 32 * V, pv[k]);
    copy16<sizeof(float) * V>(u + base + k * 32 * V, uv[k]);
  }
  const float r = row_sum<K, V>(s);
  if (lane == 0) usq[row] = r;
}

dim3 grid_for(long long n_rows) {
  return dim3(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
}

template <typename T>
int sumsq(const void* x, const void* p, float wd, float* out, long long n_rows,
          cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* pt = static_cast<const T*>(p);
  if (p == nullptr)
    chunk_sumsq_kernel<T, kNone><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
        xt, pt, wd, out, n_rows);
  else
    chunk_sumsq_kernel<T, kCastAfter><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
        xt, pt, wd, out, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool N>
int update(void* p, const void* g, float* u, const float* a, float lr_c,
           float beta, float wd, float* usq, long long n_rows, cudaStream_t s) {
  fused_update_kernel<T, D, N><<<grid_for(n_rows), 32 * kWarps, 0, s>>>(
      static_cast<T*>(p), static_cast<const T*>(g), u, a, lr_c, beta, wd, usq,
      n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int update_n(int nesterov, void* p, const void* g, float* u, const float* a,
             float lr_c, float beta, float wd, float* usq, long long n_rows,
             cudaStream_t s) {
  return nesterov ? update<T, D, true>(p, g, u, a, lr_c, beta, wd, usq, n_rows, s)
                  : update<T, D, false>(p, g, u, a, lr_c, beta, wd, usq, n_rows, s);
}

template <typename T>
int update_d(int decay_mode, int nesterov, void* p, const void* g, float* u,
             const float* a, float lr_c, float beta, float wd, float* usq,
             long long n_rows, cudaStream_t s) {
  switch (decay_mode) {
    case kNone:
      return update_n<T, kNone>(nesterov, p, g, u, a, lr_c, beta, wd, usq, n_rows, s);
    case kCastFirst:
      return update_n<T, kCastFirst>(nesterov, p, g, u, a, lr_c, beta, wd, usq, n_rows, s);
    case kCastAfter:
      return update_n<T, kCastAfter>(nesterov, p, g, u, a, lr_c, beta, wd, usq, n_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and p share it).  p == nullptr: the
// raw sum of squares of x; otherwise of decay(x, p) with cast_g_first off.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mt_chunk_sumsq(int dtype, const void* x, const void* p,
                              float wd, float* out, long long n_rows,
                              void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return sumsq<float>(x, p, wd, out, n_rows, s);
  if (dtype == 1) return sumsq<bf16_t>(x, p, wd, out, n_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype as above (p and g share it; u, a and usq are float32).
// decay_mode: 0 = wd off, 1 = cast g first, 2 = cast after the sum.
extern "C" int mt_fused_update(int dtype, void* p, const void* g, float* u,
                               const float* a, float lr_c, float beta,
                               float wd, int decay_mode, int nesterov,
                               float* usq, long long n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return update_d<float>(decay_mode, nesterov, p, g, u, a, lr_c, beta, wd, usq, n_rows, s);
  if (dtype == 1)
    return update_d<bf16_t>(decay_mode, nesterov, p, g, u, a, lr_c, beta, wd, usq, n_rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
