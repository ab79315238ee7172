// Device helpers shared by the port's optimizer kernels (sm_90a).
//
//  * to_f / from_f / round_to: fp32 and bf16 conversions with the plain
//    PyTorch versions' roundings (round to nearest even);
//  * copy16, Pack: vector copies between global memory and registers;
//  * row_sum: the sum of a 1024-element row held by the 32 lanes of a
//    warp, in the plain versions' pairwise-halving order
//    (``kernels/multi_tensor/ref.py:row_sum``: column j adds column
//    j + width/2 until one is left).  Lane l holds elements
//    e = k*32*V + l*V + c as s[k][c]; the halvings over k run inside a
//    lane, the next five across lanes by shuffles, the last ones inside
//    lane 0 over c.  Every add is __fadd_rn, so no contraction moves a
//    bit against the plain version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

using bf16_t = __nv_bfloat16;

constexpr int kChunk = 1024;   // elements per row

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

template <int BYTES>
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  static_assert(BYTES % 16 == 0, "16-byte vectors");
#pragma unroll
  for (int i = 0; i < BYTES / 16; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// N elements of T as one aligned vector, moved by one 16- or 8-byte load
// or store (load_pack / store_pack)
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* src) {
  static_assert(sizeof(T) * N == 16 || sizeof(T) * N == 8, "8 or 16 bytes");
  Pack<T, N> out;
  if constexpr (sizeof(T) * N == 16)
    *reinterpret_cast<uint4*>(&out) = *reinterpret_cast<const uint4*>(src);
  else
    *reinterpret_cast<uint2*>(&out) = *reinterpret_cast<const uint2*>(src);
  return out;
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* dst, const Pack<T, N>& x) {
  if constexpr (sizeof(T) * N == 16)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&x);
  else
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(&x);
}

// Sum of a 1024-element row held as s[k][c] by the 32 lanes of a warp;
// the result is in lane 0.  s is overwritten.
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

}  // namespace repro
