// Row RMSNorm for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py:28
// rmsnorm_pallas (pl.pallas_call at :42): for each row of d elements,
//   o = x * rsqrt(sum(x^2) / d + eps) * scale,
// in fp32 inside, with x and o in one type (fp32 or bf16) and scale fp32
// or bf16.  The TPU kernel pads the lanes to 128 and the rows to 8 and
// divides by the true d; this one guards its tails instead and never
// copies.
//
// What bounds it on this card: bytes.  A row reads d elements of x (and
// the scale, which stays in L1/L2) and writes d; about 4 flops an element.
//
// Design (simple and right first): one block of 256 threads per row.
// Each thread sums the squares of its strided elements in a fixed order,
// the warps reduce by a fixed xor-shuffle tree and warp 0 adds the eight
// warp sums in order, so the result does not depend on scheduling.  The
// second pass reads the row again (it is in L1/L2 by then) and writes
// it scaled.  Where d % 4 == 0 and the pointers allow it, both passes
// move 4 elements a thread per vector load; otherwise scalar loads (the
// tests use d = 300).

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

__device__ __forceinline__ float block_sum(float s, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sums[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, warp_sums[w]);
    warp_sums[kWarps] = t;
  }
  __syncthreads();
  return warp_sums[kWarps];
}

template <typename T, typename TS, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ o, int d, float eps) {
  __shared__ float warp_sums[kWarps + 1];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = o + row * d;
  float s = 0.f;
  if constexpr (kVec) {
    for (int i = threadIdx.x * 4; i < d; i += kThreads * 4) {
      const Pack<T, 4> v = load_pack<T, 4>(xr + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float f = to_f(v.v[c]);
        s = __fadd_rn(s, __fmul_rn(f, f));
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f(xr[i]);
      s = __fadd_rn(s, __fmul_rn(f, f));
    }
  }
  const float total = block_sum(s, warp_sums);
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));
  if constexpr (kVec) {
    for (int i = threadIdx.x * 4; i < d; i += kThreads * 4) {
      const Pack<T, 4> v = load_pack<T, 4>(xr + i);
      const Pack<TS, 4> w = load_pack<TS, 4>(scale + i);
      Pack<T, 4> out;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out.v[c] = from_f<T>(__fmul_rn(__fmul_rn(to_f(v.v[c]), inv), to_f(w.v[c])));
      store_pack(orow + i, out);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xr[i]), inv), to_f(scale[i])));
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* o, long long rows, int d,
           float eps, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const TS* st = static_cast<const TS*>(scale);
  T* ot = static_cast<T*>(o);
  if (vec)
    rmsnorm_kernel<T, TS, true><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
        xt, st, ot, d, eps);
  else
    rmsnorm_kernel<T, TS, false><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
        xt, st, ot, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype, scale_dtype: 0 = float32, 1 = bfloat16; o has x's type.  x and
// o are (rows, d) contiguous; vec != 0 asks for 4-wide vector loads (the
// wrapper sets it only where d % 4 == 0 and every pointer is aligned to 4
// elements).  Returns the cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_launch(int x_dtype, int scale_dtype, const void* x,
                              const void* scale, void* o, long long rows,
                              int d, float eps, int vec, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || (vec && d % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, o, rows, d, eps, vec, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, bf16_t>(x, scale, o, rows, d, eps, vec, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<bf16_t, float>(x, scale, o, rows, d, eps, vec, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<bf16_t, bf16_t>(x, scale, o, rows, d, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
