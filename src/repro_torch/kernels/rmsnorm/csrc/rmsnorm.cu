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
// So x is read from device memory once, and every row's loads are issued
// before any of its arithmetic.
//
// Design:
//  * rows that 32 lanes hold in registers (up to 16 packs of 16 bytes a
//    lane: d up to 2048 fp32 or 4096 bf16; up to 32 single elements: d
//    up to 1024): one warp per row, 8 rows per 256-thread block, no
//    block-wide barrier.  The kernel is built for 4, 8 and 16 packs a
//    lane (8 and 32 elements) and a row takes the fewest that hold it,
//    so that a short row's registers leave room for more rows in flight.
//    Lane l holds packs l + 32 i of the row (so each warp-wide load is
//    contiguous), sums their squares in its own order (i, then the
//    pack's elements), and the warp adds the 32 lane sums by a fixed xor
//    tree; each level adds two equal operand pairs in both lanes, so
//    every lane ends with the same sum;
//  * wider rows (gemma2-27b's 4608, chameleon-34b's 8192): one 256-thread
//    block per row.  Thread t takes packs t + 256 i, keeps them in
//    dynamic shared memory as it sums their squares, and reads its own
//    packs back from there to write the output.  The warp sums meet in
//    shared memory and every thread adds the 8 in order.  A row wider
//    than shared memory (over 226 KB; no configuration has one) is read
//    again from device memory instead;
//  * a load moves a pack of 16 bytes (4 fp32 or 8 bf16) where d is a
//    multiple of it and x, o and scale are aligned to it; in bf16 8 bytes
//    (4 elements) where only that holds (d = 300); otherwise one element
//    (an x that starts 4 bytes into an allocation, d = 120,002).
// Each sum has a fixed order, so a result does not depend on scheduling.

#include "../../csrc/common.cuh"

namespace {

using repro::bf16_t;
using repro::from_f;
using repro::to_f;

constexpr int kThreads = 256;            // the block kernel's
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // the warp kernel's rows (warps) a block
constexpr int kMaxStaged = 226 * 1024;   // bytes of a staged row (a block
                                         // has 232,448 beside warp_sums)

// P elements of T moved as one aligned vector of 16 or 8 bytes (or one
// element)
template <typename T, int P>
struct alignas(sizeof(T) * P) Vec {
  T v[P];
};

template <typename T, int P>
__device__ __forceinline__ Vec<T, P> load_vec(const T* src) {
  return *reinterpret_cast<const Vec<T, P>*>(src);
}

// P scale elements as floats; loads of at most 16 bytes
template <typename TS, int P>
__device__ __forceinline__ void load_scale(const TS* src, float (&w)[P]) {
  constexpr int kPer = (P * sizeof(TS) > 16) ? 16 / sizeof(TS) : P;
#pragma unroll
  for (int c0 = 0; c0 < P; c0 += kPer) {
    const Vec<TS, kPer> s = load_vec<TS, kPer>(src + c0);
#pragma unroll
    for (int c = 0; c < kPer; ++c) w[c0 + c] = to_f(s.v[c]);
  }
}

template <typename T, typename TS, int P>
__device__ __forceinline__ void store_scaled(T* dst, const Vec<T, P>& x,
                                             const TS* scale, float inv) {
  float w[P];
  load_scale<TS, P>(scale, w);
  Vec<T, P> out;
#pragma unroll
  for (int c = 0; c < P; ++c)
    out.v[c] = from_f<T>(__fmul_rn(__fmul_rn(to_f(x.v[c]), inv), w[c]));
  *reinterpret_cast<Vec<T, P>*>(dst) = out;
}

template <typename T, int P>
__device__ __forceinline__ float add_squares(float s, const Vec<T, P>& x) {
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const float f = to_f(x.v[c]);
    s = __fadd_rn(s, __fmul_rn(f, f));
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

__device__ __forceinline__ float inv_rms(float total, int d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));
}

// one warp per row; lane l holds packs l + 32 i, i < NP, of P elements
template <typename T, typename TS, int P, int NP>
__global__ void __launch_bounds__(32 * kRows)
rmsnorm_warp_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ o, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int n_packs = d / P;
  const T* xr = x + row * d;
  Vec<T, P> xv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (p < n_packs) xv[i] = load_vec<T, P>(xr + p * P);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (lane + 32 * i < n_packs) s = add_squares<T, P>(s, xv[i]);
  const float inv = inv_rms(warp_sum(s), d, eps);
  T* orow = o + row * d;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (p < n_packs) store_scaled<T, TS, P>(orow + p * P, xv[i], scale + p * P, inv);
  }
}

// one block per row; the row staged in dynamic shared memory when
// `staged`, read again from device memory otherwise
template <typename T, typename TS, int P>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                     T* __restrict__ o, int d, float eps, int staged) {
  extern __shared__ float4 smem4[];
  __shared__ float warp_sums[kWarps];
  Vec<T, P>* row_s = reinterpret_cast<Vec<T, P>*>(smem4);
  const long long row = blockIdx.x;
  const int n_packs = d / P;
  const T* xr = x + row * d;
  float s = 0.f;
#pragma unroll 4
  for (int p = threadIdx.x; p < n_packs; p += kThreads) {
    const Vec<T, P> v = load_vec<T, P>(xr + p * P);
    if (staged) row_s[p] = v;
    s = add_squares<T, P>(s, v);
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = warp_sums[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, warp_sums[w]);
  const float inv = inv_rms(total, d, eps);
  T* orow = o + row * d;
  // each thread reads back only the packs it staged itself
#pragma unroll 4
  for (int p = threadIdx.x; p < n_packs; p += kThreads) {
    const Vec<T, P> v = staged ? row_s[p] : load_vec<T, P>(xr + p * P);
    store_scaled<T, TS, P>(orow + p * P, v, scale + p * P, inv);
  }
}

template <typename T, typename TS, int P, int NP>
int launch_warp(const T* x, const TS* scale, T* o, long long rows, int d,
                float eps, cudaStream_t s) {
  const long long blocks = (rows + kRows - 1) / kRows;
  rmsnorm_warp_kernel<T, TS, P, NP>
      <<<static_cast<unsigned>(blocks), 32 * kRows, 0, s>>>(x, scale, o, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS, int P>
int launch_block(const T* x, const TS* scale, T* o, long long rows, int d,
                 float eps, cudaStream_t s) {
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  const int staged = row_bytes <= kMaxStaged;
  const int smem = staged ? static_cast<int>(row_bytes) : 0;
  auto kernel = rmsnorm_block_kernel<T, TS, P>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(rows), kThreads, smem, s>>>(x, scale, o, d, eps, staged);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TS, int P>
int launch_pack(const T* x, const TS* scale, T* o, long long rows, int d,
                float eps, cudaStream_t s) {
  const int per_lane = (d / P + 31) / 32;
  if constexpr (P == 1) {
    if (per_lane <= 8) return launch_warp<T, TS, 1, 8>(x, scale, o, rows, d, eps, s);
    if (per_lane <= 32) return launch_warp<T, TS, 1, 32>(x, scale, o, rows, d, eps, s);
  } else {
    if (per_lane <= 4) return launch_warp<T, TS, P, 4>(x, scale, o, rows, d, eps, s);
    if (per_lane <= 8) return launch_warp<T, TS, P, 8>(x, scale, o, rows, d, eps, s);
    if (per_lane <= 16) return launch_warp<T, TS, P, 16>(x, scale, o, rows, d, eps, s);
  }
  return launch_block<T, TS, P>(x, scale, o, rows, d, eps, s);
}

// the warp kernel with the fewest packs a lane that hold the row (4, 8 or
// 16 packs; 8 or 32 single elements), so that a short row's registers
// leave room for more rows in flight; else the block kernel
template <typename T, typename TS>
int launch(const void* x, const void* scale, void* o, long long rows, int d,
           float eps, int pack, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const TS* st = static_cast<const TS*>(scale);
  T* ot = static_cast<T*>(o);
  if (pack == 16 / static_cast<int>(sizeof(T)))
    return launch_pack<T, TS, 16 / sizeof(T)>(xt, st, ot, rows, d, eps, s);
  if constexpr (sizeof(T) == 2)
    if (pack == 4) return launch_pack<T, TS, 4>(xt, st, ot, rows, d, eps, s);
  if (pack == 1) return launch_pack<T, TS, 1>(xt, st, ot, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype, scale_dtype: 0 = float32, 1 = bfloat16; o has x's type.  x and
// o are (rows, d) contiguous.  pack is the elements a load moves: 16 bytes
// (4 fp32, 8 bf16), 8 bytes (4 bf16) or 1; the wrapper picks the widest
// that d is a multiple of and that x, o and scale are aligned to.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_launch(int x_dtype, int scale_dtype, const void* x,
                              const void* scale, void* o, long long rows,
                              int d, float eps, int pack, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || pack <= 0 || d % pack)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, o, rows, d, eps, pack, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, bf16_t>(x, scale, o, rows, d, eps, pack, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<bf16_t, float>(x, scale, o, rows, d, eps, pack, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<bf16_t, bf16_t>(x, scale, o, rows, d, eps, pack, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
