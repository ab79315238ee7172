// Per-leaf LARS passes for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_lars/kernel.py:
//   _sqnorm           (kernel.py:37; pl.pallas_call at :42), as lars_sqnorm
//   fused_lars_update (kernel.py:64; pl.pallas_call at :81), as lars_update
//
// What they compute, over one parameter tensor of any length n:
//   lars_sqnorm: out[r] = sum_j x[r*1024 + j]^2 for each 1024-element row r
//                (a ragged last row counts as zero-padded; n == 0 gives one
//                zero row).  The host folds the rows pairwise
//                (core/multi_tensor.py:_fold_sum), which is exactly the
//                port's leaf_sumsq, so the per-leaf trust ratio is bitwise
//                the plain path's.  The TPU kernel leaves the order of a
//                block's sum to XLA; against it this is a tolerance.
//   lars_update: v' = beta*v + lr_local*(g + wd*w);  w' = (w - v') in w's
//                type; w (fp32 or bf16) and v (fp32) updated in place.
//                lr_local = lr * trust ratio is a 0-d fp32 tensor on the
//                card, read through its pointer.  wd*w rounds to w's type
//                (wd arrives rounded to it), as JAX's weakly typed float;
//                wd == 0 still adds 0*w, as the reference does.
//
// What bounds them on this card: bytes.  lars_sqnorm reads each element
// once; lars_update moves w, g and v in and w and v out (20 bytes in fp32)
// for 6 flops.
//
// Design (simple and right first):
//  * lars_sqnorm: one warp per row, 16-byte vector loads where a whole
//    vector lies below n, guarded scalar loads on the ragged edge, the
//    row sum by the plain version's pairwise-halving tree
//    (../../csrc/common.cuh: row_sum);
//  * lars_update: elementwise, 4 elements a thread per vector load, 4
//    vectors a thread in flight, the n mod 4 tail on block 0;
//  * __fmul_rn / __fadd_rn everywhere: bitwise equal to the plain
//    versions (kernels/fused_lars/ref.py).

#include "../../csrc/common.cuh"

namespace {

using repro::bf16_t;
using repro::copy16;
using repro::from_f;
using repro::kChunk;
using repro::load_pack;
using repro::Pack;
using repro::store_pack;
using repro::round_to;
using repro::row_sum;
using repro::to_f;

constexpr int kWarps = 8;      // rows (warps) per block in lars_sqnorm
constexpr int kThreads = 256;  // lars_update
constexpr int kVec = 4;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
sqnorm_rows_kernel(const T* __restrict__ x, long long n,
                   float* __restrict__ out, long long n_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int K = kChunk / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;                 // whole warps leave together
  const long long base = row * kChunk + lane * V;
  alignas(16) T xv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long e = base + k * 32 * V;
    if (e + V <= n) {
      copy16<sizeof(T) * V>(xv[k], x + e);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) xv[k][c] = e + c < n ? x[e + c] : from_f<T>(0.0f);
    }
  }
  float s[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float f = to_f(xv[k][c]);
      s[k][c] = __fmul_rn(f, f);
    }
  const float r = row_sum<K, V>(s);
  if (lane == 0) out[row] = r;
}

template <typename TW, typename TG>
__device__ __forceinline__ void lars_one(TW& w, TG g, float& v, float a,
                                         float beta, float wd) {
  const float d = __fadd_rn(to_f(g), round_to<TW>(__fmul_rn(wd, to_f(w))));
  v = __fadd_rn(__fmul_rn(beta, v), __fmul_rn(a, d));
  w = from_f<TW>(__fsub_rn(to_f(w), v));
}

template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
lars_update_kernel(TW* __restrict__ w, const TG* __restrict__ g,
                   float* __restrict__ v, const float* __restrict__ lr_local,
                   float beta, float wd, long long n) {
  const float a = *lr_local;
  const long long n_vec = n / kVec;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  Pack<TW, kVec> wv[kUnroll];
  Pack<TG, kVec> gv[kUnroll];
  Pack<float, kVec> vv[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + j * kThreads;
    if (i < n_vec) {
      wv[j] = load_pack<TW, kVec>(w + i * kVec);
      gv[j] = load_pack<TG, kVec>(g + i * kVec);
      vv[j] = load_pack<float, kVec>(v + i * kVec);
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + j * kThreads;
    if (i < n_vec) {
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        lars_one(wv[j].v[c], gv[j].v[c], vv[j].v[c], a, beta, wd);
      store_pack(w + i * kVec, wv[j]);
      store_pack(v + i * kVec, vv[j]);
    }
  }
  const long long e = n_vec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && e < n) {
    TW we = w[e];
    float ve = v[e];
    lars_one(we, g[e], ve, a, beta, wd);
    w[e] = we;
    v[e] = ve;
  }
}

template <typename TW, typename TG>
int update(void* w, const void* g, float* v, const float* lr_local, float beta,
           float wd, long long n, cudaStream_t s) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long blocks = (n / kVec + per_block - 1) / per_block;
  lars_update_kernel<TW, TG><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                               kThreads, 0, s>>>(
      static_cast<TW*>(w), static_cast<const TG*>(g), v, lr_local, beta, wd, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  out holds n_rows = max(1, ceil(n /
// 1024)) float32 partials.  x 16-byte aligned.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int lars_sqnorm(int dtype, const void* x, long long n, float* out,
                           long long n_rows, void* stream) {
  if (n < 0 || n_rows <= 0 || n_rows * kChunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
  if (dtype == 0)
    sqnorm_rows_kernel<float><<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const float*>(x), n, out, n_rows);
  else if (dtype == 1)
    sqnorm_rows_kernel<bf16_t><<<grid, 32 * kWarps, 0, s>>>(
        static_cast<const bf16_t*>(x), n, out, n_rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// w_dtype, g_dtype as above; v and lr_local are float32.  w and v are
// updated in place.  All pointers 16-byte aligned (the wrapper checks).
extern "C" int lars_update(int w_dtype, int g_dtype, void* w, const void* g,
                           float* v, const float* lr_local, float beta,
                           float wd, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && g_dtype == 0)
    return update<float, float>(w, g, v, lr_local, beta, wd, n, s);
  if (w_dtype == 0 && g_dtype == 1)
    return update<float, bf16_t>(w, g, v, lr_local, beta, wd, n, s);
  if (w_dtype == 1 && g_dtype == 0)
    return update<bf16_t, float>(w, g, v, lr_local, beta, wd, n, s);
  if (w_dtype == 1 && g_dtype == 1)
    return update<bf16_t, bf16_t>(w, g, v, lr_local, beta, wd, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lars_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
