// Per-leaf SNGM update for NVIDIA Hopper (sm_90a), in CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_sngm/kernel.py:41
// fused_sngm_update (pl.pallas_call at :55): over one parameter tensor of
// any length n,
//   u' = beta*u + g*inv_norm;   p' = (p - lr*u') in p's type,
// with p (fp32 or bf16) and u (fp32) updated in place and g (fp32 or bf16)
// read.  inv_norm = 1/(||g_decayed|| + eps) is a 0-d fp32 tensor on the
// card, read through its pointer, so the step never waits for the host.
// The TPU kernel returns fp32 params for a bf16 leaf; this one writes the
// leaf back in its own type (the port keeps each leaf's dtype).
//
// What bounds it on this card: bytes.  Each element moves p, g and u in
// and p and u out (20 bytes in fp32) for 4 flops.
//
// Design (simple and right first): elementwise, 4 elements a thread per
// vector load (16 bytes of fp32), 4 vectors a thread all loaded before
// any arithmetic; the n mod 4 tail elements go to the first threads of
// block 0.  No padding copy: the TPU wrapper pads each leaf to 32,768
// elements, this kernel guards the tail instead.  Every multiply and add
// is __fmul_rn / __fadd_rn, so no FMA contraction moves a bit against
// the plain version (kernels/fused_sngm/ref.py).

#include "../../csrc/common.cuh"

namespace {

using repro::bf16_t;
using repro::from_f;
using repro::load_pack;
using repro::Pack;
using repro::store_pack;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kUnroll = 4;

template <typename TP, typename TG>
__device__ __forceinline__ void sngm_one(TP& p, TG g, float& u, float inv,
                                         float lr, float beta) {
  u = __fadd_rn(__fmul_rn(beta, u), __fmul_rn(to_f(g), inv));
  p = from_f<TP>(__fsub_rn(to_f(p), __fmul_rn(lr, u)));
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
sngm_update_kernel(TP* __restrict__ p, const TG* __restrict__ g,
                   float* __restrict__ u, const float* __restrict__ inv_norm,
                   float lr, float beta, long long n) {
  const float inv = *inv_norm;
  const long long n_vec = n / kVec;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  Pack<TP, kVec> pv[kUnroll];
  Pack<TG, kVec> gv[kUnroll];
  Pack<float, kVec> uv[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + j * kThreads;
    if (i < n_vec) {
      pv[j] = load_pack<TP, kVec>(p + i * kVec);
      gv[j] = load_pack<TG, kVec>(g + i * kVec);
      uv[j] = load_pack<float, kVec>(u + i * kVec);
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = first + j * kThreads;
    if (i < n_vec) {
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        sngm_one(pv[j].v[c], gv[j].v[c], uv[j].v[c], inv, lr, beta);
      store_pack(p + i * kVec, pv[j]);
      store_pack(u + i * kVec, uv[j]);
    }
  }
  const long long e = n_vec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && e < n) {
    TP pe = p[e];
    float ue = u[e];
    sngm_one(pe, g[e], ue, inv, lr, beta);
    p[e] = pe;
    u[e] = ue;
  }
}

template <typename TP, typename TG>
int launch(void* p, const void* g, float* u, const float* inv_norm, float lr,
           float beta, long long n, cudaStream_t s) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long blocks = (n / kVec + per_block - 1) / per_block;
  sngm_update_kernel<TP, TG><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                               kThreads, 0, s>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), u, inv_norm, lr, beta, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p_dtype, g_dtype: 0 = float32, 1 = bfloat16; u and inv_norm are float32.
// p and u are updated in place.  All pointers 16-byte aligned (the wrapper
// checks).  Returns the cudaError_t of the launch (0 on success).
extern "C" int sngm_update(int p_dtype, int g_dtype, void* p, const void* g,
                           float* u, const float* inv_norm, float lr,
                           float beta, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && g_dtype == 0)
    return launch<float, float>(p, g, u, inv_norm, lr, beta, n, s);
  if (p_dtype == 0 && g_dtype == 1)
    return launch<float, bf16_t>(p, g, u, inv_norm, lr, beta, n, s);
  if (p_dtype == 1 && g_dtype == 0)
    return launch<bf16_t, float>(p, g, u, inv_norm, lr, beta, n, s);
  if (p_dtype == 1 && g_dtype == 1)
    return launch<bf16_t, bf16_t>(p, g, u, inv_norm, lr, beta, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sngm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
