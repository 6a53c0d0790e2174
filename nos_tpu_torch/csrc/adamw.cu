// The adamw update of one parameter leaf, in optax's order of operations,
// hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU for nos_tpu/train/optim.py's
// optax.adamw (scale_by_adam -> add_decayed_weights -> scale by -lr ->
// apply_updates). Per element, in the leaf's dtype T (f32 or bf16), each
// step rounded to T as the reference's ops are (its constants, too, are
// values of T, rounded by the host):
//
//   mu  = (1 - b1) g + b1 mu               nu  = (1 - b2) g g + b2 nu
//   mh  = mu / bc1                          nh  = nu / bc2
//   u   = mh / (sqrt(nh) + eps)             u   = u + wd p
//   u   = step u  (step = -lr)              p   = p + u
//
// with bc = 1 - b^count from the host. The products, sums, quotients and
// the square root are IEEE operations rounded to nearest (the __f*_rn
// intrinsics: no contraction into FMAs), each then rounded to T, so a
// bf16 leaf takes the same bits as the plain version's eager bf16 ops.
//
// Bound: HBM bytes. It reads p, g, mu, nu and writes p, mu, nu once: 7
// words per element, ~20 flops, far under the card's balance point. A
// grid-stride loop moves 16 bytes per load and store where the leaf's
// size allows (8 bf16 or 4 f32 lanes), one element at a time for the
// tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Consts {
  float c1, b1, c2, b2, bc1, bc2, eps, wd, step;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 result to T and back: the rounding T's own op makes
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ void update(T& p, T g, T& mu, T& nu,
                                       const Consts& c) {
  const float gf = to_f(g), pf = to_f(p);
  const float m = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(c.c1, gf)),
                                   rnd<T>(__fmul_rn(c.b1, to_f(mu)))));
  const float g2 = rnd<T>(__fmul_rn(gf, gf));
  const float v = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(c.c2, g2)),
                                   rnd<T>(__fmul_rn(c.b2, to_f(nu)))));
  const float mh = rnd<T>(__fdiv_rn(m, c.bc1));
  const float nh = rnd<T>(__fdiv_rn(v, c.bc2));
  const float den = rnd<T>(__fadd_rn(rnd<T>(__fsqrt_rn(nh)), c.eps));
  float u = rnd<T>(__fdiv_rn(mh, den));
  u = rnd<T>(__fadd_rn(u, rnd<T>(__fmul_rn(c.wd, pf))));
  u = rnd<T>(__fmul_rn(c.step, u));
  p = from_f<T>(__fadd_rn(pf, u));
  mu = from_f<T>(m);
  nu = from_f<T>(v);
}

// 16 bytes of T
template <typename T>
struct alignas(16) Vec {
  T x[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(256) adamw_kernel(
    T* __restrict__ p, const T* __restrict__ g, T* __restrict__ mu,
    T* __restrict__ nu, int64_t n, Consts c) {
  constexpr int kLanes = 16 / sizeof(T);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = n / kLanes;
  for (int64_t i = tid; i < n_vec; i += stride) {
    Vec<T> pv = reinterpret_cast<Vec<T>*>(p)[i];
    const Vec<T> gv = reinterpret_cast<const Vec<T>*>(g)[i];
    Vec<T> mv = reinterpret_cast<Vec<T>*>(mu)[i];
    Vec<T> nv = reinterpret_cast<Vec<T>*>(nu)[i];
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      update(pv.x[j], gv.x[j], mv.x[j], nv.x[j], c);
    reinterpret_cast<Vec<T>*>(p)[i] = pv;
    reinterpret_cast<Vec<T>*>(mu)[i] = mv;
    reinterpret_cast<Vec<T>*>(nu)[i] = nv;
  }
  for (int64_t i = n_vec * kLanes + tid; i < n; i += stride) {
    update(p[i], g[i], mu[i], nu[i], c);
  }
}

template <typename T>
int launch(void* p, const void* g, void* mu, void* nu, int64_t n,
           const Consts& c, int sms, cudaStream_t st) {
  constexpr int kThreads = 256;
  constexpr int kLanes = 16 / sizeof(T);
  const int64_t want = (n / kLanes + kThreads - 1) / kThreads;
  const int blocks = int(want < 8 * sms ? (want > 0 ? want : 1) : 8 * sms);
  adamw_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(mu),
      static_cast<T*>(nu), n, c);
  return int(cudaGetLastError());
}

}  // namespace

// p, g, mu, nu: contiguous, 16-byte aligned, n < 2^31 elements of one
// dtype (0 f32, 1 bf16); the constants are values of that dtype.
extern "C" int nos_adamw(void* p, const void* g, void* mu, void* nu,
                         int n, int dtype, float c1, float b1, float c2,
                         float b2, float bc1, float bc2, float eps, float wd,
                         float step, int sms, void* stream) {
  const Consts c{c1, b1, c2, b2, bc1, bc2, eps, wd, step};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(p, g, mu, nu, n, c, sms, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(p, g, mu, nu, n, c, sms, st);
  return int(cudaErrorInvalidValue);
}
