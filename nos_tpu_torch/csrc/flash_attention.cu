// Causal / full GQA flash attention for Hopper (sm_90a), forward and
// backward, hand-written CUDA C++.
//
// Replaces the two TPU kernels that nos_tpu/ops/attention.py::attention
// dispatches: splash attention (_splash_attention -> _splash_kernel_cached,
// GQA grouped in the kernel, fused dq+dkv backward, logsumexp residual
// "attn_residuals") and the legacy Pallas flash kernel (_pallas_flash with
// _block_sizes). Both compute softmax(scale * Q K^T [+ mask]) V over
// q [B, H, Sq, D] and k/v [B, Hkv, Sk, D], query head h reading kv head
// h / (H / Hkv). The causal mask is bottom-right aligned (key j is seen by
// query i when j <= i + Sk - Sq), as xla_attention's tril(.., Sk - Sq);
// the wrapper requires Sq <= Sk under it, so every query row sees key 0.
// The scale multiplies the f32 scores (flash and xla_attention do so;
// splash pre-scales q in q's dtype instead, a bf16 rounding apart).
//
// Four launches, one C entry each:
//   forward                O (q's dtype) and LSE (f32 [B, H, Sq]) per
//                          (Q tile, head, b), over K/V tiles; bf16:
//                          flash_fwd_wgmma_kernel (persistent), f32:
//                          flash_fwd_kernel (a block per Q tile);
//   flash_bwd_pre_kernel   delta = rowsum(dO * O), f32 [B, H, Sq];
//   dK/dV                  one block per (K tile, kv head, b): loops over
//                          the g query heads of its group and over the Q
//                          tiles from the causal diagonal on, so the GQA
//                          sum stays in the block (no atomics, the same
//                          bits every run); bf16: flash_bwd_dkdv_wgmma_-
//                          kernel, f32: flash_bwd_dkdv_kernel;
//   dQ                     one block per (Q tile, head, b), over K tiles;
//                          bf16: flash_bwd_dq_wgmma_kernel, f32:
//                          flash_bwd_dq_kernel.
// Every kernel name keeps "flash_fwd" or "flash_bwd": profiles group by
// those substrings (and would book an "sm90_" name as a GEMM).
//
// Bound: operations. At the training shape (S 2048, D 128) attention does
// ~2 * S * D flops per K/V byte read, far above the card's ~295 flops per
// byte balance point, so the tensor-core rate decides.
//
// f32: scalar tiled kernels. The TPU grids walked the KV axis in order
// with the softmax state in VMEM scratch; here a loop inside each block
// walks it, with the running max / sum in shared memory. Tiles of Q, K, V
// (and dO) are staged in shared memory and every tile product runs scalar
// f32 FMAs (never TF32), so an f32 call differs from the plain version
// only in summation order. Accumulators live in f32 shared memory. Masked
// scores are -FLT_MAX with an explicit zero probability (never -inf,
// which turns exp(m_prev - m_new) into NaN). Ragged tails load as zero
// rows and are masked by index.
//
// bf16: FlashAttention-3's forward, and its backward kept as two kernels.
// Three warpgroups per block: a producer warp issues TMA loads into a
// two-stage ring of shared-memory stages guarded by full/empty mbarriers;
// two consumer warpgroups each own 64 rows of a 128-row tile (queries for
// the forward and dQ, keys for dK/dV) and run wgmma with their
// accumulators in registers for the whole tile; setmaxnreg moves
// registers from the producer (24) to the consumers (240). A product whose
// A operand was computed in registers (P, dS) runs in the RS form, packed
// to bf16 straight from the accumulator registers that computed it. Only
// tiles on the causal diagonal or the ragged edge test each element. The
// longest causal walks are taken first.
//   Forward (persistent: one block per SM walks its share of the (Q tile,
//   head, batch) list, and its ring runs on from one tile into the
//   next): Q resident; K and V stream in 128-key stages with their own
//   full and empty barriers, so S = Q K^T starts as soon as K has landed
//   and K's slot refills while V is still being read. S (64 x 128 a
//   warpgroup, m64n128k16 SS) -> online softmax in registers (a thread
//   owns two rows, reduced over its quad of lanes; the running max in
//   log2 units with scale * log2(e) folded in; exp2 on the SFU with
//   subnormals flushed; O rescaled by alpha = exp2(m_old - m_new)) -> P
//   packed to bf16 -> O += P V (RS, V read MN-major). Ping-pong
//   (FlashAttention-3's): the two warpgroups take turns on a pair of
//   named barriers, each turn issuing one warpgroup's P V of step j - 1
//   together with its S of step j, so one's exponentials run while the
//   other's products do. After its last S a warpgroup frees the Q
//   buffer, and the producer loads the next tile's Q; at the tile's end
//   O / l goes to bf16 in the warpgroup's rows of an O buffer, in the
//   swizzled box layout, and out by TMA in whole lines while the next
//   tile's loads land.
//   Backward: dK/dV keeps its K and V tile resident and streams (Q, dO,
//   lse, delta) across the group's heads; dQ keeps Q and dO resident and
//   streams (K, V); S and dP as m64n64k16 SS products, then P and dS in
//   registers, then dV, dK or dQ in the RS form; one block per tile.
// P (and dS) round to bf16 before their products. The plain version
// rounds the forward's normalised P to bf16 and keeps the backward's in
// f32; chip_smoke.py's pins allow for both.
//
// Where the bf16 kernels could go wrong, and what they do:
//  1. TMA maps over ctypes: cuTensorMapEncodeTiled comes from the runtime's
//     driver entry-point table inside the C entry (no -lcuda); the maps
//     are kernel parameters (__grid_constant__), encoded 3-D [B*H, S, D]
//     so the box past a ragged S zero-fills instead of reading the next
//     head's rows (and a store past Sq is clipped). A map that cannot be
//     built is cudaErrorNotSupported.
//  2. Swizzle: with SWIZZLE_128B a box is at most 64 bf16 wide, so a
//     D = 128 tile is two boxes; the descriptors' offsets follow
//     sm90.cuh (MN-major: leading = the distance between boxes, stride =
//     1024 bytes; K-major: stride 1024), checked product by product; the
//     forward's epilogue writes O in the same swizzle the store reads.
//  3. The RS operand: the m64nN accumulator fragment, packed in pairs, is
//     the A fragment of the next k16 steps (sm90.cuh); the registers are
//     pinned across each asynchronous product, and a register rescaled
//     between two products is pinned before the wgmma fence.
//  4. Masking: a masked or out-of-range (query, key) pair gives an
//     explicit zero probability; rows past Sq are computed but never
//     stored (the backward loads their lse and delta as 0). The forward's
//     running max starts at -FLT_MAX and is finite after the first tile
//     (every row sees key 0), so nothing subtracts -inf. It is taken on
//     the scaled scores, so a scale of either sign works.
//  5. Ping-pong: each consumer warpgroup syncs on its own named barrier
//     before issuing and arrives on the other's after. The first turn is
//     the first warpgroup's (it arrives on its own barrier once), both
//     take steps + 1 turns a tile (a warpgroup whose rows end a step
//     early takes an empty last turn), and the second warpgroup's very
//     last turn arrives nowhere, so no barrier is left part-way.
//  6. Ring phases across tiles: the producer and the consumers count ring
//     steps over the block's tiles, so a stage's parity carries on from
//     one tile into the next; Q and its full/empty pair flip once a tile.
//  7. Profile names: see above.
//  8. Rebuild key: the library's name hashes sm90.cuh too (_kernels.py).
//  9. Build time: raw PTX helpers, no CuTe; the library builds in seconds.
//
// Measured on the card and not kept (PERF.md): the same kernel without
// ping-pong (slower in every paired run), FlashAttention-3's intra-
// warpgroup overlap (waiting only for S, so the exponentials also run
// under the warpgroup's own P V), a third ring stage, and a pair of heads
// in a cluster sharing their K/V loads by multicast. What the bf16 kernels
// leave for later: the backward runs one block per tile (no persistent
// grid), its epilogues store from the fragments, and its consumers wait
// for their S and dP before the exponentials.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;                     // keys per K/V tile (f32)

enum DType { kF32 = 0, kBF16 = 1 };

// Row padding of the f32 kernels' shared-memory tiles, in floats: input
// tiles by 1 and accumulator tiles by 4, to spread rows over banks.
constexpr int kPad = 1;
constexpr int kPadF = 4;

constexpr size_t up128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// C[M x N] (+)= A' B' over shared-memory tiles, C f32 row-major. A'(m, k)
// is A[k * lda + m] when kTA, else A[m * lda + k]; B'(k, n) is
// B[n * ldb + k] when kTB, else B[k * ldb + n]. Called by all threads.
template <bool kTA, bool kTB, bool kAcc, int M, int N, int K>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A,
                                   int lda, const float* B, int ldb) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    float s = kAcc ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = kTA ? A[k * lda + m] : A[m * lda + k];
      const float b = kTB ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// Rows [r0, r0 + rows) of a row-major [S, D] matrix into a tile with row
// stride ld; rows at or past S load as zeros. 16-byte global loads.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int r0, int S,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      u = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    dst[r * ld + c] = u.x;
    dst[r * ld + c + 1] = u.y;
    dst[r * ld + c + 2] = u.z;
    dst[r * ld + c + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void zero_f32(float* dst, int ld, int rows) {
  for (int i = threadIdx.x; i < rows * N; i += kThreads)
    dst[(i / N) * ld + i % N] = 0.f;
}

// ----------------------------------------------------------- f32 forward

template <int D>
struct FwdLayout {
  static constexpr int kM = 64;             // query rows per block
  static constexpr int ldT = D + kPad, ldP = kBN + kPad;
  static constexpr int ldS = kBN + kPadF, ldO = D + kPadF;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + up128(4 * kM * ldT);
  static constexpr size_t v = k + up128(4 * kBN * ldT);
  static constexpr size_t s = v + up128(4 * kBN * ldT);
  static constexpr size_t p = s + up128(4 * kM * ldS);
  static constexpr size_t o = p + up128(4 * kM * ldP);
  static constexpr size_t row = o + up128(4 * kM * ldO);   // m, l, alpha
  static constexpr size_t bytes = row + up128(4 * 3 * kM);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 float scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int kM = L::kM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  float* k_s = reinterpret_cast<float*>(smem + L::k);
  float* v_s = reinterpret_cast<float*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* p_s = reinterpret_cast<float*>(smem + L::p);
  float* o_s = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::row);
  float* l_s = m_s + kM;
  float* a_s = l_s + kM;

  const int q0 = blockIdx.x * kM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int off = Sk - Sq;                  // bottom-right causal offset
  const size_t qrow = ((size_t)b * H + h) * Sq;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_rows<D>(q_s, L::ldT, q + qrow * D, q0, Sq, kM);
  zero_f32<D>(o_s, L::ldO, kM);
  if (threadIdx.x < kM) {
    m_s[threadIdx.x] = -FLT_MAX;
    l_s[threadIdx.x] = 0.f;
  }
  // the last row of this tile sees keys up to q0 + kM - 1 + off
  const int kv_end = causal ? min(Sk, q0 + kM + off) : Sk;

  // softmax work split: 4 threads per query row, 16 columns each
  const int sr = threadIdx.x / 4, sp = threadIdx.x % 4;
  const int lim = causal ? q0 + sr + off : INT32_MAX;

  for (int k0 = 0; k0 < kv_end; k0 += kBN) {
    __syncthreads();                        // previous tile consumed
    load_rows<D>(k_s, L::ldT, kb, k0, Sk, kBN);
    load_rows<D>(v_s, L::ldT, vb, k0, Sk, kBN);
    __syncthreads();
    mm<false, true, false, kM, kBN, D>(s_s, L::ldS, q_s, L::ldT, k_s,
                                       L::ldT);
    __syncthreads();
    {
      float sv[kBN / 4];
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) {
        const int c = sp + 4 * j, kj = k0 + c;
        const bool ok = kj < Sk && kj <= lim;
        sv[j] = ok ? s_s[sr * L::ldS + c] * scale : -FLT_MAX;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[sr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) {
        const int c = sp + 4 * j, kj = k0 + c;
        const bool ok = kj < Sk && kj <= lim;
        const float pv = ok ? expf(sv[j] - m_new) : 0.f;
        p_s[sr * L::ldP + c] = pv;
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sp == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[sr] = alpha * l_s[sr] + sum;
        m_s[sr] = m_new;
        a_s[sr] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kM * D; i += kThreads)
      o_s[(i / D) * L::ldO + i % D] *= a_s[i / D];
    __syncthreads();
    mm<false, false, true, kM, D, kBN>(o_s, L::ldO, p_s, L::ldP, v_s,
                                       L::ldT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq)
      out[(qrow + q0 + r) * D + c] = o_s[r * L::ldO + c] / l_s[r];
  }
  if (threadIdx.x < kM && q0 + (int)threadIdx.x < Sq)
    lse[qrow + q0 + threadIdx.x] =
        m_s[threadIdx.x] + logf(l_s[threadIdx.x]);
}

// ---------------------------------------------------------- f32 backward

// delta[row] = sum_d dO[row, d] * O[row, d], one warp per row (f32 and
// bf16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                  // whole warps leave together
  const T* a = o + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(a[d]), to_f32(g[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Query rows per inner tile of the f32 backward (the dK/dV block must
// stay under 227 KB).
constexpr int kBwdM = 32;

template <int D>
struct DkdvLayout {
  static constexpr int kM = kBwdM;
  static constexpr int ldT = D + kPad, ldP = kBN + kPad;
  static constexpr int ldS = kBN + kPadF, ldA = D + kPadF;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + up128(4 * kBN * ldT);
  static constexpr size_t q = v + up128(4 * kBN * ldT);
  static constexpr size_t g = q + up128(4 * kM * ldT);            // dO
  static constexpr size_t s = g + up128(4 * kM * ldT);
  static constexpr size_t dp = s + up128(4 * kM * ldS);
  static constexpr size_t p = dp + up128(4 * kM * ldS);
  static constexpr size_t ds = p + up128(4 * kM * ldP);
  static constexpr size_t dk = ds + up128(4 * kM * ldP);
  static constexpr size_t dv = dk + up128(4 * kBN * ldA);
  static constexpr size_t row = dv + up128(4 * kBN * ldA);        // lse, delta
  static constexpr size_t bytes = row + up128(4 * 2 * kM);
};

// Probabilities and score gradients of one (Q tile, K tile) pair from the
// staged scores S and dP: p = exp(scale * s - lse), zero where masked;
// ds = p * (dp - delta).
template <int kM>
__device__ __forceinline__ void bwd_probs(const float* s_s,
                                          const float* dp_s, int ldS,
                                          float* p_s, float* ds_s, int ldP,
                                          const float* lse_s,
                                          const float* dl_s, int q0, int k0,
                                          int Sq, int Sk, int off, int causal,
                                          float scale) {
  for (int i = threadIdx.x; i < kM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int qi = q0 + r, kj = k0 + c;
    const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi + off);
    const float pv = ok ? expf(s_s[r * ldS + c] * scale - lse_s[r]) : 0.f;
    if (p_s != nullptr) p_s[r * ldP + c] = pv;
    ds_s[r * ldP + c] = pv * (dp_s[r * ldS + c] - dl_s[r]);
  }
}

template <int kM>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int Sq) {
  if (threadIdx.x < kM) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < Sq ? lse[qi] : 0.f;
    dl_s[threadIdx.x] = qi < Sq ? delta[qi] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                      float scale, int causal) {
  using L = DkdvLayout<D>;
  constexpr int kM = L::kM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem + L::k);
  float* v_s = reinterpret_cast<float*>(smem + L::v);
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  float* g_s = reinterpret_cast<float*>(smem + L::g);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  float* p_s = reinterpret_cast<float*>(smem + L::p);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds);
  float* dk_s = reinterpret_cast<float*>(smem + L::dk);
  float* dv_s = reinterpret_cast<float*>(smem + L::dv);
  float* lse_s = reinterpret_cast<float*>(smem + L::row);
  float* dl_s = lse_s + kM;

  const int k0 = blockIdx.x * kBN, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int off = Sk - Sq;
  const size_t kvrow = ((size_t)b * Hkv + hk) * Sk;
  load_rows<D>(k_s, L::ldT, k + kvrow * D, k0, Sk, kBN);
  load_rows<D>(v_s, L::ldT, v + kvrow * D, k0, Sk, kBN);
  zero_f32<D>(dk_s, L::ldA, kBN);
  zero_f32<D>(dv_s, L::ldA, kBN);
  // the first query row that sees key k0 under the causal mask
  const int q_first = causal ? max(0, k0 - off) / kM * kM : 0;

  for (int h = hk * g; h < (hk + 1) * g; ++h) {
    const size_t qrow = ((size_t)b * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += kM) {
      __syncthreads();                      // previous tile consumed
      load_rows<D>(q_s, L::ldT, q + qrow * D, q0, Sq, kM);
      load_rows<D>(g_s, L::ldT, dout + qrow * D, q0, Sq, kM);
      load_row_stats<kM>(lse_s, dl_s, lse + qrow, delta + qrow, q0, Sq);
      __syncthreads();
      mm<false, true, false, kM, kBN, D>(s_s, L::ldS, q_s, L::ldT, k_s,
                                         L::ldT);              // S = Q K^T
      mm<false, true, false, kM, kBN, D>(dp_s, L::ldS, g_s, L::ldT, v_s,
                                         L::ldT);              // dP = dO V^T
      __syncthreads();
      bwd_probs<kM>(s_s, dp_s, L::ldS, p_s, ds_s, L::ldP, lse_s, dl_s, q0,
                    k0, Sq, Sk, off, causal, scale);
      __syncthreads();
      mm<true, false, true, kBN, D, kM>(dv_s, L::ldA, p_s, L::ldP, g_s,
                                        L::ldT);               // dV += P^T dO
      mm<true, false, true, kBN, D, kM>(dk_s, L::ldA, ds_s, L::ldP, q_s,
                                        L::ldT);               // dK += dS^T Q
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBN * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < Sk) {
      dk[(kvrow + k0 + r) * D + c] = dk_s[r * L::ldA + c] * scale;
      dv[(kvrow + k0 + r) * D + c] = dv_s[r * L::ldA + c];
    }
  }
}

template <int D>
struct DqLayout {
  static constexpr int kM = kBwdM;
  static constexpr int ldT = D + kPad, ldP = kBN + kPad;
  static constexpr int ldS = kBN + kPadF, ldA = D + kPadF;
  static constexpr size_t q = 0;
  static constexpr size_t g = q + up128(4 * kM * ldT);            // dO
  static constexpr size_t k = g + up128(4 * kM * ldT);
  static constexpr size_t v = k + up128(4 * kBN * ldT);
  static constexpr size_t s = v + up128(4 * kBN * ldT);
  static constexpr size_t dp = s + up128(4 * kM * ldS);
  static constexpr size_t ds = dp + up128(4 * kM * ldS);
  static constexpr size_t dq = ds + up128(4 * kM * ldP);
  static constexpr size_t row = dq + up128(4 * kM * ldA);
  static constexpr size_t bytes = row + up128(4 * 2 * kM);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Hkv, int Sq, int Sk, float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int kM = L::kM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  float* g_s = reinterpret_cast<float*>(smem + L::g);
  float* k_s = reinterpret_cast<float*>(smem + L::k);
  float* v_s = reinterpret_cast<float*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds);
  float* dq_s = reinterpret_cast<float*>(smem + L::dq);
  float* lse_s = reinterpret_cast<float*>(smem + L::row);
  float* dl_s = lse_s + kM;

  const int q0 = blockIdx.x * kM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int off = Sk - Sq;
  const size_t qrow = ((size_t)b * H + h) * Sq;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * D;
  load_rows<D>(q_s, L::ldT, q + qrow * D, q0, Sq, kM);
  load_rows<D>(g_s, L::ldT, dout + qrow * D, q0, Sq, kM);
  load_row_stats<kM>(lse_s, dl_s, lse + qrow, delta + qrow, q0, Sq);
  zero_f32<D>(dq_s, L::ldA, kM);
  const int kv_end = causal ? min(Sk, q0 + kM + off) : Sk;

  for (int k0 = 0; k0 < kv_end; k0 += kBN) {
    __syncthreads();                        // previous tile consumed
    load_rows<D>(k_s, L::ldT, kb, k0, Sk, kBN);
    load_rows<D>(v_s, L::ldT, vb, k0, Sk, kBN);
    __syncthreads();
    mm<false, true, false, kM, kBN, D>(s_s, L::ldS, q_s, L::ldT, k_s,
                                       L::ldT);                // S = Q K^T
    mm<false, true, false, kM, kBN, D>(dp_s, L::ldS, g_s, L::ldT, v_s,
                                       L::ldT);                // dP = dO V^T
    __syncthreads();
    bwd_probs<kM>(s_s, dp_s, L::ldS, nullptr, ds_s, L::ldP, lse_s, dl_s, q0,
                  k0, Sq, Sk, off, causal, scale);
    __syncthreads();
    mm<false, false, true, kM, D, kBN>(dq_s, L::ldA, ds_s, L::ldP, k_s,
                                       L::ldT);                // dQ += dS K
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq)
      dq[(qrow + q0 + r) * D + c] = dq_s[r * L::ldA + c] * scale;
  }
}

// --------------------------------------------------- bf16 kernels, Hopper
//
// Three warpgroups: two consumers (warps 0-7) and a producer (warps
// 8-11, of which warp 8 works). The producer streams tiles with TMA into
// a ring of kStages shared-memory stages, each guarded by a "full"
// mbarrier (data landed) and an "empty" one (both consumers are done
// with it). Each consumer owns 64 rows of the block's tile and keeps its
// accumulator in registers for the whole block.

constexpr int kWg = 128;                    // threads per warpgroup
constexpr int kSm90Threads = 3 * kWg;
constexpr int kStages = 2;
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr size_t up1024(size_t x) { return (x + 1023) / 1024 * 1024; }

// Byte offset of 1024-byte alignment in dynamic shared memory (the
// swizzled boxes need it); layouts reserve 1024 bytes for it.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// One lane per warp arrives on `bar` once every lane of the warp is done.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(bar);
}

// ---- forward

template <int D>
struct FwdSm90Layout {
  static constexpr int kM = 128;            // query rows per tile
  static constexpr int kN = 128;            // keys per ring stage
  static constexpr int kQ = kM * D * 2;     // bytes of the Q (or O) tile
  static constexpr int kKV = kN * D * 2;    // bytes of a K (or V) tile
  static constexpr size_t q = 0, o = kQ, ring = 2 * (size_t)kQ;
  static constexpr size_t stage = 2 * (size_t)kKV;            // K, then V
  static constexpr size_t bars = ring + kStages * stage;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty per stage
  static constexpr size_t bytes = bars + 8 * (2 + 4 * kStages) + 1024;
};

// The forward's work list: tile t is (Q tile, head, batch), the Q tiles
// counted down from the last, so the longest causal walks come first.
struct FwdTile {
  int q0, h, b;
};

__device__ __forceinline__ FwdTile fwd_tile(int t, int H, int B, int n_qt) {
  const int hb = t % (H * B);
  return {(n_qt - 1 - t / (H * B)) * 128, hb % H, hb / H};
}

// S = Q_wg K^T for one 128-key stage: 64 x 128, both operands K-major.
template <int D>
__device__ __forceinline__ void fwd_scores(float (&S)[64],
                                           const unsigned char* q_s,
                                           const unsigned char* k_s) {
  using L = FwdSm90Layout<D>;
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, kb = (kk % 4) * 32;
    sm90::mma_ss_n128(S, sm90::desc(q_s + box * L::kM * 128 + kb, 16, 1024),
                      sm90::desc(k_s + box * L::kN * 128 + kb, 16, 1024), kk);
  }
  sm90::wg_commit();
}

// O += P V for one 128-key stage: P from registers, V MN-major. O was
// rescaled just before, so it is pinned ahead of the fence.
template <int D>
__device__ __forceinline__ void fwd_pv(float (&O)[D / 2],
                                       const uint32_t (&P)[32],
                                       const unsigned char* v_s) {
  using L = FwdSm90Layout<D>;
  sm90::pin(O);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < L::kN / 16; ++kk)
    sm90::mma_rs<D>(O, P + 4 * kk,
                    sm90::desc(v_s + kk * 16 * 128, L::kN * 128, 1024));
  sm90::wg_commit();
}

// The online softmax of one 64 x 128 score tile, for this thread's two
// rows (row_r and row_r + 8; register i is row j = (i / 2) % 2): the
// scores scaled by scale2 (so any sign of the scale holds), their max
// over the quad, m (log2 units) moved to it, alpha =
// exp2(m_old - m_new), l (this thread's partial row sum; the quad's four
// are added in the epilogue) rescaled and grown, and S overwritten by the
// unnormalised probabilities exp2(s scale2 - m). kMasked (a tile on the
// diagonal or the ragged edge) tests each element and gives a masked one
// probability 0; other tiles test nothing.
template <bool kMasked>
__device__ __forceinline__ void fwd_softmax_tile(
    float (&S)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale2, int k0, int col_t, int row_r, int Sk, int off,
    int causal) {
  auto ok = [&](int i) {
    const int key = k0 + 8 * (i / 4) + col_t + i % 2;
    const int qi = row_r + 8 * ((i / 2) % 2);
    return !kMasked || (key < Sk && (!causal || key <= qi + off));
  };
  float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    S[i] *= scale2;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], ok(i) ? S[i] : -FLT_MAX);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j]);
    alpha[j] = sm90::exp2_ftz(m[j] - m_new);
    m[j] = m_new;
    l[j] *= alpha[j];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int j = (i / 2) % 2;
    const float p = ok(i) ? sm90::exp2_ftz(S[i] - m[j]) : 0.f;
    S[i] = p;
    l[j] += p;
  }
}

__device__ __forceinline__ void fwd_softmax(float (&S)[64], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            float scale2, bool masked, int k0,
                                            int col_t, int row_r, int Sk,
                                            int off, int causal) {
  if (masked)
    fwd_softmax_tile<true>(S, m, l, alpha, scale2, k0, col_t, row_r, Sk, off,
                           causal);
  else
    fwd_softmax_tile<false>(S, m, l, alpha, scale2, k0, col_t, row_r, Sk,
                            off, causal);
}

// Between the softmax and P V: P = S packed to bf16 (the RS operand), and
// O moved to the new running max.
template <int D>
__device__ __forceinline__ void fwd_to_pv(uint32_t (&P)[32], float (&O)[D / 2],
                                          const float (&S)[64],
                                          const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) P[i / 2] = sm90::pack_bf16(S[i], S[i + 1]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) O[i] *= alpha[(i / 2) % 2];
}

// O and LSE, persistent: block blockIdx.x takes tiles blockIdx.x,
// + gridDim.x, ... of the work list (one block per SM), and its K/V ring
// runs on from one tile into the next. Per tile of 128 query rows,
// consumer wg owns rows q0 + 64 wg ... + 63: per K/V stage of 128 keys
//   S = Q_wg K^T                            (wgmma SS, K-major operands)
//   online softmax in registers, P packed to bf16
//   O = alpha O + P V                       (wgmma RS, V MN-major)
// After its last S a warpgroup frees the Q buffer (the producer loads
// the next tile's Q once both have), and at the tile's end O / l goes to
// bf16 in its rows of the O buffer (the swizzled box layout) and out by
// TMA, one store per 64-column box, clipped at Sq, while the next tile's
// loads land; lse = (m + log2 l) ln 2.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map,
                       float* __restrict__ lse, int B, int H, int Hkv,
                       int Sq, int Sk, float scale, int causal) {
  using L = FwdSm90Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int n_qt = (Sq + L::kM - 1) / L::kM, n_tiles = n_qt * H * B;
  const int off = Sk - Sq;
  auto kv_steps = [&](int q0) {
    const int kv_end = causal ? min(Sk, q0 + L::kM + off) : Sk;
    return (kv_end + L::kN - 1) / L::kN;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 8);            // one lane per consumer warp
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    sm90::regs_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    // K or V rows key .. key + 127 into the stage of ring step `step`
    auto load = [&](const CUtensorMap* map, uint64_t* full, uint64_t* empty,
                    int step, size_t at, int key, int plane) {
      const int s = step % kStages, r = step / kStages;
      if (r > 0) sm90::mbar_wait(&empty[s], (r - 1) & 1);
      unsigned char* dst = smem + L::ring + s * L::stage + at;
      sm90::mbar_arrive_tx(&full[s], L::kKV);
      for (int c = 0; c < kBoxes; ++c)
        sm90::tma_load_3d(dst + c * L::kN * 128, map, &full[s], 64 * c, key,
                          plane);
    };
    int g = 0;                              // ring steps of earlier tiles
    for (int t = blockIdx.x, j = 0; t < n_tiles; t += gridDim.x, ++j) {
      const FwdTile w = fwd_tile(t, H, B, n_qt);
      const int plane = w.b * Hkv + w.h / (H / Hkv);
      const int n_iter = kv_steps(w.q0);
      // K of step 0 first, then Q once both warpgroups are done with the
      // last tile's, then K of step it + 1 before V of step it, so a
      // stage's K slot refills while its V is still being read
      load(&k_map, k_full, k_empty, g, 0, 0, plane);
      if (j > 0) sm90::mbar_wait(q_empty, (j - 1) & 1);
      sm90::mbar_arrive_tx(q_full, L::kQ);
      for (int c = 0; c < kBoxes; ++c)
        sm90::tma_load_3d(smem + L::q + c * L::kM * 128, &q_map, q_full,
                          64 * c, w.q0, w.b * H + w.h);
      for (int it = 1; it <= n_iter; ++it) {
        if (it < n_iter)
          load(&k_map, k_full, k_empty, g + it, 0, it * L::kN, plane);
        load(&v_map, v_full, v_empty, g + it - 1, L::kKV, (it - 1) * L::kN,
             plane);
      }
      g += n_iter;
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  // ping-pong: the first turn is warpgroup 0's
  if (wg == 0) sm90::bar_arrive(1, 2 * kWg);
  const int r_t = 16 * wl + lane / 4;       // row in the warpgroup (+ 8)
  const int col_t = 2 * (lane % 4);         // + 8 (i / 4) + i % 2
  const float scale2 = scale * kLog2e;
  const unsigned char* q_s = smem + L::q + wg * 64 * 128;
  unsigned char* o_s = smem + L::o + wg * 64 * 128;
  const bool storer = threadIdx.x % kWg == 0;

  int g = 0;
  for (int t = blockIdx.x, j = 0; t < n_tiles; t += gridDim.x, ++j) {
    const FwdTile w = fwd_tile(t, H, B, n_qt);
    const int n_iter = kv_steps(w.q0);
    const int qw0 = w.q0 + 64 * wg;         // this warpgroup's first row
    const int row_r = qw0 + r_t;
    // under the causal mask the first warpgroup's rows may end a step
    // early
    const int n_wg =
        causal ? min(n_iter, (qw0 + 63 + off) / L::kN + 1) : n_iter;
    // only steps on the diagonal or the ragged edge test each element
    auto masked = [&](int it) {
      const int k0 = it * L::kN;
      return !(k0 + L::kN <= Sk && (!causal || k0 + L::kN - 1 <= qw0 + off));
    };

    float O[D / 2], S[64];
    uint32_t P[32];
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) O[i] = 0.f;
    sm90::mbar_wait(q_full, j & 1);

    auto stage = [&](int it) {
      return smem + L::ring + ((g + it) % kStages) * L::stage;
    };
    auto phase = [&](int it) { return ((g + it) / kStages) & 1; };
    auto full = [&](uint64_t* bars, int it) {
      sm90::mbar_wait(&bars[(g + it) % kStages], phase(it));
    };
    auto release = [&](uint64_t* bars, int it) {
      warp_arrive(&bars[(g + it) % kStages]);
    };
    // turns: S_0; then P_{it-1} V_{it-1} with S_it; then the last P V
    const bool last_tile = t + (int)gridDim.x >= n_tiles;
    auto turn_begin = [&] { sm90::bar_sync(1 + wg, 2 * kWg); };
    auto turn_end = [&](bool last_turn) {
      if (!(wg == 1 && last_tile && last_turn))
        sm90::bar_arrive(2 - wg, 2 * kWg);
    };
    full(k_full, 0);
    turn_begin();
    fwd_scores<D>(S, q_s, stage(0));
    turn_end(false);
    sm90::wg_wait_all();
    sm90::pin(S);
    release(k_empty, 0);
    if (n_wg == 1) warp_arrive(q_empty);
    fwd_softmax(S, m, l, alpha, scale2, masked(0), 0, col_t, row_r, Sk,
                off, causal);
    for (int it = 1; it < n_wg; ++it) {
      fwd_to_pv<D>(P, O, S, alpha);
      full(v_full, it - 1);
      full(k_full, it);
      turn_begin();
      fwd_pv<D>(O, P, stage(it - 1) + L::kKV);
      fwd_scores<D>(S, q_s, stage(it));
      turn_end(false);
      sm90::wg_wait_all();
      sm90::pin(O);
      sm90::pin(P);
      sm90::pin(S);
      release(v_empty, it - 1);
      release(k_empty, it);
      if (it == n_wg - 1) warp_arrive(q_empty);
      fwd_softmax(S, m, l, alpha, scale2, masked(it), it * L::kN, col_t,
                  row_r, Sk, off, causal);
    }
    fwd_to_pv<D>(P, O, S, alpha);
    full(v_full, n_wg - 1);
    turn_begin();
    fwd_pv<D>(O, P, stage(n_wg - 1) + L::kKV);
    turn_end(n_wg == n_iter);
    sm90::wg_wait_all();
    sm90::pin(O);
    sm90::pin(P);
    release(v_empty, n_wg - 1);
    if (n_wg < n_iter) {
      // the tile's last step is past all of this warpgroup's rows:
      // release the stage once it has landed, and take the empty turn
      // that keeps both warpgroups' turn counts equal
      full(k_full, n_wg);
      release(k_empty, n_wg);
      full(v_full, n_wg);
      release(v_empty, n_wg);
      turn_begin();
      turn_end(true);
    }
    g += n_iter;

    const size_t row0 = ((size_t)w.b * H + w.h) * Sq;
    float inv[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 1);
      l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 2);
      inv[jj] = 1.f / l[jj];
      const int qi = row_r + 8 * jj;
      if (lane % 4 == 0 && qi < Sq)
        lse[row0 + qi] = (m[jj] + log2f(l[jj])) * kLn2;
    }
    // the last tile's store has read the O buffer
    if (storer) sm90::tma_store_wait_read();
    sm90::bar_sync(3 + wg, kWg);
    // (row, col) of the swizzled box: 16-byte chunk col / 8 of row r sits
    // at chunk (col / 8) ^ (r % 8) (sm90.cuh)
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int jj = (i / 2) % 2, r = r_t + 8 * jj;
      const int col = 8 * (i / 4) + col_t, c = col % 64;
      *reinterpret_cast<uint32_t*>(
          o_s + (col / 64) * L::kM * 128 + r * 128 +
          (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2) =
          sm90::pack_bf16(O[i] * inv[jj], O[i + 1] * inv[jj]);
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(3 + wg, kWg);            // the warpgroup's rows written
    if (storer && qw0 < Sq) {
      for (int c = 0; c < kBoxes; ++c)
        sm90::tma_store_3d(&o_map, o_s + c * L::kM * 128, 64 * c, qw0,
                           w.b * H + w.h);
      sm90::tma_store_commit();
    }
  }
  if (storer) sm90::tma_store_wait();
}

// ---- backward

template <int D>
struct DkdvSm90Layout {
  static constexpr int kN = 128;            // keys per block
  static constexpr int kM = 64;             // query rows per ring stage
  static constexpr int kKV = kN * D * 2;    // bytes of the K (or V) tile
  static constexpr int kQ = kM * D * 2;     // bytes of a Q (or dO) tile
  static constexpr size_t k = 0, v = kKV, ring = 2 * (size_t)kKV;
  // a stage: Q, dO, then lse * log2(e) and delta for its 64 rows
  static constexpr size_t stage = up1024(2 * kQ + 2 * kM * 4);
  static constexpr size_t bars = ring + kStages * stage;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

// dK, dV for 128 keys of kv head blockIdx.x, batch blockIdx.y; key tile
// blockIdx.z, so the longest walks (the first keys, under the causal
// mask) are launched first. Consumer wg owns keys k0 + 64 wg ... + 63:
// per (query head of the group, Q tile of 64 rows from the diagonal on)
//   S^T = K_wg Q^T, dP^T = V_wg dO^T      (wgmma SS, K-major operands)
//   P^T = exp2(S^T scale log2e - lse log2e), 0 where masked
//   dS^T = P^T (dP^T - delta)
//   dV += P^T dO, dK += dS^T Q            (wgmma RS: P^T, dS^T packed to
//                                          bf16 from the registers they
//                                          were computed in; dO, Q
//                                          MN-major)
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                            int Sq, int Sk, float scale, int causal) {
  using L = DkdvSm90Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * L::kN;
  const int g = H / Hkv, off = Sk - Sq;
  // the first Q tile whose rows see key k0 under the causal mask
  const int q_first = causal ? max(0, k0 - off) / L::kM * L::kM : 0;
  const int n_q = (Sq - q_first + L::kM - 1) / L::kM;
  const int n_iter = g * n_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);        // the producer warp's lanes
      sm90::mbar_init(&empty[s], 8);        // one lane per consumer warp
    }
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    sm90::regs_dec<kProducerRegs>();
    if (warp != 8) return;
    if (lane == 0) {
      const int plane = b * Hkv + hk;
      sm90::mbar_arrive_tx(kv_full, 2 * L::kKV);
      for (int c = 0; c < kBoxes; ++c) {
        sm90::tma_load_3d(smem + L::k + c * L::kN * 128, &k_map, kv_full,
                          64 * c, k0, plane);
        sm90::tma_load_3d(smem + L::v + c * L::kN * 128, &v_map, kv_full,
                          64 * c, k0, plane);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages, r = it / kStages;
      const int h = hk * g + it / n_q, q0 = q_first + (it % n_q) * L::kM;
      if (r > 0) sm90::mbar_wait(&empty[s], (r - 1) & 1);
      unsigned char* st = smem + L::ring + s * L::stage;
      float* rows = reinterpret_cast<float*>(st + 2 * L::kQ);
      const size_t row0 = ((size_t)b * H + h) * Sq;
      for (int j = lane; j < L::kM; j += 32) {
        const int qi = q0 + j;
        rows[j] = qi < Sq ? lse[row0 + qi] * kLog2e : 0.f;
        rows[L::kM + j] = qi < Sq ? delta[row0 + qi] : 0.f;
      }
      if (lane == 0) {
        sm90::mbar_arrive_tx(&full[s], 2 * L::kQ);
        for (int c = 0; c < kBoxes; ++c) {
          sm90::tma_load_3d(st + c * L::kM * 128, &q_map, &full[s], 64 * c,
                            q0, b * H + h);
          sm90::tma_load_3d(st + L::kQ + c * L::kM * 128, &do_map, &full[s],
                            64 * c, q0, b * H + h);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int kw0 = k0 + 64 * wg;             // this warpgroup's first key
  const int key_r = kw0 + 16 * wl + lane / 4;   // + 8 for odd pairs
  const int col_t = 2 * (lane % 4);             // + 8 j (+ 1)
  const float scale2 = scale * kLog2e;
  const unsigned char* k_s = smem + L::k + wg * 64 * 128;
  const unsigned char* v_s = smem + L::v + wg * 64 * 128;
  float dV[D / 2], dK[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dV[i] = dK[i] = 0.f;
  sm90::mbar_wait(kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages, r = it / kStages;
    const int q0 = q_first + (it % n_q) * L::kM;
    const unsigned char* st = smem + L::ring + s * L::stage;
    const float* rows = reinterpret_cast<const float*>(st + 2 * L::kQ);
    sm90::mbar_wait(&full[s], r & 1);

    float S[32], dP[32];
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, kb = (kk % 4) * 32;
      sm90::mma_ss_n64(
          S, sm90::desc(k_s + box * L::kN * 128 + kb, 16, 1024),
          sm90::desc(st + box * L::kM * 128 + kb, 16, 1024), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, kb = (kk % 4) * 32;
      sm90::mma_ss_n64(
          dP, sm90::desc(v_s + box * L::kN * 128 + kb, 16, 1024),
          sm90::desc(st + L::kQ + box * L::kM * 128 + kb, 16, 1024), kk);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(S);
    sm90::pin(dP);

    // only tiles on the diagonal or the ragged edge test each element
    const bool whole = q0 + L::kM <= Sq && kw0 + 64 <= Sk &&
                       (!causal || kw0 + 63 <= q0 + off);
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 8 * (i / 4) + col_t;  // query row within the tile
      const int key = key_r + 8 * ((i / 2) % 2);
      const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
      const float2 dl = *reinterpret_cast<const float2*>(rows + L::kM + col);
      float p0 = exp2f(fmaf(S[i], scale2, -l2.x));
      float p1 = exp2f(fmaf(S[i + 1], scale2, -l2.y));
      if (!whole) {
        const int qi = q0 + col;
        if (!(qi < Sq && key < Sk && (!causal || key <= qi + off))) p0 = 0.f;
        if (!(qi + 1 < Sq && key < Sk && (!causal || key <= qi + 1 + off)))
          p1 = 0.f;
      }
      pa[i / 2] = sm90::pack_bf16(p0, p1);
      dsa[i / 2] =
          sm90::pack_bf16(p0 * (dP[i] - dl.x), p1 * (dP[i + 1] - dl.y));
    }

    sm90::pin(dV);
    sm90::pin(dK);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < L::kM / 16; ++kk)
      sm90::mma_rs<D>(dV, pa + 4 * kk,
                      sm90::desc(st + L::kQ + kk * 16 * 128, L::kM * 128,
                                 1024));
#pragma unroll
    for (int kk = 0; kk < L::kM / 16; ++kk)
      sm90::mma_rs<D>(dK, dsa + 4 * kk,
                      sm90::desc(st + kk * 16 * 128, L::kM * 128, 1024));
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(dV);
    sm90::pin(dK);
    sm90::pin(pa);
    sm90::pin(dsa);
    warp_arrive(&empty[s]);
  }

  const size_t kvrow = ((size_t)b * Hkv + hk) * Sk;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int col = 8 * (i / 4) + col_t;
    const int key = key_r + 8 * ((i / 2) % 2);
    if (key < Sk) {
      const size_t at = (kvrow + key) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          sm90::pack_bf16(dK[i] * scale, dK[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          sm90::pack_bf16(dV[i], dV[i + 1]);
    }
  }
}

template <int D>
struct DqSm90Layout {
  static constexpr int kM = 128;            // query rows per block
  static constexpr int kN = 64;             // keys per ring stage
  static constexpr int kQ = kM * D * 2;     // bytes of the Q (or dO) tile
  static constexpr int kKV = kN * D * 2;    // bytes of a K (or V) tile
  static constexpr size_t q = 0, g = kQ, ring = 2 * (size_t)kQ;
  static constexpr size_t stage = 2 * (size_t)kKV;            // K, then V
  static constexpr size_t bars = ring + kStages * stage;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

// dQ for 128 query rows of head blockIdx.x, batch blockIdx.y; the Q tile
// counts down from the last as blockIdx.z grows, so the longest walks
// (the last rows, under the causal mask) are launched first. Consumer wg
// owns rows q0 + 64 wg ... + 63: per K/V tile of 64 keys
//   S = Q_wg K^T, dP = dO_wg V^T           (wgmma SS, K-major operands)
//   dS = P (dP - delta), P as above
//   dQ += dS K                              (wgmma RS, K MN-major)
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                          int Sq, int Sk, float scale, int causal) {
  using L = DqSm90Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* qd_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::kM;
  const int hk = h / (H / Hkv), off = Sk - Sq;
  const int kv_end = causal ? min(Sk, q0 + L::kM + off) : Sk;
  const int n_iter = (kv_end + L::kN - 1) / L::kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_init(qd_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    sm90::regs_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    const int plane = b * Hkv + hk;
    sm90::mbar_arrive_tx(qd_full, 2 * L::kQ);
    for (int c = 0; c < kBoxes; ++c) {
      sm90::tma_load_3d(smem + L::q + c * L::kM * 128, &q_map, qd_full,
                        64 * c, q0, b * H + h);
      sm90::tma_load_3d(smem + L::g + c * L::kM * 128, &do_map, qd_full,
                        64 * c, q0, b * H + h);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages, r = it / kStages;
      if (r > 0) sm90::mbar_wait(&empty[s], (r - 1) & 1);
      unsigned char* st = smem + L::ring + s * L::stage;
      sm90::mbar_arrive_tx(&full[s], 2 * L::kKV);
      for (int c = 0; c < kBoxes; ++c) {
        sm90::tma_load_3d(st + c * L::kN * 128, &k_map, &full[s], 64 * c,
                          it * L::kN, plane);
        sm90::tma_load_3d(st + L::kKV + c * L::kN * 128, &v_map, &full[s],
                          64 * c, it * L::kN, plane);
      }
    }
    return;
  }

  sm90::regs_inc<kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int qw0 = q0 + 64 * wg;             // this warpgroup's first row
  const int row_r = qw0 + 16 * wl + lane / 4;   // + 8 for odd pairs
  const int col_t = 2 * (lane % 4);
  const float scale2 = scale * kLog2e;
  const size_t row0 = ((size_t)b * H + h) * Sq;
  float l2[2], dl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = row_r + 8 * j;
    l2[j] = qi < Sq ? lse[row0 + qi] * kLog2e : 0.f;
    dl[j] = qi < Sq ? delta[row0 + qi] : 0.f;
  }
  const unsigned char* q_s = smem + L::q + wg * 64 * 128;
  const unsigned char* g_s = smem + L::g + wg * 64 * 128;
  float dQ[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dQ[i] = 0.f;
  sm90::mbar_wait(qd_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages, r = it / kStages;
    const int k0 = it * L::kN;
    const unsigned char* st = smem + L::ring + s * L::stage;
    sm90::mbar_wait(&full[s], r & 1);
    // under the causal mask the first warpgroup's rows end a tile early
    if (!causal || k0 <= qw0 + 63 + off) {
      float S[32], dP[32];
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, kb = (kk % 4) * 32;
        sm90::mma_ss_n64(
            S, sm90::desc(q_s + box * L::kM * 128 + kb, 16, 1024),
            sm90::desc(st + box * L::kN * 128 + kb, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / 4, kb = (kk % 4) * 32;
        sm90::mma_ss_n64(
            dP, sm90::desc(g_s + box * L::kM * 128 + kb, 16, 1024),
            sm90::desc(st + L::kKV + box * L::kN * 128 + kb, 16, 1024), kk);
      }
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(S);
      sm90::pin(dP);

      const bool whole = qw0 + 64 <= Sq && k0 + L::kN <= Sk &&
                         (!causal || k0 + L::kN - 1 <= qw0 + off);
      uint32_t dsa[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = k0 + 8 * (i / 4) + col_t;
        const int j = (i / 2) % 2;
        const int qi = row_r + 8 * j;
        float p0 = exp2f(fmaf(S[i], scale2, -l2[j]));
        float p1 = exp2f(fmaf(S[i + 1], scale2, -l2[j]));
        if (!whole) {
          const bool row_ok = qi < Sq;
          if (!(row_ok && key < Sk && (!causal || key <= qi + off))) p0 = 0.f;
          if (!(row_ok && key + 1 < Sk && (!causal || key + 1 <= qi + off)))
            p1 = 0.f;
        }
        dsa[i / 2] =
            sm90::pack_bf16(p0 * (dP[i] - dl[j]), p1 * (dP[i + 1] - dl[j]));
      }

      sm90::pin(dQ);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < L::kN / 16; ++kk)
        sm90::mma_rs<D>(dQ, dsa + 4 * kk,
                        sm90::desc(st + kk * 16 * 128, L::kN * 128, 1024));
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(dQ);
      sm90::pin(dsa);
    }
    warp_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int qi = row_r + 8 * ((i / 2) % 2);
    if (qi < Sq)
      *reinterpret_cast<uint32_t*>(dq + (row0 + qi) * D + 8 * (i / 4) +
                                   col_t) =
          sm90::pack_bf16(dQ[i] * scale, dQ[i + 1] * scale);
  }
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd_typed(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Hkv, int Sq, int Sk,
                      float scale, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using L = FwdSm90Layout<D>;
    CUtensorMap m[4];               // q, k, v; o in one warpgroup's rows
    if (!(sm90::encode_bf16_3d(&m[0], q, D, Sq, B * H, L::kM) &&
          sm90::encode_bf16_3d(&m[1], k, D, Sk, B * Hkv, L::kN) &&
          sm90::encode_bf16_3d(&m[2], v, D, Sk, B * Hkv, L::kN) &&
          sm90::encode_bf16_3d(&m[3], o, D, Sq, B * H, L::kM / 2)))
      return cudaErrorNotSupported;
    auto kernel = flash_fwd_wgmma_kernel<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    // one block per SM, each walking its share of the tiles
    const int tiles = (Sq + L::kM - 1) / L::kM * H * B;
    kernel<<<min(tiles, sms), kSm90Threads, L::bytes, st>>>(
        m[0], m[1], m[2], m[3], static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
        scale, causal);
    return cudaGetLastError();
  } else {
    using L = FwdLayout<D>;
    auto kernel = flash_fwd_kernel<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + L::kM - 1) / L::kM, H, B);
    kernel<<<grid, kThreads, L::bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), H, Hkv, Sq, Sk, scale, causal);
    return cudaGetLastError();
  }
}

// The bf16 backward's four tensor maps: q and dO [B H, Sq, D] in boxes of
// q_rows rows, k and v [B Hkv, Sk, D] in boxes of kv_rows rows.
template <int D>
bool bwd_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
              const void* k, const void* v, int B, int H, int Hkv, int Sq,
              int Sk, int q_rows, int kv_rows) {
  return sm90::encode_bf16_3d(&m[0], q, D, Sq, B * H, q_rows) &&
         sm90::encode_bf16_3d(&m[1], dout, D, Sq, B * H, q_rows) &&
         sm90::encode_bf16_3d(&m[2], k, D, Sk, B * Hkv, kv_rows) &&
         sm90::encode_bf16_3d(&m[3], v, D, Sk, B * Hkv, kv_rows);
}

template <typename T, int D>
cudaError_t dkdv_typed(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, float scale, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using L = DkdvSm90Layout<D>;
    CUtensorMap m[4];
    if (!bwd_maps<D>(m, q, dout, k, v, B, H, Hkv, Sq, Sk, L::kM, L::kN))
      return cudaErrorNotSupported;
    auto kernel = flash_bwd_dkdv_wgmma_kernel<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(Hkv, B, (Sk + L::kN - 1) / L::kN);
    kernel<<<grid, kSm90Threads, L::bytes, st>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Sk, scale, causal);
    return cudaGetLastError();
  } else {
    using L = DkdvLayout<D>;
    auto kernel = flash_bwd_dkdv_kernel<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sk + kBN - 1) / kBN, Hkv, B);
    kernel<<<grid, kThreads, L::bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Sk,
        scale, causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t dq_typed(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using L = DqSm90Layout<D>;
    CUtensorMap m[4];
    if (!bwd_maps<D>(m, q, dout, k, v, B, H, Hkv, Sq, Sk, L::kM, L::kN))
      return cudaErrorNotSupported;
    auto kernel = flash_bwd_dq_wgmma_kernel<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(H, B, (Sq + L::kM - 1) / L::kM);
    kernel<<<grid, kSm90Threads, L::bytes, st>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
        Hkv, Sq, Sk, scale, causal);
    return cudaGetLastError();
  } else {
    using L = DqLayout<D>;
    auto kernel = flash_bwd_dq_kernel<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + L::kM - 1) / L::kM, H, B);
    kernel<<<grid, kThreads, L::bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), H, Hkv, Sq, Sk, scale, causal);
    return cudaGetLastError();
  }
}

bool shape_ok(int B, int H, int Hkv, int Sq, int Sk, int causal) {
  return B > 0 && Hkv > 0 && H % Hkv == 0 && Sq > 0 && Sk > 0 &&
         B <= 65535 && H <= 65535 && (!causal || Sq <= Sk);
}

// One dispatch over (dtype, head_dim) for the three tiled launches.
#define NOS_FLASH_DISPATCH(FN, ...)                                 \
  do {                                                              \
    if (dtype == kF32 && D == 64) return FN<float, 64>(__VA_ARGS__);  \
    if (dtype == kF32 && D == 128) return FN<float, 128>(__VA_ARGS__); \
    if (dtype == kBF16 && D == 64)                                  \
      return FN<__nv_bfloat16, 64>(__VA_ARGS__);                    \
    if (dtype == kBF16 && D == 128)                                 \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                   \
    return cudaErrorInvalidValue;                                   \
  } while (0)

}  // namespace

// Plain C entries for ctypes; every tensor is contiguous, 16-byte aligned
// and in the layout above: q/o/dq [B, H, Sq, D], k/v/dk/dv [B, Hkv, Sk, D]
// in one dtype (0 f32, 1 bf16), lse/delta f32 [B, H, Sq]. D is 64 or 128.
// Each returns the launch's cudaGetLastError(); 0 is success.

extern "C" int nos_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int H, int Hkv, int Sq, int Sk,
                                       int D, float scale, int causal,
                                       int dtype, void* stream) {
  if (!shape_ok(B, H, Hkv, Sq, Sk, causal)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NOS_FLASH_DISPATCH(fwd_typed, q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale,
                     causal, st);
}

extern "C" int nos_flash_attention_bwd_preprocess(const void* o,
                                                  const void* dout,
                                                  void* delta, int rows,
                                                  int D, int dtype,
                                                  void* stream) {
  if (rows <= 0 || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kWarps - 1) / kWarps;
  if (dtype == kF32)
    flash_bwd_pre_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows, D);
  else if (dtype == kBF16)
    flash_bwd_pre_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta),
        rows, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int nos_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Sk, int D, float scale, int causal, int dtype,
    void* stream) {
  if (!shape_ok(B, H, Hkv, Sq, Sk, causal)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NOS_FLASH_DISPATCH(dkdv_typed, q, k, v, dout, lse, delta, dk, dv, B, H,
                     Hkv, Sq, Sk, scale, causal, st);
}

extern "C" int nos_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
    int Sq, int Sk, int D, float scale, int causal, int dtype,
    void* stream) {
  if (!shape_ok(B, H, Hkv, Sq, Sk, causal)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NOS_FLASH_DISPATCH(dq_typed, q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq,
                     Sk, scale, causal, st);
}
