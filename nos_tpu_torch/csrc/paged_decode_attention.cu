// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel nos_tpu/ops/attention.py::paged_decode_attention
// (body _paged_decode_kernel): causal GQA attention of an S-wide query
// window at positions pos..pos+S-1 over each row's paged KV timeline,
// walked by block table, with an f32 online softmax and an optional int8
// arena dequantized in the inner loop with dequantize_kv's exact rule
// (f32 multiply, one rounding to the compute dtype).
//
// Bound: HBM bytes. Each live K/V token is read once per query tile, and
// a decode step (S = 1, g = H/Hkv query rows per kv head) does ~2g flops
// per byte read, far below the card's ~295 flops/byte balance point.
//
// Design. The TPU grid (b, h_kv, j) ran j in order with the softmax state
// in scratch; CUDA blocks run in parallel, so j becomes a loop inside one
// block. One block per (tile of ROWS query rows, h_kv, b, timeline
// split); rows are the reference's grouping r = g_idx * S + s_idx, which
// is contiguous in q/out [B, H, S, D]. The block reads its own pos[b] and
// table[b, :], and walks its split of the timeline in chunks of 32 tokens
// up to the last position any of its rows can see (the dead-tail skip):
// 128 threads stage a chunk of K and V into shared memory as f32 (16-byte
// vector loads), then each warp scores its rows with one token per lane,
// takes the warp max and sum for the online softmax, and accumulates P.V
// with each lane owning D/32 output dims. Masked slots score -FLT_MAX
// (finfo(f32).min, as the reference: -inf would give NaN through
// exp(m_prev - m_new)).
//
// Split-KV: a decode step has only B * Hkv row tiles (64 at batch 8) for
// 132 SMs, and each walks up to 2048 tokens one chunk at a time, so the
// wrapper cuts the timeline into splits of split_tok tokens until there
// are about four blocks per SM. Each split writes its unnormalised (acc,
// m, l) to an f32 scratch, and paged_decode_merge_kernel combines them
// per row: out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i. With
// one split (prefill windows already fill the card) the block writes out
// directly.
//
// What this simple design leaves on the table: no overlap of the next
// chunk's loads with this chunk's math (cp.async / TMA double
// buffering), and scalar FMAs instead of mma/wgmma for the S > 1
// prefill windows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                  // tokens staged per step
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename QT>
__device__ __forceinline__ QT from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to the compute dtype and back: dequantize_kv casts
// once to q's dtype, and the reference kernel then reads it as f32.
template <typename QT>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of arena elements -> f32. kVec elements per 16-byte load.
template <typename KT> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* o) {
    float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(h[i]);
  }
};
template <> struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ static void load(const int8_t* p, float* o) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// QT: q/out dtype (and compute dtype). KT: arena dtype (QT, or int8 with
// f32 scales).
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_arena,
                    const KT* __restrict__ v_arena,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ pos, QT* __restrict__ out,
                    float* __restrict__ part, int H, int Hkv, int S, int bs,
                    int nb, float sm_scale, int split_tok) {
  constexpr int kDL = D / 32;                 // output dims per lane
  constexpr int kV = Vec<KT>::kN;
  __shared__ float q_s[kRows][D];
  __shared__ float k_s[kChunk][D + 1];        // +1: conflict-free rows
  __shared__ float v_s[kChunk][D];

  const int n_split = (nb * bs + split_tok - 1) / split_tok;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hk = blockIdx.y;
  const int g = H / Hkv, gs = g * S;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, gs - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pos_b = pos[b];
  const int32_t* tab = table + (size_t)b * nb;

  // rows of this kv head's group are contiguous in [B, H, S, D]
  const size_t row_base = ((size_t)b * H + (size_t)hk * g) * S;
  for (int i = threadIdx.x; i < n_rows * D; i += kThreads)
    q_s[i / D][i % D] = to_f32(q[(row_base + r0 + i / D) * D + i % D]);

  // dead-tail skip: nothing past the last position a row here can see
  int s_max = 0;
  for (int r = r0; r < r0 + n_rows; ++r) s_max = max(s_max, r % S);
  const int n_tok = min(pos_b + s_max + 1, nb * bs);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[i][j] = 0.f;
  }

  const int t_end = min(n_tok, (split + 1) * split_tok);
  for (int c0 = split * split_tok; c0 < t_end; c0 += kChunk) {
    __syncthreads();                          // previous chunk consumed
    for (int i = threadIdx.x; i < kChunk * (D / kV); i += kThreads) {
      const int t = i / (D / kV), d0 = (i % (D / kV)) * kV;
      const int tp = c0 + t;
      float kv[kV], vv[kV];
      if (tp < t_end) {
        const int lb = tp / bs, off = tp - lb * bs;
        const size_t tok = ((size_t)tab[lb] * Hkv + hk) * bs + off;
        Vec<KT>::load(k_arena + tok * D + d0, kv);
        Vec<KT>::load(v_arena + tok * D + d0, vv);
        if constexpr (std::is_same<KT, int8_t>::value) {
          const float ks = k_scale[tok], vs = v_scale[tok];
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            kv[e] = round_to<QT>(kv[e] * ks);
            vv[e] = round_to<QT>(vv[e] * vs);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        k_s[t][d0 + e] = kv[e];
        v_s[t][d0 + e] = vv[e];
      }
    }
    __syncthreads();

    const int tp = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rr = warp + i * kWarps;
      if (rr >= n_rows) break;                // warp-uniform
      const int s_idx = (r0 + rr) % S;
      float sc = -FLT_MAX;
      if (tp < t_end && tp <= pos_b + s_idx) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(q_s[rr][d], k_s[lane][d], dot);
        sc = dot * sm_scale;
      }
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(m[i] - m_new);
      const float p = expf(sc - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[i][j] *= alpha;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
        for (int j = 0; j < kDL; ++j)
          acc[i][j] = fmaf(pt, v_s[t][lane + 32 * j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rr = warp + i * kWarps;
    if (rr >= n_rows) break;
    if (part != nullptr) {
      // [B, Hkv, n_split, gs, D + 2]: acc, then m and l
      float* pr = part + ((((size_t)b * Hkv + hk) * n_split + split) * gs
                          + r0 + rr) * (D + 2);
#pragma unroll
      for (int j = 0; j < kDL; ++j) pr[lane + 32 * j] = acc[i][j];
      if (lane == 0) {
        pr[D] = m[i];
        pr[D + 1] = l[i];
      }
      continue;
    }
    const float den = l[i] == 0.f ? 1.f : l[i];
    QT* o = out + (row_base + r0 + rr) * D;
#pragma unroll
    for (int j = 0; j < kDL; ++j)
      o[lane + 32 * j] = from_f32<QT>(acc[i][j] / den);
  }
}

// One block per (query row, h_kv, b), one thread per output dim: fold the
// splits' partial softmax states into the row's output.
template <typename QT, int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part,
                          QT* __restrict__ out, int H, int Hkv, int S,
                          int n_split) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv, gs = g * S, d = threadIdx.x;
  const float* pr = part + (((size_t)b * Hkv + hk) * n_split * gs + r)
                               * (D + 2);
  const size_t stride = (size_t)gs * (D + 2);
  float m_all = -FLT_MAX;
  for (int i = 0; i < n_split; ++i) m_all = fmaxf(m_all, pr[i * stride + D]);
  float l_all = 0.f, acc = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = expf(pr[i * stride + D] - m_all);
    l_all = fmaf(w, pr[i * stride + D + 1], l_all);
    acc = fmaf(w, pr[i * stride + d], acc);
  }
  const size_t row_base = ((size_t)b * H + (size_t)hk * g) * S;
  out[(row_base + r) * D + d] =
      from_f32<QT>(acc / (l_all == 0.f ? 1.f : l_all));
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* table,
                         const void* pos, void* out, void* part, int B,
                         int H, int Hkv, int S, int D, int bs, int nb,
                         float sm_scale, int split_tok,
                         cudaStream_t stream) {
  const int gs = (H / Hkv) * S;
  const int n_split = (nb * bs + split_tok - 1) / split_tok;
  if (split_tok % kChunk != 0 || (n_split > 1) != (part != nullptr))
    return cudaErrorInvalidValue;
  dim3 grid((gs + kRows - 1) / kRows, Hkv, B * n_split);
  auto attend = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(pos), static_cast<QT*>(out),
        static_cast<float*>(part), H, Hkv, S, bs, nb, sm_scale, split_tok);
  };
  auto merge = [&](auto kernel, int threads) {
    kernel<<<dim3(gs, Hkv, B), threads, 0, stream>>>(
        static_cast<const float*>(part), static_cast<QT*>(out), H, Hkv, S,
        n_split);
  };
  if (D == 64) {
    attend(paged_decode_kernel<QT, KT, 64>);
    if (n_split > 1) merge(paged_decode_merge_kernel<QT, 64>, 64);
  } else if (D == 128) {
    attend(paged_decode_kernel<QT, KT, 128>);
    if (n_split > 1) merge(paged_decode_merge_kernel<QT, 128>, 128);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. q_dtype: 0 f32, 1 bf16; kv_dtype: the same,
// or 2 for int8 (then ks/vs are the f32 scale planes). split_tok: tokens
// per timeline split, a multiple of 32; with more than one split, part is
// an f32 scratch of B * Hkv * n_split * (H/Hkv * S) * (D + 2) floats, else
// null. Returns the launches' cudaGetLastError(); 0 is success.
extern "C" int nos_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* pos, void* out,
    void* part, int B, int H, int Hkv, int S, int D, int bs, int nb,
    float sm_scale, int split_tok, int q_dtype, int kv_dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_typed<float, float>(q, k, v, nullptr, nullptr, table, pos,
                                      out, part, B, H, Hkv, S, D, bs,
                                      nb, sm_scale, split_tok, st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, table, pos, out, part, B, H, Hkv, S, D,
        bs, nb, sm_scale, split_tok, st);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_typed<float, int8_t>(q, k, v, ks, vs, table, pos, out,
                                       part, B, H, Hkv, S, D, bs, nb,
                                       sm_scale, split_tok, st);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_typed<__nv_bfloat16, int8_t>(
        q, k, v, ks, vs, table, pos, out, part, B, H, Hkv, S, D, bs, nb,
        sm_scale, split_tok, st);
  return cudaErrorInvalidValue;
}
