// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel nos_tpu/ops/attention.py::paged_decode_attention
// (body _paged_decode_kernel): causal GQA attention of an S-wide query
// window at positions pos..pos+S-1 over each row's paged KV timeline,
// walked by block table, with an f32 online softmax and an optional int8
// arena dequantized at the point of use with dequantize_kv's exact rule
// (f32 multiply, one rounding to the compute dtype).
//
// Bound: HBM bytes. Each live K/V token is read once per query tile, and
// a decode step (S = 1, g = H/Hkv query rows per kv head) does ~2g flops
// per byte read, far below the card's ~295 flops/byte balance point, so
// the design is about keeping enough bytes in flight on every SM and
// launching nothing that reads no live token.
//
// Design (FlashDecoding's split-K on Hopper's bulk copies):
//
// - n_split blocks per (tile of R query rows, kv head, b) (the host's
//   choice, a power of two <= 8, so that the grid holds about two
//   blocks per SM; 4 blocks fit an SM, so a decode step's 512 blocks run
//   in one wave) split the row's LIVE pages, P_b = ceil((pos_b + S) /
//   bs) capped at nb: block `split` takes pages floor(split P_b / n) ..
//   floor((split + 1) P_b / n). Rows are the reference's grouping r =
//   g_idx * S + s_idx, contiguous in q/out [B, H, S, D]; R is 4 for g S
//   <= 4 (a decode step), else 8.
// - A producer warp walks the block table (32 entries per coalesced
//   load, handed out by shuffles) and its lane 0 fills a ring of 4
//   stages of 16 timeline tokens with 1-D bulk copies (one page of one kv
//   head is a contiguous bs x D run; at bs 8 a stage is two pages, at bs
//   > 16 a 16-token piece of one): K, V and the int8 scales, each stage
//   with a full mbarrier (bytes landed) and an empty one (every consumer
//   warp has read it). At the slice's decode shape a block's whole share
//   is in flight at once.
// - Four warps read each stage as it lands, in its own dtype: kL = D / 8
//   lanes cover one token's D in vectors of 8 elements (16 bytes of
//   bf16, conflict-free), so a warp holds 32 / kL tokens; every lane
//   keeps the 8 q elements of all R rows in registers. The group's R x
//   (tokens per stage) dot products are summed over its kL lanes by a
//   reduce-scatter (ScatterSum: each level sends half the values), so
//   every lane ends with one score and takes one exponential; each
//   group keeps its own online softmax (scores, P and P.V in f32 from
//   the compute-dtype V, as the reference's jnp.dot(p, v.astype(f32)))
//   in base 2 on the SFU (scores scaled by scale * log2(e)). Masked
//   slots score -FLT_MAX (finfo(f32).min, as the reference) and take
//   P = 0. int8 dequantizes in registers as it is read (f32 multiply,
//   one rounding to the compute dtype); its conversions run at a quarter
//   of the FMA rate, so the int8 walk is bound by them, not by bytes.
// - The merge runs inside the launch: the groups' (acc, m, l) fold in
//   group order into the block's state, which the block writes to its
//   slot of a scratch (L2-resident, ~1 MB at the slice's shape) before
//   taking a ticket; the last of the n_split blocks folds the slots in
//   split order, out = sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i
//   (l = 0 -> 1), and sets the ticket back to zero. One launch, no merge
//   kernel, the same bits on every run. A thread-block cluster merging
//   through distributed shared memory was built and measured first: on
//   an H100 only 62 clusters of 8 (4 blocks an SM) are resident at once,
//   so a decode step's 64 took two waves; with 5 blocks an SM (no
//   producer warp, 96 registers) they fit, but the walk spilled and
//   slowed (PERF.md, PR 5).
// - The launch counts itself: block (0, 0, 0) adds one to a 64-bit
//   counter the wrapper owns, so a launch that a CUDA graph recorded
//   counts at every replay, and the count is what the card ran.
// - Tensor cores buy nothing at S = 1 (~4 flops per byte at g = 4), so
//   P.V stays on the FMAs. S > 1 windows are on the serving path too: a
//   prefix hit prefills its suffix in the arena as one window at B = 1,
//   S = the suffix's power-of-two bucket (8 to 1024 at max_seq 2048),
//   rows reading the shared head through the table; they run the same
//   FMA path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;                  // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kMaxSplit = 8;               // blocks per row tile

// Sum each of the N values v[] over the token group's kL lanes (lane
// index li, O = kL / 2 at the call) and return value li / (kL / N),
// fully summed: each of the first log2(N) levels sends the partner the
// half of the values it keeps and adds the half it receives (N / 2
// shuffles), the remaining levels are plain butterfly sums.
template <int N, int O>
struct ScatterSum {
  __device__ static float run(float* v, int li) {
    if constexpr (N == 1) {
      float x = v[0];
#pragma unroll
      for (int o = O; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      return x;
    } else {
      const bool hi = li & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float keep = hi ? v[i + N / 2] : v[i];
        const float send = hi ? v[i] : v[i + N / 2];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      return ScatterSum<N / 2, O / 2>::run(v, li);
    }
  }
};

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

// A lane's 8 elements of one token row of D elements in shared memory,
// lane li of the token's kL = D / 8 lanes. dim(li, e) is the element
// index of register e; the layouts keep a quarter warp on 128
// contiguous bytes.
template <typename KT, int D> struct Lane;
template <int D> struct Lane<__nv_bfloat16, D> {
  __device__ static int dim(int li, int e) { return li * 8 + e; }
  __device__ static void load(const __nv_bfloat16* row, int li, float* o) {
    uint4 u = *reinterpret_cast<const uint4*>(row + li * 8);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __bfloat162float(h[e]);
  }
};
template <int D> struct Lane<float, D> {
  __device__ static int dim(int li, int e) {
    return (e < 4 ? 0 : D / 2) + li * 4 + (e & 3);
  }
  __device__ static void load(const float* row, int li, float* o) {
    float4 a = *reinterpret_cast<const float4*>(row + li * 4);
    float4 b = *reinterpret_cast<const float4*>(row + D / 2 + li * 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};
template <int D> struct Lane<int8_t, D> {
  __device__ static int dim(int li, int e) { return li * 8 + e; }
  __device__ static void load(const int8_t* row, int li, float* o) {
    uint2 u = *reinterpret_cast<const uint2*>(row + li * 8);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = static_cast<float>(c[e]);
  }
};

// Shared-memory layout, in bytes: the ring of kStages stages of 16
// tokens, which after the walk holds the token groups' states, then the
// block's merged state.
template <typename KT, int D, int R> struct Layout {
  static constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  static constexpr int kTok = 16;
  static constexpr int kStages = 4;
  static constexpr int kGroups = kWarps * 32 / (D / 8);
  static constexpr int kKV = kTok * D * (int)sizeof(KT);  // K (or V)
  static constexpr int kStage = 2 * kKV + (kInt8 ? 2 * kTok * 4 : 0);
  static constexpr int kRow = D + 2;       // acc[D], m, l
  static constexpr int kRing = kStages * kStage;
  static constexpr int kGroupStates = kGroups * R * kRow * 4;
  static constexpr int kBlock =
      ((kRing > kGroupStates ? kRing : kGroupStates) + 15) / 16 * 16;
  static constexpr int kBytes = kBlock + R * kRow * 4;
};

// QT: q/out dtype (and compute dtype). KT: arena dtype (QT, or int8 with
// f32 scales). R: query rows per block. Grid (n_split, tiles * Hkv, B).
// With n_split > 1, part holds every block's state [tiles * Hkv * B,
// n_split, R, D + 2] and ticket one counter per (row tile, kv head, b),
// zero between launches. launches: the count block (0, 0, 0) bumps.
template <typename QT, typename KT, int D, int R>
__global__ void __launch_bounds__(kThreads, R == 4 ? 4 : 2)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_arena,
                    const KT* __restrict__ v_arena,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ pos, QT* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ ticket,
                    unsigned long long* __restrict__ launches, int H,
                    int Hkv, int S, int bs, int nb, float sm_scale) {
  using L = Layout<KT, D, R>;
  constexpr int kL = D / 8;                 // lanes per token
  constexpr int kGW = 32 / kL;              // token groups per warp
  constexpr int kPer = L::kTok / L::kGroups;  // a group's tokens a stage
  static_assert(kPer >= 1, "a stage must give every group a token");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages];
  __shared__ float wgt[L::kGroups][R];
  __shared__ int last;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int g = H / Hkv, gs = g * S;
  const int tiles = (gs + R - 1) / R;
  const int tile = blockIdx.y % tiles, hk = blockIdx.y / tiles;
  const int b = blockIdx.z;
  const int r0 = tile * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0 && split == 0 && blockIdx.y == 0 && b == 0)
    atomicAdd(launches, 1ull);
  const int32_t* tab = table + (size_t)b * nb;
  // the row's block table into L2 while pos is read (4 KB a warp pass)
  if (warp == kWarps)
    for (int k = lane * 32; k < nb; k += 32 * 32) sm90::prefetch_l2(tab + k);

  // this block's share of the row's live pages, then of its tokens
  const int pos_b = pos[b];
  const int n_tok = min(pos_b + S, nb * bs);
  const int n_pages = (n_tok + bs - 1) / bs;
  const int p0 = split * n_pages / n_split;
  const int p1 = (split + 1) * n_pages / n_split;
  const int t0 = p0 * bs, t1 = min(p1 * bs, n_tok);
  const int n_st = t1 > t0 ? (t1 - t0 + L::kTok - 1) / L::kTok : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer walks the block table (lane l holds tab[base + l]);
    // its lane 0 fills stage i % kStages with up to kTok / c copies of
    // c = min(bs, kTok) tokens, each within one page, skipping those
    // past t1, once every warp has read the stage's last use
    const int c = min(bs, L::kTok);
    const int kv_bytes = c * D * (int)sizeof(KT);
    int base = -(1 << 30), entry = 0;
    for (int i = 0; i < n_st; ++i) {
      const int st = i % L::kStages;
      unsigned char* stage = smem + st * L::kStage;
      int phys[L::kTok / 8];
      int n_copy = 0;
      for (int j = 0; j < L::kTok / c; ++j) {
        const int tok = t0 + i * L::kTok + j * c;
        if (tok >= t1) break;                 // warp-uniform
        const int page = tok / bs;
        if (page >= base + 32) {
          base = page;
          entry = page + lane < nb ? tab[page + lane] : 0;
        }
        phys[j] = __shfl_sync(0xffffffffu, entry, page - base);
        ++n_copy;
      }
      if (lane == 0) {
        if (i >= L::kStages)
          sm90::mbar_wait(&empty[st], ((i / L::kStages) - 1) & 1);
        sm90::mbar_arrive_tx(
            &full[st], n_copy * (2 * kv_bytes + (L::kInt8 ? 2 * c * 4 : 0)));
        for (int j = 0; j < n_copy; ++j) {
          const int tok = t0 + i * L::kTok + j * c;
          const size_t row = ((size_t)phys[j] * Hkv + hk) * bs + tok % bs;
          sm90::bulk_load(stage + j * kv_bytes, k_arena + row * D, kv_bytes,
                          &full[st]);
          sm90::bulk_load(stage + L::kKV + j * kv_bytes, v_arena + row * D,
                          kv_bytes, &full[st]);
          if constexpr (L::kInt8) {
            sm90::bulk_load(stage + 2 * L::kKV + j * c * 4, k_scale + row,
                            c * 4, &full[st]);
            sm90::bulk_load(stage + 2 * L::kKV + L::kTok * 4 + j * c * 4,
                            v_scale + row, c * 4, &full[st]);
          }
        }
      }
      __syncwarp();
    }
  }

  // lane li of a token group ends the dot products' reduction holding
  // value v = kk * R + r (the group's token kk, row r) and keeps the
  // online softmax state of row r; lanes holding one row agree bit for
  // bit, since each step is a symmetric sum or max of the same operands
  constexpr int kN = kPer * R;              // dot products a group sums
  constexpr int kDup = kL / kN;             // lanes holding each value
  const int li = lane % kL, gid = warp * kGW + lane / kL;
  const int my_v = li / kDup, my_kk = my_v / R, my_r = my_v % R;
  float m = -FLT_MAX, l = 0.f;              // row my_r, scores in log2 units
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  // rows of this kv head's group are contiguous in [B, H, S, D]
  const size_t row_base = ((size_t)b * H + (size_t)hk * g) * S;
  if (warp < kWarps) {
    float qr[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rr = r0 + r;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qr[r][e] = rr < gs ? to_f32(q[(row_base + rr) * D
                                      + Lane<KT, D>::dim(li, e)])
                           : 0.f;
    }
    const int lim = pos_b + (r0 + my_r) % S;  // the last slot row my_r sees
    const float scale2 = sm_scale * 1.4426950408889634f;  // log2(e)

    for (int i = 0; i < n_st; ++i) {
      const int st = i % L::kStages;
      const unsigned char* stage = smem + st * L::kStage;
      const KT* ks = reinterpret_cast<const KT*>(stage);
      const KT* vs = reinterpret_cast<const KT*>(stage + L::kKV);
      const float* kscl =
          reinterpret_cast<const float*>(stage + 2 * L::kKV);
      const float* vscl = kscl + L::kTok;
      const int tok0 = t0 + i * L::kTok + gid;  // the group's token kk = 0
      sm90::mbar_wait(&full[st], (i / L::kStages) & 1);

      float dots[kN];
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        float kv[8];
        Lane<KT, D>::load(ks + (gid + kk * L::kGroups) * D, li, kv);
        if constexpr (L::kInt8) {
          const float s = kscl[gid + kk * L::kGroups];
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = round_to<QT>(kv[e] * s);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[r][e], kv[e], dot);
          dots[kk * R + r] = dot;
        }
      }
      // a slot past t1 was not copied (its score is garbage) or is
      // masked: -FLT_MAX, and P = 0
      const int t = tok0 + my_kk * L::kGroups;
      const float dot = ScatterSum<kN, kL / 2>::run(dots, li);
      const float sc = t < t1 && t <= lim ? dot * scale2 : -FLT_MAX;
      // the row's max and sum over the group's kPer tokens: the lanes
      // holding (kk, my_r) differ in the bits above R * kDup
      float mx = sc;
#pragma unroll
      for (int o = R * kDup; o < kL; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(m, mx);
      const float p = sc == -FLT_MAX ? 0.f : sm90::exp2_ftz(sc - mx);
      const float alpha = sm90::exp2_ftz(m - mx);
      float psum = p;
#pragma unroll
      for (int o = R * kDup; o < kL; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l = alpha * l + psum;
      m = mx;

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = __shfl_sync(0xffffffffu, alpha, r * kDup, kL);
        if (a != 1.f) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] *= a;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        float pk[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          pk[r] = __shfl_sync(0xffffffffu, p, (kk * R + r) * kDup, kL);
        if (tok0 + kk * L::kGroups >= t1) continue;  // not copied
        const int j = gid + kk * L::kGroups;
        float vv[8];
        Lane<KT, D>::load(vs + j * D, li, vv);
        if constexpr (L::kInt8) {
          const float s = vscl[j];
#pragma unroll
          for (int e = 0; e < 8; ++e) vv[e] = round_to<QT>(vv[e] * s);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[r][e] = fmaf(pk[r], vv[e], acc[r][e]);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
    }
  }

  // every stage consumed: the ring's memory takes the groups' states
  __syncthreads();
  float* grp = reinterpret_cast<float*>(smem);            // [groups][R][D+2]
  float* blk = reinterpret_cast<float*>(smem + L::kBlock);  // [R][D+2]
  if (warp < kWarps) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* st = grp + (gid * R + r) * L::kRow;
#pragma unroll
      for (int e = 0; e < 8; ++e) st[Lane<KT, D>::dim(li, e)] = acc[r][e];
    }
    if (my_kk == 0 && li % kDup == 0) {
      float* st = grp + (gid * R + my_r) * L::kRow;
      st[D] = m;
      st[D + 1] = l;
    }
  }
  __syncthreads();

  // fold the groups in group order: weights 2^(m_g - M) per row
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float mx = -FLT_MAX;
    for (int gi = 0; gi < L::kGroups; ++gi)
      mx = fmaxf(mx, grp[(gi * R + r) * L::kRow + D]);
    float ls = 0.f;
    for (int gi = 0; gi < L::kGroups; ++gi) {
      const float* st = grp + (gi * R + r) * L::kRow;
      wgt[gi][r] = exp2f(st[D] - mx);
      ls = fmaf(wgt[gi][r], st[D + 1], ls);
    }
    blk[r * L::kRow + D] = mx;
    blk[r * L::kRow + D + 1] = ls;
  }
  __syncthreads();
  // the block's state: in shared memory with one split, else in its
  // slot of part, followed by a ticket; the last of the n_split blocks
  // of (tile, hk, b) to take one folds every slot in split order
  const size_t cid = (size_t)b * gridDim.y + blockIdx.y;
  float* slots = n_split == 1 ? blk : part + cid * n_split * R * L::kRow;
  float* mine = slots + split * R * L::kRow;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int gi = 0; gi < L::kGroups; ++gi)
      a = fmaf(wgt[gi][r], grp[(gi * R + r) * L::kRow + d], a);
    mine[r * L::kRow + d] = a;
  }
  if (n_split > 1) {
    if (threadIdx.x < R) {
      mine[threadIdx.x * L::kRow + D] = blk[threadIdx.x * L::kRow + D];
      mine[threadIdx.x * L::kRow + D + 1] =
          blk[threadIdx.x * L::kRow + D + 1];
    }
    __threadfence();                          // the slot, then the ticket
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(ticket + cid, 1) == n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();                          // the others' slots, after
  } else {
    __syncthreads();
  }
  // every slot read is issued before any is used (the bounds are
  // unrolled to kMaxSplit), so the fold costs one L2 round trip
  const int n_rows = min(R, gs - r0);
  constexpr int kOut = (R * D + kThreads - 1) / kThreads;
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    if (idx >= n_rows * D) break;
    const int r = idx / D, d = idx % D;
    float ms[kMaxSplit], ls[kMaxSplit], as[kMaxSplit];
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) {
      if (i < n_split) {
        // the other blocks' slots are read from L2, past this SM's L1
        const float* st = slots + (i * R + r) * L::kRow;
        ms[i] = n_split == 1 ? st[D] : __ldcg(st + D);
        ls[i] = n_split == 1 ? st[D + 1] : __ldcg(st + D + 1);
        as[i] = n_split == 1 ? st[d] : __ldcg(st + d);
      }
    }
    float mx = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i)
      if (i < n_split) mx = fmaxf(mx, ms[i]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSplit; ++i) {
      if (i < n_split) {
        const float w = exp2f(ms[i] - mx);
        lsum = fmaf(w, ls[i], lsum);
        a = fmaf(w, as[i], a);
      }
    }
    out[(row_base + r0 + r) * D + d] =
        from_f32<QT>(a / (lsum == 0.f ? 1.f : lsum));
  }
  if (threadIdx.x == 0 && n_split > 1) ticket[cid] = 0;  // for the next
}

template <typename QT, typename KT, int D, int R>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* table,
                        const void* pos, void* out, void* part, void* ticket,
                        void* launches, int B, int H, int Hkv, int S, int bs,
                        int nb, float sm_scale, int n_split,
                        cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KT, D, R>;
  constexpr int bytes = Layout<KT, D, R>::kBytes;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = ((H / Hkv) * S + R - 1) / R;
  kernel<<<dim3(n_split, tiles * Hkv, B), kThreads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<QT*>(out),
      static_cast<float*>(part), static_cast<int*>(ticket),
      static_cast<unsigned long long*>(launches), H, Hkv, S, bs, nb,
      sm_scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* table,
                         const void* pos, void* out, void* part,
                         void* ticket, void* launches, int B, int H, int Hkv,
                         int S, int D, int bs, int nb, float sm_scale,
                         int n_split, cudaStream_t stream) {
  if (n_split < 1 || n_split > kMaxSplit || (n_split & (n_split - 1)) ||
      bs < 8 || (bs & (bs - 1)) || H % Hkv ||
      (n_split > 1 && (part == nullptr || ticket == nullptr)) ||
      launches == nullptr)
    return cudaErrorInvalidValue;
  const bool wide = (H / Hkv) * S > 4;       // R = 8 rows, else 4
#define NOS_ROWS(DD)                                                       \
  return wide ? launch_rows<QT, KT, DD, 8>(q, k, v, ks, vs, table, pos,   \
                                           out, part, ticket, launches,   \
                                           B, H, Hkv, S, bs, nb,          \
                                           sm_scale, n_split, stream)     \
              : launch_rows<QT, KT, DD, 4>(q, k, v, ks, vs, table, pos,   \
                                           out, part, ticket, launches,   \
                                           B, H, Hkv, S, bs, nb,          \
                                           sm_scale, n_split, stream)
  if (D == 64) NOS_ROWS(64);
  if (D == 128) NOS_ROWS(128);
#undef NOS_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes. q_dtype: 0 f32, 1 bf16; kv_dtype: the same,
// or 2 for int8 (then ks/vs are the f32 scale planes). n_split: blocks
// that split each row's live pages, 1, 2, 4 or 8; with more than one,
// part is an f32 buffer of B * Hkv * tiles * n_split * R * (D + 2)
// floats (R = 4 rows a tile when H / Hkv * S <= 4, else 8; tiles =
// ceil(H / Hkv * S / R)) and ticket an int32 buffer of B * Hkv * tiles
// zeros, which the kernel leaves zero; both may be reused by the next
// launch on the same stream. launches points at a 64-bit counter the
// launch adds one to on the card. Every arena and scale pointer must be
// 16-byte aligned (bulk copies). Returns the launch's cudaError_t; 0 is
// success.
extern "C" int nos_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* pos, void* out,
    void* part, void* ticket, void* launches, int B, int H, int Hkv, int S,
    int D, int bs, int nb, float sm_scale, int n_split, int q_dtype,
    int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_typed<float, float>(q, k, v, nullptr, nullptr, table, pos,
                                      out, part, ticket, launches, B, H, Hkv,
                                      S, D, bs, nb, sm_scale, n_split, st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, table, pos, out, part, ticket, launches, B,
        H, Hkv, S, D, bs, nb, sm_scale, n_split, st);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_typed<float, int8_t>(q, k, v, ks, vs, table, pos, out,
                                       part, ticket, launches, B, H, Hkv, S,
                                       D, bs, nb, sm_scale, n_split, st);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_typed<__nv_bfloat16, int8_t>(
        q, k, v, ks, vs, table, pos, out, part, ticket, launches, B, H, Hkv,
        S, D, bs, nb, sm_scale, n_split, st);
  return cudaErrorInvalidValue;
}
