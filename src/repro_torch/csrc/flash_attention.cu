// flash_attention: online-softmax attention with causal and sliding-window
// masks and GQA head grouping.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _kernel, pl.pallas_call at kernel.py:116), the prefill attention of
// the transformer (models/transformer/attention.py, attn_impl="flash").  It
// computes what the TPU kernel computes, in its order of operations:
//   s   = (q . k) * scale, f32 (scaled after the dot), scale = 1/sqrt(D)
//   s   = NEG_INF (-1e30) where masked: k > q (causal), k <= q - window
//         (window > 0), and keys >= Skv
//   m'  = max(m, rowmax s);  p = exp(s - m') masked to 0 again
//   l'  = exp(m - m') * l + rowsum p (f32 p);  acc' = exp(m - m') * acc + p . v
//   out = acc / max(l, 1e-30), in the input's type (a row that sees no key
//         gives 0)
// with query head h of batch b reading kv head b*Hkv + h/(Hq/Hkv).  The TPU
// kernel walks a (B*Hq, Sq/BQ, Skv/BK) grid with the kv axis innermost and
// keeps m, l and acc in VMEM scratch; a @pl.when skips kv blocks that are
// fully masked.  Here the kv axis is a loop inside a block, bounded to the
// keys its query tile can see ([q0 - window + 1, q0 + BQ) when causal), so
// the work is O(S*w), not O(S^2).
//
// Bound on Hopper: operations.  A visible (query, key) pair costs 4*D
// operations (two products) against 8*D bytes of q, k, v and o over the
// whole call; at the prefill's shape (S = 32768, window 4096, D = 80) that
// is ~3,000 operations a byte, so the bound is the pairs' operations at the
// bf16 tensor-core peak of 989 TFLOP/s (bf16 inputs make each q.k product
// exact in f32): 1.30 ms a layer.
//
// Two kernels, chosen by type, head dim and alignment alone
// (repro_flash_attention_path):
//
// * tc (bfloat16, D % 8 == 0, Skv > 0, 16-byte aligned operands): the
//   tensor-core kernel.  A block of 416 threads takes a 192-row query tile
//   of one query head: three consumer warpgroups of 64 rows and one
//   producer warp.  The producer's elected thread brings the Q tile once
//   and then K and V tiles of 64 keys by TMA (cp.async.bulk.tensor) into a
//   ring of 3 shared-memory stages, each under a "full" mbarrier
//   (expect-tx bytes) and an "empty" one (one arrival per consumer warp).
//   The tile shape was measured at one prefill layer on an H100 (PERF.md
//   section 6): 64 keys x 3 warpgroups ran fastest, ahead of 128 x 2,
//   64 x 2, 64 x 1 and 128 x 1; a warpgroup's product, softmax and product
//   run in turn, and the other warpgroups fill the tensor cores meanwhile.
//   Issuing the next Q.K^T before the softmax (P kept in two register
//   buffers, or ptxas serialises every wgmma) ran slower at two warpgroups
//   and spilled at three.  Every tile lands as D/16 boxes of [rows][16]
//   bf16 with the 32-byte swizzle: a box row is one wgmma k-step (16 bf16 =
//   32 bytes), so any D = 16n takes n k-steps with one descriptor layout,
//   and D = 8 (mod 16) is padded to 16n by TMA's zero fill.  At D = 80
//   that is 5 k-steps and no padding, where a 128-byte swizzle (64
//   columns) would need 8 with zeros or two layouts.
//   S = Q.K^T is wgmma m64n64k16 with both operands in shared memory,
//   K-major; the softmax works on the accumulator fragment in registers
//   (a row lives in the 4 threads of a quad: row max and sum by shuffles
//   1 and 2; l is kept per thread and summed at the end), with log2(e)
//   folded into the scale (p = 2^(s*scale*log2e - m), ex2.approx).  Only
//   edge tiles (the diagonal, the window's left edge, a ragged last key
//   tile) evaluate the mask; a tile that none of a warpgroup's rows can
//   see is skipped by that warpgroup.  P.V is wgmma m64nDk16 with P from
//   registers (the accumulator fragment is the A fragment) and V from
//   shared memory, MN-major (transpose bit).  The TPU's p is f32, and one
//   bf16 rounding of p costs up to 2^-9*max|v|, above the 2^-12*max|v| the
//   kernel is held to, so p is split: p_hi = bf16(p), p_lo = bf16(p - p_hi),
//   and both go through the tensor cores into one accumulator (~2^-17
//   relative; 1.5x the tensor work of one P.V).  The output tile is staged
//   in shared memory and written with 16-byte stores; rows >= Sq are never
//   written.  Blocks are ordered so that the query heads of one kv head
//   run next to each other (their K/V window is read from L2), longest
//   query tiles first.
// * simt (float32 at any D <= 128, and the other bfloat16 calls): one block
//   of 256 threads per 64-row query tile, K and V tiles converted to f32 in
//   shared memory (K with an odd number of 16-byte chunks a row, so float4
//   reads of 8 rows hit 8 bank groups), FP32 FMAs on the CUDA cores; a
//   thread owns 4 rows x 4 keys of the scores and 4 rows x ceil(D/16)
//   output columns, m and l per row in registers.  float32 stays off the
//   tensor cores: TF32 keeps 10 bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

namespace simt {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 row groups (ty) x 16 key lanes (tx)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Reduce over the 16 lanes of one query row (lanes tx = 0..15 of a half warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [r0, r0 + rows) of a row-major [n, d] matrix into shared memory as
// f32 with row stride `stride`; rows >= n and columns in [d, DQ) are 0.
template <typename T, int DQ>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int n,
                                          int d, int rows, float* dst, int stride) {
  for (int i = threadIdx.x; i < rows * DQ; i += kThreads) {
    const int r = i / DQ, c = i % DQ;
    float x = 0.f;
    if (r0 + r < n && c < d) x = to_f32(src[static_cast<long long>(r0 + r) * d + c]);
    dst[r * stride + c] = x;
  }
}

// NJ = ceil(D / 16): output columns a thread owns; DQ = 16 * NJ >= D is the
// zero-padded width of the shared tiles.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int hq,
                           int hkv, int sq, int skv, int d, int causal, int window,
                           float scale) {
  constexpr int DQ = 16 * NJ;
  constexpr int KS = DQ + 4;  // K row stride: an odd number of float4s
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][DQ]
  float* v_s = q_s + kBQ * DQ;                   // [kBK][DQ]
  float* p_s = v_s + kBK * DQ;                   // [kBQ][kBK]
  float* k_s = p_s + kBQ * kBK;                  // [kBK][KS]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;  // b * hq + h
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* qp = q + static_cast<long long>(bh) * sq * d;
  const T* kp = k + static_cast<long long>(bkv) * skv * d;
  const T* vp = v + static_cast<long long>(bkv) * skv * d;

  load_tile<T, DQ>(qp, q0, sq, d, kBQ, q_s, DQ);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the keys any row of the tile can see; other tiles are fully masked
  // and would leave m, l and acc as they are
  const int k_end = causal ? min(skv, q0 + kBQ) : skv;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's P.V is done with v_s and p_s
    load_tile<T, DQ>(kp, k0, skv, d, kBK, k_s, KS);
    load_tile<T, DQ>(vp, k0, skv, d, kBK, v_s, DQ);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DQ; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * DQ + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * KS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        vis[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        p_s[(ty * 4 + i) * kBK + tx + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * kBK + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = v_s[(c + cc) * DQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = o + (static_cast<long long>(bh) * sq + qi) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) op[col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int bhq, int hq,
           int hkv, int sq, int skv, int d, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int DQ = 16 * NJ;
  const int smem = (kBQ * DQ + kBK * DQ + kBQ * kBK + kBK * (DQ + 4)) * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, sq, skv, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bhq, int hq,
             int hkv, int sq, int skv, int d, int causal, int window, float scale,
             cudaStream_t st) {
  switch ((d + 15) / 16) {
#define REPRO_FA_CASE(NJ)                                                           \
  case NJ:                                                                          \
    return launch<T, NJ>(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal, window, scale, \
                         st);
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    REPRO_FA_CASE(8)
#undef REPRO_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace simt

namespace tc {

constexpr int kBK = 64;                           // keys a tile
constexpr int kWarpgroups = 3;                    // consumers, 64 query rows each
constexpr int kBQ = 64 * kWarpgroups;             // query rows a block
constexpr int kStages = 3;                        // K/V tiles in flight
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;         // and the producer warp
constexpr int kBoxCols = 16;                      // bf16 columns of a box: one 32-byte row
constexpr int kQBox = kBQ * 32;                   // bytes of one Q box
constexpr int kKVBox = kBK * 32;                  // bytes of one K or V box
constexpr int kSwizzleRows = 8;                   // rows of a 32-byte swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int smem_bytes(int dp) {
  // alignment slack, Q boxes, the K/V ring, the output staging tile
  return 1024 + (dp / kBoxCols) * (kQBox + kStages * 2 * kKVBox) + kBQ * (dp + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 3 (B32).
__device__ __forceinline__ uint64_t desc_b32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         3ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across a fence/wait.
template <int R>
__device__ __forceinline__ void pin(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DP = D rounded up to 16: the columns of a Q, K or V tile (NB boxes).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       int group, int n_qt, int sq, int skv, int d, int causal, int window,
                       float scale_log2) {
  constexpr int NB = DP / kBoxCols;
  constexpr int kStageBytes = 2 * NB * kKVBox;  // NB K boxes, then NB V boxes
  constexpr int kOStride = DP + 8;              // staging row (elements): no bank conflicts
  constexpr int kSbo = kSwizzleRows * 32;       // bytes between 8-row groups
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;  // swizzled boxes sit on 1 KB
  const uint32_t q_s = raw + pad;
  const uint32_t ring = q_s + NB * kQBox;
  __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + pad + NB * kQBox +
                                                        kStages * kStageBytes);
  const uint32_t full = smem_u32(&bars[0]);        // + 8 * stage
  const uint32_t empty = smem_u32(&bars[kStages]);  // + 8 * stage
  const uint32_t q_bar = smem_u32(&bars[2 * kStages]);

  // block -> (kv head, query tile, query head of the group), group fastest
  const int id = blockIdx.x;
  const int g = id % group;
  const int qt = n_qt - 1 - (id / group) % n_qt;
  const int bkv = id / (group * n_qt);
  const int bh = bkv * group + g;
  const int q0 = qt * kBQ;
  const int k_end = causal ? min(skv, q0 + kBQ) : skv;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread issues
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_bar, NB * kQBox);
      for (int j = 0; j < NB; ++j) tma_load(q_s + j * kQBox, &tm_q, q_bar, j * kBoxCols, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t st = ring + s * kStageBytes;
        const int k0 = k_first + i * kBK;
        mbar_arrive_expect_tx(full + 8 * s, kStageBytes);
        for (int j = 0; j < NB; ++j)
          tma_load(st + j * kKVBox, &tm_k, full + 8 * s, j * kBoxCols, k0, bkv);
        for (int j = 0; j < NB; ++j)
          tma_load(st + (NB + j) * kKVBox, &tm_v, full + 8 * s, j * kBoxCols, k0, bkv);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [qw, qw + 64); this thread's rows r0, r0 + 8.
  // The warpgroup index goes through a shuffle, so that ptxas knows it is
  // uniform and builds the wgmma descriptors in uniform registers.
  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qw = q0 + wg * 64;
  const int r0 = qw + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * 64 * 32;  // this warpgroup's rows of each Q box

  float acc[DP / 2], sc[kBK / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) sc[e] = 0.f;

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = k_first + i * kBK;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const bool unseen = qw >= sq || (causal && k0 > qw + 63) ||
                        (window > 0 && k0 + kBK - 1 <= qw - window);
    if (!unseen) {
      const uint32_t st = ring + s * kStageBytes;
      // S = Q . K^T
      pin(sc);
      wg_fence();
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_ss<kBK>(sc, desc_b32(q_wg + j * kQBox, 16, kSbo),
                      desc_b32(st + j * kKVBox, 16, kSbo), j > 0);
      wg_commit();
      wg_wait_all();
      pin(sc);

      // row maxima of the raw scores (masked: -inf, edge tiles only)
      float mx[2] = {-INFINITY, -INFINITY};
      const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > qw) ||
                        (window > 0 && k0 <= qw + 63 - window);
      if (edge) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int key = k0 + 8 * (e / 4) + c0 + (e & 1);
          const int row = r0 + 8 * ((e / 2) & 1);
          const bool vis = key < skv && (!causal || key <= row) &&
                           (window <= 0 || key > row - window);
          sc[e] = vis ? sc[e] : -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], sc[e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      // p = 2^(s * scale * log2e - m) (0 where masked), split into bf16 hi + lo
      float ps[2] = {0.f, 0.f};
      uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
      for (int e = 0; e < kBK / 2; e += 2) {
        const int r = (e / 2) & 1;
        const float p0 = ex2(fmaf(sc[e], scale_log2, -m[r]));
        const float p1 = ex2(fmaf(sc[e + 1], scale_log2, -m[r]));
        ps[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        p_hi[e / 8][(e / 2) % 4] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[e / 8][(e / 2) % 4] =
            pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ps[r];
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[(e / 2) & 1];

      // acc += (p_hi + p_lo) . V
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc_b32(st + NB * kKVBox + kk * 16 * 32, kKVBox, kSbo);
        wgmma_rs<DP>(acc, p_hi[kk], dv);
        wgmma_rs<DP>(acc, p_lo[kk], dv);
      }
      wg_commit();
      wg_wait_all();
      pin(acc);
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  // out = acc / max(l, 1e-30): staged in shared memory, 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* o_wg = o_s + wg * 64 * kOStride;
  const int lr = warp * 16 + lane / 4;
#pragma unroll
  for (int e = 0; e < DP / 2; e += 2) {
    const int r = (e / 2) & 1;
    *reinterpret_cast<__nv_bfloat162*>(o_wg + (lr + 8 * r) * kOStride + 8 * (e / 4) + c0) =
        __floats2bfloat162_rn(acc[e] / l[r], acc[e + 1] / l[r]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int chunks = d / 8;  // 16-byte chunks of an output row
  for (int c = threadIdx.x % 128; c < 64 * chunks; c += 128) {
    const int row = qw + c / chunks;
    if (row < sq)
      *reinterpret_cast<uint4*>(o + (static_cast<long long>(bh) * sq + row) * d +
                                8 * (c % chunks)) =
          *reinterpret_cast<const uint4*>(o_wg + (c / chunks) * kOStride + 8 * (c % chunks));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                        cudaEnableDefault, &found) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
#endif
      p = nullptr;
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// [heads, rows, d] bf16, row-major, read in boxes of [1, box_rows, 16] with
// the 32-byte swizzle; columns >= d and rows >= `rows` read as 0
bool make_map(CUtensorMap* map, const void* base, int heads, int rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int bhq, int hq, int hkv,
           int sq, int skv, int d, int causal, int window, float scale, cudaStream_t stream) {
  const int group = hq / hkv, bhkv = bhq / group;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bhq, sq, d, kBQ) || !make_map(&tk, k, bhkv, skv, d, kBK) ||
      !make_map(&tv, v, bhkv, skv, d, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(bhq) * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc<DP><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), group, n_qt, sq, skv, d, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int bhq, int hq, int hkv,
             int sq, int skv, int d, int causal, int window, float scale, cudaStream_t st) {
  switch ((d + 15) / 16) {
#define REPRO_FA_TC_CASE(NB)                                                               \
  case NB:                                                                                 \
    return launch<16 * NB>(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal, window, scale, st);
    REPRO_FA_TC_CASE(1)
    REPRO_FA_TC_CASE(2)
    REPRO_FA_TC_CASE(3)
    REPRO_FA_TC_CASE(4)
    REPRO_FA_TC_CASE(5)
    REPRO_FA_TC_CASE(6)
    REPRO_FA_TC_CASE(7)
    REPRO_FA_TC_CASE(8)
#undef REPRO_FA_TC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc
}  // namespace

// 1 when repro_flash_attention takes the tensor-core kernel for these
// operands, 0 when it takes the FMA kernel: bfloat16, D % 8 == 0 (TMA's
// 16-byte row pitch), Skv > 0 and every operand 16-byte aligned.
extern "C" int repro_flash_attention_path(const void* q, const void* k, const void* v,
                                          const void* o, int skv, int d, int dtype) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return dtype == 1 && d % 8 == 0 && skv > 0 && aligned(q) && aligned(k) && aligned(v) &&
         aligned(o);
}

// q [B*Hq, Sq, D], k/v [B*Hkv, Skv, D], o [B*Hq, Sq, D], all row-major and of
// one type: dtype 0 float32, 1 bfloat16.  1 <= D <= 128, Hq % Hkv == 0,
// B*Hq <= 65535.  window <= 0 means no window.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int bhq, int hq, int hkv, int sq, int skv,
                                     int d, int causal, int window, float scale,
                                     int dtype, void* stream) {
  if (bhq <= 0 || sq <= 0) return 0;
  if (d < 1 || d > 128 || hq <= 0 || hkv <= 0 || hq % hkv || bhq % hq || bhq > 65535 ||
      skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (repro_flash_attention_path(q, k, v, o, skv, d, dtype))
    return tc::dispatch(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal, window, scale, st);
  if (dtype == 0)
    return simt::dispatch<float>(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal, window, scale,
                                 st);
  if (dtype == 1)
    return simt::dispatch<__nv_bfloat16>(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal,
                                         window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
