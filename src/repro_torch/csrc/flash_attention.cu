// flash_attention: online-softmax attention with causal and sliding-window
// masks and GQA head grouping.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _kernel), the prefill attention of the transformer
// (models/transformer/attention.py, attn_impl="flash").  It computes what the
// TPU kernel computes, in its order of operations:
//   s   = (q . k) * scale, f32 (scaled after the dot), scale = 1/sqrt(D)
//   s   = NEG_INF (-1e30) where masked: k > q (causal), k <= q - window
//         (window > 0), and keys >= Skv
//   m'  = max(m, rowmax s);  p = exp(s - m') masked to 0 again
//   l'  = exp(m - m') * l + rowsum p;  acc' = exp(m - m') * acc + p . v
//   out = acc / max(l, 1e-30), in the input's type (a row that sees no key
//         gives 0)
// with query head h of batch b reading kv head b*Hkv + h/(Hq/Hkv).  The TPU
// kernel walks a (B*Hq, Sq/BQ, Skv/BK) grid with the kv axis innermost and
// keeps m, l and acc in VMEM scratch; a @pl.when skips kv blocks that are
// fully masked.
//
// Bound on Hopper: operations.  A visible (query, key) pair costs 4*D
// operations (two products), against 8*D bytes of q, k, v and o over the
// whole call; at the prefill's shape (S = 32768, window 4096, D = 80) that
// is ~3,000 operations a byte.  Design: one block of 256 threads per
// (b*Hq, 64-row query tile); the TPU's kv grid axis is a loop inside the
// block over 64-key tiles, and the skip is the loop's bounds, so only tiles
// in [q0 - window + 1, q0 + 63] are visited (O(S*w) work, not O(S^2)).  The
// q tile and each K and V tile are converted to f32 in shared memory (K with
// an odd number of 16-byte chunks a row, so float4 reads of 8 rows hit 8
// bank groups).  A thread owns 4 query rows x 4 keys (keys tx + 16j) of the
// score tile and 4 rows x ceil(D/16) output columns (tx + 16j); m and l live
// in registers, per row, reduced across the 16 threads of a row by
// shuffles.  Arithmetic is FP32 FMA on the CUDA cores, as the TPU kernel's
// is f32.  Tensor cores (mma/wgmma), TMA, a pipelined tile ring and one
// block per kv head serving its query heads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 row groups (ty) x 16 key lanes (tx)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace

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
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, bhq, hq, hkv, sq, skv, d, causal, window,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
