// embedding_bag: gather-and-reduce of table rows over [B,K] index bags.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag (body
// _kernel), the pooling of the two-tower model's sparse fields
// (models/recsys/two_tower.py::tower_forward).  For bag b and slot k, an id
// of -1 (any negative id) is padding; an id >= V reads row V-1.  The
// combines, as the TPU kernel computes them:
//   sum   out[b] = sum over valid k of table[id] * w[b,k], in slot order
//   mean  that sum divided by max(count of valid slots, 1)
//   max   the element-wise maximum of the valid rows (weights ignored);
//         a non-finite result (an empty bag) becomes 0
// The TPU kernel rides the indices in as a scalar-prefetch operand and DMAs
// one [1,D] table row per (bag, slot) grid step.
//
// Bound on Hopper: bytes.  Each valid slot reads one random table row
// (1 KiB at D = 256) and does D multiply-adds.  Design: one warp per bag,
// the lanes across D as float4 vectors when D % 4 == 0 (D = 256 is 64
// float4s, two per lane), so a row is read in 16-byte coalesced pieces.
// The bag's ids and weights are read by the lanes in groups of 32 and
// broadcast by shuffle; the slot loop runs in order, so each sum is taken
// left to right, one FMA a term.  The table is not staged or cached: its
// rows are random and a bag reads each once.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerLane = 2;  // vectors a lane holds per pass over D
enum Combine { kSum = 0, kMean = 1, kMax = 2 };

template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> vload(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.x[0] = q.x; r.x[1] = q.y; r.x[2] = q.z; r.x[3] = q.w;
  } else {
    r.x[0] = p[0];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void vstore(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
  } else {
    p[0] = v.x[0];
  }
}

// V: floats per vector (4 when D % 4 == 0, else 1)
template <int V, int C>
__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int* __restrict__ indices,
                                     const float* __restrict__ weights,
                                     long long n_bags, int k, long long vocab,
                                     int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // the whole warp leaves together
  const int* ids = indices + bag * k;
  const float* wts = weights + bag * k;
  const int n_vec = d / V;
  const float init = C == kMax ? -__int_as_float(0x7f800000) : 0.f;

  for (int v0 = 0; v0 < n_vec; v0 += 32 * kPerLane) {
    Vec<V> acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j].x[i] = init;
    int count = 0;
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int mine = k0 + lane < k ? ids[k0 + lane] : -1;
      const float mw = k0 + lane < k ? wts[k0 + lane] : 0.f;
      count += __popc(__ballot_sync(kFull, mine >= 0));
      const int n = k - k0 < 32 ? k - k0 : 32;
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const int id = __shfl_sync(kFull, mine, s);
        const float w = __shfl_sync(kFull, mw, s);
        if (id < 0) continue;  // padding; uniform across the warp
        const long long row = id < vocab ? id : vocab - 1;
        const float* rp = table + row * d;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int vi = v0 + j * 32 + lane;
          if (vi >= n_vec) continue;
          const Vec<V> x = vload<V>(rp + vi * V);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if constexpr (C == kMax) {
              // NaN propagates, as jnp.maximum does
              const float a = acc[j].x[i];
              acc[j].x[i] = (x.x[i] > a || x.x[i] != x.x[i]) ? x.x[i] : a;
            } else {
              acc[j].x[i] = fmaf(x.x[i], w, acc[j].x[i]);
            }
          }
        }
      }
    }
    const float denom = count > 1 ? static_cast<float>(count) : 1.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int vi = v0 + j * 32 + lane;
      if (vi >= n_vec) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float a = acc[j].x[i];
        if constexpr (C == kMean) a = a / denom;
        if constexpr (C == kMax) a = isfinite(a) ? a : 0.f;
        acc[j].x[i] = a;
      }
      vstore<V>(out + bag * d + vi * V, acc[j]);
    }
  }
}

template <int V, int C>
int launch(const float* table, const int* indices, const float* weights,
           long long n_bags, int k, long long vocab, int d, float* out,
           cudaStream_t stream) {
  const long long blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<V, C>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          table, indices, weights, n_bags, k, vocab, d, out);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int dispatch(int combine, const float* table, const int* indices,
             const float* weights, long long n_bags, int k, long long vocab,
             int d, float* out, cudaStream_t stream) {
  switch (combine) {
    case kSum:
      return launch<V, kSum>(table, indices, weights, n_bags, k, vocab, d, out, stream);
    case kMean:
      return launch<V, kMean>(table, indices, weights, n_bags, k, vocab, d, out, stream);
    case kMax:
      return launch<V, kMax>(table, indices, weights, n_bags, k, vocab, d, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// combine: 0 sum, 1 mean, 2 max.  table 16-byte aligned when d % 4 == 0.
extern "C" int repro_embedding_bag(const float* table, const int* indices,
                                   const float* weights, long long n_bags, int k,
                                   long long vocab, int d, int combine,
                                   float* out, void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  if (vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0) {
    return dispatch<4>(combine, table, indices, weights, n_bags, k, vocab, d, out, st);
  }
  return dispatch<1>(combine, table, indices, weights, n_bags, k, vocab, d, out, st);
}
