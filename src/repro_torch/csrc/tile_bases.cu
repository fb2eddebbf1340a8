// tile_bases: the exclusive prefix of the tile totals, the tile-base level
// of the interval walk step (slot_walk/ops.py::make_blocked_step).
//
// Input: the step's inclusive plane, [B, T*128] f32 (tile_cumsum's output),
// whose lane 127 of each tile is that tile's total.  Output: (bh, bl), each
// [B, T] f32, with bh + bl the prefix of the row's totals before the tile,
// accumulated in float64 and split as bh = float(p), bl = float(p - bh);
// column 0 is (0, 0).
//
// Replaces no TPU kernel: src/repro/kernels/slot_walk/ops.py scans the
// totals with jax.lax.associative_scan on TwoSum pairs, and the port's
// plain version (kernel.py::_comp_scan) is a Hillis-Steele doubling scan,
// log2 T passes of whole-tensor ops.
//
// Bound on Hopper: bytes.  Each total is the last 4 bytes of its 512-byte
// tile, so reading it costs one 32-byte sector: 32 B a total in, 8 B out
// (bh, bl), 40 B a total in all; B = 16, T = 786,432 is 503 MB, 0.15 ms at
// 3.35 TB/s.  Design: reduce, then scan, two launches and no atomics.
//  1. tile_bases_reduce_kernel: one block per 4096 totals of a row reads
//     them (16 independent loads a thread in flight), writes them compact
//     into bh, and writes their float64 sum.
//  2. tile_bases_scan_kernel: the same blocks read the compact totals back
//     (4 B each instead of a sector), take their base as the float64 sum of
//     the row's earlier block sums, scan the chunk (16 consecutive totals a
//     thread, then the 256 thread totals across the block) and write bh and
//     bl in place.
// Every sum is taken in a fixed order, so results repeat bit for bit.  The
// blocks per row follow T: one block serves a row of at most 4096 tiles.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;  // totals a block scans
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// one float of padding a 32: the blocked reads (16 consecutive floats a
// thread) and the striped ones both land on 32 distinct banks
__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }
constexpr int kStage = kChunk + kChunk / 32;

// The block's sum of v, in a fixed order, in every thread.
__device__ double block_sum(double v, double* warp_part) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += warp_part[w];
  __syncthreads();  // warp_part is reused
  return s;
}

// The block's exclusive prefix of v over thread order, in a fixed order.
__device__ double block_exclusive(double v, double* warp_part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  double exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0.0;
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  double before = 0.0;
  for (int w = 0; w < warp; ++w) before += warp_part[w];
  __syncthreads();  // warp_part is reused
  return before + exc;
}

__global__ void __launch_bounds__(kThreads)
tile_bases_reduce_kernel(const float4* __restrict__ incl, float* __restrict__ totals,
                         double* __restrict__ sums, long long t, long long chunks) {
  __shared__ double warp_part[kWarps];
  const long long row = blockIdx.x / chunks;
  const long long j0 = (blockIdx.x - row * chunks) * kChunk;
  // a tile is 32 float4s; its total is the last one's w
  const float4* src = incl + row * t * (kTile / 4) + (kTile / 4 - 1);
  float* dst = totals + row * t;
  float v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = j0 + i * kThreads + threadIdx.x;
    v[i] = j < t ? __ldg(src + j * (kTile / 4)).w : 0.0f;
  }
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = j0 + i * kThreads + threadIdx.x;
    if (j < t) dst[j] = v[i];
    acc += static_cast<double>(v[i]);
  }
  const double s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) sums[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
tile_bases_scan_kernel(const double* __restrict__ sums, float* __restrict__ bh,
                       float* __restrict__ bl, long long t, long long chunks) {
  __shared__ float stage[kStage];
  __shared__ double warp_part[kWarps];
  const long long row = blockIdx.x / chunks;
  const long long c = blockIdx.x - row * chunks;
  const long long j0 = c * kChunk;
  float* hi = bh + row * t;
  float* lo = bl + row * t;

  double base = 0.0;  // the row's totals before this chunk
  for (long long k = threadIdx.x; k < c; k += kThreads) base += sums[row * chunks + k];
  base = block_sum(base, warp_part);

  // the chunk's totals (left in bh by the reduce), striped in, blocked out
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    stage[padded(k)] = j0 + k < t ? hi[j0 + k] : 0.0f;
  }
  __syncthreads();
  double ex[kItems];  // each of the thread's totals' exclusive prefix in it
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    ex[i] = run;
    run += static_cast<double>(stage[padded(threadIdx.x * kItems + i)]);
  }
  const double before = base + block_exclusive(run, warp_part);
  float h[kItems];
  float l[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const double p = before + ex[i];
    h[i] = static_cast<float>(p);
    l[i] = static_cast<float>(p - static_cast<double>(h[i]));
  }
  // block_exclusive synchronised after every stage read; blocked in, striped out
#pragma unroll
  for (int i = 0; i < kItems; ++i) stage[padded(threadIdx.x * kItems + i)] = h[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    if (j0 + k < t) hi[j0 + k] = stage[padded(k)];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) stage[padded(threadIdx.x * kItems + i)] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    if (j0 + k < t) lo[j0 + k] = stage[padded(k)];
  }
}

}  // namespace

// incl [b, t*128] f32 (16-byte aligned), bh and bl [b, t] f32, sums
// [b * ceil(t / 4096)] f64 scratch (n_sums must be exactly that).
extern "C" int repro_tile_bases(const float* incl, float* bh, float* bl, double* sums,
                                long long n_sums, long long b, long long t, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  const long long chunks = (t + kChunk - 1) / kChunk;
  if (n_sums != b * chunks || b * chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(b * chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_bases_reduce_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(incl), bh, sums, t, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_bases_scan_kernel<<<blocks, kThreads, 0, s>>>(sums, bh, bl, t, chunks);
  return static_cast<int>(cudaGetLastError());
}
