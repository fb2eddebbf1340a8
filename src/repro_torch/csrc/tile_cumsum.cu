// tile_cumsum: inclusive prefix sum inside each 128-slot tile, [N,128] f32.
//
// Replaces src/repro/kernels/slot_walk/kernel.py::tile_cumsum (body
// _cumsum_kernel), the intra-tile level of the interval walk step
// (slot_walk/ops.py::make_blocked_step).  The TPU kernel does one
// [1,128]@[128,128] triangular matmul per tile on the MXU.
//
// Bound on Hopper: bytes.  A tile is 512 B in and 512 B out for 127 adds,
// far below the card's ridge point, so the matmul formulation would only
// multiply the work.  Design: one warp per tile.  Each lane loads four
// consecutive floats as one 16-byte vector (a warp reads the whole tile in
// one coalesced 512-byte transaction), scans them in registers, and a
// five-step __shfl_up_sync scan of the 32 lane totals gives each lane its
// base.  No shared memory, no block-level synchronisation.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void tile_cumsum_kernel(const float4* __restrict__ x,
                                   float4* __restrict__ y,
                                   long long n_tiles) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp leaves together
  const long long at = tile * (kTile / 4) + lane;
  float4 v = x[at];
  v.y += v.x;
  v.z += v.y;
  v.w += v.z;
  float run = v.w;  // inclusive scan of the lane totals
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, run, d);
    if (lane >= d) run += o;
  }
  float base = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) base = 0.0f;
  v.x += base;
  v.y += base;
  v.z += base;
  v.w += base;
  y[at] = v;
}

}  // namespace

extern "C" int repro_tile_cumsum(const float* x, float* y, long long n_tiles,
                                 void* stream) {
  if (n_tiles <= 0) return 0;
  const long long blocks = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tile_cumsum_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}
