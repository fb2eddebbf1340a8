// slot_walk_partials: one walk step's per-tile run reduction, [T,128] tiles.
//
// Replaces src/repro/kernels/slot_walk/kernel.py::slot_walk_partials (body
// _kernel), the tile level of the interval-less reverse walk
// (slot_walk/ops.py::slot_walk_pallas / slot_walk_multi_pallas).  Within a
// 128-slot tile the owning rows form contiguous runs; each run gets a local
// rank (the count of run starts before it), and the kernel writes
//   partials[t, rank]  = the sum of the run's vals (0 for unused ranks)
//   rank_rows[t, rank] = the run's row if 0 <= row < sink, else sink
// The TPU kernel builds a [slot, rank] one-hot matrix and reduces with one
// [1,128]@[128,128] MXU matmul per tile.
//
// Bound on Hopper: bytes.  A tile is 512 B of rows and 512 B of vals in and
// 1 KiB out for ~128 adds.  Design: one warp per tile, four consecutive
// slots per lane, read as one 16-byte vector each (the warp reads each
// operand's tile in one coalesced 512-byte transaction).  Run-start flags
// come from the neighbouring slot (a shuffle across lanes), a warp scan of
// the flag counts gives each slot its rank, and a segmented warp scan of
// vals gives each run end its run's sum, added left to right with no
// cancellation.  The per-rank results are placed in the warp's slice of
// shared memory (pre-filled with 0 / sink) and written out as 16-byte
// vectors, so the stores are coalesced as well.
//
// Batched walks: ``vals`` holds n_tiles = B * rows_tiles tiles and tile t
// reads rows[t % rows_tiles], so the rows are never copied B times;
// rank_rows depends on the rows alone and is written for the first
// rows_tiles tiles only.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int rank_row(int row, int sink) {
  return static_cast<unsigned>(row) < static_cast<unsigned>(sink) ? row : sink;
}

__global__ void slot_walk_partials_kernel(const int4* __restrict__ rows,
                                          const float4* __restrict__ vals,
                                          long long n_tiles,
                                          long long rows_tiles, int sink,
                                          float4* __restrict__ partials,
                                          int4* __restrict__ rank_rows) {
  __shared__ float4 s_part[kWarpsPerBlock][kTile / 4];
  __shared__ int4 s_rank[kWarpsPerBlock][kTile / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;  // the whole warp leaves together
  const long long rtile = tile % rows_tiles;
  const int4 r = rows[rtile * (kTile / 4) + lane];
  const float4 v = vals[tile * (kTile / 4) + lane];

  // run-start flags: slot 0 of the tile always starts a run
  const int prev = __shfl_up_sync(kFull, r.w, 1);
  const int f0 = lane == 0 || r.x != prev;
  const int f1 = r.y != r.x;
  const int f2 = r.z != r.y;
  const int f3 = r.w != r.z;
  // run ends: the next slot starts a run, or this is the tile's last slot
  const int next_start = __shfl_down_sync(kFull, f0, 1);
  const int e3 = lane == 31 || next_start;

  // ranks: an inclusive warp scan of the per-lane flag counts
  const int cnt = f0 + f1 + f2 + f3;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  const int k0 = incl - cnt + f0 - 1;
  const int k1 = k0 + f1;
  const int k2 = k1 + f2;
  const int k3 = k2 + f3;

  // segmented scan of vals: in-lane first, then across lanes on the
  // (trailing sum, any flag) pairs, then the carry re-enters the lane
  float agg = v.x;
  agg = f1 ? v.y : agg + v.y;
  agg = f2 ? v.z : agg + v.z;
  agg = f3 ? v.w : agg + v.w;
  int seg = f0 | f1 | f2 | f3;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ov = __shfl_up_sync(kFull, agg, d);
    const int of = __shfl_up_sync(kFull, seg, d);
    if (lane >= d) {
      if (!seg) agg = ov + agg;
      seg |= of;
    }
  }
  const float carry = __shfl_up_sync(kFull, agg, 1);  // unused by lane 0 (f0)
  const float s0 = f0 ? v.x : carry + v.x;
  const float s1 = f1 ? v.y : s0 + v.y;
  const float s2 = f2 ? v.z : s1 + v.z;
  const float s3 = f3 ? v.w : s2 + v.w;

  float* part = reinterpret_cast<float*>(s_part[warp]);
  int* rank = reinterpret_cast<int*>(s_rank[warp]);
  s_part[warp][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  s_rank[warp][lane] = make_int4(sink, sink, sink, sink);
  __syncwarp();
  // each run end owns its rank; a run's slots share one row
  if (f1) { part[k0] = s0; rank[k0] = rank_row(r.x, sink); }
  if (f2) { part[k1] = s1; rank[k1] = rank_row(r.y, sink); }
  if (f3) { part[k2] = s2; rank[k2] = rank_row(r.z, sink); }
  if (e3) { part[k3] = s3; rank[k3] = rank_row(r.w, sink); }
  __syncwarp();
  partials[tile * (kTile / 4) + lane] = s_part[warp][lane];
  if (tile < rows_tiles) rank_rows[tile * (kTile / 4) + lane] = s_rank[warp][lane];
}

}  // namespace

extern "C" int repro_slot_walk_partials(const int* rows, const float* vals,
                                        long long n_tiles,
                                        long long rows_tiles, int sink,
                                        float* partials, int* rank_rows,
                                        void* stream) {
  if (n_tiles <= 0) return 0;
  const long long blocks = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  slot_walk_partials_kernel<<<static_cast<unsigned>(blocks),
                              kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(rows), reinterpret_cast<const float4*>(vals),
      n_tiles, rows_tiles, sink, reinterpret_cast<float4*>(partials),
      reinterpret_cast<int4*>(rank_rows));
  return static_cast<int>(cudaGetLastError());
}
