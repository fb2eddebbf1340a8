// edge_segment_partials: per-tile run sums of row-sorted edge values,
// [T,128] rows and [T,128,Dp] values.
//
// Replaces src/repro/kernels/edge_segment_sum/kernel.py::edge_segment_partials
// (body _kernel), the tile level of edge_segment_sum/ops.py::edge_segment_sum
// (GNN neighbour aggregation over a CSR).  Within a 128-edge tile the rows
// form contiguous runs; each run gets a local rank (the count of run starts
// before it, slot 0 always starting one), and the kernel writes
//   partials[t, rank, :] = the sum of the run's value rows (0 for unused ranks)
//   rank_rows[t, rank]   = the run's row if 0 <= row < sink, else sink
// The TPU kernel builds a [edge, rank] one-hot matrix and reduces with one
// [128,128]@[128,d_tile] MXU matmul per tile and d-tile; the d-tile grid
// axis is a VMEM tiling detail and is not carried over, only the layout.
//
// Bound on Hopper: bytes.  A tile moves 512 B of rows and 512*Dp B of
// values in and as much out, for ~128*Dp adds.  Design: one warp per tile
// (slot_walk_partials.cu made Dp columns wide).
//   1. Each lane reads four consecutive rows as one 16-byte vector; run
//      flags come from the neighbouring slot by shuffle, a warp scan of the
//      flag counts gives every slot its rank, and each slot's rank and
//      start/end flags go to the warp's slice of shared memory, with the
//      rank rows (written out once per tile as 16-byte vectors).
//   2. The values are read in the tile's own order, 32 vectors (float4
//      where Dp % 4 == 0) a step: a step covers S = 32 / CB slots of CB
//      vector columns each, so the warp reads 512 contiguous bytes when CB
//      spans the slot's row (Dp a power of two up to 128) or is 32.  A
//      segmented scan over the S slots (shuffles by multiples of CB) plus
//      the carry of the previous step's last slot gives each run end its
//      run's sum over the run's own terms only (a tree within a step, a
//      running carry across steps): no one-hot product and no prefix
//      difference, so nothing cancels.  Run ends write their rank's row.
//   3. Ranks at and beyond the tile's run count are written as zeros, as
//      the TPU kernel's contract has it (writing only live ranks would
//      halve the bytes; that is a redesign of the op, not of this kernel).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

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
#pragma unroll
    for (int i = 0; i < V; ++i) r.x[i] = p[i];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void vstore(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v.x[i];
  }
}

template <int V>
__device__ __forceinline__ Vec<V> vadd(const Vec<V>& a, const Vec<V>& b) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = a.x[i] + b.x[i];
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> vshfl_up(const Vec<V>& a, int d) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = __shfl_up_sync(kFull, a.x[i], d);
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> vshfl(const Vec<V>& a, int src) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = __shfl_sync(kFull, a.x[i], src);
  return r;
}

__device__ __forceinline__ int rank_row(int row, int sink) {
  return static_cast<unsigned>(row) < static_cast<unsigned>(sink) ? row : sink;
}

// V: floats per vector (4 or 1); CB: vector columns a step covers, a power
// of two dividing the slot's dp / V vectors (blocks of 32 when 32 divides)
template <int V, int CB>
__global__ void edge_segment_partials_kernel(const int4* __restrict__ rows,
                                             const float* __restrict__ vals,
                                             long long n_tiles, int dp, int sink,
                                             float* __restrict__ partials,
                                             int4* __restrict__ rank_rows) {
  constexpr int S = 32 / CB;  // slots a step covers
  __shared__ int s_rank[kWarpsPerBlock][kTile];
  __shared__ int s_flag[kWarpsPerBlock][kTile];  // bit 0 run start, bit 1 run end
  __shared__ __align__(16) int s_rr[kWarpsPerBlock][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;  // the whole warp leaves together

  // 1. flags, ranks and rank rows --------------------------------------
  const int4 r = rows[tile * (kTile / 4) + lane];
  const int prev = __shfl_up_sync(kFull, r.w, 1);
  const int f0 = lane == 0 || r.x != prev;  // slot 0 always starts a run
  const int f1 = r.y != r.x;
  const int f2 = r.z != r.y;
  const int f3 = r.w != r.z;
  const int next_start = __shfl_down_sync(kFull, f0, 1);
  const int e3 = lane == 31 || next_start;
  const int cnt = f0 + f1 + f2 + f3;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  const int n_runs = __shfl_sync(kFull, incl, 31);
  const int k0 = incl - cnt + f0 - 1;
  const int k1 = k0 + f1;
  const int k2 = k1 + f2;
  const int k3 = k2 + f3;
  int* rank = s_rank[warp];
  int* flag = s_flag[warp];
  int* rr = s_rr[warp];
  const int s = 4 * lane;
  rank[s] = k0; rank[s + 1] = k1; rank[s + 2] = k2; rank[s + 3] = k3;
  flag[s] = f0 | (f1 << 1);
  flag[s + 1] = f1 | (f2 << 1);
  flag[s + 2] = f2 | (f3 << 1);
  flag[s + 3] = f3 | (e3 << 1);
  reinterpret_cast<int4*>(rr)[lane] = make_int4(sink, sink, sink, sink);
  __syncwarp();
  // each run end owns its rank; a run's slots share one row
  if (f1) rr[k0] = rank_row(r.x, sink);
  if (f2) rr[k1] = rank_row(r.y, sink);
  if (f3) rr[k2] = rank_row(r.z, sink);
  if (e3) rr[k3] = rank_row(r.w, sink);
  __syncwarp();
  rank_rows[tile * (kTile / 4) + lane] = reinterpret_cast<const int4*>(rr)[lane];

  // 2. segmented run sums, S slots x CB vector columns a step ----------
  const int g = lane / CB;  // slot within the step
  const int c = lane % CB;  // vector column within the block
  const int n_vec = dp / V;
  const float* vt = vals + tile * kTile * dp;
  float* pt = partials + tile * kTile * dp;
  for (int cb = 0; cb < n_vec; cb += CB) {
    const int col = (cb + c) * V;
    Vec<V> carry;
#pragma unroll
    for (int i = 0; i < V; ++i) carry.x[i] = 0.f;
#pragma unroll 4
    for (int s0 = 0; s0 < kTile; s0 += S) {
      const int slot = s0 + g;
      Vec<V> x = vload<V>(vt + slot * dp + col);
      const int fl = flag[slot];
      int seg = fl & 1;
#pragma unroll
      for (int d = 1; d < S; d <<= 1) {
        const Vec<V> ox = vshfl_up<V>(x, d * CB);
        const int of = __shfl_up_sync(kFull, seg, d * CB);
        if (g >= d) {
          if (!seg) x = vadd<V>(ox, x);
          seg |= of;
        }
      }
      if (!seg) x = vadd<V>(carry, x);  // the run began in an earlier step
      if (fl & 2) vstore<V>(pt + rank[slot] * dp + col, x);
      carry = vshfl<V>(x, (S - 1) * CB + c);
    }
  }

  // 3. unused ranks are zero --------------------------------------------
  Vec<V> zero;
#pragma unroll
  for (int i = 0; i < V; ++i) zero.x[i] = 0.f;
  for (int i = n_runs * n_vec + lane; i < kTile * n_vec; i += 32) {
    vstore<V>(pt + i * V, zero);
  }
}

template <int V, int CB>
int launch(const int* rows, const float* vals, long long n_tiles, int dp,
           int sink, float* partials, int* rank_rows, cudaStream_t stream) {
  const long long blocks = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_segment_partials_kernel<V, CB>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          reinterpret_cast<const int4*>(rows), vals, n_tiles, dp, sink,
          partials, reinterpret_cast<int4*>(rank_rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows 16-byte aligned; vals 16-byte aligned when dp % 4 == 0.  A step
// covers CB vector columns, the largest power of two (at most 32) that
// divides dp / V, so any dp works; powers of two up to 128 and multiples
// of 128 read 512 contiguous bytes a step.
extern "C" int repro_edge_segment_partials(const int* rows, const float* vals,
                                           long long n_tiles, int dp, int sink,
                                           float* partials, int* rank_rows,
                                           void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int v = dp % 4 == 0 ? 4 : 1;
  const int n_vec = dp / v;
  const int low = n_vec & -n_vec;  // largest power of two dividing n_vec
  const int cb = low < 32 ? low : 32;
  const auto args = [&](auto fn) {
    return fn(rows, vals, n_tiles, dp, sink, partials, rank_rows, st);
  };
  if (v == 1) {
    return cb == 1 ? args(launch<1, 1>) : args(launch<1, 2>);
  }
  switch (cb) {
    case 1: return args(launch<4, 1>);
    case 2: return args(launch<4, 2>);
    case 4: return args(launch<4, 4>);
    case 8: return args(launch<4, 8>);
    case 16: return args(launch<4, 16>);
    default: return args(launch<4, 32>);
  }
}
