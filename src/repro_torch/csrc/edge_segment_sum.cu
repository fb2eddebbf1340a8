// edge_segment_sum: segment sum of row-sorted edge values, read in place.
//
//   rows [E] i32 ascending, vals [E,D] f32  ->  out [n,D] f32
//   (out zeroed by the caller; rows outside [0, n) are dropped)
//
// Replaces src/repro/kernels/edge_segment_sum/kernel.py::edge_segment_partials
// (body _kernel) together with the padding and the rank fold around it in
// edge_segment_sum/ops.py::edge_segment_sum (GNN neighbour aggregation over
// a CSR).  The TPU kernel reduces [T,128] padded tiles to [T,128,D] per-rank
// partials with one-hot MXU matmuls and a segment_sum folds every rank; on
// Hopper that contract costs a padded copy of the values and a partials
// tensor as large as the input.
//
// Bound on Hopper: bytes, 4E + 4DE read and 4Dn written.  Design: two
// launches, no padding, no per-rank partials, no atomics.
//   1. edge_segment_runs_kernel: one warp per 128-edge tile of the flat
//      arrays (the ragged last tile masked).  Each lane reads four
//      consecutive rows; run flags come from the neighbouring slots by
//      shuffle and from the edges just before and after the tile.  The
//      values are read in the tile's order, 32 vectors (float4 where D % 4
//      == 0 and vals is 16-byte aligned) a step: S = 32 / CB slots of CB
//      vector columns.  A segmented scan over the S slots (shuffles by
//      multiples of CB) plus the carry of the previous step's last slot
//      gives each run end its run's sum over the run's own terms, so
//      nothing cancels.  Rows are sorted, so a run that neither continues
//      from the previous tile nor into the next owns its row alone and is
//      stored straight into out[row].  Only a tile's first and last run can
//      share a row with another tile: those go to seams [T,2,D], slot 0 for
//      the first run, slot 1 for the last (slot 0 again when the tile is
//      one run).
//   2. edge_segment_seams_kernel: one thread per (tile, vector column).  The
//      tile in which a multi-tile row begins owns it: it takes its own seam
//      sum, finds the last tile whose first run continues the row (gallop
//      and bisect over the tiles' first rows), adds their slot-0 seams left
//      to right and writes out[row] once.
// Every out row is written once (by 1 or by 2), in a fixed order, so the
// result is the same bit for bit on every call.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kSeamThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// a slot's destination when it ends a run: out row (>= 0) or one of these
constexpr int kNone = -1;       // not a run end, or a dropped row
constexpr int kSeamFirst = -2;  // seams[t][0]
constexpr int kSeamLast = -3;   // seams[t][1]

template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> vzero() {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = 0.f;
  return r;
}

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
  for (int i = 0; i < V; ++i) r.x[i] = __shfl_up_sync(kFullMask, a.x[i], d);
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> vshfl(const Vec<V>& a, int src) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.x[i] = __shfl_sync(kFullMask, a.x[i], src);
  return r;
}

__device__ __forceinline__ bool kept(int row, int n) {
  return static_cast<unsigned>(row) < static_cast<unsigned>(n);
}

// V: floats per vector (4 or 1); CB: vector columns a step covers, a power
// of two dividing d / V (at most 32)
template <int V, int CB>
__global__ void edge_segment_runs_kernel(const int* __restrict__ rows,
                                         const float* __restrict__ vals,
                                         long long e, int d, int n,
                                         int rows_aligned,
                                         float* __restrict__ out,
                                         float* __restrict__ seams) {
  __shared__ int s_start[kWarpsPerBlock][kTile];
  __shared__ int s_dest[kWarpsPerBlock][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  const long long base = tile * kTile;
  if (base >= e) return;  // the whole warp leaves together
  const int nv = static_cast<int>(e - base < kTile ? e - base : kTile);

  // 1. run flags and destinations --------------------------------------
  int r[4];
  if (nv == kTile && rows_aligned) {
    const int4 q = reinterpret_cast<const int4*>(rows + base)[lane];
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = 4 * lane + c;
      r[c] = s < nv ? rows[base + s] : 0;
    }
  }
  const bool has_prev = base > 0;
  const bool has_next = base + kTile < e;
  const int prev_row = has_prev ? rows[base - 1] : 0;
  const int next_row = has_next ? rows[base + kTile] : 0;
  const int left = __shfl_up_sync(kFullMask, r[3], 1);    // slot 4*lane - 1
  const int right = __shfl_down_sync(kFullMask, r[0], 1);  // slot 4*lane + 4
  int start[4], end[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s = 4 * lane + c;
    const int before = c ? r[c - 1] : left;
    const int after = c < 3 ? r[c + 1] : right;
    // a masked slot is a run of its own and ends none of the valid ones
    start[c] = s >= nv || s == 0 || r[c] != before;
    end[c] = s >= nv || s == nv - 1 || r[c] != after;
  }
  int my_first_end = kTile;
#pragma unroll
  for (int c = 3; c >= 0; --c) {
    if (end[c]) my_first_end = 4 * lane + c;
  }
  const int first_end = __reduce_min_sync(kFullMask, my_first_end);
  int* st = s_start[warp];
  int* dest = s_dest[warp];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s = 4 * lane + c;
    int dd = kNone;
    if (s < nv && end[c] && kept(r[c], n)) {
      const bool first = s == first_end;  // the tile's first run
      const bool last = s == nv - 1;      // the tile's last run
      if (first && has_prev && prev_row == r[c]) {
        dd = kSeamFirst;  // continues from the previous tile
      } else if (last && has_next && next_row == r[c]) {
        dd = first ? kSeamFirst : kSeamLast;  // continues into the next tile
      } else {
        dd = r[c];  // the row's whole run: this tile owns it alone
      }
    }
    st[s] = start[c];
    dest[s] = dd;
  }
  __syncwarp();

  // 2. segmented run sums, S slots x CB vector columns a step ----------
  constexpr int S = 32 / CB;  // slots a step covers
  const int g = lane / CB;    // slot within the step
  const int c = lane % CB;    // vector column within the block
  const int n_vec = d / V;
  const float* vt = vals + base * d;
  float* seam = seams + tile * 2 * d;
  for (int cb = 0; cb < n_vec; cb += CB) {
    const int col = (cb + c) * V;
    Vec<V> carry = vzero<V>();
#pragma unroll 8
    for (int s0 = 0; s0 < kTile; s0 += S) {
      if (s0 >= nv) break;  // uniform: the rest of the tile is masked
      const int slot = s0 + g;
      Vec<V> x = slot < nv ? vload<V>(vt + static_cast<long long>(slot) * d + col)
                           : vzero<V>();
      int seg = st[slot];
#pragma unroll
      for (int k = 1; k < S; k <<= 1) {
        const Vec<V> ox = vshfl_up<V>(x, k * CB);
        const int of = __shfl_up_sync(kFullMask, seg, k * CB);
        if (g >= k) {
          if (!seg) x = vadd<V>(ox, x);
          seg |= of;
        }
      }
      if (!seg) x = vadd<V>(carry, x);  // the run began in an earlier step
      const int dd = dest[slot];
      if (dd >= 0) {
        vstore<V>(out + static_cast<long long>(dd) * d + col, x);
      } else if (dd == kSeamFirst) {
        vstore<V>(seam + col, x);
      } else if (dd == kSeamLast) {
        vstore<V>(seam + d + col, x);
      }
      carry = vshfl<V>(x, (S - 1) * CB + c);
    }
  }
}

template <int V>
__global__ void edge_segment_seams_kernel(const int* __restrict__ rows,
                                          long long n_tiles, int d, int n,
                                          const float* __restrict__ seams,
                                          float* __restrict__ out) {
  const int n_vec = d / V;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long tile = i / n_vec;
  const int col = static_cast<int>(i % n_vec) * V;
  // the last tile continues into none; every other tile is full
  if (tile >= n_tiles - 1) return;
  const long long base = tile * kTile;
  const int row = rows[base + kTile - 1];
  if (!kept(row, n) || rows[base + kTile] != row) return;
  int which = 1;  // the tile's last run, unless the tile is one run
  if (rows[base] == row) {
    if (base > 0 && rows[base - 1] == row) return;  // began in an earlier tile
    which = 0;
  }
  // the tiles tile+1 .. last begin with the row (rows are sorted): gallop,
  // then bisect, so a hub row costs O(log) dependent loads, not one a tile
  long long last = tile + 1, hi = tile + 2, step = 1;
  while (hi < n_tiles && rows[hi * kTile] == row) {
    last = hi;
    step <<= 1;
    hi = last + step;
  }
  if (hi > n_tiles) hi = n_tiles;
  while (hi - last > 1) {
    const long long mid = (last + hi) >> 1;
    if (rows[mid * kTile] == row) last = mid; else hi = mid;
  }
  Vec<V> acc = vload<V>(seams + (tile * 2 + which) * d + col);
#pragma unroll 4
  for (long long t = tile + 1; t <= last; ++t) {  // left to right
    acc = vadd<V>(acc, vload<V>(seams + t * 2 * d + col));
  }
  vstore<V>(out + static_cast<long long>(row) * d + col, acc);
}

template <int V, int CB>
int launch(const int* rows, const float* vals, long long e, int d, int n,
           int rows_aligned, float* out, float* seams, cudaStream_t stream) {
  const long long n_tiles = (e + kTile - 1) / kTile;
  const long long blocks = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_segment_runs_kernel<V, CB>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          rows, vals, e, d, n, rows_aligned, out, seams);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles < 2) return static_cast<int>(err);
  const long long threads = (n_tiles - 1) * (d / V);
  edge_segment_seams_kernel<V>
      <<<static_cast<unsigned>((threads + kSeamThreads - 1) / kSeamThreads),
         kSeamThreads, 0, stream>>>(rows, n_tiles, d, n, seams, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows [e] int32 ascending, vals [e, d] f32 row-major, out [n, d] f32
// zeroed, seams [ceil(e / 128), 2, d] f32 scratch.  vec4 != 0 (d % 4 == 0,
// vals 16-byte aligned) reads float4 vectors.  A step covers CB vector
// columns, the largest power of two (at most 32; at most 2 for scalar
// lanes) that divides the row's vectors, so any d >= 1 works.
extern "C" int repro_edge_segment_sum(const int* rows, const float* vals,
                                      long long e, int d, int n, int vec4,
                                      float* out, float* seams, void* stream) {
  if (e <= 0) return 0;
  if (d <= 0 || n < 0 || (vec4 && d % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_aligned = reinterpret_cast<unsigned long long>(rows) % 16 == 0;
  const int n_vec = vec4 ? d / 4 : d;
  const int low = n_vec & -n_vec;  // largest power of two dividing n_vec
  const auto args = [&](auto fn) {
    return fn(rows, vals, e, d, n, rows_aligned, out, seams, st);
  };
  if (!vec4) {
    return low == 1 ? args(launch<1, 1>) : args(launch<1, 2>);
  }
  switch (low < 32 ? low : 32) {
    case 1: return args(launch<4, 1>);
    case 2: return args(launch<4, 2>);
    case 4: return args(launch<4, 4>);
    case 8: return args(launch<4, 8>);
    case 16: return args(launch<4, 16>);
    default: return args(launch<4, 32>);
  }
}
