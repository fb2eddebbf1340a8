// slot_gather: the gathered plane of the interval walk step
// (slot_walk/ops.py::make_blocked_step), out[b, s] = visits[b, gidx[s]],
// where gidx[s] == n (the sink: a dead or pad slot) reads 0.0.
//
// Replaces no TPU kernel: src/repro/kernels/slot_walk/ops.py gathers with
// jnp.concatenate([visits, zrow], axis=1)[:, gidx_p], and the port's plain
// version (kernel.py::slot_gather_torch) is torch.cat with a zero column,
// then index_select along dim 1, which reads the whole index again for
// every row of the batch.
//
// Bound on Hopper: bytes.  The plane is written once (4 B a slot a row),
// the index read once (4 B a slot), the visits once (4 B a vertex a row):
// at B = 16, T = 786,432 tiles of 128, n = 4,194,304 that is 6.44 + 0.40 +
// 0.27 = 7.11 GB, 2.12 ms at 3.35 TB/s.  What stands in the way is the
// random read: gathered row by row, every live slot asks L2 for a 32-byte
// sector for each row, and the B rows of visits (268 MB at walk16) are
// far larger than the 50 MB L2.  Design:
//  - The rows go through in passes of R, the largest power of two up to
//    16 that B fills (kernel.py::gather_rows_per_pass).  For R > 1,
//    slot_gather_pack_kernel first copies the pass's rows vertex major into
//    a scratch [n, R] (pack[v*R + r] = visits[row0 + r, v]), so one live
//    slot fetches all R values in one R*4-byte read: at walk16 one 64-byte
//    read a live slot in place of sixteen sectors.  R = 1 reads the visits
//    row as it is.  Passes over fewer rows whose pack fits L2 (R = 2:
//    33.5 MB at walk16) lose to R = 16: each pass reads the index again.
//  - slot_gather_kernel: lane l of a warp takes slots l, l + 32, ... of the
//    warp's span (J of them: 4 at R = 1, 2 at R = 2, else 1), so each index
//    load and each store of a row is one coalesced 128-byte access, every
//    index is read once a pass and every element of the plane written once.
//    Each load instruction covers 32 consecutive slots: a row's sorted
//    neighbours often share a sector, and at R = 1 the warp then reads it
//    once.  Every value is loaded before the first store, so each thread
//    has all its random reads in flight at once (interleaving the stores
//    with the loads, as the compiler may, cost 22% at walk16); the index
//    loads and the stores are streaming, the first evicted from L2.
//  - The sink is a register compare: an index outside [0, n) reads 0.0,
//    so no zero column is copied in and no read goes out of bounds.
// A copy does no arithmetic, so the plane is what index_select gives, bit
// for bit, at every R.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;

// slots a lane takes at R rows a pass: its R*4-byte reads, J of them
template <int R>
__host__ __device__ constexpr int lane_slots() { return R >= 4 ? 1 : 4 / R; }

// pack[v*R + r] = rows[r*n + v]: each warp reads R coalesced row pieces and
// writes 32*R contiguous floats.
template <int R>
__global__ void __launch_bounds__(kThreads)
slot_gather_pack_kernel(const float* __restrict__ rows, float* __restrict__ pack,
                        long long n) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= n) return;
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = __ldcs(rows + r * n + v);
  if constexpr (R == 2) {
    reinterpret_cast<float2*>(pack)[v] = make_float2(x[0], x[1]);
  } else {
    float4* dst = reinterpret_cast<float4*>(pack) + v * (R / 4);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      dst[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  }
}

// out[r, s] = value r of vertex gidx[s] in src (the pack, or at R = 1 the
// visits row), for the pass's R rows; out points at the pass's first row,
// rows `slots` floats apart.
template <int R>
__global__ void __launch_bounds__(kThreads)
slot_gather_kernel(const int* __restrict__ gidx, const float* __restrict__ src,
                   float* __restrict__ out, long long n, long long slots) {
  constexpr int J = lane_slots<R>();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // slots is whole tiles and a warp spans 32*J <= 128 of them, so a warp
  // is wholly inside or wholly past the end
  const long long s0 = (t >> 5) * (32 * J) + (t & 31);
  if (s0 >= slots) return;
  int idx[J];
#pragma unroll
  for (int j = 0; j < J; ++j) idx[j] = __ldcs(gidx + s0 + 32 * j);
  float x[J][R];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (static_cast<unsigned>(idx[j]) >= static_cast<unsigned long long>(n)) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[j][r] = 0.0f;
      continue;
    }
    const long long at = static_cast<long long>(idx[j]) * R;
    if constexpr (R == 1) {
      x[j][0] = __ldg(src + at);
    } else if constexpr (R == 2) {
      const float2 y = __ldg(reinterpret_cast<const float2*>(src + at));
      x[j][0] = y.x;
      x[j][1] = y.y;
    } else {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(src + at) + q);
        x[j][4 * q] = y.x;
        x[j][4 * q + 1] = y.y;
        x[j][4 * q + 2] = y.z;
        x[j][4 * q + 3] = y.w;
      }
    }
  }
  asm volatile("" ::: "memory");  // every load above is issued before a store
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < J; ++j) __stcs(out + r * slots + s0 + 32 * j, x[j][r]);
  }
}

template <int R>
cudaError_t run_pass(const float* rows, const int* gidx, float* out, float* pack,
                     long long n, long long slots, cudaStream_t s) {
  const float* src = rows;
  if constexpr (R > 1) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (blocks) slot_gather_pack_kernel<R><<<blocks, kThreads, 0, s>>>(rows, pack, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = pack;
  }
  const long long per_block = static_cast<long long>(kThreads) * lane_slots<R>();
  const unsigned blocks = static_cast<unsigned>((slots + per_block - 1) / per_block);
  slot_gather_kernel<R><<<blocks, kThreads, 0, s>>>(gidx, src, out, n, slots);
  return cudaGetLastError();
}

}  // namespace

// visits [b, n] f32, gidx [slots] int32 with slots a positive multiple of
// 128, out [b, slots] f32, pack scratch of n * rows_per_pass floats
// (16-byte aligned; unused when rows_per_pass is 1).  rows_per_pass is 1,
// 2, 4, 8 or 16; after the full passes, each pass takes the largest of
// those that the remaining rows fill.
extern "C" int repro_slot_gather(const float* visits, const int* gidx, float* out,
                                 float* pack, long long b, long long n, long long slots,
                                 int rows_per_pass, void* stream) {
  if (b <= 0 || slots <= 0) return 0;
  const bool pow2 = rows_per_pass > 0 && (rows_per_pass & (rows_per_pass - 1)) == 0;
  if (!pow2 || rows_per_pass > 16 || slots % kTile || n < 0 || n > 0x7fffffffLL ||
      slots / 32 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long row0 = 0; row0 < b;) {
    int r = rows_per_pass;
    while (r > b - row0) r >>= 1;
    const float* rows = visits + row0 * n;
    float* o = out + row0 * slots;
    cudaError_t err;
    switch (r) {
      case 16: err = run_pass<16>(rows, gidx, o, pack, n, slots, s); break;
      case 8: err = run_pass<8>(rows, gidx, o, pack, n, slots, s); break;
      case 4: err = run_pass<4>(rows, gidx, o, pack, n, slots, s); break;
      case 2: err = run_pass<2>(rows, gidx, o, pack, n, slots, s); break;
      default: err = run_pass<1>(rows, gidx, o, pack, n, slots, s); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    row0 += r;
  }
  return 0;
}
