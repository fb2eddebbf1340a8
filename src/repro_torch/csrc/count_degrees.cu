// The ingest degree count (paper Alg 5), two entry points:
//
//   repro_count_degrees   per-vertex histogram of raw edge sources,
//                         [M] i32 -> [n] i32
//   repro_degree_offsets  CSR offsets straight from sources sorted by the
//                         build, [M] i32 -> [n+1] i32
//
// Both replace src/repro/kernels/csr_build/kernel.py::count_degrees_pallas
// (body _kernel).  The TPU kernel compares a 128-wide edge tile against a
// 128-wide vertex tile per grid step, because TPUs have no scatter unit;
// that is O(M*n/128^2) compares and needs edges and vertices padded to 128.
// diff(offsets) over [0, n) is that kernel's histogram.
//
// count_degrees: bound by bytes, M*4 read + n*4 written.  A flat
// grid-stride loop with one atomicAdd per in-range source; out-of-range
// ids (negative or >= n) are dropped, which is the TPU kernel's padding
// contract without the padding.  The output is zeroed on the same stream
// first.  It runs at the L2's atomic rate, not the memory's, and on
// sources sorted by id the threads of a warp hit one hub counter together
// and serialise: it is the route for callers that hold unsorted sources.
//
// degree_offsets: the device build sorts the sources anyway, and on sorted
// sources offsets[v] = #{i : src[i] < v} is a run boundary: for each
// position i in [0, M], offsets[v] = i for every v in (src[i-1], src[i]]
// clipped to [0, n], with src[-1] = -inf and src[M] = +inf.  Every offset
// is written exactly once (at the one i with src[i-1] < v <= src[i]), so
// there are no atomics, no zeroing, no cumsum, and the same bits on every
// call.  Bound by bytes, M*4 read + (n+1)*4 written: sources come in
// 128-bit loads, four a lane before it looks at any (a head of up to 3
// elements before the first 16-byte boundary and the tail are single
// loads), over a grid of as many blocks as the SMs hold at once; a lane's
// predecessor comes by shuffle.  Most lanes hold no boundary (their last
// source equals their predecessor) and write nothing.  A boundary
// spanning a run of zero-degree vertices writes them all: up to kInline
// values by its own thread, longer spans by its whole warp, so one vertex
// holding every edge costs n/32 stores a lane, not n.  Sorted
// negative sources move offsets[0] off 0 and ids >= n move offsets[n] off
// M, which the caller's range check reads.
#include <cuda_runtime.h>

namespace {

__global__ void count_degrees_kernel(const int* __restrict__ src, long long m,
                                     int n, int* __restrict__ deg) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const int s = src[i];
    if (s >= 0 && s < n) atomicAdd(deg + s, 1);
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kOffsetsThreads = 256;
// int4 vectors a lane loads before it looks at any: 64 bytes in flight
constexpr int kUnroll = 4;
// spans of at most kInline vertices are written by their own thread
constexpr int kInline = 8;

// The single positions: [0, head) before the first 16-byte boundary of
// src, and [tail, m] after the last whole vector, m itself included (at
// most 3 + 4, one a lane of warp 0).  64-bit spans: the end position m
// reaches n, and an id may be INT_MAX.
__device__ void single_positions(const int* __restrict__ src, long long m, int n,
                                 long long head, long long tail,
                                 int* __restrict__ offsets) {
  const int lane = threadIdx.x & 31;
  const long long p = lane < head ? lane : tail + (lane - head);
  long long lo = 0, hi = -1;
  if (p <= m) {
    lo = p == 0 ? 0 : max(static_cast<long long>(src[p - 1]) + 1, 0LL);
    hi = p == m ? n : min(static_cast<long long>(src[p]), static_cast<long long>(n));
  }
  const bool wide = hi - lo >= kInline;
  if (!wide)
    for (long long v = lo; v <= hi; ++v) offsets[v] = static_cast<int>(p);
  unsigned pending = __ballot_sync(kFull, wide);
  while (pending) {
    const int owner = __ffs(pending) - 1;
    pending &= pending - 1;
    const long long l = __shfl_sync(kFull, lo, owner);
    const long long h = __shfl_sync(kFull, hi, owner);
    const int x = static_cast<int>(__shfl_sync(kFull, p, owner));
    for (long long v = l + lane; v <= h; v += 32) offsets[v] = x;
  }
}

// Vectors q in [0, nvec) cover positions [head, head + 4*nvec).  A warp
// takes kUnroll*32 consecutive vectors an iteration (lane + 32*j); each
// lane's first position reads its predecessor from the lane before (or
// the last lane of the vector before, or memory for lane 0 of j = 0).  A
// lane whose last source equals its predecessor holds no run boundary
// (the sources are sorted) and writes nothing: most lanes.
__global__ void __launch_bounds__(kOffsetsThreads)
degree_offsets_kernel(const int* __restrict__ src, long long m, int n,
                      long long head, long long nvec, int* __restrict__ offsets) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  if (warp == 0) single_positions(src, m, n, head, head + 4 * nvec, offsets);
  const int4* __restrict__ vec = reinterpret_cast<const int4*>(src + head);
  // warp-uniform trip count: the shuffles and ballots need every lane
  for (long long q0 = warp * 32 * kUnroll; q0 < nvec; q0 += warps * 32 * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long q = q0 + 32 * j + lane;
      v[j] = q < nvec ? __ldg(vec + q) : make_int4(0, 0, 0, 0);
    }
    // sources below 0 never open a span, so -1 stands for src[-1] = -inf
    int before = -1;
    if (lane == 0 && head + 4 * q0 > 0) before = __ldg(src + head + 4 * q0 - 1);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long q = q0 + 32 * j + lane;
      const long long p = head + 4 * q;
      int prev = __shfl_up_sync(kFull, v[j].w, 1);
      const int last = __shfl_sync(kFull, v[j].w, 31);
      if (lane == 0) prev = before;
      before = last;
      const int c[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      unsigned wide = 0;
      if (q < nvec && c[3] != prev) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = k ? c[k - 1] : prev;
          if (c[k] != a) {  // a < c[k], so a + 1 does not overflow
            const int lo = max(a + 1, 0), hi = min(c[k], n);
            if (hi - lo >= kInline) {
              wide |= 1u << k;
            } else {
              for (int x = lo; x <= hi; ++x) offsets[x] = static_cast<int>(p + k);
            }
          }
        }
      }
      unsigned pending = __ballot_sync(kFull, wide != 0);
      while (pending) {  // spans of many zero-degree vertices: the warp writes
        const int owner = __ffs(pending) - 1;
        pending &= pending - 1;
        const unsigned w = __shfl_sync(kFull, wide, owner);
        const int pv = __shfl_sync(kFull, prev, owner);
        const long long pp = __shfl_sync(kFull, p, owner);
        int co[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) co[k] = __shfl_sync(kFull, c[k], owner);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!((w >> k) & 1)) continue;
          const int lo = max((k ? co[k - 1] : pv) + 1, 0), hi = min(co[k], n);
          for (long long x = lo + lane; x <= hi; x += 32) offsets[x] = static_cast<int>(pp + k);
        }
      }
    }
  }
}

}  // namespace

extern "C" int repro_count_degrees(const int* src, long long m, int n,
                                   int* deg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(deg, 0, sizeof(int) * static_cast<size_t>(n), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0) return 0;
  constexpr int kThreads = 256;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;  // grid-stride covers the rest
  count_degrees_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      src, m, n, deg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_degree_offsets(const int* src, long long m, int n,
                                    int* offsets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, degree_offsets_kernel, kOffsetsThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long addr = reinterpret_cast<unsigned long long>(src);
  long long head = static_cast<long long>(((16 - (addr & 15)) & 15) / 4);
  if (head > m) head = m;
  const long long nvec = (m - head) / 4;
  const long long per_block = static_cast<long long>(kOffsetsThreads) * kUnroll;
  long long blocks = (nvec + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;      // warp 0 writes the single positions
  degree_offsets_kernel<<<static_cast<unsigned>(blocks), kOffsetsThreads, 0, st>>>(
      src, m, n, head, nvec, offsets);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
