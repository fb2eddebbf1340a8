// count_degrees: per-vertex histogram of edge sources, [M] i32 -> [n] i32.
//
// Replaces src/repro/kernels/csr_build/kernel.py::count_degrees_pallas
// (body _kernel), the degree count of the device ingest engine (paper
// Alg 5).  The TPU kernel compares a 128-wide edge tile against a 128-wide
// vertex tile per grid step, because TPUs have no scatter unit; that is
// O(M*n/128^2) compares and needs edges and vertices padded to 128.
//
// Bound on Hopper: bytes, M*4 read + n*4 written.  The card has fast
// atomics in L2, so the histogram is a flat grid-stride loop with one
// atomicAdd per in-range source.  Out-of-range ids (negative or >= n) are
// dropped, which is the TPU kernel's padding contract without the padding.
// The output is zeroed on the same stream first.  On inputs sorted by
// source, the threads of a warp hit one hub counter together and the
// atomics serialise; the port feeds it the raw, unsorted sources.
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

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
