// bsr_spmm: Y = A @ X with A in 128x128 block-sparse rows (BSR), f32.
//
// Replaces src/repro/kernels/bsr_spmm/kernel.py::bsr_spmm (body _kernel),
// the step of the SpMM formulation of the reverse walk
// (bsr_spmm/ops.py::reverse_walk_bsr).  The TPU kernel walks a grid
// (row-block, d-tile, s < max_blocks_per_row), one MXU matmul per stored
// block, with row_ptr / block_cols scalar-prefetched for the index maps.
//
// Operands: row_ptr [R+1] i32, block_cols [nnzb] i32, blocks [nnzb,128,128]
// f32 (row-major: blocks[s, i, k] is A[r*128 + i, c*128 + k]), x [C*128, D]
// f32, y [R*128, D] f32, D a multiple of the d-tile DT in {8,...,128}.
//
// Bound on Hopper: bytes.  Every stored tile is 64 KiB read once per d-tile
// for 2*128*128*DT FLOP: at the walk's DT = 8 that is 4 FLOP per byte, far
// below the card's float32 ridge.  Design: one 256-thread block per
// (row-block, d-tile) pair; it loops over that row-block's own blocks
// [row_ptr[r], row_ptr[r+1]) (the real count, not max_blocks_per_row), so a
// row-block with no blocks writes zeros.  For each block, the threads copy
// the A tile into shared memory with coalesced 16-byte asynchronous copies
// (cp.async, 16 per thread in flight, cached in L2 only, no registers
// spent) and the 128 x DT X panel beside it; then thread t
// owns output row t/2 and DT/2 of its columns and runs the k loop in FP32
// FMAs on the CUDA cores (no TF32).  The A rows are padded to 132 floats so
// the row-wise 16-byte shared reads of a quarter-warp hit distinct banks.
// Accumulators stay in registers across the row-block's blocks.
#include <cuda_runtime.h>

namespace {

constexpr int kB = 128;        // block size
constexpr int kPitch = kB + 4; // padded A-tile row in shared memory (floats)
constexpr int kThreads = 256;  // two threads per output row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

template <int DT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kB) * kPitch + kB * DT);
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ block_cols,
                const float* __restrict__ blocks,
                const float* __restrict__ x, int d, float* __restrict__ y) {
  static_assert(DT % 8 == 0 && DT <= 128, "d-tile must be 8..128, multiple of 8");
  constexpr int kCols = DT / 2;  // output columns per thread
  extern __shared__ float4 smem[];
  float* a_s = reinterpret_cast<float*>(smem);  // [kB][kPitch]
  float* x_s = a_s + kB * kPitch;               // [kB][DT]
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  const int col0 = blockIdx.y * DT;
  const int i = tid >> 1;
  const int j0 = (tid & 1) * kCols;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const int s_end = row_ptr[r + 1];
  for (int s = row_ptr[r]; s < s_end; ++s) {
    const float4* a_g =
        reinterpret_cast<const float4*>(blocks + static_cast<long long>(s) * kB * kB);
    const long long xrow0 = static_cast<long long>(block_cols[s]) * kB;
    __syncthreads();  // the previous block's tiles are consumed
#pragma unroll
    for (int q = 0; q < kB * kB / 4 / kThreads; ++q) {
      const int f = q * kThreads + tid;  // float4 index inside the tile
      cp_async16(a_s + (f >> 5) * kPitch + (f & 31) * 4, a_g + f);
    }
    for (int f = tid; f < kB * DT / 4; f += kThreads) {
      const int row = f / (DT / 4);
      const int c4 = f % (DT / 4);
      cp_async16(x_s + row * DT + c4 * 4, x + (xrow0 + row) * d + col0 + c4 * 4);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const float* a_row = a_s + i * kPitch;
#pragma unroll 2
    for (int k = 0; k < kB; k += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_row + k);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* xr = x_s + (k + kk) * DT + j0;
#pragma unroll
        for (int j = 0; j < kCols; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + j);
          acc[j] = fmaf(av[kk], xv.x, acc[j]);
          acc[j + 1] = fmaf(av[kk], xv.y, acc[j + 1]);
          acc[j + 2] = fmaf(av[kk], xv.z, acc[j + 2]);
          acc[j + 3] = fmaf(av[kk], xv.w, acc[j + 3]);
        }
      }
    }
  }
  float* yo = y + (r * kB + i) * d + col0 + j0;
#pragma unroll
  for (int j = 0; j < kCols; j += 4) {
    *reinterpret_cast<float4*>(yo + j) =
        make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  }
}

template <int DT>
int launch(const int* row_ptr, const int* block_cols, const float* blocks,
           const float* x, float* y, int n_row_blocks, int d,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DT>();
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_row_blocks),
                  static_cast<unsigned>(d / DT));
  bsr_spmm_kernel<DT><<<grid, kThreads, smem, stream>>>(row_ptr, block_cols,
                                                         blocks, x, d, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_bsr_spmm(const int* row_ptr, const int* block_cols,
                              const float* blocks, const float* x, float* y,
                              int n_row_blocks, int d, int d_tile,
                              void* stream) {
  if (n_row_blocks <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d_tile) {
    case 8: return launch<8>(row_ptr, block_cols, blocks, x, y, n_row_blocks, d, st);
    case 16: return launch<16>(row_ptr, block_cols, blocks, x, y, n_row_blocks, d, st);
    case 32: return launch<32>(row_ptr, block_cols, blocks, x, y, n_row_blocks, d, st);
    case 64: return launch<64>(row_ptr, block_cols, blocks, x, y, n_row_blocks, d, st);
    case 128: return launch<128>(row_ptr, block_cols, blocks, x, y, n_row_blocks, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
