// merge_rows: merge each touched row's sorted live prefix with its sorted
// op run (deletes, weight upserts, ranked inserts).
//
//   d_rows/w_rows [A,W] i32/f32, degs [A] i32,
//   b_dst/b_wgt/b_del [A,K] i32/f32/i32  ->  out_d/out_w [A,W], counts [A]
//
// Replaces src/repro/kernels/slot_update/kernel.py::merge_rows_pallas (body
// _kernel).  That kernel ranks every element through [K,W] compare and
// [W,W] one-hot matrices and places int32 ids with f32 matmuls, so it does
// O(W^2) work per row and is exact only for ids below 2^24.  Hub rows of a
// power-law graph reach W = 2^14..2^15 slots, where a [W,W] matrix is 10^9
// elements and a row no longer fits a block's shared memory.
//
// Bound on Hopper: bytes, about A*W*16 + A*K*12.  Design: one thread block
// per row, rank arithmetic on int32 ids, no staging of the row:
//   1. each op k bisects the live prefix d[0:deg] -> pos_k, found_k; that
//      classifies it as kill, upsert, new insert or no-op;
//   2. a block-wide exclusive scan over the ops (each thread owns a
//      contiguous chunk, so any K works) gives kills_before[k] and
//      ins_before[k], kept in global scratch; a new insert lands at
//      pos_k - kills_before[k] + ins_before[k];
//   3. each live lane i bisects the run for j = lower_bound(run, d[i]); a
//      delete of d[i] kills it, otherwise it moves to
//      i - kills_before[j] + ins_before[j], taking an upsert's weight;
//   4. counts = deg - kills + inserts, and the tail is SENTINEL / 0.0.
// Work is O(W + K log W) per row.  Weights are moved, never computed, so
// the result is bit-identical to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
enum OpKind { kNone = 0, kKill = 1, kInsert = 2 };

__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Classify op k against the live prefix d[0:deg]; pos = #live ids < key.
__device__ __forceinline__ int op_kind(const int* d, int deg, int key,
                                       int is_del, int* pos) {
  *pos = lower_bound(d, deg, key);
  if (key == kSentinel) return kNone;  // run padding
  const bool found = *pos < deg && d[*pos] == key;
  if (is_del) return found ? kKill : kNone;
  return found ? kNone : kInsert;  // found insert = upsert, placed in step 3
}

// Block-wide exclusive scan of two counters; all threads must call it.
__device__ void block_scan2(int a, int b, int* ea, int* eb, int* ta, int* tb) {
  __shared__ int sa[32], sb[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oa = __shfl_up_sync(kFull, ia, d);
    const int ob = __shfl_up_sync(kFull, ib, d);
    if (lane >= d) { ia += oa; ib += ob; }
  }
  if (lane == 31) { sa[warp] = ia; sb[warp] = ib; }
  __syncthreads();
  if (warp == 0) {
    int va = lane < nwarps ? sa[lane] : 0;
    int vb = lane < nwarps ? sb[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int oa = __shfl_up_sync(kFull, va, d);
      const int ob = __shfl_up_sync(kFull, vb, d);
      if (lane >= d) { va += oa; vb += ob; }
    }
    sa[lane] = va;
    sb[lane] = vb;
  }
  __syncthreads();
  *ea = (warp ? sa[warp - 1] : 0) + ia - a;
  *eb = (warp ? sb[warp - 1] : 0) + ib - b;
  *ta = sa[nwarps - 1];
  *tb = sb[nwarps - 1];
}

__global__ void merge_rows_kernel(const int* __restrict__ d_rows,
                                  const float* __restrict__ w_rows,
                                  const int* __restrict__ degs,
                                  const int* __restrict__ b_dst,
                                  const float* __restrict__ b_wgt,
                                  const int* __restrict__ b_del, int W, int K,
                                  int* __restrict__ out_d,
                                  float* __restrict__ out_w,
                                  int* __restrict__ counts,
                                  int* __restrict__ kills_before,
                                  int* __restrict__ ins_before) {
  const long long row = blockIdx.x;
  const int* d = d_rows + row * W;
  const float* w = w_rows + row * W;
  const int* bd = b_dst + row * K;
  const float* bw = b_wgt + row * K;
  const int* bl = b_del + row * K;
  int* od = out_d + row * W;
  float* ow = out_w + row * W;
  int* kb = kills_before + row * K;
  int* ib = ins_before + row * K;
  const int deg = min(max(degs[row], 0), W);

  // 1-2: classify this thread's chunk of ops, scan, place new inserts
  const int chunk = (K + blockDim.x - 1) / blockDim.x;
  const int k0 = min(K, static_cast<int>(threadIdx.x) * chunk);
  const int k1 = min(K, k0 + chunk);
  int n_kill = 0, n_ins = 0, pos;
  for (int k = k0; k < k1; ++k) {
    const int kind = op_kind(d, deg, bd[k], bl[k], &pos);
    n_kill += kind == kKill;
    n_ins += kind == kInsert;
  }
  int kills = 0, ins = 0, kills_total = 0, ins_total = 0;
  block_scan2(n_kill, n_ins, &kills, &ins, &kills_total, &ins_total);
  for (int k = k0; k < k1; ++k) {
    const int kind = op_kind(d, deg, bd[k], bl[k], &pos);
    kb[k] = kills;
    ib[k] = ins;
    if (kind == kInsert) {
      const int at = pos - kills + ins;
      if (at < W) { od[at] = bd[k]; ow[at] = bw[k]; }
    }
    kills += kind == kKill;
    ins += kind == kInsert;
  }
  __syncthreads();  // kills_before / ins_before visible to the whole block

  // 3: survivors move by the kills and inserts ranked below them
  for (int i = threadIdx.x; i < deg; i += blockDim.x) {
    const int v = d[i];
    const int j = lower_bound(bd, K, v);
    float wt = w[i];
    if (j < K && bd[j] == v) {
      if (bl[j]) continue;  // deleted
      wt = bw[j];           // upsert
    }
    const int at = i - (j < K ? kb[j] : kills_total) + (j < K ? ib[j] : ins_total);
    if (at < W) { od[at] = v; ow[at] = wt; }
  }

  // 4: count and tail
  const int count = deg - kills_total + ins_total;
  for (int i = max(count, 0) + threadIdx.x; i < W; i += blockDim.x) {
    od[i] = kSentinel;
    ow[i] = 0.0f;
  }
  if (threadIdx.x == 0) counts[row] = count;
}

}  // namespace

extern "C" int repro_merge_rows(const int* d_rows, const float* w_rows,
                                const int* degs, const int* b_dst,
                                const float* b_wgt, const int* b_del,
                                long long a, int w, int k, int* out_d,
                                float* out_w, int* counts, int* scratch,
                                int threads, void* stream) {
  if (a <= 0) return 0;
  int* kills_before = scratch;
  int* ins_before = scratch + a * static_cast<long long>(k);
  merge_rows_kernel<<<static_cast<unsigned>(a), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      d_rows, w_rows, degs, b_dst, b_wgt, b_del, w, k, out_d, out_w, counts,
      kills_before, ins_before);
  return static_cast<int>(cudaGetLastError());
}
