// merge_rows: the row merge of an update batch, fused with its gather and
// its write-back into the slotted arena.
//
// One width group of a plan: row_ops [6,A] i32 (old_start, old_cap,
// new_start, new_cap, deg, row_id per row), op runs b_dst/b_del [A,K] i32
// and b_wgt [A,K] f32, sorted per row with SENTINEL padding.  For each row:
//   1. read the live prefix ids/wts[old_start : old_start + deg];
//   2. merge the run into it: deletes, weight upserts, ranked inserts;
//   3. write the merged row to ids/wts[new_start : new_start + count] and
//      SENTINEL / 0.0 to the rest of the new block (new_cap slots);
//   4. where the row moved (new_start != old_start, old_start >= 0),
//      SENTINEL-fill ids' old block; with `moves`, write slot_rows = row_id
//      over the new block;
//   5. counts[r] = count, and when lo/hi are given and row_id < nv,
//      lo[row_id] = new_start, hi[row_id] = new_start + count.
// Pad rows (new_start < 0) write only their count.  The arena is read and
// written in place: the rows of one plan touch disjoint blocks (vacated
// blocks are freed only after the write-back, core/digraph.py), so no row
// reads a block that another row writes, and each row is read whole (into
// registers, ordered before any write by __syncwarp, or into a stage behind
// __syncthreads) before any slot of it is written.
//
// Replaces src/repro/kernels/slot_update/kernel.py::merge_rows_pallas (body
// _kernel) and, around it, the padded [A,W] gather and the scatter
// write-back of slot_update/ops.py::fused_apply.  The TPU kernel ranks
// every element through [K,W] compare and [W,W] one-hot matrices and
// places int32 ids with f32 matmuls (O(W^2), exact below 2^24).  Here ids
// are ranked by integer comparisons, so every int32 id is exact, and
// weights are moved, never computed: the result is bit-identical to the
// plain version.
//
// Bound on Hopper: bytes (row_ops, the live prefix, the run, the new block,
// the count).  Design:
//   * W <= 32, the bulk of a batch: one warp per row, eight rows a block.
//     Lane i holds slot i in registers, and lane j op j (32 ops at a time).
//     Both sequences ascend across the lanes, so each op finds its rank
//     among the live ids, and each id the ops under it, by a bisect over
//     the other's lanes with shuffles (six steps).  The ops' kill and insert
//     masks (ballots) then give a new insert its slot (rank - kills before +
//     inserts before) and a survivor its slot (i - kills below + inserts
//     with a smaller key), by __popc.  No shared memory, no scratch, no
//     bisect in device memory.
//   * W > 32: one block per row.  The live prefix and the run's keys are
//     staged in shared memory (or, for rows too wide for it, in the row's
//     slice of a global scratch); each op bisects the staged prefix, a
//     block scan gives kills and inserts before each op (kept beside the
//     keys), and each survivor bisects the staged keys.  O(W + K log W).
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // warp kernel
enum OpKind { kNone = 0, kKill = 1, kInsert = 2 };

struct Args {
  int* ids;  // the arena, read and written in place
  float* wts;
  int* slot_rows;  // written only when moves
  const int* row_ops;
  long long a;
  int w;
  const int* b_dst;
  const int* b_del;
  const float* b_wgt;
  int k;
  int moves;
  int* counts;
  int* lo;  // may be null (then hi is too)
  int* hi;
  int nv;
  int* scratch;  // block kernel only, when the stage is in device memory
};

struct Row {
  int old_start, old_cap, new_start, new_cap, deg, row_id;
};

__device__ __forceinline__ Row load_row(const Args& p, long long r) {
  Row x;
  x.old_start = p.row_ops[r];
  x.old_cap = p.row_ops[p.a + r];
  x.new_start = p.row_ops[2 * p.a + r];
  x.new_cap = p.row_ops[3 * p.a + r];
  x.deg = min(max(p.row_ops[4 * p.a + r], 0), p.w);
  x.row_id = p.row_ops[5 * p.a + r];
  return x;
}

// Steps 3 (tail), 4 and 5 for one row: `t` of `n_threads` cooperate.
__device__ __forceinline__ void finish_row(const Args& p, const Row& x,
                                           long long r, int count, int t,
                                           int n_threads) {
  if (x.new_start >= 0) {
    for (int i = max(count, 0) + t; i < x.new_cap; i += n_threads) {
      p.ids[x.new_start + i] = kSentinel;
      p.wts[x.new_start + i] = 0.0f;
    }
    if (p.moves) {
      for (int i = t; i < x.new_cap; i += n_threads) {
        p.slot_rows[x.new_start + i] = x.row_id;
      }
    }
  }
  if (x.old_start >= 0 && x.new_start != x.old_start) {
    for (int i = t; i < x.old_cap; i += n_threads) {
      p.ids[x.old_start + i] = kSentinel;
    }
  }
  if (t == 0) {
    p.counts[r] = count;
    if (p.lo != nullptr && x.row_id >= 0 && x.row_id < p.nv) {
      p.lo[x.row_id] = x.new_start;
      p.hi[x.row_id] = x.new_start + count;
    }
  }
}

__device__ __forceinline__ void put(const Args& p, const Row& x, int at,
                                    int v, float wt) {
  if (x.new_start >= 0 && at < x.new_cap) {
    p.ids[x.new_start + at] = v;
    p.wts[x.new_start + at] = wt;
  }
}

// ---------------------------------------------------------------------
// W <= 32: a warp per row
// ---------------------------------------------------------------------
// #lanes whose value is < q, for values ascending across the warp's lanes;
// every lane must call it (lanes may ask for different q).
__device__ __forceinline__ int warp_lower_bound(int v, int q) {
  int lo = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    if (__shfl_sync(kFull, v, lo + step - 1) < q) lo += step;
  }
  return lo + (__shfl_sync(kFull, v, lo) < q);
}

__global__ void merge_rows_warp_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= p.a) return;  // the whole warp leaves together
  const int* bd = p.b_dst + r * p.k;
  const int* bl = p.b_del + r * p.k;
  const float* bw = p.b_wgt + r * p.k;
  // the first 32 ops (lane j holds op j) load beside the row's operands
  bool has_op = lane < p.k;
  int q = has_op ? bd[lane] : kSentinel;
  int del = has_op ? bl[lane] : 0;
  float ow = has_op ? bw[lane] : 0.0f;
  const Row x = load_row(p, r);
  const bool live = lane < x.deg;
  const int d = live ? p.ids[x.old_start + lane] : kSentinel;
  const float wt = live ? p.wts[x.old_start + lane] : 0.0f;
  const unsigned below = (1u << lane) - 1;  // lanes under this one
  // every lane's reads of the row before any lane's put() into it
  __syncwarp();

  bool killed = false, upsert = false;
  float up_w = 0.0f;
  int ins_below = 0;  // new inserts with a key under this lane's id
  int kills = 0, ins = 0;  // totals over the chunks so far
  for (int c0 = 0; c0 < p.k; c0 += 32) {
    if (c0) {
      has_op = c0 + lane < p.k;
      q = has_op ? bd[c0 + lane] : kSentinel;
      del = has_op ? bl[c0 + lane] : 0;
      ow = has_op ? bw[c0 + lane] : 0.0f;
    }
    // op lane: its key's rank among the live ids and whether it is live;
    // row lane: the chunk's ops under its id and the op with its id (the
    // ids ascend across the lanes, SENTINEL past deg, and so do the ops)
    int pos = 0, n_lt = 0, match = -1;
    bool found = false;
    if (x.deg > 0) {  // warp-uniform
      pos = warp_lower_bound(d, q);
      const int d_at = __shfl_sync(kFull, d, min(pos, 31));
      found = pos < x.deg && d_at == q;
      n_lt = warp_lower_bound(q, d);
      const int q_at = __shfl_sync(kFull, q, min(n_lt, 31));
      if (live && n_lt < 32 && q_at == d) match = n_lt;
    }
    const bool op = has_op && q != kSentinel;  // SENTINEL pads the run
    const bool is_kill = op && del && found;
    const bool is_ins = op && !del && !found;  // found inserts upsert
    const unsigned kill_m = __ballot_sync(kFull, is_kill);
    const unsigned ins_m = __ballot_sync(kFull, is_ins);
    if (is_ins) {
      put(p, x, pos - kills - __popc(kill_m & below) + ins + __popc(ins_m & below),
          q, ow);
    }
    const int m = match < 0 ? 0 : match;
    const int m_del = __shfl_sync(kFull, del, m);
    const float m_w = __shfl_sync(kFull, ow, m);
    if (match >= 0) {
      if (m_del) {
        killed = true;
      } else {
        upsert = true;
        up_w = m_w;
      }
    }
    ins_below += __popc(ins_m & (n_lt >= 32 ? kFull : (1u << n_lt) - 1));
    kills += __popc(kill_m);
    ins += __popc(ins_m);
  }
  const int kills_below = __popc(__ballot_sync(kFull, killed) & below);
  if (live && !killed) {
    put(p, x, lane - kills_below + ins_below, d, upsert ? up_w : wt);
  }
  finish_row(p, x, r, x.deg - kills + ins, lane, 32);
}

// ---------------------------------------------------------------------
// W > 32: a block per row
// ---------------------------------------------------------------------
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Classify an op against the staged live prefix; pos = #live ids < key.
__device__ __forceinline__ int op_kind(const int* d, int deg, int key,
                                       int is_del, int* pos) {
  *pos = lower_bound(d, deg, key);
  if (key == kSentinel) return kNone;  // run padding
  const bool found = *pos < deg && d[*pos] == key;
  if (is_del) return found ? kKill : kNone;
  return found ? kNone : kInsert;  // a found insert is an upsert
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

// ints a row's stage holds: ids and weights (w each), the run's keys, kills
// and inserts before each op (k each)
__host__ __device__ __forceinline__ long long stage_ints(int w, int k) {
  return 2LL * w + 3LL * k;
}

__global__ void merge_rows_block_kernel(const Args p) {
  extern __shared__ int smem[];
  const long long r = blockIdx.x;
  const int t = threadIdx.x, n_threads = blockDim.x;
  const Row x = load_row(p, r);
  int* sd = p.scratch ? p.scratch + r * stage_ints(p.w, p.k) : smem;
  float* sw = reinterpret_cast<float*>(sd + p.w);
  int* sk = sd + 2 * p.w;
  int* skb = sk + p.k;
  int* sib = skb + p.k;
  const int* bd = p.b_dst + r * p.k;
  const int* bl = p.b_del + r * p.k;
  const float* bw = p.b_wgt + r * p.k;

  // 1. stage the row and the run's keys; after this no slot is read
  for (int i = t; i < x.deg; i += n_threads) {
    sd[i] = p.ids[x.old_start + i];
    sw[i] = p.wts[x.old_start + i];
  }
  for (int i = t; i < p.k; i += n_threads) sk[i] = bd[i];
  __syncthreads();

  // 2. classify this thread's chunk of ops, scan, place new inserts
  const int chunk = (p.k + n_threads - 1) / n_threads;
  const int k0 = min(p.k, t * chunk);
  const int k1 = min(p.k, k0 + chunk);
  int n_kill = 0, n_ins = 0, pos;
  for (int j = k0; j < k1; ++j) {
    const int kind = op_kind(sd, x.deg, sk[j], bl[j], &pos);
    n_kill += kind == kKill;
    n_ins += kind == kInsert;
  }
  int kills = 0, ins = 0, kills_total = 0, ins_total = 0;
  block_scan2(n_kill, n_ins, &kills, &ins, &kills_total, &ins_total);
  for (int j = k0; j < k1; ++j) {
    const int kind = op_kind(sd, x.deg, sk[j], bl[j], &pos);
    skb[j] = kills;
    sib[j] = ins;
    if (kind == kInsert) put(p, x, pos - kills + ins, sk[j], bw[j]);
    kills += kind == kKill;
    ins += kind == kInsert;
  }
  __syncthreads();  // kills / inserts before each op visible to the block

  // 3. survivors move by the kills and inserts ranked below them
  for (int i = t; i < x.deg; i += n_threads) {
    const int v = sd[i];
    const int j = lower_bound(sk, p.k, v);
    float wt = sw[i];
    if (j < p.k && sk[j] == v) {
      if (bl[j]) continue;  // deleted
      wt = bw[j];           // upsert
    }
    put(p, x, i - (j < p.k ? skb[j] : kills_total) + (j < p.k ? sib[j] : ins_total),
        v, wt);
  }
  finish_row(p, x, r, x.deg - kills_total + ins_total, t, n_threads);
}

}  // namespace

// ids/wts: the arena, merged in place.  threads: the block kernel's block size
// (w > 32).  scratch: null when a row's stage (4 * (2w + 3k) bytes) fits in
// shared memory, else a * that many bytes of device memory.
extern "C" int repro_merge_rows(int* ids, float* wts, int* slot_rows,
                                const int* row_ops, long long a, int w,
                                const int* b_dst, const int* b_del,
                                const float* b_wgt, int k, int moves,
                                int* counts, int* lo, int* hi, int nv,
                                int* scratch, int threads, void* stream) {
  if (a <= 0) return 0;
  if (w <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{ids, wts, slot_rows, row_ops, a, w,
               b_dst, b_del, b_wgt, k, moves, counts, lo, hi, nv, scratch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w <= 32) {
    const long long blocks = (a + kRowsPerBlock - 1) / kRowsPerBlock;
    merge_rows_warp_kernel<<<static_cast<unsigned>(blocks), kRowsPerBlock * 32,
                             0, st>>>(p);
  } else {
    const size_t smem = scratch ? 0 : static_cast<size_t>(4 * stage_ints(w, k));
    merge_rows_block_kernel<<<static_cast<unsigned>(a), threads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
