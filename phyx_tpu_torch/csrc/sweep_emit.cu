// K6 and K7, the sweep-and-prune pair emission on Hopper (sm_90a).
//
// K6 replaces the TPU kernel phyx_tpu/kernels/sweep.py, sweep_emit_v2 (line
// 371); K7 replaces sweep_emit (line 36).  Both sweep bodies sorted by AABB
// min x: source row k tests the candidates j > k below nact, and emits the
// body ids (min, max) of each j whose x-interval starts before k's ends
// (xlo[j] <= xhi[k]), whose y-interval overlaps k's and where one of the two
// is dynamic (dyn[k] + dyn[j] > 0).  Emissions go to the pair buffer in the
// reference's serial order; the first max_pairs are kept, the rest counted
// (ovf).  nact is read on the device.
//
// The two differ in their order, which decides what survives a full
// buffer, and in their layout:
//
// * K7 takes the AABBs by body id, [lox, loy, hix, hiy] a row, and order
//   (sorted row -> body id).  Row si walks sj = si+1, si+2, ... while
//   sj < nact and the candidate's lox <= its hix: emissions ordered (si, sj).
// * K6 takes the AABBs, order and dyn already sorted, and a capacity in
//   whole 1024-row chunks.  Source chunk s is tested against target chunks
//   t = s, s+1, ... while t's first row is below nact and starts at or
//   before chunk_hix[s], the largest hix of chunk s (inactive rows
//   included, as the reference's max over the chunk); row k of chunk s
//   tests chunk t only where k < nact and t's first lox <= xhi[k].  Inside
//   a (k, t) cell the hits are extracted largest j first (the TPU takes a
//   max over the hit lanes): emissions ordered (s, t, k, j descending).
//   The chunk bounds only skip cells with no hit on x-sorted rows; they are
//   kept so that the kernel computes the reference's function on any rows.
//
// What the TPU kernels do that is not carried over: K7 keeps everything in
// SMEM and appends with a running counter; K6 holds the columns twice (flat
// in SMEM for scalar reads, (8, 128) tiles in VMEM for 1024-lane vector
// tests) and extracts hits with a max-reduction.  Here the rows stay in
// device memory (17,408 rows, 278 KB, at the 64-env scene: L2-resident).
//
// What bounds both: the bytes.  The rows below nact are read once and the
// kept pairs written once; the tests are a few float compares a candidate,
// far below that at 67 TFLOP/s (chip_smoke.py counts both).  As built, the
// longest walk's latency sets the time.
//
// K7, one block, one launch (count, scan and emit in the same block): a
// warp a sorted row in turn.  The warp's 32 lanes test candidates
// sj = si+1+lane+32m together, so order[sj] is read coalesced and 32
// AABB gathers are in flight, not one; __ballot_sync gives the x-open mask
// (b.x <= a.z, false on NaN, as the serial break) and the hit mask, and
// only hits before the first lane that is not x-open count; the walk stops
// at that batch.  The count is a __popc; the per-row counts sit in shared
// memory (4 n bytes; in a device buffer where they do not fit), a
// block-wide exclusive scan saturated at max_pairs gives each row its first
// slot, and in the emit walk a hit's slot is its row's first slot plus the
// row's hits before it (__popc of the mask below its lane), so the buffer
// is in (si, sj) order to the bit and slots at or past max_pairs are not
// written.  The same launch fills the slots from num on with EMPTY and
// writes num and ovf.  At the 500-box frame its time is the ground rows'
// walks (~500 candidates, 16 batches of two dependent loads each).
//
// K6, count, scan, emit, as K4's (csrc/sweep_tiled.cu).  The serial order
// is a sum over cells, K6's the (source row, target chunk) pairs laid out
// (s, t, k) over t >= s.  Kernel 1 counts each cell's hits with one thread
// a cell; an exclusive prefix sum over the cells (torch.cumsum in the
// wrapper, on the device) gives each its first slot; kernel 2 walks again
// and writes below max_pairs.  Its blocks are a quarter of a source chunk
// against one target chunk; the block stages the target chunk's rows in
// shared memory and its threads walk them in step, so each candidate's row
// is one broadcast read.  Its threads walk a visited target chunk in step,
// every row of it, not only the x-open run (chip_smoke.py; PERF.md has the
// times).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;    // K6's chunk: the reference's 8 x 128 lanes
constexpr int kThreads = 256;   // K6: a quarter chunk a block
constexpr int kQuarters = kChunk / kThreads;

// Candidate b (with dyn db) hits source a (with dyn da): b starts before a
// ends in x, the y-intervals overlap, one of the two is dynamic.
__device__ __forceinline__ bool hits(float4 a, int da, float4 b, int db) {
  return b.x <= a.z && b.y <= a.w && a.y <= b.w && da + db > 0;
}

__device__ __forceinline__ int active_rows(const int* nact, int n) {
  return min(max(*nact, 0), n);
}

// ---- K7: a warp a sorted row, one block ------------------------------

constexpr int kWarpThreads = 1024;  // K7's block: 32 warps
constexpr unsigned kAll = 0xffffffffu;

struct Rows {
  const float4* aabb;  // (n) [lox, loy, hix, hiy] by body id
  const int* order;    // (n) body id of sorted row
  const int* dyn;      // (n) by body id
  const int* nact;
  int n;
};

// Walks sorted row si with the warp: batch m tests sj = si+1+32m+lane on
// every lane, and batch(h, i, j) gets the hits h before the first lane
// that is not x-open (bit L: lane L's candidate), body i and this lane's
// body j.  The walk ends after the batch holding a closed lane, or when
// batch returns false.  Uniform over the warp.
template <class Batch>
__device__ __forceinline__ void walk_warp(const Rows& w, int si, int na,
                                          int lane, Batch batch) {
  const int i = w.order[si];
  const float4 a = w.aabb[i];
  const int di = w.dyn[i];
  for (int base = si + 1; base < na; base += 32) {
    const int sj = base + lane;
    int j = 0;
    bool open = false, hit = false;
    if (sj < na) {
      j = w.order[sj];
      const float4 b = w.aabb[j];
      open = b.x <= a.z;
      hit = hits(a, di, b, w.dyn[j]);
    }
    const unsigned closed = __ballot_sync(kAll, !open);
    const unsigned before = closed ? (1u << (__ffs(closed) - 1)) - 1u : kAll;
    const unsigned h = __ballot_sync(kAll, hit) & before;
    if (!batch(h, i, j) || closed) return;
  }
}

// One block: counts, scan, emit.  counts: shared memory (kSmem, 4 n bytes
// of dynamic shared memory) or the device buffer counts_g (n ints).
template <bool kSmem>
__global__ void __launch_bounds__(kWarpThreads)
    warp_sweep(Rows w, int* __restrict__ counts_g, int max_pairs, int empty,
               int* __restrict__ pi, int* __restrict__ pj,
               int* __restrict__ num_out, int* __restrict__ ovf_out) {
  extern __shared__ int counts_s[];
  __shared__ long long s_warp[32];
  int* counts = kSmem ? counts_s : counts_g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kWarpThreads / 32;
  const int na = active_rows(w.nact, w.n);

  for (int si = warp; si < na; si += nwarps) {
    int c = 0;
    walk_warp(w, si, na, lane, [&](unsigned h, int, int) {
      c += __popc(h);
      return true;
    });
    if (lane == 0) counts[si] = c;
  }
  __syncthreads();

  // exclusive prefix sum of the counts, each saturated at max_pairs (the
  // slots past it are not written); the total in 64 bits
  long long carry = 0;
  for (int base = 0; base < na; base += kWarpThreads) {
    const int idx = base + tid;
    const long long x = idx < na ? counts[idx] : 0;
    long long y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(kAll, y, o);
      if (lane >= o) y += u;
    }
    if (lane == 31) s_warp[warp] = y;
    __syncthreads();
    if (warp == 0) {
      long long z = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long u = __shfl_up_sync(kAll, z, o);
        if (lane >= o) z += u;
      }
      s_warp[lane] = z;
    }
    __syncthreads();
    const long long excl = carry + (warp ? s_warp[warp - 1] : 0) + y - x;
    if (idx < na)
      counts[idx] = static_cast<int>(excl < max_pairs ? excl : max_pairs);
    carry += s_warp[nwarps - 1];
    __syncthreads();
  }
  const int num = static_cast<int>(carry < max_pairs ? carry : max_pairs);

  for (int s = num + tid; s < max_pairs; s += kWarpThreads) {
    pi[s] = empty;
    pj[s] = empty;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int si = warp; si < na; si += nwarps) {
    int slot = counts[si];
    // a row with hits has its successor's first slot past its own, until
    // the buffer is full
    const int next = si + 1 < na ? counts[si + 1] : num;
    if (slot >= next) continue;
    walk_warp(w, si, na, lane, [&](unsigned h, int i, int j) {
      const int at = slot + __popc(h & below);
      if ((h >> lane & 1u) && at < max_pairs) {
        pi[at] = min(i, j);
        pj[at] = max(i, j);
      }
      slot += __popc(h);
      return slot < max_pairs;
    });
  }
  if (tid == 0) {
    *num_out = num;
    *ovf_out = static_cast<int>(carry - num);
  }
}

// ---- K6: a block a (quarter source chunk, target chunk) ------------------

struct Chunked {
  const float4* aabb;      // (n) [lox, loy, hix, hiy] sorted
  const int* order;        // (n) body id of sorted row
  const int* dyn;          // (n) sorted
  const int* nact;
  const float* chunk_hix;  // (nb) largest hix of each chunk
  int nb;
};

// The cells of source chunks below s: t runs over [s', nb) for each s' < s.
__device__ __forceinline__ long long cell_base(int s, int t, int nb) {
  const long long tri = (long long)s * nb - (long long)s * (s - 1) / 2;
  return (tri + (t - s)) * kChunk;
}

// Whether the reference's chunk loop of source chunk s reaches target
// chunk t: every chunk u in [s, t] has its first row below na and starting
// at or before chunk_hix[s].
__device__ __forceinline__ bool visited(const Chunked& w, int s, int t,
                                        int na) {
  if ((long long)s * kChunk >= na) return false;  // s is no source chunk
  const float smax = w.chunk_hix[s];
  for (int u = s; u <= t; ++u)
    if (!((long long)u * kChunk < na && w.aabb[u * kChunk].x <= smax))
      return false;
  return true;
}

// One block's view of its cell group: source row k (this thread's), target
// chunk t, and the candidate rows [lo, hi) the block walks.
struct Cell {
  int s, t, k, lo, hi;
  long long id;  // the cell's index in (s, t, k) order
};

__device__ __forceinline__ Cell cell_of(const Chunked& w, int na) {
  const int s = blockIdx.y;
  const int t = blockIdx.x / kQuarters;
  const int first = s * kChunk + (blockIdx.x % kQuarters) * kThreads;
  Cell c;
  c.s = s;
  c.t = t;
  c.k = first + threadIdx.x;
  // below t's chunk or k + 1 nothing is a candidate of the block's rows
  c.lo = max(t * kChunk, first + 1);
  c.hi = min((t + 1) * kChunk, na);
  c.id = cell_base(s, t, w.nb) + (c.k - s * kChunk);
  return c;
}

// Stages target chunk t's rows (and, with ids, their body ids) in shared
// memory.
__device__ __forceinline__ void stage(const Chunked& w, int t, float4* box,
                                      int* dyn, int* ids) {
  for (int r = threadIdx.x; r < kChunk; r += kThreads) {
    box[r] = w.aabb[t * kChunk + r];
    dyn[r] = w.dyn[t * kChunk + r];
    if (ids) ids[r] = w.order[t * kChunk + r];
  }
  __syncthreads();
}

// Row k's guard for chunk t: active, and open at t's first lox.
__device__ __forceinline__ bool guard(const Chunked& w, const Cell& c,
                                      float4 a, int na) {
  return c.k < na && w.aabb[c.t * kChunk].x <= a.z;
}

__global__ void __launch_bounds__(kThreads)
    chunked_count(Chunked w, int* __restrict__ counts) {
  if (blockIdx.x / kQuarters < blockIdx.y) return;  // t < s: no cells
  const int na = active_rows(w.nact, w.nb * kChunk);
  const Cell c = cell_of(w, na);
  if (!visited(w, c.s, c.t, na)) {
    counts[c.id] = 0;
    return;
  }
  __shared__ float4 box[kChunk];
  __shared__ int dyn[kChunk];
  stage(w, c.t, box, dyn, nullptr);
  const float4 a = w.aabb[c.k];
  const int da = w.dyn[c.k];
  int n = 0;
  if (guard(w, c, a, na))
    for (int j = c.lo; j < c.hi; ++j)
      n += j > c.k && hits(a, da, box[j - c.t * kChunk],
                           dyn[j - c.t * kChunk]);
  counts[c.id] = n;
}

__global__ void __launch_bounds__(kThreads)
    chunked_emit(Chunked w, const int* __restrict__ counts,
                 const long long* __restrict__ ends, int max_pairs,
                 int* __restrict__ pi, int* __restrict__ pj) {
  if (blockIdx.x / kQuarters < blockIdx.y) return;
  const int na = active_rows(w.nact, w.nb * kChunk);
  const Cell c = cell_of(w, na);
  const int cnt = counts[c.id];
  // exclusive prefix: the emissions of the cells before this one
  long long slot = ends[c.id] - cnt;
  const bool writes = cnt > 0 && slot < max_pairs;
  if (!__syncthreads_or(writes)) return;  // uniform over the block
  __shared__ float4 box[kChunk];
  __shared__ int dyn[kChunk];
  __shared__ int ids[kChunk];
  stage(w, c.t, box, dyn, ids);
  if (!writes) return;
  const float4 a = w.aabb[c.k];
  const int da = w.dyn[c.k];
  const int oi = w.order[c.k];
  // the reference extracts the largest hit lane first: j descending
  for (int j = c.hi - 1; j >= c.lo; --j) {
    const int r = j - c.t * kChunk;
    if (j > c.k && hits(a, da, box[r], dyn[r])) {
      pi[slot] = min(oi, ids[r]);
      pj[slot] = max(oi, ids[r]);
      if (++slot >= max_pairs) break;
    }
  }
}

Chunked chunked(const void* aabb, const void* order, const void* dyn,
                const void* nact, const void* chunk_hix, int nb) {
  return {static_cast<const float4*>(aabb), static_cast<const int*>(order),
          static_cast<const int*>(dyn), static_cast<const int*>(nact),
          static_cast<const float*>(chunk_hix), nb};
}

dim3 chunked_grid(int nb) { return dim3(nb * kQuarters, nb); }

}  // namespace

// Plain C entries for ctypes: each launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; aabb is
// (n, 4) f32 [lox, loy, hix, hiy], 16-byte aligned; order and dyn (n) int32;
// nact () int32.  pi and pj (max_pairs) int32 get the slots [0, min(total,
// max_pairs)).

// K7: aabb and dyn by body id; one launch writes the whole buffer (EMPTY
// from num on), num and ovf (() int32).  counts: a device buffer of n ints,
// used when smem_counts is 0 (the counts not in shared memory).
extern "C" int phyx_sweep_warp(const void* aabb, const void* order,
                               const void* dyn, const void* nact,
                               void* counts, void* pi, void* pj, void* num,
                               void* ovf, int n, int max_pairs, int empty,
                               int smem_counts, void* stream) {
  const Rows w{static_cast<const float4*>(aabb),
               static_cast<const int*>(order), static_cast<const int*>(dyn),
               static_cast<const int*>(nact), n};
  const auto kernel = smem_counts ? warp_sweep<true> : warp_sweep<false>;
  const size_t smem = smem_counts ? 4 * static_cast<size_t>(n) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kWarpThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<int*>(counts), max_pairs, empty, static_cast<int*>(pi),
      static_cast<int*>(pj), static_cast<int*>(num), static_cast<int*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

// K6's two launches: counts is int32 a cell, ends its inclusive prefix sum
// in int64.
// K6: aabb, order and dyn sorted, n = 1024 nb; chunk_hix (nb) f32; one cell
// a (source row, target chunk t >= its chunk), counts (nb (nb + 1) / 2 *
// 1024) in (s, t, k) order.
extern "C" int phyx_sweep_chunked_count(const void* aabb, const void* order,
                                        const void* dyn, const void* nact,
                                        const void* chunk_hix, void* counts,
                                        int nb, void* stream) {
  chunked_count<<<chunked_grid(nb), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      chunked(aabb, order, dyn, nact, chunk_hix, nb),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int phyx_sweep_chunked_emit(const void* aabb, const void* order,
                                       const void* dyn, const void* nact,
                                       const void* counts, const void* ends,
                                       void* pi, void* pj, int nb,
                                       int max_pairs, void* stream) {
  chunked_emit<<<chunked_grid(nb), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      chunked(aabb, order, dyn, nact, nullptr, nb),
      static_cast<const int*>(counts), static_cast<const long long*>(ends),
      max_pairs, static_cast<int*>(pi), static_cast<int*>(pj));
  return static_cast<int>(cudaGetLastError());
}
