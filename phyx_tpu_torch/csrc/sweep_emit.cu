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
// tests) and extracts hits with a max-reduction.
//
// What bounds both: the bytes.  The rows below nact are read once and the
// kept pairs written once; the tests are a few float compares a candidate,
// far below that at 67 TFLOP/s (chip_smoke.py counts both).  As built, the
// longest walk's latency and the launch set the time.
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
// K6, one launch that counts, scans and writes (csrc/onepass.cuh's
// single-pass scan), on a persistent grid of resident blocks that take
// tickets in turn.  The serial order is a sum over cells, the (source row
// k, target chunk t) pairs in (s, t, k) order.  The first nb tickets are
// chunk tiles: tile s computes chunk_hix[s] (NaN if any hix is, as the
// reference's max) and the last target chunk its chunk loop reaches, and
// publishes that.  The later tickets wait for all of them and number only
// the reached tiles, an eighth of a source chunk (128 rows) with an
// active row against one reached target chunk, in (s, t, q) order; the
// ticket past the last is the end tile, which looks back over them all
// and writes num, ovf and the EMPTY tail.  A cell the chunk loop never
// reaches costs no tile and no scan entry.  A tile brings target chunk
// t's rows, dyn and ids (24 KB) into shared memory with three bulk copies
// (TMA) on one mbarrier while its lanes load their source rows.  Its 16
// warps take 8 source rows each, interleaved (row w + 16 r: the grounds of
// one x-cell sort next to each other and would otherwise all fall to one
// warp), a row at a time, 32 candidates j = lo+32b+lane a batch (lo =
// max(t's first row, k + 1)), two batches loaded before either is tested:
// the hit mask is a __ballot_sync, lane b keeps batch b's mask in a
// register (a cell has at most 32 batches) and lane r the row's count.
// The whole cell is tested, on any rows; the walk stops after the step
// holding the first candidate that is not x-open only where the launch
// has shown, on the staged rows, that t's rows below nact have
// nondecreasing lox and no NaN (then no hit lies past that candidate: the
// short walk, taken on every main-path frame).  A block scan of the
// counts in row order gives each row its first slot in the tile; after
// the look-back, a hit's slot is the tile's first slot, its row's offset
// and the row's hits at a larger j (the batches above: a suffix sum of the
// masks' __popc; in its batch: __popc of the mask above its lane), so the
// emissions come in (s, t, k, j descending) order with no second walk,
// and slots at or past max_pairs are not written.

#include <cuda_runtime.h>

#include "onepass.cuh"

namespace {

constexpr int kChunk = 1024;  // K6's chunk: the reference's 8 x 128 lanes

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

// ---- K6: one pass over (source rows, reached target chunk) tiles --------

constexpr int kTileRows = 128;  // K6's tile: an eighth of a source chunk
constexpr int kTilesPerChunk = kChunk / kTileRows;
constexpr int kCellThreads = 512;  // 16 warps
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kWarpRows = kTileRows / kCellWarps;  // 16 source rows a warp

struct Chunked {
  const float4* aabb;  // (n) [lox, loy, hix, hiy] sorted
  const int* order;    // (n) body id of sorted row
  const int* dyn;      // (n) sorted
  const int* nact;
  int nb;
};

// Each source chunk's reach, the last target chunk t its chunk loop
// reaches (s - 1 for none): written once a call by the chunk tile s (ticket
// s), read by every later tile.
struct Reach {
  unsigned* flag;  // (nb) the epoch of the call that wrote it
  int* last;       // (nb)
};

// The largest hix of chunk s over its 1024 rows (inactive ones included),
// NaN if any is NaN: the reference's max.  Every thread; a barrier.
__device__ __forceinline__ float chunk_max(const Chunked& w, int s,
                                           float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = -__int_as_float(0x7f800000);  // -inf
  bool nan = false;
  for (int r = threadIdx.x; r < kChunk; r += kCellThreads) {
    const float z = w.aabb[s * kChunk + r].z;
    nan = nan || isnan(z);
    m = fmaxf(m, z);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kAll, m, o));
  if (lane == 0) s_red[warp] = m;
  nan = __syncthreads_or(nan);
  for (int i = 0; i < kCellWarps; ++i) m = fmaxf(m, s_red[i]);
  return nan ? __int_as_float(0x7fffffff) : m;
}

// The reference's chunk loop of source chunk s: target chunks t = s, s+1,
// ... while t's first row is below na and starts at or before
// chunk_hix[s].  Returns the last t it reaches (s - 1 for none).  Every
// thread; barriers.
__device__ __forceinline__ int chunk_reach(const Chunked& w, int s, int na,
                                           float* s_red, int* s_stop) {
  if (s * kChunk >= na) return s - 1;  // s is no source chunk
  const float smax = chunk_max(w, s, s_red);
  if (threadIdx.x == 0) *s_stop = w.nb;
  __syncthreads();
  for (int u = s + threadIdx.x; u < w.nb; u += kCellThreads)
    if (!(u * kChunk < na && w.aabb[u * kChunk].x <= smax))
      atomicMin(s_stop, u);
  __syncthreads();
  return *s_stop - 1;
}

// The tile of compact index j, among the reached tiles in (s, t, q) order:
// source chunk s, target chunk t in [s, its reach], part q of s's
// 128-row parts with an active row.  One warp, every lane: waits for every
// chunk's reach; returns the number of reached tiles (the end tile's
// index) and, where j is below it, (s, t, q).
__device__ __forceinline__ int locate(const Chunked& w, Reach rc,
                                      unsigned epoch, int na, int j, int& s,
                                      int& t, int& q) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < w.nb; base += 32) {
    const int c = base + lane;
    int v = 0, nq = 0, last = c - 1;
    if (c < w.nb) {
      for (unsigned tries = 0;
           phyx::onepass::load_acquire(&rc.flag[c]) != epoch;)
        if (++tries == phyx::onepass::kMaxTries) __trap();
      last = phyx::onepass::load_relaxed(&rc.last[c]);
      nq = min(max((na - c * kChunk + kTileRows - 1) / kTileRows, 0),
               kTilesPerChunk);
      v = last >= c ? (last - c + 1) * nq : 0;
    }
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, x, o);
      if (lane >= o) x += y;
    }
    const unsigned here =
        __ballot_sync(kAll, v > 0 && carry + x - v <= j && j < carry + x);
    if (here) {
      const int src = __ffs(here) - 1;
      const int idx = j - carry - __shfl_sync(kAll, x - v, src);
      const int k = __shfl_sync(kAll, nq, src);
      s = base + src;
      t = s + idx / k;
      q = idx % k;
    }
    carry += __shfl_sync(kAll, x, 31);
  }
  return carry;
}

// Row r of warp w of the tile: rows interleaved over the warps, so that
// neighbouring long rows (the grounds of one x-cell sort together) walk on
// different warps.
__device__ __forceinline__ int tile_row(int warp, int r) {
  return warp + kCellWarps * r;
}

// One launch of a persistent grid: each block takes tickets in turn.
// Tickets 0 .. nb-1 are chunk tiles (the reach of source chunk s); the
// next ones, less nb, number the reached tiles in (s, t, q) order, then
// the end tile, which writes the counters.  A tile's 16 warps take 16
// source rows k each, one at a time; lane b keeps the hit mask of the
// row's batch b (32 candidates), and a block scan of the rows' counts in
// row order gives each row's first slot in the tile, the look-back the
// tile's; a hit's slot is its row's first slot plus the row's hits at a
// larger j.
__global__ void __launch_bounds__(kCellThreads)
    chunked_onepass(Chunked w, phyx::onepass::Scan sc, Reach rc,
                    int max_pairs, int empty, int* __restrict__ pi,
                    int* __restrict__ pj, int* __restrict__ counters) {
  namespace op = phyx::onepass;
  __shared__ alignas(16) float4 box[kChunk];
  __shared__ alignas(16) int sdyn[kChunk];
  __shared__ alignas(16) int sids[kChunk];
  __shared__ alignas(8) uint64_t bar;
  __shared__ int s_row[kTileRows];  // a row's count, then its first place
  __shared__ float s_red[kCellWarps];
  __shared__ int s_cnt[kTileRows / 32];
  __shared__ int s_tile[4];  // s, t, q, the reached tiles
  __shared__ long long s_first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int na = active_rows(w.nact, w.nb * kChunk);
  if (tid == 0) op::mbar_init(&bar);
  for (unsigned phase = 0;;) {
  const op::Tile ticket = op::take(sc);  // barriers: bar is initialized
  if (ticket.index < w.nb) {  // a chunk tile
    const int last = chunk_reach(w, ticket.index, na, s_red, &s_tile[0]);
    if (tid == 0) {
      rc.last[ticket.index] = last;
      op::store_release(&rc.flag[ticket.index], ticket.epoch);
    }
    continue;
  }
  const op::Tile tile{ticket.index - w.nb, ticket.epoch, ticket.calls};
  if (warp == 0) {
    int s = 0, t = 0, q = 0;
    const int n = locate(w, rc, tile.epoch, na, tile.index, s, t, q);
    if (lane == 0) {
      s_tile[0] = s;
      s_tile[1] = t;
      s_tile[2] = q;
      s_tile[3] = n;
    }
  }
  __syncthreads();
  const int reached = s_tile[3];
  // the call's last ticket: one past the end tile a block but the end
  // tile's (which exits after it)
  if (tid == 0 && tile.index == reached + static_cast<int>(gridDim.x) - 1)
    op::finish_call(sc, tile);
  if (tile.index > reached) return;  // past the end tile: none left
  if (tile.index == reached) {       // the end tile: num, ovf, EMPTY tail
    if (warp == 0) {
      const long long total = op::look_back(sc, tile, lane);
      if (lane == 0) s_first = total;
    }
    __syncthreads();
    const long long total = s_first;
    const int num = static_cast<int>(total < max_pairs ? total : max_pairs);
    if (tid == 0) {
      counters[0] = num;
      counters[1] = static_cast<int>(total - num);
    }
    for (int p = num + tid; p < max_pairs; p += kCellThreads) {
      pi[p] = empty;
      pj[p] = empty;
    }
    return;
  }
  const int s = s_tile[0], t = s_tile[1];
  const int tbase = t * kChunk;
  const int first_row = s * kChunk + s_tile[2] * kTileRows;

  // target chunk t's columns into shared memory: three bulk copies
  if (tid == 0) {
    op::fence_proxy_async();
    op::mbar_expect(&bar, kChunk * 24);
    op::bulk_load(box, w.aabb + tbase, kChunk * 16, &bar);
    op::bulk_load(sdyn, w.dyn + tbase, kChunk * 4, &bar);
    op::bulk_load(sids, w.order + tbase, kChunk * 4, &bar);
  }
  unsigned m[kWarpRows];  // lane b: the row's batch b hit mask
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) m[r] = 0u;
  float4 my_a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int my_d = 0, my_o = 0;  // lane r: the warp's row r's AABB, dyn, id
  if (lane < kWarpRows) {
    const int k = first_row + tile_row(warp, lane);
    my_a = w.aabb[k];
    my_d = w.dyn[k];
    my_o = w.order[k];
  }
  op::mbar_wait(&bar, phase);
  phase ^= 1u;
  // the proof that allows the short walk: t's active rows have
  // nondecreasing lox and none is NaN, so no hit of a row lies past its
  // first candidate that is not x-open
  const int rows = min(kChunk, na - tbase);
  bool ok = true;
  for (int r = tid; r < rows; r += kCellThreads) {
    const float x = box[r].x;
    ok = ok && !isnan(x) && (r + 1 >= rows || x <= box[r + 1].x);
  }
  const bool sorted = __syncthreads_and(ok);
  const float first_lox = box[0].x;
  const int hi = min(tbase + kChunk, na) - tbase;  // chunk-relative
  int cnt = 0;  // lane r: the warp's row r's hits in this cell
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int k = first_row + tile_row(warp, r);
    const float4 a = make_float4(
        __shfl_sync(kAll, my_a.x, r), __shfl_sync(kAll, my_a.y, r),
        __shfl_sync(kAll, my_a.z, r), __shfl_sync(kAll, my_a.w, r));
    const int da = __shfl_sync(kAll, my_d, r);
    if (!(k < na && first_lox <= a.z)) continue;  // the row's guard
    int c = 0;
    // two batches a step, both loaded before either is tested; the short
    // walk ends after the step holding a closed candidate
    for (int j0 = max(tbase, k + 1) - tbase, b = 0; j0 < hi;
         j0 += 64, b += 2) {
      const int j = j0 + lane;
      const bool in0 = j < hi, in1 = j + 32 < hi;
      float4 b0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b1 = b0;
      int d0 = 0, d1 = 0;
      if (in0) {
        b0 = box[j];
        d0 = sdyn[j];
      }
      if (in1) {
        b1 = box[j + 32];
        d1 = sdyn[j + 32];
      }
      const unsigned h0 = __ballot_sync(kAll, in0 && hits(a, da, b0, d0));
      const unsigned h1 = __ballot_sync(kAll, in1 && hits(a, da, b1, d1));
      if (lane == b) m[r] = h0;
      if (lane == b + 1) m[r] = h1;
      c += __popc(h0) + __popc(h1);
      if (sorted && __any_sync(kAll, (in0 && !(b0.x <= a.z)) ||
                                         (in1 && !(b1.x <= a.z))))
        break;
    }
    if (lane == r) cnt = c;
  }
  if (lane < kWarpRows) s_row[tile_row(warp, lane)] = cnt;
  __syncthreads();

  // each row's first place in the tile: an exclusive scan in row order
  int v = 0, x = 0, agg = 0;
  if (warp < kTileRows / 32) {
    v = s_row[tid];
    x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_cnt[warp] = x;
  }
  __syncthreads();
  for (int i = 0; i < kTileRows / 32; ++i) {
    x += i < warp ? s_cnt[i] : 0;
    agg += s_cnt[i];
  }
  if (warp < kTileRows / 32) s_row[tid] = x - v;

  if (tid == 0) op::publish(sc, tile, agg, tile.index == 0);
  if (agg == 0) continue;  // block-uniform: nothing to write
  if (warp == 0) {
    const long long excl = tile.index ? op::look_back(sc, tile, lane) : 0;
    if (lane == 0) {
      if (tile.index) op::publish(sc, tile, excl + agg, true);
      s_first = excl;
    }
  }
  __syncthreads();
  const long long first = s_first;

  const unsigned above_lane = ~((2u << lane) - 1u);
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int i = tile_row(warp, r);
    const long long slot = first + s_row[i];
    const int c = i + 1 < kTileRows ? s_row[i + 1] - s_row[i] : agg - s_row[i];
    if (c == 0 || slot >= max_pairs) continue;
    const int oi = __shfl_sync(kAll, my_o, r);
    // lane's candidate in batch 0, chunk-relative
    const int jb = max(tbase, first_row + i + 1) - tbase + lane;
    // the row's hits in the batches above each lane's batch
    const int pc = __popc(m[r]);
    int suf = pc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kAll, suf, o);
      if (lane + o < 32) suf += y;
    }
    const int above = suf - pc;
    for (unsigned todo = __ballot_sync(kAll, m[r] != 0u); todo;
         todo &= todo - 1u) {
      const int b = __ffs(todo) - 1;
      const unsigned h = __shfl_sync(kAll, m[r], b);
      const long long at =
          slot + __shfl_sync(kAll, above, b) + __popc(h & above_lane);
      if ((h >> lane & 1u) && at < max_pairs) {
        const int oj = sids[jb + 32 * b];
        pi[at] = min(oi, oj);
        pj[at] = max(oi, oj);
      }
    }
  }
  }
}

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

// K6's reached tiles at nb chunks, at most (the scratch's ntiles).
extern "C" int phyx_sweep_chunked_tiles(int nb) {
  return nb * (nb + 1) / 2 * kTilesPerChunk;
}

// K6: aabb, order and dyn sorted, each 16-byte aligned, n = 1024 nb; one
// launch writes the whole buffer (EMPTY from num on) and counters (2)
// int32 [num, ovf].  The scratch, zeroed once and kept for this stream and
// shape: ticket (1) u64, flag (ntiles) u32, agg and incl (ntiles) i64,
// reach_flag and reach (nb) i32; ntiles = phyx_sweep_chunked_tiles(nb).
// The launch keeps the scratch's call count itself (csrc/onepass.cuh), so
// the scratch is never cleared and a captured launch replays.
extern "C" int phyx_sweep_chunked(const void* aabb, const void* order,
                                  const void* dyn, const void* nact,
                                  void* ticket, void* flag, void* agg,
                                  void* incl, void* reach_flag, void* reach,
                                  void* pi, void* pj, void* counters, int nb,
                                  int max_pairs, int empty, void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = phyx_sweep_chunked_tiles(nb);
  const Chunked w{static_cast<const float4*>(aabb),
                  static_cast<const int*>(order), static_cast<const int*>(dyn),
                  static_cast<const int*>(nact), nb};
  const phyx::onepass::Scan sc{static_cast<unsigned long long*>(ticket),
                               static_cast<unsigned*>(flag),
                               static_cast<long long*>(agg),
                               static_cast<long long*>(incl), ntiles};
  const Reach rc{static_cast<unsigned*>(reach_flag), static_cast<int*>(reach)};
  const int grid = phyx::onepass::resident_grid(chunked_onepass, kCellThreads,
                                                nb + ntiles + 1);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  chunked_onepass<<<grid, kCellThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      w, sc, rc, max_pairs, empty, static_cast<int*>(pi),
      static_cast<int*>(pj), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}
