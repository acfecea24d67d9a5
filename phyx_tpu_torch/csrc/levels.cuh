// The level schedule shared by the level-by-level solves on Hopper
// (sm_90a): K1 (contact_solver_streamed.cu) over its row list, K3 and K5
// (contact_solver_tiled.cu) over the tiled tier's slab walk.
//
// Why levels: a visit reads and writes its own row's accumulators and the
// rows of its two bodies, nothing else, and a pass's residual is a max of
// values >= 0, which no order changes.  So any schedule that runs each
// visit after every earlier visit (in serial order) sharing a body row with
// it performs the same float operations on the same operands as the serial
// walk.  The pre-pass (visit_levels) gives each visit the level
// 1 + max(last[i], last[j]) (last: per body-table row, the level of its
// latest visit, in shared memory where it fits), walking the visits in
// serial order.  It buckets the visits by level (count, prefix sum,
// scatter; the order inside a level is free) into 80-byte records: the
// row's 12 columns, its 2 warm impulses, both bodies' inv_mass and
// inv_inertia (read-only), both body rows, the joint flag in the sign bit
// of the first, a free flag in bit 30 of each.  The level solve
// (level_solve) runs each pass level by level; a pass's residual is a max_p
// across the block in one fixed order, so every thread takes the same
// gate.  A NaN residual stays NaN under any order of the max, its payload
// may not.
//
// Free rows.  A row whose 8 columns are all +0.0 bits (a static at rest:
// inverse masses 0, velocity and pseudo-velocity +0.0; the tiled tier's
// zero blocks, halo and padding, the pile's ground) orders nothing while
// every write to it is +0.0: each write is col -+ m * (product) with m =
// +0.0 (solve_rows.cuh), and +0.0 -+ (+-0.0) is +0.0 under round to
// nearest, so the row keeps its bits and every read of it, in any order,
// reads +0.0.  The pre-pass classifies the rows of the table it is given
// (a bitmask in shared memory) and walks a free row as no node: it
// contributes 0 to a visit's level and its last level never moves (its
// loads read a slot that holds 0, its stores go to a sink slot).  The level
// solve reads a free row as +0.0 without loading it, computes its writes as
// before, and stores none of them: a write whose bits are not +0.0 (a
// product that is not finite) sets the solve's fallback flag.  A product
// that is not finite writes NaN to the row in the serial walk, and which
// later visits read that NaN depends on the order; so where the flag is
// set, a rerun (gated launches that return at once while it is clear)
// copies the table back from the solve's input and runs the pre-pass and
// the level solve again over the full graph, every row a node: the result
// equals the serial walk's to the bit in every case.  K2
// (contact_solver.cu) keeps the full graph (prepass<false>).
//
// A visit map says which visits a pass makes, in serial order, and where
// each finds its data (the solves differ only there):
//   int table_ints() const        ints of shared memory the map needs for
//                                 its own table (host and device)
//   int begin(int* table)         called by every thread of the pre-pass
//                                 block: builds the table, ends with a
//                                 barrier, returns the number of visits v
//   Visit at(int q, int& hint)    visit q of [0, v): its row slot k, its
//                                 two body-table rows (clamped as the
//                                 serial walk clamps them), joint or not;
//                                 hint is a cursor the caller keeps per
//                                 thread, 0 at first, for q ascending
//   const float* cols(int k)      slot k's 12 row columns
//   const float* warm(int k)      its 2 warm impulses
//
// The level solve, built in three steps, each kept because the card ran it
// faster (PERF.md has each step's time; k1_anatomy.py measures them):
//   - the level-synchronous solve over the body table in device memory;
//   - the three working columns of every row (0-2 in the warm and velocity
//     passes, 5-7 in the displacement passes) in shared memory, 12 N
//     bytes, where they fit one block's 227 KB (the caller decides from the
//     table's rows N), else in device memory;
//   - each thread holds its records of the next kDepth levels (and their
//     accumulators, last written by this thread in the previous pass) in
//     registers, loaded kDepth levels early, so a record's L2 latency
//     overlaps the levels between.
// The level offsets sit in shared memory where they fit beside the
// columns.  One block of kSolveThreads threads.  The visits are
// solve_rows.cuh's, instantiated on BodyCols; built with -fmad=false like
// every solve kernel here.

#pragma once

#include <cuda_runtime.h>

#include "solve_rows.cuh"

namespace phyx {
namespace levels {

constexpr int kPrepassThreads = 512;
constexpr int kWarm = 0, kVel = 1, kPos = 2;
// the level solve's dynamic shared memory: one block's 227 KB less 1 KB
// for its own (the residual's 128 bytes)
constexpr int kSolveSmem = 232448 - 1024;
// the level solve's block (128 and 256 threads were no faster on the card)
constexpr int kSolveThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
// the joint-row flag rides in the sign bit of a record's first body row,
// each body's free flag in bit 30 of its row
constexpr int kJointFlag = static_cast<int>(0x80000000u);
constexpr int kFreeFlag = 0x40000000;
constexpr int kRowBits = 0x3fffffff;
// a solve's counters (ints, in device memory): levels a pass, visits,
// visits with a free endpoint, fallback fired (0 or 1; the rerun's gate)
constexpr int kStatLevels = 0, kStatVisits = 1, kStatFreed = 2,
              kStatFallback = 3, kStats = 4;

struct Visit {
  int k, i, j;
  bool joint;
};

// ---- the visit map of K1 and K2 ----

// Contact rows [0, num), then joint rows [c_cap, c_cap + numj), the counts
// read on the device and clamped into their capacities, the ids clamped
// into [0, N) as the plain version clamps them
struct RowsMap {
  const int* b1;
  const int* b2;
  const float* con;
  const float* warm_rows;
  const int* num_ptr;
  const int* numj_ptr;  // null: no joint rows
  int n_cap, c_cap, j_cap;
  int num;

  __host__ __device__ int table_ints() const { return 0; }
  __device__ __forceinline__ int begin(int*) {
    num = *num_ptr;
    num = num < 0 ? 0 : (num > c_cap ? c_cap : num);
    int numj = numj_ptr ? *numj_ptr : 0;
    numj = numj < 0 ? 0 : (numj > j_cap ? j_cap : numj);
    return num + numj;
  }
  __device__ __forceinline__ Visit at(int q, int&) const {
    const int k = q < num ? q : c_cap + (q - num);
    return {k, clamp_id(b1[k], n_cap), clamp_id(b2[k], n_cap), k >= c_cap};
  }
  __device__ __forceinline__ const float* cols(int k) const {
    return con + 12 * static_cast<size_t>(k);
  }
  __device__ __forceinline__ const float* warm(int k) const {
    return warm_rows + 2 * k;
  }
};

// ---- the pre-pass: levels, buckets, records ----

// whether row b is free in the bitmask free_mask
__device__ __forceinline__ bool row_free(const unsigned* free_mask, int b) {
  return (free_mask[b >> 5] >> (b & 31)) & 1u;
}

// Run by every thread of one block (any multiple of 32 threads up to
// 1024).  table: the map's table in shared memory; last (n_rows ints, and
// 2 more with kFree: the zero slot and the sink): the last-level array, in
// shared or device memory; free_mask (kFree: n_rows bits, shared memory).
// Out: lvl (R) each visit's level, cursor (R), loff (R + 1) level offsets,
// *nlev_out the level count, slot_s (R) each record's row slot, rec (R * 20)
// and acc_s (R * 4, zeroed), both in level order; stats (may be null): the
// counters, the fallback flag cleared.  Ends without a barrier after the
// scatter.
template <bool kFree, class Map>
__device__ __forceinline__ void prepass(
    Map map, const float* __restrict__ body, int n_rows, int* table,
    int* last, unsigned* free_mask, int* __restrict__ lvl,
    int* __restrict__ cursor, int* __restrict__ loff,
    int* __restrict__ nlev_out, int* __restrict__ slot_s,
    float* __restrict__ rec, float* __restrict__ acc_s,
    int* __restrict__ stats) {
  __shared__ int s_nlev, s_freed;
  __shared__ int s_warp[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int v = map.begin(table);
  // a free row's loads read the zero slot, its stores go to the sink
  const int zero = n_rows, sink = n_rows + 1;
  for (int b = tid; b < (kFree ? n_rows + 2 : n_rows); b += blockDim.x)
    last[b] = 0;
  if (kFree) {
    // a warp classifies 32 rows a step, one a lane, into one mask word
    for (int base = warp * 32; base < n_rows; base += blockDim.x) {
      const int b = base + lane;
      bool f = false;
      if (b < n_rows) {
        unsigned bits = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          bits |= __float_as_uint(body[8 * static_cast<size_t>(b) + c]);
        f = bits == 0u;
      }
      const unsigned m = __ballot_sync(kFull, f);
      if (lane == 0) free_mask[base >> 5] = m;
    }
  }
  __syncthreads();
  // a visit's load row for body-table row b
  const auto node = [&](int b) {
    return kFree && row_free(free_mask, b) ? zero : b;
  };

  // the recurrence, walked by lane 0 of warp 0 alone (so last[] has one
  // writer and one order): each chunk's 32 row pairs are loaded by the
  // warp while the chunk before is walked and shuffled to lane 0 before
  // the walk, so a step's chain is two shared loads, a max and two stores
  // (a free row's store slot, the sink, is chosen off the chain).  A whole
  // chunk is walked unrolled with no bound check on its steps, the last
  // chunk by a loop.
  if (warp == 0) {
    int maxl = 0, i = 0, j = 0, hint = 0, freed = 0;
    if (lane < v) {
      const Visit x = map.at(lane, hint);
      i = node(x.i);
      j = node(x.j);
    }
    for (int base = 0; base < v; base += 32) {
      int in = 0, jn = 0;
      if (base + 32 + lane < v) {
        const Visit x = map.at(base + 32 + lane, hint);
        in = node(x.i);
        jn = node(x.j);
      }
      if (kFree)
        freed += __popc(__ballot_sync(
            kFull, base + lane < v && (i == zero || j == zero)));
      int is[32], js[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        is[t] = __shfl_sync(kFull, i, t);
        js[t] = __shfl_sync(kFull, j, t);
      }
      if (lane == 0) {
        if (base + 32 <= v) {
#pragma unroll
          for (int t = 0; t < 32; ++t) {
            const int l = 1 + max(last[is[t]], last[js[t]]);
            last[kFree && is[t] == zero ? sink : is[t]] = l;
            last[kFree && js[t] == zero ? sink : js[t]] = l;
            lvl[base + t] = l;
            maxl = max(maxl, l);
          }
        } else {
          for (int t = 0; t < v - base; ++t) {
            const int l = 1 + max(last[is[t]], last[js[t]]);
            last[kFree && is[t] == zero ? sink : is[t]] = l;
            last[kFree && js[t] == zero ? sink : js[t]] = l;
            lvl[base + t] = l;
            maxl = max(maxl, l);
          }
        }
      }
      __syncwarp();
      i = in;
      j = jn;
    }
    if (lane == 0) {
      s_nlev = maxl;
      s_freed = freed;
    }
  }
  __syncthreads();
  const int n_levels = s_nlev;

  // bucket by level: count, exclusive prefix sum, scatter
  for (int l = tid; l < n_levels; l += blockDim.x) cursor[l] = 0;
  __syncthreads();
  for (int q = tid; q < v; q += blockDim.x) atomicAdd(&cursor[lvl[q] - 1], 1);
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < n_levels; base += blockDim.x) {
    const int l = base + tid;
    const int x = l < n_levels ? cursor[l] : 0;
    int y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += u;
    }
    if (lane == 31) s_warp[warp] = y;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += u;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp ? s_warp[warp - 1] : 0) + y - x;
    if (l < n_levels) {
      loff[l] = excl;
      cursor[l] = excl;
    }
    carry += s_warp[nwarps - 1];
    __syncthreads();
  }
  if (tid == 0) {
    loff[n_levels] = v;
    *nlev_out = n_levels;
    if (stats != nullptr) {
      stats[kStatLevels] = n_levels;
      stats[kStatVisits] = v;
      stats[kStatFreed] = kFree ? s_freed : 0;
      stats[kStatFallback] = 0;
    }
  }
  __syncthreads();
  int hint = 0;
  for (int q = tid; q < v; q += blockDim.x) {
    const Visit x = map.at(q, hint);
    const int pos = atomicAdd(&cursor[lvl[q] - 1], 1);
    const float* c = map.cols(x.k);
    const float* w = map.warm(x.k);
    const int fi = kFree && row_free(free_mask, x.i) ? kFreeFlag : 0;
    const int fj = kFree && row_free(free_mask, x.j) ? kFreeFlag : 0;
    float4* r = reinterpret_cast<float4*>(rec) + 5 * static_cast<size_t>(pos);
    r[0] = make_float4(c[0], c[1], c[2], c[3]);
    r[1] = make_float4(c[4], c[5], c[6], c[7]);
    r[2] = make_float4(c[8], c[9], c[10], c[11]);
    r[3] = make_float4(w[0], w[1], body[8 * x.i + 3], body[8 * x.i + 4]);
    r[4] = make_float4(body[8 * x.j + 3], body[8 * x.j + 4],
                       __int_as_float((x.joint ? (x.i | kJointFlag) : x.i) |
                                      fi),
                       __int_as_float(x.j | fj));
    reinterpret_cast<float4*>(acc_s)[pos] = make_float4(0.f, 0.f, 0.f, 0.f);
    slot_s[pos] = x.k;
  }
}

// The pre-pass as a kernel of its own (K1, K3, K5).  One block.  kFree:
// free rows are no nodes (the main path); else the full graph (the rerun).
// gate (may be null): the rerun's, which returns at once unless *gate is
// set, and otherwise first copies the table body back from body0, the
// solve's input.  Scratch (ints): lvl (R), cursor (R), loff (R + 1), nlev
// (1), slot_s (R), and last_g (n_rows + 2), the last-level array when it
// is not in shared memory (kLastSmem false); (floats): rec (R * 20), acc_s
// (R * 4).  stats (may be null): the counters.  Dynamic shared memory: the
// map's table, then last[] (kLastSmem), then the free rows' bitmask
// (kFree).
template <class Map, bool kLastSmem, bool kFree>
__global__ void __launch_bounds__(kPrepassThreads) visit_levels(
    Map map, float* __restrict__ body, const float* __restrict__ body0,
    int n_rows, const int* __restrict__ gate, int* __restrict__ lvl,
    int* __restrict__ cursor, int* __restrict__ loff,
    int* __restrict__ nlev_out, int* __restrict__ slot_s,
    float* __restrict__ rec, float* __restrict__ acc_s,
    int* __restrict__ last_g, int* __restrict__ stats) {
  if (gate != nullptr) {
    if (*gate == 0) return;
    for (int k = threadIdx.x; k < 8 * n_rows; k += blockDim.x)
      body[k] = body0[k];
  }
  extern __shared__ int dyn_sm[];
  int* last = kLastSmem ? dyn_sm + map.table_ints() : last_g;
  unsigned* free_mask = reinterpret_cast<unsigned*>(
      dyn_sm + map.table_ints() + (kLastSmem ? n_rows + 2 : 0));
  prepass<kFree>(map, body, n_rows, dyn_sm, last, free_mask, lvl, cursor,
                 loff, nlev_out, slot_s, rec, acc_s, stats);
}

// ---- the level solve ----

// A body as a visit of the level solve sees it: its three working columns
// (0-2 in the warm and velocity passes, 5-7 in the displacement passes) at
// v, in shared or device memory, and inv_mass, inv_inertia (columns 3, 4)
// in registers, from the record.  A free row (free) is read as +0.0
// without a load, and its writes are not stored: their bits are ORed into
// *bad, which stays 0 while every write is +0.0.
struct BodyCols {
  float* v;
  float im, ii;
  bool free;
  unsigned* bad;

  struct Col {
    BodyCols& b;
    int c;
    __device__ __forceinline__ operator float() const {
      if (c == 3 || c == 4) return c == 3 ? b.im : b.ii;
      return b.free ? 0.0f : b.v[c < 3 ? c : c - 5];
    }
    __device__ __forceinline__ Col& operator=(float x) {
      if (b.free)
        *b.bad |= __float_as_uint(x);
      else
        b.v[c < 3 ? c : c - 5] = x;
      return *this;
    }
  };
  __device__ __forceinline__ Col operator[](int c) { return Col{*this, c}; }
};

struct Item {
  float4 r[5];  // the record
  float4 a;     // the row's accumulators
};

__device__ __forceinline__ void load_item(Item& it, const float4* rec4,
                                          const float4* acc4, int pos) {
#pragma unroll
  for (int k = 0; k < 5; ++k) it.r[k] = rec4[5 * pos + k];
  it.a = acc4[pos];
}

// one visit of record pos; returns its residual term (0 for warm visits).
// kFree: the record's free flags are read (bad: see BodyCols); else no
// row is free (K2)
template <int kKind, bool kJoints, bool kSmem, bool kFree = false>
__device__ __forceinline__ float visit(const Item& it, float* cols,
                                       float* body, float4* acc4, int pos,
                                       unsigned* bad = nullptr) {
  const float c[12] = {it.r[0].x, it.r[0].y, it.r[0].z, it.r[0].w,
                       it.r[1].x, it.r[1].y, it.r[1].z, it.r[1].w,
                       it.r[2].x, it.r[2].y, it.r[2].z, it.r[2].w};
  const float w[2] = {it.r[3].x, it.r[3].y};
  float a[4] = {it.a.x, it.a.y, it.a.z, it.a.w};
  const int ib = __float_as_int(it.r[4].z), jb = __float_as_int(it.r[4].w);
  const bool joint = kJoints && ib < 0;
  const int i = ib & kRowBits, j = jb & kRowBits;
  const int base = kKind == kPos ? 5 : 0;
  BodyCols bi{kSmem ? cols + 3 * i : body + 8 * i + base, it.r[3].z,
              it.r[3].w, kFree && (ib & kFreeFlag) != 0, bad};
  BodyCols bj{kSmem ? cols + 3 * j : body + 8 * j + base, it.r[4].x,
              it.r[4].y, kFree && (jb & kFreeFlag) != 0, bad};
  float r = 0.0f;
  if (kKind == kWarm) {
    if (joint)
      joint_warm(bi, bj, c, w, a);
    else
      contact_warm(bi, bj, c, w, a);
  } else if (kKind == kVel) {
    r = joint ? joint_vel(bi, bj, c, a) : contact_vel(bi, bj, c, a);
  } else {
    r = joint ? joint_pos(bi, bj, c, a) : contact_pos(bi, bj, c, a);
  }
  acc4[pos] = make_float4(a[0], a[1], a[2], a[3]);
  return r;
}

// one pass: every level's records, a barrier after each level.  Record
// pos of a level belongs to thread (pos - level start) mod blockDim in
// every pass, so a thread's early load of a later record's accumulators
// reads what it wrote itself in the previous pass.  Each thread keeps its
// first record of the next kDepth levels in registers (a ring, each slot
// refilled right after its visit), so an L2 round trip (longer than a
// level) is covered by the levels between; a level wider than the block
// loads its further records at their visit.  Returns the thread's max_p of
// the visits' residual terms; ORs the bits of its writes to free rows into
// bad.
constexpr int kDepth = 3;

template <int kKind, bool kJoints, bool kSmem>
__device__ __forceinline__ float level_pass(float* cols, float* body,
                                            const float4* rec4, float4* acc4,
                                            const int* loff, int n_levels,
                                            unsigned& bad) {
  // loff: the level offsets, in shared memory where they fit
  const int t = threadIdx.x;
  float r = 0.0f;
  Item ring[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (d < n_levels && loff[d] + t < loff[d + 1])
      load_item(ring[d], rec4, acc4, loff[d] + t);
  for (int l0 = 0; l0 < n_levels; l0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int l = l0 + d;
      if (l < n_levels) {
        const int lo = loff[l], hi = loff[l + 1];
        if (lo + t < hi)
          r = max_p(r, visit<kKind, kJoints, kSmem, true>(
                           ring[d], cols, body, acc4, lo + t, &bad));
        for (int p = lo + t + blockDim.x; p < hi; p += blockDim.x) {
          Item it;
          load_item(it, rec4, acc4, p);
          r = max_p(r, visit<kKind, kJoints, kSmem, true>(
                           it, cols, body, acc4, p, &bad));
        }
        const int ln = l + kDepth;
        if (ln < n_levels && loff[ln] + t < loff[ln + 1])
          load_item(ring[d], rec4, acc4, loff[ln] + t);
        __syncthreads();
      }
    }
  }
  return r;
}

// max_p across the block, the same value in every thread
__device__ __forceinline__ float block_max(float r, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = max_p(r, __shfl_xor_sync(kFull, r, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = r;
  __syncthreads();
  float m = 0.0f;
  for (int w = 0; w < (blockDim.x >> 5); ++w) m = max_p(m, red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ void copy_cols(float* cols, float* body, int n,
                                          int base, bool to_smem) {
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (to_smem)
        cols[3 * b + c] = body[8 * b + base + c];
      else
        body[8 * b + base + c] = cols[3 * b + c];
    }
  }
}

// One block of kSolveThreads over a body table of n_rows rows.  Gates:
// from the second velocity pass on, a pass is skipped once
// the previous executed pass's residual is below tols[0]; displacement
// passes likewise with tols[1].  res_out gets the residual of the last
// executed velocity pass; the accumulators go back to their row slots in
// acc (zeroed by the caller).  A write to a free row that is not +0.0 sets
// *flag (may be null).  gate (may be null): the rerun's, which returns at
// once unless *gate is set.
//
// Dynamic shared memory (smem_bytes): the working columns (12 n_rows
// bytes, kSmem), then the level offsets where all n_levels + 1 fit the
// rest, so that a level's bounds cost a shared load, not an L2 round trip.
template <bool kJoints, bool kSmem>
__global__ void __launch_bounds__(kSolveThreads) level_solve(
    float* __restrict__ body, const float* __restrict__ rec,
    float* __restrict__ acc_s, const int* __restrict__ loff_g,
    const int* __restrict__ nlev_ptr, const int* __restrict__ slot_s,
    float* __restrict__ acc, const float* __restrict__ tols,
    float* __restrict__ res_out, int* __restrict__ flag,
    const int* __restrict__ gate, int n_rows, int vel_iters, int pos_iters,
    int smem_bytes) {
  if (gate != nullptr && *gate == 0) return;
  extern __shared__ float cols[];
  __shared__ float red[32];
  const int n_levels = *nlev_ptr;
  const float4* rec4 = reinterpret_cast<const float4*>(rec);
  float4* acc4 = reinterpret_cast<float4*>(acc_s);
  const float vtol = tols[0], ptol = tols[1];
  const int ncols = kSmem ? 3 * n_rows : 0;
  int* loff_s = reinterpret_cast<int*>(cols + ncols);
  const bool offs_in_smem = 4 * (ncols + n_levels + 1) <= smem_bytes;
  const int* loff = offs_in_smem ? loff_s : loff_g;
  if (offs_in_smem)
    for (int l = threadIdx.x; l <= n_levels; l += blockDim.x)
      loff_s[l] = loff_g[l];
  if (kSmem) copy_cols(cols, body, n_rows, 0, true);
  __syncthreads();
  unsigned bad = 0u;
  level_pass<kWarm, kJoints, kSmem>(cols, body, rec4, acc4, loff, n_levels,
                                    bad);
  float res = 0.0f;
  bool converged = false;
  for (int p = 0; p < vel_iters && !converged; ++p) {
    res = block_max(level_pass<kVel, kJoints, kSmem>(cols, body, rec4, acc4,
                                                     loff, n_levels, bad),
                    red);
    converged = res < vtol;
  }
  if (kSmem) {
    copy_cols(cols, body, n_rows, 0, false);
    if (pos_iters > 0) copy_cols(cols, body, n_rows, 5, true);
    __syncthreads();
  }
  converged = false;
  for (int p = 0; p < pos_iters && !converged; ++p) {
    const float pres = block_max(
        level_pass<kPos, kJoints, kSmem>(cols, body, rec4, acc4, loff,
                                         n_levels, bad),
        red);
    converged = pres < ptol;
  }
  if (kSmem && pos_iters > 0) copy_cols(cols, body, n_rows, 5, false);
  const int v = loff[n_levels];
  for (int pos = threadIdx.x; pos < v; pos += blockDim.x)
    reinterpret_cast<float4*>(acc)[slot_s[pos]] = acc4[pos];
  if (threadIdx.x == 0) *res_out = res;
  if (bad != 0u && flag != nullptr) *flag = 1;
}

// ---- launches ----

struct Scratch {
  int *lvl, *cursor, *loff, *nlev, *slot_s, *last_g;
  float *rec, *acc_s;
};

// ints: lvl (R), cursor (R), loff (R + 1), nlev (1), slot_s (R), last_g
// (n_rows + 2); floats: rec (R * 20), acc_s (R * 4)
inline Scratch carve(void* iscratch, void* fscratch, int r) {
  int* is = static_cast<int*>(iscratch);
  float* fs = static_cast<float*>(fscratch);
  return Scratch{is, is + r, is + 2 * r, is + 3 * r + 1, is + 3 * r + 2,
                 is + 4 * r + 2, fs, fs + 20 * static_cast<size_t>(r)};
}

// the pre-pass over map's visits of a table of n_rows rows; in_smem puts
// its last-level array in shared memory (the caller decides from n_rows).
// free: free rows are no nodes (the main path), else the full graph; the
// free rows' bitmask takes n_rows / 8 bytes of shared memory, beside the
// map's table (up to ~1.8 million rows; bench row E at 1024 envs has
// 280,576).
// gate, body0: the rerun's (visit_levels); stats: the counters (may be
// null)
template <class Map>
cudaError_t launch_levels(const Map& map, float* body, const float* body0,
                          int n_rows, bool in_smem, bool free,
                          const int* gate, int* stats, const Scratch& s,
                          cudaStream_t stream) {
  const auto kernel =
      free ? (in_smem ? visit_levels<Map, true, true>
                      : visit_levels<Map, false, true>)
           : (in_smem ? visit_levels<Map, true, false>
                      : visit_levels<Map, false, false>);
  const size_t smem =
      4 * (static_cast<size_t>(map.table_ints()) +
           (in_smem ? n_rows + 2 : 0) + (free ? (n_rows + 31) / 32 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<1, kPrepassThreads, smem, stream>>>(
      map, body, body0, n_rows, gate, s.lvl, s.cursor, s.loff, s.nlev,
      s.slot_s, s.rec, s.acc_s, s.last_g, stats);
  return cudaGetLastError();
}

template <bool kJoints, bool kSmem>
cudaError_t launch_solve_as(float* body, const Scratch& s, float* acc,
                            const float* tols, float* res, int* flag,
                            const int* gate, int n_rows, int vel_iters,
                            int pos_iters, cudaStream_t stream) {
  const auto kernel = level_solve<kJoints, kSmem>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSolveSmem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kSolveThreads, kSolveSmem, stream>>>(
      body, s.rec, s.acc_s, s.loff, s.nlev, s.slot_s, acc, tols, res, flag,
      gate, n_rows, vel_iters, pos_iters, kSolveSmem);
  return cudaGetLastError();
}

// the level solve after launch_levels; smem_cols puts the working columns
// in shared memory (the caller decides from n_rows: 12 n_rows bytes must
// fit kSolveSmem)
inline cudaError_t launch_solve(bool joints, bool smem_cols, float* body,
                                const Scratch& s, float* acc,
                                const float* tols, float* res, int* flag,
                                const int* gate, int n_rows, int vel_iters,
                                int pos_iters, cudaStream_t stream) {
  const auto launch =
      joints ? (smem_cols ? launch_solve_as<true, true>
                          : launch_solve_as<true, false>)
             : (smem_cols ? launch_solve_as<false, true>
                          : launch_solve_as<false, false>);
  return launch(body, s, acc, tols, res, flag, gate, n_rows, vel_iters,
                pos_iters, stream);
}

// The whole solve on body (n_rows * 8, in/out; body0 its input, left as
// it is): the pre-pass with free rows and the level solve, then the rerun
// over the full graph, whose two launches return at once unless the first
// solve set the fallback flag (stats[kStatFallback]).  stats: the
// counters (kStats ints).
template <class Map>
cudaError_t launch_whole(const Map& map, bool joints, float* body,
                         const float* body0, int n_rows, bool smem_last,
                         bool smem_cols, float* acc, const float* tols,
                         float* res, int* stats, int vel_iters,
                         int pos_iters, const Scratch& s,
                         cudaStream_t stream) {
  int* flag = stats + kStatFallback;
  cudaError_t err = launch_levels(map, body, body0, n_rows, smem_last, true,
                                  nullptr, stats, s, stream);
  if (err == cudaSuccess)
    err = launch_solve(joints, smem_cols, body, s, acc, tols, res, flag,
                       nullptr, n_rows, vel_iters, pos_iters, stream);
  if (err == cudaSuccess)
    err = launch_levels(map, body, body0, n_rows, smem_last, false, flag,
                        nullptr, s, stream);
  if (err == cudaSuccess)
    err = launch_solve(joints, smem_cols, body, s, acc, tols, res, nullptr,
                       flag, n_rows, vel_iters, pos_iters, stream);
  return err;
}

}  // namespace levels
}  // namespace phyx
