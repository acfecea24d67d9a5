// The two tiled solves on Hopper (sm_90a), run level by level over the
// visits' dependency graph on the embedded body table: K3, slab-major, and
// K5, routed, with joint rows.  Both use the level schedule of levels.cuh
// (K1's) with a slab visit map; they differ only in where a slab's slots
// lie.
//
// K3 replaces the TPU kernel phyx_tpu/kernels/contact_solver_tiled2.py,
// _tiled2_kernel (line 68), called through solve_contacts_tiled2.  Bodies
// are embedded in x-rank slab windows (solver.solve_pallas_tiled2), contact
// slots lie in slab-major order, and every pass (one warm start, vel_iters
// velocity passes, pos_iters displacement passes) visits the slots
// [0, cum[n_slabs]) in order, slot k with the body window of the slab s
// that holds it (cum[s] <= k < cum[s+1]).
//
// K5 replaces the TPU kernel phyx_tpu/kernels/contact_solver_tiled.py,
// _tiled_kernel (line 57), called through solve_contacts_tiled.  Rows are
// routed to per-slab slot budgets by solver.solve_pallas_tiled (slab s owns
// slots [s*(c_slots + j_slots), +c_slots) for contacts and the j_slots after
// them for joint rows), and every pass visits, slab by slab, the slab's live
// contact slots (counts[s], at most c_slots) and then its live joint slots
// (counts[n_slabs + s], at most j_slots).
//
// What the TPU kernels do that is not carried over: they copy one slab
// window (W rows) into SMEM, switch windows where a slab ends (K3 mid-block,
// switch_window, with a rewind to the first live slab at each pass wrap).
// On one body table all of that is the identity: window s is written back
// before window s+1 is read, and nothing else reads the table meanwhile, so
// visiting row s*stride + local in the table reads and writes exactly what
// the window copy would.  Windows overlap in the table itself (slab s's
// halo rows are slab s+1's first rows), so a visit's two rows,
// s*stride + clamp(local, window), are nodes of one graph over the table:
// the pre-pass keys its last-level array on the table row after the clamp,
// and visits of two slabs that share a halo row keep their serial order,
// while slabs with disjoint rows run side by side.  Their 1024-slot row
// blocks, double buffering, 16x unroll, K5's dead-block skip (here only
// live slots are walked) and buffer-set bookkeeping are not carried over
// either.
//
// What bounds them: the serial walk (the first design, one thread) was one
// dependent chain of 17 passes x the walked slots, each an id load, two
// body-row loads, ~40 dependent float operations and a store the next visit may
// read: ~380-455 ns a visit on an H100, so latency, not bytes.  Run level by
// level the chain is the levels (a pass's depth, not its visits) plus the
// serial pre-pass over the walked slots.  K3 walks the slots of live pairs: the
// SAT-dead slots inside them are visited as no-ops (zero masses and warm
// impulses) and stay visits, since a no-op can still flip the sign of a
// written zero.  Each slab's zero block (where statics at rest are remapped),
// the halo and the padding are free rows (levels.cuh): while every write to
// them is +0.0 they are no nodes, so a slab's contacts with the ground and
// the slope are not one chain through its zero row.  Placement (the wrapper
// decides from the table's rows as K1 does from its bodies,
// kernels/contact_solver_streamed.py placement): the
// last-level array (4 npad bytes) in shared memory up to 51,200 rows (the 20k
// pile's table), else in device memory; the working columns (12 npad bytes) in
// shared memory where they fit one block (small tables), else in device memory,
// where the table sits in the 50 MB L2.  Columns spread over a thread-block
// cluster's shared memory (4 blocks at 51,200 rows) ran each level 1.46 times
// slower than the device-memory columns on an H100 (k3_anatomy.py, PERF.md), so
// one block it is.

#include <cuda_runtime.h>

#include "levels.cuh"

namespace {

using phyx::levels::Scratch;
using phyx::levels::Visit;

__device__ __forceinline__ int clamp_count(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// one slab's slots: contact slots [c0, c1), then joint slots [j0, j1)
struct SlabSlots {
  int c0, c1, j0, j1;
};

// K3: slab s holds the slots [cum[s], cum[s+1]), clamped into [0, s_cap)
struct CumSlots {
  const int* cum;  // (n_slabs + 1) live-slot cumsum
  int s_cap;
  __device__ __forceinline__ SlabSlots operator()(int s) const {
    const int c0 = clamp_count(cum[s], 0, s_cap);
    return {c0, clamp_count(cum[s + 1], c0, s_cap), 0, 0};
  }
};

// K5: slab s's budgets, filled to its live contact and joint counts
struct BudgetSlots {
  const int* counts;  // (2*n_slabs) live contact, then joint rows per slab
  int n_slabs, c_slots, j_slots;
  __device__ __forceinline__ SlabSlots operator()(int s) const {
    const int c0 = s * (c_slots + j_slots);
    const int j0 = c0 + c_slots;
    return {c0, c0 + clamp_count(counts[s], 0, c_slots), j0,
            j0 + clamp_count(counts[n_slabs + s], 0, j_slots)};
  }
};

// The slab walk as a visit map (levels.cuh): for each slab s its contact
// slots, then its joint slots (Segments says which), a slot's rows at
// s*stride + its local rows clamped into [0, window).  Segment g = 2s
// (contacts) or 2s + 1 (joints); begin() lays out in shared memory each
// segment's first visit (off, 2 n_slabs + 1) and first slot (first,
// 2 n_slabs).  A segment never starts before the one before it ends (a
// running max), so no slot is visited twice in a pass: on a non-decreasing
// cum (a cumsum, as every caller makes) and on K5's budgets this is the
// serial walk's order exactly.
template <class Segments>
struct SlabMap {
  const int* b12;  // (S*2) window-local rows
  const float* cw;  // (S*14) row columns | warm impulses
  Segments segs;
  int n_slabs, stride, window;
  int* off;
  int* first;

  __host__ __device__ int table_ints() const { return 4 * n_slabs + 1; }
  __device__ __forceinline__ int begin(int* table) {
    off = table;
    first = table + 2 * n_slabs + 1;
    if (threadIdx.x == 0) {
      int total = 0, end = 0;
      for (int s = 0; s < n_slabs; ++s) {
        const SlabSlots g = segs(s);
        const int lo[2] = {g.c0, g.j0}, hi[2] = {g.c1, g.j1};
        for (int h = 0; h < 2; ++h) {
          const int a = max(lo[h], end), b = max(hi[h], a);
          off[2 * s + h] = total;
          first[2 * s + h] = a;
          total += b - a;
          end = b;
        }
      }
      off[2 * n_slabs] = total;
    }
    __syncthreads();
    return off[2 * n_slabs];
  }
  __device__ __forceinline__ Visit at(int q, int& g) const {
    while (q >= off[g + 1]) ++g;
    const int k = first[g] + (q - off[g]);
    const int base = (g >> 1) * stride;
    return {k, base + phyx::clamp_id(b12[2 * k], window),
            base + phyx::clamp_id(b12[2 * k + 1], window), (g & 1) != 0};
  }
  __device__ __forceinline__ const float* cols(int k) const {
    return cw + 14 * static_cast<size_t>(k);
  }
  __device__ __forceinline__ const float* warm(int k) const {
    return cw + 14 * static_cast<size_t>(k) + 12;
  }
};

template <class Segments>
SlabMap<Segments> slab_map(const void* b12, const void* cw, Segments segs,
                           int n_slabs, int stride, int window) {
  return SlabMap<Segments>{static_cast<const int*>(b12),
                           static_cast<const float*>(cw),
                           segs,
                           n_slabs,
                           stride,
                           window,
                           nullptr,
                           nullptr};
}

// the whole solve (levels.cuh launch_whole) on body (npad*8, in/out; body0
// its input), or (solve false) the pre-pass alone, free rows no nodes
template <class Segments>
int run(const SlabMap<Segments>& map, bool joints, void* body,
        const void* body0, void* acc, void* res, const void* tols,
        void* stats, int npad, int s_cap, int vel_iters, int pos_iters,
        void* iscratch, void* fscratch, int smem_last, int smem_cols,
        bool solve, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Scratch s = phyx::levels::carve(iscratch, fscratch, s_cap);
  if (!solve)
    return static_cast<int>(phyx::levels::launch_levels(
        map, static_cast<float*>(body), nullptr, npad, smem_last != 0, true,
        nullptr, static_cast<int*>(stats), s, st));
  return static_cast<int>(phyx::levels::launch_whole(
      map, joints, static_cast<float*>(body),
      static_cast<const float*>(body0), npad, smem_last != 0,
      smem_cols != 0, static_cast<float*>(acc),
      static_cast<const float*>(tols), static_cast<float*>(res),
      static_cast<int*>(stats), vel_iters, pos_iters, s, st));
}

}  // namespace

// Plain C entries for ctypes: each launches on `stream` and returns the
// first CUDA error (0 = launched).  Pointers are device pointers; npad is
// the table's rows, s_cap its slots; iscratch holds 4 s_cap + npad + 4 ints
// and fscratch 24 s_cap floats (levels.cuh carve); stats 4 ints, the
// call's counters (levels.cuh).  body0 is the solve's input table, left as
// it is (the rerun's copy).  smem_last puts the pre-pass's last-level array
// (4 npad bytes) in shared memory, smem_cols the level solve's working
// columns (12 npad bytes): the caller decides from npad what fits.  solve
// = 0 runs the pre-pass alone (for timing it, and for checking the
// levels).

extern "C" int phyx_contact_solve_tiled2(
    void* body, const void* body0, const void* b12, const void* cw,
    void* acc, void* res, const void* cum, const void* tols, void* stats,
    int stride, int window, int n_slabs, int s_cap, int vel_iters,
    int pos_iters, int npad, void* iscratch, void* fscratch, int smem_last,
    int smem_cols, int solve, void* stream) {
  return run(slab_map(b12, cw, CumSlots{static_cast<const int*>(cum), s_cap},
                      n_slabs, stride, window),
             false, body, body0, acc, res, tols, stats, npad, s_cap,
             vel_iters, pos_iters, iscratch, fscratch, smem_last, smem_cols,
             solve != 0, stream);
}

extern "C" int phyx_contact_solve_tiled(
    void* body, const void* body0, const void* b12, const void* cw,
    void* acc, void* res, const void* counts, const void* tols, void* stats,
    int stride, int window, int n_slabs, int c_slots, int j_slots,
    int vel_iters, int pos_iters, int npad, void* iscratch, void* fscratch,
    int smem_last, int smem_cols, int solve, void* stream) {
  const BudgetSlots segs{static_cast<const int*>(counts), n_slabs, c_slots,
                         j_slots};
  return run(slab_map(b12, cw, segs, n_slabs, stride, window), j_slots > 0,
             body, body0, acc, res, tols, stats, npad,
             n_slabs * (c_slots + j_slots), vel_iters, pos_iters, iscratch,
             fscratch, smem_last, smem_cols, solve != 0, stream);
}
