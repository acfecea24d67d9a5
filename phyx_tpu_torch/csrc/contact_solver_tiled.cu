// The two tiled serial solves on Hopper (sm_90a): K3, slab-major, and K5,
// routed, with joint rows.  Both walk solve_slabs (solve_slabs.cuh) with
// solve_rows.cuh's visits; they differ only in where a slab's slots lie.
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
// (counts[n_slabs + s], at most j_slots).  Joint segments are compiled away
// when there are no joint slots, as in K1.
//
// What the TPU kernels do that is not carried over: they copy one slab
// window (W rows) into SMEM, switch windows where a slab ends (K3 mid-block,
// switch_window, with a rewind to the first live slab at each pass wrap).
// On one body table in device memory all of that is the identity: window s
// is written back before window s+1 is read, and nothing else reads the
// table meanwhile, so visiting row s*stride + local in the table reads and
// writes exactly what the window copy would.  Their 1024-slot row blocks,
// double buffering, 16x unroll, K5's dead-block skip (here only live slots
// are walked) and buffer-set bookkeeping are not carried over either.
//
// What bounds them: one dependent chain of visits, 17 passes x the walked
// slots (K3 walks the slots of live pairs: SAT-dead slots inside them are
// visited as no-ops, zero masses and warm impulses), each a load of a row
// and two body rows, ~40 dependent float operations and a store the next
// visit may read.  So latency, not bytes.  The design is K1's, simple and
// right first: one thread, the table (1.6 MB at the 20k pile: 51,200 rows)
// in device memory, where it sits in the 50 MB L2 (it does not fit one
// block's 227 KB of shared memory, nor does one 18,432-row window), the slab
// segments read on the device so the wrapper never waits.

#include <cuda_runtime.h>

#include "solve_slabs.cuh"

namespace {

__device__ __forceinline__ int clamp_count(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// K3: slab s holds the slots [cum[s], cum[s+1]), clamped into [0, s_cap)
struct CumSlots {
  const int* cum;  // (n_slabs + 1) live-slot cumsum
  int s_cap;
  __device__ __forceinline__ phyx::SlabSlots operator()(int s) const {
    const int c0 = clamp_count(cum[s], 0, s_cap);
    return {c0, clamp_count(cum[s + 1], c0, s_cap), 0, 0};
  }
};

// K5: slab s's budgets, filled to its live contact and joint counts
struct BudgetSlots {
  const int* counts;  // (2*n_slabs) live contact, then joint rows per slab
  int n_slabs, c_slots, j_slots;
  __device__ __forceinline__ phyx::SlabSlots operator()(int s) const {
    const int c0 = s * (c_slots + j_slots);
    const int j0 = c0 + c_slots;
    return {c0, c0 + clamp_count(counts[s], 0, c_slots), j0,
            j0 + clamp_count(counts[n_slabs + s], 0, j_slots)};
  }
};

template <bool kJoints, class Segments>
__global__ void contact_solve_slabs(
    float* __restrict__ body,        // (npad*8) in/out
    const int* __restrict__ b12,     // (S*2) window-local rows
    const float* __restrict__ cw,    // (S*14)
    float* __restrict__ acc,         // (S*4) zeroed by the caller
    float* __restrict__ res_out,     // (1)
    const float* __restrict__ tols,  // (2) [velocity, position] thresholds
    int stride, int window, int n_slabs, Segments segs, int vel_iters,
    int pos_iters) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  phyx::solve_slabs<kJoints>(body, acc, b12, cw, stride, window, n_slabs,
                             segs, vel_iters, pos_iters, tols[0], tols[1],
                             res_out);
}

template <bool kJoints, class Segments>
int launch(void* body, const void* b12, const void* cw, void* acc, void* res,
           const void* tols, int stride, int window, int n_slabs,
           Segments segs, int vel_iters, int pos_iters, void* stream) {
  contact_solve_slabs<kJoints>
      <<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(body), static_cast<const int*>(b12),
          static_cast<const float*>(cw), static_cast<float*>(acc),
          static_cast<float*>(res), static_cast<const float*>(tols), stride,
          window, n_slabs, segs, vel_iters, pos_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes: each launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers.
extern "C" int phyx_contact_solve_tiled2(
    void* body, const void* b12, const void* cw, void* acc, void* res,
    const void* cum, const void* tols, int stride, int window, int n_slabs,
    int s_cap, int vel_iters, int pos_iters, void* stream) {
  return launch<false>(body, b12, cw, acc, res, tols, stride, window,
                       n_slabs, CumSlots{static_cast<const int*>(cum), s_cap},
                       vel_iters, pos_iters, stream);
}

extern "C" int phyx_contact_solve_tiled(
    void* body, const void* b12, const void* cw, void* acc, void* res,
    const void* counts, const void* tols, int stride, int window,
    int n_slabs, int c_slots, int j_slots, int vel_iters, int pos_iters,
    void* stream) {
  const BudgetSlots segs{static_cast<const int*>(counts), n_slabs, c_slots,
                         j_slots};
  return j_slots > 0
             ? launch<true>(body, b12, cw, acc, res, tols, stride, window,
                            n_slabs, segs, vel_iters, pos_iters, stream)
             : launch<false>(body, b12, cw, acc, res, tols, stride, window,
                             n_slabs, segs, vel_iters, pos_iters, stream);
}
