// Sequential-impulse solve on Hopper (sm_90a), run level by level over the
// visits' dependency graph, state in device memory.
//
// Replaces the TPU kernel phyx_tpu/kernels/contact_solver_streamed.py,
// _streamed_kernel (line 58), called through solve_contacts_streamed.  It
// computes what that kernel computes, and what the serial walk of its plain
// version computes, to the bit: one warm-start pass, vel_iters
// velocity passes (coupled-tangent contact visit through c_nt) and
// pos_iters displacement passes over body columns 5-7, each visiting the
// contact rows [0, num) and then the joint rows [c_cap, c_cap + numj), with
// the runtime residual gates read from tols.
//
// What bounded it: the serial walk is one dependent chain of
// (1 + vel_iters + pos_iters) * (num + numj) visits, each an id load, a
// body-row load that depends on it, ~40 dependent float operations and a
// store the next visit may read: ~350 ns a visit on one thread of the card
// (the 10k pile frame: 222 ms a solve).
//
// What the levels change: the same visits run level by level over their
// dependency graph (levels.cuh, shared with the tiled kernels K3 and K5 of
// contact_solver_tiled.cu): a pre-pass levels the live visits and buckets
// them into records, then one block runs each pass level by level.  The
// visit map (RowsMap, levels.cuh, shared with K2) walks the contact rows
// [0, num), then the joint rows [c_cap, c_cap + numj), the ids clamped
// into [0, N) as the plain version clamps them.  The pile's ground, a
// static at rest, is a free row (levels.cuh): its contacts order nothing.
// Measured depth (chip_smoke.py on an H100), every row a node: the settled
// 10k pile frame has 1,160 levels a pass for 39,280 visits, the 64-env
// frame 123 for 50,745 (its envs run side by side).

#include <cuda_runtime.h>

#include "levels.cuh"

namespace {

using phyx::levels::RowsMap;
using phyx::levels::Scratch;

RowsMap rows_map(const void* b1, const void* b2, const void* con,
                 const void* warm, const void* num, const void* num_joints,
                 int n_cap, int c_cap, int j_cap) {
  return RowsMap{static_cast<const int*>(b1),
                 static_cast<const int*>(b2),
                 static_cast<const float*>(con),
                 static_cast<const float*>(warm),
                 static_cast<const int*>(num),
                 static_cast<const int*>(num_joints),
                 n_cap, c_cap, j_cap, 0};
}

}  // namespace

// Plain C entries for ctypes: each launches on `stream` and returns the
// first CUDA error (0 = launched).  Pointers are device pointers;
// num_joints may be null (no joint rows); iscratch holds 4 R + N + 4 ints
// and fscratch 24 R floats (carve); stats 4 ints, the call's counters
// (levels.cuh: levels a pass, visits, visits with a free endpoint,
// fallback fired).  smem_last puts the pre-pass's last-level array
// (4 N bytes) in shared memory, smem_cols the level solve's working
// columns (12 N bytes): the caller decides from N what fits.

// The pre-pass alone, free rows no nodes (for timing it, and for checking
// the levels).
extern "C" int phyx_visit_levels(const void* b1, const void* b2,
                                 const void* con, const void* warm,
                                 const void* body, const void* num,
                                 const void* num_joints, void* stats,
                                 int n_cap, int c_cap, int j_cap,
                                 void* iscratch, void* fscratch,
                                 int smem_last, void* stream) {
  const Scratch s = phyx::levels::carve(iscratch, fscratch, c_cap + j_cap);
  return static_cast<int>(phyx::levels::launch_levels(
      rows_map(b1, b2, con, warm, num, num_joints, n_cap, c_cap, j_cap),
      const_cast<float*>(static_cast<const float*>(body)), nullptr, n_cap,
      smem_last != 0, true, nullptr, static_cast<int*>(stats), s,
      static_cast<cudaStream_t>(stream)));
}

// The whole solve (levels.cuh launch_whole) on body (N*8, in/out), whose
// input body0 is left as it is (the rerun's copy).
extern "C" int phyx_contact_solve_streamed(
    void* body, const void* body0, const void* b1, const void* b2,
    const void* con, const void* warm, void* acc, void* res, const void* num,
    const void* num_joints, const void* tols, void* stats, int n_cap,
    int c_cap, int j_cap, int vel_iters, int pos_iters, void* iscratch,
    void* fscratch, int smem_last, int smem_cols, void* stream) {
  const Scratch s = phyx::levels::carve(iscratch, fscratch, c_cap + j_cap);
  return static_cast<int>(phyx::levels::launch_whole(
      rows_map(b1, b2, con, warm, num, num_joints, n_cap, c_cap, j_cap),
      num_joints != nullptr, static_cast<float*>(body),
      static_cast<const float*>(body0), n_cap, smem_last != 0,
      smem_cols != 0, static_cast<float*>(acc),
      static_cast<const float*>(tols), static_cast<float*>(res),
      static_cast<int*>(stats), vel_iters, pos_iters, s,
      static_cast<cudaStream_t>(stream)));
}
