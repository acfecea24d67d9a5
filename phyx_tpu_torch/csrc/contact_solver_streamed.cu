// Serial sequential-impulse solve on Hopper (sm_90a), state in device memory.
//
// Replaces the TPU kernel phyx_tpu/kernels/contact_solver_streamed.py,
// _streamed_kernel (line 58), called through solve_contacts_streamed.  It
// computes what that kernel computes: one warm-start pass, vel_iters
// velocity passes (coupled-tangent contact visit through c_nt) and
// pos_iters displacement passes over body columns 5-7, each visiting the
// contact rows [0, num) and then the joint rows [c_cap, c_cap + numj), with
// the runtime residual gates read from tols.  The visits are solve_rows in
// solve_rows.cuh, shared with the fused kernel (contact_solver.cu).
//
// What bounds it: the solve is one dependent chain of about
// (1 + vel_iters + pos_iters) * (num + numj) visits.  Each visit reads a row
// and two body rows and writes both body rows back; the next visit may read
// what this one wrote.  So one thread walks every visit, and the time is
// latency (load -> arithmetic -> store), not bandwidth.
//
// Design, simple and right first: one block, one working thread, the body
// table and accumulators in device memory (the 16,384 x 8 f32 body table of
// the 10k pile, 512 KB, sits in the 50 MB L2; it does not fit one block's
// 227 KB of shared memory, which is why this kernel exists beside the fused
// one), the live counts read on the device (the wrapper never syncs).  The
// TPU kernel's 1024-slot DMA double buffering, 16x unroll and id*8
// pre-scaling are not carried over.
//
// Next steps (later work): keep the velocity columns (3 x 16,384 f32 =
// 192 KB) in one block's shared memory, and let the other lanes of the warp
// prefetch the rows and ids of the visits ahead.

#include <cuda_runtime.h>

#include "solve_rows.cuh"

namespace {

// kJoints = false compiles the joint loops away: with them present, the
// contact visits of a jointless solve ran ~1% slower on an H100 (the 10k
// pile frame), though their arithmetic is the same.
template <bool kJoints>
__global__ void contact_solve_streamed(
    float* __restrict__ body,          // (N*8) in/out
    const int* __restrict__ b1,        // (R) body ids
    const int* __restrict__ b2,
    const float* __restrict__ con,     // (R*12)
    const float* __restrict__ warm,    // (R*2)
    float* __restrict__ acc,           // (R*4) zeroed by the caller
    float* __restrict__ res_out,       // (1)
    const int* __restrict__ num_ptr,   // () live contact rows
    const int* __restrict__ numj_ptr,  // () live joint rows, or null
    const float* __restrict__ tols,    // (2) [velocity, position] thresholds
    int n_cap, int c_cap, int j_cap, int vel_iters, int pos_iters) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int num = *num_ptr;
  num = num < 0 ? 0 : (num > c_cap ? c_cap : num);
  int numj = kJoints ? *numj_ptr : 0;
  numj = numj < 0 ? 0 : (numj > j_cap ? j_cap : numj);
  phyx::solve_rows(body, acc, b1, b2, con, warm, num, numj, c_cap, n_cap,
                   vel_iters, pos_iters, tols[0], tols[1], res_out);
}

}  // namespace

// Plain C entry for ctypes: launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers; num_joints
// may be null (no joint rows).
extern "C" int phyx_contact_solve_streamed(
    void* body, const void* b1, const void* b2, const void* con,
    const void* warm, void* acc, void* res, const void* num,
    const void* num_joints, const void* tols, int n_cap, int c_cap,
    int j_cap, int vel_iters, int pos_iters, void* stream) {
  const auto kernel = num_joints ? contact_solve_streamed<true>
                                 : contact_solve_streamed<false>;
  kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(body), static_cast<const int*>(b1),
      static_cast<const int*>(b2), static_cast<const float*>(con),
      static_cast<const float*>(warm), static_cast<float*>(acc),
      static_cast<float*>(res), static_cast<const int*>(num),
      static_cast<const int*>(num_joints), static_cast<const float*>(tols),
      n_cap, c_cap, j_cap, vel_iters, pos_iters);
  return static_cast<int>(cudaGetLastError());
}
