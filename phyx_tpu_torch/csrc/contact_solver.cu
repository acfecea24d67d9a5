// Fused serial sequential-impulse solve on Hopper (sm_90a), state in
// shared memory.
//
// Replaces the TPU kernel phyx_tpu/kernels/contact_solver.py,
// _solver_kernel (line 50), called through solve_contacts_fused.  It
// computes what that kernel computes, and what the streamed kernel
// (contact_solver_streamed.cu) computes: one warm-start pass, vel_iters
// velocity passes and pos_iters displacement passes, each visiting the
// contact rows [0, num) and then the joint rows [c_cap, c_cap + numj), with
// the runtime residual gates read from tols.  Both kernels run solve_rows
// (solve_rows.cuh), so they agree to the bit.
//
// What bounds it: one dependent chain of (1 + vel_iters + pos_iters) *
// (num + numj) visits, each a load of two body rows, ~40 dependent float
// operations and a store that the next visit may read.  So latency, not
// bytes: a 1000-link chain frame moves ~0.3 MB.
//
// What the design does about it: the read-modify-write state, the body
// table (N x 8 f32) and the accumulators (R x 4 f32), lives in one block's
// dynamic shared memory, where a dependent load takes ~30 cycles instead of
// the 200+ of L2.  The block's threads copy the body table in and zero the
// accumulators; one thread walks every visit in the reference's order; the
// threads copy both out.  The read-only rows (con, warm, ids) stay in device
// memory, where they sit in L2.  The state must fit 227 KB:
// 4 * (8 N + 4 R) bytes (fused_smem_bytes in
// phyx_tpu_torch/kernels/contact_solver.py, which picks this kernel or the
// streamed one).  Built with -fmad=false, as the streamed kernel is.

#include <cuda_runtime.h>

#include "solve_rows.cuh"

namespace {

constexpr int kThreads = 512;

// kJoints = false compiles the joint loops away, as in the streamed kernel.
template <bool kJoints>
__global__ void __launch_bounds__(kThreads) contact_solve_fused(
    const float* __restrict__ body_in,  // (N*8)
    float* __restrict__ body_out,       // (N*8)
    const int* __restrict__ b1,         // (R) body ids
    const int* __restrict__ b2,
    const float* __restrict__ con,      // (R*12)
    const float* __restrict__ warm,     // (R*2)
    float* __restrict__ acc_out,        // (R*4)
    float* __restrict__ res_out,        // (1)
    const int* __restrict__ num_ptr,    // () live contact rows
    const int* __restrict__ numj_ptr,   // () live joint rows, or null
    const float* __restrict__ tols,     // (2) [velocity, position]
    int n_cap, int c_cap, int j_cap, int vel_iters, int pos_iters) {
  extern __shared__ float smem[];
  float* body = smem;               // n_cap * 8
  float* acc = smem + 8 * n_cap;    // (c_cap + j_cap) * 4
  const int nb = 8 * n_cap;
  const int na = 4 * (c_cap + j_cap);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) body[i] = body_in[i];
  for (int i = threadIdx.x; i < na; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {
    int num = *num_ptr;
    num = num < 0 ? 0 : (num > c_cap ? c_cap : num);
    int numj = kJoints ? *numj_ptr : 0;
    numj = numj < 0 ? 0 : (numj > j_cap ? j_cap : numj);
    phyx::solve_rows(body, acc, b1, b2, con, warm, num, numj, c_cap, n_cap,
                     vel_iters, pos_iters, tols[0], tols[1], res_out);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) body_out[i] = body[i];
  for (int i = threadIdx.x; i < na; i += blockDim.x) acc_out[i] = acc[i];
}

}  // namespace

// Plain C entry for ctypes: raises the kernel's dynamic shared memory limit
// to what this call needs, launches on `stream` and returns the first CUDA
// error (0 = launched).  A launch refused for its shared memory never runs,
// and a later synchronize would not report it.  Pointers are device
// pointers; num_joints may be null (no joint rows).
extern "C" int phyx_contact_solve_fused(
    const void* body_in, void* body_out, const void* b1, const void* b2,
    const void* con, const void* warm, void* acc, void* res, const void* num,
    const void* num_joints, const void* tols, int n_cap, int c_cap,
    int j_cap, int vel_iters, int pos_iters, void* stream) {
  const size_t smem = sizeof(float) * (8 * static_cast<size_t>(n_cap) +
                                       4 * static_cast<size_t>(c_cap + j_cap));
  const auto kernel = num_joints ? contact_solve_fused<true>
                                 : contact_solve_fused<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(body_in), static_cast<float*>(body_out),
      static_cast<const int*>(b1), static_cast<const int*>(b2),
      static_cast<const float*>(con), static_cast<const float*>(warm),
      static_cast<float*>(acc), static_cast<float*>(res),
      static_cast<const int*>(num), static_cast<const int*>(num_joints),
      static_cast<const float*>(tols), n_cap, c_cap, j_cap, vel_iters,
      pos_iters);
  return static_cast<int>(cudaGetLastError());
}
