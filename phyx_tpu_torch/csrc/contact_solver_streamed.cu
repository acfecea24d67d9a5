// Serial sequential-impulse contact solve on Hopper (sm_90a).
//
// Replaces the TPU kernel phyx_tpu/kernels/contact_solver_streamed.py,
// _streamed_kernel (line 58), called through solve_contacts_streamed.  It
// computes what that kernel computes for contact rows: one warm-start pass,
// vel_iters velocity passes (coupled-tangent visit through c_nt) and
// pos_iters displacement passes over body columns 5-7, visiting rows
// [0, num) in order, with the runtime residual gates read from tols.
//
// What bounds it: the solve is one dependent chain of about
// (1 + vel_iters + pos_iters) * num visits.  Each visit reads a contact row
// and two body rows and writes both body rows back; the next visit may read
// what this one wrote.  So one thread walks every visit, and the time is
// latency (load -> arithmetic -> store), not bandwidth: the 16,384 x 8 f32
// body table of the 10k pile (512 KB) sits in the 50 MB L2.
//
// Design, simple and right first: one block, one working thread, the body
// table and accumulators in device memory, the live count read on the
// device (the wrapper never syncs).  The TPU kernel's 1024-slot DMA double
// buffering, 16x unroll and id*8 pre-scaling are not carried over.
// Built with -fmad=false so every multiply and add rounds separately in the
// written order, the order of the plain version in
// phyx_tpu_torch/kernels/contact_solver_streamed.py.
//
// Next steps (later work): keep the velocity columns (3 x 16,384 f32 =
// 192 KB) in one block's shared memory, and let the other lanes of the
// warp prefetch the contact rows and ids of the visits ahead.

#include <cuda_runtime.h>

namespace {

// NaN-propagating max / min with the tie rule of std::max / std::min, as
// torch.maximum / torch.minimum compute them.
__device__ __forceinline__ float max_p(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__device__ __forceinline__ float min_p(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ int clamp_id(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void contact_solve_streamed(
    float* __restrict__ body,        // (N*8) in/out
    const int* __restrict__ b1,      // (R) body ids
    const int* __restrict__ b2,
    const float* __restrict__ con,   // (R*12)
    const float* __restrict__ warm,  // (R*2)
    float* __restrict__ acc,         // (R*4) zeroed by the caller
    float* __restrict__ res_out,     // (1)
    const int* __restrict__ num_ptr, // () live rows
    const float* __restrict__ tols,  // (2) [velocity, position] thresholds
    int n_cap, int r_cap, int vel_iters, int pos_iters) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int num = *num_ptr;
  num = num < 0 ? 0 : (num > r_cap ? r_cap : num);
  const float vtol = tols[0];
  const float ptol = tols[1];

  // warm pass: re-apply the cached impulses
  for (int k = 0; k < num; ++k) {
    const float* c = con + 12 * k;
    const float nx = c[0], ny = c[1];
    const float wn = warm[2 * k], wt = warm[2 * k + 1];
    const float px = nx * wn - ny * wt;
    const float py = ny * wn + nx * wt;
    const float r1x = c[2], r1y = c[3], r2x = c[4], r2y = c[5];
    float* bi = body + 8 * clamp_id(b1[k], n_cap);
    float* bj = body + 8 * clamp_id(b2[k], n_cap);
    const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
    bi[0] = bi[0] - px * im1;
    bi[1] = bi[1] - py * im1;
    bi[2] = bi[2] - ii1 * (r1x * py - r1y * px);
    bj[0] = bj[0] + px * im2;
    bj[1] = bj[1] + py * im2;
    bj[2] = bj[2] + ii2 * (r2x * py - r2y * px);
    acc[4 * k] = wn;
    acc[4 * k + 1] = wt;
  }

  // velocity passes; the residual is the last executed pass's
  float res = 0.0f;
  bool converged = false;
  for (int p = 0; p < vel_iters && !converged; ++p) {
    res = 0.0f;
    for (int k = 0; k < num; ++k) {
      const float* c = con + 12 * k;
      const float nx = c[0], ny = c[1];
      const float r1x = c[2], r1y = c[3], r2x = c[4], r2y = c[5];
      const float mn = c[6], mt = c[7], fr = c[8], dstv = c[9], ctn = c[11];
      float* bi = body + 8 * clamp_id(b1[k], n_cap);
      float* bj = body + 8 * clamp_id(b2[k], n_cap);
      const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
      const float vx1 = bi[0], vy1 = bi[1], w1 = bi[2];
      const float vx2 = bj[0], vy2 = bj[1], w2 = bj[2];
      const float dvx = vx2 - w2 * r2y - vx1 + w1 * r1y;
      const float dvy = vy2 + w2 * r2x - vy1 - w1 * r1x;
      const float vn = nx * dvx + ny * dvy;
      const float vt = -ny * dvx + nx * dvy;
      float d = (dstv - vn) * mn;
      float a = acc[4 * k];
      const float na = max_p(a + d, 0.0f);
      const float dn = na - a;
      acc[4 * k] = na;
      d = -(vt + ctn * dn) * mt;
      a = acc[4 * k + 1];
      const float mf = fr * na;
      const float ta = min_p(max_p(a + d, -mf), mf);
      const float dt = ta - a;
      acc[4 * k + 1] = ta;
      const float px = nx * dn - ny * dt;
      const float py = ny * dn + nx * dt;
      bi[0] = vx1 - px * im1;
      bi[1] = vy1 - py * im1;
      bi[2] = w1 - ii1 * (r1x * py - r1y * px);
      bj[0] = vx2 + px * im2;
      bj[1] = vy2 + py * im2;
      bj[2] = w2 + ii2 * (r2x * py - r2y * px);
      res = max_p(res, max_p(fabsf(dn), fabsf(dt)));
    }
    converged = res < vtol;
  }

  // displacement passes on the pseudo-velocity columns 5-7
  converged = false;
  for (int p = 0; p < pos_iters && !converged; ++p) {
    float pres = 0.0f;
    for (int k = 0; k < num; ++k) {
      const float* c = con + 12 * k;
      const float nx = c[0], ny = c[1];
      const float r1x = c[2], r1y = c[3], r2x = c[4], r2y = c[5];
      const float mn = c[6], ddv = c[10];
      float* bi = body + 8 * clamp_id(b1[k], n_cap);
      float* bj = body + 8 * clamp_id(b2[k], n_cap);
      const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
      const float px1 = bi[5], py1 = bi[6], q1 = bi[7];
      const float px2 = bj[5], py2 = bj[6], q2 = bj[7];
      const float dvx = px2 - q2 * r2y - px1 + q1 * r1y;
      const float dvy = py2 + q2 * r2x - py1 - q1 * r1x;
      const float vn = nx * dvx + ny * dvy;
      float d = (ddv - vn) * mn;
      const float a = acc[4 * k + 2];
      const float na = max_p(a + d, 0.0f);
      d = na - a;
      acc[4 * k + 2] = na;
      const float ix = nx * d;
      const float iy = ny * d;
      bi[5] = px1 - ix * im1;
      bi[6] = py1 - iy * im1;
      bi[7] = q1 - ii1 * (r1x * iy - r1y * ix);
      bj[5] = px2 + ix * im2;
      bj[6] = py2 + iy * im2;
      bj[7] = q2 + ii2 * (r2x * iy - r2y * ix);
      pres = max_p(pres, fabsf(d));
    }
    converged = pres < ptol;
  }
  *res_out = res;
}

}  // namespace

// Plain C entry for ctypes: launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers.
extern "C" int phyx_contact_solve_streamed(
    void* body, const void* b1, const void* b2, const void* con,
    const void* warm, void* acc, void* res, const void* num,
    const void* tols, int n_cap, int r_cap, int vel_iters, int pos_iters,
    void* stream) {
  contact_solve_streamed<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(body), static_cast<const int*>(b1),
      static_cast<const int*>(b2), static_cast<const float*>(con),
      static_cast<const float*>(warm), static_cast<float*>(acc),
      static_cast<float*>(res), static_cast<const int*>(num),
      static_cast<const float*>(tols), n_cap, r_cap, vel_iters, pos_iters);
  return static_cast<int>(cudaGetLastError());
}
