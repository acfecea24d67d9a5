// The visits of every solve kernel.  The fused kernel contact_solver.cu, the
// streamed kernel contact_solver_streamed.cu and the tiled kernels
// contact_solver_tiled.cu run them level by level (levels.cuh); every kernel
// does each visit's arithmetic here, so the fused and streamed kernels agree
// to the bit by construction.  Built with -fmad=false: every multiply and add
// rounds separately, in the order written here, which is the order of the
// plain version (phyx_tpu_torch/kernels/contact_solver_streamed.py).
//
// Layout (flat): body rows (N*8) [vx, vy, w, inv_mass, inv_inertia, dvx,
// dvy, dw]; plain body ids b1/b2 (R); rows con (R*12) and warm (R*2);
// accumulators acc (R*4), all zero on entry.  Contact rows [0, num) are
// [nx, ny, r1x, r1y, r2x, r2y, mass_n, mass_t, friction, dst_v, dst_dv,
// c_nt]; joint rows [c_cap, c_cap + numj) use the encodings of
// phyx_tpu_torch/joints.py (kind in slot 11).  Each pass visits the contact
// rows, then the joint rows.
//
// The visits are templates on the body type B: bi[c] reads or writes column c
// of a body.  The level solves of levels.cuh and contact_solver.cu pass a view
// whose working columns sit in shared or device memory.  The arithmetic, and
// its order, is the same for every B.

#pragma once

#include <cuda_runtime.h>

namespace phyx {

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

// ---- contact rows ----

template <class B>
__device__ __forceinline__ void contact_warm(B bi, B bj,
                                             const float* c, const float* w,
                                             float* a) {
  const float nx = c[0], ny = c[1];
  const float wn = w[0], wt = w[1];
  const float px = nx * wn - ny * wt;
  const float py = ny * wn + nx * wt;
  const float r1x = c[2], r1y = c[3], r2x = c[4], r2y = c[5];
  const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
  bi[0] = bi[0] - px * im1;
  bi[1] = bi[1] - py * im1;
  bi[2] = bi[2] - ii1 * (r1x * py - r1y * px);
  bj[0] = bj[0] + px * im2;
  bj[1] = bj[1] + py * im2;
  bj[2] = bj[2] + ii2 * (r2x * py - r2y * px);
  a[0] = wn;
  a[1] = wt;
}

// coupled-tangent velocity visit; returns max(|dn|, |dt|)
template <class B>
__device__ __forceinline__ float contact_vel(B bi, B bj,
                                             const float* c, float* a) {
  const float nx = c[0], ny = c[1];
  const float r1x = c[2], r1y = c[3], r2x = c[4], r2y = c[5];
  const float mn = c[6], mt = c[7], fr = c[8], dstv = c[9], ctn = c[11];
  const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
  const float vx1 = bi[0], vy1 = bi[1], w1 = bi[2];
  const float vx2 = bj[0], vy2 = bj[1], w2 = bj[2];
  const float dvx = vx2 - w2 * r2y - vx1 + w1 * r1y;
  const float dvy = vy2 + w2 * r2x - vy1 - w1 * r1x;
  const float vn = nx * dvx + ny * dvy;
  const float vt = -ny * dvx + nx * dvy;
  float d = (dstv - vn) * mn;
  float acc = a[0];
  const float na = max_p(acc + d, 0.0f);
  const float dn = na - acc;
  a[0] = na;
  d = -(vt + ctn * dn) * mt;
  acc = a[1];
  const float mf = fr * na;
  const float ta = min_p(max_p(acc + d, -mf), mf);
  const float dt = ta - acc;
  a[1] = ta;
  const float px = nx * dn - ny * dt;
  const float py = ny * dn + nx * dt;
  bi[0] = vx1 - px * im1;
  bi[1] = vy1 - py * im1;
  bi[2] = w1 - ii1 * (r1x * py - r1y * px);
  bj[0] = vx2 + px * im2;
  bj[1] = vy2 + py * im2;
  bj[2] = w2 + ii2 * (r2x * py - r2y * px);
  return max_p(fabsf(dn), fabsf(dt));
}

// displacement visit on the pseudo-velocity columns 5-7; returns |d|
template <class B>
__device__ __forceinline__ float contact_pos(B bi, B bj,
                                             const float* c, float* a) {
  const float nx = c[0], ny = c[1];
  const float r1x = c[2], r1y = c[3], r2x = c[4], r2y = c[5];
  const float mn = c[6], ddv = c[10];
  const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
  const float px1 = bi[5], py1 = bi[6], q1 = bi[7];
  const float px2 = bj[5], py2 = bj[6], q2 = bj[7];
  const float dvx = px2 - q2 * r2y - px1 + q1 * r1y;
  const float dvy = py2 + q2 * r2x - py1 - q1 * r1x;
  const float vn = nx * dvx + ny * dvy;
  float d = (ddv - vn) * mn;
  const float acc = a[2];
  const float na = max_p(acc + d, 0.0f);
  d = na - acc;
  a[2] = na;
  const float ix = nx * d;
  const float iy = ny * d;
  bi[5] = px1 - ix * im1;
  bi[6] = py1 - iy * im1;
  bi[7] = q1 - ii1 * (r1x * iy - r1y * ix);
  bj[5] = px2 + ix * im2;
  bj[6] = py2 + iy * im2;
  bj[7] = q2 + ii2 * (r2x * iy - r2y * ix);
  return fabsf(d);
}

// ---- joint rows: revolute (kind 1) or distance (kind 2) ----

struct JointArms {
  bool rev;
  float r1x, r1y, r2x, r2y;
};

// selects, not an index computed at run time: c may be an array in
// registers
__device__ __forceinline__ JointArms joint_arms(const float* c) {
  JointArms g;
  g.rev = c[11] == 1.0f;
  g.r1x = g.rev ? c[0] : c[2];
  g.r1y = g.rev ? c[1] : c[3];
  g.r2x = g.rev ? c[2] : c[4];
  g.r2y = g.rev ? c[3] : c[5];
  return g;
}

// apply the impulse (px, py) to columns off..off+2; every body value is
// read afresh, as the reference kernels read it
template <class B>
__device__ __forceinline__ void joint_apply(B bi, B bj,
                                            const JointArms& g, float px,
                                            float py, int off) {
  const float im1 = bi[3], ii1 = bi[4], im2 = bj[3], ii2 = bj[4];
  bi[off] = bi[off] - px * im1;
  bi[off + 1] = bi[off + 1] - py * im1;
  bi[off + 2] = bi[off + 2] - ii1 * (g.r1x * py - g.r1y * px);
  bj[off] = bj[off] + px * im2;
  bj[off + 1] = bj[off + 1] + py * im2;
  bj[off + 2] = bj[off + 2] + ii2 * (g.r2x * py - g.r2y * px);
}

template <class B>
__device__ __forceinline__ void joint_warm(B bi, B bj,
                                           const float* c, const float* w,
                                           float* a) {
  const JointArms g = joint_arms(c);
  const float wx = w[0], wy = w[1];
  float px, py;
  if (g.rev) {
    px = wx;
    py = wy;
  } else {
    px = c[0] * wx;
    py = c[1] * wx;
  }
  joint_apply(bi, bj, g, px, py, 0);
  a[0] = wx;
  a[1] = g.rev ? wy : 0.0f;
}

// revolute impulse -(M dv); distance impulse -m (n.dv) n; returns
// max(|px|, |py|)
template <class B>
__device__ __forceinline__ float joint_vel(B bi, B bj,
                                           const float* c, float* a) {
  const JointArms g = joint_arms(c);
  const float vx1 = bi[0], vy1 = bi[1], w1 = bi[2];
  const float vx2 = bj[0], vy2 = bj[1], w2 = bj[2];
  const float dvx = vx2 - w2 * g.r2y - vx1 + w1 * g.r1y;
  const float dvy = vy2 + w2 * g.r2x - vy1 - w1 * g.r1x;
  float px, py;
  if (g.rev) {
    px = -(c[4] * dvx + c[5] * dvy);
    py = -(c[5] * dvx + c[6] * dvy);
    a[0] = a[0] + px;
    a[1] = a[1] + py;
  } else {
    const float nx = c[0], ny = c[1];
    const float dd = -c[6] * (nx * dvx + ny * dvy);
    px = nx * dd;
    py = ny * dd;
    a[0] = a[0] + dd;
    a[1] = a[1] + 0.0f;
  }
  joint_apply(bi, bj, g, px, py, 0);
  return max_p(fabsf(px), fabsf(py));
}

// displacement visit toward the row's target; returns max(|px|, |py|)
template <class B>
__device__ __forceinline__ float joint_pos(B bi, B bj,
                                           const float* c, float* a) {
  const JointArms g = joint_arms(c);
  const float px1 = bi[5], py1 = bi[6], q1 = bi[7];
  const float px2 = bj[5], py2 = bj[6], q2 = bj[7];
  const float dvx = px2 - q2 * g.r2y - px1 + q1 * g.r1y;
  const float dvy = py2 + q2 * g.r2x - py1 - q1 * g.r1x;
  float px, py;
  if (g.rev) {
    const float ex = c[7] - dvx;
    const float ey = c[8] - dvy;
    px = c[4] * ex + c[5] * ey;
    py = c[5] * ex + c[6] * ey;
    a[2] = a[2] + px;
    a[3] = a[3] + py;
  } else {
    const float nx = c[0], ny = c[1];
    const float dd = c[6] * (c[7] - (nx * dvx + ny * dvy));
    px = nx * dd;
    py = ny * dd;
    a[2] = a[2] + dd;
    a[3] = a[3] + 0.0f;
  }
  joint_apply(bi, bj, g, px, py, 5);
  return max_p(fabsf(px), fabsf(py));
}

}  // namespace phyx
