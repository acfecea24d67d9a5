// The slab-ordered serial solve shared by the two tiled kernels of
// contact_solver_tiled.cu: K3 (slab-major contact slots) and K5 (per-slab
// contact and joint budgets).  The
// visits are those of solve_rows.cuh, unchanged; what differs from
// solve_rows is the order of the walk and where a row finds its bodies.
//
// Layout (flat): the embedded body table (npad*8) [vx, vy, w, inv_mass,
// inv_inertia, dvx, dvy, dw] in slab windows (window s = rows [s*stride,
// s*stride + window)); per slot, b12 (2) int32 body rows local to the
// slot's slab window, cw (14) f32 [12 row columns | 2 warm impulses], acc
// (4) f32, zero on entry.  Built with -fmad=false, as solve_rows.
//
// The walk: every pass visits slab 0, 1, ..., and in slab s its contact
// slots, then its joint slots (Segments says which).  A row's bodies are
// at s*stride + local, with local clamped into [0, window).

#pragma once

#include <cuda_runtime.h>

#include "solve_rows.cuh"

namespace phyx {

// one slab's slots: contact slots [c0, c1), then joint slots [j0, j1)
struct SlabSlots {
  int c0, c1, j0, j1;
};

// Segments: a callable int -> SlabSlots.  kJoints = false compiles the joint
// segments away.  Gates and residual as in solve_rows: from the second
// velocity pass on, a pass is skipped once the previous executed pass's
// residual is below vtol (displacement passes: ptol); res_out gets the
// residual of the last executed velocity pass.
template <bool kJoints, class Segments>
__device__ __forceinline__ void solve_slabs(
    float* body, float* acc, const int* b12, const float* cw, int stride,
    int window, int n_slabs, const Segments& segs, int vel_iters,
    int pos_iters, float vtol, float ptol, float* res_out) {
#define PHYX_SLOT(k)                                                  \
  float* bi = body + 8 * (base + clamp_id(b12[2 * (k)], window));     \
  float* bj = body + 8 * (base + clamp_id(b12[2 * (k) + 1], window)); \
  const float* c = cw + 14 * (k);                                     \
  float* a = acc + 4 * (k);

  for (int s = 0; s < n_slabs; ++s) {
    const SlabSlots g = segs(s);
    const int base = s * stride;
    for (int k = g.c0; k < g.c1; ++k) {
      PHYX_SLOT(k)
      contact_warm(bi, bj, c, c + 12, a);
    }
    if constexpr (kJoints) {
      for (int k = g.j0; k < g.j1; ++k) {
        PHYX_SLOT(k)
        joint_warm(bi, bj, c, c + 12, a);
      }
    }
  }

  float res = 0.0f;
  bool converged = false;
  for (int p = 0; p < vel_iters && !converged; ++p) {
    res = 0.0f;
    for (int s = 0; s < n_slabs; ++s) {
      const SlabSlots g = segs(s);
      const int base = s * stride;
      for (int k = g.c0; k < g.c1; ++k) {
        PHYX_SLOT(k)
        res = max_p(res, contact_vel(bi, bj, c, a));
      }
      if constexpr (kJoints) {
        for (int k = g.j0; k < g.j1; ++k) {
          PHYX_SLOT(k)
          res = max_p(res, joint_vel(bi, bj, c, a));
        }
      }
    }
    converged = res < vtol;
  }

  converged = false;
  for (int p = 0; p < pos_iters && !converged; ++p) {
    float pres = 0.0f;
    for (int s = 0; s < n_slabs; ++s) {
      const SlabSlots g = segs(s);
      const int base = s * stride;
      for (int k = g.c0; k < g.c1; ++k) {
        PHYX_SLOT(k)
        pres = max_p(pres, contact_pos(bi, bj, c, a));
      }
      if constexpr (kJoints) {
        for (int k = g.j0; k < g.j1; ++k) {
          PHYX_SLOT(k)
          pres = max_p(pres, joint_pos(bi, bj, c, a));
        }
      }
    }
    converged = pres < ptol;
  }
#undef PHYX_SLOT
  *res_out = res;
}

}  // namespace phyx
