"""The least time the card could take for a frame's contact solve, from
what the frame's inputs need.

The solve kernels K1 (``csrc/contact_solver_streamed.cu``) and K3
(``csrc/contact_solver_tiled.cu``) compute the same serial solve: one warm
pass, ``vel_iters`` velocity passes and ``pos_iters`` displacement passes
over the frame's live contact points.  Whatever walks or pads the kernel
does, the frame needs:

* bytes: each live body's row (8 float32: velocity, spin, inverse mass and
  inertia, pseudo-velocity) read once and written once; each live contact
  point's row (12 float32), warm impulses (2 float32) and body ids (2
  int32) read once, and its accumulators (4 float32) written once; the
  residual (one float32) written once;
* float operations: each live point's visits, ``OPS`` a visit of each
  kind (the arithmetic of one visit: contact warm start, velocity and
  displacement, as the serial solve writes it).

The bound is the larger of bytes over the card's memory rate and
operations over its float32 rate; a kernel's roofline share is the bound
over the kernel's device time a frame.
"""

from __future__ import annotations

from benchmark.trace import solve_kernel_us

# NVIDIA H100 SXM data sheet, at its 700 W power limit: HBM3 bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s f32"

# float operations of one visit: contact warm start, velocity (normal and
# friction limiters, both bodies' updates, the residual's max) and
# displacement
OPS = dict(warm=24, velocity=59, displacement=40)
BODY_ROW_BYTES = 8 * 4
POINT_IN_BYTES = 12 * 4 + 2 * 4 + 2 * 4
POINT_OUT_BYTES = 4 * 4


def solve_bound(live_bodies: int, live_points: int, vel_iters: int,
                pos_iters: int) -> dict:
    """The bound of one frame's solve: bytes, operations, the least
    seconds each allows and the larger of the two."""
    nbytes = (2 * live_bodies * BODY_ROW_BYTES
              + live_points * (POINT_IN_BYTES + POINT_OUT_BYTES) + 4)
    ops = live_points * (OPS["warm"] + vel_iters * OPS["velocity"]
                         + pos_iters * OPS["displacement"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bytes_s=t_bytes, ops_s=t_ops,
                bound_s=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_share(run, kernel: str):
    """Percent of its bound that ``kernel`` (K1 or K3) reaches over the
    traced calls' frames, or None where the trace shows no launch of it.
    Each traced call's live points are those of its last frame."""
    if not run.trace or not run.traced_points:
        return None
    us = solve_kernel_us(run.trace["ops"], kernel)
    traced = [c for c in run.window.calls if c.traced]
    frames = sum(c.frames for c in traced)
    if us <= 0 or not frames:
        return None
    points = sum(p * c.frames for p, c in zip(run.traced_points, traced))
    c = run.config
    bound = solve_bound(run.live_bodies, points / frames,
                        c["velocity_iterations"], c["position_iterations"])
    return 100.0 * bound["bound_s"] / (us / 1e6 / frames)
