"""Narrowphase: batched oriented-box SAT + incident-face clipping
(``phyx_tpu/narrowphase.py``).

Every candidate pair runs in parallel as SoA vector math; the early-outs of
a scalar implementation become masks.  Fixed two-point manifolds with the
oracle's stable feature ids (``collide_box_box_np``), which is what lets the
contact cache warm-start across frames.

Geometry conventions (shared with the oracle):
  * Box vertices CCW: 0=(-x,-y) 1=(+x,-y) 2=(+x,+y) 3=(-x,+y).
  * Face f outward normal: 0:+x, 1:+y, 2:-x, 3:-y.
  * Feature id = flip*4 + incident-vertex-id, flip=4 when B is reference.
  * Manifold normal always points from body A (pair.pi) toward body B.
"""

from __future__ import annotations

import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch.broadphase import Pairs
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import Bodies, _record

# SAT reference-face preference hysteresis (same constants as the oracle)
REL_TOL = 0.98
ABS_TOL = 0.001


@_record
class Contacts:
    """Flat SoA contact-point constraints, capacity C = 2 * max_pairs.
    Contact ``2*p + k`` is point-slot ``k`` of pair-slot ``p``."""

    b1: torch.Tensor           # (C,) int32 body A index (clamped-safe)
    b2: torch.Tensor           # (C,) int32 body B index
    normal: torch.Tensor       # (C, 2) f32, A -> B
    r1: torch.Tensor           # (C, 2) f32 offset from body A center
    r2: torch.Tensor           # (C, 2) f32 offset from body B center
    penetration: torch.Tensor  # (C,) f32 >= 0
    fid: torch.Tensor          # (C,) int32 feature id, -1 when invalid
    valid: torch.Tensor        # (C,) bool
    warm_n: torch.Tensor       # (C,) f32 warm-start impulses (cache.py)
    warm_t: torch.Tensor       # (C,) f32
    mass_n: torch.Tensor       # (C,) f32 prepared data (solver.prepare)
    mass_t: torch.Tensor       # (C,) f32
    friction: torch.Tensor     # (C,) f32
    dst_v: torch.Tensor        # (C,) f32 restitution target velocity
    dst_dv: torch.Tensor       # (C,) f32 displacement target velocity
    c_nt: torch.Tensor         # (C,) f32 normal->tangent coupling
    color: torch.Tensor        # (C,) int32 color class (coloring.py)


def _sel(cond, a, b):
    """where() broadcasting a trailing vector axis."""
    return torch.where(cond[..., None] if a.ndim > cond.ndim else cond, a, b)


def _comp(v, k):
    """v[:, k] for per-row k in {0, 1}."""
    return torch.where(k == 1, v[:, 1], v[:, 0])


def narrowphase_with_props(bodies: Bodies, pairs: Pairs, cfg: SimConfig):
    """``narrowphase`` plus the per-pair body properties that
    ``solver.prepare`` needs, taken from the same gather.  Returns
    (Contacts, (props1, props2)) with props* = (P, 7):
    [vel.x, vel.y, angvel, inv_mass, inv_inertia, friction, restitution]."""
    n = bodies.capacity
    # EMPTY slots are clamped to a real row (masked below): an index past
    # the end would raise here, and assert on the device
    i = torch.clamp(pairs.pi, max=n - 1)
    j = torch.clamp(pairs.pj, max=n - 1)
    pvalid = pairs.valid

    geom = torch.cat(
        [bodies.pos, bodies.rot, bodies.half_extent,              # 0:6
         bodies.vel, bodies.angvel[:, None],                      # 6:9
         bodies.inv_mass[:, None], bodies.inv_inertia[:, None],   # 9:11
         bodies.friction[:, None], bodies.restitution[:, None],   # 11:13
         ], dim=1)
    ga = geom[i.to(torch.int64)]
    gb = geom[j.to(torch.int64)]
    props = (ga[:, 6:13], gb[:, 6:13])
    pa, ra, ha = ga[:, 0:2], ga[:, 2:4], ga[:, 4:6]
    pb, rb, hb = gb[:, 0:2], gb[:, 2:4], gb[:, 4:6]

    d = pb - pa
    da = m2.rot_inv_apply(ra, d)           # B center in A frame
    db = m2.rot_inv_apply(rb, -d)          # A center in B frame

    cr = ra[:, 0] * rb[:, 0] + ra[:, 1] * rb[:, 1]
    sr = ra[:, 0] * rb[:, 1] - ra[:, 1] * rb[:, 0]
    ac, as_ = torch.abs(cr), torch.abs(sr)

    # SAT separations on the 4 face axes (2 of A, 2 of B)
    sep_ax = torch.abs(da[:, 0]) - ha[:, 0] - (ac * hb[:, 0] + as_ * hb[:, 1])
    sep_ay = torch.abs(da[:, 1]) - ha[:, 1] - (as_ * hb[:, 0] + ac * hb[:, 1])
    sep_bx = torch.abs(db[:, 0]) - hb[:, 0] - (ac * ha[:, 0] + as_ * ha[:, 1])
    sep_by = torch.abs(db[:, 1]) - hb[:, 1] - (as_ * ha[:, 0] + ac * ha[:, 1])

    overlapping = ((sep_ax <= 0.0) & (sep_ay <= 0.0)
                   & (sep_bx <= 0.0) & (sep_by <= 0.0) & pvalid)

    axis_a = (sep_ay > sep_ax).to(torch.int32)
    best_a = torch.maximum(sep_ax, sep_ay)
    axis_b = (sep_by > sep_bx).to(torch.int32)
    best_b = torch.maximum(sep_bx, sep_by)
    use_b = best_b > REL_TOL * best_a + ABS_TOL

    # reference / incident frames
    ref_p = _sel(use_b, pb, pa)
    ref_r = _sel(use_b, rb, ra)
    ref_h = _sel(use_b, hb, ha)
    inc_p = _sel(use_b, pa, pb)
    inc_r = _sel(use_b, ra, rb)
    inc_h = _sel(use_b, ha, hb)
    axis = torch.where(use_b, axis_b, axis_a)
    d_ref = _sel(use_b, db, da)
    sign = torch.where(_comp(d_ref, axis) >= 0.0, 1.0, -1.0)

    # reference face world normal: sign * ref_R[:, axis]
    col0 = torch.stack([ref_r[:, 0], ref_r[:, 1]], dim=-1)
    col1 = torch.stack([-ref_r[:, 1], ref_r[:, 0]], dim=-1)
    n_face = sign[:, None] * _sel(axis == 1, col1, col0)
    normal = _sel(use_b, -n_face, n_face)             # always A -> B

    # incident face: most anti-parallel to n_face, in incident-local frame
    n_inc = m2.rot_inv_apply(inc_r, n_face)
    inc_axis = (torch.abs(n_inc[:, 1]) > torch.abs(n_inc[:, 0])).to(torch.int32)
    inc_sign = torch.where(_comp(n_inc, inc_axis) >= 0.0, -1.0, 1.0)

    def ids(*vals):
        # per-row choice among four int32 constants by face index
        out = torch.full_like(fidx, vals[3])
        for f in (2, 1, 0):
            out = torch.where(fidx == f, vals[f], out)
        return out

    fidx = torch.where(inc_axis == 0,
                       torch.where(inc_sign > 0, 0, 2),
                       torch.where(inc_sign > 0, 1, 3)).to(torch.int32)
    # face -> (v0, v1) vertex ids, CCW: 0:(1,2) 1:(2,3) 2:(3,0) 3:(0,1)
    v0_id = ids(1, 2, 3, 0)
    v1_id = ids(2, 3, 0, 1)

    def vert_local(vid):
        sx = torch.where((vid == 1) | (vid == 2), 1.0, -1.0)
        sy = torch.where(vid >= 2, 1.0, -1.0)
        return torch.stack([sx * inc_h[:, 0], sy * inc_h[:, 1]], dim=-1)

    def to_ref_local(v_local):
        w = inc_p + m2.rot_apply(inc_r, v_local)
        return m2.rot_inv_apply(ref_r, w - ref_p)

    p0 = to_ref_local(vert_local(v0_id))
    p1 = to_ref_local(vert_local(v1_id))

    # clip against the two side planes of the reference face
    other = 1 - axis
    ref_h_other = _comp(ref_h, other)
    p0o = _comp(p0, other)
    p1o = _comp(p1, other)

    fully_out = torch.zeros_like(overlapping)
    for plane_sign in (-1.0, 1.0):
        d0 = plane_sign * p0o - ref_h_other
        d1 = plane_sign * p1o - ref_h_other
        fully_out = fully_out | ((d0 > 0.0) & (d1 > 0.0))
        t0 = d0 / torch.where(torch.abs(d0 - d1) > 1e-30, d0 - d1, 1e-30)
        t1 = d1 / torch.where(torch.abs(d1 - d0) > 1e-30, d1 - d0, 1e-30)
        new_p0 = _sel(d0 > 0.0, p0 + (p1 - p0) * t0[:, None], p0)
        new_p1 = _sel(d1 > 0.0, p1 + (p0 - p1) * t1[:, None], p1)
        p0, p1 = new_p0, new_p1
        p0o = _comp(p0, other)
        p1o = _comp(p1, other)

    pair_ok = overlapping & ~fully_out
    flip = torch.where(use_b, 4, 0).to(torch.int32)

    def finish_point(p_local, vid):
        separation = sign * _comp(p_local, axis) - _comp(ref_h, axis)
        ok = pair_ok & (separation <= 0.0)
        p_world = ref_p + m2.rot_apply(ref_r, p_local)
        return p_world, -separation, flip + vid, ok

    w0, pen0, fid0, ok0 = finish_point(p0, v0_id)
    w1, pen1, fid1, ok1 = finish_point(p1, v1_id)

    def ilv(a0, a1):
        """Interleave the 2 point-slots: contact 2p+k."""
        return torch.stack([a0, a1], dim=1).reshape((-1,) + a0.shape[1:])

    c_valid = ilv(ok0, ok1)
    c_world = ilv(w0, w1)
    zf = torch.zeros(c_valid.shape, dtype=torch.float32,
                     device=c_valid.device)
    return Contacts(
        b1=ilv(i, i), b2=ilv(j, j),
        normal=torch.where(c_valid[:, None], ilv(normal, normal), 0.0),
        r1=c_world - ilv(pa, pa),
        r2=c_world - ilv(pb, pb),
        penetration=torch.where(c_valid, ilv(pen0, pen1), 0.0),
        fid=torch.where(c_valid, ilv(fid0, fid1), -1),
        valid=c_valid,
        warm_n=zf, warm_t=zf,
        mass_n=zf, mass_t=zf, friction=zf, dst_v=zf, dst_dv=zf, c_nt=zf,
        color=torch.zeros(c_valid.shape, dtype=torch.int32,
                          device=c_valid.device),
    ), props
