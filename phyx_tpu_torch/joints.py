"""User joints: revolute (pin) and distance constraints
(``phyx_tpu/joints.py``).

A joint is a solver row after the contact rows: the same limiter machinery
(precomputed rows and effective masses, warm-started impulses, a velocity
pass and a split-impulse displacement pass), visited by the same kernels.

Row encodings (12 f32 per row, the contact row's width):

  revolute: [r1x, r1y, r2x, r2y, m00, m01, m11, dstx, dsty, 0, 0, kind=1]
    2D point equality, solved with the 2x2 effective-mass inverse
    (m00 m01; m01 m11); velocity target 0; displacement target
    (dstx, dsty) = clamped -beta * anchor error.

  distance: [nx, ny, r1x, r1y, r2x, r2y, mass, dst, 0, 0, 0, kind=2]
    1D constraint along the current anchor axis n; signed displacement
    target dst = clamped beta * (rest - |d|).

Accumulators per row (4 f32): velocity impulse (x, y) and displacement
impulse (x, y); a distance joint keeps its scalar impulse in x.
"""

from __future__ import annotations

import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch.config import SimConfig

KIND_NONE = 0
KIND_REVOLUTE = 1
KIND_DISTANCE = 2


def prepare_joint_rows(bodies, joints, cfg: SimConfig):
    """Batched joint prepare: returns (rows (J, 12) f32, warm (J, 2) f32).
    Free slots (kind 0) get zero rows and zero warm impulses."""
    b1 = joints.b1.to(torch.int64)
    b2 = joints.b2.to(torch.int64)
    valid = joints.kind != KIND_NONE
    rev = joints.kind == KIND_REVOLUTE

    p1, p2 = bodies.pos[b1], bodies.pos[b2]
    im1, im2 = bodies.inv_mass[b1], bodies.inv_mass[b2]
    ii1, ii2 = bodies.inv_inertia[b1], bodies.inv_inertia[b2]
    r1 = m2.rot_apply(bodies.rot[b1], joints.a1)
    r2 = m2.rot_apply(bodies.rot[b2], joints.a2)
    err = (p2 + r2) - (p1 + r1)              # anchor separation

    # revolute: the 2x2 effective mass K^-1
    r1x, r1y, r2x, r2y = r1[:, 0], r1[:, 1], r2[:, 0], r2[:, 1]
    k00 = im1 + im2 + ii1 * (r1y * r1y) + ii2 * (r2y * r2y)
    k01 = -ii1 * r1x * r1y - ii2 * r2x * r2y
    k11 = im1 + im2 + ii1 * (r1x * r1x) + ii2 * (r2x * r2x)
    det = k00 * k11 - k01 * k01
    inv_det = torch.where(torch.abs(det) > 1e-30, 1.0 / det, 0.0)
    m00 = k11 * inv_det
    m01 = -k01 * inv_det
    m11 = k00 * inv_det
    # the displacement target points against the error, to shrink it
    mdv = cfg.max_displacement_velocity
    dst_rev = torch.clamp(-cfg.joint_beta * err, -mdv, mdv)

    # distance: axis and scalar effective mass
    dist = torch.sqrt((err * err).sum(dim=-1))
    safe = torch.clamp(dist, min=1e-9)[:, None]
    axis_x = torch.stack([torch.ones_like(dist), torch.zeros_like(dist)],
                         dim=-1)
    n = torch.where(dist[:, None] > 1e-9, err / safe, axis_x)
    rn1 = m2.cross(r1, n)
    rn2 = m2.cross(r2, n)
    kd = im1 + im2 + ii1 * (rn1 * rn1) + ii2 * (rn2 * rn2)
    mass_d = torch.where(kd > 0.0, 1.0 / torch.clamp(kd, min=1e-30), 0.0)
    # positive when too short: drive the separation rate positive
    dst_dist = torch.clamp(cfg.joint_beta * (joints.rest - dist), -mdv, mdv)

    zero = torch.zeros_like(dist)
    rows_rev = torch.stack([
        r1x, r1y, r2x, r2y, m00, m01, m11, dst_rev[:, 0], dst_rev[:, 1],
        zero, zero, torch.full_like(dist, float(KIND_REVOLUTE))], dim=1)
    rows_dist = torch.stack([
        n[:, 0], n[:, 1], r1x, r1y, r2x, r2y, mass_d, dst_dist, zero, zero,
        zero, torch.full_like(dist, float(KIND_DISTANCE))], dim=1)
    rows = torch.where(rev[:, None], rows_rev, rows_dist)
    rows = torch.where(valid[:, None], rows, 0.0)
    warm = torch.where(valid[:, None], joints.accum, 0.0)
    return rows, warm
