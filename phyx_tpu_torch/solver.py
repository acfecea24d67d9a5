"""Sequential-impulse solver: prepare, residual gates and the packing that
feeds the serial solve kernel (``phyx_tpu/solver.py``).

* ``prepare`` = PrepareJoints: the 2D Jacobian rows collapse to normal /
  tangent scalars, effective masses, the restitution target velocity and
  the displacement target (penetration - slop), all batched.
* ``velocity_threshold`` / ``position_threshold``: the runtime thresholds
  of the residual gates, scaled by the frame's contact and joint warm
  impulses.
* ``solve_pallas``: packs bodies, contacts and joint rows into the solve
  kernels' flat rows and unpacks their output — the counterpart of the
  reference's ``solve_pallas`` for the fused and streamed kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels.contact_solver import solve_contacts_fused
from phyx_tpu_torch.kernels.contact_solver_streamed import \
    solve_contacts_streamed
from phyx_tpu_torch.narrowphase import Contacts
from phyx_tpu_torch.types import Bodies, Joints


def prepare(contacts: Contacts, cfg: SimConfig, pair_props) -> Contacts:
    """Batched PrepareJoints.  ``pair_props`` — (props1, props2) from
    ``narrowphase_with_props``, each (C/2, 7) at pair granularity:
    [vel.x, vel.y, angvel, inv_mass, inv_inertia, friction, restitution]."""
    n = contacts.normal
    t = m2.perp(n)
    r1, r2 = contacts.r1, contacts.r2
    # expand pair rows to the 2 contact slots (a broadcast, not a gather)
    p1, p2 = (p[:, None].expand(-1, 2, -1).reshape(-1, p.shape[-1])
              for p in pair_props)
    im1, im2 = p1[:, 3], p2[:, 3]
    ii1, ii2 = p1[:, 4], p2[:, 4]

    rn1, rn2 = m2.cross(r1, n), m2.cross(r2, n)
    kn = im1 + im2 + ii1 * rn1 * rn1 + ii2 * rn2 * rn2
    mass_n = torch.where(kn > 0.0, 1.0 / torch.clamp(kn, min=1e-30), 0.0)

    rt1, rt2 = m2.cross(r1, t), m2.cross(r2, t)
    kt = im1 + im2 + ii1 * rt1 * rt1 + ii2 * rt2 * rt2
    mass_t = torch.where(kt > 0.0, 1.0 / torch.clamp(kt, min=1e-30), 0.0)

    # normal->tangent coupling J_t M^-1 J_n^T: the solve visit updates the
    # tangent velocity analytically after the normal impulse
    c_nt = ii1 * rn1 * rt1 + ii2 * rn2 * rt2

    friction = torch.sqrt(p1[:, 5] * p2[:, 5])

    pv1 = p1[:, 0:2] + m2.cross_sv(p1[:, 2], r1)
    pv2 = p2[:, 0:2] + m2.cross_sv(p2[:, 2], r2)
    vn0 = m2.dot(n, pv2 - pv1)
    e = torch.maximum(p1[:, 6], p2[:, 6])
    dst_v = torch.where(vn0 < -cfg.restitution_threshold, -e * vn0, 0.0)

    dst_dv = torch.clamp(
        cfg.contact_beta * torch.clamp(contacts.penetration - cfg.slop,
                                       min=0.0),
        max=cfg.max_displacement_velocity)

    v = contacts.valid
    return contacts.replace(
        mass_n=torch.where(v, mass_n, 0.0),
        mass_t=torch.where(v, mass_t, 0.0),
        friction=torch.where(v, friction, 0.0),
        dst_v=torch.where(v, dst_v, 0.0),
        dst_dv=torch.where(v, dst_dv, 0.0),
        c_nt=torch.where(v, c_nt, 0.0),
    )


def impulse_scale(contacts: Contacts,
                  joint_warm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scene impulse scale of the relative gates: max |warm impulse| of
    the frame, contacts and user joints (0 on cold starts, which disables
    the relative gates)."""
    s = torch.abs(torch.where(contacts.valid, contacts.warm_n, 0.0)).max()
    s = torch.maximum(s, torch.abs(
        torch.where(contacts.valid, contacts.warm_t, 0.0)).max())
    if joint_warm is not None and joint_warm.shape[0]:
        s = torch.maximum(s, torch.abs(joint_warm).max())
    return s


def velocity_threshold(cfg: SimConfig, contacts: Contacts,
                       joint_warm: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """max(velocity_tol, velocity_rel_tol * impulse_scale); () f32."""
    t = torch.full((), cfg.velocity_tol, dtype=torch.float32,
                   device=contacts.valid.device)
    if cfg.velocity_rel_tol > 0.0:
        t = torch.maximum(t, cfg.velocity_rel_tol
                          * impulse_scale(contacts, joint_warm))
    return t


def position_threshold(cfg: SimConfig, contacts: Contacts,
                       joint_warm: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """position_rel_tol * impulse_scale; () f32, 0 when the gate is off."""
    if cfg.position_rel_tol <= 0.0:
        return torch.zeros((), dtype=torch.float32,
                           device=contacts.valid.device)
    return cfg.position_rel_tol * impulse_scale(contacts, joint_warm)


def pack_rows(bodies: Bodies, contacts: Contacts, num_contacts: torch.Tensor,
              cfg: SimConfig, joints: Optional[Joints] = None,
              joint_rows: Optional[torch.Tensor] = None,
              joint_warm: Optional[torch.Tensor] = None) -> dict:
    """The solve kernels' arguments for ``contacts`` (already compacted:
    live rows first) and, when given, the joints' prepared rows and warm
    impulses (``joints.prepare_joint_rows``), appended at slot C.  Body rows
    are [vx, vy, w, inv_mass, inv_inertia, dvx, dvy, dw] with the
    pseudo-velocities starting at zero; contact rows are [n, r1, r2, mass_n,
    mass_t, friction, dst_v, dst_dv, c_nt]."""
    n = bodies.capacity
    c = contacts.valid.shape[0]
    body_flat = torch.cat([
        bodies.vel, bodies.angvel[:, None], bodies.inv_mass[:, None],
        bodies.inv_inertia[:, None],
        torch.zeros((n, 3), dtype=torch.float32, device=bodies.vel.device),
    ], dim=1).reshape(-1)
    con = torch.stack([
        contacts.normal[:, 0], contacts.normal[:, 1],
        contacts.r1[:, 0], contacts.r1[:, 1],
        contacts.r2[:, 0], contacts.r2[:, 1],
        contacts.mass_n, contacts.mass_t, contacts.friction,
        contacts.dst_v, contacts.dst_dv, contacts.c_nt,
    ], dim=1)
    warm = torch.stack([contacts.warm_n, contacts.warm_t], dim=1)
    b1, b2 = contacts.b1, contacts.b2
    num_joints = None
    if joints is not None and joints.capacity:
        con = torch.cat([con, joint_rows])
        warm = torch.cat([warm, joint_warm])
        b1 = torch.cat([b1, torch.clamp(joints.b1, max=n - 1)])
        b2 = torch.cat([b2, torch.clamp(joints.b2, max=n - 1)])
        # live joints fill a prefix of the slots; a device count
        num_joints = (joints.kind != 0).sum(dtype=torch.int32)
    else:
        joint_warm = None
    # an ungated kind's threshold is 0.0, which never fires
    tols = None
    if (cfg.velocity_tol > 0.0 or cfg.velocity_rel_tol > 0.0
            or cfg.position_rel_tol > 0.0):
        tols = torch.stack([velocity_threshold(cfg, contacts, joint_warm),
                            position_threshold(cfg, contacts, joint_warm)])
    return dict(body_flat=body_flat, b1=b1.contiguous(),
                b2=b2.contiguous(), con_flat=con.reshape(-1),
                warm_flat=warm.reshape(-1),
                num_contacts=num_contacts.to(torch.int32),
                vel_iters=cfg.velocity_iterations,
                pos_iters=cfg.position_iterations, num_joints=num_joints,
                c_cap=c, tols=tols)


def solve_pallas(bodies: Bodies, contacts: Contacts,
                 num_contacts: torch.Tensor, cfg: SimConfig, fused: bool,
                 joints: Optional[Joints] = None,
                 joint_rows: Optional[torch.Tensor] = None,
                 joint_warm: Optional[torch.Tensor] = None):
    """Warm start + velocity + position solve in the exact serial
    Gauss-Seidel order, contacts then joints, through the fused kernel
    (``fused``) or the streamed one.  Returns (bodies', accum_n, accum_t,
    residual, joint_accum (J, 2))."""
    n = bodies.capacity
    c = contacts.valid.shape[0]
    j = 0 if joints is None else joints.capacity
    kernel = solve_contacts_fused if fused else solve_contacts_streamed
    body_out, acc, res = kernel(**pack_rows(
        bodies, contacts, num_contacts, cfg, joints, joint_rows, joint_warm))
    body_out = body_out.reshape(n, 8)
    acc = acc.reshape(c + j, 4)
    bodies = bodies.replace(vel=body_out[:, 0:2], angvel=body_out[:, 2],
                            dvel=body_out[:, 5:7], dangvel=body_out[:, 7])
    return bodies, acc[:c, 0], acc[:c, 1], res[0], acc[c:, 0:2]
