"""Sequential-impulse solver: prepare, residual gates and the packing that
feeds the serial solve kernel (``phyx_tpu/solver.py``).

* ``prepare`` = PrepareJoints: the 2D Jacobian rows collapse to normal /
  tangent scalars, effective masses, the restitution target velocity and
  the displacement target (penetration - slop), all batched.
* ``velocity_threshold`` / ``position_threshold``: the runtime thresholds
  of the residual gates.
* ``solve_pallas``: packs bodies and contacts into the kernel's flat rows
  and unpacks its output — the counterpart of the reference's
  ``solve_pallas`` for contact rows (joint rows follow with ROADMAP M9).
"""

from __future__ import annotations

import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels.contact_solver_streamed import \
    solve_contacts_streamed
from phyx_tpu_torch.narrowphase import Contacts
from phyx_tpu_torch.types import Bodies


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


def impulse_scale(contacts: Contacts) -> torch.Tensor:
    """Scene impulse scale of the relative gates: max |warm impulse| of
    the frame (0 on cold starts, which disables the relative gates)."""
    s = torch.abs(torch.where(contacts.valid, contacts.warm_n, 0.0)).max()
    return torch.maximum(s, torch.abs(
        torch.where(contacts.valid, contacts.warm_t, 0.0)).max())


def velocity_threshold(cfg: SimConfig, contacts: Contacts) -> torch.Tensor:
    """max(velocity_tol, velocity_rel_tol * impulse_scale); () f32."""
    t = torch.full((), cfg.velocity_tol, dtype=torch.float32,
                   device=contacts.valid.device)
    if cfg.velocity_rel_tol > 0.0:
        t = torch.maximum(t, cfg.velocity_rel_tol * impulse_scale(contacts))
    return t


def position_threshold(cfg: SimConfig, contacts: Contacts) -> torch.Tensor:
    """position_rel_tol * impulse_scale; () f32, 0 when the gate is off."""
    if cfg.position_rel_tol <= 0.0:
        return torch.zeros((), dtype=torch.float32,
                           device=contacts.valid.device)
    return cfg.position_rel_tol * impulse_scale(contacts)


def pack_streamed(bodies: Bodies, contacts: Contacts,
                  num_contacts: torch.Tensor, cfg: SimConfig) -> dict:
    """The kernel's arguments for ``contacts`` (already compacted: live
    rows first).  Body rows are [vx, vy, w, inv_mass, inv_inertia,
    dvx, dvy, dw] with the pseudo-velocities starting at zero; contact rows
    are [n, r1, r2, mass_n, mass_t, friction, dst_v, dst_dv, c_nt]."""
    n = bodies.capacity
    body_flat = torch.cat([
        bodies.vel, bodies.angvel[:, None], bodies.inv_mass[:, None],
        bodies.inv_inertia[:, None],
        torch.zeros((n, 3), dtype=torch.float32, device=bodies.vel.device),
    ], dim=1).reshape(-1)
    con_flat = torch.stack([
        contacts.normal[:, 0], contacts.normal[:, 1],
        contacts.r1[:, 0], contacts.r1[:, 1],
        contacts.r2[:, 0], contacts.r2[:, 1],
        contacts.mass_n, contacts.mass_t, contacts.friction,
        contacts.dst_v, contacts.dst_dv, contacts.c_nt,
    ], dim=1).reshape(-1)
    warm_flat = torch.stack([contacts.warm_n, contacts.warm_t],
                            dim=1).reshape(-1)
    # an ungated kind's threshold is 0.0, which never fires
    tols = None
    if (cfg.velocity_tol > 0.0 or cfg.velocity_rel_tol > 0.0
            or cfg.position_rel_tol > 0.0):
        tols = torch.stack([velocity_threshold(cfg, contacts),
                            position_threshold(cfg, contacts)])
    return dict(body_flat=body_flat, b1=contacts.b1.contiguous(),
                b2=contacts.b2.contiguous(), con_flat=con_flat,
                warm_flat=warm_flat,
                num_contacts=num_contacts.to(torch.int32),
                vel_iters=cfg.velocity_iterations,
                pos_iters=cfg.position_iterations, tols=tols)


def solve_pallas(bodies: Bodies, contacts: Contacts,
                 num_contacts: torch.Tensor, cfg: SimConfig):
    """Warm start + velocity + position solve in the exact serial
    Gauss-Seidel order, through the serial solve kernel.  Returns
    (bodies', accum_n, accum_t, residual)."""
    n = bodies.capacity
    c = contacts.valid.shape[0]
    body_out, acc, res = solve_contacts_streamed(
        **pack_streamed(bodies, contacts, num_contacts, cfg))
    body_out = body_out.reshape(n, 8)
    acc = acc.reshape(c, 4)
    bodies = bodies.replace(vel=body_out[:, 0:2], angvel=body_out[:, 2],
                            dvel=body_out[:, 5:7], dangvel=body_out[:, 7])
    return bodies, acc[:, 0], acc[:, 1], res[0]
