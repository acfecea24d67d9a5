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
* ``solve_pallas_tiled2`` and ``solve_pallas_tiled``: the same for the
  tiled tier, K3 on the slab-major pair buffer and K5 on rows routed here
  to per-slab budgets (``tiling`` has the slab embedding).
* ``warm_start``, ``solve_velocity`` and ``solve_position``: the colored
  solve (``solver_backend="xla"`` and the colored fallback), torch ops.
  Each pass sweeps the contact colors, then the joint colors, one after
  another; a color's rows run as one full-width masked batch (gather, row
  solve, clamp the accumulated impulse, scatter-add), which is the serial
  algorithm in the color-sorted order because no dynamic body repeats
  inside a non-final color (``coloring``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch import tiling
from phyx_tpu_torch.broadphase import TiledRouting
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels.contact_solver import solve_contacts_fused
from phyx_tpu_torch.kernels.contact_solver_streamed import \
    solve_contacts_streamed
from phyx_tpu_torch.kernels.contact_solver_tiled import (
    solve_contacts_tiled, solve_contacts_tiled2)
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


def thresholds(cfg: SimConfig, contacts: Contacts,
               joint_warm: Optional[torch.Tensor] = None
               ) -> Optional[torch.Tensor]:
    """The gates' (2,) [velocity, position] thresholds, or None when the
    configuration is ungated.  An ungated kind's threshold is 0.0, which
    never fires."""
    if (cfg.velocity_tol > 0.0 or cfg.velocity_rel_tol > 0.0
            or cfg.position_rel_tol > 0.0):
        return torch.stack([velocity_threshold(cfg, contacts, joint_warm),
                            position_threshold(cfg, contacts, joint_warm)])
    return None


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
    tols = thresholds(cfg, contacts, joint_warm)
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


def _rep2(x: torch.Tensor) -> torch.Tensor:
    """Each pair-level row twice, once per contact slot of the pair."""
    return x[:, None].expand(x.shape[0], 2, *x.shape[1:]).reshape(
        2 * x.shape[0], *x.shape[1:])


def _contact_columns(contacts: Contacts) -> torch.Tensor:
    """(C, 14) f32: the 12 contact row columns, then warm_n, warm_t."""
    return torch.stack([
        contacts.normal[:, 0], contacts.normal[:, 1],
        contacts.r1[:, 0], contacts.r1[:, 1],
        contacts.r2[:, 0], contacts.r2[:, 1],
        contacts.mass_n, contacts.mass_t, contacts.friction,
        contacts.dst_v, contacts.dst_dv, contacts.c_nt,
        contacts.warm_n, contacts.warm_t], dim=1)


def _unembed_bodies(bodies: Bodies, table: torch.Tensor, order, cfg):
    rows = tiling.unembed(table.reshape(-1, 8), order, cfg,
                          bodies.capacity)
    return bodies.replace(vel=rows[:, 0:2], angvel=rows[:, 2],
                          dvel=rows[:, 5:7], dangvel=rows[:, 7])


def pack_tiled2(bodies: Bodies, contacts: Contacts, routing: TiledRouting,
                cfg: SimConfig) -> dict:
    """K3's arguments (``kernels/contact_solver_tiled.py``): the embedded
    table from the broadphase's ranked columns, the slots in the pair
    buffer's (slab, pi, pj) order, not compacted (slots of dead pairs lie
    past ``cum[n_slabs]`` and are never walked; SAT-dead slots of live
    pairs are no-ops), ``cum`` = 2 x the kept-pair cumsum, and the gate
    thresholds of the uncompacted contacts."""
    n = bodies.capacity
    K, _, W, _, n_slabs, _ = tiling.slab_dims(cfg, n)
    b12 = torch.stack([routing.lb1, routing.lb2], dim=1)
    return dict(
        body_flat=tiling.embed(routing.ranked_cols, cfg, n).reshape(-1),
        b12=_rep2(b12).reshape(-1),
        cw=_contact_columns(contacts).reshape(-1),
        cum=routing.pair_cum * 2,
        vel_iters=cfg.velocity_iterations, pos_iters=cfg.position_iterations,
        n_slabs=n_slabs, slab_stride=K, window_rows=W,
        tols=thresholds(cfg, contacts))


def solve_pallas_tiled2(bodies: Bodies, contacts: Contacts,
                        routing: TiledRouting, cfg: SimConfig):
    """The slab-major tiled solve through K3.  Returns (bodies', accum_n,
    accum_t, residual); the slab clamps were counted into ``ovf_slab`` by
    the broadphase, and the accumulators come back in contact order."""
    body_out, acc, res = solve_contacts_tiled2(
        **pack_tiled2(bodies, contacts, routing, cfg))
    acc = acc.reshape(-1, 4)
    live = contacts.valid
    return (_unembed_bodies(bodies, body_out, routing.order, cfg),
            torch.where(live, acc[:, 0], 0.0),
            torch.where(live, acc[:, 1], 0.0), res[0])


def _route_rows(slab, live, n_slabs: int, cap: int, cap_all: int,
                base_off: int):
    """Slots of rows routed to per-slab budgets: a row's slab is its
    ``slab``, its place the rank among its slab's live rows in row order (a
    stable sort by slab); slab s's rows take slots ``s*cap_all + base_off +
    rank`` up to ``cap`` of them.  Returns (slot per row, or the spill slot
    n_slabs*cap_all for dead and overflowing rows; ok per row; live rows
    per slab, at most ``cap``; rows past the budgets)."""
    m = live.shape[0]
    skey = torch.where(live, slab, n_slabs)
    skey_s, perm = torch.sort(skey, stable=True)
    bounds = torch.searchsorted(skey_s, torch.arange(
        n_slabs + 1, dtype=skey_s.dtype, device=skey_s.device))
    counts = bounds[1:] - bounds[:-1]
    rank_s = torch.arange(m, device=skey_s.device) - bounds[skey_s]
    rank = torch.empty_like(rank_s).index_copy_(0, perm, rank_s)
    ok = live & (rank < cap)
    slot = torch.where(ok, skey * cap_all + base_off + rank,
                       n_slabs * cap_all)
    return (slot, ok, torch.clamp(counts, max=cap).to(torch.int32),
            torch.clamp(counts - cap, min=0).sum(dtype=torch.int32))


def _place(slot, vals, n_slots: int) -> torch.Tensor:
    """Rows ``vals`` written to their ``slot`` of a zero buffer of
    ``n_slots`` rows; the spill slot ``n_slots`` is dropped."""
    out = torch.zeros((n_slots + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_copy_(0, slot, vals)[:n_slots]


def pack_tiled(bodies: Bodies, contacts: Contacts, xorder: torch.Tensor,
               cfg: SimConfig, joints: Optional[Joints] = None,
               joint_rows: Optional[torch.Tensor] = None,
               joint_warm: Optional[torch.Tensor] = None):
    """K5's arguments (``kernels/contact_solver_tiled.py``) and what
    un-routing needs.  Bodies embedded by ``xorder``; contacts routed at
    pair level (both slots of a pair share endpoints) and joint rows like
    them (``tiling.route_pairs``); per-slab budgets of ``cbps`` 1024-slot
    blocks, cbps = ceil(2c / n_slabs / 1024) (at least 2 with one slab),
    and likewise for joints (at least one block), as in the reference.
    Returns (args, (contact slots, contact ok, joint slots, joint ok),
    tiled overflow: clamped live rows plus rows past the budgets)."""
    n = bodies.capacity
    c = contacts.valid.shape[0]
    j_cap = 0 if joints is None else joints.capacity
    K, _, W, _, n_slabs, _ = tiling.slab_dims(cfg, n)
    xo = xorder.to(torch.int64)
    rank = torch.empty_like(xo).index_copy_(
        0, xo, torch.arange(n, device=xo.device))
    ranked_cols = torch.stack([bodies.vel[:, 0], bodies.vel[:, 1],
                               bodies.angvel, bodies.inv_mass,
                               bodies.inv_inertia], dim=1)[xo]
    pz = tiling.pz_table(rank, tiling.zero_safe_mask(bodies), cfg, n)

    blk = tiling.BLK
    cbps = -(-(2 * c // n_slabs) // blk)
    if n_slabs == 1:
        cbps = max(cbps, 2)
    jbps = max(1, -(-(2 * j_cap // n_slabs) // blk)) if j_cap else 0
    cap_c, cap_j = cbps * blk, jbps * blk
    cap_all = cap_c + cap_j
    n_slots = n_slabs * cap_all

    live = contacts.valid
    lb1, lb2, slab, in_win = tiling.route_pairs(
        pz, contacts.b1[0::2], contacts.b2[0::2], cfg, n)
    lb1, lb2, slab, in_win = (_rep2(x) for x in (lb1, lb2, slab, in_win))
    c_slot, c_ok, counts_c, ovf_c = _route_rows(slab, live, n_slabs, cap_c,
                                                cap_all, 0)
    ovf = (live & ~in_win).sum(dtype=torch.int32) + ovf_c
    slots = [c_slot]
    b12 = [torch.stack([lb1 - slab * K, lb2 - slab * K], dim=1)]
    cw = [_contact_columns(contacts)]
    counts_j = torch.zeros_like(counts_c)
    j_slot = j_ok = None
    if j_cap:
        jlive = joints.kind != 0
        jb1, jb2, jslab, jin = tiling.route_pairs(
            pz, torch.clamp(joints.b1, 0, n - 1),
            torch.clamp(joints.b2, 0, n - 1), cfg, n)
        j_slot, j_ok, counts_j, ovf_j = _route_rows(
            jslab, jlive, n_slabs, cap_j, cap_all, cap_c)
        ovf = ovf + (jlive & ~jin).sum(dtype=torch.int32) + ovf_j
        slots.append(j_slot)
        b12.append(torch.stack([jb1 - jslab * K, jb2 - jslab * K], dim=1))
        cw.append(torch.cat([joint_rows, joint_warm], dim=1))
    slots = torch.cat(slots)
    args = dict(
        body_flat=tiling.embed(ranked_cols, cfg, n).reshape(-1),
        b12=_place(slots, torch.cat(b12).to(torch.int32),
                   n_slots).reshape(-1),
        cw=_place(slots, torch.cat(cw), n_slots).reshape(-1),
        slab_counts=torch.cat([counts_c, counts_j]),
        vel_iters=cfg.velocity_iterations, pos_iters=cfg.position_iterations,
        n_slabs=n_slabs, slab_stride=K, window_rows=W, j_slots=cap_j,
        tols=thresholds(cfg, contacts, joint_warm if j_cap else None))
    return args, (c_slot, c_ok, j_slot, j_ok), ovf


def solve_pallas_tiled(bodies: Bodies, contacts: Contacts,
                       xorder: torch.Tensor, cfg: SimConfig,
                       joints: Optional[Joints] = None,
                       joint_rows: Optional[torch.Tensor] = None,
                       joint_warm: Optional[torch.Tensor] = None):
    """The routed tiled solve through K5 (``pack_tiled``), accumulators
    gathered back to row order, zero outside live rows inside their
    budget.  Returns (bodies', accum_n, accum_t, residual, tiled overflow,
    joint_accum (J, 2))."""
    args, (c_slot, c_ok, j_slot, j_ok), ovf = pack_tiled(
        bodies, contacts, xorder, cfg, joints, joint_rows, joint_warm)
    body_out, acc, res = solve_contacts_tiled(**args)
    acc = torch.cat([acc.reshape(-1, 4),
                     torch.zeros((1, 4), dtype=acc.dtype, device=acc.device)])
    acc_c = torch.where(c_ok[:, None], acc[c_slot, 0:2], 0.0)
    joint_accum = torch.zeros((0, 2), dtype=torch.float32,
                              device=acc.device)
    if j_slot is not None:
        joint_accum = torch.where(j_ok[:, None], acc[j_slot, 0:2], 0.0)
    return (_unembed_bodies(bodies, body_out, xorder, cfg), acc_c[:, 0],
            acc_c[:, 1], res[0], ovf, joint_accum)


class XlaJoints(NamedTuple):
    """User-joint rows of the colored solve: ``rows``/``warm`` from
    ``joints.prepare_joint_rows``, ``color`` from ``coloring.color_rows``
    over the joint graph, endpoints clamped to the body capacity."""

    rows: torch.Tensor    # (J, 12) f32
    b1: torch.Tensor      # (J,) int32
    b2: torch.Tensor      # (J,) int32
    warm: torch.Tensor    # (J, 2) f32 warm-start impulse
    color: torch.Tensor   # (J,) int32
    valid: torch.Tensor   # (J,) bool


class _Rows(NamedTuple):
    """What a sweep reads of its rows' two bodies, body-1 rows stacked on
    body-2 rows: the endpoints, the (-y, x) form of the body offsets, and
    per row [inv_mass, inv_mass, inv_inertia] with the sign of the
    impulse that body takes."""

    b12: torch.Tensor     # (2R,) int64
    rp: torch.Tensor      # (2R, 2) perp(r1), perp(r2)
    scale: torch.Tensor   # (2R, 3) -[im1, im1, ii1], +[im2, im2, ii2]


def _rows(bodies: Bodies, b1, b2, r1, r2) -> _Rows:
    b12 = torch.cat([b1, b2]).to(torch.int64)
    r = b1.shape[0]
    im = bodies.inv_mass.index_select(0, b12)
    scale = torch.stack(
        [im, im, bodies.inv_inertia.index_select(0, b12)], dim=1)
    scale[:r] = -scale[:r]
    return _Rows(b12, m2.perp(torch.cat([r1, r2])), scale)


def _sum2(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] + x[..., 1]: ``m2.dot``'s two-term sum as one add."""
    a, b = x.unbind(-1)
    return a + b


def _rel(v: torch.Tensor, rows: _Rows) -> torch.Tensor:
    """Relative velocity (R, 2) of the rows' points, body 2 minus body 1,
    from the (N, 3) [vx, vy, w] table ``v``: ``v + w x r`` (w * (-ry) is
    the reference's -(w * ry) exactly)."""
    gv, gw = v.index_select(0, rows.b12).split([2, 1], dim=1)
    p1, p2 = (gv + gw * rows.rp).chunk(2)
    return p2 - p1


def _ordered_add(v: torch.Tensor, idx: torch.Tensor,
                 upd: torch.Tensor) -> torch.Tensor:
    """``v`` with row k of ``upd`` added to row ``idx[k]``, the same bits
    every run.  On the card ``index_put(accumulate=True)`` gives them (it
    sorts by index; ``index_add`` is atomic there).  On the CPU
    ``index_add`` does, summing in the order of k at any thread count,
    while ``index_put(accumulate=True)`` keeps that order on one thread
    only and races on several."""
    if v.is_cuda:
        return v.index_put((idx,), upd, accumulate=True)
    return v.index_add(0, idx, upd)


def _apply(v: torch.Tensor, rows: _Rows, p: torch.Tensor,
           conflicts: bool) -> torch.Tensor:
    """``v`` (N, 3) with impulse ``p`` (R, 2) applied to both bodies of
    each row: -p to body 1, +p to body 2, the reference's products to the
    bit (a sign moved between factors, ``cross(r, p)`` as the two-term
    sum of ``perp(r) * p``).  Per body the adds come in row order, body-1
    rows first, as the reference's four scatter-adds.  A batch whose rows
    may share a dynamic body (``conflicts``: the final color class, the
    warm start) is summed by ``_ordered_add``; elsewhere each dynamic body
    takes at most one nonzero add and the rest are signed zeros, whose sum
    does not depend on the order, so ``index_add`` gives the same bits
    every run on either device."""
    p2 = torch.cat([p, p])
    upd = torch.cat([p2, _sum2(rows.rp * p2).unsqueeze(1)], dim=1)
    upd = upd * rows.scale
    if conflicts:
        return _ordered_add(v, rows.b12, upd)
    return v.index_add(0, rows.b12, upd)


def _body_table(vel, angvel) -> torch.Tensor:
    return torch.cat([vel, angvel[:, None]], dim=1)


class _JointGeom(NamedTuple):
    """Per-kind joint row geometry, from ``rows[:, 11]``: revolute rows
    take r1 = rows[0:2], r2 = rows[2:4]; distance rows r1 = rows[2:4],
    r2 = rows[4:6] and the axis n = rows[0:2]."""

    is_rev: torch.Tensor  # (J, 1) bool
    rows: _Rows
    n: torch.Tensor       # (J, 2) distance axis
    m: torch.Tensor       # (J, 2, 2) revolute [[m00, m01], [m01, m11]]
    m11: torch.Tensor     # (J, 1) distance effective mass


def _joint_geom(bodies: Bodies, j: XlaJoints) -> _JointGeom:
    is_rev = (j.rows[:, 11] == 1.0)[:, None]
    r1 = torch.where(is_rev, j.rows[:, 0:2], j.rows[:, 2:4])
    r2 = torch.where(is_rev, j.rows[:, 2:4], j.rows[:, 4:6])
    m00, m01, m11 = j.rows[:, 4:5], j.rows[:, 5:6], j.rows[:, 6:7]
    m = torch.stack([torch.cat([m00, m01], 1), torch.cat([m01, m11], 1)], 1)
    return _JointGeom(is_rev, _rows(bodies, j.b1, j.b2, r1, r2),
                      j.rows[:, 0:2], m, m11)


def _color_masks(valid, color, num_colors: int) -> list:
    """Per color c, the (R,) bool mask of the live rows of color c."""
    cols = torch.arange(num_colors, dtype=color.dtype, device=color.device)
    return list((valid[None] & (color[None] == cols[:, None])).unbind(0))


def _passes(n_passes: int, gated: bool, thresh, carry: tuple, run) -> tuple:
    """``n_passes`` passes of ``run`` over ``carry``, whose last entry is
    the residual of the last executed pass.  Gated, a pass after the first
    keeps the old carry where that residual is below ``thresh``: computed
    and discarded element by element, with no host read."""
    for it in range(n_passes):
        new = run(carry)
        if gated and it > 0:
            done = carry[-1] < thresh
            new = tuple(torch.where(done, old, nw)
                        for old, nw in zip(carry, new))
        carry = new
    return carry


def _max_abs(*xs) -> torch.Tensor:
    return torch.stack([x.abs().max() for x in xs]).max()


def warm_start(bodies: Bodies, contacts: Contacts,
               joints: Optional[XlaJoints] = None) -> Bodies:
    """Apply the cached accumulated impulses before the passes; joint warm
    impulses after the contacts' (the kernels' order): revolute re-applies
    its 2D impulse, distance its scalar along the current axis."""
    c = contacts
    t = m2.perp(c.normal)
    imp = c.normal * c.warm_n[:, None] + t * c.warm_t[:, None]
    imp = torch.where(c.valid[:, None], imp, 0.0)
    v = _apply(_body_table(bodies.vel, bodies.angvel),
               _rows(bodies, c.b1, c.b2, c.r1, c.r2), imp, True)
    if joints is not None:
        j = joints
        g = _joint_geom(bodies, j)
        p = torch.where(g.is_rev, j.warm, g.n * j.warm[:, 0:1])
        p = torch.where(j.valid[:, None], p, 0.0)
        v = _apply(v, g.rows, p, True)
    return bodies.replace(vel=v[:, 0:2], angvel=v[:, 2])


def solve_velocity(bodies: Bodies, contacts: Contacts, cfg: SimConfig,
                   joints: Optional[XlaJoints] = None):
    """The velocity passes.  Returns (bodies', accum_n, accum_t, residual):
    the residual is the max |impulse delta| of the last executed pass.
    With ``joints``, joint colors sweep after the contact colors of every
    pass and the (J, 2) joint accumulator is appended to the tuple.

    A row changes only in its own color's sweep, so the pass's residual is
    taken once, from each row's sum of its per-sweep deltas (all zero but
    one), instead of a max after every sweep."""
    c = contacts
    k = cfg.num_colors
    nt = torch.stack([c.normal, m2.perp(c.normal)], dim=1)   # (C, 2, 2)
    neg_mass_t = -c.mass_t
    rows = _rows(bodies, c.b1, c.b2, c.r1, c.r2)
    masks = _color_masks(c.valid, c.color, k)
    if joints is not None:
        j = joints
        g = _joint_geom(bodies, j)
        neg_m11 = -g.m11
        jmasks = _color_masks(j.valid, j.color, k)
        # a distance joint keeps its scalar impulse in column 0
        col0 = torch.arange(2, device=j.valid.device) == 0
        jmasks0 = [m[:, None] & col0 for m in jmasks]

    def color_sweep(col, v, an, at, d_nt):
        mask = masks[col]
        # one relative-velocity evaluation: the tangent velocity after the
        # normal impulse follows from the coupling c_nt (solver.prepare)
        vn, vt = _sum2(nt * _rel(v, rows).unsqueeze(1)).unbind(1)
        d = (c.dst_v - vn) * c.mass_n
        dn = torch.where(mask, (an + d).clamp_(min=0.0) - an, 0.0)
        an = an + dn
        d = (vt + c.c_nt * dn) * neg_mass_t
        max_f = c.friction * an
        dt = torch.where(mask, (at + d).clamp_(-max_f, max_f) - at, 0.0)
        at = at + dt
        dnt = torch.stack([dn, dt], dim=1)
        imp = _sum2((nt * dnt.unsqueeze(2)).transpose(1, 2))  # n dn + t dt
        v = _apply(v, rows, imp, col == k - 1)
        return v, an, at, d_nt + dnt

    def joint_color_sweep(col, v, jan, jp):
        mask = jmasks[col].unsqueeze(1)
        dv = _rel(v, g.rows)
        # revolute: p = -(M @ dv); distance: p = -(m * n.dv) * n
        dd = neg_m11 * _sum2(g.n * dv).unsqueeze(1)
        p = torch.where(g.is_rev, -_sum2(g.m * dv.unsqueeze(1)), g.n * dd)
        p = torch.where(mask, p, 0.0)
        jan = jan + torch.where(g.is_rev, p,
                                torch.where(jmasks0[col], dd, 0.0))
        v = _apply(v, g.rows, p, col == k - 1)
        return v, jan, jp + p

    def run(carry):
        v, an, at, jan, _ = carry
        d_nt = torch.zeros((an.shape[0], 2), dtype=torch.float32,
                           device=an.device)
        for col in range(k):
            v, an, at, d_nt = color_sweep(col, v, an, at, d_nt)
        if joints is None:
            return v, an, at, jan, d_nt.abs().max()
        jp = torch.zeros_like(jan)
        for col in range(k):
            v, jan, jp = joint_color_sweep(col, v, jan, jp)
        return v, an, at, jan, _max_abs(d_nt, jp)

    gated = cfg.velocity_tol > 0.0 or cfg.velocity_rel_tol > 0.0
    vthresh = velocity_threshold(
        cfg, contacts, joints.warm if joints is not None else None)
    if joints is not None:
        jan0 = joints.warm * torch.cat(
            [torch.ones_like(g.is_rev, dtype=torch.float32),
             g.is_rev.float()], dim=1)
    else:
        jan0 = torch.zeros((0, 2), dtype=torch.float32,
                           device=c.valid.device)
    v, an, at, jan, res = _passes(
        cfg.velocity_iterations, gated, vthresh,
        (_body_table(bodies.vel, bodies.angvel), c.warm_n, c.warm_t, jan0,
         torch.zeros((), dtype=torch.float32, device=c.valid.device)), run)
    out = bodies.replace(vel=v[:, 0:2], angvel=v[:, 2])
    if joints is not None:
        return out, an, at, res, jan
    return out, an, at, res


def solve_position(bodies: Bodies, contacts: Contacts, cfg: SimConfig,
                   joints: Optional[XlaJoints] = None) -> Bodies:
    """The displacement passes on pseudo-velocities (split impulse): they
    land in ``dvel``/``dangvel``, which position integration consumes.
    With ``joints``, joint colors (anchor-error targets) sweep after the
    contact colors of every pass.  The residual, taken only when gated,
    is the velocity passes' (one sum of per-sweep deltas a pass)."""
    c = contacts
    k = cfg.num_colors
    n = c.normal
    rows = _rows(bodies, c.b1, c.b2, c.r1, c.r2)
    masks = _color_masks(c.valid, c.color, k)
    if joints is not None:
        j = joints
        g = _joint_geom(bodies, j)
        jmasks = _color_masks(j.valid, j.color, k)
        # revolute target (dstx, dsty); distance target scalar along n
        jdst, jdst0 = j.rows[:, 7:9], j.rows[:, 7]
    gated = cfg.position_rel_tol > 0.0

    def color_sweep(col, dv, ad):
        d = (c.dst_dv - _sum2(n * _rel(dv, rows))) * c.mass_n
        d = torch.where(masks[col], (ad + d).clamp_(min=0.0) - ad, 0.0)
        dv = _apply(dv, rows, n * d.unsqueeze(1), col == k - 1)
        return dv, ad + d, d

    def joint_color_sweep(col, dv):
        rel = _rel(dv, g.rows)
        dd = (g.m11 * (jdst0 - _sum2(g.n * rel)).unsqueeze(1))
        p = torch.where(g.is_rev, _sum2(g.m * (jdst - rel).unsqueeze(1)),
                        g.n * dd)
        p = torch.where(jmasks[col].unsqueeze(1), p, 0.0)
        return _apply(dv, g.rows, p, col == k - 1), p

    def run(carry):
        dv, ad, _ = carry
        dsum = torch.zeros_like(ad)
        for col in range(k):
            dv, ad, d = color_sweep(col, dv, ad)
            if gated:
                dsum = dsum + d
        deltas = [dsum]
        if joints is not None:
            jp = torch.zeros_like(j.warm)
            for col in range(k):
                dv, p = joint_color_sweep(col, dv)
                if gated:
                    jp = jp + p
            deltas.append(jp)
        return dv, ad, _max_abs(*deltas) if gated else carry[-1]

    pthresh = position_threshold(
        cfg, contacts, joints.warm if joints is not None else None)
    dv, _, _ = _passes(
        cfg.position_iterations, gated, pthresh,
        (torch.zeros((bodies.capacity, 3), dtype=torch.float32,
                     device=c.valid.device),
         torch.zeros_like(c.warm_n),
         torch.zeros((), dtype=torch.float32, device=c.valid.device)), run)
    return bodies.replace(dvel=dv[:, 0:2], dangvel=dv[:, 2])
