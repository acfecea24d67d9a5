"""The simulation step (``phyx_tpu/step.py``).

One frame, with no host round-trip:

    integrate velocities (gravity)
    -> broadphase (grid sweep & prune, static shapes)
    -> jointed-pair exclusion
    -> narrowphase (batched SAT + clip)
    -> contact-cache join (warm-start impulses carried across frames)
    -> prepare contacts and joint rows + valid-first compaction + serial
       solve kernel (warm start, velocity passes, displacement passes;
       contact rows, then joint rows)
    -> integrate positions (velocity + split-impulse pseudo-velocity)
    -> rebuild cache, emit stats

Ported so far: ``solver_backend="pallas"``, with and without user joints.
One predicate picks the kernel (``kernels/contact_solver.fits``): the
fused kernel, whose body table and accumulators sit in one block's shared
memory, when they fit its 227 KB (the 1k pile, the 1000-link chain); the
streamed kernel, which keeps them in device memory, otherwise (the 10k
pile).  The two compute the same thing bit for bit.  The reference's TPU
budget tiers do not carry over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch import solver
from phyx_tpu_torch.broadphase import Pairs, broadphase, lex_sort_pairs
from phyx_tpu_torch.cache import build_cache, lex_join, warm_start_from_cache
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.joints import prepare_joint_rows
from phyx_tpu_torch.kernels import contact_solver
from phyx_tpu_torch.narrowphase import Contacts, narrowphase_with_props
from phyx_tpu_torch.types import EMPTY, Bodies, Joints, SolverStats, State

# the fields the solve reads, permuted together by the compaction.  `valid`
# keeps the original order, as in the reference (step.py:246-255): the
# relative gates' impulse scale masks the permuted warm impulses with it
# (ROADMAP queue 3)
_SOLVE_FIELDS = ("b1", "b2", "normal", "r1", "r2", "mass_n", "mass_t",
                 "friction", "dst_v", "dst_dv", "c_nt", "warm_n", "warm_t")


def integrate_velocities(bodies: Bodies, cfg: SimConfig) -> Bodies:
    # g * dt rounded in float32, as the reference computes it
    gdt = np.float32(cfg.gravity) * np.float32(cfg.dt)
    g = torch.stack([torch.full_like(bodies.angvel[:1], float(v))
                     for v in gdt], dim=-1)
    dynamic = (bodies.inv_mass > 0.0) & bodies.active
    vel = torch.where(dynamic[:, None], bodies.vel + g, bodies.vel)
    return bodies.replace(vel=vel)


def integrate_positions(bodies: Bodies, cfg: SimConfig) -> Bodies:
    dynamic = (bodies.inv_mass > 0.0) & bodies.active
    pos = torch.where(dynamic[:, None],
                      bodies.pos + bodies.vel * cfg.dt + bodies.dvel,
                      bodies.pos)
    dw = bodies.angvel * cfg.dt + bodies.dangvel
    rot = torch.where(dynamic[:, None], m2.rot_advance(bodies.rot, dw),
                      bodies.rot)
    return bodies.replace(pos=pos, rot=rot,
                          dvel=torch.zeros_like(bodies.dvel),
                          dangvel=torch.zeros_like(bodies.dangvel))


def exclude_joint_pairs(pairs: Pairs, joints: Joints) -> Pairs:
    """Drop candidate pairs whose bodies a user joint connects (collide
    connected = false): their contacts would fight the joint.  The pair
    buffer is re-sorted with the dropped slots at EMPTY, last, and ``num``
    shrinks by the number dropped, as in the reference."""
    live = joints.kind != 0
    empty = torch.full_like(joints.b1, EMPTY)
    ja = torch.where(live, torch.minimum(joints.b1, joints.b2), empty)
    jb = torch.where(live, torch.maximum(joints.b1, joints.b2), empty)
    _, hit = lex_join(ja, jb, pairs.pi, pairs.pj)
    pi = torch.where(hit, EMPTY, pairs.pi)
    pj = torch.where(hit, EMPTY, pairs.pj)
    pi, pj = lex_sort_pairs(pi, pj)
    return pairs.replace(pi=pi, pj=pj, valid=pi != EMPTY,
                         num=pairs.num - hit.sum(dtype=torch.int32))


def compact_contacts(contacts: Contacts):
    """Live contacts first, in their original order (a stable sort), so the
    kernel visits only live rows in the reference's sweep order.  Returns
    (compacted contacts, order, live count); only the solve's fields are
    permuted — valid, penetration, fid and color keep the original
    order."""
    order = torch.argsort((~contacts.valid).to(torch.int32), stable=True)
    compacted = contacts.replace(**{
        f: getattr(contacts, f)[order] for f in _SOLVE_FIELDS})
    return compacted, order, contacts.valid.sum(dtype=torch.int32)


def prepare_joint_stage(bodies: Bodies, joints: Joints, cfg: SimConfig):
    """The joints' solver rows and warm impulses from the bodies after
    velocity integration; (None, None) for a scene without joint slots."""
    if joints.capacity == 0:
        return None, None
    return prepare_joint_rows(bodies, joints, cfg)


def solve_stage(bodies: Bodies, contacts: Contacts, joints: Joints,
                joint_rows, joint_warm, cfg: SimConfig):
    """Compaction + the serial solve (contacts, then joint rows) + the
    accumulator un-permute.  Returns (bodies', accum_n, accum_t, residual,
    joints with this frame's accumulated impulses)."""
    if cfg.solver_backend != "pallas":
        raise NotImplementedError(
            f"solver_backend={cfg.solver_backend!r} is not ported yet: "
            "ROADMAP M10 (xla, the colored backend) / M11 (pallas_tiled)")
    compacted, order, num_live = compact_contacts(contacts)
    # the tier predicate: the fused kernel when its state fits one block's
    # shared memory, else the streamed one
    fused = contact_solver.fits(bodies.capacity,
                                order.shape[0] + joints.capacity)
    (bodies, accum_n, accum_t, residual,
     joint_accum) = solver.solve_pallas(
        bodies, compacted, num_live, cfg, fused, joints, joint_rows,
        joint_warm)
    back = torch.zeros((order.shape[0], 2), dtype=torch.float32,
                       device=order.device)
    back[order] = torch.stack([accum_n, accum_t], dim=1)
    if joints.capacity:
        joints = joints.replace(accum=joint_accum)
    return bodies, back[:, 0], back[:, 1], residual, joints


def contact_stage(state: State, cfg: SimConfig):
    """Everything before the solve: integrate velocities, broadphase,
    jointed-pair exclusion, narrowphase, warm start, prepare and the
    joints' rows.  Returns (bodies, pairs, prepared contacts, joint rows,
    joint warm impulses)."""
    bodies = integrate_velocities(state.bodies, cfg)
    pairs = broadphase(bodies, cfg)
    if state.joints.capacity:
        pairs = exclude_joint_pairs(pairs, state.joints)
    contacts, pair_props = narrowphase_with_props(bodies, pairs, cfg)
    contacts = warm_start_from_cache(contacts, pairs, state.cache)
    contacts = solver.prepare(contacts, cfg, pair_props)
    joint_rows, joint_warm = prepare_joint_stage(bodies, state.joints, cfg)
    return bodies, pairs, contacts, joint_rows, joint_warm


def finish_stage(state: State, cfg: SimConfig, bodies: Bodies, joints,
                 pairs, contacts: Contacts, accum_n: torch.Tensor,
                 accum_t: torch.Tensor, residual: torch.Tensor) -> State:
    """Everything after the solve: integrate positions, rebuild the cache,
    emit stats."""
    bodies = integrate_positions(bodies, cfg)
    cache = build_cache(contacts, pairs, accum_n, accum_t)
    stats = SolverStats(
        num_pairs=pairs.num,
        num_contacts=contacts.valid.sum(dtype=torch.int32),
        pair_overflow=pairs.overflow,
        max_penetration=torch.where(contacts.valid, contacts.penetration,
                                    0.0).max(),
        residual=residual,
        halo_overflow=state.stats.halo_overflow,
        ovf_window=pairs.ovf_window,
        ovf_slots=pairs.ovf_slots,
        ovf_drop=pairs.ovf_drop,
        ovf_band=pairs.ovf_band,
        ovf_slab=pairs.ovf_slab,
    )
    return State(bodies=bodies, joints=joints, cache=cache, stats=stats)


def step(state: State, cfg: SimConfig) -> State:
    """One simulation frame: State -> State, no host round-trip."""
    bodies, pairs, contacts, joint_rows, joint_warm = contact_stage(
        state, cfg)
    bodies, accum_n, accum_t, residual, joints = solve_stage(
        bodies, contacts, state.joints, joint_rows, joint_warm, cfg)
    return finish_stage(state, cfg, bodies, joints, pairs, contacts,
                        accum_n, accum_t, residual)


def rollout(state: State, cfg: SimConfig, num_steps: int) -> State:
    """``num_steps`` frames.  A plain loop of ``step``: each frame's work
    is queued on the device without waiting for the previous one."""
    for _ in range(num_steps):
        state = step(state, cfg)
    return state


def stats_dict(stats: SolverStats) -> dict:
    """Host copy of the counters (one device read each; not for the hot
    loop)."""
    return {f.name: getattr(stats, f.name).item()
            for f in dataclasses.fields(stats)}


def solve_inputs(state: State, cfg: SimConfig) -> dict:
    """The solve kernel's arguments for the frame ``step(state, cfg)``
    would run (for comparing the kernels with their plain version)."""
    bodies, _, contacts, joint_rows, joint_warm = contact_stage(state, cfg)
    compacted, _, num_live = compact_contacts(contacts)
    return solver.pack_rows(bodies, compacted, num_live, cfg, state.joints,
                            joint_rows, joint_warm)
