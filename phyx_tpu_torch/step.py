"""The simulation step (``phyx_tpu/step.py``).

One frame, with no host round-trip:

    integrate velocities (gravity)
    -> broadphase (grid sweep & prune, static shapes)
    -> narrowphase (batched SAT + clip)
    -> contact-cache join (warm-start impulses carried across frames)
    -> prepare + valid-first compaction + serial solve kernel (warm start,
       velocity passes, displacement passes)
    -> integrate positions (velocity + split-impulse pseudo-velocity)
    -> rebuild cache, emit stats

Ported so far: ``solver_backend="pallas"`` for scenes without joints.  Every
capacity goes to the one serial solve kernel: it keeps the body table in
device memory, so the reference's on-chip budget tiers (fused, streamed,
tiled) have no counterpart here — the fused and streamed kernels compute
the same thing bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch import solver
from phyx_tpu_torch.broadphase import broadphase
from phyx_tpu_torch.cache import build_cache, warm_start_from_cache
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.narrowphase import Contacts, narrowphase_with_props
from phyx_tpu_torch.types import Bodies, SolverStats, State

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


def solve_stage(bodies: Bodies, contacts: Contacts, cfg: SimConfig):
    """Compaction + the serial solve + the accumulator un-permute.
    Returns (bodies', accum_n, accum_t, residual)."""
    if cfg.solver_backend != "pallas":
        raise NotImplementedError(
            f"solver_backend={cfg.solver_backend!r} is not ported yet: "
            "ROADMAP M10 (xla, the colored backend) / M11 (pallas_tiled)")
    compacted, order, num_live = compact_contacts(contacts)
    bodies, accum_n, accum_t, residual = solver.solve_pallas(
        bodies, compacted, num_live, cfg)
    back = torch.zeros((order.shape[0], 2), dtype=torch.float32,
                       device=order.device)
    back[order] = torch.stack([accum_n, accum_t], dim=1)
    return bodies, back[:, 0], back[:, 1], residual


def contact_stage(state: State, cfg: SimConfig):
    """Everything before the solve: integrate velocities, broadphase,
    narrowphase, warm start and prepare.  Returns (bodies, pairs,
    prepared contacts)."""
    if state.joints.capacity:
        raise NotImplementedError("scenes with joints are not ported yet: "
                                  "ROADMAP M9")
    bodies = integrate_velocities(state.bodies, cfg)
    pairs = broadphase(bodies, cfg)
    contacts, pair_props = narrowphase_with_props(bodies, pairs, cfg)
    contacts = warm_start_from_cache(contacts, pairs, state.cache)
    contacts = solver.prepare(contacts, cfg, pair_props)
    return bodies, pairs, contacts


def finish_stage(state: State, cfg: SimConfig, bodies: Bodies, pairs,
                 contacts: Contacts, accum_n: torch.Tensor,
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
    return State(bodies=bodies, joints=state.joints, cache=cache,
                 stats=stats)


def step(state: State, cfg: SimConfig) -> State:
    """One simulation frame: State -> State, no host round-trip."""
    bodies, pairs, contacts = contact_stage(state, cfg)
    bodies, accum_n, accum_t, residual = solve_stage(bodies, contacts, cfg)
    return finish_stage(state, cfg, bodies, pairs, contacts, accum_n,
                        accum_t, residual)


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
    would run (for comparing the kernel with its plain version)."""
    bodies, _, contacts = contact_stage(state, cfg)
    compacted, _, num_live = compact_contacts(contacts)
    return solver.pack_streamed(bodies, compacted, num_live, cfg)
