"""The simulation step (``phyx_tpu/step.py``).

One frame, with no host round-trip:

    integrate velocities (gravity)
    -> broadphase (grid, or sweep & prune through K4 or K6/K7; static
       shapes)
    -> jointed-pair exclusion
    -> narrowphase (batched SAT + clip)
    -> contact-cache join (warm-start impulses carried across frames)
    -> prepare contacts and joint rows + the solve: valid-first
       compaction and a serial solve kernel, or the colored sweeps (warm
       start, velocity passes, displacement passes; contact rows, then
       joint rows)
    -> integrate positions (velocity + split-impulse pseudo-velocity)
    -> rebuild cache, emit stats

Every ``solver_backend`` is ported, with and without user joints.  Which
function the solve computes follows the reference
(``tiling.resolve_tiled``): the tiled tier where the reference
tiles (``pallas_tiled``, or bodies above its streamed budget, as the 20k
pile), through K3 on the slab-major pair buffer, or K5 on rows routed to
slab budgets for jointed scenes and ``tiled_routing=False``; elsewhere the
serial row order.  There one predicate picks the kernel
(``kernels/contact_solver.fits``): the fused kernel, whose body table and
accumulators sit in one block's shared memory, when they fit its 227 KB
(the 1k pile, the 1000-link chain); the streamed kernel, which keeps them
in device memory, otherwise (the 10k pile).  The two compute the same
thing bit for bit.  ``"xla"``, and the ``"pallas"`` configurations where
the reference falls back to it (``tiling.colored_fallback``), take the
colored solve: on-device coloring (``coloring``), then colored
Gauss-Seidel sweeps in torch ops (``solver.solve_velocity`` and
``solve_position``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyx_tpu_torch import math2d as m2
from phyx_tpu_torch import solver, tiling, tracing
from phyx_tpu_torch.broadphase import (Pairs, broadphase, compute_aabbs,
                                       lex_sort_pairs, rank_order)
from phyx_tpu_torch.cache import build_cache, lex_join, warm_start_from_cache
from phyx_tpu_torch.coloring import color_contacts, color_rows
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


def colored_rows(bodies: Bodies, contacts: Contacts, joints: Joints,
                 joint_rows, joint_warm, cfg: SimConfig):
    """The colored solve's rows (``phyx_tpu/step.py`` solve_stage's else
    branch): contacts and joint rows colored on the device, static bodies
    (both inverse masses 0) imposing no conflicts, joint endpoints clamped
    to the body capacity.  Returns (body_static, colored contacts,
    ``solver.XlaJoints`` or None where there are no joint slots)."""
    body_static = (bodies.inv_mass == 0.0) & (bodies.inv_inertia == 0.0)
    contacts = color_contacts(contacts, body_static, cfg)
    xj = None
    if joints.capacity:
        jvalid = joints.kind != 0
        nb = bodies.capacity - 1
        jb1 = torch.clamp(joints.b1, max=nb)
        jb2 = torch.clamp(joints.b2, max=nb)
        xj = solver.XlaJoints(
            rows=joint_rows, b1=jb1, b2=jb2, warm=joint_warm,
            color=color_rows(jb1, jb2, jvalid, body_static, cfg.num_colors),
            valid=jvalid)
    return body_static, contacts, xj


def solve_colored(bodies: Bodies, contacts: Contacts, joints: Joints,
                  joint_rows, joint_warm, cfg: SimConfig):
    """The colored solve: ``colored_rows``, then the warm start, the
    velocity and the displacement passes, joint colors after the contact
    colors.  Returns (bodies', accum_n, accum_t, residual, joints)."""
    _, contacts, xj = colored_rows(bodies, contacts, joints, joint_rows,
                                   joint_warm, cfg)
    bodies = solver.warm_start(bodies, contacts, xj)
    out = solver.solve_velocity(bodies, contacts, cfg, xj)
    bodies, accum_n, accum_t, residual = out[:4]
    if xj is not None:
        joints = joints.replace(accum=out[4])
    bodies = solver.solve_position(bodies, contacts, cfg, xj)
    return bodies, accum_n, accum_t, residual, joints


def solve_stage(bodies: Bodies, contacts: Contacts, pairs: Pairs,
                joints: Joints, joint_rows, joint_warm, cfg: SimConfig):
    """The solve, in the reference's branch order (``phyx_tpu/step.py``
    solve_stage): the tiled tier (K3 when the pairs carry slab-major
    routing and there are no joints, else K5, whose slab clamps and budget
    overflow are added to the pairs' counters); the colored solve for the
    colored fallback; else for ``"pallas"`` compaction, K2 or K1, and the
    accumulator un-permute, and for ``"xla"`` the colored solve.
    Returns (bodies', accum_n, accum_t, residual, joints with this frame's
    accumulated impulses, pairs)."""
    n = bodies.capacity
    c_cap = contacts.valid.shape[0]
    if tiling.resolve_tiled(cfg, n, c_cap):
        if pairs.routing is not None and joints.capacity == 0:
            bodies, accum_n, accum_t, residual = solver.solve_pallas_tiled2(
                bodies, contacts, pairs.routing, cfg)
            return bodies, accum_n, accum_t, residual, joints, pairs
        (bodies, accum_n, accum_t, residual, ovf,
         joint_accum) = solver.solve_pallas_tiled(
            bodies, contacts, rank_order(bodies, *compute_aabbs(bodies), cfg),
            cfg, joints if joints.capacity else None, joint_rows, joint_warm)
        pairs = pairs.replace(overflow=pairs.overflow + ovf,
                              ovf_slab=pairs.ovf_slab + ovf)
        if joints.capacity:
            joints = joints.replace(accum=joint_accum)
        return bodies, accum_n, accum_t, residual, joints, pairs
    if cfg.solver_backend == "pallas_tiled":
        raise ValueError(f"pallas_tiled needs the contact slots (2 x "
                         f"max_pairs = {c_cap}) in whole blocks of "
                         f"{tiling.BLK}, at least two")
    if (cfg.solver_backend == "xla"
            or tiling.colored_fallback(cfg, n, c_cap, joints.capacity)):
        return solve_colored(bodies, contacts, joints, joint_rows,
                             joint_warm, cfg) + (pairs,)
    compacted, order, num_live = compact_contacts(contacts)
    # the kernel predicate: the fused kernel when its state fits one
    # block's shared memory, else the streamed one
    fused = contact_solver.fits(n, c_cap + joints.capacity)
    (bodies, accum_n, accum_t, residual,
     joint_accum) = solver.solve_pallas(
        bodies, compacted, num_live, cfg, fused, joints, joint_rows,
        joint_warm)
    back = torch.zeros((order.shape[0], 2), dtype=torch.float32,
                       device=order.device)
    back[order] = torch.stack([accum_n, accum_t], dim=1)
    if joints.capacity:
        joints = joints.replace(accum=joint_accum)
    return bodies, back[:, 0], back[:, 1], residual, joints, pairs


def contact_stage(state: State, cfg: SimConfig, mark=None):
    """Everything before the solve: integrate velocities, broadphase,
    jointed-pair exclusion, narrowphase, warm start, prepare and the
    joints' rows.  Returns (bodies, pairs, prepared contacts, joint rows,
    joint warm impulses).  ``mark(stage)`` is called as each stage of
    ``profiling.STAGES`` ends (``profiling.STAGES_JOINTS`` on a scene with
    joint slots); None, the default, is the state's device's stage marks
    (``tracing.stage_marks``)."""
    if mark is None:
        mark = tracing.stage_marks(state.bodies.pos.device)
    bodies = integrate_velocities(state.bodies, cfg)
    mark("integrate")
    # jointed scenes: no slab-major routing (the jointed-pair exclusion
    # re-sorts the buffer; the jointed tiled solve is K5)
    pairs = broadphase(bodies, cfg, tiled_routing=False
                       if state.joints.capacity else None)
    if state.joints.capacity:
        pairs = exclude_joint_pairs(pairs, state.joints)
    mark("broadphase")
    contacts, pair_props = narrowphase_with_props(bodies, pairs, cfg)
    mark("narrowphase")
    contacts = warm_start_from_cache(contacts, pairs, state.cache)
    mark("cache_join")
    contacts = solver.prepare(contacts, cfg, pair_props)
    mark("prepare")
    joint_rows, joint_warm = prepare_joint_stage(bodies, state.joints, cfg)
    if state.joints.capacity:
        mark("joint_prepare")
    return bodies, pairs, contacts, joint_rows, joint_warm


def finish_stage(state: State, cfg: SimConfig, bodies: Bodies, joints,
                 pairs, contacts: Contacts, accum_n: torch.Tensor,
                 accum_t: torch.Tensor, residual: torch.Tensor,
                 mark=None) -> State:
    """Everything after the solve: integrate positions, rebuild the cache,
    emit stats; then ``mark("build_cache")`` (None, the default, is the
    state's device's stage marks, ``tracing.stage_marks``)."""
    if mark is None:
        mark = tracing.stage_marks(state.bodies.pos.device)
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
    out = State(bodies=bodies, joints=joints, cache=cache, stats=stats)
    mark("build_cache")
    return out


def step(state: State, cfg: SimConfig, mark=None) -> State:
    """One simulation frame: State -> State, no host round-trip.
    ``mark(stage)`` is called as each stage ends, in the order of
    ``profiling.STAGES`` (``STAGES_JOINTS`` on a scene with joint slots;
    their solve is the contacts and joints solved together).  None, the
    default, is the state's device's stage marks
    (``tracing.stage_marks``), which also mark the frame's start
    ("frame"): on the card a one-thread kernel a mark, captured with the
    frame into ``rollout``'s graph, read by ``tracing.last_frame_ms`` and
    in a profiler trace.  The stage profiler passes its own hook, which
    replaces them."""
    if mark is None:
        mark = tracing.stage_marks(state.bodies.pos.device)
        mark("frame")
    bodies, pairs, contacts, joint_rows, joint_warm = contact_stage(
        state, cfg, mark)
    bodies, accum_n, accum_t, residual, joints, pairs = solve_stage(
        bodies, contacts, pairs, state.joints, joint_rows, joint_warm, cfg)
    mark("solve")
    return finish_stage(state, cfg, bodies, joints, pairs, contacts,
                        accum_n, accum_t, residual, mark)


def rollout(state: State, cfg: SimConfig, num_steps: int) -> State:
    """``num_steps`` frames, in the role of the reference's ``lax.scan``
    under one jit.  On the CPU a loop of ``step``.  On the card a CUDA
    graph replay: the first call for a configuration runs one frame
    uncaptured (the warm-up, which builds every kernel the frame launches),
    captures one ``step`` (``_capture``) and replays it for the other
    frames; later calls copy the state in and replay every frame.  The
    replays chain on the device with no host work between frames.  Returns
    a copy: a state the caller keeps is never written by a later replay.
    A capture or replay that fails raises; nothing falls back to the
    loop.  The kernels' launch counts (``<wrapper>.launches``) count the
    warm-up frame; a replay launches from the graph, past every wrapper.
    The graphs of a device share K4's and K6's scan scratch
    (``kernels.sweep._scan_scratch``): replay them one at a time, on one
    stream or in turn."""
    return run_frames(state, (cfg, state.bodies.pos.device),
                      lambda s: step(s, cfg), num_steps)


def run_frames(state: State, key: tuple, frame, num_steps: int) -> State:
    """``num_steps`` frames of ``frame`` (State -> State, no host read):
    on the CPU a loop; on the card the replays of the frame captured under
    ``key`` (``graph_for``: the first call for a key and state layout runs
    one frame uncaptured and captures the next), returning a copy.  The
    graph replay of ``rollout``, of the sharded scene
    (``parallel.spatial``) and of the stacked batches
    (``parallel.envs``).  Host spans (``tracing.span``): ``rollout``
    around the call, ``replay`` around the replays, ``copy_out`` around
    the copy."""
    with tracing.span("rollout"):
        if num_steps <= 0 or state.bodies.pos.device.type != "cuda":
            for _ in range(num_steps):
                state = frame(state)
            return state
        graph, done = graph_for(state, key, lambda: (frame, None))
        with tracing.span("replay"):
            for _ in range(num_steps - done):
                graph.graph.replay()
        with tracing.span("copy_out"):
            return _map(graph.static, torch.clone)


@dataclasses.dataclass
class _Graph:
    """A captured frame: ``graph`` reads ``static`` and writes the frame's
    output back into it; ``pool_bytes`` the device memory its private pool took
    at capture (``torch.cuda.memory_reserved`` before and after)."""

    graph: "torch.cuda.CUDAGraph"
    static: State
    signature: tuple
    pool_bytes: int
    # what the frame keeps on the device beside the state (None for
    # ``step``; the guards' error record for ``debug.checked_rollout``)
    aux: object = None


# captured frames: (cfg, device) -> _Graph for ``rollout``'s step, and
# (cfg, device, name) for another frame of that configuration
_GRAPHS: dict = {}
# the stream each device captures on (a capture needs one of its own)
_STREAMS: dict = {}


def _leaves(state: State) -> list:
    return [getattr(getattr(state, rec.name), f.name)
            for rec in dataclasses.fields(state)
            for f in dataclasses.fields(getattr(state, rec.name))]


def _map(state: State, fn) -> State:
    return State(**{rec.name: getattr(state, rec.name).replace(**{
        f.name: fn(getattr(getattr(state, rec.name), f.name))
        for f in dataclasses.fields(getattr(state, rec.name))})
        for rec in dataclasses.fields(state)})


def _signature(state: State) -> tuple:
    """Every state tensor's shape and dtype, in field order."""
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(state))


def _copy_into(static: State, state: State) -> None:
    """``static``'s tensors take ``state``'s values.  A source that shares
    memory with a buffer of ``static`` (other than being that buffer) is
    copied aside first, so no copy reads what another has written."""
    dst = _leaves(static)
    taken = {t.untyped_storage().data_ptr() for t in dst}
    src = [s if s is d or s.untyped_storage().data_ptr() not in taken
           else s.clone() for d, s in zip(dst, _leaves(state))]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def graph_for(state: State, key: tuple, make_frame) -> tuple:
    """The captured frame under ``key`` (``(cfg, device)`` or ``(cfg,
    device, name)``) holding ``state``: where one is held with the same
    tensor shapes and dtypes, ``state`` is copied into its buffers and
    (graph, 0) returned; else the key's graph is freed, ``make_frame()``
    gives (frame function, aux), ``_capture`` runs its warm-up frame and
    captures it, and (graph, 1) is returned (the warm-up is the call's
    first frame, whose output the buffers hold).  Host spans
    (``tracing.span``): ``copy_in`` around the signature check and the
    copy, ``capture`` around a capture."""
    with tracing.span("copy_in"):
        sig = _signature(state)
        graph = _GRAPHS.get(key)
        held = graph is not None and graph.signature == sig
        if held:
            _copy_into(graph.static, state)
    if held:
        return graph, 0
    with tracing.span("capture"):
        _release(key)
        frame, aux = make_frame()
        graph = _GRAPHS[key] = _capture(state, frame, sig, aux)
    return graph, 1


def _capture(state: State, frame, signature: tuple, aux=None) -> _Graph:
    """One uncaptured ``frame(state)`` on the device's capture stream (the
    warm-up: it builds the frame's kernels before capture, since a build
    must not run inside one, and makes K4's and K6's scan scratch for that
    stream, which the captured launches then use), its output copied into
    buffers of its own; then one ``frame`` of those buffers captured with
    the copy of its output back into them.  ``frame`` maps a State to the
    next one; whatever else it writes (``aux``) must be device memory
    made before the call."""
    dev = state.bodies.pos.device
    cur = torch.cuda.current_stream(dev)
    side = _STREAMS.get(dev)
    if side is None:
        side = _STREAMS[dev] = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        static = _map(frame(state), torch.clone)
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            _copy_into(static, frame(static))
        except BaseException:
            # end the capture so the stream is usable, then raise the fault
            try:
                graph.capture_end()
            except RuntimeError:
                pass
            raise
        graph.capture_end()
        pool = torch.cuda.memory_reserved(dev) - reserved
    cur.wait_stream(side)
    return _Graph(graph=graph, static=static, signature=signature,
                  pool_bytes=pool, aux=aux)


def _release(key: tuple) -> None:
    graph = _GRAPHS.pop(key, None)
    if graph is not None:
        torch.cuda.current_stream(key[1]).synchronize()


def release_graphs(cfg: SimConfig = None, device=None) -> None:
    """Frees the captured frames of ``cfg`` (every configuration where
    None) on ``device`` (every device where None), ``rollout``'s and
    ``debug.checked_rollout``'s, once the device has finished their
    replays (the current stream is waited for)."""
    for key in [k for k in _GRAPHS
                if (cfg is None or k[0] == cfg)
                and (device is None or k[1] == torch.device(device))]:
        _release(key)


def graph_info() -> list:
    """Each captured frame: its configuration, device, frame ("step" for
    ``rollout``'s, else the name in its key) and private pool bytes."""
    return [dict(cfg=k[0], device=str(k[1]),
                 frame=k[2] if len(k) > 2 else "step",
                 pool_bytes=g.pool_bytes)
            for k, g in _GRAPHS.items()]


def stats_dict(stats: SolverStats) -> dict:
    """Host copy of the counters (one device read each; not for the hot
    loop)."""
    return {f.name: getattr(stats, f.name).item()
            for f in dataclasses.fields(stats)}


def solve_inputs(state: State, cfg: SimConfig, path=None) -> dict:
    """The solve kernel's arguments for the frame ``step(state, cfg)``
    would run (for comparing the kernels with their plain version).
    ``path`` names the solve: "rows" (K1 and K2, on the compacted
    contacts), "tiled2" (K3, on the slab-major pairs) or "tiled" (K5);
    None = the one the step takes."""
    bodies, pairs, contacts, joint_rows, joint_warm = contact_stage(
        state, cfg)
    if path is None:
        path = "rows"
        if tiling.resolve_tiled(cfg, bodies.capacity,
                                contacts.valid.shape[0]):
            path = ("tiled2" if pairs.routing is not None
                    and state.joints.capacity == 0 else "tiled")
    if path == "tiled2":
        return solver.pack_tiled2(bodies, contacts, pairs.routing, cfg)
    joints = state.joints if state.joints.capacity else None
    if path == "tiled":
        return solver.pack_tiled(
            bodies, contacts, rank_order(bodies, *compute_aabbs(bodies), cfg),
            cfg, joints, joint_rows, joint_warm)[0]
    compacted, _, num_live = compact_contacts(contacts)
    return solver.pack_rows(bodies, compacted, num_live, cfg, state.joints,
                            joint_rows, joint_warm)
