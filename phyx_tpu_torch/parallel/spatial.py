"""Spatial decomposition of ONE scene into x-bands with a halo exchange
(``phyx_tpu/parallel/spatial.py``).

A large scene is cut into D x-bands (shards).  Each shard runs the
unchanged ``step`` on its own body table, and the only traffic between
shards is the halo: each frame, every shard exports its H lowest-x and H
highest-x owned bodies to its left and right neighbours as read-only
copies.

Per-shard body table (capacity ``L = S + H + M + H``)::

    [ statics (S) | halo_L (H) | owned dynamics (M) | halo_R (H) ]

* Statics are copied to every shard: they never move, so a scene-wide
  ground needs no exchange and no owner.
* Ownership is fixed while a sharding lasts: ``shard_spatial`` sorts the
  dynamic bodies by x and deals them to shards in contiguous runs.  A body
  that drifts across a cut is still integrated by its own shard; the halo
  keeps its contacts.  ``rebalance`` re-deals by current x between chunks.
* Joint-connected components are dealt whole (union-find on the host), so
  every joint is shard-local; a component above one shard's fair share
  (``ceil(dynamics / D)``) raises.
* The halo is chosen every frame from current positions, its rows ordered
  by owner slot, so halo slots stay put while the exported set does and
  the shard-local contact cache keeps warm-starting cut contacts.

A contact across a cut exists on both neighbouring shards and is solved on
each (additive-Schwarz coupling: Gauss-Seidel within a band, Jacobi-like
across cuts).  A cut pair that neither side exported is lost, and counted:
each frame every shard compares the x-reach of its unexported bodies with
its neighbours' and writes the count into ``stats.halo_overflow``; grow H
(``suggest_halo``) and ``rebalance`` when it is not 0.

The shards share the state's one device: every leaf carries the leading
shard axis D, the halo moves by a shift along that axis, and the shards'
steps run in turn.  On the card a whole D-shard frame is one captured CUDA
graph (``step.run_frames``).  This is the reference's layout, so
``convert.state_from_numpy`` and ``state_to_numpy`` carry a sharded state
across unchanged.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from phyx_tpu_torch.broadphase import compute_aabbs
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.parallel.envs import each
from phyx_tpu_torch.step import run_frames, step
from phyx_tpu_torch.types import (Bodies, ContactCache, Joints, SolverStats,
                                  State, parked_positions)

# stats reduced across shards by the maximum; every other one is summed
_MAX_STATS = ("max_penetration", "residual")


class SpatialDims(NamedTuple):
    """Layout of the per-shard body table."""
    D: int   # number of shards
    S: int   # replicated static slots
    H: int   # halo capacity per side
    M: int   # owned dynamic slots per shard


@dataclasses.dataclass(frozen=True)
class SpatialMeta:
    """Host bookkeeping that maps shard-local rows back to global ids."""
    dims: SpatialDims
    static_ids: np.ndarray   # (S,) global body ids of replicated statics
    owned_ids: np.ndarray    # (D, M) global body ids, -1 = padding
    capacity: int            # original global body capacity
    # global joint index per shard-local joint slot
    owned_joint_ids: Optional[np.ndarray] = None   # (D, Jloc), -1 = pad
    joint_capacity: int = 0  # original global joint capacity


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def suggest_halo(state: State, n_shards: int, margin: float = 2.0) -> int:
    """Halo size from the scene: the most dynamic bodies within one
    interaction diameter (4 x the largest half extent) of any equal-count
    x-cut, times ``margin``, rounded up to a multiple of 8 (at least 8)."""
    b = state.bodies
    pos, he = _host(b.pos), _host(b.half_extent)
    dyn = _host(b.active) & (_host(b.inv_mass) > 0.0)
    x = np.sort(pos[dyn, 0])
    if x.size == 0 or n_shards < 2:
        return 8
    diam = 4.0 * float(he[dyn].max())
    cuts = [x[min((k * x.size) // n_shards, x.size - 1)]
            for k in range(1, n_shards)]
    worst = max(int(((x > c - diam) & (x < c + diam)).sum()) for c in cuts)
    return max(8, int(-(-worst * margin // 8) * 8))


def _deal(arrs: dict, dyn_ids: np.ndarray, dyn_mask: np.ndarray,
          jarrs: Optional[dict], live_j: np.ndarray, capacity: int, D: int):
    """Joint-connected components (union-find over dynamic endpoints) and
    singletons, in mean-x order, dealt first-fit to D shards of M slots.
    Returns (owned (D, M) global ids with -1 pads, body id -> shard)."""
    parent = np.arange(capacity, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:      # path compression
            parent[i], i = root, parent[i]
        return root

    for j in live_j:
        e1, e2 = int(jarrs["b1"][j]), int(jarrs["b2"][j])
        if dyn_mask[e1] and dyn_mask[e2]:
            parent[find(e1)] = find(e2)

    groups = defaultdict(list)
    for gid in dyn_ids:               # x-sorted: members stay x-sorted
        groups[find(gid)].append(int(gid))
    units = sorted(groups.values(),
                   key=lambda ids: float(arrs["pos"][ids, 0].mean()))
    maxu = max((len(u) for u in units), default=1)
    base_m = max(8, -(-int(dyn_ids.size) // D))
    if maxu > base_m:
        raise ValueError(
            f"joint-connected component of {maxu} bodies exceeds one "
            f"shard's fair share ({base_m} slots at {D} shards); use "
            f"fewer shards or the mega-scene path")
    # first-fit in x order always succeeds with maxu - 1 slack per shard
    M = base_m + (maxu - 1)
    owned = np.full((D, M), -1, np.int64)
    body_shard = {}
    d, fill = 0, 0
    for u in units:
        if fill + len(u) > M:
            d, fill = d + 1, 0
        assert d < D, "first-fit deal overflowed (cannot happen: slack)"
        owned[d, fill:fill + len(u)] = u
        for gid in u:
            body_shard[gid] = d
        fill += len(u)
    return owned, body_shard


def _shard_joints(jarrs: dict, live_j: np.ndarray, owned: np.ndarray,
                  body_shard: dict, static_ids: np.ndarray, S: int, H: int):
    """Per-shard joint tables whose endpoints are local slots.  Returns
    ({field: (D, Jloc, ...) array}, owned joint ids (D, Jloc))."""
    D = owned.shape[0]
    static_local = {int(g): i for i, g in enumerate(static_ids)}
    local_slot = [dict(static_local) for _ in range(D)]
    for d in range(D):
        for s_, gid in enumerate(owned[d]):
            if gid >= 0:
                local_slot[d][int(gid)] = S + H + s_
    per_shard = [[] for _ in range(D)]
    for j in live_j:
        e1, e2 = int(jarrs["b1"][j]), int(jarrs["b2"][j])
        d1, d2 = body_shard.get(e1), body_shard.get(e2)
        if d1 is not None and d2 is not None and d1 != d2:
            raise AssertionError("joint endpoints dealt to different shards "
                                 "(cannot happen: union-find)")
        per_shard[d1 if d1 is not None else
                  (d2 if d2 is not None else 0)].append(int(j))
    jloc = max(8, max(len(p) for p in per_shard))
    owned_joints = np.full((D, jloc), -1, np.int64)
    for d in range(D):
        owned_joints[d, :len(per_shard[d])] = per_shard[d]

    def leaf(name: str, x: np.ndarray) -> np.ndarray:
        out = np.zeros((D, jloc) + x.shape[1:], x.dtype)
        for d in range(D):
            for slot, j in enumerate(owned_joints[d]):
                if j < 0:
                    continue
                v = x[j]
                if name in ("b1", "b2"):
                    v = local_slot[d][int(v)]
                out[d, slot] = v
        return out

    return {k: leaf(k, v) for k, v in jarrs.items()}, owned_joints


def _repeated(rec, D: int):
    """A record with every leaf repeated on a new leading axis of D."""
    return rec.replace(**{
        f.name: getattr(rec, f.name).unsqueeze(0).expand(
            (D,) + tuple(getattr(rec, f.name).shape)).clone()
        for f in dataclasses.fields(rec)})


def shard_spatial(state: State, cfg: SimConfig, n_shards: int, halo: int,
                  max_pairs_per_shard: Optional[int] = None,
                  ) -> Tuple[State, SimConfig, SpatialMeta]:
    """Cut ``state`` into ``n_shards`` x-bands (on the host, in NumPy).

    Returns ``(sstate, local_cfg, meta)``: every leaf of ``sstate``
    carries a leading shard axis D and lies on ``state``'s device;
    ``local_cfg`` is the per-shard configuration (``max_bodies`` L,
    ``max_pairs`` ``max_pairs_per_shard``, by default ``max(256,
    ceil(max_pairs / D))``, and the shard-local joint slots) to pass to
    ``spatial_rollout``.  The contact caches start empty.  Joint-connected
    components are dealt whole; one above a shard's fair share raises
    ``ValueError``.

    The default budget is the reference's.  Where it leaves a shard's
    contact slots (2 x its pairs) out of whole 1024-slot blocks, a
    ``"pallas"`` shard above the streamed budget (L > 23,680) runs the
    colored solve and no solve kernel; pass ``max_pairs_per_shard=
    tiling.block_pair_budget(ceil(max_pairs / D))`` for the tiled one."""
    D, H = int(n_shards), int(halo)
    device = state.bodies.pos.device
    b = state.bodies
    arrs = {f.name: _host(getattr(b, f.name)) for f in dataclasses.fields(b)}
    act = arrs["active"]
    static_mask = act & (arrs["inv_mass"] == 0.0) & (arrs["inv_inertia"] == 0.0)
    dyn_mask = act & ~static_mask
    static_ids = np.nonzero(static_mask)[0]
    dyn_ids = np.nonzero(dyn_mask)[0]
    dyn_ids = dyn_ids[np.argsort(arrs["pos"][dyn_ids, 0], kind="stable")]
    S = int(static_ids.size)

    jarrs, live_j = None, np.zeros((0,), np.int64)
    if state.joints.capacity:
        jarrs = {f.name: _host(getattr(state.joints, f.name))
                 for f in dataclasses.fields(state.joints)}
        live_j = np.nonzero(jarrs["kind"] != 0)[0]
    owned, body_shard = _deal(arrs, dyn_ids, dyn_mask, jarrs, live_j,
                              b.capacity, D)
    M = owned.shape[1]
    dims = SpatialDims(D=D, S=S, H=H, M=M)
    L = S + 2 * H + M
    park = parked_positions(L)

    def shard_leaf(name: str, x: np.ndarray) -> np.ndarray:
        out = np.zeros((D, L) + x.shape[1:], x.dtype)
        if name == "pos":
            out[:] = park[None]
        if name == "rot":
            out[..., 0] = 1.0
        if name == "half_extent":
            out[:] = 1.0
        for d in range(D):
            out[d, :S] = x[static_ids]
            ids = owned[d]
            ok = ids >= 0
            out[d, S + H:S + H + M][ok] = x[ids[ok]]
        return out

    bodies = Bodies(**{k: torch.from_numpy(shard_leaf(k, v)).to(device)
                       for k, v in arrs.items()})
    if max_pairs_per_shard is None:
        max_pairs_per_shard = max(256, -(-cfg.max_pairs // D))

    owned_joints, jloc = None, 0
    if live_j.size:
        jleaves, owned_joints = _shard_joints(jarrs, live_j, owned,
                                              body_shard, static_ids, S, H)
        jloc = owned_joints.shape[1]
        joints = Joints(**{k: torch.from_numpy(v).to(device)
                           for k, v in jleaves.items()})
    else:
        joints = _repeated(Joints.empty(0, device), D)

    local_cfg = cfg.replace(max_bodies=L, max_pairs=int(max_pairs_per_shard),
                            max_joints=jloc)
    sstate = State(bodies=bodies, joints=joints,
                   cache=_repeated(ContactCache.empty(
                       int(max_pairs_per_shard), device), D),
                   stats=_repeated(SolverStats.zeros(device), D))
    meta = SpatialMeta(dims=dims, static_ids=static_ids, owned_ids=owned,
                       capacity=b.capacity, owned_joint_ids=owned_joints,
                       joint_capacity=state.joints.capacity)
    return sstate, local_cfg, meta


def _from_left(x: torch.Tensor, edge) -> torch.Tensor:
    """Shard d receives shard d - 1's ``x``, shard 0 the value ``edge``:
    the shift along the shard axis that stands for the exchange with the
    left neighbour."""
    return torch.cat([torch.full_like(x[:1], edge), x[:-1]], dim=0)


def _from_right(x: torch.Tensor, edge) -> torch.Tensor:
    """Shard d receives shard d + 1's ``x``, the last shard ``edge``."""
    return torch.cat([x[1:], torch.full_like(x[:1], edge)], dim=0)


def _exchange_halo(b: Bodies, dims: SpatialDims) -> Tuple[Bodies,
                                                           torch.Tensor]:
    """Refresh every shard's halo slots from its neighbours.  ``b`` is the
    stacked (D, L) body table.  Returns (bodies, halo_overflow (D,) int32).

    Each shard exports its H lowest-x and H highest-x owned rows (a stable
    argsort of x with inactive rows at +inf / -inf, as the reference's),
    in owner-slot order; shard d's ``halo_L`` is shard d - 1's right
    export and its ``halo_R`` shard d + 1's left export; the mesh edges
    receive zero rows, and every inactive row is re-parked.  Slot
    stability holds while the exported set is stable: the frame it
    changes, a halo slot can hold another body while the shard's cache
    still joins on local ids, so a cut contact whose feature ids coincide
    warm-starts from the previous occupant's impulse for that one frame.

    The overflow count: a cut pair is lost only when neither body was
    exported.  Each shard sends the extreme AABB x-reach of its unexported
    bodies toward each neighbour, and counts its own unexported bodies
    whose AABB x-interval reaches past its neighbours' (conservative in
    y, like the sweep's x-intervals)."""
    D, S, H, M = dims
    own = b.replace(**{f.name: getattr(b, f.name)[:, S + H:S + H + M]
                       for f in dataclasses.fields(b)})
    take = min(H, M)          # H > M: export everything + inactive pad
    rows = torch.arange(D, device=b.pos.device)[:, None]

    def edge(ids):
        ids = torch.sort(ids, dim=1).values  # owner-slot order
        out = {}
        for f in dataclasses.fields(own):
            a = getattr(own, f.name)[rows, ids]
            if take < H:
                a = torch.cat([a, torch.zeros((D, H - take) + a.shape[2:],
                                              dtype=a.dtype,
                                              device=a.device)], dim=1)
            out[f.name] = a
        return out

    x = own.pos[..., 0]
    inf = torch.full_like(x, float("inf"))
    idx_l = torch.argsort(torch.where(own.active, x, inf), dim=1,
                          stable=True)[:, :take]
    idx_r = torch.argsort(torch.where(own.active, x, -inf), dim=1,
                          stable=True)[:, M - take:]
    exp_l, exp_r = edge(idx_l), edge(idx_r)
    halo_l = {k: _from_left(v, 0) for k, v in exp_r.items()}
    halo_r = {k: _from_right(v, 0) for k, v in exp_l.items()}

    flat = own.replace(pos=own.pos.reshape(D * M, 2),
                       rot=own.rot.reshape(D * M, 2),
                       half_extent=own.half_extent.reshape(D * M, 2))
    lo, hi = (e[:, 0].reshape(D, M) for e in compute_aabbs(flat))
    unmarked = torch.zeros((D, M), dtype=torch.bool, device=x.device)
    mark_l = unmarked.scatter(1, idx_l, True)
    mark_r = unmarked.scatter(1, idx_r, True)
    un_l = own.active & ~mark_l
    un_r = own.active & ~mark_r
    # my unexported-right max reach -> right neighbour; min reach -> left
    reach_r = torch.where(un_r, hi, -inf).amax(dim=1)
    reach_l = torch.where(un_l, lo, inf).amin(dim=1)
    lreach = _from_left(reach_r, float("-inf"))
    rreach = _from_right(reach_l, float("inf"))
    halo_ovf = ((un_l & (lo <= lreach[:, None])).sum(dim=1, dtype=torch.int32)
                + (un_r & (hi >= rreach[:, None])).sum(dim=1,
                                                       dtype=torch.int32))

    merged = {f.name: torch.cat([
        getattr(b, f.name)[:, :S], halo_l[f.name],
        getattr(b, f.name)[:, S + H:S + H + M], halo_r[f.name]], dim=1)
        for f in dataclasses.fields(b)}
    # re-park rows that arrived inactive (zeros from the mesh edges, or
    # inactive neighbour slots): distinct far-away positions and unit
    # extents, so their AABBs never overlap anything real.  Made on the
    # device (``types.parked_positions``'s float32 values): a frame holds
    # no host-to-device copy, so it can be captured
    alive = merged["active"][..., None]
    pos, rot = merged["pos"], merged["rot"]
    park_x = (torch.arange(pos.shape[1], dtype=torch.float32,
                           device=x.device) * 16.0 + 1.0e7)
    park = torch.stack([park_x, torch.zeros_like(park_x)], dim=-1)
    unit = torch.stack([torch.ones_like(rot[..., 0]),
                        torch.zeros_like(rot[..., 1])], dim=-1)
    merged.update(
        pos=torch.where(alive, pos, park),
        rot=torch.where(alive, rot, unit),
        half_extent=torch.where(alive, merged["half_extent"], 1.0))
    return Bodies(**merged), halo_ovf


def reduce_stats(stats: SolverStats) -> SolverStats:
    """The cross-shard counters of stacked per-shard ``stats``: sums (cut
    contacts count on both sides: an upper bound), the maximum for
    ``max_penetration`` and ``residual``; every shard gets the reduced
    record."""
    out = {}
    for f in dataclasses.fields(stats):
        a = getattr(stats, f.name)
        r = (a.amax(dim=0) if f.name in _MAX_STATS
             else a.sum(dim=0, dtype=a.dtype))
        out[f.name] = r.expand(a.shape).clone()
    return SolverStats(**out)


def spatial_frame(sstate: State, local_cfg: SimConfig,
                  dims: SpatialDims) -> State:
    """One frame of the sharded scene (the frame ``spatial_rollout``
    captures): the halo exchange, each shard's ``step`` (its
    ``halo_overflow`` written first) in turn, the stats reduced across
    shards."""
    bodies, halo_ovf = _exchange_halo(sstate.bodies, dims)
    sstate = sstate.replace(bodies=bodies, stats=sstate.stats.replace(
        halo_overflow=halo_ovf))
    out = each(lambda s: step(s, local_cfg), sstate)
    return out.replace(stats=reduce_stats(out.stats))


def spatial_rollout(sstate: State, local_cfg: SimConfig, meta: SpatialMeta,
                    num_steps: int) -> State:
    """Advance the sharded scene ``num_steps`` frames (``spatial_frame``).

    The port has no mesh: the D shards share the state's one device and
    step in turn.  On the CPU a loop; on the card one whole D-shard frame
    is captured as one CUDA graph under ``(local_cfg, device, ("spatial",
    dims))`` and replayed (``step.run_frames``), as ``rollout`` replays a
    step; the key holds ``dims`` because two layouts can share every
    tensor shape.  A capture that fails raises.  Free an old layout's
    graph with ``step.release_graphs(local_cfg)``."""
    dims = meta.dims
    if sstate.bodies.pos.shape[0] != dims.D:
        raise ValueError(f"the state has {sstate.bodies.pos.shape[0]} "
                         f"shards but was sharded for {dims.D}")
    return run_frames(sstate, (local_cfg, sstate.bodies.pos.device,
                               ("spatial", dims)),
                      lambda s: spatial_frame(s, local_cfg, dims), num_steps)


def unshard(sstate: State, meta: SpatialMeta, template: State) -> State:
    """Gather the owned rows back into a global State (on the host), on
    ``template``'s device.  ``template`` gives the global layout (as a
    rule the state before sharding); statics come from shard 0's copies;
    stats are shard 0's (the reduced record).  The contact cache is empty
    at the template's capacity: the template's predates the sharded run,
    and its stale impulses would warm-start the first frame."""
    D, S, H, M = meta.dims
    device = template.bodies.pos.device
    out = {f.name: _host(getattr(template.bodies, f.name)).copy()
           for f in dataclasses.fields(template.bodies)}
    for name in out:
        sh = _host(getattr(sstate.bodies, name))
        if S:
            out[name][meta.static_ids] = sh[0, :S]
        for d in range(D):
            ids = meta.owned_ids[d]
            ok = ids >= 0
            out[name][ids[ok]] = sh[d, S + H:S + H + M][ok]
    stats = SolverStats(**{f.name: getattr(sstate.stats, f.name)[0].clone()
                           .to(device) for f in dataclasses.fields(
                               sstate.stats)})
    joints = template.joints
    if (meta.owned_joint_ids is not None and meta.joint_capacity
            and joints.capacity):
        acc = _host(template.joints.accum).copy()
        sh = _host(sstate.joints.accum)          # (D, Jloc, 2)
        for d in range(D):
            ids = meta.owned_joint_ids[d]
            ok = ids >= 0
            acc[ids[ok]] = sh[d][ok]
        joints = joints.replace(accum=torch.from_numpy(acc).to(device))
    return State(bodies=Bodies(**{k: torch.from_numpy(v).to(device)
                                  for k, v in out.items()}),
                 joints=joints,
                 cache=ContactCache.empty(template.cache.capacity, device),
                 stats=stats)


def rebalance(sstate: State, meta: SpatialMeta, template: State,
              cfg: SimConfig, halo: Optional[int] = None,
              max_pairs_per_shard: Optional[int] = None,
              ) -> Tuple[State, SimConfig, SpatialMeta]:
    """Re-deal ownership by current x (on the host, between chunks): the
    same shard count, a new ``halo`` where given.  The caches restart
    empty (one frame of warm start lost)."""
    dims = meta.dims
    return shard_spatial(unshard(sstate, meta, template), cfg, dims.D,
                         dims.H if halo is None else halo,
                         max_pairs_per_shard=max_pairs_per_shard)
