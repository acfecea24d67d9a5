"""Core state records (SoA, fixed capacity) as dataclasses of tensors.

Counterpart of ``phyx_tpu/types.py``: the same records, field names and
dtypes.  Every per-body and per-contact quantity is a tensor with a static
capacity and an active mask, so ``step`` never needs a host round-trip.
Factories take the ``device`` on which the state lives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EMPTY = 2**31 - 1   # int32 sentinel key of free pair / cache slots, sorts last


def _record(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


def parked_positions(n: int) -> np.ndarray:
    """Distinct far-away x positions for inactive slots, so inactive AABBs
    never overlap anything (the reference's ``types._parked``)."""
    x = np.arange(n, dtype=np.float32) * 16.0 + 1.0e7
    return np.stack([x, np.zeros(n, np.float32)], axis=-1)


@_record
class Bodies:
    """SoA rigid-body state, capacity ``N = pos.shape[0]``.

    Rotation is a (cos, sin) pair per body.  Static bodies have
    ``inv_mass == inv_inertia == 0``; free slots have ``active == False``.
    """

    pos: torch.Tensor          # (N, 2) f32
    rot: torch.Tensor          # (N, 2) f32 (cos, sin)
    vel: torch.Tensor          # (N, 2) f32
    angvel: torch.Tensor       # (N,)  f32
    dvel: torch.Tensor         # (N, 2) f32 split-impulse pseudo-velocity
    dangvel: torch.Tensor      # (N,)  f32
    inv_mass: torch.Tensor     # (N,)  f32
    inv_inertia: torch.Tensor  # (N,)  f32
    half_extent: torch.Tensor  # (N, 2) f32
    friction: torch.Tensor     # (N,)  f32
    restitution: torch.Tensor  # (N,)  f32
    active: torch.Tensor       # (N,)  bool

    @property
    def capacity(self) -> int:
        return self.pos.shape[-2]

    @staticmethod
    def zeros(n: int, device) -> "Bodies":
        f32 = dict(dtype=torch.float32, device=device)
        rot = torch.zeros((n, 2), **f32)
        rot[:, 0] = 1.0
        return Bodies(
            pos=torch.from_numpy(parked_positions(n)).to(device),
            rot=rot,
            vel=torch.zeros((n, 2), **f32),
            angvel=torch.zeros((n,), **f32),
            dvel=torch.zeros((n, 2), **f32),
            dangvel=torch.zeros((n,), **f32),
            inv_mass=torch.zeros((n,), **f32),
            inv_inertia=torch.zeros((n,), **f32),
            half_extent=torch.ones((n, 2), **f32),
            friction=torch.zeros((n,), **f32),
            restitution=torch.zeros((n,), **f32),
            active=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@_record
class Joints:
    """SoA user-joint state, fixed capacity J (static topology): revolute
    and distance joints, solved as rows after the contacts (``joints.py``).
    Live joints fill slots ``[0, count)``; free slots have kind 0."""

    kind: torch.Tensor    # (J,) int32: 0 none, 1 revolute, 2 distance
    b1: torch.Tensor      # (J,) int32
    b2: torch.Tensor      # (J,) int32
    a1: torch.Tensor      # (J, 2) f32 local anchor on body 1
    a2: torch.Tensor      # (J, 2) f32 local anchor on body 2
    rest: torch.Tensor    # (J,) f32 distance-joint rest length
    accum: torch.Tensor   # (J, 2) f32 warm-start velocity impulse

    @property
    def capacity(self) -> int:
        return self.kind.shape[-1]

    @staticmethod
    def empty(j: int, device) -> "Joints":
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return Joints(
            kind=torch.zeros((j,), **i32),
            b1=torch.zeros((j,), **i32),
            b2=torch.zeros((j,), **i32),
            a1=torch.zeros((j, 2), **f32),
            a2=torch.zeros((j, 2), **f32),
            rest=torch.zeros((j,), **f32),
            accum=torch.zeros((j, 2), **f32),
        )


@_record
class ContactCache:
    """Per-pair warm-start state, sorted lexicographically by ``(pi, pj)``
    with free slots at ``(EMPTY, EMPTY)``."""

    pi: torch.Tensor                # (P,) int32
    pj: torch.Tensor                # (P,) int32
    fid: torch.Tensor               # (P, 2) int32, -1 = none
    normal_impulse: torch.Tensor    # (P, 2) f32
    friction_impulse: torch.Tensor  # (P, 2) f32

    @property
    def capacity(self) -> int:
        return self.pi.shape[-1]

    @staticmethod
    def empty(p: int, device) -> "ContactCache":
        i32 = dict(dtype=torch.int32, device=device)
        return ContactCache(
            pi=torch.full((p,), EMPTY, **i32),
            pj=torch.full((p,), EMPTY, **i32),
            fid=torch.full((p, 2), -1, **i32),
            normal_impulse=torch.zeros((p, 2), dtype=torch.float32,
                                       device=device),
            friction_impulse=torch.zeros((p, 2), dtype=torch.float32,
                                         device=device),
        )


@_record
class SolverStats:
    """Per-step counters, produced on the device and read only when the
    caller asks.  ``pair_overflow`` is the sum of the ``ovf_*`` causes
    (legend in ``phyx_tpu/types.py``)."""

    num_pairs: torch.Tensor        # () int32
    num_contacts: torch.Tensor     # () int32
    pair_overflow: torch.Tensor    # () int32
    max_penetration: torch.Tensor  # () f32
    residual: torch.Tensor         # () f32
    halo_overflow: torch.Tensor    # () int32 (spatial sharding; 0 here)
    ovf_window: torch.Tensor       # () int32
    ovf_slots: torch.Tensor        # () int32
    ovf_drop: torch.Tensor         # () int32
    ovf_band: torch.Tensor         # () int32
    ovf_slab: torch.Tensor         # () int32

    @staticmethod
    def zeros(device) -> "SolverStats":
        def z32():
            return torch.zeros((), dtype=torch.int32, device=device)

        def zf():
            return torch.zeros((), dtype=torch.float32, device=device)
        return SolverStats(z32(), z32(), z32(), zf(), zf(), z32(),
                           z32(), z32(), z32(), z32(), z32())


@_record
class State:
    """Full simulation state: bodies + user joints + contact cache + stats."""

    bodies: Bodies
    joints: Joints
    cache: ContactCache
    stats: SolverStats

    @staticmethod
    def zeros(max_bodies: int, max_pairs: int, max_joints: int = 0,
              device="cuda") -> "State":
        return State(
            bodies=Bodies.zeros(max_bodies, device),
            joints=Joints.empty(max_joints, device),
            cache=ContactCache.empty(max_pairs, device),
            stats=SolverStats.zeros(device),
        )
