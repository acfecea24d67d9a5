"""Host-side scene construction (``phyx_tpu/world.py``).

Boxes and user joints accumulate on the host in NumPy (not the hot path);
``build`` turns them into the fixed-capacity ``State`` on a device, the
card unless the caller names another.  The arrays are computed exactly as
the JAX package computes them, so both packages build bit-identical states
from the same calls.  ``World`` owns a State and steps it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.joints import KIND_DISTANCE, KIND_REVOLUTE
from phyx_tpu_torch.step import stats_dict
from phyx_tpu_torch.step import step as _step
from phyx_tpu_torch.types import State


class SceneBuilder:
    """Accumulates boxes and joints on the host, then ``build``s the
    State."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self._rows = []
        self._joints = []

    def add_box(self, pos, half_extent, angle: float = 0.0,
                density: float = 1.0, friction: float = 0.3,
                restitution: float = 0.0, static: bool = False,
                velocity=(0.0, 0.0), angvel: float = 0.0) -> int:
        """m = rho * 4 * hx * hy, I = m * (hx^2 + hy^2) / 3 (as the oracle)."""
        h = np.asarray(half_extent, np.float64)
        if static:
            inv_m = inv_i = 0.0
        else:
            m = density * 4.0 * h[0] * h[1]
            inertia = m * (h[0] ** 2 + h[1] ** 2) / 3.0
            inv_m, inv_i = 1.0 / m, 1.0 / inertia
        self._rows.append(dict(
            pos=np.asarray(pos, np.float64), h=h, angle=float(angle),
            inv_m=inv_m, inv_i=inv_i, friction=float(friction),
            restitution=float(restitution),
            vel=np.asarray(velocity, np.float64), angvel=float(angvel)))
        return len(self._rows) - 1

    @property
    def num_bodies(self) -> int:
        return len(self._rows)

    def add_revolute_joint(self, b1: int, b2: int, world_anchor) -> int:
        """Pin two bodies together at a world-space point.  Local anchors
        come from the bodies' build poses."""
        return self._add_joint(KIND_REVOLUTE, b1, b2, world_anchor,
                               world_anchor, 0.0)

    def add_distance_joint(self, b1: int, b2: int, anchor1, anchor2,
                           rest: Optional[float] = None) -> int:
        """Keep two world-space anchor points at a fixed distance (by
        default their distance at build time)."""
        a1 = np.asarray(anchor1, np.float64)
        a2 = np.asarray(anchor2, np.float64)
        if rest is None:
            rest = float(np.linalg.norm(a2 - a1))
        return self._add_joint(KIND_DISTANCE, b1, b2, a1, a2, rest)

    def _add_joint(self, kind, b1, b2, w1, w2, rest) -> int:
        if self.cfg.max_joints <= len(self._joints):
            raise ValueError(
                f"joint count exceeds max_joints={self.cfg.max_joints}")

        def local(body, w):
            r = self._rows[body]
            c, s = np.cos(r["angle"]), np.sin(r["angle"])
            d = np.asarray(w, np.float64) - r["pos"]
            return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])

        self._joints.append(dict(
            kind=kind, b1=b1, b2=b2,
            a1=local(b1, w1), a2=local(b2, w2), rest=float(rest)))
        return len(self._joints) - 1

    def build(self, device="cuda") -> State:
        n = self.cfg.max_bodies
        k = len(self._rows)
        if k > n:
            raise ValueError(f"{k} bodies exceed max_bodies={n}")
        st = State.zeros(n, self.cfg.max_pairs, self.cfg.max_joints,
                         device=device)

        def fill(record, rows, columns):
            if not rows:
                return
            for name, key, dtype in columns:
                getattr(record, name)[:len(rows)] = torch.from_numpy(
                    np.asarray([r[key] for r in rows], dtype)).to(device)

        fill(st.joints, self._joints, (
            ("kind", "kind", np.int32), ("b1", "b1", np.int32),
            ("b2", "b2", np.int32), ("a1", "a1", np.float32),
            ("a2", "a2", np.float32), ("rest", "rest", np.float32)))
        if k == 0:
            return st
        angle = np.asarray([r["angle"] for r in self._rows], np.float32)
        rot = np.stack([np.cos(angle), np.sin(angle)], -1).astype(np.float32)
        b = st.bodies
        b.rot[:k] = torch.from_numpy(rot).to(device)
        fill(b, self._rows, (
            ("pos", "pos", np.float32), ("vel", "vel", np.float32),
            ("angvel", "angvel", np.float32),
            ("inv_mass", "inv_m", np.float32),
            ("inv_inertia", "inv_i", np.float32),
            ("half_extent", "h", np.float32),
            ("friction", "friction", np.float32),
            ("restitution", "restitution", np.float32)))
        b.active[:k] = True
        return st

    def to_oracle(self):
        """Build the matching NumPy-oracle world (same bodies, same cfg)."""
        from phyx_tpu_torch.oracle.engine import OracleWorld
        w = OracleWorld(self.cfg)
        for r in self._rows:
            w.add_box(r["pos"], r["h"], angle=r["angle"],
                      friction=r["friction"], restitution=r["restitution"],
                      static=(r["inv_m"] == 0.0),
                      velocity=r["vel"], angvel=r["angvel"])
            if r["inv_m"] > 0.0:
                w.inv_mass[-1] = r["inv_m"]
                w.inv_inertia[-1] = r["inv_i"]
        from phyx_tpu_torch.oracle.engine import _UserJoint
        for j in self._joints:
            w.user_joints.append(_UserJoint(
                kind=j["kind"], b1=j["b1"], b2=j["b2"],
                a1=np.asarray(j["a1"], np.float64),
                a2=np.asarray(j["a2"], np.float64),
                rest=j["rest"], accum=np.zeros(2)))
        return w


class World:
    """Owns a State and steps it.  Without ``state`` it starts from an
    empty one on ``device`` (the card unless the caller names another)."""

    def __init__(self, cfg: SimConfig, state: Optional[State] = None,
                 device="cuda"):
        self.cfg = cfg
        self.state = state if state is not None else State.zeros(
            cfg.max_bodies, cfg.max_pairs, device=device)

    def step(self, n: int = 1) -> "World":
        for _ in range(n):
            self.state = _step(self.state, self.cfg)
        return self

    # host views: each waits for the device (for tests and demos, not the
    # hot loop)
    def positions(self, k: Optional[int] = None) -> np.ndarray:
        p = self.state.bodies.pos.cpu().numpy()
        return p if k is None else p[:k]

    def stats(self) -> dict:
        s = stats_dict(self.state.stats)
        return {key: s[key] for key in (
            "num_pairs", "num_contacts", "pair_overflow", "max_penetration",
            "residual", "ovf_window", "ovf_slots", "ovf_drop", "ovf_band",
            "ovf_slab")}
