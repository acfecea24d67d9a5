"""Host-side scene construction (``phyx_tpu/world.py``).

Boxes accumulate on the host in NumPy (not the hot path); ``build`` turns
them into the fixed-capacity ``State`` on the device the caller names.  The
arrays are computed exactly as the JAX package computes them, so both
packages build bit-identical states from the same calls.
"""

from __future__ import annotations

import numpy as np
import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import State


class SceneBuilder:
    """Accumulates boxes on the host, then ``build(device)``s the State."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self._rows = []

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

    def build(self, device="cpu") -> State:
        n = self.cfg.max_bodies
        k = len(self._rows)
        if k > n:
            raise ValueError(f"{k} bodies exceed max_bodies={n}")
        st = State.zeros(n, self.cfg.max_pairs, self.cfg.max_joints,
                         device=device)
        if k == 0:
            return st

        def col(key, dtype=np.float32):
            return torch.from_numpy(
                np.asarray([r[key] for r in self._rows], dtype)).to(device)

        angle = np.asarray([r["angle"] for r in self._rows], np.float32)
        rot = torch.from_numpy(np.stack([np.cos(angle), np.sin(angle)],
                                        -1).astype(np.float32)).to(device)
        b = st.bodies
        for name, value in (("pos", col("pos")), ("rot", rot),
                            ("vel", col("vel")), ("angvel", col("angvel")),
                            ("inv_mass", col("inv_m")),
                            ("inv_inertia", col("inv_i")),
                            ("half_extent", col("h")),
                            ("friction", col("friction")),
                            ("restitution", col("restitution"))):
            getattr(b, name)[:k] = value
        b.active[:k] = True
        return st
