"""The benchmark's scenes as NumPy arrays, made from the run's seed.

A configuration's ``scene`` entry names a kind; the kind is a file of its
own, ``benchmark/scenes/<kind>.py``, found by that name, whose
``make(boxes, seed, **kw)`` returns a ``Scene``.  The kinds copy the
arithmetic of the engine's scenes, so that the workload is fixed by the
benchmark: the harness hands each box to the program's ``SceneBuilder``
and the same arrays to the reference.  A box is a row of ``Scene``'s
arrays: centre, half extents, angle, density, friction, restitution and
whether it is static; body 0 is the ground.
"""

from __future__ import annotations

import importlib.util
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

KIND = re.compile(r"^[a-z][a-z0-9_]*$")


@dataclass
class Scene:
    pos: np.ndarray          # (B, 2) float64
    half: np.ndarray         # (B, 2)
    angle: np.ndarray        # (B,)
    density: np.ndarray      # (B,)
    friction: np.ndarray     # (B,)
    restitution: np.ndarray  # (B,)
    static: np.ndarray       # (B,) bool

    def __len__(self) -> int:
        return self.pos.shape[0]

    def inverse_masses(self):
        """(inv_mass, inv_inertia) in float64: m = density * 4 hx hy,
        I = m (hx^2 + hy^2) / 3, both 0 for a static box."""
        h = self.half
        m = self.density * 4.0 * h[:, 0] * h[:, 1]
        inertia = m * (h[:, 0] ** 2 + h[:, 1] ** 2) / 3.0
        with np.errstate(divide="ignore"):
            inv_m = np.where(self.static, 0.0, 1.0 / m)
            inv_i = np.where(self.static, 0.0, 1.0 / inertia)
        return inv_m, inv_i


class Rows:
    """The boxes of a scene, added one by one."""

    def __init__(self):
        self.rows = []

    def box(self, pos, half, angle=0.0, density=1.0, friction=0.3,
            restitution=0.0, static=False):
        self.rows.append((pos[0], pos[1], half[0], half[1], angle, density,
                          friction, restitution, static))

    def ground(self, half_width: float = 1e4):
        self.box((0.0, -10.0), (half_width, 10.0), static=True, friction=0.6)

    def scene(self) -> Scene:
        a = np.asarray([r[:8] for r in self.rows], np.float64)
        return Scene(pos=a[:, 0:2], half=a[:, 2:4], angle=a[:, 4],
                     density=a[:, 5], friction=a[:, 6], restitution=a[:, 7],
                     static=np.asarray([r[8] for r in self.rows], bool))


def make(config: dict, seed: int, root: Path = None) -> Scene:
    """The scene of a configuration file: its ``boxes`` of the ``scene``
    entry's ``kind`` (``benchmark/scenes/<kind>.py`` under ``root``, the
    checkout; by default this one), whose other keys are the kind's
    keyword arguments."""
    entry = config["scene"]
    name = entry["kind"]
    if not KIND.match(name):
        raise ValueError(f"not a scene kind: {name!r}")
    folder = Path(__file__).parent if root is None else \
        Path(root) / "benchmark" / "scenes"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_scene_{name}", folder / f"{name}.py")
    kind = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kind)
    kw = {k: v for k, v in entry.items() if k != "kind"}
    return kind.make(config["boxes"], seed=seed, **kw)
