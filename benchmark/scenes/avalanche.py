"""The avalanche: boxes in a grid above a static slope, which rain onto the
slope and flow off it."""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes import Rows, Scene


def make(boxes: int, seed: int, box_half: float = 0.5) -> Scene:
    """Each box jittered in x and turned by
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    rows = Rows()
    rows.ground()
    rows.box((-30.0, 15.0), (40.0, 1.0), angle=-0.35, static=True,
             friction=0.3)
    cols = max(1, int(math.sqrt(boxes)))
    s = box_half * 2.5
    for k in range(boxes):
        r, c = divmod(k, cols)
        x = -60.0 + c * s + rng.uniform(-0.2, 0.2) * box_half
        rows.box((x, 25.0 + r * s), (box_half, box_half), friction=0.4,
                 angle=rng.uniform(-0.3, 0.3))
    return rows.scene()
