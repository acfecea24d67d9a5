"""The pile: boxes in a near-square grid of columns on a ground plane."""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes import Rows, Scene


def make(boxes: int, seed, box_half: float = 0.5, jitter: float = 0.1,
         ground_half: float = 1e4) -> Scene:
    """Each column position jittered by ``numpy.random.default_rng(seed)``;
    the ground ``ground_half`` wide each way."""
    rng = np.random.default_rng(seed)
    rows = Rows()
    rows.ground(ground_half)
    cols = max(1, int(math.sqrt(boxes * 2)))
    spacing = box_half * 2.05
    placed = row = 0
    while placed < boxes:
        for c in range(cols):
            if placed >= boxes:
                break
            x = (c - cols / 2) * spacing + rng.uniform(-jitter, jitter) \
                * box_half
            rows.box((x, 0.5 + row * spacing), (box_half, box_half),
                     friction=0.5)
            placed += 1
        row += 1
    return rows.scene()
