"""Canonical scene builders (``phyx_tpu/scenes.py``): the pile of the
bench's main path and the single stack of the oracle tests.  The other
scenes follow with ROADMAP M9."""

from __future__ import annotations

import math

import numpy as np

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.world import SceneBuilder


def _ground(sb: SceneBuilder, half_width: float = 1e4):
    return sb.add_box((0.0, -10.0), (half_width, 10.0), static=True,
                      friction=0.6)


def pile(cfg: SimConfig, num_boxes: int, seed: int = 0,
         box_half: float = 0.5, jitter: float = 0.1,
         ground_half: float = 1e4) -> SceneBuilder:
    """Stacked-box pile on a ground plane: a near-square grid of columns
    with per-box jitter from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    sb = SceneBuilder(cfg)
    _ground(sb, ground_half)
    cols = max(1, int(math.sqrt(num_boxes * 2)))
    spacing = box_half * 2.05
    placed = 0
    row = 0
    while placed < num_boxes:
        for c in range(cols):
            if placed >= num_boxes:
                break
            x = (c - cols / 2) * spacing + rng.uniform(-jitter, jitter) * box_half
            y = 0.5 + row * spacing
            sb.add_box((x, y), (box_half, box_half), friction=0.5)
            placed += 1
        row += 1
    return sb


def stack(cfg: SimConfig, height: int, box_half: float = 0.5) -> SceneBuilder:
    """Single vertical stack — the classic warm-start stability test."""
    sb = SceneBuilder(cfg)
    _ground(sb)
    for k in range(height):
        sb.add_box((0.0, 0.5 + k * box_half * 2.0), (box_half, box_half),
                   friction=0.6)
    return sb
