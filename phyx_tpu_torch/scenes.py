"""Canonical scene builders (``phyx_tpu/scenes.py``): the piles of the
bench's 10k and 1k rows, the stack of the oracle tests, the pyramid, the
avalanche, and the jointed chain, bridge and net.  Each builds the same
arrays as its JAX counterpart from the same arguments."""

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


def pyramid(cfg: SimConfig, base: int,
            box_half: float = 0.5) -> SceneBuilder:
    """Pyramid of boxes (joint-heavy lateral contact network)."""
    sb = SceneBuilder(cfg)
    _ground(sb)
    s = box_half * 2.02
    for row in range(base):
        count = base - row
        for c in range(count):
            x = (c - count / 2.0 + 0.5) * s
            y = 0.5 + row * s
            sb.add_box((x, y), (box_half, box_half), friction=0.6)
    return sb


def avalanche(cfg: SimConfig, num_boxes: int, seed: int = 0,
              box_half: float = 0.5) -> SceneBuilder:
    """Boxes rain onto a slope — broadphase/cache-churn stress
    (BASELINE.json:10)."""
    rng = np.random.default_rng(seed)
    sb = SceneBuilder(cfg)
    _ground(sb)
    sb.add_box((-30.0, 15.0), (40.0, 1.0), angle=-0.35, static=True,
               friction=0.3)
    cols = max(1, int(math.sqrt(num_boxes)))
    s = box_half * 2.5
    for k in range(num_boxes):
        r, c = divmod(k, cols)
        x = -60.0 + c * s + rng.uniform(-0.2, 0.2) * box_half
        y = 25.0 + r * s
        sb.add_box((x, y), (box_half, box_half), friction=0.4,
                   angle=rng.uniform(-0.3, 0.3))
    return sb


def chain(cfg: SimConfig, num_links: int, link_half=(0.6, 0.15),
          anchor=(0.0, 20.0)) -> SceneBuilder:
    """Hanging chain of revolute-jointed links (BASELINE.json:9 config C:
    joint-heavy scene stressing prepare + displacement solve)."""
    sb = SceneBuilder(cfg)
    _ground(sb)
    hx = link_half[0]
    pivot = sb.add_box(anchor, (0.2, 0.2), static=True)
    prev = pivot
    x, y = anchor
    for k in range(num_links):
        cx = x + hx + 2 * hx * k
        link = sb.add_box((cx, y), link_half, friction=0.2, density=2.0)
        sb.add_revolute_joint(prev, link, (cx - hx, y))
        prev = link
    return sb


def bridge(cfg: SimConfig, num_planks: int, span: float = None,
           plank_half=(0.6, 0.1), height: float = 6.0,
           load_boxes: int = 0, seed: int = 0) -> SceneBuilder:
    """Plank bridge suspended between two pillars, optionally loaded with
    boxes dropped on top (config C stress: joints + contacts coupling)."""
    rng = np.random.default_rng(seed)
    sb = SceneBuilder(cfg)
    _ground(sb)
    hx = plank_half[0]
    if span is None:
        span = 2 * hx * num_planks
    x0 = -span / 2
    left = sb.add_box((x0 - 0.5, height), (0.5, 0.5), static=True)
    right = sb.add_box((x0 + span + 0.5, height), (0.5, 0.5), static=True)
    prev = left
    for k in range(num_planks):
        cx = x0 + hx + 2 * hx * k
        plank = sb.add_box((cx, height), plank_half, friction=0.6,
                           density=1.5)
        sb.add_revolute_joint(prev, plank, (cx - hx, height))
        prev = plank
    sb.add_revolute_joint(prev, right, (x0 + span, height))
    for k in range(load_boxes):
        x = x0 + rng.uniform(0.1, 0.9) * span
        sb.add_box((x, height + 2.0 + 1.2 * k), (0.4, 0.4), friction=0.4)
    return sb


def net(cfg: SimConfig, num_nodes: int, spacing: float = 1.5,
        anchor_y: float = 15.0) -> SceneBuilder:
    """Row of boxes connected by distance joints, hung from two anchors —
    exercises the distance-joint rows."""
    sb = SceneBuilder(cfg)
    _ground(sb)
    x0 = -(num_nodes - 1) * spacing / 2
    left = sb.add_box((x0 - spacing, anchor_y), (0.2, 0.2), static=True)
    right = sb.add_box((x0 + num_nodes * spacing, anchor_y), (0.2, 0.2),
                       static=True)
    nodes = []
    for k in range(num_nodes):
        nodes.append(sb.add_box((x0 + k * spacing, anchor_y), (0.25, 0.25),
                                friction=0.3))
    sb.add_distance_joint(left, nodes[0], (x0 - spacing, anchor_y),
                          (x0, anchor_y))
    for k in range(num_nodes - 1):
        sb.add_distance_joint(nodes[k], nodes[k + 1],
                              (x0 + k * spacing, anchor_y),
                              (x0 + (k + 1) * spacing, anchor_y))
    sb.add_distance_joint(nodes[-1], right,
                          (x0 + (num_nodes - 1) * spacing, anchor_y),
                          (x0 + num_nodes * spacing, anchor_y))
    return sb
