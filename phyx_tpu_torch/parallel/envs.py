"""Independent scenes as one block-diagonal mega-scene
(``phyx_tpu/parallel/envs.py``).

Envs are concatenated into one scene, each translated to its own cell of a
band grid, so that no AABB of one env can meet another's: one ``step``
advances every env, and the broadphase and solve see one large scene (bench
row E).  Built on the host in NumPy, like ``SceneBuilder``: the mega-scene
builds the same arrays as the JAX package's from the same builders.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import State
from phyx_tpu_torch.world import SceneBuilder


def concat_envs(builders: Sequence[SceneBuilder], cfg: SimConfig,
                band_width: float = 1.0e4, y_bands: int = 1,
                band_height: float = 0.0):
    """Merge per-env builders into one mega ``SceneBuilder``.

    Env ``e`` moves to the cell of x band ``e // y_bands`` (spacing
    ``band_width``, centred on x = 0) and y band ``e % y_bands`` (spacing
    ``band_height``); its joints follow its bodies.  With bands wider than
    any env, no pair crosses envs.  A grid (``y_bands > 1``) keeps
    coordinates small at large env counts, where an x-line would reach
    magnitudes whose float32 spacing exceeds the contact slop.

    Returns ``(mega_builder, env_slices, offsets)``: ``env_slices[e]``
    indexes env e's bodies in the mega arrays, ``offsets[e]`` is its (x, y)
    translation (float32)."""
    if y_bands > 1 and band_height <= 0.0:
        raise ValueError("y_bands > 1 requires band_height > 0")
    mega = SceneBuilder(cfg)
    slices: List[slice] = []
    offsets = np.zeros((len(builders), 2), np.float32)
    x0 = -(-len(builders) // y_bands) / 2.0
    for e, sb in enumerate(builders):
        dx = (e // y_bands - x0) * band_width
        dy = (e % y_bands) * band_height
        offsets[e] = (dx, dy)
        start = len(mega._rows)
        for r in sb._rows:
            mega._rows.append({**r, "pos": r["pos"] + np.array([dx, dy])})
        for j in sb._joints:
            mega._joints.append({**j, "b1": j["b1"] + start,
                                 "b2": j["b2"] + start})
        slices.append(slice(start, len(mega._rows)))
    return mega, slices, offsets


def env_positions(state: State, env_slices, offsets) -> List[np.ndarray]:
    """Per-env local positions from a mega-scene state (one device read)."""
    pos = state.bodies.pos.cpu().numpy()
    return [pos[s] - offsets[e] for e, s in enumerate(env_slices)]
