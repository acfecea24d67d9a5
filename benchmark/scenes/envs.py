"""The batched-env mega-scene (bench row E): independent piles laid out
side by side in one scene, as ``parallel.envs.concat_envs`` lays out the
envs of ``demos.run_envs.envs_layout``.

The configuration's ``boxes`` counts the boxes of one env; each env adds
its ground, so the scene holds ``envs * (boxes + 1)`` bodies, env by env,
each env's ground first.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes import Scene, pile

# envs_layout's band grid: x cells 80 apart, y-bands 400 apart, each
# env's ground 30 wide each way
BAND_WIDTH, BAND_HEIGHT, GROUND_HALF = 80.0, 400.0, 30.0


def y_bands(envs: int) -> int:
    """``envs_layout``'s rule: 8 y-bands from 64 envs, else 1."""
    return 8 if envs >= 64 else 1


def layout(env_seeds, boxes: int) -> Scene:
    """Env e a pile of ``boxes`` boxes from seed ``env_seeds[e]``, moved to
    the cell of x band e // B (centred on x = 0) and y band e % B, for B
    the ``y_bands`` of the env count."""
    bands = y_bands(len(env_seeds))
    x0 = -(-len(env_seeds) // bands) / 2.0
    parts = []
    for e, seed in enumerate(env_seeds):
        env = pile.make(boxes, seed, ground_half=GROUND_HALF)
        env.pos = env.pos + np.array([(e // bands - x0) * BAND_WIDTH,
                                      (e % bands) * BAND_HEIGHT])
        parts.append(env)
    return Scene(**{f: np.concatenate([getattr(p, f) for p in parts])
                    for f in ("pos", "half", "angle", "density", "friction",
                              "restitution", "static")})


def make(boxes: int, seed: int, envs: int) -> Scene:
    """``envs`` envs of ``boxes`` boxes, env e's pile from the seed
    ``[seed, e]``."""
    return layout([[seed, e] for e in range(envs)], boxes)
