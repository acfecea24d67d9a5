"""Independent scenes (``phyx_tpu/parallel/envs.py``).

Two forms, as in the reference:

* ``concat_envs``, the fast single-card form: envs are concatenated into
  one scene, each translated to its own cell of a band grid, so that no
  AABB of one env can meet another's: one ``step`` advances every env, and
  the broadphase and solve see one large scene (bench row E).  Built on
  the host in NumPy, like ``SceneBuilder``: the mega-scene builds the same
  arrays as the JAX package's from the same builders.
* A stacked batch, every State leaf with a leading env (or group) axis:
  ``make_env_batch`` with ``sharded_env_step``, and the grouped mega-scenes
  of ``concat_envs_grouped`` with ``sharded_mega_step``.  The reference
  ``vmap``s its step over that axis; ``torch.func.vmap`` cannot trace the
  port's kernels (ctypes calls), so the port steps each slice in turn and
  restacks, which gives each env exactly ``step(env, cfg)``.  On the card
  one frame of the whole batch is one captured CUDA graph
  (``step.run_frames``).  The slices share the batch's one device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import _leaves, _map, run_frames, step
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


def stacked(states: Sequence[State]) -> State:
    """States of one layout stacked on a new leading axis."""
    leaves = iter([torch.stack(ts) for ts in zip(*map(_leaves, states))])
    return _map(states[0], lambda _: next(leaves))


def each(frame, batch: State) -> State:
    """``frame`` (State -> State) applied to each slice of the leading axis
    of ``batch`` in turn, the results restacked."""
    return stacked([frame(_map(batch, lambda t: t[i]))
                    for i in range(batch.bodies.pos.shape[0])])


def make_env_batch(states: Sequence[State], device=None) -> State:
    """Per-env States (one layout) stacked on a leading env axis, on
    ``device`` (the first state's where None)."""
    batch = stacked(states)
    return batch if device is None else _map(batch, lambda t: t.to(device))


def _batched_step(cfg: SimConfig, num_steps: int, name: str):
    def advance(batch: State) -> State:
        return run_frames(batch, (cfg, batch.bodies.pos.device, name),
                          lambda b: each(lambda s: step(s, cfg), b),
                          num_steps)
    return advance


def sharded_env_step(cfg: SimConfig, num_steps: int = 1):
    """A batch -> batch step: ``step(env, cfg)`` on each env's slice of the
    leading axis, restacked (the reference ``vmap``s it; see the module
    docstring), ``num_steps`` frames a call.  On the card the B env steps
    of a frame are one captured graph under ``(cfg, device, "env
    batch")``.  ``concat_envs`` is the fast single-card form of many
    envs."""
    return _batched_step(cfg, num_steps, "env batch")


def concat_envs_grouped(builders: Sequence[SceneBuilder], cfg: SimConfig,
                        n_groups: int, band_width: float = 1.0e4,
                        y_bands: int = 1, band_height: float = 0.0,
                        device="cuda"):
    """Envs split into ``n_groups`` contiguous groups, each concatenated
    into its own mega-scene (``concat_envs``), the group states stacked on
    a leading axis on ``device`` for ``sharded_mega_step``.  ``cfg`` sizes
    one group.  Returns ``(stacked_state, env_slices, offsets)``:
    ``env_slices[g][e]`` and ``offsets[g][e]`` locate env e of group g in
    that group's body arrays.  Raises ``ValueError`` where the envs do not
    split evenly."""
    if len(builders) % n_groups:
        raise ValueError(
            f"{len(builders)} envs not divisible by {n_groups} groups")
    per = len(builders) // n_groups
    states, slices, offsets = [], [], []
    for g in range(n_groups):
        mega, sl, off = concat_envs(
            builders[g * per:(g + 1) * per], cfg, band_width=band_width,
            y_bands=y_bands, band_height=band_height)
        states.append(mega.build(device))
        slices.append(sl)
        offsets.append(off)
    return stacked(states), slices, offsets


def sharded_mega_step(cfg: SimConfig, num_steps: int = 1):
    """A stacked -> stacked step advancing each group's mega-scene
    ``num_steps`` frames with the unchanged ``step``; the groups share no
    body, so no exchange runs, and the stats stay per group.  On the card
    one frame of all groups is one captured graph under ``(cfg, device,
    "grouped")``, replayed ``num_steps`` times.  Build the input with
    ``concat_envs_grouped``."""
    return _batched_step(cfg, num_steps, "grouped")
