"""State carried across in both directions as NumPy arrays.

The engine has no model parameters; its state is what moves between the
two packages.  ``state_from_numpy`` takes any record tree with the ``State``
field names whose leaves are array-likes (for example the JAX package's
``State`` after ``jax.tree_util.tree_map(np.asarray, st)``) and puts it on
``device``; ``state_to_numpy`` gives back the same tree with NumPy leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyx_tpu_torch.types import (Bodies, ContactCache, Joints, SolverStats,
                                  State)

_RECORDS = (("bodies", Bodies), ("joints", Joints), ("cache", ContactCache),
            ("stats", SolverStats))


def state_from_numpy(tree, device) -> State:
    parts = {}
    for name, cls in _RECORDS:
        sub = getattr(tree, name)
        parts[name] = cls(**{
            f.name: torch.from_numpy(
                np.array(getattr(sub, f.name), copy=True)).to(device)
            for f in dataclasses.fields(cls)})
    return State(**parts)


def state_to_numpy(state: State) -> State:
    parts = {}
    for name, cls in _RECORDS:
        sub = getattr(state, name)
        parts[name] = cls(**{
            f.name: getattr(sub, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(cls)})
    return State(**parts)
