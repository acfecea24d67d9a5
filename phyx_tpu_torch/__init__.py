"""phyx_tpu_torch — the PyTorch and CUDA port of phyx_tpu.

The JAX package ``phyx_tpu`` is the reference; this package mirrors its
module names, record field names and dtypes so each piece has a
counterpart, and never imports jax or ``phyx_tpu``.  Plain stages are torch
operations; the serial contact solve is a CUDA kernel written for Hopper
(``csrc/``, built at first use).

Ported so far: the 10k-pile main path — ``SimConfig``, the state records,
``scenes.pile``/``stack``, the grid and all-pairs broadphases, narrowphase,
the contact cache, solver prepare, the serial solve kernel, ``step`` and
``rollout`` — for ``solver_backend="pallas"`` and scenes without joints.

    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.step import step, rollout
"""

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import (Bodies, ContactCache, Joints, SolverStats,
                                  State)
from phyx_tpu_torch.world import SceneBuilder

__version__ = "0.1.0"

__all__ = ["SimConfig", "Bodies", "ContactCache", "Joints", "State",
           "SolverStats", "SceneBuilder"]
