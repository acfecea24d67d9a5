"""phyx_tpu_torch — the PyTorch and CUDA port of phyx_tpu.

The JAX package ``phyx_tpu`` is the reference; this package mirrors its
module names, record field names and dtypes so each piece has a
counterpart, and never imports jax or ``phyx_tpu``.  Plain stages are torch
operations, and so is the colored solve (on-device coloring and colored
Gauss-Seidel sweeps), which the reference writes as plain XLA; the serial
solve is CUDA written for Hopper (``csrc/``, built at first use), in a
fused form (state in shared memory), a streamed form (state in device
memory) and two slab-ordered tiled forms (the x-rank embedded body table
in device memory), and so are the broadphases' sweeps.

Ported so far: ``SimConfig``, the state records, the scenes (piles, stack,
pyramid, avalanche, and the jointed chain, bridge and net), batched envs
as one mega-scene (``parallel.envs.concat_envs``), the grid, tiled-sweep
and all-pairs broadphases with banded and segmented sweep keys and the
slab-major finalize, jointed-pair exclusion, narrowphase, the contact
cache, solver and joint prepare, the coloring, the seven kernels,
``step`` and ``World`` — for every ``solver_backend`` (``"xla"``, the
default, ``"pallas"`` and ``"pallas_tiled"``); ``rollout`` as a CUDA graph
replay on the card (M7); the autotuner ``tune`` and the sweep-budget
policies (M13); and the auxiliaries (M15): ``checkpoint`` (npz files
interchangeable with the JAX package's), ``metrics`` (``snapshot``,
``MetricsLogger``), ``debug`` (``checked_step``, ``checked_rollout``),
``profiling`` (``profile_step``), the f64 ``oracle`` with
``SceneBuilder.to_oracle``, and the headless ``demos``; and multi-device
(M16) on one card: ``parallel.spatial`` (one scene in x-bands with a halo
exchange: ``shard_spatial``, ``spatial_rollout``, ``unshard``,
``rebalance``) and ``parallel.envs``' stacked batches
(``make_env_batch``, ``sharded_env_step``, ``concat_envs_grouped``,
``sharded_mega_step``), whose shards, envs and groups share one device.
Entry points put state on the card unless the caller names another
device.

    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.step import step, rollout
"""

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import (Bodies, ContactCache, Joints, SolverStats,
                                  State)
from phyx_tpu_torch.world import SceneBuilder, World

__version__ = "0.1.0"

__all__ = ["SimConfig", "Bodies", "ContactCache", "Joints", "State",
           "SolverStats", "SceneBuilder", "World"]
