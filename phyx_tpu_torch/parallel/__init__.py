"""Many scenes, and one scene in many parts (``phyx_tpu/parallel``).

``envs``: independent envs as one mega-scene (``concat_envs``), as a
stacked batch (``make_env_batch``, ``sharded_env_step``) and as stacked
mega-scene groups (``concat_envs_grouped``, ``sharded_mega_step``).
``spatial``: one scene cut into x-bands with a halo exchange
(``shard_spatial``, ``spatial_rollout``, ``unshard``, ``rebalance``).  The
slices of a batch and the shards of a scene share one device and step in
turn; on the card a frame of all of them is one captured CUDA graph."""

from phyx_tpu_torch.parallel.envs import make_env_batch, sharded_env_step

__all__ = ["make_env_batch", "sharded_env_step"]
