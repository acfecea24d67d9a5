"""Many independent scenes in one (``phyx_tpu/parallel``): the mega-scene
of ``envs.concat_envs``.  The batched and sharded forms of the reference
(``make_env_batch``, ``sharded_env_step``, ``concat_envs_grouped``,
``sharded_mega_step``) are not ported yet (ROADMAP M16)."""
