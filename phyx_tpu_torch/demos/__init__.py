"""Headless demos (``demos/`` of the JAX package): ``run_scene`` and
``run_envs``, run as ``python -m phyx_tpu_torch.demos.<name>``, on the card
unless ``--cpu`` is given."""
