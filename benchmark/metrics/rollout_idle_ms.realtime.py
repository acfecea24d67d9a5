"""rollout_idle_ms.realtime: device idle ms a frame between the trace's first
and last frame marks whose innermost open host range is one of the
program's spans (``phyx.rollout``, ``phyx.copy_in``, ``phyx.replay``,
``phyx.copy_out``), in the realtime cells (``benchmark/spans.py``)."""

from benchmark.spans import rollout_idle_ms as read  # noqa: F401
