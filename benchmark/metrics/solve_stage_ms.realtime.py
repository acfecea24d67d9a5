"""solve_stage_ms.realtime: device ms a frame of the solve stage, in the
realtime cells (``benchmark/readers.py``)."""

from benchmark.readers import solve_stage_ms as read  # noqa: F401
