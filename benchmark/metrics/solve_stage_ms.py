"""solve_stage_ms: device ms a frame of the solve stage, in the batch cells
(``benchmark/readers.py``)."""

from benchmark.readers import solve_stage_ms as read  # noqa: F401
