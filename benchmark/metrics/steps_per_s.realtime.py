"""steps_per_s.realtime: frames completed over the whole window, in the
realtime cells (one frame a call, read back and waited for)
(``benchmark/readers.py``)."""

from benchmark.readers import steps_per_s as read  # noqa: F401
