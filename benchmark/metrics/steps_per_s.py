"""steps_per_s: frames completed over the whole window, in the batch cells
(calls of many frames, several in flight) (``benchmark/readers.py``)."""

from benchmark.readers import steps_per_s as read  # noqa: F401
