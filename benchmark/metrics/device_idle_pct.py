"""device_idle_pct: the device's idle share of the traced stretch, in the
batch cells (``benchmark/readers.py``)."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
