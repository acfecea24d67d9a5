"""contact_stage_ms.realtime: device ms a frame of the contact stage, in the
realtime cells (``benchmark/readers.py``)."""

from benchmark.readers import contact_stage_ms as read  # noqa: F401
