"""contact_stage_ms: device ms a frame of the contact stage, in the batch
cells (``benchmark/readers.py``)."""

from benchmark.readers import contact_stage_ms as read  # noqa: F401
