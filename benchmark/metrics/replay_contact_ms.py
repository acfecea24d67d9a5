"""replay_contact_ms: device ms a replayed frame from its start mark to its
``prepare`` mark (the contact stage), over the traced frames, in the batch
cells (``benchmark/spans.py``)."""

from benchmark.spans import replay_contact_ms as read  # noqa: F401
