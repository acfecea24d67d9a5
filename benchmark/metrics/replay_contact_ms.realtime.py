"""replay_contact_ms.realtime: device ms a replayed frame from its start mark
to its ``prepare`` mark (the contact stage), over the traced frames, in the
realtime cells (``benchmark/spans.py``)."""

from benchmark.spans import replay_contact_ms as read  # noqa: F401
