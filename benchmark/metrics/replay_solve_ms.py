"""replay_solve_ms: device ms a replayed frame from its ``prepare`` mark to
its ``solve`` mark (the solve stage), over the traced frames, in the batch
cells (``benchmark/spans.py``)."""

from benchmark.spans import replay_solve_ms as read  # noqa: F401
