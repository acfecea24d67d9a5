"""capture_s: self seconds of every ``capture`` span of the process (each
frame captured into a CUDA graph: its warm-up frame and capture, less the
kernels' builds inside them), from the program's span totals
(``benchmark/spans.py``)."""

from benchmark.spans import capture_s as read  # noqa: F401
