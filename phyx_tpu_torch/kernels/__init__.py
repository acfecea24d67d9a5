"""Kernels written by hand for Hopper, each beside its plain torch version
and with a launch count (``<wrapper>.launches``)."""

import torch


def count_launch(wrapper) -> None:
    """Adds one to ``wrapper.launches`` for a kernel launched on the card.
    A launch inside a CUDA graph capture only records the kernel, which
    runs at each replay outside any wrapper: it is not counted."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
