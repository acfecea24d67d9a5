"""Kernels written by hand for Hopper, each beside its plain torch version
and with a launch count (``<wrapper>.launches``)."""
