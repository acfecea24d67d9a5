"""Kernels written by hand for Hopper, each beside its plain torch version
and with a launch count (``<wrapper>.launches``)."""

import torch


def count_launch(wrapper) -> None:
    """Adds one to ``wrapper.launches`` for a kernel launched on the card.
    A launch inside a CUDA graph capture only records the kernel, which
    runs at each replay outside any wrapper: it is not counted."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def wrappers() -> dict:
    """Every hand-written kernel's wrapper, by its name in the port's
    records (K1-K7)."""
    from phyx_tpu_torch.kernels.contact_solver import solve_contacts_fused
    from phyx_tpu_torch.kernels.contact_solver_streamed import \
        solve_contacts_streamed
    from phyx_tpu_torch.kernels.contact_solver_tiled import (
        solve_contacts_tiled, solve_contacts_tiled2)
    from phyx_tpu_torch.kernels.sweep import sweep_emit, sweep_emit_v2
    from phyx_tpu_torch.kernels.sweep_tiled import sweep_emit_tiled
    return dict(K1=solve_contacts_streamed, K2=solve_contacts_fused,
                K3=solve_contacts_tiled2, K4=sweep_emit_tiled,
                K5=solve_contacts_tiled, K6=sweep_emit_v2, K7=sweep_emit)
