"""The reduction of a torch.profiler trace of the window's last stretch.

Device busy time is the union of the device's operation intervals (kernels,
copies, fills); the span runs from the first operation's start to the last
one's end; an idle gap is a stretch of the span with no operation, named by
the innermost of the harness's host annotations (``LABELS``) open at the
gap's start.  A hand-written solve kernel's time is that of its level
pre-pass (``visit_levels`` over the kernel's visit map) and of the level
solves that follow it.
"""

from __future__ import annotations

import collections

# the harness's host annotations (torch.profiler.record_function names)
LABELS = ("rollout", "guard", "readback", "wait", "reset")
# the visit map of each level-scheduled solve kernel, by the name its
# pre-pass is instantiated with
SOLVE_MAPS = {"K1": "RowsMap", "K3": "CumSlots"}
NAME_CHARS = 120


def reduce_events(events) -> dict:
    """``events``: the profiler's ``events()``.  Returns the device
    operations (name, start us, end us) in time order, the host
    annotations and the busy, span and gap figures."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler also lays each host annotation over the device work it
    # launched, under the annotation's name: not an operation
    ops = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in events
                  if e.device_type == cuda and e.name not in LABELS),
                 key=lambda o: o[1])
    notes = [(e.name, e.time_range.start, e.time_range.end)
             for e in events
             if e.device_type != cuda and e.name in LABELS]
    return summarize(ops, notes)


def summarize(ops, notes) -> dict:
    busy = 0.0
    gaps = []
    end = None
    for _, s, e in ops:
        if end is None or s >= end:
            if end is not None and s > end:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = (ops[-1][2] - ops[0][1]) if ops else 0.0
    by_name = collections.defaultdict(float)
    for name, s, e in ops:
        by_name[name[:NAME_CHARS]] += e - s

    def host_at(t):
        open_ = [(e - s, name) for name, s, e in notes if s <= t < e]
        return min(open_)[1] if open_ else "none"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return dict(
        ops=ops, busy_us=busy, span_us=span,
        device_ops=sorted(([n, t / 1e6] for n, t in by_name.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=[[host_at(s), (e - s) / 1e6] for s, e in longest])


def solve_kernel_us(ops, kernel: str) -> float:
    """Device us of the level-scheduled solve ``kernel`` (K1 or K3)
    among ``ops``: its pre-passes and the level solves after each."""
    total = 0.0
    current = None
    for name, s, e in ops:
        if "visit_levels" in name:
            current = next((k for k, m in SOLVE_MAPS.items() if m in name),
                           None)
        elif "level_solve" not in name:
            continue
        if current == kernel:
            total += e - s
    return total
