"""Readings of the program's own trace: the stage marks its frames carry on
the device and the host spans around its calls (``phyx_tpu_torch/tracing.py``
in the program).

* A stage mark is a one-thread kernel named ``phyx_mark_<stage>``,
  launched by ``step`` at the frame's start (``frame``) and as each stage
  ends, captured with the frame into the replayed graph.  A frame of the
  trace runs from one ``frame`` mark to the next; a stage's time is the
  device's busy time (the union of its operations, as
  ``benchmark/trace.py`` counts busy time) from the start of the mark
  before it to the start of its own.  What the device idles there, waiting
  for the host to finish launching the graph, is left to the idle metrics.
* A host span is a profiler range named ``phyx.<name>`` (``phyx.rollout``,
  ``phyx.copy_in``, ``phyx.replay``, ``phyx.copy_out``, ``phyx.capture``,
  ``phyx.build``), on the profiler's host timeline.

Each device idle gap between the trace's first and last frame marks is
split, instant by instant, by the innermost host range open then, of the
harness's annotations (``benchmark/trace.LABELS``) and the program's spans.

Every reader returns None where the program leaves nothing to read: on the
CPU, and with a program that has no marks or spans.
"""

from __future__ import annotations

import bisect
import collections

from benchmark.trace import LABELS

MARK = "phyx_mark_"
SPAN = "phyx."


def mark_stage(name: str):
    """The stage of a mark kernel's name, else None."""
    return name[len(MARK):] if name.startswith(MARK) else None


def frames(ops) -> list:
    """The traced frames, in time order: {stage: its mark's start us}, each
    from a ``frame`` mark to the next (marks before the first ``frame``
    mark left out)."""
    out = []
    for name, start, _ in ops:
        stage = mark_stage(name)
        if stage == "frame":
            out.append({"frame": start})
        elif stage is not None and out:
            out[-1].setdefault(stage, start)
    return out


def stage_ms(ops, first: str, last: str):
    """The mean device busy ms from the ``first`` mark to the ``last`` mark
    over the frames that hold both, or None where none does."""
    line = Timeline(ops)
    busy = [f[last] - f[first] - sum(e - s for s, e in
                                     line.gaps(f[first], f[last]))
            for f in frames(ops) if first in f and last in f]
    if not busy:
        return None
    return sum(busy) / len(busy) / 1e3


def host_ranges(events) -> list:
    """(name, start us, end us) of each host range of the harness's labels
    and the program's spans among the profiler's ``events()``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type != cuda
            and (e.name in LABELS or e.name.startswith(SPAN))]


class Timeline:
    """The device operations (name, start, end) in time order, indexed for
    the idle stretches of any interval."""

    def __init__(self, ops):
        self.ops = ops
        self.starts = [s for _, s, _ in ops]
        # the latest end among the operations up to each one
        self.reach, end = [], float("-inf")
        for _, _, e in ops:
            end = max(end, e)
            self.reach.append(end)

    def gaps(self, lo: float, hi: float) -> list:
        """(start, end) of each stretch of [lo, hi] in which no operation
        runs."""
        k = bisect.bisect_left(self.starts, lo)
        end = max(lo, self.reach[k - 1]) if k else lo
        gaps = []
        for _, s, e in self.ops[k:bisect.bisect_left(self.starts, hi)]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < hi:
            gaps.append((end, hi))
        return gaps


def innermost(ranges) -> list:
    """(start, end, name) pieces of the time the ``ranges`` cover, each
    named by the innermost (shortest) range open over it."""
    points = sorted({t for _, s, e in ranges for t in (s, e)})
    by_start = sorted(ranges, key=lambda r: r[1])
    pieces, active, k = [], [], 0
    for a, b in zip(points, points[1:]):
        while k < len(by_start) and by_start[k][1] <= a:
            active.append(by_start[k])
            k += 1
        active = [r for r in active if r[2] > a]
        if active:
            name = min(active, key=lambda r: r[2] - r[1])[0]
            pieces.append((a, b, name))
    return pieces


def idle_by_host(ops, ranges, lo: float, hi: float) -> dict:
    """{innermost host range's name ("none" where none is open): idle us}
    over the idle gaps of [lo, hi]."""
    out = collections.defaultdict(float)
    pieces = innermost(ranges)
    k = 0
    for gs, ge in Timeline(ops).gaps(lo, hi):
        covered = 0.0
        while k < len(pieces) and pieces[k][1] <= gs:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < ge:
            a, b, name = pieces[j]
            overlap = min(b, ge) - max(a, gs)
            if overlap > 0:
                out[name] += overlap
                covered += overlap
            j += 1
        if ge - gs > covered:
            out["none"] += ge - gs - covered
    return dict(out)


def frame_span(ops):
    """(first frame mark's start, last frame mark's start, frames between
    them), or None with fewer than two frame marks."""
    starts = [s for name, s, _ in ops if mark_stage(name) == "frame"]
    if len(starts) < 2:
        return None
    return starts[0], starts[-1], len(starts) - 1


# --- the readers --------------------------------------------------------------

def replay_contact_ms(run):
    """Device busy ms a replayed frame from its ``frame`` mark to its
    ``prepare`` mark: the contact stage."""
    if not run.trace:
        return None
    return stage_ms(run.trace["ops"], "frame", "prepare")


def replay_solve_ms(run):
    """Device busy ms a replayed frame from its ``prepare`` mark to its
    ``solve`` mark: the solve stage."""
    if not run.trace:
        return None
    return stage_ms(run.trace["ops"], "prepare", "solve")


def rollout_idle_ms(run):
    """Device idle ms a frame, between the trace's first and last frame
    marks, whose innermost open host range is one of the program's spans
    (``phyx.*``)."""
    if not run.trace or run.window.profiler is None:
        return None
    span = frame_span(run.trace["ops"])
    if span is None:
        return None
    lo, hi, count = span
    split = idle_by_host(run.trace["ops"],
                         host_ranges(run.window.profiler.events()), lo, hi)
    return sum(us for name, us in split.items()
               if name.startswith(SPAN)) / 1e3 / count


def capture_s(run):
    """Self seconds of every ``capture`` span the process has closed (the
    frames captured into CUDA graphs: each warm-up frame and capture, less
    the kernels' builds inside them), from the program's span totals."""
    try:
        from phyx_tpu_torch import tracing
    except ImportError:
        return None
    row = tracing.totals().get("capture")
    return None if row is None else row["self_s"]
