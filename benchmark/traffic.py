"""The one traffic generator: a mix is a file of parameters
(``benchmark/traffic/<mix>.json``) that this module reads and runs.

* ``frames_per_call``: frames of one ``rollout`` call, each taking the
  previous call's state;
* ``in_flight``: calls the client lets run at once; before it enqueues a
  call it waits on the CUDA event of the call ``in_flight`` back (1: a
  closed loop, one call at a time);
* ``readback``: ``"bodies"`` copies every body's position and rotation to
  the host after each call and waits for them (the frame's time runs from
  the call to that copy); ``"none"`` reads nothing back;
* ``segment_frames``: every this many frames the state goes back to the
  settled snapshot, so the window replays one fixed segment whatever the
  speed;
* ``check_calls``, ``check_snapshot_calls``: how many calls of the window,
  and of those that start from the snapshot, are kept for the comparison
  with the reference, drawn from the run's seed (a call drawn for both
  is compared once);
* ``trace_seconds``: with ``--trace 1``, the last stretch of the window
  that torch.profiler traces;
* ``warmup_calls``: calls run before the window (their state is dropped);
* ``stage_frames``: with ``--trace 1``, the uncaptured frames from the
  snapshot whose stages are timed after the window.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

KEYS = ("frames_per_call", "in_flight", "readback", "segment_frames",
        "check_calls", "check_snapshot_calls", "trace_seconds",
        "warmup_calls", "stage_frames")


def validate(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if mix["readback"] not in ("bodies", "none"):
        raise ValueError(f"unknown readback {mix['readback']!r}")
    if min(mix["frames_per_call"], mix["in_flight"],
           mix["segment_frames"]) < 1:
        raise ValueError("frames_per_call, in_flight and segment_frames "
                         "must be positive")
    return mix


@dataclass
class Call:
    frames: int
    t_call: float
    t_return: float
    # the positions on the host (readback "bodies"), else None
    t_done: float = None
    traced: bool = False


@dataclass
class Kept:
    """A call kept for the comparison: its index, input and output states
    and, with readback, the host copy the client received."""
    index: int
    state_in: object
    state_out: object
    host: object = None


@dataclass
class Window:
    calls: list
    flags: list            # each call's guard result, on the device
    t_start: float
    t_end: float
    kept: list
    # the last call's output state (the snapshot where no call ran)
    last: object = None
    traced_outputs: list = field(default_factory=list)
    profiler: object = None
    # when the profiled stretch began (host clock)
    t_trace: float = None

    @property
    def frames(self) -> int:
        return sum(c.frames for c in self.calls)


class _Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn by ``rng``."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, make):
        if self.size <= 0:
            return
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            k = int(self.rng.integers(0, self.seen + 1))
            if k < self.size:
                self.items[k] = make()
        self.seen += 1


def drive(rollout, guard, snapshot, mix: dict, seconds: float, rng,
          bodies: int, trace: bool = False) -> Window:
    """Runs the mix from ``snapshot`` for ``seconds``: ``rollout(state,
    frames)`` is the program's call, ``guard(state)`` a device flag of
    the guarantees a returned state breaks.  Ends with the device
    synchronised."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = snapshot.bodies.pos.is_cuda
    fpc = mix["frames_per_call"]
    per_segment = max(1, mix["segment_frames"] // fpc)
    readback = mix["readback"] == "bodies"
    host = None
    if readback:
        host = torch.empty((bodies, 4), dtype=torch.float32,
                           pin_memory=cuda)

    def note(name):
        return record_function(name) if trace else contextlib.nullcontext()

    def read_back(out):
        rows = torch.cat([out.bodies.pos[:bodies], out.bodies.rot[:bodies]],
                         dim=1)
        host.copy_(rows, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream().synchronize()

    for _ in range(mix["warmup_calls"]):
        out = rollout(snapshot, fpc)
        guard(out)
        if readback:
            read_back(out)
    if cuda:
        torch.cuda.synchronize()

    any_call = _Reservoir(mix["check_calls"], rng)
    from_snap = _Reservoir(mix["check_snapshot_calls"], rng)
    calls, flags, events, traced_outputs = [], [], [], []
    prof = t_trace = None
    state, pos_in_segment = snapshot, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if trace and prof is None and now >= deadline - mix["trace_seconds"]:
            # the calls in flight finish first: every device operation of
            # the trace belongs to a traced call
            if cuda:
                torch.cuda.synchronize()
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            t_trace = time.perf_counter()
            # the stretch lasts its length whatever the profiler's start
            # took
            deadline = max(deadline, t_trace + mix["trace_seconds"])
        if pos_in_segment == per_segment:
            with note("reset"):
                state, pos_in_segment = snapshot, 0
        while len(events) >= mix["in_flight"]:
            with note("wait"):
                events.pop(0).synchronize()
        t_call = time.perf_counter()
        with note("rollout"):
            out = rollout(state, fpc)
        t_return = time.perf_counter()
        with note("guard"):
            flags.append(guard(out))
        call = Call(frames=fpc, t_call=t_call, t_return=t_return,
                    traced=prof is not None)
        if readback:
            with note("readback"):
                read_back(out)
            call.t_done = time.perf_counter()
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        if call.traced:
            traced_outputs.append(out.stats.num_contacts)
        index = len(calls)
        calls.append(call)

        def keep(state_in=state, out=out, index=index):
            return Kept(index, state_in, out,
                        host.clone() if readback else None)

        any_call.offer(keep)
        if state is snapshot:
            from_snap.offer(keep)
        state = out
        pos_in_segment += 1
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    kept = sorted({k.index: k for k in from_snap.items + any_call.items}
                  .values(), key=lambda k: k.index)
    return Window(calls=calls, flags=flags, t_start=t_start, t_end=t_end,
                  kept=kept, last=state, traced_outputs=traced_outputs,
                  profiler=prof, t_trace=t_trace)
