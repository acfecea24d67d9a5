"""Per-stage step profiling as a library call (``phyx_tpu/profiling.py``).

The reference times prefixes of the step pipeline, because per-op
tracing is unusable on its device.  Here each stage is timed directly:
``step`` calls a ``mark(stage)`` hook as each stage ends, so the profiled
frame is the shipped pipeline's, and ``stage_times`` times the spans
between the marks.

    from phyx_tpu_torch.profiling import profile_step
    rows = profile_step(state, cfg, reps=20)
    # [{"stage": "integrate", "ms": ..., "cum_ms": ...}, ...,
    #  {"stage": "REAL full step", "ms": ...}]

On the card each stage is timed by a pair of CUDA events, with each frame
queued behind a sleep kernel so that the host's enqueue does not pace the
stages, and ``reps`` chained frames (each frame's input is the previous
one's output) averaged.  A frame whose host enqueue outlasts its sleep is
reported (``device_only``), and ``profile_step`` refuses it.  "REAL full
step" is the replayed frame: CUDA events around ``rollout(state, cfg,
reps)`` after a call that captured its graph (the call's copy of the
state in and out included).  On the CPU, ``time.perf_counter``.  The
profiler opens no torch.profiler session (a second session in one process
has shown no device events on the card).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import rollout, step
from phyx_tpu_torch.types import State

STAGES = ["integrate", "broadphase", "narrowphase", "cache_join", "prepare",
          "solve", "build_cache"]
STAGES_JOINTS = ["integrate", "broadphase", "narrowphase", "cache_join",
                 "prepare", "joint_prepare", "solve", "build_cache"]

# the least sleep ahead of a frame, and its share over the host's enqueue
_MIN_SLEEP_MS = 2.0
_SLEEP_OVER_ENQUEUE = 3.0


def _sleep_cycles_a_ms(dev) -> float:
    """The sleep kernel's cycles a millisecond on ``dev``."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _frame_cuda(state: State, cfg: SimConfig, sleep_cycles: int, times):
    """One frame behind a sleep of ``sleep_cycles``, each stage's event ms
    added to ``times``; returns (state, host ms of the enqueue, sleep
    ms)."""
    marks = []

    def mark(stage: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    torch.cuda.synchronize(state.bodies.pos.device)
    mark("sleep")
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    mark("start")
    t0 = time.perf_counter()
    state = step(state, cfg, mark)
    host_ms = (time.perf_counter() - t0) * 1e3
    marks[-1][1].synchronize()
    for (_, a), (stage, b) in zip(marks[1:], marks[2:]):
        times[stage] += a.elapsed_time(b)
    return state, host_ms, marks[0][1].elapsed_time(marks[1][1])


def _frame_cpu(state: State, cfg: SimConfig, times):
    last = [time.perf_counter()]

    def mark(stage: str) -> None:
        now = time.perf_counter()
        times[stage] += (now - last[0]) * 1e3
        last[0] = now

    t0 = last[0]
    state = step(state, cfg, mark)
    return state, (time.perf_counter() - t0) * 1e3, 0.0


def stage_times(state: State, cfg: SimConfig, reps: int,
                sleep_ms: float = None):
    """Each stage's time over ``reps`` chained frames of ``step``.

    Returns (the state after the frames, times): each stage's mean ms
    (``STAGES``, or ``STAGES_JOINTS`` on a scene with joint slots),
    "sleep" (the mean ms of the sleep ahead of a frame), "host_enqueue"
    (the mean host ms from a frame's start to its last mark) and
    "device_only".

    On the card each frame is queued behind a sleep kernel of ``sleep_ms``
    (None: 3 x one frame's host enqueue, at least 2 ms, timed on one more
    frame run first; 0: no sleep, and the events time the stream's wall
    clock) and its stages timed by CUDA events.  "device_only" is whether
    the host had queued every frame before its sleep ended, so that the
    events timed the device's work alone: a frame that queues more
    launches than the launch queue holds makes the host wait for the
    device, and no sleep helps.  The kernels must be built (one frame run
    before).  On the CPU the stages are timed by ``time.perf_counter``,
    there is no sleep, and "device_only" is True (the host's time is the
    work)."""
    stages = STAGES_JOINTS if state.joints.capacity else STAGES
    dev = state.bodies.pos.device
    cuda = dev.type == "cuda"
    if cuda and sleep_ms is None:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state = step(state, cfg)
        sleep_ms = max(_MIN_SLEEP_MS,
                       _SLEEP_OVER_ENQUEUE * (time.perf_counter() - t0) * 1e3)
    cycles = int(sleep_ms * _sleep_cycles_a_ms(dev)) if cuda and sleep_ms \
        else 0
    times = dict.fromkeys(stages, 0.0)
    host = slept = 0.0
    device_only = True
    for _ in range(reps):
        if cuda:
            state, host_ms, sleep = _frame_cuda(state, cfg, cycles, times)
            device_only &= host_ms < sleep
        else:
            state, host_ms, sleep = _frame_cpu(state, cfg, times)
        host += host_ms
        slept += sleep
    out = {stage: ms / reps for stage, ms in times.items()}
    out.update(sleep=slept / reps, host_enqueue=host / reps,
               device_only=device_only)
    return state, out


def profile_step(state: State, cfg: SimConfig, reps: int = 100,
                 sleep_ms: float = None) -> List[Dict]:
    """Per-stage breakdown of ``step`` on (state, cfg), averaged over
    ``reps`` chained frames (``stage_times``, after one warm-up frame).

    Returns one row ``{"stage", "ms", "cum_ms"}`` per stage of ``STAGES``
    (``STAGES_JOINTS`` on a scene with joint slots, whose solve row is the
    contacts and joints solved together), then ``{"stage": "REAL full
    step", "ms": ...}``, the frame as ``rollout`` runs it.  Raises
    ``RuntimeError`` where the host's enqueue paced the stages (a frame
    that overfills the launch queue, or a ``sleep_ms`` too short):
    ``stage_times`` gives those times, flagged."""
    st = step(state, cfg)                    # warm-up: kernels built
    st, times = stage_times(st, cfg, reps, sleep_ms)
    if not times["device_only"]:
        raise RuntimeError(
            f"profile_step: the host took {times['host_enqueue']:.3f} ms "
            f"(mean) to queue a frame behind a {times['sleep']:.3f} ms "
            "sleep, so the stage times would be the host's pace")
    dev = st.bodies.pos.device
    if dev.type == "cuda":
        st = rollout(st, cfg, 1)             # captures the frame's graph
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        rollout(st, cfg, reps)
        end.record()
        end.synchronize()
        real_ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        rollout(st, cfg, reps)
        real_ms = (time.perf_counter() - t0) * 1e3
    rows: List[Dict] = []
    cum = 0.0
    for stage in (STAGES_JOINTS if st.joints.capacity else STAGES):
        cum += times[stage]
        rows.append({"stage": stage, "ms": times[stage], "cum_ms": cum})
    rows.append({"stage": "REAL full step", "ms": real_ms / reps})
    return rows
