"""Readings shared by metrics that are split by the kind of cell (a metric
of the realtime cells and one of the batch cells, each with its own
bound or its own end-to-end metric to move): each metric's file under
``benchmark/metrics`` returns one of these."""

STAGES = ("integrate", "broadphase", "narrowphase", "cache_join", "prepare")


def steps_per_s(run):
    """Frames completed over the whole window, from its first call to the
    synchronise after its last, on the host clock."""
    w = run.window
    if not w.calls:
        return None
    return w.frames / (w.t_end - w.t_start)


def contact_stage_ms(run):
    """Device ms a frame of ``step.contact_stage`` (integrate, broadphase,
    narrowphase, cache join, prepare), by ``profiling.stage_times`` over
    uncaptured frames from the settled snapshot, each behind a sleep
    kernel."""
    if not run.stages or not run.stages.get("device_only"):
        return None
    return sum(run.stages[k] for k in STAGES)


def solve_stage_ms(run):
    """Device ms a frame of ``step.solve_stage`` (the solve kernel with its
    packing), timed as ``contact_stage_ms``."""
    if not run.stages or not run.stages.get("device_only"):
        return None
    return run.stages["solve"]


def device_idle_pct(run):
    """The share of the traced stretch's device span (first operation's
    start to last one's end) in which no operation ran on the device, in
    percent."""
    t = run.trace
    if not t or t["span_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["span_us"])
